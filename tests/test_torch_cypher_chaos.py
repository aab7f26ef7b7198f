"""The port's Cypher engine under hostile input: the cases of
``tests/test_cypher_chaos.py`` run against the port on the CPU, unchanged
but for their imports.
"""

import random
import string

import pytest

from nornicdb_tpu_torch.cypher import CypherExecutor as _PortExecutor
from nornicdb_tpu_torch.errors import NornicError
from nornicdb_tpu_torch.storage import MemoryEngine, Node


def CypherExecutor(*args, **kwargs):
    """The port's executor on the CPU (``device=None`` would mean CUDA)."""
    kwargs.setdefault("device", "cpu")
    return _PortExecutor(*args, **kwargs)


@pytest.fixture
def ex():
    eng = MemoryEngine()
    e = CypherExecutor(eng)
    e.execute("CREATE (:Seed {v: 1})-[:R]->(:Seed {v: 2})")
    return e


MALFORMED = [
    "",
    "   ",
    "MATCH",
    "MATCH (",
    "MATCH (n",
    "MATCH (n)",  # no RETURN is legal? — no-op query returns empty
    "MATCH (n RETURN n",
    "MATCH (n) RETURN",
    "RETURN ,",
    "RETURN 1 +",
    "RETURN (1",
    "RETURN [1, 2",
    "RETURN {a: }",
    "CREATE (n:)",
    "CREATE (n {",
    "MATCH (a)-[->(b) RETURN a",
    "MATCH (a)-[:]->(b) RETURN a",
    "WHERE true RETURN 1",
    "MATCH (n) WHERE RETURN n",
    "RETURN 'unterminated",
    'RETURN "also unterminated',
    "RETURN `backtick",
    "MATCH (n) RETURN n ORDER",
    "MATCH (n) RETURN n LIMIT",
    "MATCH (n) RETURN n SKIP x y",
    "UNWIND AS x RETURN x",
    "CALL",
    "CALL ()",
    "MERGE",
    "DELETE",
    "SET",
    "FOREACH (x IN [1,2] |",
    "RETURN CASE WHEN THEN 1 END",
    "RETURN reduce(acc, x IN [1] | acc)",
    "MATCH (n) RETURN n UNION MATCH (m) RETURN m, m",  # column mismatch
    "RETURN $",
    "RETURN 1 /* unclosed comment",
    "MATCH p = shortestPath((a)) RETURN p",
    "CREATE INDEX FOR (n) ON (n.x)",
    "RETURN 1 ^ ^ 2",
    ";;;",
    "MATCH (n) RETURN n; MATCH (m) RETURN m",  # trailing statement
]


class TestMalformedInputs:
    @pytest.mark.parametrize("query", MALFORMED)
    def test_malformed_raises_cleanly(self, ex, query):
        try:
            ex.execute(query)
        except NornicError:
            pass  # clean framework error is the contract
        # anything else (crash, SystemError, etc.) fails the test

    def test_state_intact_after_garbage(self, ex):
        for query in MALFORMED:
            try:
                ex.execute(query)
            except NornicError:
                pass
        r = ex.execute("MATCH (s:Seed) RETURN count(s)")
        assert r.rows == [[2]]
        r = ex.execute("MATCH (:Seed)-[r:R]->(:Seed) RETURN count(r)")
        assert r.rows == [[1]]


class TestFuzz:
    def test_random_token_soup(self, ex):
        """Random keyword/punct soup must never escape NornicError."""
        rng = random.Random(42)
        vocab = [
            "MATCH", "RETURN", "WHERE", "CREATE", "SET", "DELETE", "WITH",
            "(", ")", "[", "]", "{", "}", ":", ",", "-", "->", "<-", "=",
            "n", "m", "x", "'s'", "1", "1.5", "$p", "*", "..", "|", "AND",
            "NOT", "NULL", "count", ".", "ORDER", "BY", "LIMIT",
        ]
        for _ in range(300):
            q = " ".join(rng.choice(vocab) for _ in range(rng.randint(1, 15)))
            try:
                ex.execute(q, {"p": 1})
            except NornicError:
                pass

    def test_random_bytes(self, ex):
        rng = random.Random(7)
        for _ in range(100):
            q = "".join(
                rng.choice(string.printable) for _ in range(rng.randint(1, 60))
            )
            try:
                ex.execute(q)
            except NornicError:
                pass

    def test_deep_nesting(self, ex):
        q = "RETURN " + "(" * 150 + "1" + ")" * 150
        try:
            r = ex.execute(q)
            assert r.rows == [[1]]
        except (NornicError, RecursionError):
            pass  # clean rejection is acceptable for pathological nesting

    def test_huge_list_literal(self, ex):
        q = "RETURN size([" + ",".join(["1"] * 5000) + "]) AS n"
        assert ex.execute(q).rows == [[5000]]

    def test_long_string_property(self, ex):
        big = "x" * 100_000
        ex.execute("CREATE (:Big {v: $v})", {"v": big})
        r = ex.execute("MATCH (b:Big) RETURN size(b.v)")
        assert r.rows == [[100_000]]


class TestAdversarialValues:
    def test_null_everywhere(self, ex):
        r = ex.execute(
            "RETURN null + null AS a, null[0] AS b, null.x AS c, "
            "size(null) AS d, toUpper(null) AS e"
        )
        assert r.rows == [[None, None, None, None, None]]

    def test_division_edge_cases(self, ex):
        from nornicdb_tpu_torch.errors import CypherTypeError

        with pytest.raises(CypherTypeError):
            ex.execute("RETURN 1 / 0")
        with pytest.raises(CypherTypeError):
            ex.execute("RETURN 1 % 0")

    def test_mixed_type_comparisons_are_null(self, ex):
        r = ex.execute("RETURN 1 < 'a' AS a, [1] < 2 AS b")
        assert r.rows == [[None, None]]

    def test_unicode_identifiers_and_strings(self, ex):
        ex.execute("CREATE (:Pærson {`nöm`: 'Bjørn 🎿'})")
        r = ex.execute("MATCH (p:Pærson) RETURN p.`nöm`")
        assert r.rows == [["Bjørn 🎿"]]

    def test_parameter_type_soup(self, ex):
        params = {
            "s": "str", "i": 7, "f": 1.5, "b": True, "n": None,
            "l": [1, [2, {"k": "v"}]], "m": {"nested": {"deep": [None]}},
        }
        r = ex.execute(
            "RETURN $s, $i, $f, $b, $n, $l, $m", params
        )
        assert r.rows[0] == ["str", 7, 1.5, True, None,
                             [1, [2, {"k": "v"}]], {"nested": {"deep": [None]}}]
