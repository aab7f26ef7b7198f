"""Cypher through the port's ``DB`` facade, each case in both packages on
the same operations: ``db.cypher`` / ``execute_cypher`` and a reopen
(``tests/test_db_facade_depth.py::...test_cypher_roundtrip_through_facade``
and the verify recipe's flow), the limits DDL and its enforcement
(``tests/test_db_limits.py``), ``USE`` / aliases / DROP DATABASE
(``tests/test_multidb.py::TestCypherMultidb``) with the per-database
executor cache, the executor cases of ``tests/test_telemetry.py::
TestSlowLog``, ``cypher_stats``, ``log_queries``, the query cache as the
executor's result cache, and Heimdall's ``query`` action
(``tests/test_heimdall_depth.py::...test_query_action_*``).
"""

import logging

import pytest

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu.db import Config as JaxConfig
from nornicdb_tpu.errors import NornicError as JaxNornicError
from nornicdb_tpu.heimdall import Generator as JaxGenerator
from nornicdb_tpu.heimdall import HeimdallManager as JaxHeimdall
from nornicdb_tpu.telemetry.slowlog import slow_log as jax_slow_log
from nornicdb_tpu_torch.db import Config as PortConfig
from nornicdb_tpu_torch.errors import NornicError as PortNornicError
from nornicdb_tpu_torch.heimdall import Generator as PortGenerator
from nornicdb_tpu_torch.heimdall import HeimdallManager as PortHeimdall
from nornicdb_tpu_torch.telemetry.slowlog import slow_log as port_slow_log

PKGS = {
    "jax": dict(open=lambda p="", cfg=None: nornicdb_tpu.open_db(p, cfg),
                Config=JaxConfig, Error=JaxNornicError, slow=jax_slow_log,
                Heimdall=JaxHeimdall, Generator=JaxGenerator),
    "torch": dict(open=lambda p="", cfg=None: nornicdb_tpu_torch.open_db(
                      p, cfg, device="cpu"),
                  Config=PortConfig, Error=PortNornicError,
                  slow=port_slow_log, Heimdall=PortHeimdall,
                  Generator=PortGenerator),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture
def db(pkg):
    d = pkg["open"]()
    d.cypher("CREATE DATABASE limited")
    yield d
    d.close()


@pytest.fixture
def slow(pkg):
    log = pkg["slow"]
    log.clear()
    log.recorded = 0
    old = log.threshold_s
    yield log
    log.configure(threshold_s=old, capacity=128)
    log.clear()
    log.recorded = 0


class TestFacade:
    def test_cypher_roundtrip_through_facade(self, pkg):
        d = pkg["open"]()
        try:
            d.cypher("CREATE (n:Facade {k: 1})")
            res = d.cypher("MATCH (n:Facade) RETURN n.k AS k")
            assert res.rows == [[1]]
            assert res.columns == ["k"]
            assert d.execute_cypher("MATCH (n:Facade) RETURN count(n)"
                                    ).rows == [[1]]
        finally:
            d.close()

    def test_create_match_close_reopen(self, pkg, tmp_path):
        """The verify recipe's Cypher flow: CREATE, MATCH back, close,
        reopen (WAL recovery), MATCH again."""
        path = str(tmp_path / "data")
        d = pkg["open"](path)
        created = d.cypher("CREATE (n:X {k: 1}) RETURN n").rows[0][0]
        assert created.labels == ["X"] and created.properties == {"k": 1}
        assert d.cypher("MATCH (n:X) RETURN n.k").rows == [[1]]
        d.close()
        d2 = pkg["open"](path)
        try:
            got = d2.cypher("MATCH (n:X) RETURN n, n.k").rows
            assert [r[1] for r in got] == [1]
            assert got[0][0].id == created.id
        finally:
            d2.close()

    def test_cypher_stats_never_builds_the_executor(self, pkg):
        d = pkg["open"]()
        try:
            assert d.cypher_stats() is None
            for _ in range(3):
                d.cypher("MATCH (n:S) WHERE n.v > $v RETURN n.v", {"v": 1})
            stats = d.cypher_stats()
            assert stats["plan_cache"]["hits"] >= 1
            assert stats["enabled"] is True
        finally:
            d.close()

    def test_query_cache_is_the_result_cache(self, pkg):
        d = pkg["open"]()
        try:
            assert d.executor.cache is d.query_cache
            off = pkg["open"]("", pkg["Config"](query_cache_enabled=False))
            try:
                assert off.executor.cache is None
            finally:
                off.close()
        finally:
            d.close()

    def test_log_queries_reaches_the_executor(self, pkg, caplog):
        d = pkg["open"]("", pkg["Config"](log_queries=True))
        try:
            assert d.executor.log_queries is True
            with caplog.at_level(logging.INFO, logger="nornicdb.query"):
                d.cypher("RETURN 1 AS one")
            assert any("RETURN 1" in r.getMessage() for r in caplog.records)
        finally:
            d.close()

    def test_concurrent_first_calls_share_one_executor(self):
        """The port builds ``DB.executor`` under the DB lock (the JAX
        facade does not lock it): clients racing the first ``cypher``
        call share one executor and so one plan cache."""
        import sys
        import threading

        d = PKGS["torch"]["open"]()
        seen: list = []
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(
                target=lambda: seen.append(id(d.executor)))
                for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
                assert not t.is_alive()
            assert len(seen) == 16 and len(set(seen)) == 1
        finally:
            sys.setswitchinterval(old)
            d.close()

    def test_session_executor_is_fresh_and_shares_schema(self, pkg):
        d = pkg["open"]()
        try:
            a, b = d.session_executor(), d.session_executor()
            assert a is not b and a is not d.executor
            assert a.schema is d.schema
            d.cypher("CREATE DATABASE hr")
            s = d.session_executor("hr")
            assert s.schema is d.executor_for("hr").schema
        finally:
            d.close()


# ---- cases of tests/test_db_limits.py, in both packages
class TestLimitsDDL:
    def test_set_and_show_limits(self, db):
        db.cypher("ALTER DATABASE limited SET LIMIT max_nodes = 1000000")
        r = db.cypher("SHOW LIMITS FOR DATABASE limited")
        assert r.columns == ["database", "limit", "value", "description"]
        assert r.rows == [["limited", "max_nodes", 1000000, "max nodes"]]

    def test_multiple_limits_in_one_statement(self, db):
        db.cypher("ALTER DATABASE limited SET LIMIT "
                  "max_nodes = 2000000, max_edges = 5000000")
        r = db.cypher("SHOW LIMITS FOR DATABASE limited")
        got = {row[1]: row[2] for row in r.rows}
        assert got == {"max_nodes": 2000000, "max_edges": 5000000}

    def test_duration_suffix(self, db):
        db.cypher("ALTER DATABASE limited SET LIMIT max_query_time = 60s")
        r = db.cypher("SHOW LIMITS FOR DATABASE limited")
        assert ["limited", "max_query_time", 60.0, "max query time"] in r.rows

    def test_limits_merge_not_replace(self, db):
        db.cypher("ALTER DATABASE limited SET LIMIT max_nodes = 10")
        db.cypher("ALTER DATABASE limited SET LIMIT max_edges = 20")
        got = {row[1]: row[2]
               for row in db.cypher("SHOW LIMITS FOR DATABASE limited").rows}
        assert got == {"max_nodes": 10, "max_edges": 20}

    def test_unknown_limit_key_errors(self, pkg, db):
        with pytest.raises(pkg["Error"]):
            db.cypher("ALTER DATABASE limited SET LIMIT invalid_limit = 1000")

    def test_nonexistent_database_errors(self, pkg, db):
        with pytest.raises(pkg["Error"]):
            db.cypher("ALTER DATABASE nonexistent SET LIMIT max_nodes = 1000")

    def test_show_limits_unlimited(self, db):
        r = db.cypher("SHOW LIMITS FOR DATABASE limited")
        assert r.rows == [["limited", "unlimited", None,
                           "no limits configured"]]


class TestLimitsEnforcement:
    def test_max_nodes_enforced(self, pkg, db):
        db.cypher("ALTER DATABASE limited SET LIMIT max_nodes = 3")
        ex = db.executor_for("limited")
        for i in range(3):
            ex.execute(f"CREATE (:N {{i: {i}}})")
        with pytest.raises(pkg["Error"], match="limit"):
            ex.execute("CREATE (:N {i: 99})")

    def test_limit_change_drops_the_cached_executor(self, db):
        before = db.executor_for("limited")
        assert db.executor_for("limited") is before
        db.cypher("ALTER DATABASE limited SET LIMIT max_nodes = 3")
        assert db.executor_for("limited") is not before

    def test_write_rate_enforced_on_all_write_ops(self, pkg, db):
        db.cypher("ALTER DATABASE limited SET LIMIT "
                  "max_writes_per_second = 5")
        ex = db.executor_for("limited")
        throttled = 0
        for i in range(25):
            try:
                ex.execute(f"CREATE (:W {{i: {i}}})")
            except pkg["Error"]:
                throttled += 1
        assert throttled > 0

    def test_query_rate_enforced(self, pkg, db):
        db.cypher("ALTER DATABASE limited SET LIMIT "
                  "max_queries_per_second = 4")
        ex = db.executor_for("limited")
        throttled = 0
        for _ in range(25):
            try:
                ex.execute("RETURN 1")
            except pkg["Error"]:
                throttled += 1
        assert throttled > 0

    def test_rollback_exempt_from_write_rate(self, pkg, db):
        db.cypher("ALTER DATABASE limited SET LIMIT "
                  "max_writes_per_second = 4")
        ex = db.executor_for("limited")
        ex.execute("CREATE (:R {id: 1, v: 0})")
        with pytest.raises(pkg["Error"]):
            ex.execute("MATCH (n:R {id: 1}) "
                       "SET n.v = 1 SET n.a = 1 SET n.b = 1 "
                       "SET n.bad = NOPE()")
        assert ex.execute("MATCH (n:R) RETURN n.v, n.a").rows == [[0, None]]


class TestDefaultDatabaseLimits:
    def test_query_limits_enforced_on_default(self, pkg):
        d = pkg["open"]()
        try:
            d.cypher("ALTER DATABASE neo4j SET LIMIT "
                     "max_queries_per_second = 3")
            throttled = 0
            for _ in range(20):
                try:
                    d.cypher("RETURN 1")
                except pkg["Error"]:
                    throttled += 1
            assert throttled > 0, "default-db qps limit inert"
        finally:
            d.close()

    def test_write_side_keys_rejected_on_default(self, pkg):
        d = pkg["open"]()
        try:
            for key in ("max_nodes", "max_edges", "max_writes_per_second"):
                with pytest.raises(pkg["Error"], match="not enforceable"):
                    d.cypher(f"ALTER DATABASE neo4j SET LIMIT {key} = 10")
        finally:
            d.close()


# ---- tests/test_multidb.py::TestCypherMultidb, in both packages
class TestCypherMultidb:
    def test_create_show_use_drop(self, pkg):
        d = pkg["open"]()
        try:
            d.cypher("CREATE DATABASE hr")
            names = [row[0] for row in d.cypher("SHOW DATABASES").rows]
            assert "hr" in names and "system" in names
            d.cypher("USE hr CREATE (:Emp {name: 'Ann'})")
            assert d.cypher("USE hr MATCH (e:Emp) RETURN e.name").rows == [
                ["Ann"]]
            assert d.cypher("MATCH (e:Emp) RETURN count(e)").rows == [[0]]
            d.cypher("CREATE ALIAS people FOR DATABASE hr")
            assert d.cypher("USE people MATCH (e:Emp) RETURN count(e)"
                            ).rows == [[1]]
            hr = d.executor_for("hr")
            assert d.executor_for("people") is hr  # cached by resolved name
            d.cypher("DROP ALIAS people")
            d.cypher("DROP DATABASE hr")
            assert "hr" not in [r[0] for r in d.cypher("SHOW DATABASES").rows]
            # DROP DATABASE went through on_invalidate: the cache is gone
            assert "hr" not in d._db_executors
        finally:
            d.close()


# ---- executor cases of tests/test_telemetry.py::TestSlowLog
class TestSlowLog:
    def test_executor_records_over_threshold(self, pkg, slow):
        d = pkg["open"]()
        try:
            slow.configure(threshold_s=1e-9)
            d.cypher("CREATE (:SL {v: 'sensitive-value'})")
            assert slow.recorded >= 1
            entry = slow.snapshot()[0]
            assert "sensitive-value" not in entry["query"]
            assert entry["duration_ms"] > 0
            assert entry["plan"] is not None
        finally:
            d.close()

    def test_threshold_zero_disables(self, pkg, slow):
        slow.configure(threshold_s=0.0)
        d = pkg["open"]()
        try:
            d.cypher("RETURN 1")
            assert slow.recorded == 0 and not slow.snapshot()
        finally:
            d.close()


# ---- tests/test_heimdall_depth.py::...test_query_action_*
def _echo(pkg, reply: str):
    class EchoGenerator(pkg["Generator"]):
        def generate(self, prompt, max_tokens=128):
            return reply

    return EchoGenerator()


class TestHeimdallQueryAction:
    def test_query_action_executes_cypher(self, pkg, db):
        db.cypher("CREATE (:T {v: 1}), (:T {v: 2})")
        gen = _echo(pkg, '{"action": "query", "params": {"cypher": '
                         '"MATCH (n:T) RETURN count(n)"}}')
        out = pkg["Heimdall"](gen, db=db).chat(
            [{"role": "user", "content": "count T"}])
        assert out["action_result"]["rows"] == [[2]]

    def test_query_action_rejects_writes(self, pkg, db):
        db.cypher("CREATE (:Keep)")
        gen = _echo(pkg, '{"action": "query", "params": {"cypher": '
                         '"MATCH (n) DETACH DELETE n"}}')
        out = pkg["Heimdall"](gen, db=db).chat(
            [{"role": "user", "content": "wipe it"}])
        assert "read-only" in out["action_result"]["error"]
        assert db.storage.node_count() == 1  # nothing deleted

    def test_query_action_through_db_heimdall(self, pkg, db):
        db.store("a")
        db.store("b")
        out = db.heimdall._action_query(
            {"cypher": "MATCH (n) RETURN count(n)"})
        assert out["rows"] == [[db.storage.node_count()]]
        refused = db.heimdall._action_query({"cypher": "CREATE (n:X)"})
        assert "read-only" in refused["error"]
