"""The port's Cypher functions: the cases of
``tests/test_cypher_functions_depth.py`` run against the port on the CPU,
unchanged but for their imports (``open_db("", device="cpu")``).
"""

import math

import pytest

import nornicdb_tpu_torch


@pytest.fixture(scope="module")
def db():
    d = nornicdb_tpu_torch.open_db("", device="cpu")
    yield d
    d.close()


def one(db, query, params=None):
    return db.cypher(query, params or {}).rows[0][0]


class TestNullPropagation:
    """Null in -> null out for scalar functions (Neo4j semantics)."""

    @pytest.mark.parametrize("expr", [
        "toUpper(null)", "toLower(null)", "trim(null)", "size(null)",
        "reverse(null)", "toInteger(null)", "toFloat(null)",
        "abs(null)", "sqrt(null)", "head(null)", "last(null)",
        "length(null)", "substring(null, 1)", "split(null, ',')",
        "left(null, 2)", "replace(null, 'a', 'b')",
    ])
    def test_scalar_null_in_null_out(self, db, expr):
        assert one(db, f"RETURN {expr}") is None

    def test_coalesce_skips_nulls(self, db):
        assert one(db, "RETURN coalesce(null, null, 7, 9)") == 7
        assert one(db, "RETURN coalesce(null, null)") is None


class TestCoercionBoundaries:
    @pytest.mark.parametrize("expr,expected", [
        ("toInteger('12.9')", 12),        # truncation, not rounding
        ("toInteger('not a number')", None),
        ("toInteger(true)", 1),
        ("toInteger(3.99)", 3),
        ("toFloat('2.5')", 2.5),
        ("toFloat('junk')", None),
        ("toString(1.5)", "1.5"),
        ("toString(true)", "true"),
        ("toBoolean('TRUE')", True),
        ("toBoolean('nope')", None),
    ])
    def test_conversion(self, db, expr, expected):
        assert one(db, f"RETURN {expr}") == expected

    @pytest.mark.parametrize("expr,expected", [
        ("sign(-3)", -1), ("sign(0)", 0), ("sign(2.5)", 1),
        ("round(2.5)", 3.0), ("round(-2.5)", -2.0),  # HALF_UP toward +inf
        ("ceil(1.1)", 2.0), ("floor(-1.1)", -2.0),
        ("abs(-2.5)", 2.5),
        ("range(1, 10, 3)", [1, 4, 7, 10]),
        ("range(5, 1, -2)", [5, 3, 1]),
        ("range(1, 0)", []),
    ])
    def test_math_and_range(self, db, expr, expected):
        assert one(db, f"RETURN {expr}") == expected

    def test_division_semantics(self, db):
        assert one(db, "RETURN 7 / 2") == 3          # integer division
        assert one(db, "RETURN 7.0 / 2") == 3.5
        assert one(db, "RETURN 7 % 3") == 1

    @pytest.mark.parametrize("expr,expected", [
        ("substring('hello', 1, 3)", "ell"),
        ("substring('hello', 99)", ""),
        ("left('hello', 99)", "hello"),
        ("split('a,,b', ',')", ["a", "", "b"]),
        ("replace('aaa', 'a', 'b')", "bbb"),
        ("reverse('abc')", "cba"),
        ("size('héllo')", 5),
        ("toUpper('mixedCase')", "MIXEDCASE"),
    ])
    def test_string_edges(self, db, expr, expected):
        assert one(db, f"RETURN {expr}") == expected

    def test_list_comprehension_and_reduce(self, db):
        assert one(db, "RETURN [x IN range(1,5) WHERE x % 2 = 0 | x * 10]") \
            == [20, 40]
        assert one(db, "RETURN reduce(s = 0, x IN [1,2,3] | s + x)") == 6
        assert one(db, "RETURN reduce(s = '', w IN ['a','b'] | s + w)") == \
            "ab"


class TestSpatialFamily:
    """ref: functions_eval_math.go:716-930."""

    def test_point_cartesian_constructor(self, db):
        p = one(db, "RETURN point({x: 1.0, y: 2.0})")
        assert p["x"] == 1.0 and p["y"] == 2.0

    def test_point_wgs84_constructor(self, db):
        p = one(db, "RETURN point({latitude: 59.91, longitude: 10.75})")
        assert p["latitude"] == 59.91

    def test_point_null_and_bad_input(self, db):
        assert one(db, "RETURN point(null)") is None
        with pytest.raises(Exception):
            db.cypher("RETURN point({a: 1})")

    def test_cartesian_distance(self, db):
        d = one(db, "RETURN distance(point({x: 0.0, y: 0.0}), "
                    "point({x: 3.0, y: 4.0}))")
        assert d == pytest.approx(5.0)

    def test_3d_distance(self, db):
        d = one(db, "RETURN distance(point({x: 0.0, y: 0.0, z: 0.0}), "
                    "point({x: 1.0, y: 2.0, z: 2.0}))")
        assert d == pytest.approx(3.0)

    def test_haversine_distance_oslo_to_bergen(self, db):
        # Oslo (59.9139, 10.7522) -> Bergen (60.3913, 5.3221): ~305 km
        d = one(db, "RETURN point.distance("
                    "point({latitude: 59.9139, longitude: 10.7522}), "
                    "point({latitude: 60.3913, longitude: 5.3221}))")
        assert 295_000 < d < 315_000

    def test_distance_null_and_mixed_kind(self, db):
        assert one(db, "RETURN distance(null, point({x:1.0,y:1.0}))") is None
        assert one(db, "RETURN distance(point({x:1.0,y:1.0}), "
                       "point({latitude:1.0,longitude:1.0}))") is None

    def test_point_withinbbox_alias(self, db):
        """Neo4j's official spelling (ref: functions_eval_math.go:916)."""
        assert one(db, "RETURN point.withinBBox(point({x: 1.0, y: 1.0}), "
                       "point({x: 0.0, y: 0.0}), "
                       "point({x: 2.0, y: 2.0}))") is True

    def test_within_bbox(self, db):
        q = ("RETURN withinBBox(point({{x: {px}, y: {py}}}), "
             "point({{x: 0.0, y: 0.0}}), point({{x: 10.0, y: 10.0}}))")
        assert one(db, q.format(px=5.0, py=5.0)) is True
        assert one(db, q.format(px=11.0, py=5.0)) is False
        assert one(db, q.format(px=10.0, py=10.0)) is True  # inclusive

    @pytest.mark.parametrize("acc,expected", [
        ("point.x", 1.5), ("point.y", 2.5), ("point.z", None),
        ("point.latitude", None), ("point.srid", 7203),
    ])
    def test_accessors_cartesian(self, db, acc, expected):
        v = one(db, f"RETURN {acc}(point({{x: 1.5, y: 2.5}}))")
        assert v == expected

    def test_accessors_wgs84(self, db):
        q = "point({latitude: 59.9, longitude: 10.7})"
        assert one(db, f"RETURN point.latitude({q})") == 59.9
        assert one(db, f"RETURN point.longitude({q})") == 10.7
        assert one(db, f"RETURN point.srid({q})") == 4326

    def test_points_stored_and_filtered(self, db):
        """Spatial values flow through storage + WHERE like the reference's
        basic-support contract."""
        db.cypher("CREATE (a:Place {name: 'near', loc: point({x: 1.0, "
                  "y: 1.0})}), (b:Place {name: 'far', loc: point({x: 90.0, "
                  "y: 90.0})})")
        rows = db.cypher(
            "MATCH (p:Place) "
            "WHERE distance(p.loc, point({x: 0.0, y: 0.0})) < 10 "
            "RETURN p.name").rows
        assert rows == [["near"]]
