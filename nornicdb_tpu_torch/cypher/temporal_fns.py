"""Neo4j temporal functions: date / datetime / time / duration.

Behavioral reference: the reference supports Neo4j temporal functions through
its Cypher function registry (pkg/cypher/fn/registry.go) and APOC date
category. Temporal values are represented as field-maps (so `d.year`
property access works like Neo4j's accessors) carrying `iso` (sortable
string form) and `epochMillis`.
"""

from __future__ import annotations

import datetime as _dt
import re
import time
from typing import Any, Optional

from nornicdb_tpu_torch.cypher.functions import register
from nornicdb_tpu_torch.errors import CypherTypeError

_DURATION_RE = re.compile(
    r"P(?:(?P<years>\d+)Y)?(?:(?P<months>\d+)M)?(?:(?P<weeks>\d+)W)?"
    r"(?:(?P<days>\d+)D)?(?:T(?:(?P<hours>\d+)H)?(?:(?P<minutes>\d+)M)?"
    r"(?:(?P<seconds>[\d.]+)S)?)?"
)


def _date_map(d: _dt.date) -> dict[str, Any]:
    return {
        "__temporal__": "date",
        "year": d.year,
        "month": d.month,
        "day": d.day,
        "week": d.isocalendar()[1],
        "dayOfWeek": d.isoweekday(),
        "iso": d.isoformat(),
        "epochMillis": int(
            _dt.datetime(d.year, d.month, d.day, tzinfo=_dt.timezone.utc).timestamp()
            * 1000
        ),
    }


def _datetime_map(dt: _dt.datetime) -> dict[str, Any]:
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return {
        "__temporal__": "datetime",
        "year": dt.year,
        "month": dt.month,
        "day": dt.day,
        "hour": dt.hour,
        "minute": dt.minute,
        "second": dt.second,
        "millisecond": dt.microsecond // 1000,
        "timezone": str(dt.tzinfo),
        "iso": dt.isoformat(),
        "epochMillis": int(dt.timestamp() * 1000),
        "epochSeconds": int(dt.timestamp()),
    }


def _time_map(t: _dt.time) -> dict[str, Any]:
    return {
        "__temporal__": "time",
        "hour": t.hour,
        "minute": t.minute,
        "second": t.second,
        "millisecond": t.microsecond // 1000,
        "iso": t.isoformat(),
    }


def _parse_input(value: Any) -> _dt.datetime:
    if value is None:
        return _dt.datetime.now(_dt.timezone.utc)
    if isinstance(value, dict):
        if "epochMillis" in value:
            return _dt.datetime.fromtimestamp(
                value["epochMillis"] / 1000.0, _dt.timezone.utc
            )
        return _dt.datetime(
            int(value.get("year", 1970)), int(value.get("month", 1)),
            int(value.get("day", 1)), int(value.get("hour", 0)),
            int(value.get("minute", 0)), int(value.get("second", 0)),
            int(value.get("millisecond", 0)) * 1000, _dt.timezone.utc,
        )
    if isinstance(value, (int, float)):
        return _dt.datetime.fromtimestamp(float(value) / 1000.0, _dt.timezone.utc)
    if isinstance(value, str):
        s = value.replace("Z", "+00:00")
        try:
            return _dt.datetime.fromisoformat(s)
        except ValueError:
            d = _dt.date.fromisoformat(s)
            return _dt.datetime(d.year, d.month, d.day, tzinfo=_dt.timezone.utc)
    raise CypherTypeError(f"cannot parse temporal value {value!r}")


@register("date")
def fn_date(value=None):
    return _date_map(_parse_input(value).date())


@register("datetime")
def fn_datetime(value=None):
    return _datetime_map(_parse_input(value))


@register("localdatetime")
def fn_localdatetime(value=None):
    return _datetime_map(_parse_input(value))


@register("time")
@register("localtime")
def fn_time(value=None):
    if value is None:
        return _time_map(_dt.datetime.now(_dt.timezone.utc).time())
    if isinstance(value, str):
        return _time_map(_dt.time.fromisoformat(value))
    return _time_map(_parse_input(value).time())


@register("datetime.fromepochmillis")
def fn_from_epoch_millis(ms):
    if ms is None:
        return None
    return _datetime_map(
        _dt.datetime.fromtimestamp(int(ms) / 1000.0, _dt.timezone.utc)
    )


@register("datetime.fromepoch")
def fn_from_epoch(seconds, nanos=0):
    if seconds is None:
        return None
    return _datetime_map(
        _dt.datetime.fromtimestamp(
            int(seconds) + int(nanos) / 1e9, _dt.timezone.utc
        )
    )


@register("duration")
def fn_duration(value):
    """duration('P1DT2H') or duration({days: 1, hours: 2})."""
    if value is None:
        return None
    fields = {"years": 0, "months": 0, "weeks": 0, "days": 0, "hours": 0,
              "minutes": 0, "seconds": 0.0}
    if isinstance(value, str):
        m = _DURATION_RE.fullmatch(value)
        if not m:
            raise CypherTypeError(f"invalid duration string {value!r}")
        for k, v in m.groupdict().items():
            if v is not None:
                fields[k] = float(v) if k == "seconds" else int(v)
    elif isinstance(value, dict):
        for k in fields:
            if k in value:
                fields[k] = value[k]
        if "milliseconds" in value:
            fields["seconds"] += value["milliseconds"] / 1000.0
    else:
        raise CypherTypeError("duration() expects a string or map")
    total_ms = int(
        (
            fields["years"] * 365.2425 * 86400
            + fields["months"] * 30.436875 * 86400
            + fields["weeks"] * 7 * 86400
            + fields["days"] * 86400
            + fields["hours"] * 3600
            + fields["minutes"] * 60
            + fields["seconds"]
        )
        * 1000
    )
    return {
        "__temporal__": "duration",
        **{k: v for k, v in fields.items()},
        "milliseconds": total_ms,
        "iso": _duration_iso(fields),
    }


def _duration_iso(f: dict) -> str:
    out = "P"
    if f["years"]:
        out += f"{int(f['years'])}Y"
    if f["months"]:
        out += f"{int(f['months'])}M"
    if f["weeks"]:
        out += f"{int(f['weeks'])}W"
    if f["days"]:
        out += f"{int(f['days'])}D"
    t = ""
    if f["hours"]:
        t += f"{int(f['hours'])}H"
    if f["minutes"]:
        t += f"{int(f['minutes'])}M"
    if f["seconds"]:
        s = f["seconds"]
        t += f"{int(s) if float(s).is_integer() else s}S"
    if t:
        out += "T" + t
    return out if len(out) > 1 else "PT0S"


@register("duration.between")
def fn_duration_between(a, b):
    if a is None or b is None:
        return None
    da, db = _parse_input(a), _parse_input(b)
    delta = db - da
    total = delta.total_seconds()
    sign = -1 if total < 0 else 1
    total = abs(total)
    days = int(total // 86400)
    rem = total - days * 86400
    hours = int(rem // 3600)
    minutes = int((rem - hours * 3600) // 60)
    seconds = rem - hours * 3600 - minutes * 60
    return fn_duration(
        {
            "days": sign * days,
            "hours": sign * hours,
            "minutes": sign * minutes,
            "seconds": sign * round(seconds, 3),
        }
    )


def _as_duration_ms(v):
    if isinstance(v, dict) and v.get("__temporal__") == "duration":
        return v["milliseconds"]
    return None


@register("duration.indays")
def fn_duration_in_days(a, b=None):
    """Two forms (ref: duration_functions_test.go:207): with one argument,
    total days of a duration as a float; with two, the duration between
    two temporals expressed in whole days."""
    if a is None:
        return None
    if b is None:
        ms = _as_duration_ms(a)
        if ms is None:
            raise CypherTypeError("duration.inDays expects a duration")
        return ms / 86400000.0
    d = fn_duration_between(a, b)
    if d is None:
        return None
    return fn_duration({"days": int(d["milliseconds"] / 86400000)})


@register("duration.inseconds")
def fn_duration_in_seconds(a, b=None):
    """(ref: duration_functions_test.go RETURN duration.inSeconds(...))"""
    if a is None:
        return None
    if b is None:
        ms = _as_duration_ms(a)
        if ms is None:
            raise CypherTypeError("duration.inSeconds expects a duration")
        return ms / 1000.0
    d = fn_duration_between(a, b)
    return None if d is None else d["milliseconds"] / 1000.0


@register("date.year")
def fn_date_year(value):
    """(ref: temporal_functions_test.go:184 — string date accessors)"""
    return None if value is None else _parse_input(value).year


@register("date.month")
def fn_date_month(value):
    return None if value is None else _parse_input(value).month


@register("date.day")
def fn_date_day(value):
    return None if value is None else _parse_input(value).day


@register("date.truncate")
def fn_date_truncate(unit, value=None):
    dt = _parse_input(value)
    unit = str(unit).lower()
    if unit == "year":
        dt = dt.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
    elif unit == "month":
        dt = dt.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    elif unit == "week":
        dt = (dt - _dt.timedelta(days=dt.isoweekday() - 1)).replace(
            hour=0, minute=0, second=0, microsecond=0
        )
    elif unit == "day":
        dt = dt.replace(hour=0, minute=0, second=0, microsecond=0)
    else:
        raise CypherTypeError(f"unsupported truncate unit {unit}")
    return _date_map(dt.date())
