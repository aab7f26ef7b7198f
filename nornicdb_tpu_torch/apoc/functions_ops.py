"""APOC operational function categories: load / log / lock / warmup /
trigger / periodic / import / export / refactor.

Behavioral reference: upstream NornicDB apoc/apoc.go registerAllFunctions +
apoc/{load,log,lock,warmup,trigger,periodic,import,export,refactor}/.
Notes on fidelity:

- load: local-file and data-string loaders are real. The reference's
  external connectors (jdbc/kafka/s3/gcs/azure/redis/elasticsearch/ldap/
  arrow/avro/parquet/rest/graphql/driver) are placeholders that return
  empty results (load.go:299 Jdbc, :405 S3, :435 Kafka, ...); this build
  mirrors that observable behavior exactly and says so per-function.
- lock: a real in-process lock registry (the reference's lock.go is also
  process-local bookkeeping over the embedded store).
- log: a real bounded in-memory log ring with levels + search/tail.
- refactor: function forms of the refactor procedures, executed through
  the live storage engine.

The port's copy of ``nornicdb_tpu/apoc/functions_ops.py``.
"""

from __future__ import annotations

import csv as _csvmod
import io
import json as _json
import os
import re
import threading
import time
import uuid as _uuid
from typing import Any, Optional

from nornicdb_tpu_torch.apoc.functions_graph import _edge, _graph_fn, _node
from nornicdb_tpu_torch.apoc.registry import register
from nornicdb_tpu_torch.errors import NornicError, NotFoundError
from nornicdb_tpu_torch.storage.types import Edge, Node

# =============================================================== apoc.load


def _gated_path(path) -> str:
    """Shared import gate for every apoc.load.* local read: explicit
    operator opt-in, confinable via NORNICDB_IMPORT_DIR (config.py)."""
    from nornicdb_tpu_torch.config import resolve_import_url

    p = str(path)
    if p.startswith(("http://", "https://", "s3://", "gs://")):
        raise NornicError(
            "remote URLs are not loadable in this build (zero-egress); "
            "use a local path"
        )
    try:
        return resolve_import_url(p)
    except PermissionError as e:
        raise NornicError(str(e)) from None


def _read_local(path: str) -> str:
    with open(_gated_path(path), "r", encoding="utf-8") as f:
        return f.read()


def _csv_rows(text: str, sep=",") -> list[dict]:
    reader = _csvmod.DictReader(io.StringIO(text), delimiter=sep)
    return [dict(r) for r in reader]


@register("apoc.load.csv")
def load_csv(path, config=None):
    sep = (config or {}).get("sep", ",")
    return _csv_rows(_read_local(path), sep)


@register("apoc.load.csvStream")
def load_csv_stream(data, config=None):
    """CSV from a data string (stream form)."""
    sep = (config or {}).get("sep", ",")
    return _csv_rows(str(data), sep)


@register("apoc.load.jsonStream")
def load_json_stream(data):
    """One JSON document per line (NDJSON)."""
    out = []
    for line in str(data).splitlines():
        line = line.strip()
        if line:
            out.append(_json.loads(line))
    return out


@register("apoc.load.jsonParams")
def load_json_params(path_or_data, params=None):
    """Load JSON after ${param} substitution. Accepts a file path (import-
    gated) or inline JSON data; a gated path must surface the gate error,
    not fall through to 'parse the path as JSON'."""
    data = str(path_or_data)
    # inline sniff covers every JSON start token — objects/arrays/strings by
    # prefix, bare scalars (123, -4.5, true, null) by an actual parse so a
    # digit-leading *path* ("2024/data.json" fails json.loads) still routes
    # to the gated file read
    looks_inline = data.lstrip()[:1] in ("{", "[", '"')
    if not looks_inline:
        try:
            _json.loads(data)
            looks_inline = True
        except ValueError:
            pass
    if looks_inline:
        text = data
    else:
        try:
            text = _read_local(data)
        except OSError:
            text = data  # not a readable file: treat as inline data
    for k, v in (params or {}).items():
        text = text.replace("${" + str(k) + "}", str(v))
    return _json.loads(text)


@register("apoc.load.jsonSchema")
def load_json_schema(data):
    """Infer a {key: type} schema from a JSON document."""
    obj = _json.loads(data) if isinstance(data, str) else data

    def kind(v):
        if v is None:
            return "null"
        if isinstance(v, bool):
            return "boolean"
        if isinstance(v, int):
            return "integer"
        if isinstance(v, float):
            return "number"
        if isinstance(v, str):
            return "string"
        if isinstance(v, list):
            return "array"
        return "object"

    if isinstance(obj, dict):
        return {k: kind(v) for k, v in obj.items()}
    return kind(obj)


@register("apoc.load.xml")
def load_xml(path):
    from nornicdb_tpu_torch.apoc.functions_ext import _xml_to_map
    import xml.etree.ElementTree as _ET

    return _xml_to_map(_ET.fromstring(_read_local(path)))


@register("apoc.load.xmlSimple")
def load_xml_simple(data):
    from nornicdb_tpu_torch.apoc.functions_ext import _xml_to_map
    import xml.etree.ElementTree as _ET

    return _xml_to_map(_ET.fromstring(str(data)))


@register("apoc.load.html")
def load_html(data, selectors=None):
    """Extract title/meta/links/text from an HTML string (the reference's
    Html is likewise a lightweight extractor, load.go)."""
    html = str(data)
    title = re.search(r"<title[^>]*>(.*?)</title>", html, re.S | re.I)
    metas = {
        m.group(1): m.group(2)
        for m in re.finditer(
            r'<meta\s+name="([^"]+)"\s+content="([^"]*)"', html, re.I)
    }
    links = re.findall(r'href="([^"]+)"', html, re.I)
    text = re.sub(r"<[^>]+>", " ", re.sub(r"<(script|style).*?</\1>", " ",
                                          html, flags=re.S | re.I))
    return {
        "title": title.group(1).strip() if title else None,
        "meta": metas,
        "links": links,
        "text": " ".join(text.split()),
    }


@register("apoc.load.directory")
def load_directory(path, pattern="*"):
    import fnmatch

    return sorted(
        f for f in os.listdir(_gated_path(path))
        if fnmatch.fnmatch(f, str(pattern))
    )


@register("apoc.load.directoryTree")
def load_directory_tree(path):
    out = []
    for root, _dirs, files in os.walk(_gated_path(path)):
        for f in sorted(files):
            out.append(os.path.join(root, f))
    return sorted(out)


@register("apoc.load.binary")
def load_binary(path):
    """Local file bytes as base64 (import-gated)."""
    import base64

    with open(_gated_path(path), "rb") as f:
        return base64.b64encode(f.read()).decode()


@register("apoc.load.stream")
def load_stream(path):
    return _read_local(path).splitlines()


def _placeholder(name, value):
    """Mirror the reference's placeholder connectors exactly (load.go:299
    Jdbc -> [], :405 S3 -> empty, :435 Kafka -> [] ...)."""

    def fn(*args, **kwargs):
        return value() if callable(value) else value

    fn.__doc__ = (
        f"{name}: external connector; returns the same empty result as the "
        "reference's placeholder implementation (apoc/load/load.go)."
    )
    return fn


register("apoc.load.jdbc")(_placeholder("apoc.load.jdbc", list))
register("apoc.load.jdbcUpdate")(_placeholder("apoc.load.jdbcUpdate", 0))
register("apoc.load.kafka")(_placeholder("apoc.load.kafka", list))
register("apoc.load.redis")(_placeholder("apoc.load.redis", None))
register("apoc.load.s3")(_placeholder("apoc.load.s3", ""))
register("apoc.load.gcs")(_placeholder("apoc.load.gcs", ""))
register("apoc.load.azure")(_placeholder("apoc.load.azure", ""))
register("apoc.load.elasticsearch")(
    _placeholder("apoc.load.elasticsearch", list))
register("apoc.load.ldap")(_placeholder("apoc.load.ldap", list))
register("apoc.load.arrow")(_placeholder("apoc.load.arrow", list))
register("apoc.load.avro")(_placeholder("apoc.load.avro", list))
register("apoc.load.parquet")(_placeholder("apoc.load.parquet", list))
register("apoc.load.rest")(_placeholder("apoc.load.rest", dict))
register("apoc.load.graphql")(_placeholder("apoc.load.graphql", dict))


@register("apoc.load.driver")
def load_driver(driver_name, url=None, query=None):
    raise NornicError(f"driver not implemented: {driver_name}")


# ================================================================ apoc.log
_LOG_LOCK = threading.Lock()
_LOG_RING: list[dict] = []
_LOG_MAX = 10_000
_LOG_LEVELS = ("TRACE", "DEBUG", "INFO", "WARN", "ERROR")
_log_state = {"level": "INFO"}
_log_timers: dict[str, float] = {}


def _log_emit(level: str, message, category="general") -> dict:
    entry = {
        "ts": int(time.time() * 1000),
        "level": level,
        "message": str(message),
        "category": category,
    }
    with _LOG_LOCK:
        if _LOG_LEVELS.index(level) >= _LOG_LEVELS.index(_log_state["level"]):
            _LOG_RING.append(entry)
            del _LOG_RING[:-_LOG_MAX]
    return entry


for _lvl in ("trace", "debug", "info", "warn", "error"):
    register(f"apoc.log.{_lvl}")(
        (lambda lvl: lambda message: _log_emit(lvl, message))(_lvl.upper())
    )


@register("apoc.log.custom")
def log_custom(level, message, category="custom"):
    lvl = str(level).upper()
    if lvl not in _LOG_LEVELS:
        raise NornicError(f"unknown log level {level!r}")
    return _log_emit(lvl, message, category)


@register("apoc.log.audit")
def log_audit(message):
    return _log_emit("INFO", message, "audit")


@register("apoc.log.security")
def log_security(message):
    return _log_emit("WARN", message, "security")


@register("apoc.log.query")
def log_query(query, duration_ms=0):
    return _log_emit("INFO", f"query={query} duration={duration_ms}ms",
                     "query")


@register("apoc.log.result")
def log_result(result):
    return _log_emit("INFO", _json.dumps(result, default=str)[:500], "result")


@register("apoc.log.progress")
def log_progress(done, total, label=""):
    pct = (100.0 * float(done) / float(total)) if total else 0.0
    return _log_emit("INFO", f"{label} {done}/{total} ({pct:.1f}%)",
                     "progress")


@register("apoc.log.setLevel")
def log_set_level(level):
    lvl = str(level).upper()
    if lvl not in _LOG_LEVELS:
        raise NornicError(f"unknown log level {level!r}")
    with _LOG_LOCK:
        _log_state["level"] = lvl
    return lvl


@register("apoc.log.getLevel")
def log_get_level():
    return _log_state["level"]


@register("apoc.log.clear")
def log_clear():
    with _LOG_LOCK:
        n = len(_LOG_RING)
        _LOG_RING.clear()
    return n


@register("apoc.log.rotate")
def log_rotate(keep=1000):
    with _LOG_LOCK:
        n = len(_LOG_RING)
        del _LOG_RING[:-int(keep)]
        return n - len(_LOG_RING)


@register("apoc.log.tail")
def log_tail(n=10):
    with _LOG_LOCK:
        return list(_LOG_RING[-int(n):])


@register("apoc.log.stream")
def log_stream(since_ts=0):
    with _LOG_LOCK:
        return [e for e in _LOG_RING if e["ts"] >= int(since_ts)]


@register("apoc.log.search")
def log_search(pattern):
    pat = re.compile(str(pattern), re.IGNORECASE)
    with _LOG_LOCK:
        return [e for e in _LOG_RING if pat.search(e["message"])]


@register("apoc.log.stats")
def log_stats():
    with _LOG_LOCK:
        counts: dict[str, int] = {}
        for e in _LOG_RING:
            counts[e["level"]] = counts.get(e["level"], 0) + 1
        return {"total": len(_LOG_RING), "byLevel": counts,
                "level": _log_state["level"]}


@register("apoc.log.format")
def log_format(entry):
    e = entry or {}
    return f"[{e.get('ts')}] {e.get('level')} {e.get('category')}: " \
           f"{e.get('message')}"


@register("apoc.log.timer")
def log_timer(name, stop=False):
    """Start (or stop and report) a named timer; returns elapsed ms."""
    now = time.perf_counter()
    if not stop:
        with _LOG_LOCK:
            _log_timers[str(name)] = now
        return 0.0
    with _LOG_LOCK:
        t0 = _log_timers.pop(str(name), now)
    ms = (now - t0) * 1000.0
    _log_emit("INFO", f"timer {name}: {ms:.2f}ms", "timer")
    return ms


@register("apoc.log.memory")
def log_memory():
    import resource

    usage = resource.getrusage(resource.RUSAGE_SELF)
    return {"maxRssKb": usage.ru_maxrss}


@register("apoc.log.metrics")
def log_metrics():
    return {**log_stats(), "timers": sorted(_log_timers)}


@register("apoc.log.performance")
def log_performance(label, ms):
    return _log_emit("INFO", f"{label}: {float(ms):.2f}ms", "performance")


@register("apoc.log.toFile")
def log_to_file(path):
    with _LOG_LOCK:
        lines = [log_format(e) for e in _LOG_RING]
    with open(str(path), "w", encoding="utf-8") as f:
        f.write("\n".join(lines))
    return len(lines)


# =============================================================== apoc.lock
# Real in-process registry (the reference's lock.go is the same idea over
# the embedded store: write/read lock bookkeeping per entity id).
_locks_lock = threading.Lock()
_locks: dict[str, dict] = {}  # id -> {mode, count, priority}


def _ent_id(v) -> str:
    if isinstance(v, (Node, Edge)):
        return v.id
    return str(v)


def _acquire(ids, mode) -> int:
    n = 0
    with _locks_lock:
        for i in ids:
            cur = _locks.get(i)
            if cur is None:
                _locks[i] = {"mode": mode, "count": 1, "priority": 0}
                n += 1
            elif cur["mode"] == "read" and mode == "read":
                cur["count"] += 1
                n += 1
            elif cur["mode"] == mode == "write":
                cur["count"] += 1  # re-entrant
                n += 1
    return n


def _release(ids) -> int:
    n = 0
    with _locks_lock:
        for i in ids:
            cur = _locks.get(i)
            if cur is not None:
                cur["count"] -= 1
                if cur["count"] <= 0:
                    _locks.pop(i, None)
                n += 1
    return n


@register("apoc.lock.nodes")
@register("apoc.lock.batch")
def lock_nodes(nodes):
    return _acquire([_ent_id(v) for v in (nodes or [])], "write")


@register("apoc.lock.readNodes")
def lock_read_nodes(nodes):
    return _acquire([_ent_id(v) for v in (nodes or [])], "read")


@register("apoc.lock.unlockNodes")
@register("apoc.lock.unlockBatch")
def unlock_nodes(nodes):
    return _release([_ent_id(v) for v in (nodes or [])])


@register("apoc.lock.relationships")
def lock_relationships(rels):
    return _acquire([_ent_id(v) for v in (rels or [])], "write")


@register("apoc.lock.readRelationships")
def lock_read_relationships(rels):
    return _acquire([_ent_id(v) for v in (rels or [])], "read")


@register("apoc.lock.unlockRelationships")
def unlock_relationships(rels):
    return _release([_ent_id(v) for v in (rels or [])])


@register("apoc.lock.all")
def lock_all(nodes, rels):
    return lock_nodes(nodes) + lock_relationships(rels)


@register("apoc.lock.unlockAll")
def unlock_all():
    with _locks_lock:
        n = len(_locks)
        _locks.clear()
    return n


@register("apoc.lock.tryLock")
def try_lock(entity):
    i = _ent_id(entity)
    with _locks_lock:
        if i in _locks:
            return False
        _locks[i] = {"mode": "write", "count": 1, "priority": 0}
        return True


@register("apoc.lock.isLocked")
def is_locked(entity):
    with _locks_lock:
        return _ent_id(entity) in _locks


@register("apoc.lock.waitFor")
def wait_for(entity, timeout_ms=1000):
    deadline = time.time() + float(timeout_ms) / 1000.0
    i = _ent_id(entity)
    while time.time() < deadline:
        if try_lock(i):
            return True
        time.sleep(0.005)
    return False


@register("apoc.lock.withLock")
def with_lock(entity, value):
    """Acquire, return value, release (value-form of the reference's
    callback shape, which Cypher cannot pass)."""
    i = _ent_id(entity)
    _acquire([i], "write")
    try:
        return value
    finally:
        _release([i])


@register("apoc.lock.withReadLock")
def with_read_lock(entity, value):
    i = _ent_id(entity)
    _acquire([i], "read")
    try:
        return value
    finally:
        _release([i])


@register("apoc.lock.priority")
def lock_priority(entity, priority):
    with _locks_lock:
        cur = _locks.get(_ent_id(entity))
        if cur is None:
            return False
        cur["priority"] = int(priority)
        return True


@register("apoc.lock.stats")
def lock_stats():
    with _locks_lock:
        reads = sum(1 for v in _locks.values() if v["mode"] == "read")
        return {"held": len(_locks), "read": reads,
                "write": len(_locks) - reads}


@register("apoc.lock.clear")
def lock_clear():
    return unlock_all()


@register("apoc.lock.detectDeadlock")
def detect_deadlock():
    """Single-process registry: no wait-for graph, so never a deadlock
    (same invariant as the reference's embedded-store locks)."""
    return False


# ============================================================ apoc.warmup
_warmup_lock = threading.Lock()
_warmup_state = {"last": None}


@_graph_fn("apoc.warmup.nodes")
def warmup_nodes(ex):
    n = sum(1 for _ in ex.storage.all_nodes())
    return {"nodesLoaded": n}


@_graph_fn("apoc.warmup.relationships")
def warmup_relationships(ex):
    n = sum(1 for _ in ex.storage.all_edges())
    return {"relsLoaded": n}


@_graph_fn("apoc.warmup.properties")
def warmup_properties(ex):
    n = sum(len(x.properties) for x in ex.storage.all_nodes())
    n += sum(len(x.properties) for x in ex.storage.all_edges())
    return {"propertiesLoaded": n}


@_graph_fn("apoc.warmup.indexes")
def warmup_indexes(ex):
    count = 0
    for node in ex.storage.all_nodes():
        ex.schema.index_node(node)
        count += 1
    return {"indexed": count, "indexes": len(ex.schema.list_indexes())}


@_graph_fn("apoc.warmup.cache")
def warmup_cache(ex):
    """Prime the columnar scan index for every label."""
    idx = ex._scan_index()
    labels = set()
    for n in ex.storage.all_nodes():
        labels.update(n.labels)
    warmed = 0
    if idx is not None:
        for label in labels:
            if idx._get(label) is not None:
                warmed += 1
    return {"labelsWarmed": warmed}


@_graph_fn("apoc.warmup.run")
def warmup_run(ex):
    out = {**warmup_nodes(ex), **warmup_relationships(ex),
           **warmup_properties(ex), **warmup_cache(ex)}
    with _warmup_lock:
        _warmup_state["last"] = {"ts": int(time.time() * 1000), **out}
    return out


@_graph_fn("apoc.warmup.runWithParams")
def warmup_run_with_params(ex, config=None):
    cfg = config or {}
    out = {}
    if cfg.get("nodes", True):
        out.update(warmup_nodes(ex))
    if cfg.get("relationships", True):
        out.update(warmup_relationships(ex))
    if cfg.get("properties", False):
        out.update(warmup_properties(ex))
    if cfg.get("cache", False):
        out.update(warmup_cache(ex))
    with _warmup_lock:
        _warmup_state["last"] = {"ts": int(time.time() * 1000), **out}
    return out


@_graph_fn("apoc.warmup.subgraph")
def warmup_subgraph(ex, labels):
    n = 0
    for label in labels or []:
        n += len(ex.storage.get_nodes_by_label(label))
    return {"nodesLoaded": n}


@_graph_fn("apoc.warmup.path")
def warmup_path(ex, start, max_hops=3):
    from nornicdb_tpu_torch.apoc.functions_graph import neighbors_to_hop

    return {"nodesLoaded": len(neighbors_to_hop(ex, start, None, max_hops))}


@register("apoc.warmup.status")
def warmup_status():
    return {"lastRun": _warmup_state["last"]}


@register("apoc.warmup.progress")
def warmup_progress():
    return {"running": False, "lastRun": _warmup_state["last"]}


@register("apoc.warmup.stats")
def warmup_stats():
    return {"lastRun": _warmup_state["last"]}


@register("apoc.warmup.clear")
def warmup_clear():
    with _warmup_lock:
        _warmup_state["last"] = None
    return True


@_graph_fn("apoc.warmup.optimize")
def warmup_optimize(ex):
    return warmup_run(ex)


@register("apoc.warmup.schedule")
def warmup_schedule(interval_seconds):
    """Scheduling belongs to apoc.periodic procedures; records intent."""
    return {"scheduled": False,
            "hint": "use apoc.periodic.repeat with apoc.warmup.run"}


# =========================================================== apoc.trigger
def _trigger_mgr(ex):
    from nornicdb_tpu_torch.apoc.triggers import manager_for

    return manager_for(ex)


@_graph_fn("apoc.trigger.add")
@_graph_fn("apoc.trigger.install")
def trigger_add(ex, name, statement, config=None):
    t = _trigger_mgr(ex).add(str(name), str(statement), dict(config or {}))
    return {"name": t.name, "paused": t.paused}


@_graph_fn("apoc.trigger.remove")
@_graph_fn("apoc.trigger.drop")
def trigger_remove(ex, name):
    return _trigger_mgr(ex).remove(str(name))


@_graph_fn("apoc.trigger.removeAll")
def trigger_remove_all(ex):
    return _trigger_mgr(ex).remove_all()


@_graph_fn("apoc.trigger.list")
def trigger_list(ex):
    return [{"name": t.name, "statement": t.statement, "paused": t.paused}
            for t in _trigger_mgr(ex).list()]


@_graph_fn("apoc.trigger.show")
def trigger_show(ex, name):
    t = _trigger_mgr(ex).get(str(name))
    if t is None:
        return None
    return {"name": t.name, "statement": t.statement, "paused": t.paused,
            "config": dict(t.selector)}


@_graph_fn("apoc.trigger.pause")
@_graph_fn("apoc.trigger.disable")
def trigger_pause(ex, name):
    t = _trigger_mgr(ex).pause(str(name), True)
    return t is not None


@_graph_fn("apoc.trigger.resume")
@_graph_fn("apoc.trigger.enable")
def trigger_resume(ex, name):
    t = _trigger_mgr(ex).pause(str(name), False)
    return t is not None


@_graph_fn("apoc.trigger.isEnabled")
def trigger_is_enabled(ex, name):
    t = _trigger_mgr(ex).get(str(name))
    return t is not None and not t.paused


@_graph_fn("apoc.trigger.count")
def trigger_count(ex):
    return len(_trigger_mgr(ex).list())


@_graph_fn("apoc.trigger.stats")
def trigger_stats(ex):
    ts = _trigger_mgr(ex).list()
    return {"total": len(ts), "paused": sum(1 for t in ts if t.paused)}


@_graph_fn("apoc.trigger.export")
def trigger_export(ex):
    return [{"name": t.name, "statement": t.statement,
             "config": dict(t.selector), "paused": t.paused}
            for t in _trigger_mgr(ex).list()]


@_graph_fn("apoc.trigger.import")
def trigger_import(ex, triggers):
    mgr = _trigger_mgr(ex)
    n = 0
    for spec in triggers or []:
        t = mgr.add(str(spec["name"]), str(spec["statement"]),
                    dict(spec.get("config") or {}))
        if spec.get("paused"):
            mgr.pause(t.name, True)
        n += 1
    return n


def _selector_trigger(ex, name, statement, selector):
    t = _trigger_mgr(ex).add(str(name), str(statement), selector)
    return {"name": t.name, "config": selector}


@_graph_fn("apoc.trigger.nodeByLabel")
def trigger_node_by_label(ex, label, statement):
    return _selector_trigger(ex, f"label-{label}", statement,
                             {"selector": {"label": str(label)}})


@_graph_fn("apoc.trigger.relationshipByType")
def trigger_rel_by_type(ex, rel_type, statement):
    return _selector_trigger(ex, f"type-{rel_type}", statement,
                             {"selector": {"type": str(rel_type)}})


@_graph_fn("apoc.trigger.onCreate")
def trigger_on_create(ex, name, statement):
    return _selector_trigger(ex, name, statement, {"event": "create"})


@_graph_fn("apoc.trigger.onUpdate")
def trigger_on_update(ex, name, statement):
    return _selector_trigger(ex, name, statement, {"event": "update"})


@_graph_fn("apoc.trigger.onDelete")
def trigger_on_delete(ex, name, statement):
    return _selector_trigger(ex, name, statement, {"event": "delete"})


@_graph_fn("apoc.trigger.before")
def trigger_before(ex, name, statement):
    return _selector_trigger(ex, name, statement, {"phase": "before"})


@_graph_fn("apoc.trigger.after")
def trigger_after(ex, name, statement):
    return _selector_trigger(ex, name, statement, {"phase": "after"})


@_graph_fn("apoc.trigger.afterAsync")
def trigger_after_async(ex, name, statement):
    return _selector_trigger(ex, name, statement, {"phase": "afterAsync"})


# ========================================================== apoc.periodic
@_graph_fn("apoc.periodic.iterate")
def periodic_iterate_fn(ex, outer, inner, config=None):
    """Function form of the periodic.iterate procedure: batches the outer
    query's rows through the inner statement; returns {batches, total}."""
    cfg = config or {}
    batch_size = int(cfg.get("batchSize", 1000))
    res = ex.execute(str(outer))
    rows = res.rows_as_dicts()
    total = 0
    batches = 0
    for i in range(0, len(rows), batch_size):
        for row in rows[i:i + batch_size]:
            ex.execute(str(inner), row)
            total += 1
        batches += 1
    return {"batches": batches, "total": total}


@_graph_fn("apoc.periodic.commit")
def periodic_commit_fn(ex, statement, params=None):
    """Re-run until the statement reports no more updates (LIMIT loops)."""
    total = 0
    for _ in range(10_000):
        res = ex.execute(str(statement), params or {})
        n = 0
        if res.rows and isinstance(res.rows[0][0], (int, float)):
            n = int(res.rows[0][0])
        else:
            st = res.stats
            n = (st.nodes_created + st.nodes_deleted + st.properties_set
                 if st else 0)
        total += n
        if n == 0:
            break
    return {"updates": total}


@_graph_fn("apoc.periodic.submit")
def periodic_submit(ex, name, statement):
    """Run once, record as a completed job (the reference's Submit also
    executes immediately in the background)."""
    ex.execute(str(statement))
    with _jobs_lock:
        jobs = _jobs_state.setdefault(id(ex), {})
        jobs[str(name)] = {"name": str(name), "statement": str(statement),
                           "done": True, "cancelled": False}
        return jobs[str(name)]


_jobs_lock = threading.Lock()
_jobs_state: dict[int, dict] = {}


@_graph_fn("apoc.periodic.repeat")
@_graph_fn("apoc.periodic.schedule")
def periodic_repeat(ex, name, statement, interval_s=60):
    """Records the schedule; execution rides the DB's decay/maintenance
    timer rather than an unmanaged thread."""
    with _jobs_lock:
        jobs = _jobs_state.setdefault(id(ex), {})
        jobs[str(name)] = {"name": str(name), "statement": str(statement),
                           "intervalSeconds": int(interval_s), "done": False,
                           "cancelled": False}
        return jobs[str(name)]


@_graph_fn("apoc.periodic.cancel")
def periodic_cancel(ex, name):
    jobs = _jobs_state.get(id(ex), {})
    job = jobs.get(str(name))
    if job is None:
        return False
    job["cancelled"] = True
    return True


@_graph_fn("apoc.periodic.list")
def periodic_list(ex):
    return [j for j in _jobs_state.get(id(ex), {}).values()
            if not j.get("cancelled")]


@_graph_fn("apoc.periodic.countdown")
def periodic_countdown(ex, name, statement, count):
    """Run `statement` `count` times now (bounded synchronous form)."""
    n = 0
    for _ in range(int(count)):
        ex.execute(str(statement))
        n += 1
    return {"name": str(name), "executions": n}


@_graph_fn("apoc.periodic.truncate")
def periodic_truncate(ex, config=None):
    """Delete everything in batches (ref periodic.go Truncate)."""
    deleted = 0
    for n in list(ex.storage.all_nodes()):
        ex.storage.delete_node(n.id)
        deleted += 1
    return {"nodesDeleted": deleted}


@_graph_fn("apoc.periodic.rock")
def periodic_rock(ex, name, config=None):
    """Rock'n'roll alias of iterate (the reference keeps the joke name)."""
    cfg = config or {}
    return periodic_iterate_fn(
        ex, cfg.get("outer", "MATCH (n) RETURN n LIMIT 0"),
        cfg.get("inner", "RETURN 1"), cfg)


# ============================================================ apoc.import
@register("apoc.import.parseCsvLine")
def import_parse_csv_line(line, sep=","):
    reader = _csvmod.reader(io.StringIO(str(line)), delimiter=str(sep))
    for row in reader:
        return row
    return []


@register("apoc.import.parseJsonLine")
def import_parse_json_line(line):
    return _json.loads(str(line))


@register("apoc.import.csvData")
def import_csv_data(data, config=None):
    return _csv_rows(str(data), (config or {}).get("sep", ","))


@register("apoc.import.jsonData")
def import_json_data(data):
    return load_json_stream(data) if "\n" in str(data).strip() \
        else _json.loads(str(data))


@register("apoc.import.convertType")
def import_convert_type(value, type_name):
    t = str(type_name).lower()
    if value is None:
        return None
    if t in ("int", "integer", "long"):
        return int(float(value))
    if t in ("float", "double"):
        return float(value)
    if t in ("bool", "boolean"):
        return str(value).lower() in ("1", "true", "yes")
    if t == "string":
        return str(value)
    if t == "list":
        return list(value) if isinstance(value, (list, tuple)) \
            else [v.strip() for v in str(value).split(";")]
    raise NornicError(f"unknown type {type_name!r}")


@register("apoc.import.validateSchema")
def import_validate_schema(data, schema):
    """Rows must carry every schema key with the right JSON type."""
    rows = data if isinstance(data, list) else [data]
    schema = schema or {}

    def ok(v, t):
        return {
            "string": isinstance(v, str),
            "integer": isinstance(v, int) and not isinstance(v, bool),
            "number": isinstance(v, (int, float)) and not isinstance(v, bool),
            "boolean": isinstance(v, bool),
            "array": isinstance(v, list),
            "object": isinstance(v, dict),
        }.get(str(t).lower(), True)

    bad = []
    for i, row in enumerate(rows):
        for k, t in schema.items():
            if k not in row or not ok(row[k], t):
                bad.append({"row": i, "key": k})
    return {"valid": not bad, "violations": bad}


@_graph_fn("apoc.import.transform")
def import_transform(ex, data, expr):
    """Map rows through a Cypher expression over `row`."""
    from nornicdb_tpu_torch.apoc.functions_graph import _eval_pred

    return [_eval_pred(ex, str(expr), {"row": row}) for row in (data or [])]


@_graph_fn("apoc.import.filter")
def import_filter(ex, data, predicate):
    from nornicdb_tpu_torch.apoc.functions_graph import _eval_pred

    return [row for row in (data or [])
            if _eval_pred(ex, str(predicate), {"row": row}) is True]


@register("apoc.import.merge")
def import_merge(d1, d2):
    return list(d1 or []) + list(d2 or [])


@register("apoc.import.batch")
def import_batch(items, batch_size):
    size = max(int(batch_size), 1)
    items = list(items or [])
    return [items[i:i + size] for i in range(0, len(items), size)]


@register("apoc.import.file")
def import_file(path):
    return _read_local(path)


@register("apoc.import.stream")
def import_stream(data):
    return str(data).splitlines()


@register("apoc.import.url")
def import_url(url):
    raise NornicError(
        "remote URLs are not loadable in this build (zero-egress); "
        "use apoc.import.file with a local path"
    )


@_graph_fn("apoc.import.cypher")
def import_cypher(ex, path):
    from nornicdb_tpu_torch.apoc.functions_graph2 import cypher_run_file

    return cypher_run_file(ex, path)


@_graph_fn("apoc.import.cypherData")
def import_cypher_data(ex, queries):
    out = []
    items = queries if isinstance(queries, list) else str(queries).split(";")
    for q in items:
        q = str(q).strip()
        if q:
            out.append(ex.execute(q).rows_as_dicts())
    return out


@_graph_fn("apoc.import.graphMLData")
def import_graphml_data(ex, xml_string):
    """Create nodes/edges from a GraphML string (data form of the
    apoc.import.graphml procedure)."""
    import tempfile

    with tempfile.NamedTemporaryFile(
        "w", suffix=".graphml", delete=False, encoding="utf-8"
    ) as f:
        f.write(str(xml_string))
        tmp = f.name
    try:
        from nornicdb_tpu_torch.apoc.export_import import import_graphml

        return import_graphml(ex, [tmp], {})
    finally:
        os.unlink(tmp)


# ========================================================== apoc.export
def _graph_data(ex, nodes=None, rels=None):
    if nodes is None:
        nodes = list(ex.storage.all_nodes())
    if rels is None:
        rels = list(ex.storage.all_edges())
    return nodes, rels


@_graph_fn("apoc.export.jsonData")
def export_json_data_fn(ex, nodes=None, rels=None):
    from nornicdb_tpu_torch.apoc.export_import import _json_payload

    return _json_payload(*_graph_data(ex, nodes, rels))


@_graph_fn("apoc.export.csvData")
def export_csv_data_fn(ex, nodes=None, rels=None):
    from nornicdb_tpu_torch.apoc.export_import import _csv_payload

    return _csv_payload(*_graph_data(ex, nodes, rels))


@_graph_fn("apoc.export.cypherData")
def export_cypher_data_fn(ex, nodes=None, rels=None):
    from nornicdb_tpu_torch.apoc.export_import import _cypher_payload

    return _cypher_payload(*_graph_data(ex, nodes, rels))


@_graph_fn("apoc.export.graphMLData")
def export_graphml_data_fn(ex, nodes=None, rels=None):
    from nornicdb_tpu_torch.apoc.export_import import _graphml_payload

    return _graphml_payload(*_graph_data(ex, nodes, rels))


def _export_file(ex, path, payload_fn):
    from nornicdb_tpu_torch.apoc.export_import import _export_allowed

    if not _export_allowed():
        raise NornicError("export is disabled (NORNICDB_APOC_EXPORT_ENABLED)")
    payload = payload_fn()
    with open(str(path), "w", encoding="utf-8") as f:
        f.write(payload)
    return {"file": str(path), "bytes": len(payload)}


@_graph_fn("apoc.export.json")
@_graph_fn("apoc.export.jsonAll")
def export_json_file(ex, path):
    return _export_file(ex, path, lambda: export_json_data_fn(ex))


@_graph_fn("apoc.export.csv")
@_graph_fn("apoc.export.csvAll")
def export_csv_file(ex, path):
    return _export_file(ex, path, lambda: export_csv_data_fn(ex))


@_graph_fn("apoc.export.cypher")
@_graph_fn("apoc.export.cypherAll")
def export_cypher_file(ex, path):
    return _export_file(ex, path, lambda: export_cypher_data_fn(ex))


@_graph_fn("apoc.export.graphML")
@_graph_fn("apoc.export.graphMLAll")
def export_graphml_file(ex, path):
    return _export_file(ex, path, lambda: export_graphml_data_fn(ex))


@register("apoc.export.toString")
def export_to_string(data):
    if isinstance(data, str):
        return data
    return _json.dumps(data, default=str, sort_keys=True)


@register("apoc.export.toFile")
def export_to_file(data, path):
    from nornicdb_tpu_torch.apoc.export_import import _export_allowed

    if not _export_allowed():
        raise NornicError("export is disabled (NORNICDB_APOC_EXPORT_ENABLED)")
    payload = export_to_string(data)
    with open(str(path), "w", encoding="utf-8") as f:
        f.write(payload)
    return {"file": str(path), "bytes": len(payload)}


# ========================================================= apoc.refactor
@_graph_fn("apoc.refactor.renameLabel")
def refactor_rename_label(ex, old, new):
    n = 0
    for node in ex.storage.get_nodes_by_label(str(old)):
        node.labels = [str(new) if l == str(old) else l for l in node.labels]
        ex.storage.update_node(node)
        n += 1
    return n


@_graph_fn("apoc.refactor.renameType")
@_graph_fn("apoc.refactor.changeType")
def refactor_rename_type(ex, old, new):
    n = 0
    for e in list(ex.storage.get_edges_by_type(str(old))):
        ex.storage.delete_edge(e.id)
        ex.storage.create_edge(Edge(
            id=e.id, start_node=e.start_node, end_node=e.end_node,
            type=str(new), properties=dict(e.properties)))
        n += 1
    return n


@_graph_fn("apoc.refactor.renameProperty")
def refactor_rename_property(ex, old, new):
    n = 0
    for node in ex.storage.all_nodes():
        if str(old) in node.properties:
            node.properties[str(new)] = node.properties.pop(str(old))
            ex.storage.update_node(node)
            n += 1
    return n


@_graph_fn("apoc.refactor.setType")
def refactor_set_type(ex, rel, new_type):
    r = _edge(ex, rel)
    ex.storage.delete_edge(r.id)
    return ex.storage.create_edge(Edge(
        id=r.id, start_node=r.start_node, end_node=r.end_node,
        type=str(new_type), properties=dict(r.properties)))


@_graph_fn("apoc.refactor.invertRelationship")
def refactor_invert(ex, rel):
    from nornicdb_tpu_torch.apoc.functions_graph import rel_reverse

    return rel_reverse(ex, rel)


@_graph_fn("apoc.refactor.redirectRelationship")
def refactor_redirect(ex, rel, new_target):
    r = _edge(ex, rel)
    t = _node(ex, new_target)
    ex.storage.delete_edge(r.id)
    return ex.storage.create_edge(Edge(
        id=r.id, start_node=r.start_node, end_node=t.id,
        type=r.type, properties=dict(r.properties)))


@_graph_fn("apoc.refactor.mergeNodes")
def refactor_merge_nodes(ex, nodes):
    from nornicdb_tpu_torch.apoc.functions_graph import nodes_collapse

    return nodes_collapse(ex, nodes)


@_graph_fn("apoc.refactor.mergeRelationships")
def refactor_merge_rels(ex, rels):
    """Merge parallel rels into the first (properties combine, first
    wins)."""
    seq = [_edge(ex, v) for v in (rels or [])]
    if not seq:
        return None
    target = seq[0]
    for other in seq[1:]:
        for k, v in other.properties.items():
            target.properties.setdefault(k, v)
        ex.storage.delete_edge(other.id)
    return ex.storage.update_edge(target)


@_graph_fn("apoc.refactor.cloneNodes")
def refactor_clone_nodes(ex, nodes, with_rels=False):
    from nornicdb_tpu_torch.apoc.functions_graph import node_clone

    clones = []
    mapping = {}
    for v in nodes or []:
        n = _node(ex, v)
        c = node_clone(ex, n)
        mapping[n.id] = c
        clones.append(c)
    if with_rels:
        for v in nodes or []:
            n = _node(ex, v)
            for r in ex.storage.get_outgoing_edges(n.id):
                if r.end_node in mapping:
                    ex.storage.create_edge(Edge(
                        id=f"apoc-{_uuid.uuid4()}",
                        start_node=mapping[n.id].id,
                        end_node=mapping[r.end_node].id,
                        type=r.type, properties=dict(r.properties)))
    return clones


@_graph_fn("apoc.refactor.cloneSubgraph")
def refactor_clone_subgraph(ex, nodes, rels=None):
    from nornicdb_tpu_torch.apoc.functions_graph2 import create_clone_subgraph

    if rels is None:
        ids = {(_node(ex, v)).id for v in (nodes or [])}
        rels = [r for nid in ids for r in ex.storage.get_outgoing_edges(nid)
                if r.end_node in ids]
    return create_clone_subgraph(ex, nodes, rels)


@_graph_fn("apoc.refactor.cloneSubgraphFromPaths")
def refactor_clone_subgraph_from_paths(ex, paths):
    nodes: dict[str, str] = {}
    for p in paths or []:
        for nid in (p if isinstance(p, list) else p.get("nodes", [])):
            nid = nid.id if isinstance(nid, Node) else str(nid)
            nodes[nid] = nid
    return refactor_clone_subgraph(ex, list(nodes))


@_graph_fn("apoc.refactor.extractNode")
def refactor_extract_node(ex, rel, labels=None):
    """Turn a relationship into a node with IN/OUT rels (ref
    refactor.go ExtractNode)."""
    r = _edge(ex, rel)
    mid = ex.storage.create_node(Node(
        id=f"apoc-{_uuid.uuid4()}", labels=list(labels or [r.type]),
        properties=dict(r.properties)))
    ex.storage.delete_edge(r.id)
    ex.storage.create_edge(Edge(
        id=f"apoc-{_uuid.uuid4()}", start_node=r.start_node,
        end_node=mid.id, type="IN", properties={}))
    ex.storage.create_edge(Edge(
        id=f"apoc-{_uuid.uuid4()}", start_node=mid.id,
        end_node=r.end_node, type="OUT", properties={}))
    return mid


@_graph_fn("apoc.refactor.collapseNode")
def refactor_collapse_node(ex, node, rel_type=None):
    """Inverse of extractNode: replace a node with a direct rel between its
    single in- and out-neighbor."""
    n = _node(ex, node)
    ins = ex.storage.get_incoming_edges(n.id)
    outs = ex.storage.get_outgoing_edges(n.id)
    if len(ins) != 1 or len(outs) != 1:
        raise NornicError(
            "collapseNode requires exactly one incoming and one outgoing "
            "relationship")
    new_type = str(rel_type or f"{ins[0].type}_{outs[0].type}")
    props = {**ins[0].properties, **outs[0].properties, **n.properties}
    start, end = ins[0].start_node, outs[0].end_node
    ex.storage.delete_node(n.id)  # cascades the two rels
    return ex.storage.create_edge(Edge(
        id=f"apoc-{_uuid.uuid4()}", start_node=start, end_node=end,
        type=new_type, properties=props))


@_graph_fn("apoc.refactor.deleteAndReconnect")
def refactor_delete_and_reconnect(ex, node):
    """Delete a node, reconnecting each in-neighbor to each out-neighbor."""
    n = _node(ex, node)
    ins = ex.storage.get_incoming_edges(n.id)
    outs = ex.storage.get_outgoing_edges(n.id)
    created = []
    for i in ins:
        for o in outs:
            if i.start_node == n.id or o.end_node == n.id:
                continue
            created.append(ex.storage.create_edge(Edge(
                id=f"apoc-{_uuid.uuid4()}", start_node=i.start_node,
                end_node=o.end_node, type=o.type,
                properties=dict(o.properties))))
    ex.storage.delete_node(n.id)
    return created


@_graph_fn("apoc.refactor.normalize")
def refactor_normalize(ex, node, prop, mapping):
    """Map a property's raw values through a {raw: normalized} table."""
    n = _node(ex, node)
    v = n.properties.get(str(prop))
    if v in (mapping or {}):
        n.properties[str(prop)] = mapping[v]
        ex.storage.update_node(n)
    return n


@_graph_fn("apoc.refactor.normalizeAsBoolean")
def refactor_normalize_bool(ex, node, prop, true_values, false_values):
    n = _node(ex, node)
    v = n.properties.get(str(prop))
    if v in (true_values or []):
        n.properties[str(prop)] = True
        ex.storage.update_node(n)
    elif v in (false_values or []):
        n.properties[str(prop)] = False
        ex.storage.update_node(n)
    return n


@_graph_fn("apoc.refactor.categorizeProperty")
def refactor_categorize(ex, prop, rel_type, label):
    """Extract a property into category nodes linked by rel_type (ref
    refactor.go Categorize)."""
    cats: dict[str, Node] = {}
    n_linked = 0
    for node in list(ex.storage.all_nodes()):
        v = node.properties.get(str(prop))
        if v is None or str(label) in node.labels:
            continue
        key = str(v)
        cat = cats.get(key)
        if cat is None:
            for existing in ex.storage.get_nodes_by_label(str(label)):
                if existing.properties.get("name") == v:
                    cat = existing
                    break
            if cat is None:
                cat = ex.storage.create_node(Node(
                    id=f"apoc-{_uuid.uuid4()}", labels=[str(label)],
                    properties={"name": v}))
            cats[key] = cat
        ex.storage.create_edge(Edge(
            id=f"apoc-{_uuid.uuid4()}", start_node=node.id,
            end_node=cat.id, type=str(rel_type), properties={}))
        node.properties.pop(str(prop), None)
        ex.storage.update_node(node)
        n_linked += 1
    return {"categories": len(cats), "linked": n_linked}


@_graph_fn("apoc.refactor.denormalize")
def refactor_denormalize(ex, node, rel_type, prop):
    """Copy a neighbor's property back onto the node (inverse of
    categorizeProperty)."""
    n = _node(ex, node)
    for r in ex.storage.get_outgoing_edges(n.id):
        if r.type == str(rel_type):
            cat = ex.get_node_or_none(r.end_node)
            if cat is not None and "name" in cat.properties:
                n.properties[str(prop)] = cat.properties["name"]
                ex.storage.update_node(n)
                break
    return n


@_graph_fn("apoc.refactor.from")
def refactor_from(ex, rel, new_start):
    r = _edge(ex, rel)
    s = _node(ex, new_start)
    ex.storage.delete_edge(r.id)
    return ex.storage.create_edge(Edge(
        id=r.id, start_node=s.id, end_node=r.end_node,
        type=r.type, properties=dict(r.properties)))
