"""Request tracing: contextvar-propagated spans in a bounded ring buffer.

A copy of ``nornicdb_tpu/telemetry/tracing.py`` (the port imports nothing of
the JAX package): family names, help text, label names, span names and
environment variables are the JAX package's, so one dashboard reads both.

A trace starts at an ingress (HTTP dispatch, Bolt RUN, gRPC search,
replication RPC delivery) via ``tracer.start_trace(...)`` and flows to
every ``tracer.span(...)`` below it on the same logical context: child
threads inherit via ``contextvars.copy_context()`` (the Raft broadcast
hop), explicit worker hand-offs use ``tracer.capture()`` +
``tracer.attach()`` (the QueryBatcher hop), and process boundaries carry
W3C ``traceparent`` (HTTP header, replication Message field).

Always-on-cheap contract (asserted by the ``-m slow`` microbench in
tests/test_telemetry.py): when tracing is disabled, or no trace is active
on the context, or the trace was not sampled, ``tracer.span()`` performs
ONE contextvar read and returns a shared no-op handle — no allocation, no
locking, no formatting.

Completed traces land in a bounded ring buffer (``deque(maxlen=...)``,
whose appends are atomic under the GIL — no lock held while recording)
served at ``/admin/traces`` and ``/admin/traces/<id>``.  Span lists are
plain lists appended in finish order; ``list.append`` is atomic, so a
worker thread finishing a span never blocks an ingress thread.  A span
finishing after its root closed still lands in the (already ringed)
trace — late device work stays visible.
"""

from __future__ import annotations

import contextvars
import os
import random
import re
import time
import uuid
from collections import deque
from typing import Any, Optional

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)

# spans recorded per trace before further spans are counted-but-dropped
MAX_SPANS_PER_TRACE = 512


def parse_traceparent(header: str) -> Optional[tuple[str, str, bool]]:
    """-> (trace_id, parent_span_id, sampled) or None if malformed
    (W3C trace-context: version-traceid-parentid-flags)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id, bool(int(flags, 16) & 0x01)


def format_traceparent(trace_id: str, span_id: str, sampled: bool = True) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def _new_trace_id() -> str:
    return uuid.uuid4().hex


def _new_span_id() -> str:
    return os.urandom(8).hex()


class _Trace:
    """Collector for one trace: finished-span records + identity."""

    __slots__ = (
        "trace_id", "root_span_id", "remote_parent", "started_wall",
        "spans", "dropped_spans",
    )

    def __init__(self, trace_id: str, root_span_id: str,
                 remote_parent: Optional[str]):
        self.trace_id = trace_id
        self.root_span_id = root_span_id
        self.remote_parent = remote_parent
        self.started_wall = time.time()
        self.spans: list[dict[str, Any]] = []
        self.dropped_spans = 0

    def record(self, rec: dict[str, Any]) -> None:
        if len(self.spans) >= MAX_SPANS_PER_TRACE:
            self.dropped_spans += 1
            return
        self.spans.append(rec)  # list.append: atomic under the GIL


class _NoopSpan:
    """Shared handle for the disabled/unsampled path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_attr(self, key: str, value: Any) -> None:
        pass

    # duck-typed introspection used by ingress code
    trace_id = None
    span_id = None

    def traceparent(self) -> Optional[str]:
        return None


NOOP_SPAN = _NoopSpan()


class Span:
    __slots__ = (
        "_tracer", "trace", "name", "span_id", "parent_id",
        "_t0", "_start_wall", "attrs", "_token", "_is_root", "error",
    )

    def __init__(self, tracer: "Tracer", trace: _Trace, name: str,
                 parent_id: Optional[str], is_root: bool,
                 attrs: Optional[dict] = None):
        self._tracer = tracer
        self.trace = trace
        self.name = name
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.attrs = dict(attrs) if attrs else None
        self._is_root = is_root
        self.error = None
        self._token: Optional[contextvars.Token] = None
        self._t0 = 0.0
        self._start_wall = 0.0

    @property
    def trace_id(self) -> str:
        return self.trace.trace_id

    def traceparent(self) -> str:
        return format_traceparent(self.trace.trace_id, self.span_id)

    def set_attr(self, key: str, value: Any) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        self._start_wall = time.time()
        self._t0 = time.perf_counter()
        self._token = self._tracer._var.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        duration = time.perf_counter() - self._t0
        if self._token is not None:
            self._tracer._var.reset(self._token)
            self._token = None
        if exc is not None:
            self.error = f"{type(exc).__name__}: {exc}"
        rec = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self._start_wall,
            "duration_ms": duration * 1e3,
        }
        if self.attrs:
            rec["attrs"] = self.attrs
        if self.error:
            rec["error"] = self.error
        self.trace.record(rec)
        if self._is_root:
            self._tracer._finish(self.trace, self.name, duration)
        return False


class _Attach:
    """Re-enter a captured span on another thread's context (worker
    hand-off, e.g. the QueryBatcher flush thread)."""

    __slots__ = ("_tracer", "_span", "_token")

    def __init__(self, tracer: "Tracer", span: Optional[Span]):
        self._tracer = tracer
        self._span = span
        self._token = None

    def __enter__(self) -> Optional[Span]:
        if self._span is not None:
            self._token = self._tracer._var.set(self._span)
        return self._span

    def __exit__(self, *exc) -> bool:
        if self._token is not None:
            self._tracer._var.reset(self._token)
            self._token = None
        return False


class Tracer:
    def __init__(self, capacity: int = 256):
        self.enabled = os.environ.get(
            "NORNICDB_TRACING", "1"
        ).lower() not in ("0", "false", "no")
        try:
            self.sample_rate = float(
                os.environ.get("NORNICDB_TRACE_SAMPLE", "1.0")
            )
        except ValueError:
            self.sample_rate = 1.0
        self._ring: deque[dict[str, Any]] = deque(maxlen=capacity)
        self._var: contextvars.ContextVar[Optional[Span]] = (
            contextvars.ContextVar("nornicdb_trace_span", default=None)
        )

    def configure(self, enabled=None, sample_rate=None, capacity=None) -> None:
        if enabled is not None:
            self.enabled = bool(enabled)
        if sample_rate is not None:
            self.sample_rate = float(sample_rate)
        if capacity is not None:
            self._ring = deque(self._ring, maxlen=int(capacity))

    # -- span creation -----------------------------------------------------
    def start_trace(self, name: str, traceparent: Optional[str] = None,
                    attrs: Optional[dict] = None):
        """Open a ROOT span (new trace, or continuing an incoming
        ``traceparent``'s trace id).  Unsampled/disabled -> no-op handle."""
        if not self.enabled:
            return NOOP_SPAN
        trace_id = remote_parent = None
        sampled = None
        if traceparent:
            parsed = parse_traceparent(traceparent)
            if parsed is not None:
                trace_id, remote_parent, sampled = parsed
        if sampled is None:
            sampled = (
                self.sample_rate >= 1.0
                or random.random() < self.sample_rate
            )
        if not sampled:
            return NOOP_SPAN
        trace = _Trace(trace_id or _new_trace_id(), "", remote_parent)
        span = Span(self, trace, name, remote_parent, is_root=True,
                    attrs=attrs)
        trace.root_span_id = span.span_id
        return span

    def span(self, name: str, attrs: Optional[dict] = None):
        """Child span of the context's active span; shared no-op handle
        when no trace is active (ONE contextvar read, no allocation)."""
        cur = self._var.get()
        if cur is None:
            return NOOP_SPAN
        return Span(self, cur.trace, name, cur.span_id, is_root=False,
                    attrs=attrs)

    def add_span(self, name: str, start_perf: float, end_perf: float,
                 attrs: Optional[dict] = None,
                 parent: Optional[Span] = None) -> None:
        """Retroactively record a completed span (measured with
        perf_counter timestamps) under ``parent`` or the active span —
        used where the timing is known only after the fact (per-caller
        queue wait inside a shared batch)."""
        cur = parent if parent is not None else self._var.get()
        if cur is None or isinstance(cur, _NoopSpan):
            return
        rec = {
            "name": name,
            "span_id": _new_span_id(),
            "parent_id": cur.span_id,
            # display WALL timestamp back-derived from the perf offset; the
            # duration itself is pure perf_counter arithmetic
            "start": time.time()
            - (time.perf_counter() - start_perf),
            "duration_ms": (end_perf - start_perf) * 1e3,
        }
        if attrs:
            rec["attrs"] = dict(attrs)
        cur.trace.record(rec)

    # -- context plumbing --------------------------------------------------
    def capture(self) -> Optional[Span]:
        """The active span, for hand-off to a worker via ``attach()``."""
        return self._var.get()

    def attach(self, span: Optional[Span]) -> _Attach:
        return _Attach(self, span)

    def current_traceparent(self) -> Optional[str]:
        cur = self._var.get()
        if cur is None:
            return None
        return cur.traceparent()

    def current_trace_id(self) -> Optional[str]:
        cur = self._var.get()
        return None if cur is None else cur.trace.trace_id

    # -- cross-process merge ------------------------------------------------
    def merge_remote(
        self,
        trace_id: str,
        spans: list[dict],
        root: Optional[str] = None,
        started: Optional[float] = None,
        duration_ms: Optional[float] = None,
        proc: Optional[str] = None,
    ) -> bool:
        """Merge span records exported by ANOTHER process (a prefork
        worker shipping its finished trace over the device broker) into
        the local ring, so ``/admin/traces/<id>`` renders one tree
        spanning both processes.

        Spans keep their own ``span_id``/``parent_id`` identities — the
        worker's traceparent hand-off means local spans already point at
        the remote caller's span id, so the tree builder nests them
        without any re-parenting.  Each merged record is tagged with the
        originating ``proc`` so the tree says which process ran what.
        Records land in the NEWEST ring entry with this trace id, or a
        fresh entry when the local process never recorded one (e.g. a
        shm-served worker search that never touched the primary)."""
        if not self.enabled or not trace_id:
            return False
        clean: list[dict[str, Any]] = []
        for rec in list(spans)[:MAX_SPANS_PER_TRACE]:
            if not isinstance(rec, dict) or not rec.get("span_id"):
                continue
            r = dict(rec)
            if proc:
                r["proc"] = proc
            clean.append(r)
        if not clean:
            return False
        found = None
        # snapshot: iterating the live deque races root-span finishes
        for t in list(self._ring):
            if t["trace_id"] == trace_id:
                found = t  # latest entry with this id wins
        if found is not None:
            found["spans"].extend(clean)  # list.extend: atomic under GIL
            return True
        self._ring.append({
            "trace_id": trace_id,
            "root": root or (clean[0].get("name") or "remote"),
            "started": started if started is not None
            else (clean[0].get("start") or time.time()),
            "duration_ms": duration_ms if duration_ms is not None
            else max((s.get("duration_ms") or 0.0) for s in clean),
            "spans": clean,
            "dropped_spans": 0,
            "remote_parent": None,
        })
        return True

    # -- ring buffer -------------------------------------------------------
    def _finish(self, trace: _Trace, root_name: str, duration: float) -> None:
        self._ring.append({
            "trace_id": trace.trace_id,
            "root": root_name,
            "started": trace.started_wall,
            "duration_ms": duration * 1e3,
            "spans": trace.spans,
            "dropped_spans": trace.dropped_spans,
            "remote_parent": trace.remote_parent,
        })

    def count(self) -> int:
        return len(self._ring)

    def traces(self, limit: int = 100) -> list[dict[str, Any]]:
        """Newest-first summaries for /admin/traces."""
        entries = list(self._ring)[-limit:][::-1]
        return [
            {
                "trace_id": t["trace_id"],
                "root": t["root"],
                "started": t["started"],
                "duration_ms": round(t["duration_ms"], 3),
                "span_count": len(t["spans"]),
                "dropped_spans": t["dropped_spans"],
            }
            for t in entries
        ]

    def trace(self, trace_id: str) -> Optional[dict[str, Any]]:
        """Full span tree for /admin/traces/<id> (children nested under
        parents; spans with a missing parent surface at the top level).

        A trace id may own SEVERAL ring entries — a worker's root and the
        broker handler continuing it in-process, or a replication peer's
        handler entries — so the detail view merges every matching
        entry's spans (deduped by span id) into one tree; identity
        fields come from the latest entry, preserving the old
        single-entry behavior."""
        # snapshot first: iterating the live deque would raise if another
        # thread's root span finishes (ring append) mid-scan
        matches = [t for t in list(self._ring)
                   if t["trace_id"] == trace_id]
        if not matches:
            return None
        found = matches[-1]  # latest entry wins the identity fields
        if len(matches) == 1:
            spans = list(found["spans"])
        else:
            seen_ids: set = set()
            spans = []
            for t in matches:
                for rec in list(t["spans"]):
                    sid = rec.get("span_id")
                    if sid in seen_ids:
                        continue
                    seen_ids.add(sid)
                    spans.append(rec)
        nodes = {
            rec["span_id"]: dict(rec, children=[]) for rec in spans
        }
        roots = []
        for rec in spans:
            node = nodes[rec["span_id"]]
            # .get(): remote-merged records may omit parent_id entirely
            parent = nodes.get(rec.get("parent_id") or "")
            if parent is not None and parent is not node:
                parent["children"].append(node)
            else:
                roots.append(node)
        for node in nodes.values():
            node["children"].sort(key=lambda n: n.get("start", 0.0))
        roots.sort(key=lambda n: n.get("start", 0.0))
        return {
            "trace_id": found["trace_id"],
            "root": found["root"],
            "started": found["started"],
            "duration_ms": found["duration_ms"],
            "dropped_spans": found["dropped_spans"],
            "remote_parent": found["remote_parent"],
            "spans": spans,  # flat finish-order list (tree view below)
            "tree": roots,
        }

    def clear(self) -> None:
        self._ring.clear()


tracer = Tracer()
