"""Telemetry of the port (``nornicdb_tpu_torch/telemetry``) on the CPU.

- the ``TestRegistry``, ``TestTracing``, ``TestSlowLog``,
  ``TestBatcherTelemetry`` and ``TestOverheadMicrobench`` cases of
  ``tests/test_telemetry.py``, against the port (the slow-log cases that
  drive the Cypher executor wait for it);
- one sequence of registry operations renders byte-identical exposition
  text in both packages;
- after the same small CPU run of the ``ServingEngine``, the
  ``GenerationEngine`` and the ``SearchService`` in both packages, the two
  process registries have the same family names, TYPE and HELP lines and
  label names for every family the engines report, and equal counts where
  the run is deterministic. Each package has its own ``REGISTRY``, so each
  render is read against its own engines, by differences across the run
  (other tests in the process move the counters too);
- ``capture_profile`` on the CPU returns a gzipped tar holding a Chrome
  trace, and a capture that overlaps it raises ``ProfileBusy``;
- the device-residency gauge and the build-info cell.
"""

from __future__ import annotations

import dataclasses
import io
import json
import tarfile
import threading
import time

import jax
import numpy as np
import pytest

from nornicdb_tpu.telemetry import metrics as jmetrics
from nornicdb_tpu.telemetry.promparse import parse_exposition
from nornicdb_tpu_torch.telemetry import deviceprof
from nornicdb_tpu_torch.telemetry import metrics as tmetrics
from nornicdb_tpu_torch.telemetry import slowlog as tslowlog
from nornicdb_tpu_torch.telemetry.slowlog import slow_log
from nornicdb_tpu_torch.telemetry.tracing import (
    format_traceparent,
    parse_traceparent,
    tracer,
)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """The tracer/slow-log singletons are process-global; every test starts
    from an empty ring and the default thresholds."""
    tracer.clear()
    slow_log.clear()
    slow_log.recorded = 0
    old_threshold = slow_log.threshold_s
    old_enabled, old_rate = tracer.enabled, tracer.sample_rate
    yield
    tracer.clear()
    slow_log.clear()
    slow_log.configure(threshold_s=old_threshold)
    tracer.configure(enabled=old_enabled, sample_rate=old_rate)


# ---------------------------------------------------------------- registry
class TestRegistry:
    def test_counter_gauge_labels_and_render(self):
        r = tmetrics.Registry()
        c = r.counter("t_total", "helptext", labels=("kind",))
        c.labels("a").inc()
        c.labels("a").inc(2)
        c.labels("b").inc()
        g = r.gauge("t_gauge", "g")
        g.set(2.5)
        text = r.render_prometheus()
        assert "# HELP t_total helptext" in text
        assert "# TYPE t_total counter" in text
        assert 't_total{kind="a"} 3' in text
        assert 't_total{kind="b"} 1' in text
        assert "t_gauge 2.5" in text

    def test_integral_values_render_without_decimal(self):
        r = tmetrics.Registry()
        c = r.counter("big_total")
        c.inc(12345678)  # {:g} would render 1.23457e+07
        assert "big_total 12345678" in r.render_prometheus()

    def test_histogram_triples_cumulative(self):
        r = tmetrics.Registry()
        h = r.histogram("lat_seconds", "lat", buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 5.0, 0.01):  # 0.01 == bound: le includes it
            h.observe(v)
        text = r.render_prometheus()
        assert 'lat_seconds_bucket{le="0.01"} 2' in text
        assert 'lat_seconds_bucket{le="0.1"} 3' in text
        assert 'lat_seconds_bucket{le="1"} 3' in text
        assert 'lat_seconds_bucket{le="+Inf"} 4' in text
        assert "lat_seconds_count 4" in text
        assert "lat_seconds_sum" in text

    def test_label_escaping(self):
        r = tmetrics.Registry()
        c = r.counter("esc_total", labels=("q",))
        c.labels('say "hi"\nback\\slash').inc()
        text = r.render_prometheus()
        assert r'q="say \"hi\"\nback\\slash"' in text

    def test_idempotent_registration_and_kind_conflict(self):
        r = tmetrics.Registry()
        a = r.counter("same_total", labels=("x",))
        b = r.counter("same_total", labels=("x",))
        assert a is b
        with pytest.raises(ValueError):
            r.gauge("same_total")

    def test_stats_adapter_flatten_rename_counters(self):
        r = tmetrics.Registry()
        r.stats_callback(
            "app", lambda: {"sub": {"hits": 3, "ratio": 0.5, "skip": "str"}},
            rename={"app_sub_hits": "app_sub_hits_total"},
            counters={"app_sub_hits"},
        )
        text = r.render_prometheus()
        assert "# TYPE app_sub_hits_total counter" in text
        assert "app_sub_hits_total 3" in text
        assert "# TYPE app_sub_ratio gauge" in text
        assert "skip" not in text

    def test_dead_callback_does_not_break_render(self):
        r = tmetrics.Registry()
        r.gauge_callback("boom", "", lambda: 1 / 0)
        r.gauge("ok").set(1)
        text = r.render_prometheus()
        assert "ok 1" in text and "boom" not in text

    def test_parent_chain_renders_parent_families(self):
        parent = tmetrics.Registry()
        parent.counter("p_total").inc()
        child = tmetrics.Registry(parent=parent)
        child.gauge("c_gauge").set(1)
        text = child.render_prometheus()
        assert "p_total 1" in text and "c_gauge 1" in text


# ---------------------------------------------------------------- tracing
class TestTracing:
    def test_span_nesting_and_ring(self):
        with tracer.start_trace("root") as root:
            with tracer.span("child") as c1:
                with tracer.span("grandchild"):
                    pass
            assert c1.parent_id == root.span_id
        entry = tracer.trace(root.trace_id)
        assert entry is not None
        tree = entry["tree"]
        assert tree[0]["name"] == "root"
        assert tree[0]["children"][0]["name"] == "child"
        assert tree[0]["children"][0]["children"][0]["name"] == "grandchild"

    def test_span_without_trace_is_shared_noop(self):
        s1 = tracer.span("a")
        s2 = tracer.span("b")
        assert s1 is s2  # the shared no-op handle: no allocation
        with s1 as s:
            s.set_attr("k", "v")  # must not blow up
        assert tracer.count() == 0

    def test_traceparent_roundtrip(self):
        tp = format_traceparent("ab" * 16, "cd" * 8)
        parsed = parse_traceparent(tp)
        assert parsed == ("ab" * 16, "cd" * 8, True)
        assert parse_traceparent("junk") is None
        assert parse_traceparent(
            "00-" + "0" * 32 + "-" + "cd" * 8 + "-01") is None

    def test_incoming_traceparent_continues_trace(self):
        tp = format_traceparent("12" * 16, "34" * 8)
        with tracer.start_trace("server", traceparent=tp) as root:
            assert root.trace_id == "12" * 16
            assert root.parent_id == "34" * 8
        entry = tracer.trace("12" * 16)
        assert entry["remote_parent"] == "34" * 8

    def test_unsampled_and_disabled_paths_record_nothing(self):
        tracer.configure(sample_rate=0.0)
        assert tracer.start_trace("x") is tracer.span("y")
        tracer.configure(sample_rate=1.0, enabled=False)
        assert tracer.start_trace("x") is tracer.span("y")
        assert tracer.count() == 0

    def test_sampled_flag_zero_suppresses(self):
        tp = format_traceparent("ab" * 16, "cd" * 8, sampled=False)
        assert tracer.start_trace("x", traceparent=tp) is tracer.span("y")

    def test_ring_is_bounded(self):
        tracer.configure(capacity=8)
        try:
            for i in range(20):
                with tracer.start_trace(f"t{i}"):
                    pass
            assert tracer.count() == 8
            assert tracer.traces()[0]["root"] == "t19"  # newest first
        finally:
            tracer.configure(capacity=256)

    def test_cross_thread_attach(self):
        seen = {}

        def worker(ctx):
            with tracer.attach(ctx):
                with tracer.span("worker.step"):
                    seen["trace"] = tracer.current_trace_id()

        with tracer.start_trace("root") as root:
            ctx = tracer.capture()
            t = threading.Thread(target=worker, args=(ctx,))
            t.start()
            t.join()
        assert seen["trace"] == root.trace_id
        names = {s["name"] for s in tracer.trace(root.trace_id)["spans"]}
        assert "worker.step" in names

    def test_add_span_retroactive(self):
        t0 = time.perf_counter()
        t1 = t0 + 0.25
        with tracer.start_trace("root") as root:
            tracer.add_span("queued", t0, t1)
        spans = tracer.trace(root.trace_id)["spans"]
        rec = next(s for s in spans if s["name"] == "queued")
        assert rec["parent_id"] == root.span_id
        assert 240 < rec["duration_ms"] < 260

    def test_error_recorded_on_exception(self):
        with pytest.raises(ValueError):
            with tracer.start_trace("root") as root:
                raise ValueError("boom")
        spans = tracer.trace(root.trace_id)["spans"]
        assert "ValueError: boom" in spans[0]["error"]


# ---------------------------------------------------------------- slow log
class TestSlowLog:
    def test_redact_query_strips_string_literals(self):
        q = "MATCH (n {name: 'secret', note: \"two words\"}) RETURN n"
        red = tslowlog.redact_query(q)
        assert "secret" not in red and "two words" not in red
        assert red.count("'?'") == 2

    def test_redact_params_keeps_shapes_only(self):
        red = tslowlog.redact_params(
            {"s": "classified", "n": 42, "lst": [1, 2, 3], "d": {"a": 1}}
        )
        assert red == {"s": "<str[10]>", "n": "<int>",
                       "lst": "<list[3]>", "d": "<dict[1]>"}
        assert "classified" not in json.dumps(red)

    def test_threshold_zero_disables(self):
        slow_log.configure(threshold_s=0.0)
        assert not slow_log.maybe_record("RETURN 1", {}, 5.0)
        assert slow_log.recorded == 0 and not slow_log.snapshot()

    def test_ring_bounded(self):
        slow_log.configure(threshold_s=1e-9, capacity=4)
        try:
            for i in range(10):
                slow_log.maybe_record(f"RETURN {i}", {}, 1.0)
            assert len(slow_log.snapshot()) == 4
            assert slow_log.recorded == 10
            assert "RETURN 9" in slow_log.snapshot()[0]["query"]
        finally:
            slow_log.configure(capacity=128)


# ---------------------------------------------------------------- batcher
class TestBatcherTelemetry:
    def test_queue_wait_span_lands_in_caller_trace(self):
        from nornicdb_tpu_torch.search.batcher import QueryBatcher

        def batch_fn(queries, k, min_sim):
            return [[("id", 0.9)] for _ in range(queries.shape[0])]

        b = QueryBatcher(batch_fn, window=0.01, max_batch=8)
        try:
            with tracer.start_trace("caller") as root:
                res = b.search(np.ones(4, np.float32), k=1)
        finally:
            b.close()
        assert res == [("id", 0.9)]
        entry = tracer.trace(root.trace_id)
        names = {s["name"] for s in entry["spans"]}
        assert "search.queue_wait" in names
        assert "search.batch" in names  # leader's device span
        assert b.stats.batches == 1


# ------------------------------------------------------------ microbench
class TestOverheadMicrobench:
    """The always-on-cheap bound: with no active trace, the instrumented
    hot path runs within a small constant factor of the un-instrumented
    baseline (one contextvar read, no allocation)."""

    N = 50_000

    @staticmethod
    def _work(state: dict, i: int) -> None:
        state["k"] = i
        state["acc"] = state.get("acc", 0) + (i & 7)

    @staticmethod
    def _bench(baseline, instrumented) -> tuple[float, float]:
        """Best of five rounds of each, the two runs alternating within a
        round, so a burst of load on the machine lands on both sides."""
        best = [float("inf"), float("inf")]
        for _ in range(5):
            for k, fn in enumerate((baseline, instrumented)):
                t0 = time.perf_counter()
                fn()
                best[k] = min(best[k], time.perf_counter() - t0)
        return best[0], best[1]

    def test_untraced_span_overhead_bounded(self):
        state: dict = {}
        work = self._work

        def baseline():
            for i in range(self.N):
                work(state, i)

        def instrumented():
            for i in range(self.N):
                with tracer.span("bench.op"):
                    work(state, i)

        assert tracer.capture() is None  # no active trace on this context
        base, instr = self._bench(baseline, instrumented)
        ratio = instr / base
        assert ratio < 8.0, f"no-trace span path too slow: {ratio:.2f}x"

    def test_disabled_tracer_overhead_bounded(self):
        state: dict = {}
        work = self._work
        tracer.configure(enabled=False)

        def baseline():
            for i in range(self.N):
                work(state, i)

        def instrumented():
            for i in range(self.N):
                with tracer.start_trace("bench.request"):
                    work(state, i)

        base, instr = self._bench(baseline, instrumented)
        ratio = instr / base
        assert ratio < 8.0, f"disabled ingress path too slow: {ratio:.2f}x"


# --------------------------------------------------- renders vs the JAX one
def _registry_ops(m) -> str:
    """One sequence of registry operations on a fresh registry of metrics
    module ``m``; returns its exposition text."""
    r = m.Registry()
    c = r.counter("ops_total", "operations by kind", labels=("kind", "q"))
    c.labels("read", "a").inc()
    c.labels("write", 'say "hi"\nback\\slash').inc(41)
    c.labels("read", "a").inc(0.5)
    g = r.gauge("ops_depth", "queue depth")
    g.set(3)
    g.inc(2.25)
    g.labels().dec(1)
    r.counter_callback("ops_cb_total", "a counter callback", lambda: 9)
    h = r.histogram("ops_seconds", "latency", labels=("route",))
    for v in (0.0004, 0.003, 0.02, 0.2, 2.0, 20.0):
        h.labels("embed").observe(v)
    b = r.histogram("ops_bytes", "bytes", buckets=m.BYTE_BUCKETS)
    for v in (100, 5000, 3e6, 1e10):
        b.observe(v)
    r.counter("big_total").inc(12345678)
    r.gauge_callback("ops_live", "a live callback", lambda: 7.5)
    r.stats_callback(
        "app", lambda: {"sub": {"hits": 3, "ratio": 0.5, "skip": "s"}},
        rename={"app_sub_hits": "app_sub_hits_total"},
        counters={"app_sub_hits"},
    )
    child = m.Registry(parent=r)
    child.gauge("child_gauge", "child").set(1)
    return child.render_prometheus()


def test_registry_render_byte_identical():
    assert _registry_ops(tmetrics) == _registry_ops(jmetrics)


# the families the ported engines report (serving/stats.py,
# genserve/stats.py, the batcher, the corpus sync, the tuner, deviceprof
# and the cost model)
ENGINE_FAMILIES = (
    "nornicdb_serving_packed_tokens", "nornicdb_serving_pack_efficiency",
    "nornicdb_serving_sheds_total", "nornicdb_serving_staging_overlap_ratio",
    "nornicdb_serving_embedder", "nornicdb_serving_queue_depth",
    "nornicdb_serving_queue_tokens", "nornicdb_serving_batches_total",
    "nornicdb_embed_retries_total",
    "nornicdb_genserve_queue_depth", "nornicdb_genserve_running_seqs",
    "nornicdb_genserve_page_pool_utilization",
    "nornicdb_genserve_prefill_seconds",
    "nornicdb_genserve_decode_step_seconds", "nornicdb_genserve_sheds_total",
    "nornicdb_genserve_generated_tokens_total",
    "nornicdb_genserve_evictions_total", "nornicdb_genserve_requests_total",
    "nornicdb_genserve_prefill_tokens_total",
    "nornicdb_genserve_prefix_hits_total", "nornicdb_genserve_prefix_pages",
    "nornicdb_search_queue_wait_seconds", "nornicdb_search_device_seconds",
    "nornicdb_search_batch_size",
    "nornicdb_device_sync_seconds", "nornicdb_device_sync_transfer_bytes",
    "nornicdb_ivf_tunes_total", "nornicdb_ivf_measured_recall",
    "nornicdb_ivf_n_probe", "nornicdb_ivf_local_k",
    "nornicdb_hbm_bytes", "nornicdb_device_programs_total",
    "nornicdb_device_program_seconds", "nornicdb_profile_captures_total",
    "nornicdb_cost_model_predicted_seconds_total",
    "nornicdb_cost_model_actual_seconds_total",
    "nornicdb_cost_model_observations_total",
    "nornicdb_cost_model_relative_error", "nornicdb_cost_model_confidence",
    "nornicdb_cost_model_admission_total", "nornicdb_slo_burn_rate",
    "nornicdb_slo_target_seconds", "nornicdb_build_info",
    "nornicdb_component_errors_total",
)
# deterministic counters of the run: (family, sample name, labels)
DETERMINISTIC = (
    ("nornicdb_genserve_requests_total", 'outcome="ok"'),
    ("nornicdb_genserve_requests_total", 'outcome="shed"'),
    ("nornicdb_genserve_generated_tokens_total", ""),
    ("nornicdb_genserve_prefill_tokens_total", 'pass="first"'),
    ("nornicdb_serving_sheds_total", 'path="embed",reason="queue_full"'),
    ("nornicdb_ivf_tunes_total", 'outcome="too_small"'),
)


class _ServingCfg:
    """ServingConfig stand-in (the fields of tests/test_serving.py's)."""

    enabled = True
    embedder = "full"
    student_model_dir = ""
    student_min_mrr = 0.6
    student_eval_suite = ""
    max_queue = 4096
    max_queue_tokens = 262144
    deadline_ms = 10_000.0
    batch_wait_ms = 1.0
    max_batch_tokens = 2048
    max_rows = 8
    staging_depth = 2


GEN_KW = dict(page_size=16, pool_pages=33, max_seqs=4, max_seq_tokens=128,
              prefill_chunk=32, deadline_ms=60000)
TEXTS = [f"graph node {i} about telemetry and tracing" for i in range(24)]


def _run_jax_stack() -> None:
    from nornicdb_tpu.backend import BackendManager, FakeHooks
    from nornicdb_tpu.config import GenServeConfig
    from nornicdb_tpu.embed import HashEmbedder
    from nornicdb_tpu.genserve import GenerationEngine
    from nornicdb_tpu.models import qwen2
    from nornicdb_tpu.models.tokenizer import HashTokenizer
    from nornicdb_tpu.search.service import SearchConfig, SearchService
    from nornicdb_tpu.serving import ServingEngine
    from nornicdb_tpu.storage import MemoryEngine, Node

    eng = ServingEngine(HashEmbedder(16), _ServingCfg())
    try:
        eng.embed_batch(TEXTS[:8])
        eng.embed_batch(TEXTS[8:])
    finally:
        eng.stop()
    cfg = dataclasses.replace(qwen2.QWEN_SMALL, dtype="float32")
    mgr = BackendManager(hooks=FakeHooks("ok"), acquire_timeout=0.5,
                         probe_interval=0.05, probe_timeout=0.4)
    gen = GenerationEngine(
        qwen2.init_params(cfg, jax.random.PRNGKey(0)), cfg,
        tokenizer=HashTokenizer(cfg.vocab_size),
        config=GenServeConfig(**GEN_KW), manager=mgr)
    try:
        for prompt in PROMPTS:
            gen.generate(prompt, max_new_tokens=4)
    finally:
        gen.stop()
        mgr.stop()
    _search(MemoryEngine, Node, HashEmbedder, SearchConfig,
            lambda st, emb, cfg: SearchService(st, emb, dims=16, config=cfg))


def _run_port_stack() -> None:
    from nornicdb_tpu_torch.config import GenServeConfig
    from nornicdb_tpu_torch.convert import qwen2_params_from_jax
    from nornicdb_tpu_torch.embed import HashEmbedder
    from nornicdb_tpu_torch.genserve import GenerationEngine
    from nornicdb_tpu_torch.models import qwen2
    from nornicdb_tpu_torch.models.tokenizer import HashTokenizer
    from nornicdb_tpu_torch.search import SearchConfig, SearchService
    from nornicdb_tpu_torch.serving import ServingEngine
    from nornicdb_tpu_torch.storage import MemoryEngine, Node
    from nornicdb_tpu.models import qwen2 as jqwen2

    eng = ServingEngine(HashEmbedder(16), _ServingCfg())
    try:
        eng.embed_batch(TEXTS[:8])
        eng.embed_batch(TEXTS[8:])
    finally:
        eng.stop()
    jcfg = dataclasses.replace(jqwen2.QWEN_SMALL, dtype="float32")
    cfg = dataclasses.replace(qwen2.QWEN_SMALL, dtype="float32")
    params = qwen2_params_from_jax(
        jax.tree.map(np.asarray,
                     jqwen2.init_params(jcfg, jax.random.PRNGKey(0))), "cpu")
    gen = GenerationEngine(params, cfg, tokenizer=HashTokenizer(
        cfg.vocab_size), config=GenServeConfig(**GEN_KW), device="cpu")
    try:
        for prompt in PROMPTS:
            gen.generate(prompt, max_new_tokens=4)
    finally:
        gen.stop()
    _search(MemoryEngine, Node, HashEmbedder, SearchConfig,
            lambda st, emb, cfg: SearchService(st, emb, dims=16, config=cfg,
                                               device="cpu"))


PROMPTS = [[5, 17, 42, 8, 9, 11, 300, 12], [7] * 20, [100, 200, 300]]


def _search(engine_cls, node_cls, embedder_cls, config_cls, make) -> None:
    st = engine_cls()
    emb = embedder_cls(16)
    svc = make(st, emb, config_cls(exact=True))
    try:
        svc.attach(st)
        for i, text in enumerate(TEXTS):
            st.create_node(node_cls(id=f"n{i}", properties={"content": text},
                                    embedding=emb.embed(text)))
        with tracer.start_trace("caller"):
            svc.search("graph node telemetry", limit=5)
        svc.search("tracing", limit=5)
        svc.recluster()  # below tune_min_rows: a too_small tune
    finally:
        svc.shutdown()


def _families(text: str) -> dict:
    return parse_exposition(text)


def _label_names(block) -> set:
    names = set()
    for _, labelstr, _ in block.samples:
        for pair in labelstr.split(","):
            key = pair.partition("=")[0].strip()
            if key and key != "le":
                names.add(key)
    return names


def _value(fams: dict, family: str, labelstr: str) -> float:
    block = fams.get(family)
    if block is None:
        return 0.0
    for name, labels, value in block.samples:
        if name == family and labels == labelstr:
            return float(value)
    return 0.0


def test_engine_families_match_jax():
    from nornicdb_tpu.telemetry import REGISTRY as JREGISTRY
    from nornicdb_tpu_torch.telemetry import REGISTRY as TREGISTRY

    # the JAX package registers its families at import, as the port does
    import nornicdb_tpu.genserve.stats  # noqa: F401
    import nornicdb_tpu.search.batcher  # noqa: F401
    import nornicdb_tpu.search.service  # noqa: F401
    import nornicdb_tpu.serving.stats  # noqa: F401
    import nornicdb_tpu.telemetry.costmodel  # noqa: F401
    import nornicdb_tpu.telemetry.deviceprof  # noqa: F401
    import nornicdb_tpu_torch.genserve  # noqa: F401
    import nornicdb_tpu_torch.search  # noqa: F401
    import nornicdb_tpu_torch.serving  # noqa: F401
    import nornicdb_tpu_torch.telemetry.costmodel  # noqa: F401

    j0, t0 = (_families(JREGISTRY.render_prometheus()),
              _families(TREGISTRY.render_prometheus()))
    _run_jax_stack()
    _run_port_stack()
    j1, t1 = (_families(JREGISTRY.render_prometheus()),
              _families(TREGISTRY.render_prometheus()))
    for fam in ENGINE_FAMILIES:
        assert fam in t1 and fam in j1, fam
        assert t1[fam].kind == j1[fam].kind, fam
        assert t1[fam].help == j1[fam].help, fam
        assert _label_names(t1[fam]) == _label_names(j1[fam]), fam
    # every family the port renders is one of the JAX package's, declared
    # the same way
    for fam, block in t1.items():
        assert fam in j1, fam
        assert (block.kind, block.help) == (j1[fam].kind, j1[fam].help), fam
    for fam, labels in DETERMINISTIC:
        dj = _value(j1, fam, labels) - _value(j0, fam, labels)
        dt = _value(t1, fam, labels) - _value(t0, fam, labels)
        assert dt == dj, (fam, labels, dt, dj)
    assert _value(t1, "nornicdb_genserve_requests_total", 'outcome="ok"') \
        - _value(t0, "nornicdb_genserve_requests_total", 'outcome="ok"') == 3
    # the program ledger keys the JAX engines report
    for key in ('subsystem="serving",kind="embed"',
                'subsystem="genserve",kind="ragged"',
                'subsystem="search",kind="dense"'):
        for fams in (t1, j1):
            assert any(key in labels for _, labels, _ in
                       fams["nornicdb_device_programs_total"].samples), key
    for fam in ("nornicdb_serving_batches_total",
                "nornicdb_cost_model_observations_total",
                "nornicdb_device_sync_seconds"):
        total = {f: sum(float(v) for name, _, v in f_[fam].samples
                        if not name.endswith(("_bucket", "_sum")))
                 for f, f_ in (("before", t0), ("after", t1))}
        assert total["after"] > total["before"], fam


def test_queue_wait_and_generation_spans_in_caller_trace():
    """The engines' spans land in the submitting request's trace."""
    from nornicdb_tpu_torch.config import GenServeConfig
    from nornicdb_tpu_torch.embed import HashEmbedder
    from nornicdb_tpu_torch.genserve import GenerationEngine
    from nornicdb_tpu_torch.models import QWEN_SMALL, init_params
    from nornicdb_tpu_torch.serving import ServingEngine

    eng = ServingEngine(HashEmbedder(16), _ServingCfg())
    gen = GenerationEngine(init_params(QWEN_SMALL, 0, "cpu"), QWEN_SMALL,
                           config=GenServeConfig(**GEN_KW), device="cpu")
    try:
        with tracer.start_trace("caller") as root:
            eng.embed_batch(TEXTS[:3])
            gen.generate([5, 17, 42], max_new_tokens=3)
    finally:
        eng.stop()
        gen.stop()
    names = {s["name"] for s in tracer.trace(root.trace_id)["spans"]}
    assert {"serving.queue_wait", "serving.batch", "genserve.admit",
            "genserve.queue_wait", "genserve.prefill",
            "genserve.decode"} <= names


# ------------------------------------------------------- device profiling
def test_capture_profile_cpu_returns_trace_tar_and_is_single_flight():
    before = deviceprof.PROFILER.captures
    errors: list = []
    blob: list = []

    def first():
        blob.append(deviceprof.capture_profile(1.0, device="cpu"))

    t = threading.Thread(target=first)
    t.start()
    deadline = time.monotonic() + 10
    while not deviceprof.PROFILER._capture_lock.locked():
        assert time.monotonic() < deadline, "capture never started"
        time.sleep(0.005)
    try:
        deviceprof.capture_profile(0.05, device="cpu")
    except deviceprof.ProfileBusy as e:
        errors.append(e)
    t.join()
    assert len(errors) == 1
    assert deviceprof.PROFILER.captures == before + 1
    with tarfile.open(fileobj=io.BytesIO(blob[0]), mode="r:gz") as tar:
        names = tar.getnames()
        assert names
        trace = json.load(tar.extractfile(
            next(n for n in names if n.endswith(".json"))))
    assert trace["traceEvents"]


def test_capture_profile_clamps_seconds():
    t0 = time.perf_counter()
    deviceprof.capture_profile(100.0, max_seconds=0.1, device="cpu")
    assert time.perf_counter() - t0 < 30.0


def test_hbm_gauge_equals_corpus_and_pool_tensors():
    from nornicdb_tpu_torch.config import GenServeConfig
    from nornicdb_tpu_torch.genserve import GenerationEngine
    from nornicdb_tpu_torch.models import QWEN_SMALL, init_params
    from nornicdb_tpu_torch.ops import DeviceCorpus
    from nornicdb_tpu_torch.telemetry import REGISTRY

    c = DeviceCorpus(32, device="cpu", quantize=True)
    c.add_batch([f"r{i}" for i in range(300)],
                np.random.default_rng(0).normal(size=(300, 32)).astype(
                    np.float32))
    c.search(np.ones((1, 32), np.float32), k=3)  # first sync: upload
    own = DeviceCorpus._hbm_bytes(c)
    assert own["corpus_f32"] == (c._dev.numel() * 4 + c._dev_valid.numel()
                                 * c._dev_valid.element_size())
    assert own["corpus_int8"] == sum(t.numel() * t.element_size()
                                     for t in c._dev_i8)
    gen = GenerationEngine(init_params(QWEN_SMALL, 0, "cpu"), QWEN_SMALL,
                           config=GenServeConfig(**GEN_KW), device="cpu")
    try:
        gen.generate([5, 17, 42], max_new_tokens=2)
        pool = gen._pages
        assert GenerationEngine._hbm_bytes(gen)["kv_pages"] == (
            pool.numel() * pool.element_size())
        deviceprof.PROFILER.refresh_hbm()
        snap = deviceprof.snapshot()["hbm_bytes"]
        # the gauge sums every live provider: at least these two
        assert snap["corpus_f32"] >= own["corpus_f32"] > 0
        assert snap["kv_pages"] >= pool.numel() * pool.element_size()
        assert 'nornicdb_hbm_bytes{component="corpus_f32"}' in \
            REGISTRY.render_prometheus()
    finally:
        gen.stop()


def test_build_info_one_live_cell_backend_from_torch():
    from nornicdb_tpu_torch.telemetry import REGISTRY

    text = REGISTRY.render_prometheus()
    live = [line for line in text.splitlines()
            if line.startswith("nornicdb_build_info{") and line.endswith(" 1")]
    assert len(live) == 1
    assert 'version="0.1.0"' in live[0]
    assert 'backend="cpu"' in live[0] or 'backend="cuda"' in live[0]
