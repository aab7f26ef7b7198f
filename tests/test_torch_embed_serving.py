"""The port's embed slice against the JAX package's, on the CPU: the ragged
packer, the device embedder (``DeviceEmbedder``, the counterpart of
``TPUEmbedder``), ``CachedEmbedder``, ``ServingConfig`` and the continuous
batching ``ServingEngine``.

The JAX side is built as ``tests/test_serving.py`` builds it (a
``BackendManager`` with fake hooks behind each ``TPUEmbedder``); its
parameters are carried into the port with ``convert.bge_params_from_jax``.
Tolerances: float32 within 1e-5 between the two packages on the same path;
bf16 cosine >= 0.999 and 2**-5 absolute per component (the bound of
``tests/test_torch_bge_m3.py``). Within the port, packed against padded
per-request embeddings hold the JAX package's own bounds
(``tests/test_serving.py``): float32 cosine > 1 - 1e-5 and 1e-4 absolute,
bf16 cosine > 0.99.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import jax
import numpy as np
import pytest

from nornicdb_tpu.backend import BackendManager, FakeHooks
from nornicdb_tpu.config import ServingConfig as JServingConfig
from nornicdb_tpu.embed.base import CachedEmbedder as JCachedEmbedder
from nornicdb_tpu.embed.base import HashEmbedder as JHashEmbedder
from nornicdb_tpu.embed.base import TPUEmbedder
from nornicdb_tpu.models import bge_m3 as JB
from nornicdb_tpu.serving import RaggedPacker as JRaggedPacker
from nornicdb_tpu.serving import ServingEngine as JServingEngine
from nornicdb_tpu_torch import ClosedError, ResourceExhausted
from nornicdb_tpu_torch.config import ServingConfig
from nornicdb_tpu_torch.convert import bge_params_from_jax
from nornicdb_tpu_torch.embed import (
    CachedEmbedder,
    DeviceEmbedder,
    HashEmbedder,
)
from nornicdb_tpu_torch.models import bge_m3 as TB
from nornicdb_tpu_torch.serving import (
    RaggedPacker,
    ServingEngine,
    unpack_results,
)

DIMS = 64
F32_TOL = 1e-5
BF16_ABS = 2.0 ** -5
BF16_COS = 0.999

F32_CFG = JB.BgeConfig(
    vocab_size=512, hidden=DIMS, layers=2, heads=4, intermediate=128,
    max_positions=512, dims=DIMS, dtype="float32",
)
CONFIGS = {"f32": F32_CFG, "bf16": JB.BGE_SMALL}

MIXED_TEXTS = [
    "x",
    "short one",
    "two neighbors packed tight",
    "a slightly longer sentence with a dozen or so words inside it",
    " ".join(f"w{i}" for i in range(60)),
    " ".join(f"mid{i}" for i in range(120)),
    " ".join(f"long{i}" for i in range(505)),  # max-length row
    "tail text after the long one",
]

_LIVE_MANAGERS: list[BackendManager] = []
_LIVE_ENGINES: list = []


@pytest.fixture(autouse=True)
def _cleanup():
    yield
    while _LIVE_ENGINES:
        _LIVE_ENGINES.pop().stop()
    while _LIVE_MANAGERS:
        _LIVE_MANAGERS.pop().stop()


def _mgr() -> BackendManager:
    mgr = BackendManager(hooks=FakeHooks("ok"), acquire_timeout=0.5,
                         probe_interval=0.05, probe_timeout=0.4)
    _LIVE_MANAGERS.append(mgr)
    return mgr


@pytest.fixture(scope="module")
def jax_params():
    """name -> JAX parameters of that config (PRNGKey(0))."""
    return {name: JB.init_params(cfg, jax.random.PRNGKey(0))
            for name, cfg in CONFIGS.items()}


def _pair(jax_params, name: str, **kw):
    """(JAX TPUEmbedder, port DeviceEmbedder) on the same weights."""
    jcfg = CONFIGS[name]
    jp = jax_params[name]
    jemb = TPUEmbedder(cfg=jcfg, params=jp, backend=_mgr(), **kw)
    tp = bge_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    temb = DeviceEmbedder(cfg=TB.BgeConfig(**dataclasses.asdict(jcfg)),
                          params=tp, device="cpu", **kw)
    return jemb, temb


def _embedder(jax_params, name: str = "f32", **kw) -> DeviceEmbedder:
    return _pair(jax_params, name, **kw)[1]


def _assert_same(name: str, want, got) -> None:
    want = np.stack(want)
    got = np.stack(got)
    if name == "f32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ABS)
    assert (got * want).sum(-1).min() >= BF16_COS


class _Cfg:
    """ServingConfig stand-in with test-friendly defaults, the fields of
    ``tests/test_serving.py``'s."""

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

    def __init__(self, **kw):
        for k, v in kw.items():
            assert hasattr(self, k), k
            setattr(self, k, v)


def _engine(inner, **cfg_kw) -> ServingEngine:
    eng = ServingEngine(inner, _Cfg(**cfg_kw))
    _LIVE_ENGINES.append(eng)
    return eng


def _random_seqs(rng, n: int, max_len: int) -> list[list[int]]:
    """Token sequences of mostly short, some long lengths (1..max_len+20)."""
    short = rng.integers(1, 40, n)
    long = rng.integers(1, max_len + 21, n)
    lens = np.where(rng.random(n) < 0.7, short, long)
    return [[0] + rng.integers(4, 500, int(m) - 1).tolist() for m in lens]


# ---------------------------------------------------------------- packer
class TestRaggedPackerParity:
    @pytest.mark.parametrize("max_len", [512, 506, 128])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_same_packed_batch_as_jax(self, seed, max_len):
        rng = np.random.default_rng(seed)
        seqs = _random_seqs(rng, 24, max_len)
        kw = dict(pad_id=1, pad_token_id=1, max_len=max_len, max_rows=16,
                  max_cells=4096)
        jp, tp = JRaggedPacker(**kw), RaggedPacker(**kw)
        assert tp.capacities == jp.capacities
        lengths = [len(s) for s in seqs]
        for budget in (0, 300, 4096):
            assert tp.plan(lengths, budget_tokens=budget) == jp.plan(
                lengths, budget_tokens=budget)
        for cap in (0, tp.capacities[-1]):
            want = jp.pack(seqs[:10], capacity=cap)
            got = tp.pack(seqs[:10], capacity=cap)
            for name in ("ids", "seg", "positions", "cls_rows", "cls_cols"):
                a, b = getattr(want, name), getattr(got, name)
                assert a.dtype == b.dtype == np.int32, name
                np.testing.assert_array_equal(b, a, err_msg=name)
            assert got.order == want.order and got.tokens == want.tokens
            assert got.shape_class == want.shape_class

    def test_off_grid_max_len_gets_own_class(self):
        p = RaggedPacker(pad_id=1, pad_token_id=1, max_len=506)
        assert p.capacities[-1] == 506
        pack = p.pack([[7] * 300])
        assert pack.tokens == 300 and pack.ids.shape[1] == 506

    def test_unpack_restores_input_order(self):
        p = RaggedPacker(pad_id=1, pad_token_id=1, max_len=64)
        pack = p.pack([[0] * 3, [0] * 9, [0] * 5])
        emb = np.arange(len(pack.cls_rows) * 2, dtype=np.float32).reshape(-1, 2)
        out = unpack_results(pack, emb, n_inputs=3)
        for slot, idx in enumerate(pack.order):
            np.testing.assert_array_equal(out[idx], emb[slot])


# ------------------------------------------------------------ embedders
class TestEmbedders:
    def test_hash_embedder_matches_jax(self):
        texts = ["a b c", "", "graph node edge", "A B c"]
        for a, b in zip(HashEmbedder(32).embed_batch(texts),
                        JHashEmbedder(32).embed_batch(texts)):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_embed_batch_matches_tpu_embedder(self, jax_params, name):
        jemb, temb = _pair(jax_params, name)
        got = temb.embed_batch(MIXED_TEXTS)
        want = jemb.embed_batch(MIXED_TEXTS)
        assert all(g.dtype == np.float32 and g.shape == (temb.dimensions(),)
                   for g in got)
        _assert_same(name, want, got)
        assert temb.stats["batches"] == jemb.stats["batches"]
        assert temb.stats["embedded"] == jemb.stats["embedded"]

    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_embed_packed_matches_tpu_embedder(self, jax_params, name):
        jemb, temb = _pair(jax_params, name)
        seqs = [temb.tokenizer.encode(t, max_len=temb.max_len)
                for t in MIXED_TEXTS]
        pack = RaggedPacker(pad_id=1, pad_token_id=1).pack(seqs)
        got = unpack_results(pack, temb.embed_packed(pack))
        want = unpack_results(pack, jemb.embed_packed(pack))
        _assert_same(name, want, got)
        assert temb.packed_shapes == jemb.packed_shapes == {pack.shape_class}
        for key in ("packed_dispatches", "packed_tokens", "batches",
                    "embedded"):
            assert temb.stats[key] == jemb.stats[key], key

    def test_classes_and_surface(self, jax_params):
        jemb, temb = _pair(jax_params, "f32", max_len=300, opt_batch=8)
        for n in (1, 31, 32, 33, 200, 299, 300, 301):
            assert temb._bucket_len(n) == jemb._bucket_len(n), n
        for n in (1, 3, 5, 8, 9, 40):
            assert temb._batch_class(n) == jemb._batch_class(n), n
        assert temb.dimensions() == jemb.dimensions() == DIMS
        assert temb.model() == "bge-m3-torch"
        assert temb.device.type == "cpu"
        assert temb.embed_batch([]) == []

    def test_default_params_from_seed(self):
        a = DeviceEmbedder(cfg=TB.BGE_SMALL, seed=3, device="cpu")
        b = DeviceEmbedder(cfg=TB.BGE_SMALL, seed=3, device="cpu")
        np.testing.assert_array_equal(a.embed("same text"), b.embed("same text"))
        assert a.tokenizer.vocab_size == TB.BGE_SMALL.vocab_size

    def test_cached_embedder_hits_and_misses(self):
        calls: list = []

        class Counting(HashEmbedder):
            def embed_batch(self, texts):
                calls.append(list(texts))
                return super().embed_batch(texts)

        port = CachedEmbedder(Counting(16), capacity=2)
        ref = JCachedEmbedder(JHashEmbedder(16), capacity=2)
        for batch in (["a", "b"], ["a", "c"], ["b"], ["c", "c"]):
            got, want = port.embed_batch(batch), ref.embed_batch(batch)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            assert (port.hits, port.misses) == (ref.hits, ref.misses)
        # ["a","b"] miss; "a" hits; "b" was evicted by "c" (capacity 2)
        assert calls == [["a", "b"], ["c"], ["b"], ["c", "c"]] or calls[:3] == [
            ["a", "b"], ["c"], ["b"]]
        assert port.hits >= 1 and port.misses >= 4
        assert port.dimensions() == 16 and port.model() == "hash-embedder"


# ------------------------------------------------------------ config
class TestServingConfig:
    def test_same_fields_and_defaults_as_jax(self):
        assert dataclasses.asdict(ServingConfig()) == dataclasses.asdict(
            JServingConfig())
        cfg = ServingConfig()
        assert (cfg.max_queue, cfg.max_queue_tokens, cfg.deadline_ms,
                cfg.batch_wait_ms, cfg.max_batch_tokens, cfg.max_rows,
                cfg.staging_depth) == (4096, 262144, 2000.0, 2.0, 8192, 16, 2)

    def test_from_env(self):
        cfg = ServingConfig.from_env({
            "NORNICDB_SERVING_MAX_ROWS": "8",
            "NORNICDB_SERVING_DEADLINE_MS": "250.5",
            "NORNICDB_SERVING_ENABLED": "false",
            "NORNICDB_GENSERVE_MAX_QUEUE": "1",
        })
        assert cfg.max_rows == 8 and cfg.deadline_ms == 250.5
        assert cfg.enabled is False and cfg.max_queue == 4096


# ------------------------------------------------------- equivalence
class TestRaggedEquivalence:
    def _pack_for(self, e, texts):
        seqs = [
            e.tokenizer.encode(t, max_len=e.max_len) or [e.tokenizer.pad_id]
            for t in texts
        ]
        packer = RaggedPacker(
            pad_id=e.tokenizer.pad_id,
            pad_token_id=e.cfg.pad_token_id,
            max_len=e.max_len,
        )
        return packer.pack(seqs)

    def test_f32_packed_matches_per_request_tight(self, jax_params):
        e = _embedder(jax_params)
        pack = self._pack_for(e, MIXED_TEXTS)
        ragged = unpack_results(
            pack, e.embed_packed(pack), n_inputs=len(MIXED_TEXTS)
        )
        for i, text in enumerate(MIXED_TEXTS):
            ref = e.embed(text)
            cos = float(np.dot(ragged[i], ref))
            assert cos > 1.0 - 1e-5, (i, cos)
            np.testing.assert_allclose(ragged[i], ref, atol=1e-4)

    def test_bf16_default_config_loose_bound(self, jax_params):
        e = _embedder(jax_params, "bf16")
        texts = MIXED_TEXTS[:6]
        pack = self._pack_for(e, texts)
        ragged = unpack_results(pack, e.embed_packed(pack), n_inputs=len(texts))
        for i, text in enumerate(texts):
            cos = float(np.dot(ragged[i], e.embed(text)))
            assert cos > 0.99, (i, cos)

    def test_segment_boundary_no_leak(self, jax_params):
        """Adjacent segments in one row must not bleed into each other:
        the same text embeds identically regardless of its neighbors."""
        e = _embedder(jax_params)
        probe = "the probe text under test"
        alone = e.embed(probe)
        for neighbors in (
            ["aaaa bbbb cccc"], ["x"], [" ".join(f"n{i}" for i in range(25))],
        ):
            pack = self._pack_for(e, [neighbors[0], probe, neighbors[0]])
            emb = unpack_results(pack, e.embed_packed(pack), n_inputs=3)
            np.testing.assert_allclose(emb[1], alone, atol=1e-4)

    def test_single_program_per_pack(self, jax_params):
        e = _embedder(jax_params)
        before = e.stats["packed_dispatches"]
        pack = self._pack_for(e, MIXED_TEXTS)
        e.embed_packed(pack)
        assert e.stats["packed_dispatches"] == before + 1
        # repeated same-shape packs add no new shape classes
        shapes_before = set(e.packed_shapes)
        e.embed_packed(self._pack_for(e, MIXED_TEXTS))
        assert set(e.packed_shapes) == shapes_before


# ------------------------------------------------------------ engine
class TestServingEngine:
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_engine_matches_jax_engine(self, jax_params, name):
        """The slice end to end: the port's engine over the port's
        embedder against the JAX engine over TPUEmbedder, same weights,
        one request (so both pack the same grids). The JAX engine runs
        without a deadline: its predictive admission reads a process-wide
        cost model that other tests in this process may have trained."""
        jemb, temb = _pair(jax_params, name)
        jeng = JServingEngine(jemb, _Cfg(deadline_ms=0.0))
        _LIVE_ENGINES.append(jeng)
        got = _engine(temb).embed_batch(MIXED_TEXTS)
        want = jeng.embed_batch(MIXED_TEXTS)
        _assert_same(name, want, got)
        assert temb.packed_shapes == jemb.packed_shapes

    def test_engine_matches_inner(self, jax_params):
        inner = _embedder(jax_params)
        eng = _engine(inner)
        out = eng.embed_batch(MIXED_TEXTS)
        ref = inner.embed_batch(MIXED_TEXTS)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a, b, atol=1e-4)

    def test_concurrent_callers_coalesce(self, jax_params):
        inner = _embedder(jax_params)
        eng = _engine(inner, batch_wait_ms=20.0)
        n = 12
        res: list = [None] * n
        errs: list = []

        def call(i):
            try:
                res[i] = eng.embed_batch([f"text number {i} here"])[0]
            except Exception as exc:  # pragma: no cover - fail loudly
                errs.append(exc)

        ts = [threading.Thread(target=call, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        assert not errs
        assert all(r is not None for r in res)
        # continuous batching: far fewer device batches than callers
        assert eng.stats.batches < n
        # results are per-caller correct, not leader-only
        for i in range(n):
            np.testing.assert_allclose(
                res[i], inner.embed(f"text number {i} here"), atol=1e-4
            )

    def test_hash_embedder_fallback_path(self):
        inner = HashEmbedder(32)
        eng = _engine(inner)
        out = eng.embed_batch(["a b c", "d e"])
        ref = inner.embed_batch(["a b c", "d e"])
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
        assert eng.stats.packed_batches == 0  # no packed path for hash

    def test_queue_full_sheds_never_wedges(self):
        class SlowEmbedder(HashEmbedder):
            def embed_batch(self, texts):
                time.sleep(0.15)
                return super().embed_batch(texts)

        eng = _engine(
            SlowEmbedder(16), max_queue=4, max_queue_tokens=100_000,
            batch_wait_ms=0.0, deadline_ms=30_000.0,
        )
        held: list = []
        shed = 0

        def caller():
            try:
                held.append(eng.embed_batch([f"t {len(held)} word"] * 2))
            except ResourceExhausted:
                pass

        ts = [threading.Thread(target=caller) for _ in range(12)]
        for t in ts:
            t.start()
        # saturate from this thread too: at least one submit must shed
        for _ in range(20):
            try:
                eng.embed_batch(["x y z"] * 3)
            except ResourceExhausted as e:
                assert e.reason == "queue_full"
                shed += 1
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        assert shed > 0
        assert eng.stats.sheds_queue_full > 0
        # never a wedge: the engine still serves after saturation
        out = eng.embed_batch(["post saturation text"])
        assert out[0].shape == (16,)

    def test_off_grid_max_len_engine_equivalence(self, jax_params):
        """A 300-token text through an engine whose embedder has
        max_len=506 must match the per-request path (no truncation)."""
        inner = _embedder(jax_params, max_len=506)
        eng = _engine(inner)
        text = " ".join(f"w{i}" for i in range(298))
        out = eng.embed_batch([text])[0]
        np.testing.assert_allclose(out, inner.embed(text), atol=1e-4)

    def test_queue_counters_reset_after_shed_drain(self):
        class StuckEmbedder(HashEmbedder):
            def embed_batch(self, texts):
                time.sleep(5.0)
                return super().embed_batch(texts)

        eng = _engine(
            StuckEmbedder(8), deadline_ms=300.0, batch_wait_ms=0.0,
            staging_depth=1,
        )
        # several concurrent requests: the first occupies compute (stuck
        # 5s), the next fills the depth-1 staging buffer, the rest age
        # out IN THE QUEUE; the _shed_expired path must both fail them
        # and reset the queue counters
        errs: list = []

        def caller():
            try:
                eng.embed_batch(["doomed text"] * 2)
            except ResourceExhausted as e:
                errs.append(e)

        ts = [threading.Thread(target=caller) for _ in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        assert len(errs) == 6
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with eng._lock:
                if eng._queued_texts == 0:
                    break
            time.sleep(0.05)
        assert eng.stats.sheds_deadline > 0
        snap = eng.stats_snapshot()
        assert snap["queue_texts"] == 0 and snap["queue_tokens"] == 0

    def test_deadline_sheds_bounded_time(self):
        class StuckEmbedder(HashEmbedder):
            def embed_batch(self, texts):
                time.sleep(5.0)
                return super().embed_batch(texts)

        eng = _engine(StuckEmbedder(8), deadline_ms=300.0, batch_wait_ms=0.0)
        t0 = time.monotonic()
        with pytest.raises(ResourceExhausted) as ei:
            eng.embed_batch(["will expire"])
        assert ei.value.reason == "deadline"
        # deadline + 1s grace + wait granularity, not the 5s embed
        assert time.monotonic() - t0 < 4.0

    def test_stop_fails_pending_fast(self):
        class NeverEmbedder(HashEmbedder):
            def embed_batch(self, texts):
                time.sleep(30)
                return super().embed_batch(texts)

        eng = _engine(NeverEmbedder(8), deadline_ms=0.0, batch_wait_ms=0.0)
        errs: list = []

        def caller():
            try:
                eng.embed_batch(["stuck"])
            except Exception as exc:
                errs.append(exc)

        t = threading.Thread(target=caller)
        t.start()
        time.sleep(0.2)
        eng.stop()
        t.join(timeout=10)
        assert not t.is_alive()
        assert errs and isinstance(
            errs[0], (ClosedError, ResourceExhausted)
        )
        with pytest.raises(ClosedError):
            eng.embed_batch(["after stop"])

    def test_stats_snapshot_shape(self, jax_params):
        eng = _engine(_embedder(jax_params))
        eng.embed_batch(MIXED_TEXTS[:4])
        snap = eng.stats_snapshot()
        assert snap["ragged"] is True
        assert snap["texts"] >= 4
        assert 0.0 < snap["pack_efficiency"] <= 1.0
        assert "packed_programs" in snap
        assert snap["model"] == "bge-m3-torch"
        assert snap["sheds_queue_full"] == snap["sheds_deadline"] == 0

    def test_default_config_from_env(self, jax_params, monkeypatch):
        monkeypatch.setenv("NORNICDB_SERVING_MAX_ROWS", "4")
        eng = ServingEngine(_embedder(jax_params))
        _LIVE_ENGINES.append(eng)
        assert isinstance(eng.config, ServingConfig)
        assert eng.config.max_rows == 4 and eng._packer.max_rows == 4

