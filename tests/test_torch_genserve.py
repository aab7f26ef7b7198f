"""The port's generation engine (``nornicdb_tpu_torch.genserve``) on the CPU.

The engine serves float32 QWEN_SMALL with the JAX package's parameters
(carried over with ``convert.qwen2_params_from_jax``) and must emit the same
token lists as the JAX engine for the same requests: in float32 the two
models' logits differ by under 1e-5 (tests/test_torch_qwen2.py), far below
the greedy margins of these prompts. Scheduler semantics (prefix hits,
eviction, shedding, stop, streaming) are held to the port's own dense
reference (``prefill`` + ``decode_step`` at the engine's cache width), as
the JAX suite holds its engine to its dense path.
"""

import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from nornicdb_tpu.backend import BackendManager, FakeHooks
from nornicdb_tpu.config import GenServeConfig as JaxGenServeConfig
from nornicdb_tpu.genserve import GenerationEngine as JaxEngine
from nornicdb_tpu.models import qwen2 as JQ
from nornicdb_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from nornicdb_tpu_torch import ClosedError, DeviceUnavailable, ResourceExhausted
from nornicdb_tpu_torch import genserve
from nornicdb_tpu_torch.config import GenServeConfig
from nornicdb_tpu_torch.convert import qwen2_params_from_jax
from nornicdb_tpu_torch.genserve import GenerationEngine
from nornicdb_tpu_torch.genserve.engine import GenHandle, _Seq
from nornicdb_tpu_torch.models import qwen2 as TQ
from nornicdb_tpu_torch.models.tokenizer import HashTokenizer

JCFG = dataclasses.replace(JQ.QWEN_SMALL, dtype="float32")
TCFG = dataclasses.replace(TQ.QWEN_SMALL, dtype="float32")
JPARAMS = JQ.init_params(JCFG, jax.random.PRNGKey(0))
TPARAMS = qwen2_params_from_jax(jax.tree.map(np.asarray, JPARAMS), "cpu")
TOK = HashTokenizer(TCFG.vocab_size)
ENGINE_KW = dict(page_size=16, pool_pages=33, max_seqs=4, max_seq_tokens=128,
                 prefill_chunk=32, deadline_ms=60000)

_LIVE: list = []


@pytest.fixture(autouse=True)
def _cleanup():
    yield
    while _LIVE:
        _LIVE.pop().stop()


def _engine(**kw) -> GenerationEngine:
    cfg = dict(ENGINE_KW)
    cfg.update(kw)
    eng = GenerationEngine(TPARAMS, TCFG, tokenizer=TOK,
                           config=GenServeConfig(**cfg), device="cpu")
    _LIVE.append(eng)
    return eng


def _jax_engine(**kw) -> JaxEngine:
    cfg = dict(ENGINE_KW)
    cfg.update(kw)
    mgr = BackendManager(hooks=FakeHooks("ok"), acquire_timeout=0.5,
                         probe_interval=0.05, probe_timeout=0.4,
                         degrade_after=1, recover_after=1)
    _LIVE.append(mgr)
    eng = JaxEngine(JPARAMS, JCFG, tokenizer=JaxHashTokenizer(JCFG.vocab_size),
                    config=JaxGenServeConfig(**cfg), manager=mgr)
    _LIVE.append(eng)
    return eng


def _prompt(n: int, seed: int = 0) -> list[int]:
    rng = np.random.default_rng(seed * 1000 + n)
    return [int(x) for x in rng.integers(4, TCFG.vocab_size, n)]


def _dense_ref(prompt: list[int], max_new: int, max_len: int = 128) -> list[int]:
    """The port's dense path at the engine's cache width."""
    logits, caches = TQ.prefill(TPARAMS, TCFG, torch.tensor([prompt]), max_len)
    tok = int(logits[0].argmax())
    out, pos = [tok], len(prompt)
    while len(out) < max_new and tok != TOK.eos_id:
        logits, caches = TQ.decode_step(TPARAMS, TCFG, torch.tensor([tok]),
                                        caches, pos)
        tok = int(logits[0].argmax())
        out.append(tok)
        pos += 1
    return out


# one parametrised case per request set: a concurrent mixed batch, and
# prompt lengths straddling every page boundary
CASES = [("mixed", [(n, 2) for n in (3, 11, 24, 40)], 12)] + [
    (f"plen{n}", [(n, 0)], 10) for n in (1, 15, 16, 17, 31, 32, 33, 63)]


class TestParityWithJaxEngine:
    @pytest.mark.parametrize("name,spec,max_new", CASES,
                             ids=[c[0] for c in CASES])
    def test_same_tokens_as_jax_engine(self, name, spec, max_new):
        prompts = [_prompt(n, seed=s) for n, s in spec]
        outs = {}
        for key, eng in (("jax", _jax_engine()), ("port", _engine())):
            handles = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
            outs[key] = [h.result() for h in handles]
            if len(prompts) > 1:
                # they really shared fused steps (continuous batching)
                assert eng.stats.decode_steps < eng.stats.generated_tokens
        assert outs["port"] == outs["jax"]
        assert all(len(o) >= 1 for o in outs["port"])

    @pytest.mark.parametrize("max_seqs,prefill_chunk", [
        (4, 32), (8, 64), (1, 16), (3, 128)])
    def test_ragged_classes_match_jax(self, max_seqs, prefill_chunk):
        kw = dict(max_seqs=max_seqs, prefill_chunk=prefill_chunk,
                  max_seq_tokens=256, pool_pages=64)
        jax_eng = JaxEngine(JPARAMS, JCFG, config=JaxGenServeConfig(
            **{**ENGINE_KW, **kw}))
        assert _engine(**kw)._ragged_classes() == jax_eng._ragged_classes()


class TestPrefixCacheAndEviction:
    def test_prefix_hit_skips_prefill_and_keeps_tokens(self):
        eng = _engine()
        shared = _prompt(50, seed=7)
        out1 = eng.generate(shared, max_new_tokens=4)
        first_after_1 = eng.stats.prefill_tokens_first
        h2 = eng.submit(shared, max_new_tokens=4)
        out2 = h2.result()
        assert out1 == out2 == _dense_ref(shared, 4)
        # 3 full 16-token pages adopted (the 4th would swallow the whole
        # prompt; the final chunk must still produce first-token logits)
        assert h2.prefix_reused_tokens == 48
        assert eng.stats.prefix_hits >= 3
        assert eng.stats.prefill_tokens_first - first_after_1 == len(shared) - 48
        snap = eng.stats_snapshot()
        assert snap["prefix_pages"] >= 3 and snap["prefix_reused_tokens"] >= 48

    def test_eviction_and_readmission_stay_exact(self):
        eng = _engine(page_size=8, pool_pages=8, max_seq_tokens=56,
                      prefill_chunk=16)
        common = _prompt(16, seed=9)
        prompts = [common + _prompt(n, seed=10 + n) for n in (5, 9, 12)]
        handles = [eng.submit(p, max_new_tokens=20) for p in prompts]
        outs = [h.result() for h in handles]
        assert outs == [_dense_ref(p, 20, max_len=56) for p in prompts]
        assert eng.stats.evictions > 0, "pool was sized to force eviction"
        assert eng.stats.readmissions > 0
        assert eng.stats.prefill_tokens_re > 0
        assert eng.stats.prefix_hits > 0

    def test_idle_cached_pages_reclaimed_lru_under_pressure(self):
        eng = _engine(page_size=8, pool_pages=12, max_seq_tokens=64,
                      max_seqs=2, prefill_chunk=16)
        for s in range(4):
            eng.generate(_prompt(17, seed=20 + s), max_new_tokens=2)
        cached_before = len(eng._prefix_cache)
        assert cached_before > 0
        prompts = [_prompt(30, seed=40 + s) for s in range(3)]
        handles = [eng.submit(p, max_new_tokens=8) for p in prompts]
        assert [h.result() for h in handles] == [
            _dense_ref(p, 8, max_len=64) for p in prompts]
        assert len(eng._prefix_cache) <= cached_before + 3 * 3

    def test_shared_page_release_keeps_coholder(self):
        eng = _engine()
        eng.submit([1], max_new_tokens=1).result()  # builds the pool
        assert eng._running == []
        pid = eng._free_pages.pop()
        eng._page_refs[pid] = 2  # shared by two sequences
        seqs = [_Seq(GenHandle(eng, 0.0), [1], 1, -1) for _ in range(2)]
        for seq in seqs:
            seq.page_ids = [pid]
            seq.page_table = np.asarray([pid], np.int32)
        eng._release_pages(seqs[0])
        assert pid not in eng._free_pages and eng._page_refs[pid] == 1
        # also prefix-cached: the LAST holder's release keeps it resident
        eng._prefix_cache[b"k"] = pid
        eng._page_hash[pid] = b"k"
        eng._release_pages(seqs[1])
        assert pid not in eng._free_pages and pid not in eng._page_refs


class TestDenseMode:
    """``mode="dense"``: the escape hatch of per-sequence dense caches (the
    JAX suite's dense-mode cases, and eviction in dense mode)."""

    def test_dense_mode_fallback_equivalence(self):
        prompts = [_prompt(n, seed=3) for n in (5, 17)]
        outs = {}
        for key, eng in (("jax", _jax_engine(mode="dense")),
                         ("port", _engine(mode="dense"))):
            handles = [eng.submit(p, max_new_tokens=8) for p in prompts]
            outs[key] = [h.result() for h in handles]
        assert outs["port"] == outs["jax"] == [_dense_ref(p, 8)
                                               for p in prompts]

    def test_dense_serves_without_pool_or_chunks(self):
        eng = _engine(mode="dense")
        eng.warmup()
        assert ("dense_prefill", 3, 64) in eng.programs  # the tiny request
        prompts = [_prompt(n, seed=6) for n in (4, 30, 70)]
        handles = [eng.submit(p, max_new_tokens=12) for p in prompts]
        assert [h.result() for h in handles] == [
            _dense_ref(p, 12, max_len=TQ.round_up_pow2(len(p) + 12))
            for p in prompts]
        assert eng._pages is None and eng.stats.fused_steps == 0
        assert not eng._prefix_cache and eng.stats.prefix_hits == 0
        assert {p[0] for p in eng.programs} == {"dense_prefill", "dense_step"}
        assert ("dense_step", 128) in eng.programs  # 70 + 12 -> 128
        snap = eng.stats_snapshot()
        assert snap["mode"] == "dense" and snap["completed"] == 4
        assert snap["prefill_chunks"] == 4 and snap["decode_steps"] == 3 * 11 + 1
        assert all(s.dense_cache is None for s in eng._running)

    def test_dense_decode_failure_drops_donated_cache(self, monkeypatch):
        """A failing step may have half-written the sequence's cache (written
        in place): it is dropped at the step, so a requeue re-prefills."""
        eng = _engine(mode="dense")
        monkeypatch.setattr(GenerationEngine, "start", lambda self: None)
        eng.submit([1, 2, 3], max_new_tokens=4)

        def boom(*a, **k):
            raise RuntimeError("injected dispatch failure")

        monkeypatch.setattr(TQ, "decode_step", boom)
        with pytest.raises(RuntimeError, match="injected"):
            eng._step()  # admits, prefills (first token), then decodes
        seq = eng._running[0]
        assert seq.out and seq.dense_cache is None

    def test_dense_eviction_and_readmission_stay_exact(self, monkeypatch):
        """An evicted dense sequence drops its cache, is requeued at the
        head, and re-prefills from prompt + emitted tokens: the output is
        unchanged."""
        eng = _engine(mode="dense", max_seqs=2)
        real = GenerationEngine._decode_step
        evicted = []

        def evicting(self):
            running = [s for s in self._running if s.state == "decode"]
            if not evicted and running and len(running[0].out) == 4:
                victim = running[0]
                assert victim.dense_cache is not None
                self._evict(victim)
                evicted.append(victim)
                assert victim.dense_cache is None
                assert self._queue[0] is victim
            real(self)

        monkeypatch.setattr(GenerationEngine, "_decode_step", evicting)
        prompts = [_prompt(n, seed=8) for n in (6, 19)]
        handles = [eng.submit(p, max_new_tokens=10) for p in prompts]
        outs = [h.result() for h in handles]
        assert evicted and eng.stats.evictions == 1
        assert eng.stats.readmissions == 1
        assert eng.stats.prefill_tokens_re == len(evicted[0].prompt) + 4
        assert outs == [_dense_ref(p, 10, max_len=64) for p in prompts]


class TestScheduling:
    def test_queue_full_sheds(self):
        eng = _engine(max_seqs=1, max_queue=2)
        handles, sheds = [], 0
        for i in range(12):
            try:
                handles.append(eng.submit(_prompt(6, seed=i),
                                          max_new_tokens=30))
            except ResourceExhausted as e:
                assert e.reason == "queue_full"
                sheds += 1
        assert sheds >= 1
        assert eng.stats.sheds_queue_full == sheds
        for h in handles:
            assert len(h.result()) >= 1

    def test_deadline_shed_never_wedges(self):
        from nornicdb_tpu_torch.telemetry.costmodel import COST_MODEL

        # cold model -> submit fails open, so the queued request reaches
        # the post-admission deadline path this test asserts on
        COST_MODEL.reset()
        eng = _engine(max_seqs=1)
        h1 = eng.submit(_prompt(8), max_new_tokens=120)
        h2 = eng.submit(_prompt(4, seed=9), max_new_tokens=4, deadline_ms=50)
        t0 = time.monotonic()
        with pytest.raises(ResourceExhausted) as ei:
            h2.result()
        assert ei.value.reason == "deadline"
        assert time.monotonic() - t0 < 0.05 + h2._GRACE + 2.0
        assert eng.stats.sheds_deadline >= 1
        assert len(h1.result()) >= 1  # the running request was unharmed

    def test_stop_fails_fast(self):
        eng = _engine(max_seqs=1)
        h1 = eng.submit(_prompt(8), max_new_tokens=120)
        h2 = eng.submit(_prompt(4, seed=5), max_new_tokens=4)
        eng.stop()
        with pytest.raises((ClosedError, ResourceExhausted)):
            h2.result()
        try:
            h1.result(partial_ok=True)  # bounded fast either way
        except ClosedError:
            pass
        with pytest.raises(ClosedError):
            eng.submit(_prompt(3), max_new_tokens=2)

    def test_streaming_delivers_before_completion(self):
        eng = _engine()
        h = eng.submit(_prompt(6), max_new_tokens=60)
        stream = h.stream_tokens()
        first = next(stream)
        assert isinstance(first, int)
        assert not h.done, "first token must stream before the request ends"
        assert [first] + list(stream) == h.tokens
        h2 = eng.submit(_prompt(5), max_new_tokens=6)
        assert "".join(h2.stream_text()) == TOK.decode(h2.tokens)
        assert eng.generate_text("hello port", max_new_tokens=3) == TOK.decode(
            _dense_ref(TOK.encode("hello port", add_special=False), 3))

    def test_prompt_tail_trim_and_max_new_clamp(self):
        eng = _engine(max_seq_tokens=64)
        long_prompt = _prompt(200)
        out = eng.generate(long_prompt, max_new_tokens=500)
        assert out == _dense_ref(long_prompt[-63:], 1, max_len=64)

    def test_warmup_covers_every_class_steady_traffic_adds_none(self):
        eng = _engine()
        eng.warmup()
        w = eng._table_width
        assert eng.programs == {("ragged", f, tq, w)
                                for f, tq in eng._ragged_classes()}
        assert eng._pages is None  # warmup never touches the serving pool
        programs = set(eng.programs)
        handles = [eng.submit(_prompt(n, seed=n), max_new_tokens=6)
                   for n in (3, 18, 40, 61, 27)]
        for h in handles:
            h.result()
        shared = _prompt(45, seed=99)
        eng.generate(shared, max_new_tokens=4)
        eng.generate(shared, max_new_tokens=4)  # prefix-hit path
        assert eng.programs == programs

    def test_failed_step_fails_resident_work_and_drops_pool(self, monkeypatch):
        """A step that raises may have half-written the in-place pool: every
        resident request fails, the pool and prefix cache are dropped, and
        the next request is served from a fresh pool."""
        eng = _engine()
        shared = _prompt(40, seed=3)
        good = eng.generate(shared, max_new_tokens=3)
        assert eng._prefix_cache
        real = TQ.ragged_fused_step
        calls = []

        def broken(*a, **k):
            calls.append(1)
            raise RuntimeError("injected step failure")

        monkeypatch.setattr(TQ, "ragged_fused_step", broken)
        with pytest.raises(RuntimeError, match="injected"):
            eng.generate(_prompt(9, seed=4), max_new_tokens=3)
        assert calls and eng.stats.errors >= 1
        assert eng._pages is None and not eng._prefix_cache
        monkeypatch.setattr(TQ, "ragged_fused_step", real)
        assert eng.generate(shared, max_new_tokens=3) == good
        assert eng.stats.prefix_hits == 0  # the cache went with the pool


class TestConstructionAndConfig:
    def test_device_none_means_cuda(self):
        if torch.cuda.is_available():
            eng = GenerationEngine(TPARAMS, TCFG, config=GenServeConfig())
            assert eng.device.type == "cuda" and eng._attn_for() == "cuda"
            return
        with pytest.raises(DeviceUnavailable, match="device='cpu'"):
            GenerationEngine(TPARAMS, TCFG, config=GenServeConfig())

    def test_cpu_engine_uses_the_torch_path(self):
        eng = _engine()
        assert eng.device.type == "cpu" and eng._attn_for() == "torch"
        assert eng.params["tok_emb_f32"].dtype == torch.float32

    def test_refuses_dense_mode_and_a_pool_too_small(self):
        """Dense mode is ported and serves; an unknown mode and a pool too
        small for one sequence are refused."""
        prompt = _prompt(9, seed=2)
        assert _engine(mode="dense").generate(
            prompt, max_new_tokens=5) == _dense_ref(prompt, 5, max_len=64)
        with pytest.raises(ValueError, match="dense"):
            _engine(mode="ragged")
        with pytest.raises(ValueError, match="pool_pages"):
            _engine(pool_pages=4, max_seq_tokens=128)

    def test_config_matches_jax_and_reads_env(self, monkeypatch):
        got = dataclasses.asdict(GenServeConfig())
        want = dataclasses.asdict(JaxGenServeConfig())
        # the recorded difference: the port fails where JAX goes to the CPU
        assert (got.pop("fallback"), want.pop("fallback")) == ("fail", "cpu")
        assert got == want
        env = {"NORNICDB_GENSERVE_PAGE_SIZE": "8",
               "NORNICDB_GENSERVE_DEADLINE_MS": "250",
               "NORNICDB_GENSERVE_ENABLED": "false",
               "NORNICDB_GENSERVE_MODE": "paged"}
        cfg = GenServeConfig.from_env(env)
        assert (cfg.page_size, cfg.deadline_ms, cfg.enabled) == (8, 250.0, False)
        monkeypatch.setenv("NORNICDB_GENSERVE_MAX_SEQS", "3")
        genserve.configure(None)
        assert genserve.current_config().max_seqs == 3
        mine = GenServeConfig(max_seqs=5)
        genserve.configure(mine)
        try:
            assert genserve.current_config() is mine
        finally:
            genserve.configure(None)

    def test_stats_snapshot(self):
        eng = _engine()
        eng.generate(_prompt(20, seed=1), max_new_tokens=3)
        snap = eng.stats_snapshot()
        assert snap["completed"] == 1 and snap["generated_tokens"] == 3
        assert snap["fused_steps"] >= 3 and snap["prefill_chunks"] >= 1
        assert snap["device"] == "cpu" and snap["mode"] == "paged"
        assert snap["queue_depth"] == 0 and snap["programs"]

    def test_concurrent_submitters(self):
        eng = _engine()
        prompts = [_prompt(n, seed=30) for n in (4, 9, 14, 22, 33, 47)]
        outs = [None] * len(prompts)

        def client(i):
            outs[i] = eng.generate(prompts[i], max_new_tokens=5)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert outs == [_dense_ref(p, 5) for p in prompts]
