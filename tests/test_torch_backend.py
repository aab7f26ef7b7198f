"""The port's device owner (``nornicdb_tpu_torch.backend``) against the JAX
package's, under the port's policy.

The cases of ``tests/test_backend.py`` (``TestStateMachine``,
``TestCorpusFallback``, ``TestServiceUnderFault``, ``TestLockGuard``,
``TestDefaultManagerWiring``) run against the port on the CPU with an
injected manager over ``FakeHooks``. The port has one policy, ``"fail"``:
where a JAX case serves from the host under JAX's default ``"cpu"``, the
port's case holds that the call raises DeviceUnavailable within the bound,
and that after the recovery the same call answers as JAX's host path did
(the same ids; scores within bf16's rounding, the device path's product). A config naming ``"cpu"`` is refused.
For the same FakeHooks script both managers go through the same
transitions and counters. The embedder's and the generation engine's
gates are held to the policy, and a consumer on the CPU with no injected
manager never creates one.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from nornicdb_tpu import backend as jax_backend
from nornicdb_tpu.ops.similarity import DeviceCorpus as JaxCorpus
from nornicdb_tpu_torch import backend as backend_mod
from nornicdb_tpu_torch.backend import BackendManager, FakeHooks, hooks_from_env
from nornicdb_tpu_torch.errors import BackendLockHeldError, DeviceUnavailable
from nornicdb_tpu_torch.ops.similarity import DeviceCorpus

DIMS = 16
# the device path scores with a bf16 product (as the JAX package's device
# path): a cosine in [0.5, 1] rounds by at most half of bf16's 2**-8 step
BF16_TOL = 4e-3

_LIVE_MANAGERS: list = []


@pytest.fixture(autouse=True)
def _stop_managers():
    yield
    while _LIVE_MANAGERS:
        _LIVE_MANAGERS.pop().stop()


def _mgr(hooks, cls=BackendManager, **kw):
    kw.setdefault("acquire_timeout", 0.3)
    kw.setdefault("probe_interval", 0.03)
    kw.setdefault("probe_timeout", 0.25)
    kw.setdefault("degrade_after", 3)
    kw.setdefault("recover_after", 2)
    mgr = cls(hooks=hooks, **kw)
    _LIVE_MANAGERS.append(mgr)
    return mgr


def _wait_state(mgr, state, timeout=10.0):
    deadline = time.monotonic() + timeout
    while mgr.state != state and time.monotonic() < deadline:
        time.sleep(0.01)
    assert mgr.state == state, f"never reached {state}, stuck at {mgr.state}"


def _vecs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, DIMS)).astype(np.float32)


def _corpus(mgr, n=64, seed=0):
    vecs = _vecs(n, seed)
    c = DeviceCorpus(dims=DIMS, backend=mgr, device="cpu")
    c.add_batch([f"n{i}" for i in range(n)], vecs)
    return c, vecs


class TestStateMachine:
    def test_the_only_policy_is_fail(self):
        """JAX's default policy is "cpu"; the port's manager takes no
        policy at all, and a config that names "cpu" is refused."""
        from nornicdb_tpu_torch.config import BackendConfig

        assert jax_backend.BackendManager(
            hooks=jax_backend.FakeHooks("ok")).fallback == "cpu"
        assert not hasattr(BackendManager(hooks=FakeHooks("ok")), "fallback")
        with pytest.raises(TypeError):
            BackendManager(hooks=FakeHooks("ok"), fallback="cpu")
        with pytest.raises(ValueError, match="device='cpu'"):
            backend_mod.configure(BackendConfig(fallback="cpu"))
        backend_mod.configure(BackendConfig(fallback="fail"))
        backend_mod.configure()

    def test_ok_acquire_reaches_ready(self):
        mgr = _mgr(FakeHooks("ok"))
        assert mgr.await_ready() is True
        assert mgr.state == backend_mod.READY
        assert mgr.stats()["device"]["platform"] == "fake"

    def test_hang_acquire_times_out_to_degraded(self):
        mgr = _mgr(FakeHooks("hang"), acquire_timeout=0.2)
        t0 = time.perf_counter()
        ok = mgr.await_ready()
        waited = time.perf_counter() - t0
        assert ok is False
        assert waited < 1.2, "await_ready must honor the acquire timeout"
        _wait_state(mgr, backend_mod.DEGRADED_CPU, timeout=2.0)
        assert mgr.counters.acquire_timeouts >= 1

    def test_require_ready_raises_within_the_bound_by_default(self):
        mgr = _mgr(FakeHooks("hang"), acquire_timeout=0.2)
        t0 = time.perf_counter()
        with pytest.raises(DeviceUnavailable, match="not serving"):
            mgr.require_ready()
        assert time.perf_counter() - t0 < 1.2

    def test_failing_acquire_degrades(self):
        mgr = _mgr(FakeHooks("fail"))
        assert mgr.await_ready() is False
        _wait_state(mgr, backend_mod.DEGRADED_CPU, timeout=2.0)

    def test_counters_are_current_when_the_state_is_seen(self, monkeypatch):
        """A caller that sees READY after a recovery reads the recovery's
        count (the JAX manager counts after releasing its lock, so a
        reader woken on the new state can read the old count). The
        transition's log line is slowed to widen that window."""
        import importlib

        # the module (the package's ``manager`` is the default-manager call)
        manager_mod = importlib.import_module(
            "nornicdb_tpu_torch.backend.manager")
        real = manager_mod.logger.warning

        def slow_warning(*a, **kw):
            real(*a, **kw)
            time.sleep(0.2)

        monkeypatch.setattr(manager_mod.logger, "warning", slow_warning)
        hooks = FakeHooks("hang")
        mgr = _mgr(hooks, acquire_timeout=0.2)
        mgr.await_ready()
        _wait_state(mgr, backend_mod.DEGRADED_CPU, timeout=5.0)
        assert mgr.counters.degrades == 1
        hooks.set_mode("ok")
        _wait_state(mgr, backend_mod.READY, timeout=10.0)
        assert mgr.counters.recoveries == 1, mgr.counters

    def test_degraded_await_fails_fast(self):
        mgr = _mgr(FakeHooks("hang"), acquire_timeout=0.2)
        mgr.await_ready()
        _wait_state(mgr, backend_mod.DEGRADED_CPU, timeout=2.0)
        t0 = time.perf_counter()
        assert mgr.await_ready() is False
        assert time.perf_counter() - t0 < 0.05

    @pytest.mark.parametrize("script", [
        ["fail", "fail", "ok", "fail", "fail", "fail",
         "ok", "fail", "ok", "fail", "ok", "fail", "ok", "ok"],
        ["fail"] * 5 + ["ok"] * 3 + ["fail"] * 3 + ["ok", "ok"],
        ["ok", "fail", "ok", "fail", "ok"],
    ])
    def test_same_transitions_and_counters_as_jax(self, script):
        """The probe loop's body, stepped through one FakeHooks script in
        both packages: the same states, transitions and counters."""
        managers = []
        for pkg, cls, hooks in (
                ("jax", jax_backend.BackendManager, jax_backend.FakeHooks),
                ("torch", BackendManager, FakeHooks)):
            h = hooks("ok")
            m = _mgr(h, cls=cls, degrade_after=3, recover_after=2,
                     probe_interval=60.0)
            assert m.await_ready()
            states = []
            for mode in script:
                h.set_mode(mode)
                m._probe_tick()
                states.append(m.state)
            managers.append((states, m))
        (js, jm), (ts, tm) = managers
        assert ts == js
        assert ([(a, b, r) for _, a, b, r in tm.counters.transitions]
                == [(a, b, r) for _, a, b, r in jm.counters.transitions])
        for key in ("recoveries", "degrades",
                    "acquire_timeouts", "probes", "probe_failures"):
            assert getattr(tm.counters, key) == getattr(jm.counters, key), key

    def test_probe_flap_hysteresis_no_thrash(self):
        hooks = FakeHooks("ok")
        mgr = _mgr(hooks, degrade_after=3, recover_after=2,
                   probe_interval=60.0)
        assert mgr.await_ready()

        def tick(mode):
            hooks.set_mode(mode)
            mgr._probe_tick()

        tick("fail")
        tick("fail")
        assert mgr.state == backend_mod.READY
        tick("ok")
        tick("fail")
        tick("fail")
        assert mgr.state == backend_mod.READY
        assert mgr.counters.degrades == 0
        tick("fail")
        assert mgr.state == backend_mod.DEGRADED_CPU
        assert mgr.counters.degrades == 1
        for j in range(6):
            tick("ok" if j % 2 == 0 else "fail")
        assert mgr.state == backend_mod.DEGRADED_CPU
        assert mgr.counters.recoveries == 0
        tick("ok")
        tick("ok")
        assert mgr.state == backend_mod.READY
        assert mgr.counters.recoveries == 1

    def test_slow_probe_counts_as_failure(self):
        hooks = FakeHooks("ok")
        mgr = _mgr(hooks, probe_latency_threshold=0.02, probe_timeout=1.0)
        assert mgr.await_ready()
        hooks.set_mode("slow")
        hooks.delay = 0.05
        _wait_state(mgr, backend_mod.DEGRADED_CPU)
        assert mgr.counters.probe_failures >= mgr.degrade_after

    def test_stats_shape(self):
        mgr = _mgr(FakeHooks("ok"))
        mgr.await_ready()
        time.sleep(0.1)  # a few green probes
        s = mgr.stats()
        want = set(jax_backend.BackendManager(
            hooks=jax_backend.FakeHooks("ok")).stats())
        # the port has no policy knob, no re-upload mode, no host serving
        knobs = {"fallback_policy", "recovery_reupload", "fallbacks_total"}
        assert knobs <= want and not knobs & set(s)
        assert want - knobs <= set(s)
        assert s["transitions"][-1]["to"] == backend_mod.READY
        assert 0 < s["probe_latency_p50_s"] <= s["probe_latency_max_s"]

    def test_fake_hooks_from_env(self, monkeypatch):
        monkeypatch.setenv("NORNICDB_FAKE_BACKEND", "hang")
        h = hooks_from_env()
        assert isinstance(h, FakeHooks) and h.mode == "hang"
        monkeypatch.setenv("NORNICDB_FAKE_BACKEND", "slow:0.2")
        h = hooks_from_env()
        assert h.mode == "slow" and h.delay == 0.2
        monkeypatch.setenv("NORNICDB_FAKE_BACKEND", "bogus")
        assert hooks_from_env() is None
        monkeypatch.delenv("NORNICDB_FAKE_BACKEND")
        assert hooks_from_env() is None

    def test_metric_families_render_as_jax(self):
        from nornicdb_tpu.telemetry.metrics import REGISTRY as JR
        from nornicdb_tpu_torch.telemetry.metrics import REGISTRY as PR

        def families(reg):
            text = reg.render_prometheus()
            return [ln for ln in text.splitlines()
                    if ln.startswith(("# HELP nornicdb_backend_",
                                      "# TYPE nornicdb_backend_"))]

        got, want = families(PR), families(JR)
        assert got and got == want


class TestCorpusFallback:
    def test_default_policy_raises_within_the_bound(self):
        mgr = _mgr(FakeHooks("hang"), acquire_timeout=0.2)
        c, vecs = _corpus(mgr)
        t0 = time.perf_counter()
        with pytest.raises(DeviceUnavailable):
            c.search(vecs[0], k=3)
        assert time.perf_counter() - t0 < 1.2
        with pytest.raises(DeviceUnavailable):
            c.score_subset(vecs[0], ["n0"])

    def test_degraded_search_raises_then_recovers_exact(self):
        """JAX's case serves exact host results while degraded; the port's
        raises at once, and answers the same exact results once the card
        serves again."""
        hooks = FakeHooks("hang")
        mgr = _mgr(hooks, acquire_timeout=0.2)
        c, vecs = _corpus(mgr)
        t0 = time.perf_counter()
        with pytest.raises(DeviceUnavailable):
            c.search(vecs[7], k=5)
        assert time.perf_counter() - t0 < 1.2
        _wait_state(mgr, backend_mod.DEGRADED_CPU, timeout=2.0)
        t0 = time.perf_counter()
        with pytest.raises(DeviceUnavailable):
            c.search(vecs[7], k=5)
        assert time.perf_counter() - t0 < 0.05  # degraded: no wait
        hooks.set_mode("ok")
        _wait_state(mgr, backend_mod.READY)
        res = c.search(vecs[7], k=5, exact=True)
        assert res[0][0][0] == "n7"
        assert res[0][0][1] == pytest.approx(1.0, abs=BF16_TOL)
        norm = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
        want = np.argsort(-(norm @ norm[7]))[:5]
        assert [r[0] for r in res[0]] == [f"n{i}" for i in want]

    def test_recovered_search_equals_jax_host_search(self):
        """The same corpus and queries: JAX's degraded host path (float32)
        and the port's device path after its recovery (a bf16 product, as
        JAX's device path): the same top 10 up to bf16's rounding."""
        jmgr = _mgr(jax_backend.FakeHooks("hang"),
                    cls=jax_backend.BackendManager, acquire_timeout=0.2)
        hooks = FakeHooks("hang")
        tmgr = _mgr(hooks, acquire_timeout=0.2)
        vecs = _vecs(200, seed=3)
        ids = [f"n{i}" for i in range(200)]
        jc = JaxCorpus(dims=DIMS, backend=jmgr)
        jc.add_batch(ids, vecs)
        tc = DeviceCorpus(dims=DIMS, backend=tmgr, device="cpu")
        tc.add_batch(ids, vecs)
        for c in (jc, tc):
            c.remove("n5")
        q = _vecs(8, seed=9)
        with pytest.raises(DeviceUnavailable):
            tc.search(q, k=10)
        hooks.set_mode("ok")
        _wait_state(tmgr, backend_mod.READY)
        want, got = jc.search(q, k=10), tc.search(q, k=10, exact=True)
        # bf16 may swap rows whose float32 scores lie within its rounding:
        # each returned row's reported score is its float32 cosine within
        # BF16_TOL, and the rows' float32 cosines are JAX's top 10
        norm = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        for j, (w, g) in enumerate(zip(want, got)):
            exact = np.array([norm[int(i[1:])] @ qn[j] for i, _ in g])
            assert "n5" not in [i for i, _ in g] and len(g) == len(w) == 10
            np.testing.assert_allclose([s for _, s in g], exact,
                                       atol=BF16_TOL)
            np.testing.assert_allclose(np.sort(exact)[::-1],
                                       [s for _, s in w], atol=2 * BF16_TOL)
        ws = jc.score_subset(q[0], ["n1", "n5", "n7", "zz"])
        gs = tc.score_subset(q[0], ["n1", "n5", "n7", "zz"])
        assert [i for i, _ in gs] == [i for i, _ in ws] == ["n1", "n7"]
        np.testing.assert_allclose([s for _, s in gs], [s for _, s in ws],
                                   atol=BF16_TOL)
        assert jmgr.counters.fallbacks == 2

    def test_degraded_score_subset(self):
        hooks = FakeHooks("hang")
        mgr = _mgr(hooks, acquire_timeout=0.2)
        c, vecs = _corpus(mgr)
        with pytest.raises(DeviceUnavailable):
            c.score_subset(vecs[3], ["n3", "n5", "missing"])
        hooks.set_mode("ok")
        _wait_state(mgr, backend_mod.READY)
        scored = c.score_subset(vecs[3], ["n3", "n5", "missing"])
        assert [i for i, _ in scored] == ["n3", "n5"]
        assert scored[0][1] == pytest.approx(1.0, abs=BF16_TOL)

    def test_device_arrays_raise_while_degraded(self):
        mgr = _mgr(FakeHooks("hang"), acquire_timeout=0.2)
        c, _ = _corpus(mgr)
        with pytest.raises(DeviceUnavailable):
            c.device_arrays()

    def test_recovery_reupload_equivalence_vs_rebuild(self):
        hooks = FakeHooks("hang")
        mgr = _mgr(hooks, acquire_timeout=0.2)
        c, vecs = _corpus(mgr, n=48)
        extra = np.random.default_rng(99).standard_normal(
            (16, DIMS)).astype(np.float32)
        with pytest.raises(DeviceUnavailable):
            c.search(vecs[0], k=3)  # trips degraded
        c.add_batch([f"x{i}" for i in range(16)], extra)
        c.remove("n5")
        _wait_state(mgr, backend_mod.DEGRADED_CPU, timeout=2.0)
        hooks.set_mode("ok")
        _wait_state(mgr, backend_mod.READY)
        assert mgr.counters.recoveries == 1
        ok_mgr = _mgr(FakeHooks("ok"))
        fresh = DeviceCorpus(dims=DIMS, backend=ok_mgr, device="cpu")
        fresh.add_batch([f"n{i}" for i in range(48)], vecs)
        fresh.add_batch([f"x{i}" for i in range(16)], extra)
        fresh.remove("n5")
        for q in (vecs[2], extra[4], vecs[5]):
            got = c.search(q, k=8, exact=True)[0]
            want = fresh.search(q, k=8, exact=True)[0]
            assert [i for i, _ in got] == [i for i, _ in want]
            for (_, a), (_, b) in zip(got, want):
                assert a == pytest.approx(b, abs=1e-5)
        assert c.sync_stats.full_uploads >= 1

    def test_recovery_patches_degraded_writes(self):
        """The resident buffer survives a recovery (JAX's "dirty" mode, the
        only one on CUDA): a write made while degraded is patched in, with
        no whole-corpus upload."""
        hooks = FakeHooks("ok")
        mgr = _mgr(hooks, degrade_after=1, recover_after=1)
        c, vecs = _corpus(mgr, n=500)
        assert c.search(vecs[0], k=3)[0][0][0] == "n0"
        fulls_before = c.sync_stats.full_uploads
        hooks.set_mode("fail")
        _wait_state(mgr, backend_mod.DEGRADED_CPU)
        v_new = np.ones(DIMS, np.float32)
        c.add("fresh", v_new)
        with pytest.raises(DeviceUnavailable):
            c.search(v_new, k=1)
        hooks.set_mode("ok")
        _wait_state(mgr, backend_mod.READY)
        res = c.search(v_new, k=1, exact=True)
        assert res[0][0][0] == "fresh"  # device path sees the patch
        assert c.sync_stats.full_uploads == fulls_before
        assert c.sync_stats.patches >= 1

    def test_cluster_fit_while_degraded_raises_then_installs(self):
        from nornicdb_tpu_torch.ops.kmeans import kmeans_fit

        hooks = FakeHooks("ok")
        mgr = _mgr(hooks, degrade_after=1, recover_after=1)
        c, vecs = _corpus(mgr, n=64)
        assert c.search(vecs[0], k=1)[0]
        res = kmeans_fit(vecs, k=4, iters=5, device="cpu")
        assignments = {f"n{i}": int(a) for i, a in enumerate(res.assignments)}
        hooks.set_mode("fail")
        _wait_state(mgr, backend_mod.DEGRADED_CPU)
        with pytest.raises(DeviceUnavailable):
            c.set_clusters(res.centroids, assignments)
        assert c._centroids is None
        hooks.set_mode("ok")
        _wait_state(mgr, backend_mod.READY)
        c.set_clusters(res.centroids, assignments)
        assert c._centroids is not None
        assert c.search(vecs[9], k=3, n_probe=2)[0][0][0] == "n9"

    def test_recovery_keeps_cluster_state(self):
        from nornicdb_tpu_torch.ops.kmeans import kmeans_fit

        hooks = FakeHooks("ok")
        mgr = _mgr(hooks, degrade_after=1, recover_after=1)
        c, vecs = _corpus(mgr, n=64)
        assert c.search(vecs[0], k=1)[0]
        res = kmeans_fit(vecs, k=4, iters=5, device="cpu")
        c.set_clusters(res.centroids,
                       {f"n{i}": int(a) for i, a in enumerate(res.assignments)})
        centroids = c._centroids
        assert centroids is not None
        hooks.set_mode("fail")
        _wait_state(mgr, backend_mod.DEGRADED_CPU)
        hooks.set_mode("ok")
        _wait_state(mgr, backend_mod.READY)
        assert c._centroids is centroids  # never dropped
        assert c.search(vecs[9], k=3, n_probe=2)[0][0][0] == "n9"


class TestServiceUnderFault:
    def _service(self, mgr):
        from nornicdb_tpu_torch.search.service import (
            SearchConfig,
            SearchService,
        )
        from nornicdb_tpu_torch.storage import MemoryEngine, Node

        storage = MemoryEngine()
        svc = SearchService(storage, dims=DIMS, device="cpu",
                            config=SearchConfig(min_similarity=-1.0))
        vecs = np.random.default_rng(5).standard_normal(
            (20, DIMS)).astype(np.float32)
        for i in range(20):
            node = Node(id=f"doc{i}", labels=["Doc"],
                        properties={"content": f"document number {i}"},
                        embedding=vecs[i])
            storage.create_node(node)
            svc.index_node(node)
        svc._corpus._backend = mgr
        return svc, storage, vecs

    def test_search_after_write_answers_after_recovery(self):
        """JAX's case answers from the host within the deadline; the
        port's raises within it, reports the state, and answers with the
        fresh write once the card serves."""
        from nornicdb_tpu_torch.storage import Node

        hooks = FakeHooks("hang")
        mgr = _mgr(hooks, acquire_timeout=0.5)
        svc, storage, _ = self._service(mgr)
        v = np.full(DIMS, 0.5, np.float32)
        node = Node(id="fresh", labels=["Doc"],
                    properties={"content": "the freshest document"},
                    embedding=v)
        storage.create_node(node)
        svc.index_node(node)
        done = threading.Event()
        out: list = []

        def run():
            try:
                svc.vector_candidates(v, k=3)
            except DeviceUnavailable as e:
                out.append(e)
            done.set()

        threading.Thread(target=run, daemon=True).start()
        assert done.wait(mgr.acquire_timeout + 1.0)
        assert len(out) == 1 and isinstance(out[0], DeviceUnavailable)
        _wait_state(mgr, backend_mod.DEGRADED_CPU, timeout=2.0)
        snap = svc.stats_snapshot()
        assert snap["backend"]["state"] == backend_mod.DEGRADED_CPU
        hooks.set_mode("ok")
        _wait_state(mgr, backend_mod.READY)
        assert svc.vector_candidates(v, k=3)[0][0] == "fresh"

    def test_search_after_write_raises_within_deadline_by_default(self):
        mgr = _mgr(FakeHooks("hang"), acquire_timeout=0.5)
        svc, _, vecs = self._service(mgr)
        t0 = time.perf_counter()
        with pytest.raises(DeviceUnavailable):
            svc.vector_candidates(vecs[0], k=3)
        assert time.perf_counter() - t0 < mgr.acquire_timeout + 1.0

    def test_concurrent_writers_and_searchers_never_wedge(self):
        from nornicdb_tpu_torch.storage import Node

        mgr = _mgr(FakeHooks("hang"), acquire_timeout=0.3)
        svc, _, vecs = self._service(mgr)
        stop = threading.Event()
        errors: list = []
        refused: list = []

        def writer():
            rng = np.random.default_rng(17)
            i = 0
            while not stop.is_set():
                node = Node(id=f"w{i % 10}", labels=["Doc"],
                            properties={"content": f"write {i}"},
                            embedding=rng.standard_normal(DIMS).astype(
                                np.float32))
                try:
                    svc.index_node(node)
                except Exception as e:  # pragma: no cover - failure path
                    errors.append(e)
                i += 1
                time.sleep(0.002)

        def searcher():
            for _ in range(10):
                try:
                    svc.vector_candidates(vecs[3], k=5)
                except DeviceUnavailable as e:
                    refused.append(e)
                except Exception as e:  # pragma: no cover - failure path
                    errors.append(e)

        wt = threading.Thread(target=writer, daemon=True)
        wt.start()
        threads = [threading.Thread(target=searcher, daemon=True)
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15.0)
            assert not t.is_alive(), "searcher wedged under hung backend"
        stop.set()
        wt.join(timeout=5.0)
        assert not errors, errors
        assert len(refused) == 40  # every search raised, none wedged

    def test_batched_path_serves_under_fault(self):
        """Batched searches under a hung owner raise within the bound
        (none wedges); once the card serves, the batcher answers."""
        from nornicdb_tpu_torch.search.service import (
            SearchConfig,
            SearchService,
        )
        from nornicdb_tpu_torch.storage import MemoryEngine, Node

        hooks = FakeHooks("hang")
        mgr = _mgr(hooks, acquire_timeout=0.3)
        svc = SearchService(
            MemoryEngine(), dims=DIMS, device="cpu",
            config=SearchConfig(batching_enabled=True, batch_window=0.005),
        )
        vecs = np.random.default_rng(3).standard_normal(
            (12, DIMS)).astype(np.float32)
        for i in range(12):
            svc.index_node(Node(id=f"d{i}", labels=["Doc"],
                                properties={"content": f"doc {i}"},
                                embedding=vecs[i]))
        svc._corpus._backend = mgr
        results = []

        def search(i):
            try:
                results.append(svc.vector_candidates(vecs[i], k=3))
            except DeviceUnavailable as e:
                results.append(e)

        def burst():
            results.clear()
            threads = [threading.Thread(target=search, args=(i,),
                                        daemon=True) for i in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10.0)
                assert not t.is_alive(), "batched search wedged"
            return list(results)

        try:
            got = burst()
            assert len(got) == 6
            assert all(isinstance(r, DeviceUnavailable) for r in got), got
            hooks.set_mode("ok")
            _wait_state(mgr, backend_mod.READY)
            got = burst()
            assert len(got) == 6 and all(isinstance(r, list) and r
                                         for r in got), got
        finally:
            svc.shutdown()


class TestLockGuard:
    def test_guard_raises_when_nornsan_reports_held_locks(self, monkeypatch):
        import importlib

        manager_mod = importlib.import_module(
            "nornicdb_tpu_torch.backend.manager")
        monkeypatch.setattr(manager_mod, "_held_lock_sites",
                            lambda: ["ops/similarity.py:373"])
        mgr = _mgr(FakeHooks("ok"))
        with pytest.raises(BackendLockHeldError):
            mgr.await_ready()
        assert mgr.counters.lock_violations == 1

    def test_guard_inactive_without_nornsan(self):
        mgr = _mgr(FakeHooks("ok"))
        assert mgr.await_ready() is True

    def test_corpus_search_path_holds_no_lock_at_gate(self, monkeypatch):
        import importlib

        manager_mod = importlib.import_module(
            "nornicdb_tpu_torch.backend.manager")
        mgr = _mgr(FakeHooks("ok"))
        c, vecs = _corpus(mgr)
        sync_lock = c._sync_lock

        def held():
            return ["sync_lock"] if sync_lock._is_owned() else []

        monkeypatch.setattr(manager_mod, "_held_lock_sites", held)
        assert c.search(vecs[0], k=3)[0][0][0] == "n0"


class TestDefaultManagerWiring:
    def test_manager_stats_surface(self):
        backend_mod.reset_default()
        try:
            assert backend_mod.manager_stats() is None
            backend_mod.configure(hooks=FakeHooks("ok"))
            backend_mod.manager().ensure_started()
            s = backend_mod.manager_stats()
            assert s is not None and "state" in s
        finally:
            backend_mod.reset_default()
            backend_mod.configure()

    def test_configure_applies_to_fresh_default(self):
        from nornicdb_tpu_torch.config import BackendConfig

        backend_mod.reset_default()
        try:
            backend_mod.configure(BackendConfig(acquire_timeout=3.5),
                                  hooks=FakeHooks("ok"))
            mgr = backend_mod.manager()
            assert mgr.acquire_timeout == 3.5
        finally:
            backend_mod.reset_default()
            backend_mod.configure()

    def test_env_naming_the_cpu_policy_is_refused(self, monkeypatch):
        monkeypatch.setenv("NORNICDB_DEVICE_FALLBACK", "cpu")
        backend_mod.reset_default()
        try:
            backend_mod.configure(hooks=FakeHooks("ok"))
            with pytest.raises(ValueError, match="'cpu' is not supported"):
                backend_mod.manager()
            assert backend_mod.manager_stats() is None
            monkeypatch.setenv("NORNICDB_DEVICE_FALLBACK", "fail")
            assert backend_mod.manager().await_ready()
        finally:
            backend_mod.reset_default()
            backend_mod.configure()

    def test_devices_under_a_fake_backend(self):
        backend_mod.reset_default()
        try:
            backend_mod.configure(hooks=FakeHooks("hang"),
                                  acquire_timeout=0.2)
            t0 = time.perf_counter()
            with pytest.raises(DeviceUnavailable):
                backend_mod.devices()
            assert time.perf_counter() - t0 < 1.2
        finally:
            backend_mod.reset_default()
            backend_mod.configure()


class _Spy:
    """Hooks that record a touch: a CPU consumer must never make one."""

    def __init__(self):
        self.touches = self.probes = 0

    def touch(self):
        self.touches += 1
        return {"platform": "spy", "device_count": 1}

    def probe(self):
        self.probes += 1


class TestCpuConsumersNeverStartAManager:
    def test_cpu_consumers_create_no_manager(self, monkeypatch):
        import nornicdb_tpu_torch
        from nornicdb_tpu_torch.embed import DeviceEmbedder
        from nornicdb_tpu_torch.models import BGE_SMALL

        spy = _Spy()
        backend_mod.reset_default()
        made = []
        real = backend_mod.BackendManager

        def spying(*a, **kw):
            made.append(kw)
            kw["hooks"] = spy
            return real(*a, **kw)

        monkeypatch.setattr(backend_mod, "BackendManager", spying)
        try:
            vecs = _vecs(32)
            c = DeviceCorpus(dims=DIMS, device="cpu")
            c.add_batch([f"n{i}" for i in range(32)], vecs)
            assert c.search(vecs[1], k=2)[0][0][0] == "n1"
            emb = DeviceEmbedder(cfg=BGE_SMALL, device="cpu")
            emb.embed_batch(["graph node"])
            db = nornicdb_tpu_torch.open_db("", device="cpu")
            db.cypher("UNWIND range(1, 3) AS i CREATE (:N {i: i})")
            assert db.cypher("MATCH (n:N) RETURN n.i ORDER BY n.i DESC "
                             "LIMIT 1").rows == [[3]]
            db.close()
            assert made == [] and spy.touches == 0 and spy.probes == 0
            assert backend_mod.manager_stats() is None
        finally:
            backend_mod.reset_default()


class TestEmbedderGate:
    def _embedder(self, mgr):
        from nornicdb_tpu_torch.embed import DeviceEmbedder
        from nornicdb_tpu_torch.models import BGE_SMALL

        return DeviceEmbedder(cfg=BGE_SMALL, device="cpu", backend=mgr)

    def test_fail_policy_raises_within_the_bound(self):
        emb = self._embedder(_mgr(FakeHooks("hang"), acquire_timeout=0.2))
        t0 = time.perf_counter()
        with pytest.raises(DeviceUnavailable):
            emb.embed_batch(["a text"])
        assert time.perf_counter() - t0 < 1.2
        assert emb.stats["batches"] == 0

    def test_degraded_raises_and_recovery_embeds_the_same(self):
        hooks = FakeHooks("ok")
        mgr = _mgr(hooks, degrade_after=1, recover_after=1)
        emb = self._embedder(mgr)
        want = emb.embed_batch(["graph node", "another text"])
        hooks.set_mode("fail")
        _wait_state(mgr, backend_mod.DEGRADED_CPU)
        with pytest.raises(DeviceUnavailable):
            emb.embed_batch(["graph node", "another text"])
        hooks.set_mode("ok")
        _wait_state(mgr, backend_mod.READY)
        got = emb.embed_batch(["graph node", "another text"])
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-6)
        assert emb.stats["batches"] == 2


class TestGenerationGate:
    def _engine(self, mgr, fallback="fail"):
        from nornicdb_tpu_torch.config import GenServeConfig
        from nornicdb_tpu_torch.genserve import GenerationEngine
        from nornicdb_tpu_torch.models import QWEN_SMALL, init_params

        eng = GenerationEngine(
            init_params(QWEN_SMALL, 0, "cpu"), QWEN_SMALL,
            config=GenServeConfig(fallback=fallback, max_seq_tokens=64,
                                  pool_pages=9, page_size=16),
            device="cpu", manager=mgr)
        return eng

    def test_fail_policy_fails_the_request(self):
        mgr = _mgr(FakeHooks("hang"), acquire_timeout=0.2)
        eng = self._engine(mgr)
        try:
            with pytest.raises(DeviceUnavailable):
                eng.warmup(timeout=0.3)
            with pytest.raises(DeviceUnavailable):
                eng.generate([5, 17, 42], max_new_tokens=4)
        finally:
            eng.stop()

    def test_named_cpu_config_is_refused(self):
        with pytest.raises(ValueError, match="'cpu' is not supported"):
            self._engine(_mgr(FakeHooks("ok")), "cpu")

    def test_degraded_fails_and_recovery_generates_the_same_tokens(self):
        """The pool stays resident across a recovery: the same greedy
        tokens before the fault and after it."""
        hooks = FakeHooks("ok")
        mgr = _mgr(hooks, degrade_after=1, recover_after=1)
        eng = self._engine(mgr)
        try:
            want = eng.generate([5, 17, 42], max_new_tokens=6)
            hooks.set_mode("fail")
            _wait_state(mgr, backend_mod.DEGRADED_CPU)
            with pytest.raises(DeviceUnavailable):
                eng.generate([5, 17, 42], max_new_tokens=6)
            hooks.set_mode("ok")
            _wait_state(mgr, backend_mod.READY)
            assert eng.generate([5, 17, 42], max_new_tokens=6) == want
        finally:
            eng.stop()


def test_cpu_tensor_round_trip_hooks_are_lazy():
    """Importing the backend never initialises CUDA, and the real hooks
    make their stream only at touch."""
    from nornicdb_tpu_torch.backend import RealHooks

    h = RealHooks()
    assert h.stream is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            h.probe()
