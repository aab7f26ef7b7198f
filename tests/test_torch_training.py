"""The port's training steps (nornicdb_tpu_torch.models.training) against
the JAX package's on the CPU.

The same numpy-seeded batches go through both; JAX's parameters are carried
into the port with ``convert.qwen2_params_from_jax`` /
``convert.bge_params_from_jax``, so both start from the same bits.
Gradients are compared against ``jax.value_and_grad`` directly, AdamW against
``optax.adamw`` on identical gradients, and multi-step runs by their losses
(after one step Adam's update is near ``lr * sign(g)``, so a gradient near
zero with another sign moves one element by up to ~2 lr).

Tolerances:
- float32 losses: |d| <= 1e-5; float32 gradients: each leaf's max |d| <=
  1e-4 of the leaf's largest |g| (measured <= 4e-6).
- bfloat16 losses: |d| <= 1e-2 (losses of 2.5-6.3; activations carry 2**-8
  relative rounding, InfoNCE's temperature of 0.05 multiplies it by 20);
  bfloat16 gradients: per-leaf cosine >= 0.995 (measured >= 0.998).
- bge-m3's key biases get an exact gradient of zero (softmax is invariant
  to adding q.b_k to a row): both packages give rounding noise there, held
  to |g| <= 1e-6 (float32) / 1e-4 (bfloat16) of the largest gradient entry.
- AdamW on identical gradients, 3 updates: float32 parameters within 1e-4
  lr, moments within 1e-5 relative (Frobenius); bfloat16 parameters within
  one bf16 ulp of the value plus 0.25 lr (the direction comes from moments
  rounded to bf16, which differ most where a moment nearly cancels;
  measured <= 0.13 lr), moments within 2**-7 relative (Frobenius).
- 5 train steps from carried parameters: float32 losses within 1e-4, bf16
  within 2e-2 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nornicdb_tpu.models import bge_m3 as jbge
from nornicdb_tpu.models import qwen2 as jqwen
from nornicdb_tpu.models import training as jtrain
from nornicdb_tpu.models import weights as jweights
from nornicdb_tpu_torch import convert
from nornicdb_tpu_torch.models import bge_m3 as tbge
from nornicdb_tpu_torch.models import qwen2 as tqwen
from nornicdb_tpu_torch.models import training as ttrain
from nornicdb_tpu_torch.models import weights as tweights

DTYPES = ["float32", "bfloat16"]
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _qwen(dtype, seed=0):
    jc = dataclasses.replace(jqwen.QWEN_SMALL, dtype=dtype)
    tc = dataclasses.replace(tqwen.QWEN_SMALL, dtype=dtype)
    jp = jqwen.init_params(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp


def _bge(dtype, seed=1):
    jc = dataclasses.replace(jbge.BGE_SMALL, dtype=dtype)
    tc = dataclasses.replace(tbge.BGE_SMALL, dtype=dtype)
    jp = jbge.init_params(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp


def _carry(jp, kind):
    host = jax.tree.map(np.asarray, jp)
    if kind == "qwen":
        return convert.qwen2_params_from_jax(host, "cpu")
    return convert.bge_params_from_jax(host, "cpu")


def _lm_batch(rng, vocab, b=4, t=17):
    ids = rng.integers(0, vocab, (b, t)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 10:] = 0  # a padded row: its tail predicts nothing
    return {"ids": ids, "mask": mask}


def _pair_batch(rng, vocab, b=8, t=16):
    ids_a = rng.integers(4, vocab, (b, t)).astype(np.int32)
    ids_b = rng.integers(4, vocab, (b, t)).astype(np.int32)
    mask_a = np.ones_like(ids_a)
    mask_a[:, 12:] = 0
    return {"ids_a": ids_a, "mask_a": mask_a,
            "ids_b": ids_b, "mask_b": np.ones_like(ids_b)}


# jitted: op-by-op JAX on the CPU is slower than its compile at these sizes
_lm_value_and_grad = jax.jit(jax.value_and_grad(jtrain.lm_loss),
                             static_argnums=1)
_embedder_value_and_grad = jax.jit(jax.value_and_grad(jtrain.embedder_loss),
                                   static_argnums=1)


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _check_grads(jgrads, params, dtype, zero_grad_leaves=()):
    """Each leaf's gradient in the port against jax.grad's (tolerances in
    the module docstring)."""
    fj, ft = jweights.flatten_params(jgrads), tweights.flatten_params(params)
    assert set(fj) == set(ft)
    gmax = max(float(np.abs(_np(g)).max()) for g in fj.values())
    for name, p in ft.items():
        a, b = _np(fj[name]), _np(p.grad)
        if name.endswith(zero_grad_leaves):
            tol = 1e-6 if dtype == "float32" else 1e-4
            assert np.abs(a).max() <= tol * gmax, name
            assert np.abs(b).max() <= tol * gmax, name
        elif dtype == "float32":
            assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max(), name
        else:
            assert _cos(a, b) >= 0.995, (name, _cos(a, b))


class TestLosses:
    def test_info_nce_loss(self):
        rng = np.random.default_rng(0)
        a = rng.standard_normal((8, 16)).astype(np.float32)
        b = a + 0.3 * rng.standard_normal((8, 16)).astype(np.float32)
        a /= np.linalg.norm(a, axis=1, keepdims=True)
        b /= np.linalg.norm(b, axis=1, keepdims=True)
        for temp in (0.05, 1.0):
            want = float(jtrain.info_nce_loss(jnp.asarray(a), jnp.asarray(b),
                                              temp))
            got = float(ttrain.info_nce_loss(torch.from_numpy(a),
                                             torch.from_numpy(b), temp))
            assert abs(got - want) <= 1e-5, (temp, got, want)

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_lm_loss_and_grads(self, dtype):
        jc, tc, jp = _qwen(dtype)
        batch = _lm_batch(np.random.default_rng(0), jc.vocab_size)
        lj, gj = _lm_value_and_grad(jp, jc, _to_jax(batch))
        state = ttrain.TrainState.create(_carry(jp, "qwen"),
                                         ttrain.make_optimizer())
        lt = ttrain.lm_loss(state.params, tc, _to_torch(batch))
        lt.backward()
        assert abs(float(lt.detach()) - float(lj)) <= LOSS_TOL[dtype]
        _check_grads(gj, state.params, dtype)

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_embedder_loss_and_grads(self, dtype):
        jc, tc, jp = _bge(dtype)
        batch = _pair_batch(np.random.default_rng(1), jc.vocab_size)
        lj, gj = _embedder_value_and_grad(jp, jc, _to_jax(batch))
        state = ttrain.TrainState.create(_carry(jp, "bge"),
                                         ttrain.make_optimizer())
        lt = ttrain.embedder_loss(state.params, tc, _to_torch(batch))
        lt.backward()
        assert abs(float(lt.detach()) - float(lj)) <= LOSS_TOL[dtype]
        _check_grads(gj, state.params, dtype, zero_grad_leaves=("k.b",))

    def test_tied_table_gradient_has_both_terms(self):
        """A bf16 serving dict (``with_f32_logit_weights`` adds a float32
        copy, ``tok_emb_f32``) fed to training: the logits still cast
        ``tok_emb`` in the graph, so its gradient is the lookup's plus the
        logits' term, as in JAX; the copy gets none and the state drops
        it."""
        jc, tc, jp = _qwen("bfloat16")
        batch = _lm_batch(np.random.default_rng(2), jc.vocab_size)
        _, gj = _lm_value_and_grad(jp, jc, _to_jax(batch))
        served = tqwen.with_f32_logit_weights(_carry(jp, "qwen"))
        state = ttrain.TrainState.create(served, ttrain.make_optimizer())
        assert "tok_emb_f32" not in state.params
        ttrain.lm_loss(served, tc, _to_torch(batch)).backward()
        assert served["tok_emb_f32"].grad is None
        got, want = _np(state.params["tok_emb"].grad), _np(gj["tok_emb"])
        assert _cos(got, want) >= 0.995
        # rows of tokens the batch never reads get the logits' term only
        unread = np.setdiff1d(np.arange(jc.vocab_size), batch["ids"])
        assert _cos(got[unread], want[unread]) >= 0.995
        assert np.abs(got[unread]).max() > 0


class TestOptimizer:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_adamw_matches_optax_on_identical_gradients(self, dtype):
        rng = np.random.default_rng(3)
        lr = 1e-3
        shapes = {"w": (64, 48), "b": (48,), "emb": (128, 32)}
        p0 = {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
              for k, s in shapes.items()}
        grads = [{k: (rng.standard_normal(s) * 10 ** rng.uniform(-3, 0))
                  .astype(np.float32) for k, s in shapes.items()}
                 for _ in range(3)]
        jd, td = jnp.dtype(dtype), getattr(torch, dtype)
        opt = optax.adamw(lr, weight_decay=0.01)
        jp = {k: jnp.asarray(v, jd) for k, v in p0.items()}
        js = opt.init(jp)
        state = ttrain.TrainState.create(
            {k: torch.from_numpy(v).to(td) for k, v in p0.items()},
            ttrain.make_optimizer(lr))
        for g in grads:
            updates, js = opt.update({k: jnp.asarray(v, jd)
                                      for k, v in g.items()}, js, jp)
            jp = optax.apply_updates(jp, updates)
            for k, p in state.params.items():
                p.grad = torch.from_numpy(g[k]).to(td)
            state.opt_state.step()
            state.opt_state.zero_grad()
            for k, p in state.params.items():
                slot = state.opt_state.state[p]
                assert slot["exp_avg"].dtype == td  # optax's moment dtype
                for mom, name in ((js[0].mu[k], "exp_avg"),
                                  (js[0].nu[k], "exp_avg_sq")):
                    a, b = _np(mom), _np(slot[name])
                    rel = np.linalg.norm(a - b) / np.linalg.norm(a)
                    assert rel <= (1e-5 if dtype == "float32" else 2 ** -7)
                a, b = _np(jp[k]), _np(p)
                d = np.abs(a - b)
                if dtype == "float32":
                    assert d.max() <= 1e-4 * lr, k
                else:
                    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)),
                                     2.0 ** -126)
                    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
                    assert (d <= ulp + 0.25 * lr).all(), k

    def test_decay_applies_to_every_leaf(self):
        # optax's adamw has no mask: a zero gradient still decays a leaf
        p = {"scale": torch.ones(4), "w": torch.full((2, 2), 2.0)}
        state = ttrain.TrainState.create(p, ttrain.make_optimizer(0.1, 0.5))
        for t in state.params.values():
            t.grad = torch.zeros_like(t)
        state.opt_state.step()
        torch.testing.assert_close(state.params["scale"],
                                   torch.full((4,), 0.95))
        torch.testing.assert_close(state.params["w"],
                                   torch.full((2, 2), 1.9))


class TestTrainSteps:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_lm_steps_match_jax(self, dtype):
        jc, tc, jp = _qwen(dtype, seed=4)
        rng = np.random.default_rng(4)
        batches = [_lm_batch(rng, jc.vocab_size) for _ in range(5)]
        jopt = jtrain.make_optimizer(1e-3)
        jstate = jtrain.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
        jstep = jtrain.make_lm_train_step(jc, jopt)
        topt = ttrain.make_optimizer(1e-3)
        tstate = ttrain.TrainState.create(_carry(jp, "qwen"), topt)
        tstep = ttrain.make_lm_train_step(tc, topt)
        for b in batches:
            jstate, lj = jstep(jstate, _to_jax(b))
            tstate, lt = tstep(tstate, _to_torch(b))
            _close_loss(float(lt), float(lj), dtype)
        assert tstate.step == 5 and int(jstate.step) == 5

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_infonce_steps_match_jax(self, dtype):
        jc, tc, jp = _bge(dtype, seed=5)
        rng = np.random.default_rng(5)
        batches = [_pair_batch(rng, jc.vocab_size) for _ in range(5)]
        jopt = jtrain.make_optimizer(1e-3)
        jstate = jtrain.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
        jstep = jtrain.make_train_step(jc, jopt)
        topt = ttrain.make_optimizer(1e-3)
        tstate = ttrain.TrainState.create(_carry(jp, "bge"), topt)
        tstep = ttrain.make_train_step(tc, topt)
        for b in batches:
            jstate, lj = jstep(jstate, _to_jax(b))
            tstate, lt = tstep(tstate, _to_torch(b))
            _close_loss(float(lt), float(lj), dtype)

    def test_phase_hook_sees_each_phase(self):
        cfg = tqwen.QWEN_SMALL
        opt = ttrain.make_optimizer()
        state = ttrain.init_lm_train_state(cfg, opt, seed=0, device="cpu")
        seen = []
        ids = torch.randint(0, cfg.vocab_size, (2, 9), dtype=torch.int32)
        state, loss = ttrain.make_lm_train_step(cfg, opt)(
            state, {"ids": ids, "mask": torch.ones_like(ids)}, seen.append)
        assert seen == ["forward", "backward", "optimizer"]
        assert not loss.requires_grad and state.step == 1
        assert all(p.grad is None for p in ttrain.param_leaves(state.params))

    def test_loss_decreases_single_device(self):
        """Port twin of tests/test_models.py TestTraining's single-device
        case."""
        cfg = tbge.BGE_SMALL
        opt = ttrain.make_optimizer(1e-3)
        state = ttrain.init_train_state(cfg, opt, seed=1, device="cpu")
        step = ttrain.make_train_step(cfg, opt)
        rng = np.random.default_rng(0)
        batch = {
            "ids_a": torch.from_numpy(
                rng.integers(4, 1000, (8, 16)).astype(np.int32)),
            "mask_a": torch.ones((8, 16), dtype=torch.int32),
            "mask_b": torch.ones((8, 16), dtype=torch.int32),
        }
        # positive pairs = same text
        batch["ids_b"] = batch["ids_a"]
        losses = []
        for _ in range(5):
            state, loss = step(state, batch)
            losses.append(float(loss))
        assert losses[-1] < losses[0]

    def test_init_states_follow_the_device_policy(self):
        opt = ttrain.make_optimizer()
        state = ttrain.init_train_state(tbge.BGE_SMALL, opt, device="cpu")
        leaves = ttrain.param_leaves(state.params)
        assert all(p.requires_grad and p.device.type == "cpu"
                   for p in leaves)
        assert len(state.opt_state.param_groups[0]["params"]) == len(leaves)
        if not torch.cuda.is_available():
            from nornicdb_tpu_torch import DeviceUnavailable

            with pytest.raises(DeviceUnavailable):
                ttrain.init_lm_train_state(tqwen.QWEN_SMALL, opt)


def _close_loss(got: float, want: float, dtype: str) -> None:
    if dtype == "float32":
        assert abs(got - want) <= 1e-4, (got, want)
    else:
        assert abs(got - want) <= 2e-2 * abs(want), (got, want)
