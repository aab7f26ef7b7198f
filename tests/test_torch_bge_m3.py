"""The port's bge-m3 encoder (``nornicdb_tpu_torch.models.bge_m3``) against the
JAX package's, on the CPU.

The same inputs, made with numpy from fixed seeds, go through both; the JAX
parameters are carried over with ``convert.bge_params_from_jax``. Configs:
``BGE_SMALL`` (bf16), the float32 config of ``tests/test_serving.py``, and
a ``dims != hidden`` variant of each, which runs the ``proj`` head.

Tolerances:
- float32: within 1e-5 (relative and absolute). Not bit-exact: XLA and
  torch order their float32 sums differently on the CPU (the largest
  difference seen is 2.1e-7).
- bfloat16: XLA rounds to bf16 after each elementwise op of the tanh GELU
  where torch rounds once, so a hidden value can land a bf16 ulp away.
  Embeddings within 2**-5 absolute per component and cosine >= 0.999 to
  the JAX one (the largest difference seen is 0.0035, the lowest cosine
  0.99997); layer norm outputs within 2**-5 absolute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nornicdb_tpu.models import bge_m3 as JB
from nornicdb_tpu.models import layers as JL
from nornicdb_tpu.serving.ragged import RaggedPacker
from nornicdb_tpu_torch.convert import bge_params_from_jax
from nornicdb_tpu_torch.models import bge_m3 as TB
from nornicdb_tpu_torch.models import layers as TL

F32_TOL = 1e-5
BF16_ABS = 2.0 ** -5
BF16_COS = 0.999

# (name, JAX config); the port's config is the same dataclass fields
CONFIGS = {
    "small_bf16": JB.BGE_SMALL,
    "small_bf16_proj": dataclasses.replace(JB.BGE_SMALL, dims=64),
    "f32": JB.BgeConfig(vocab_size=512, hidden=64, layers=2, heads=4,
                        intermediate=128, max_positions=512, dims=64,
                        dtype="float32"),
    "f32_proj": JB.BgeConfig(vocab_size=512, hidden=64, layers=2, heads=4,
                             intermediate=128, max_positions=512, dims=48,
                             dtype="float32"),
}


def _port_cfg(jcfg) -> TB.BgeConfig:
    return TB.BgeConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    """(JAX cfg, JAX params, port cfg, port params)."""
    jcfg = CONFIGS[request.param]
    jp = JB.init_params(jcfg, jax.random.PRNGKey(0))
    tp = bge_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, _port_cfg(jcfg), tp


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_embeddings(dtype: str, want, got) -> None:
    want, got = _np(want), _np(got)
    assert want.shape == got.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ABS)
    cos = (got * want).sum(-1)
    assert cos.min() >= BF16_COS, cos.min()


def _batch(seed: int, vocab: int, b: int = 6, t: int = 40):
    """(B, T) int32 ids + mask: random lengths 1..T, pads after."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, t + 1, b)
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.int32)
    ids = rng.integers(4, vocab, (b, t)).astype(np.int32)
    ids = np.where(mask > 0, ids, 1).astype(np.int32)
    return ids, mask


def _pack(seed: int, vocab: int, max_len: int = 128):
    """A packed grid of the JAX package's packer over random sequences."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 60, 11)
    seqs = [[0] + rng.integers(4, vocab, n - 1).tolist() for n in lens]
    return RaggedPacker(pad_id=1, pad_token_id=1, max_len=max_len).pack(seqs)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


class TestLayerNorm:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_jax(self, dtype):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((5, 7, 96)).astype(np.float32) * 3 + 1
        scale = rng.standard_normal(96).astype(np.float32)
        bias = rng.standard_normal(96).astype(np.float32)
        jx = jnp.asarray(x, dtype)
        want = JL.layer_norm({"scale": jnp.asarray(scale),
                              "bias": jnp.asarray(bias)}, jx)
        tx = _t(np.array(jx.astype(jnp.float32))).to(
            getattr(torch, dtype))
        got = TL.layer_norm({"scale": _t(scale), "bias": _t(bias)}, tx)
        assert got.dtype == tx.dtype
        tol = F32_TOL if dtype == "float32" else BF16_ABS
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


class TestForward:
    def test_params_carried_bit_exact(self, model):
        jcfg, jp, _, tp = model
        want = np.asarray(jp["blocks"][1]["up"]["w"].astype(jnp.float32))
        np.testing.assert_array_equal(_np(tp["blocks"][1]["up"]["w"]), want)
        assert tp["emb_ln"]["scale"].dtype == torch.float32
        assert tp["tok_emb"].dtype == getattr(torch, jcfg.dtype)
        assert ("proj" in tp) == (jcfg.dims != jcfg.hidden)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_forward_matches_jax(self, model, seed):
        jcfg, jp, tcfg, tp = model
        ids, mask = _batch(seed, jcfg.vocab_size)
        want = JB.forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask))
        got = TB.forward(tp, tcfg, _t(ids), _t(mask))
        assert got.dtype == torch.float32 and got.shape == (6, jcfg.dims)
        _assert_embeddings(jcfg.dtype, want, got)
        np.testing.assert_allclose(
            np.linalg.norm(_np(got), axis=-1), 1.0, atol=1e-5)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_forward_packed_matches_jax(self, model, seed):
        jcfg, jp, tcfg, tp = model
        p = _pack(seed, jcfg.vocab_size)
        args = (p.ids, p.seg, p.positions, p.cls_rows, p.cls_cols)
        want = JB.forward_packed(jp, jcfg, *map(jnp.asarray, args))
        got = TB.forward_packed(tp, tcfg, *map(_t, args))
        assert got.shape == (len(p.cls_rows), jcfg.dims)
        # the live segments only: padded CLS slots gather pad rows
        n = p.n_segments
        _assert_embeddings(jcfg.dtype, _np(want)[:n], _np(got)[:n])

    def test_fully_masked_rows_stay_finite(self, model):
        """A pad query softmaxes to a uniform row (the -1e30 additive
        mask), never NaN, so every gathered embedding stays finite."""
        jcfg, _, tcfg, tp = model
        p = RaggedPacker(pad_id=1, pad_token_id=1, max_len=64).pack(
            [[0, 5, 6], [0, 7]], rows=4)
        got = TB.forward_packed(tp, tcfg, *map(_t, (
            p.ids, p.seg, p.positions, p.cls_rows, p.cls_cols)))
        assert torch.isfinite(got).all()


class TestGelu:
    def test_jax_default_is_the_tanh_form(self):
        x = np.linspace(-6, 6, 1001, dtype=np.float32)
        want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
        tanh = torch.nn.functional.gelu(_t(x), approximate="tanh").numpy()
        erf = torch.nn.functional.gelu(_t(x)).numpy()
        np.testing.assert_allclose(tanh, want, rtol=1e-6, atol=1e-6)
        assert np.abs(erf - want).max() > 1e-4

    def test_exact_gelu_would_miss_the_reference(self, monkeypatch):
        """The port's forward holds the float32 tolerance only with the
        tanh GELU: with torch's default (erf) form it misses JAX's."""
        jcfg = CONFIGS["f32"]
        jp = JB.init_params(jcfg, jax.random.PRNGKey(0))
        tp = bge_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        tcfg = _port_cfg(jcfg)
        ids, mask = _batch(0, jcfg.vocab_size)
        want = _np(JB.forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
        _assert_embeddings("float32", want, TB.forward(tp, tcfg, _t(ids),
                                                       _t(mask)))
        real = torch.nn.functional.gelu
        monkeypatch.setattr(TB.F, "gelu", lambda x, approximate="none": real(x))
        erf = _np(TB.forward(tp, tcfg, _t(ids), _t(mask)))
        assert np.abs(erf - want).max() > 2 * F32_TOL


class TestInitParams:
    @pytest.mark.parametrize("name", ["small_bf16", "f32_proj"])
    def test_same_tree_shapes_and_dtypes_as_jax(self, name):
        jcfg = CONFIGS[name]
        jp = JB.init_params(jcfg, jax.random.PRNGKey(1))
        tp = TB.init_params(_port_cfg(jcfg), 1, "cpu")
        want = jax.tree.map(np.asarray, jp)
        # a torch tensor is a leaf of a JAX pytree: same dict/list layout
        assert jax.tree.structure(tp) == jax.tree.structure(want)
        jl, tl = jax.tree.leaves(want), jax.tree.leaves(tp)
        assert len(jl) == len(tl)
        for a, t in zip(jl, tl):
            assert tuple(a.shape) == tuple(t.shape)
            assert str(t.dtype).split(".")[-1] == a.dtype.name

    def test_reference_distributions(self):
        cfg = _port_cfg(CONFIGS["f32"])
        p = TB.init_params(cfg, 0, "cpu")
        assert abs(float(p["tok_emb"].std()) - 0.02) < 2e-3
        lim = float(np.sqrt(6.0 / (cfg.hidden + cfg.intermediate)))
        up = p["blocks"][0]["up"]["w"]
        assert float(up.abs().max()) <= lim
        assert float(up.abs().max()) > 0.95 * lim
        assert not p["blocks"][0]["up"]["b"].any()
        assert (p["blocks"][0]["attn_ln"]["scale"] == 1).all()
        # same seed, same draw; another seed, another draw
        again = TB.init_params(cfg, 0, "cpu")
        assert torch.equal(again["blocks"][1]["q"]["w"], p["blocks"][1]["q"]["w"])
        other = TB.init_params(cfg, 1, "cpu")
        assert not torch.equal(other["tok_emb"], p["tok_emb"])
