"""The port's fused cosine kernel wrapper (its plain version on the CPU)
against the JAX package's Pallas ``fused_cosine_scores`` run in interpret
mode, on the same inputs.

Inputs are made with numpy from fixed seeds and handed to both sides; a
16-bit corpus is rounded to its type once, in numpy's float32 values, by
each framework (both round to nearest even). Tolerance: scores within 1e-5
absolute (both normalize in float32 with the same clamp and multiply in
float32; the sums run in other orders). Top-k ids are identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nornicdb_tpu.ops import pallas_kernels as P
from nornicdb_tpu_torch.ops import fused_cosine_scores, fused_cosine_topk
from nornicdb_tpu_torch.ops import kernels as K
from nornicdb_tpu_torch.ops import kernels_ref as R
from nornicdb_tpu_torch.ops.similarity import cosine_topk, l2_normalize

TOL = 1e-5
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
              torch.float16: jnp.float16}


def _case(q, n, d, seed, zero_rows=(7,)):
    rng = np.random.default_rng(seed)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    # raw corpus rows of mixed norms: the kernel normalizes them
    c = (rng.standard_normal((n, d)) * rng.uniform(0.1, 5.0, (n, 1))).astype(
        np.float32)
    c[list(zero_rows)] = 0.0  # the 1e-24 clamp: a zero row scores 0
    valid = rng.random(n) > 0.2
    return qs, c, valid


def _both(qs, c, dtype, tile_n):
    want = np.asarray(P.fused_cosine_scores(
        jnp.asarray(qs), jnp.asarray(c, JAX_DTYPES[dtype]), tile_n=tile_n,
        interpret=True))
    got = fused_cosine_scores(torch.from_numpy(qs),
                              torch.from_numpy(c).to(dtype), tile_n=tile_n)
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scores_match_jax(dtype):
    qs, c, _ = _case(8, 512, 128, seed=1)
    got, want = _both(qs, c, dtype, 128)
    assert got.dtype == torch.float32 and got.shape == (8, 512)
    assert np.max(np.abs(got.numpy() - want)) <= TOL
    assert (got[:, 7] == 0).all() and (want[:, 7] == 0).all()


@pytest.mark.parametrize("q,n,d,tile_n,dtype", [
    (1, 384, 7, 128, torch.float16),    # one query, a narrow odd width
    (33, 256, 100, 512, torch.float32),  # tile_n > N: the tile is N
    (16, 640, 64, 128, torch.bfloat16),
])
def test_any_q_and_d_match_jax(q, n, d, tile_n, dtype):
    qs, c, _ = _case(q, n, d, seed=q + n + d)
    got, want = _both(qs, c, dtype, tile_n)
    assert np.max(np.abs(got.numpy() - want)) <= TOL


def test_plain_version_is_the_wrapper_on_the_cpu():
    qs, c, _ = _case(8, 512, 128, seed=2)
    q_t, c_t = torch.from_numpy(qs), torch.from_numpy(c)
    before = K.launch_counts()["fused_cosine_scores"]
    assert torch.equal(fused_cosine_scores(q_t, c_t),
                       R.fused_cosine_scores(q_t, c_t))
    # the count is of kernel launches: the CPU path launches none
    assert K.launch_counts()["fused_cosine_scores"] == before


@pytest.mark.parametrize("k", [1, 5, 50])
def test_topk_ids_match_jax_and_the_f32_scan(k):
    """As ``tests/test_ops.py::TestPallasKernels`` holds the Pallas top-k to
    the XLA f32 ``cosine_topk``: the same ids from all three."""
    qs, c, valid = _case(8, 512, 128, seed=3 + k)
    vj, ij = P.fused_cosine_topk(jnp.asarray(qs), jnp.asarray(c),
                                 jnp.asarray(valid), k, tile_n=128)
    q_t, c_t, v_t = (torch.from_numpy(qs), torch.from_numpy(c),
                     torch.from_numpy(valid))
    vt, it = fused_cosine_topk(q_t, c_t, v_t, k, tile_n=128)
    vx, ix = cosine_topk(q_t, l2_normalize(c_t), v_t, k, use_bf16=False)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(it.numpy(), ix.numpy())
    assert np.max(np.abs(vt.numpy() - np.asarray(vj))) <= TOL
    assert np.max(np.abs(vt.numpy() - vx.numpy())) <= TOL
    assert valid[it.numpy()].all(), "masked rows leaked"


def test_n_no_multiple_of_tile_raises_as_jax():
    qs, c, _ = _case(4, 500, 32, seed=4)
    with pytest.raises(ValueError):
        P.fused_cosine_scores(jnp.asarray(qs), jnp.asarray(c), tile_n=128,
                              interpret=True)
    with pytest.raises(ValueError, match="multiple of tile_n"):
        fused_cosine_scores(torch.from_numpy(qs), torch.from_numpy(c),
                            tile_n=128)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    qs, c, _ = _case(4, 256, 32, seed=5)
    q_t, c_t = torch.from_numpy(qs), torch.from_numpy(c)
    with pytest.raises(TypeError):
        fused_cosine_scores(q_t.double(), c_t)  # queries are float32
    with pytest.raises(TypeError):
        fused_cosine_scores(q_t, c_t.double())
    with pytest.raises(ValueError):
        fused_cosine_scores(q_t, c_t[:, :16].contiguous())  # D differs
    with pytest.raises(ValueError):
        fused_cosine_scores(q_t, c_t.t())  # not contiguous
