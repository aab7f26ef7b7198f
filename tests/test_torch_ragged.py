"""The port's ragged paged attention (the wrapper of
``ops/csrc/ragged_paged_attention.cu``, which runs its plain version for
CPU tensors) against the JAX package's Pallas kernel in interpret mode.

Lanes as in the JAX kernel test: a decode lane (Tq slots, one valid row), a
prefill chunk, an all-padding lane, plus a lane sharing a page with the
first. Valid rows are compared; padding rows are zeros in the port (the TPU
kernel leaves a finite average over masked slots there, which no caller
reads). Tolerances: float32 within 1e-6 (the same f32 arithmetic, summed
in other orders); bfloat16 within 2**-7 relative and absolute (probabilities
rounded to bf16 before P.V: a one-ulp f32 difference can move one by a
bf16 ulp, and the output is rounded to bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nornicdb_tpu.ops import pallas_kernels as pk
from nornicdb_tpu_torch.ops import kernels as K

TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}


def _lanes(dt, h=4, hkv=2, dh=16, lmax=5, tq=8, p=6, ps=4, seed=3):
    rng = np.random.default_rng(seed)
    k_pages = rng.standard_normal((p + 2, ps, hkv, dh)).astype(np.float32)
    v_pages = rng.standard_normal((p + 2, ps, hkv, dh)).astype(np.float32)
    q = rng.standard_normal((lmax, tq, h, dh)).astype(np.float32)
    tables = np.zeros((lmax, p), np.int32)
    positions = np.full((lmax, tq), -1, np.int32)
    tables[0, :3] = [1, 2, 3]          # decode at slot 9 (3 pages resident)
    positions[0, 0] = 9
    tables[1, :3] = [4, 5, 2]          # chunk rows at slots 4..11
    positions[1] = np.arange(4, 4 + tq)
    # lane 2: all padding (null table, all -1)
    tables[3, :2] = [1, 6]             # shares page 1 with lane 0; half chunk
    positions[3, :min(3, tq)] = [5, 6, 7][:tq]
    tables[4, :6] = [7, 6, 5, 4, 3, 2]  # every slot visible to the last row
    positions[4, tq - 1] = p * ps - 1
    return [np.asarray(x) for x in (q, k_pages, v_pages)], tables, positions


def _jax_out(dt, arrays, tables, positions):
    q, kp, vp = (jnp.asarray(a, dt) for a in arrays)
    return np.asarray(pk.ragged_paged_attention(
        q, kp, vp, jnp.asarray(tables), jnp.asarray(positions),
        interpret=True), np.float32)


def _port_out(dt, arrays, tables, positions):
    q, kp, vp = (torch.from_numpy(a).to(getattr(torch, dt)) for a in arrays)
    return K.ragged_paged_attention(q, kp, vp, torch.from_numpy(tables),
                                    torch.from_numpy(positions))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [dict(), dict(h=14, hkv=2, dh=64, tq=1),
                                   dict(h=4, hkv=4, dh=8, tq=3)])
def test_plain_matches_pallas_interpret(dt, shape):
    arrays, tables, positions = _lanes(dt, **shape)
    want = _jax_out(dt, arrays, tables, positions)
    got = _port_out(dt, arrays, tables, positions)
    assert got.dtype == getattr(torch, dt) and got.shape == want.shape
    valid = positions >= 0
    np.testing.assert_allclose(got.float().numpy()[valid], want[valid],
                               rtol=TOL[dt], atol=TOL[dt])
    assert bool((got[torch.from_numpy(~valid)] == 0).all())


def test_cpu_calls_are_not_kernel_launches():
    arrays, tables, positions = _lanes("float32")
    before = K.launch_counts()["ragged_paged_attention"]
    _port_out("float32", arrays, tables, positions)
    assert K.launch_counts()["ragged_paged_attention"] == before


def test_wrapper_checks_its_inputs():
    arrays, tables, positions = _lanes("float32")
    q, kp, vp = (torch.from_numpy(a) for a in arrays)
    t, pos = torch.from_numpy(tables), torch.from_numpy(positions)
    with pytest.raises(TypeError):  # float16 is no type of the kernel
        K.ragged_paged_attention(q.half(), kp.half(), vp.half(), t, pos)
    with pytest.raises(TypeError):  # pools of another type than q
        K.ragged_paged_attention(q, kp.bfloat16(), vp.bfloat16(), t, pos)
    with pytest.raises(TypeError):
        K.ragged_paged_attention(q, kp, vp, t.long(), pos)
    with pytest.raises(ValueError):  # rank
        K.ragged_paged_attention(q[0], kp, vp, t, pos)
    with pytest.raises(ValueError):  # contiguity
        K.ragged_paged_attention(q.transpose(1, 2), kp, vp, t, pos)
    with pytest.raises(ValueError):  # positions of another shape
        K.ragged_paged_attention(q, kp, vp, t, pos[:, :2].contiguous())
    with pytest.raises(ValueError):  # H no multiple of Hkv
        K.ragged_paged_attention(q[:, :, :3].contiguous(), kp, vp, t, pos)
