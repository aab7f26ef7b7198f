"""Neural-net layers of the port as plain functions over parameter dicts.

Counterpart of ``nornicdb_tpu/models/layers.py``: the same parameter layout
(dense weights ``(in, out)``, biases and norm scales as separate leaves) and
the same rounding points, so the tests compare like with like.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ W + b with W (in, out): products summed in float32, the bias added
    in float32, one rounding to ``x.dtype`` (the reference's
    ``preferred_element_type=float32`` einsum). Without a bias one matmul in
    ``x.dtype`` is the same computation: float32 accumulation, one rounding
    (torch's CPU and CUDA bf16 GEMMs accumulate in float32)."""
    w = params["w"]
    if "b" not in params:
        return torch.matmul(x, w)
    y = torch.matmul(x.float(), w.float()) + params["b"].float()
    return y.to(x.dtype)


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-5
               ) -> torch.Tensor:
    """Mean/variance normalization over the last axis in float32, the
    float32 ``scale`` and ``bias`` applied in float32, one rounding to
    ``x.dtype``."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * params["scale"]).to(x.dtype)


def rope_freqs(dim: int, max_pos: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """(max_pos, dim/2) float32 rotation angles, computed with numpy exactly
    as the reference computes them."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    pos = np.arange(max_pos, dtype=np.float32)
    return torch.from_numpy(np.outer(pos, inv)).to(device)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> torch.Tensor:
    xf = x.float()
    d2 = x.shape[-1] // 2
    x1, x2 = xf[..., :d2], xf[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, T, H, Dh); angles: (T, Dh/2) — rotate half-pairs."""
    return _rotate(x, torch.cos(angles)[None, :, None, :],
                   torch.sin(angles)[None, :, None, :])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, H, Dh) attention; mask broadcastable to (B, H, Tq, Tk),
    additive. float32 scores scaled after the product, float32 softmax, the
    probabilities rounded to ``v.dtype`` before the PV product, which sums in
    float32; output in ``q.dtype``."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * scale
    if mask is not None:
        s = s + mask
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: expand (B, T, Hkv, Dh) -> (B, T, Hkv*n_rep, Dh)."""
    if n_rep == 1:
        return x
    b, t, h, d = x.shape
    return x[:, :, :, None, :].expand(b, t, h, n_rep, d).reshape(
        b, t, h * n_rep, d)
