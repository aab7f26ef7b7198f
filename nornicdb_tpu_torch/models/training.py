"""Training steps of the port: contrastive (InfoNCE) training of the bge-m3
encoder and next-token LM training of the Qwen2 decoder.

Counterpart of ``nornicdb_tpu/models/training.py``. The JAX module jits pure
functions over immutable pytrees; here the parameters stay the port's
parameter dicts (the JAX pytree leaf for leaf), each leaf a tensor with
``requires_grad``, and a step runs the forward, ``backward`` and one
``torch.optim.AdamW`` step, updating the state in place and returning it.
Every product is a plain torch op: the JAX package trains through XLA, with
no Pallas kernel and no custom backward.

The sharded trio of the JAX module (``make_sharded_train_step``,
``shard_batch``, ``shard_train_state``) belongs to the multi-device work
(ROADMAP A7) and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from nornicdb_tpu_torch._device import DeviceLike, map_tree
from nornicdb_tpu_torch.models import bge_m3, qwen2

# leaves derived from others for serving (``qwen2.with_f32_logit_weights``):
# a training forward that read ``tok_emb_f32`` would put the tied logits'
# gradient on the copy, never on ``tok_emb``
_DERIVED = ("tok_emb_f32",)


def _without_derived(params: dict) -> dict:
    return {k: v for k, v in params.items() if k not in _DERIVED}


def param_leaves(params) -> list[torch.Tensor]:
    """The parameter tensors in the tree's order (derived leaves left
    out)."""
    leaves: list[torch.Tensor] = []
    map_tree(leaves.append, _without_derived(params))
    return leaves


@dataclass(frozen=True)
class AdamW:
    """``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8, its defaults) as a
    factory of ``torch.optim.AdamW``: torch binds an optimizer to its
    parameters when it is made, where optax binds them in ``init``, so
    :meth:`init` makes it. Decoupled decay on every leaf (optax applies it
    with no mask). The moments take each parameter's dtype, as optax's do:
    a bf16 model keeps bf16 moments. The fused implementation keeps its
    step count on the parameters' device and does each update's arithmetic
    in float32 with one rounding to the parameter's dtype."""

    lr: float = 1e-4
    weight_decay: float = 0.01

    def init(self, params) -> torch.optim.AdamW:
        return torch.optim.AdamW(
            param_leaves(params), lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=self.weight_decay, fused=True)


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay)


@dataclass
class TrainState:
    """Parameters (leaves with ``requires_grad``), the optimizer bound to
    them (``opt_state``) and the count of steps taken."""

    params: dict
    opt_state: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, params: dict, optimizer: AdamW) -> "TrainState":
        """A state over ``params`` as they are (no copy): derived serving
        leaves are dropped and every leaf is made to require gradients."""
        params = _without_derived(params)
        map_tree(lambda t: t.requires_grad_(True), params)
        return cls(params, optimizer.init(params), 0)


def info_nce_loss(emb_a: torch.Tensor, emb_b: torch.Tensor,
                  temperature: float = 0.05) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch negatives. emb_*: (B, D) normalized."""
    logits = (emb_a @ emb_b.T / temperature).float()  # (B, B)
    labels = torch.arange(logits.shape[0], device=logits.device)
    l_ab = F.cross_entropy(logits, labels, reduction="none")
    l_ba = F.cross_entropy(logits.T, labels, reduction="none")
    return torch.mean(l_ab + l_ba) * 0.5


def embedder_loss(params, cfg: bge_m3.BgeConfig, batch: dict) -> torch.Tensor:
    emb_a = bge_m3.forward(params, cfg, batch["ids_a"], batch["mask_a"])
    emb_b = bge_m3.forward(params, cfg, batch["ids_b"], batch["mask_b"])
    return info_nce_loss(emb_a, emb_b)


def lm_loss(params, cfg: qwen2.QwenConfig, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy for the Qwen2 decoder. batch["ids"]: (B, T)
    integer ids; batch["mask"]: (B, T) 1 where a PREDICTION target is real
    (the loss at position t predicts token t+1). The tied logits cast
    ``tok_emb`` inside the graph, so its gradient holds both the lookup's
    and the logits' terms, as ``jax.grad`` gives it."""
    logits = qwen2.forward(_without_derived(params), cfg, batch["ids"][:, :-1])
    targets = batch["ids"][:, 1:].long()
    mask = batch["mask"][:, 1:].float()
    ce = F.cross_entropy(logits.flatten(0, 1), targets.flatten(),
                         reduction="none").view_as(mask)
    return torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)


# a step's phase boundaries, for a caller that times them: called with
# "forward", "backward" and "optimizer" as each one has been queued
PhaseHook = Optional[Callable[[str], None]]


def make_step(loss_fn: Callable[[dict, object], torch.Tensor]):
    """``step(state, batch, on_phase=None) -> (state, loss)`` over any loss
    of (params, batch): the forward, ``backward``, the optimizer's step,
    gradients cleared."""

    def step(state: TrainState, batch: dict, on_phase: PhaseHook = None):
        loss = loss_fn(state.params, batch)
        if on_phase:
            on_phase("forward")
        loss.backward()
        if on_phase:
            on_phase("backward")
        state.opt_state.step()
        state.opt_state.zero_grad(set_to_none=True)
        if on_phase:
            on_phase("optimizer")
        state.step += 1
        return state, loss.detach()

    return step


def make_train_step(cfg: bge_m3.BgeConfig, optimizer: AdamW):
    """The InfoNCE train step ``step(state, batch) -> (state, loss)``. The
    update is the state's optimizer (``optimizer.init`` made it), so
    ``optimizer`` is taken for the JAX signature only."""
    return make_step(lambda params, batch: embedder_loss(params, cfg, batch))


def make_lm_train_step(cfg: qwen2.QwenConfig, optimizer: AdamW):
    """The LM train step for the assistant decoder (see make_train_step)."""
    return make_step(lambda params, batch: lm_loss(params, cfg, batch))


def init_lm_train_state(cfg: qwen2.QwenConfig, optimizer: AdamW,
                        seed: int = 0, device: DeviceLike = None
                        ) -> TrainState:
    """Qwen2 parameters from ``seed`` on ``device`` (``None`` means CUDA)."""
    return TrainState.create(qwen2.init_params(cfg, seed, device), optimizer)


def init_train_state(cfg: bge_m3.BgeConfig, optimizer: AdamW, seed: int = 0,
                     device: DeviceLike = None) -> TrainState:
    """bge-m3 parameters from ``seed`` on ``device`` (``None`` means CUDA)."""
    return TrainState.create(bge_m3.init_params(cfg, seed, device), optimizer)
