"""Critic: the value model (a Qwen2.5-VL backbone + a scalar token head) and
its clipped-loss update -- the GAE path (counterpart of
``spatialthinker_tpu/trainer/critic.py``).

Values are read at hidden positions P-1 .. P+R-2, the prediction slots of the
response tokens (the log-prob slice of ``train_step``). The head is fp32
whatever the backbone's dtype: weight (E, 1) drawn normal * 0.02, bias 0.

The update is the actor's accumulation loop (``train_step._make_grad_fn``)
with the clipped value loss in place of the policy loss: one backward per
micro-batch, the mean over micro-batches, the global norm as
``critic/grad_norm``, the clip to ``max_grad_norm`` and the NaN skip folded
into one scale, then ``apply_optimizer_step``. On several GPUs the critic is
sharded as the actor is (TP-local under tensor parallelism, its fp32 value
head replicated) and takes the same ``groups`` and ``sp`` (``train_step``'s
module docstring); the JAX critic runs one program over the mesh and takes
no ``sp``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from ..algos.losses import compute_value_loss
from ..models.qwen2_5_vl.host import VisionInputs
from ..models.qwen2_5_vl.model import Qwen25VL
from ..ops.ulysses import all_gather_seq, seq_chunk
from .optim import AdamW
from .train_step import (
    TrainBatch, _aligned, _hidden_chunk, _make_grad_fn, _response_hidden, apply_optimizer_step,
    token_share,
)


class ValueHead(nn.Module):
    """hidden (.., E) -> one value per position, in fp32."""

    def __init__(self, hidden_size: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(hidden_size, 1, device=device, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(1, device=device, dtype=torch.float32))

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return (hidden.float() @ self.weight + self.bias)[..., 0]


class Critic(Qwen25VL):
    """A ``Qwen25VL`` backbone (its ``text`` and ``vision`` modules, taken
    over as they are, not copied) plus ``value_head``. Parameter names are the
    backbone's and ``value_head.weight`` / ``value_head.bias``, so the
    backbone's weight carriers and checkpoints apply unchanged."""

    def __init__(self, backbone: Qwen25VL, generator: torch.Generator):
        nn.Module.__init__(self)
        self.cfg = backbone.cfg
        self.tp = backbone.tp  # a TP-local backbone: the head stays replicated
        self.text = backbone.text
        self.vision = backbone.vision
        device = backbone.text.norm.weight.device
        self.value_head = ValueHead(self.cfg.text.hidden_size, device=device)
        with torch.no_grad():
            self.value_head.weight.normal_(0.0, 0.02, generator=generator)


def _values_chunk(critic: Critic, batch: TrainBatch, vision, remat, sp) -> torch.Tensor:
    """Values of this sp rank's chunk of the positions (B, S / sp)."""
    return critic.value_head(_hidden_chunk(critic, batch, vision, remat, sp))


def compute_values(critic: Critic, batch: TrainBatch, vision: Optional[VisionInputs] = None,
                   *, remat: Union[bool, str] = False, sp=None) -> torch.Tensor:
    """(B, R) fp32 value predictions, 0 past each response. Under ``sp``
    gathered from the sp group's chunks (no gradient through the gather)."""
    if sp is not None:
        s, r = batch.input_ids.shape[1], batch.responses.shape[1]
        values = all_gather_seq(_values_chunk(critic, batch, vision, remat, sp), sp.group)
        return values[:, s - r - 1 : s - 1] * batch.response_mask.float()
    hidden = _response_hidden(critic, batch, vision, remat)
    return critic.value_head(hidden) * batch.response_mask.float()


class CriticBatch(NamedTuple):
    train: TrainBatch
    values: torch.Tensor   # (B, R) old values
    returns: torch.Tensor  # (B, R)


def critic_loss_fn(critic: Critic, cb: CriticBatch, vision: Optional[VisionInputs], *,
                   cliprange_value: float = 0.5, remat: Union[bool, str] = True, sp=None,
                   n_tokens=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    mask = cb.train.response_mask.float()
    if sp is None:
        vpreds, returns, values = compute_values(critic, cb.train, vision, remat=remat), cb.returns, cb.values
    else:  # position-aligned chunks, as the actor's loss
        s = cb.train.input_ids.shape[1]
        vpreds = _values_chunk(critic, cb.train, vision, remat, sp)
        mask, returns, values = (seq_chunk(_aligned(x, s), sp) for x in (mask, cb.returns, cb.values))
        vpreds = vpreds * mask
    vf_loss, vf_clipfrac = compute_value_loss(vpreds, returns, values, mask, cliprange_value)
    out = token_share({"critic/vf_loss": vf_loss, "critic/vf_clipfrac": vf_clipfrac}, mask, n_tokens)
    return out["critic/vf_loss"], out


def make_critic_update_fn(critic: Critic, optimizer: AdamW, *, cliprange_value: float = 0.5,
                          max_grad_norm: float = 1.0, remat: Union[bool, str] = True,
                          grad_accum_dtype=torch.float32, groups=None, sp=None):
    """Returns ``update(micro_batches: CriticBatch, vision=None) -> metrics``
    (a leading micro dim on every tensor, as ``make_update_fn`` takes them);
    the critic and the optimizer state change in place. The gradient
    accumulator lives for one call only."""
    grad_step = _make_grad_fn(
        critic, critic_loss_fn, max_grad_norm=max_grad_norm, grad_accum_dtype=grad_accum_dtype,
        loss_key=None, norm_key="critic/grad_norm", cliprange_value=cliprange_value, remat=remat,
        groups=groups, sp=sp,
    )

    def update(micro_batches: CriticBatch, vision: Optional[VisionInputs] = None):
        grads, metrics, finite, factor = grad_step(micro_batches, vision)
        apply_optimizer_step(optimizer, grads, critic, finite=finite, grad_scale=factor)
        return metrics

    return update
