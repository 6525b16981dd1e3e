"""Parameter sharding of a multi-GPU run (counterpart of
``spatialthinker_tpu/parallel/sharding.py``): FSDP2 (``fully_shard``) over the
mesh's ``(data, fsdp x model)`` dims -- each text decoder layer, each vision
block (and a critic's fp32 value head), then the root (embeddings, final
norm, head, patch embed, merger) -- replicated over ``data`` (HSDP) and
sharded over the rest.

Under tensor parallelism (a model built TP-local, ``model.tp`` set: the JAX
module's Megatron rule table, ``parallel/tensor.py``) FSDP2 wraps the same
units over ``(data, fsdp)`` only (``mesh.fsdp_mesh``), and not at all when
that is one rank. Under sequence parallelism the ``model`` axis carries
sequence shards and parameters are sharded over it as over ``fsdp`` (JAX
keeps the MLP tensor-parallel there, ``_degrade_spec``; the math is the
same). ``_degrade_spec``'s other use (replicate a dim whose size does not
divide the mesh) is not needed: FSDP2 shards dim 0 in ``torch.chunk``
pieces, padding the last, so every size divides.

``full_state`` and ``unsharded_copy`` gather over ``model`` too, so
checkpoints, export and every reader of whole weights see the HF layout;
``tp_rollout_copy`` is the rollout's copy under TP: this rank's shards with
``embed_tokens`` / ``lm_head`` whole, never a whole copy of the weights.

Gradients are SUMMED over the ranks (``set_gradient_divide_factor(1)`` with
sum reductions): the update normalises each rank's loss by the global token
count itself (``trainer/train_step.py``), so the sum is the global mean.

The model functions take the module as an argument; they run inside the
root's forward (``Qwen25VL.forward(fn, ...)``), which is what gathers the
root's parameters around them.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import FSDPModule, fully_shard
from torch.distributed.tensor import DTensor, distribute_tensor

from .mesh import fsdp_mesh as tp_fsdp_mesh
from .mesh import shard_mesh
from .tensor import gather_leaf, shard_for_rank, tp_size


def shard_model(model: nn.Module, mesh: DeviceMesh, *, reshard_after_forward: bool = True) -> nn.Module:
    """``fully_shard`` the text layers, the vision blocks and the root of a
    ``Qwen25VL`` (or a critic) over ``mesh``, in place; returns the model. A
    TP-local model is wrapped over ``(data, fsdp)`` only, and left as it is
    when that is one rank."""
    for p in model.parameters():  # FSDP shards contiguous parameters only
        if not p.is_contiguous():
            p.data = p.data.contiguous()
    if tp_size(model.tp) > 1:
        fsdp_mesh = tp_fsdp_mesh(mesh)
        if fsdp_mesh.size() == 1:
            return model
    else:
        fsdp_mesh = shard_mesh(mesh)
        if fsdp_mesh.shape[0] == 1:
            fsdp_mesh = fsdp_mesh["shard"]  # one replica: plain FSDP
    # a critic's fp32 value head is a unit of its own: one unit holds one dtype
    units = list(model.text.layers) + list(model.vision.blocks) + (
        [model.value_head] if hasattr(model, "value_head") else [])
    for block in units:
        fully_shard(block, mesh=fsdp_mesh, reshard_after_forward=reshard_after_forward)
    fully_shard(model, mesh=fsdp_mesh, reshard_after_forward=reshard_after_forward)
    for module in model.modules():
        if isinstance(module, FSDPModule):
            module.set_gradient_divide_factor(1.0)
            module.set_force_sum_reduction_for_comms(True)
    return model


def is_sharded(model: nn.Module) -> bool:
    return isinstance(model, FSDPModule)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a ``DTensor`` (the same storage); any other
    tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def full_tensor(shard: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which ``shard`` is this rank's piece, laid out as
    the parameter ``like`` (a collective over ``like``'s mesh); ``shard``
    itself when ``like`` is not sharded."""
    if not isinstance(like, DTensor):
        return shard
    return DTensor.from_local(shard, like.device_mesh, like.placements, shape=like.shape,
                              stride=like.stride()).full_tensor()


def local_piece(full: torch.Tensor, like: torch.Tensor, name: str = "", tp=None) -> torch.Tensor:
    """This rank's piece of ``full`` as the parameter ``like`` (named
    ``name``) shards it: its TP shard under ``tp``, then its FSDP piece (no
    communication: every rank holds ``full``)."""
    if tp_size(tp) > 1:
        full = shard_for_rank({name: full}, tp.size, tp.rank)[name]
    if not isinstance(like, DTensor):
        return full
    return distribute_tensor(full.to(like.device), like.device_mesh, like.placements,
                             src_data_rank=None).to_local()


def reshard(model: nn.Module) -> None:
    """Free every gathered parameter of a sharded model."""
    for module in model.modules():
        if isinstance(module, FSDPModule):
            module.reshard()


@torch.no_grad()
def full_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter whole (over ``model`` too under TP: the HF layout), on
    every rank, on the model's device (one gather per parameter)."""
    reshard(model)
    return {name: gather_leaf(name, full_tensor(local(t), t).detach(), model.tp)
            for name, t in model.state_dict().items()}


def unsharded_copy(model: nn.Module) -> nn.Module:
    """A plain ``Qwen25VL`` with the whole parameters of a sharded one, for
    code that reads whole weights outside the FSDP hooks: the rollout
    engines off TP, ``quantize_model``. The caller drops it afterwards."""
    from ..models.qwen2_5_vl.model import Qwen25VL

    copy = Qwen25VL(model.cfg, device="meta", dtype=model.text.norm.weight.dtype)
    copy.load_state_dict(full_state(model), assign=True)
    return copy.requires_grad_(False)


@torch.no_grad()
def tp_rollout_copy(model: nn.Module) -> nn.Module:
    """The rollout's copy of a TP-local policy: a plain TP-local
    ``Qwen25VL`` (this rank's shards, gathered over ``(data, fsdp)`` one
    parameter at a time, or shared as they are when unwrapped) whose
    ``embed_tokens`` / ``lm_head`` are whole (gathered over ``model``), so
    logits and sampling are local. No whole copy of the other weights ever
    exists."""
    from ..models.qwen2_5_vl.model import Qwen25VL

    reshard(model)
    copy = Qwen25VL(model.cfg, device="meta", dtype=model.text.norm.weight.dtype, tp=model.tp,
                    whole_vocab=True)
    state = {}
    for name, t in model.named_parameters():
        w = full_tensor(local(t), t).detach()
        if name in ("text.embed_tokens.weight", "text.lm_head.weight"):
            w = gather_leaf(name, w, model.tp)
        state[name] = w
    copy.load_state_dict(state, assign=True)
    return copy.requires_grad_(False)


def rollout_bytes(model: nn.Module) -> int:
    """Bytes of a rollout copy's own tensors (parameters and buffers)."""
    seen, n = set(), 0
    for t in list(model.parameters()) + list(model.buffers()):
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            n += t.numel() * t.element_size()
    return n
