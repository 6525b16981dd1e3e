"""AnyPrecision AdamW with its moments on the host, applied by streaming row
slices through the GPU (counterpart of
``spatialthinker_tpu/trainer/streamed_opt.py``).

The fused ``adamw_bf16`` keeps parameters, gradients and both moments on the
card at once. At 7B (8.29 B parameters) that is 66 GB in bf16 before the
reference copy or any activation. Here the bf16 moments (and the optional
Kahan compensation, in the parameter's dtype) live permanently in
page-locked host memory, one tensor per parameter. ``step`` walks the
trainable parameters: a leaf of at least ``_STREAM_THRESHOLD`` elements goes
in row slices (``layer_chunk`` rows, or enough rows to make
``_STREAM_THRESHOLD`` elements, whichever is more), a smaller leaf whole.
For each slice the moment slices are copied to the card, the parameter slice
is updated in place by ``any_precision_leaf_`` -- the leaf function of the
fused optimizer, in the same row order, so the two agree bit for bit -- and
the new moment slices are copied back. The card then holds parameters,
gradients and one slice's moments.

All copies are queued on the current stream (host-to-device, the update,
device-to-host), so a slice's device buffers are reused only after its
copies back have run; the call synchronizes once at its end, after which the
host moments are current.

``state`` has the fused optimizer's layout (``{"count", "mu", "nu",
"compensation"}``, keyed by parameter name; ``compensation`` empty without
Kahan), so checkpoints are written and read as the fused optimizer's are. A
non-finite step changes nothing, the count included. On several GPUs each
rank pins and streams the moments of its own parameter shards only
(``to_local()``); the JAX class runs on one device only.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple, TypedDict

import torch

from ..parallel.offload import pinned_zeros
from ..parallel.sharding import local
from .optim import _row_chunks, any_precision_leaf_

# leaves at least this big stream in row slices; smaller leaves go whole
_STREAM_THRESHOLD = 1 << 24  # 16M elements = 32 MB in bf16


class StreamedAdamWState(TypedDict):
    """Host-resident optimizer state, by parameter name."""

    count: int
    mu: Dict[str, torch.Tensor]            # bf16, on the host
    nu: Dict[str, torch.Tensor]            # bf16, on the host
    compensation: Dict[str, torch.Tensor]  # the parameter's dtype, on the host; empty without Kahan


def _host_zeros(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if p.is_cuda:
        return pinned_zeros(p.shape, dtype)
    return torch.zeros(p.shape, dtype=dtype)


class StreamedAdamW:
    """AnyPrecision AdamW (bf16 moments, optional Kahan compensation) with
    host-resident state; see the module docstring. ``step`` (the JAX class's
    ``apply``) has the fused ``AdamW.step``'s signature, so the update
    functions take either optimizer."""

    moment_dtype = torch.bfloat16
    strategy = "adamw_bf16"

    def __init__(self, schedule: Callable[[int], float], *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-2, use_kahan_summation: bool = True,
                 layer_chunk: int = 4):
        self.schedule = schedule
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.use_kahan_summation = use_kahan_summation
        self.layer_chunk = layer_chunk
        self.state: StreamedAdamWState = {"count": 0, "mu": {}, "nu": {}, "compensation": {}}
        self.last_apply_stats: Dict[str, int] = {}

    def init(self, named_params: Iterable[Tuple[str, torch.Tensor]]) -> None:
        """Allocate the host moments (and compensation) of every named
        parameter, zeroed. Nothing is allocated on the card."""
        for name, p in named_params:
            p = local(p)  # a sharded parameter: this rank's shard only
            if name in self.state["mu"]:
                continue
            self.state["mu"][name] = _host_zeros(p, self.moment_dtype)
            self.state["nu"][name] = _host_zeros(p, self.moment_dtype)
            if self.use_kahan_summation:
                self.state["compensation"][name] = _host_zeros(p, p.dtype)

    def _spans(self, p: torch.Tensor):
        dim0 = p.shape[0]
        if p.numel() < _STREAM_THRESHOLD:
            return [(0, dim0)]
        # layer_chunk rows, but never slices much below _STREAM_THRESHOLD
        # elements: an embedding table would otherwise go in thousands of copies
        per_row = max(p.numel() // dim0, 1)
        span = min(max(self.layer_chunk, _STREAM_THRESHOLD // per_row, 1), dim0)
        return [(l0, min(span, dim0 - l0)) for l0 in range(0, dim0, span)]

    @torch.no_grad()
    def step(self, named_params: Iterable[Tuple[str, torch.Tensor]],
             grads: Mapping[str, torch.Tensor], *, finite: bool = True,
             grad_scale: Optional[float] = None, sample_slices: int = 0) -> None:
        """Update every named parameter that has a gradient, in place. A
        non-finite step changes nothing, the count and ``last_apply_stats``
        included.

        ``sample_slices`` > 0 is for timing only (the trainer never passes
        it): the first N slices go through the card, the rest are counted in
        ``last_apply_stats`` but skipped, so their rows do not move."""
        if not finite:
            return
        state = self.state
        count_prev = int(state["count"])
        count = count_prev + 1
        hyper = dict(
            lr=float(self.schedule(count_prev)), c1=1.0 - self.b1**count, c2=1.0 - self.b2**count,
            b1=self.b1, b2=self.b2, eps=self.eps, weight_decay=self.weight_decay, scale=grad_scale,
        )
        measured_slices = measured_bytes = total_bytes = 0
        for name, p in named_params:
            g = grads.get(name)
            if g is None:
                continue
            p, g = local(p), local(g)
            mu_h, nu_h = state["mu"][name], state["nu"][name]
            comp_h = state["compensation"].get(name)
            if p.dim() == 0:  # a scalar goes as one row
                p, g, mu_h, nu_h = (t.view(1) for t in (p, g, mu_h, nu_h))
                comp_h = None if comp_h is None else comp_h.view(1)
            for l0, span in self._spans(p):
                rows = slice(l0, l0 + span)
                host = [t[rows] for t in (mu_h, nu_h, comp_h) if t is not None]
                slice_bytes = sum(t.numel() * t.element_size() for t in host)
                total_bytes += slice_bytes
                if sample_slices and measured_slices >= sample_slices:
                    continue  # counted, not streamed
                measured_slices += 1
                measured_bytes += slice_bytes
                dev = [t.to(p.device, non_blocking=True) for t in host]
                mu_d, nu_d = dev[0], dev[1]
                comp_d = dev[2] if comp_h is not None else None
                p_rows, g_rows = p[rows], g[rows]
                for sl in _row_chunks(p_rows):
                    any_precision_leaf_(p_rows[sl], g_rows[sl], mu_d[sl], nu_d[sl],
                                        None if comp_d is None else comp_d[sl], **hyper)
                for h, d in zip(host, dev):
                    h.copy_(d, non_blocking=True)
        if any(p.is_cuda for p in grads.values()):
            torch.cuda.current_stream().synchronize()
        state["count"] = count
        self.last_apply_stats = {"measured_slices": measured_slices,
                                 "measured_bytes": measured_bytes, "total_bytes": total_bytes}


def make_streamed_optimizer(lr: float, *, weight_decay: float = 1e-2,
                            betas: Tuple[float, float] = (0.9, 0.999), warmup_steps: int = 0,
                            use_kahan_summation: bool = True) -> StreamedAdamW:
    """``StreamedAdamW`` with the fused optimizer's schedule (constant after
    a linear warmup)."""
    from .optim import make_schedule

    return StreamedAdamW(make_schedule(lr, warmup_steps), b1=betas[0], b2=betas[1],
                         weight_decay=weight_decay, use_kahan_summation=use_kahan_summation)
