"""AdamW for the actor update, in place (counterpart of
``spatialthinker_tpu/trainer/optim.py`` and of the ``optax.adamw`` the JAX
package's ``make_optimizer`` returns).

Two strategies:

- ``adamw``: decoupled AdamW equal to ``optax.adamw`` -- fp32 moments, the
  update ``-lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)`` added to the
  parameter and rounded to its dtype.
- ``adamw_bf16``: AnyPrecision AdamW -- both moments in bf16 and a
  per-parameter Kahan compensation buffer (in the parameter's dtype) that
  carries the remainder bf16 rounding drops into the next step;
  ``use_kahan_summation=False`` keeps no buffer. The leaf math is
  ``adamw_leaf_core`` of the JAX package in the same order, fp32 inside.

Both read the learning-rate schedule at the pre-increment count (the first
step sees ``schedule(0)``), fold the gradient scale (clip rescale and
micro-batch divisor) into the leaf math, and skip the whole step -- parameters,
moments, compensation and count untouched -- when ``finite`` is false.

Parameters, moments and buffers are updated in place; a leaf's fp32
temporaries are capped by walking it in row chunks. State is kept by
parameter name: ``{"count": int, "mu": {name: tensor}, "nu": ...,
"compensation": ...}``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch

_CHUNK_ELEMENTS = 1 << 24  # fp32 temporaries of one chunk: 64 MB each


def make_schedule(lr: float, warmup_steps: int = 0) -> Callable[[int], float]:
    """Constant after a linear warmup from 0 over ``warmup_steps`` steps."""
    if warmup_steps > 0:
        return lambda count: lr * min(count, warmup_steps) / warmup_steps
    return lambda count: lr


def _row_chunks(t: torch.Tensor):
    """Slices along dim 0 of at most ``_CHUNK_ELEMENTS`` elements each."""
    if t.dim() == 0 or t.numel() <= _CHUNK_ELEMENTS:
        yield slice(None)
        return
    rows = t.shape[0]
    per = max(1, _CHUNK_ELEMENTS // max(t.numel() // rows, 1))
    for start in range(0, rows, per):
        yield slice(start, min(start + per, rows))


def adamw_leaf_(p, g, mu, nu, *, lr, c1, c2, b1, b2, eps, weight_decay, scale) -> None:
    """One ``optax.adamw`` update of one leaf (or a row chunk of it), in place.
    The gradient is rescaled in fp32 and rounded back to its own dtype first,
    as the JAX package's non-fused apply does."""
    g32 = (g.float() * scale).to(g.dtype).float() if scale is not None else g.float()
    mu.mul_(b1).add_(g32, alpha=1.0 - b1)
    nu.mul_(b2).addcmul_(g32, g32, value=1.0 - b2)
    update = (mu / c1) / (torch.sqrt(nu / c2) + eps)
    p32 = p.float()
    update.add_(p32, alpha=weight_decay)
    p.copy_(p32.add_(update, alpha=-lr))


def any_precision_leaf_(p, g, mu, nu, comp, *, lr, c1, c2, b1, b2, eps, weight_decay,
                        scale) -> None:
    """One AnyPrecision AdamW update of one leaf (or a row chunk), in place:
    ``adamw_leaf_core`` of the JAX package, same order, fp32 inside. ``comp``
    is the Kahan buffer or None."""
    g32 = g.float()
    if scale is not None:
        g32 = g32 * scale
    mu32 = mu.float() * b1 + (1.0 - b1) * g32
    nu32 = nu.float() * b2 + (1.0 - b2) * g32 * g32
    denom = torch.sqrt(nu32 / c2) + eps
    p32 = p.float()
    step = -lr * (mu32 / c1 / denom + weight_decay * p32)
    if comp is not None:
        y = step - comp.float()
        t = (p32 + y).to(p.dtype)  # the rounded new parameter
        comp.copy_((t.float() - p32) - y)
    else:
        t = (p32 + step).to(p.dtype)
    p.copy_(t)
    mu.copy_(mu32)
    nu.copy_(nu32)


class AdamW:
    """Both strategies behind one ``step``; see the module docstring."""

    def __init__(self, schedule: Callable[[int], float], *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-2, strategy: str = "adamw",
                 use_kahan_summation: bool = True):
        if strategy not in ("adamw", "adamw_bf16"):
            raise ValueError(f"unknown optimizer strategy {strategy!r}")
        self.schedule = schedule
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.strategy = strategy
        self.use_kahan_summation = use_kahan_summation and strategy == "adamw_bf16"
        self.state: Dict[str, object] = {"count": 0, "mu": {}, "nu": {}, "compensation": {}}

    def reset_moments(self) -> None:
        """Drop (and free) the moments and compensation buffers; the count
        stays. The next step starts them from zero."""
        self.state = {"count": self.state["count"], "mu": {}, "nu": {}, "compensation": {}}

    def init(self, named_params: Iterable[Tuple[str, torch.Tensor]]) -> None:
        """Allocate the moments (and compensation buffers) of every named
        parameter now instead of at its first step, so that what a training
        run keeps resident is resident before anything else is sized."""
        for name, p in named_params:
            self._leaf_state(name, p)

    @property
    def moment_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.strategy == "adamw_bf16" else torch.float32

    def _leaf_state(self, name: str, p: torch.Tensor):
        mu, nu, comp = self.state["mu"], self.state["nu"], self.state["compensation"]
        if name not in mu:
            mu[name] = torch.zeros_like(p, dtype=self.moment_dtype)
            nu[name] = torch.zeros_like(p, dtype=self.moment_dtype)
            if self.use_kahan_summation:
                comp[name] = torch.zeros_like(p)
        return mu[name], nu[name], comp.get(name)

    @torch.no_grad()
    def step(self, named_params: Iterable[Tuple[str, torch.Tensor]],
             grads: Mapping[str, torch.Tensor], *, finite: bool = True,
             grad_scale: Optional[float] = None) -> None:
        """Update every named parameter that has a gradient, in place. A
        non-finite step changes nothing, the count included."""
        if not finite:
            return
        count_prev = int(self.state["count"])
        count = count_prev + 1
        hyper = dict(
            lr=float(self.schedule(count_prev)), c1=1.0 - self.b1**count, c2=1.0 - self.b2**count,
            b1=self.b1, b2=self.b2, eps=self.eps, weight_decay=self.weight_decay, scale=grad_scale,
        )
        for name, p in named_params:
            g = grads.get(name)
            if g is None:
                continue
            mu, nu, comp = self._leaf_state(name, p)
            for sl in _row_chunks(p):
                if self.strategy == "adamw":
                    adamw_leaf_(p[sl], g[sl], mu[sl], nu[sl], **hyper)
                else:
                    any_precision_leaf_(p[sl], g[sl], mu[sl], nu[sl],
                                        None if comp is None else comp[sl], **hyper)
        self.state["count"] = count
