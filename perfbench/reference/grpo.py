"""Plain reference of the first steps of GRPO training: advantages, log-probs,
the loss as the configuration defines it, its gradient, the gradient clip and
AdamW with the parameters stored in bfloat16, all in float32 with TF32 off.

The configuration's loss of one optimizer step (``worker.actor``): the
mini-batch is cut into micro-batches of packed rows; a micro-batch's loss is
the token mean, over its response tokens, of the dual-clip PPO term plus
``kl_loss_coef`` times the ``low_var_kl`` penalty against the reference
policy; the step's loss is the mean over its micro-batches. Which sample
lies in which micro-batch is a packing decision: the reference takes it as
given (``partition``: the micro-batch of each sample and the response tokens
each micro-batch holds), and the harness reads it from the rows the program
packed, by their tokens.

Advantages: GRPO, each sample's score whitened over its prompt's group
(unbiased std, eps 1e-6). AdamW: bias-corrected moments, decoupled weight
decay, the new parameter rounded to bfloat16 (``strategy: adamw``).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from ..check import leaf_norms
from ..weights import make_weights
from .qwen2_5_vl import Reference


def grpo_advantages(scores: np.ndarray, group: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    scores = scores.astype(np.float64)
    out = np.empty_like(scores)
    for g in np.unique(group):
        sel = group == g
        s = scores[sel]
        out[sel] = (s - s.mean()) / (s.std(ddof=1) + eps)
    return out


def low_var_kl(logp: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    d = ref - logp
    return torch.clamp(torch.exp(d) - d - 1.0, -10.0, 10.0)


def policy_term(logp, old, adv, low, high, dual):
    neg_kl = logp - old
    ratio = torch.exp(neg_kl)
    clipped = torch.exp(torch.clamp(neg_kl, math.log(1.0 - low), math.log(1.0 + high)))
    l1, l2 = -adv * ratio, -adv * clipped
    higher = torch.maximum(l1, l2)
    return torch.where(adv < 0, torch.minimum(higher, -adv * dual), higher)


class Steps:
    """Follows the first optimizer steps from the seed's weights.
    ``leaves`` are the float32 parameters (requires_grad), by name."""

    def __init__(self, model: dict, training: dict, leaves: Dict[str, torch.Tensor], precision: str = "fp32"):
        self.ref = Reference(model, leaves, precision)
        self.model = model
        self.t = training
        self.leaves = leaves
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.count = 0

    def sequence(self, prompt, response, device):
        ids = torch.as_tensor(np.concatenate([prompt.ids, response]), device=device)
        start = int(prompt.positions.max()) + 1
        gen = np.arange(start, start + len(response))[None, :].repeat(3, 0)
        pos = torch.as_tensor(np.concatenate([prompt.positions, gen], 1), device=device)
        return ids, pos

    @torch.no_grad()
    def log_probs(self, unit, device) -> List[np.ndarray]:
        """Log-probs of every sample's response at the current parameters."""
        out = []
        n = unit.n
        for pi, prompt in enumerate(unit.prompts):
            image = self.ref.vision(torch.as_tensor(prompt.patches, device=device), prompt.grid[0])
            for s in range(pi * n, (pi + 1) * n):
                ids, pos = self.sequence(prompt, unit.responses[s], device)
                out.append(self.ref.response_log_probs(ids, pos, image, len(prompt.ids),
                                                       self.t["temperature"]).cpu().numpy())
        return out

    def step(self, unit, ref_lp: List[np.ndarray], partition: dict, device) -> dict:
        """One optimizer step on ``unit``; ``ref_lp`` the reference policy's
        log-probs of its samples (None: they are this step's own, the policy
        still being the reference). ``partition``: ``micro`` (micro-batch of
        each sample, by position in the unit), ``tokens`` (response tokens of
        each micro-batch), ``n_micro``. Returns what the step produced."""
        t, n = self.t, unit.n
        group = np.arange(len(unit.responses)) // n
        adv = grpo_advantages(unit.scores, group)
        weight = [1.0 / (partition["n_micro"] * partition["tokens"][partition["micro"][s]])
                  for s in range(len(unit.responses))]
        old, loss_sum, weighted_abs_adv = [], 0.0, 0.0
        for pi, prompt in enumerate(unit.prompts):
            image = self.ref.vision(torch.as_tensor(prompt.patches, device=device), prompt.grid[0])
            image_in = image.detach().requires_grad_(True)
            for s in range(pi * n, (pi + 1) * n):
                ids, pos = self.sequence(prompt, unit.responses[s], device)
                logp = self.ref.response_log_probs(ids, pos, image_in, len(prompt.ids), t["temperature"])
                cur = logp.detach()
                ref = cur if ref_lp is None else torch.as_tensor(ref_lp[s], device=device)
                a = torch.full_like(logp, float(adv[s]))
                per_token = policy_term(logp, cur, a, t["clip_ratio_low"], t["clip_ratio_high"],
                                        t["clip_ratio_dual"])
                if t["use_kl_loss"]:
                    per_token = per_token + t["kl_loss_coef"] * low_var_kl(logp, ref)
                loss = per_token.sum() * weight[s]
                loss.backward()
                loss_sum += float(loss.detach())
                weighted_abs_adv += abs(float(adv[s])) * len(logp) * weight[s]
                old.append(cur.cpu().numpy())
            image.backward(image_in.grad)
        norm = math.sqrt(sum(float(p.grad.double().pow(2).sum()) for p in self.leaves.values()))
        factor = min(1.0, t["max_grad_norm"] / (norm + 1e-6))
        first_grad = None
        if self.count == 0:
            first_grad = leaf_norms(self.model, ((k, p.grad) for k, p in self.leaves.items()), scale=factor)
        self._adamw(factor)
        return {"old": old, "adv": adv, "loss": loss_sum, "grad_norm": norm, "first_grad": first_grad,
                "abs_adv": weighted_abs_adv}

    def change(self, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
        return leaf_norms(self.model, self.leaves.items(), minus=start)

    @torch.no_grad()
    def _adamw(self, factor: float) -> None:
        t = self.t
        b1, b2 = t["betas"]
        self.count += 1
        c1, c2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for k, p in self.leaves.items():
            g = p.grad * factor
            m, v = self.m[k], self.v[k]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            update = (m / c1) / (torch.sqrt(v / c2) + t["eps"]) + t["weight_decay"] * p
            p.copy_((p - t["lr"] * update).to(torch.bfloat16).float())
            p.grad = None


def follow(model: dict, training: dict, seed: int, units: list, partitions: list, device,
           precision: str = "fp32") -> dict:
    """The reference's record of ``len(units)`` optimizer steps from the
    weights of ``seed``: unit k is step k + 1, ``partitions[k]`` its
    micro-batches (``check.read_partition``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    leaves = {k: v.float().requires_grad_(True) for k, v in make_weights(model, seed, device).items()}
    steps = Steps(model, training, leaves, precision)
    # the reference policy is the starting one: its log-probs of the later
    # steps' samples are taken before the first step moves it
    ref_lp = [None] + [steps.log_probs(u, device) for u in units[1:]]
    out = []
    for unit, part, ref in zip(units, partitions, ref_lp):
        r = steps.step(unit, ref, part, device)
        out.append({"old": r["old"], "ref": r["old"] if ref is None else ref, "adv": r["adv"],
                    "loss": r["loss"], "grad_norm": r["grad_norm"], "abs_adv": r["abs_adv"]})
        if r["first_grad"] is not None:
            first = r["first_grad"]
    del steps.m, steps.v
    start = make_weights(model, seed, device)
    change = steps.change(start)
    return {"steps": out, "first_grad": first, "change": change}
