"""The comparison that decides ``correct`` for a training cell.

A record is what one side produced over the followed steps: per step the old
and the reference log-probs of every sample's response tokens, every
sample's advantage, the loss and the gradient norm before the clip; the
per-leaf norms of the first gradient as the optimizer got it (after the
clip) and of the parameters' change over the steps. The program's record is
read from its batches and its optimizer state; the reference's from
``reference/grpo.py``. Each number below has a limit of its own, in
``limits/<workload>.json``, set from the program's readings over a dozen
seeds and the control's (PERF.md gives both).

- ``logp_old``, ``logp_ref``: the widest gap of a log-prob, over every
  response token of every step.
- ``adv``: the widest gap of an advantage.
- ``loss``: the widest gap of a step's loss over the step's mean |advantage|
  under the same token weights.
- ``grad_norm``: the widest gap of a step's gradient norm, over the
  reference's.
- ``grad_leaf``: the worst leaf's gap between the two first-gradient norms,
  over the larger of the reference's norm of that leaf and of the median leaf.
- ``change_leaf``: the same for the parameters' change over the steps, of
  the leaves whose reference gradient is at least a thousandth of the median
  leaf's (a leaf with a gradient that is nought to rounding, as a key bias
  under softmax, moves under Adam by round-off alone).
- ``unmatched``: samples not found exactly once among the packed rows the
  program updated on (exact).
- ``split``: where the program's split of a step's samples into
  micro-batches departs from the one the configuration asks for, worked out
  here from the samples' own lengths (``rule_split``): micro-batches whose
  tokens no micro-batch of the rule matches, on either side, plus a row
  width or a row count a micro-batch that differs (exact). The reference
  weights each token by the program's split, so this holds that split to
  the configuration.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

NUMBERS = ("logp_old", "logp_ref", "adv", "loss", "grad_norm", "grad_leaf", "change_leaf", "unmatched",
           "split")
SMALL_GRADIENT = 1e-3


def rule_split(totals: List[int], micro_rows: int) -> Tuple[int, int, List[int]]:
    """The split of one optimizer step's samples that the configuration asks
    for, from each sample's tokens (prompt and response) alone: rows of at
    least 256 tokens, a multiple of 256, that hold the longest sample and
    twice the mean one; the samples laid into them first fit by decreasing
    length; the rows, in the order they were opened, cut into the fewest
    micro-batches of at most ``micro_rows`` (the configuration's
    ``micro_batch_size_per_device_for_update``) rows, as even as whole rows
    allow. Returns (row width, rows a micro-batch, tokens of each
    micro-batch). Samples of equal length are interchangeable here, so the
    tokens do not depend on the order of ties."""
    target = max(max(totals), int(2 * float(np.mean(totals))))
    width = max(256, -(-target // 256) * 256)
    rows: List[int] = []
    for need in sorted(totals, reverse=True):
        for i, used in enumerate(rows):
            if used + need <= width:
                rows[i] += need
                break
        else:
            rows.append(need)
    n_micro = max(-(-len(rows) // max(micro_rows, 1)), 1)
    per = -(-len(rows) // n_micro)
    return width, per, [sum(rows[g * per:(g + 1) * per]) for g in range(n_micro)]


def read_partition(records: List[tuple], responses: List[np.ndarray], totals: List[int],
                   micro_rows: int) -> dict:
    """The micro-batch of each sample, from the packed rows one optimizer
    step updated on, and that split held against ``rule_split``.
    ``records``: per call of the update, (labels, loss_mask, segment_ids),
    each (n_micro, rows, L); a sample is found by its response tokens, which
    are the labels where its segment's loss mask is set. ``totals``: each
    sample's prompt and response tokens, from the made unit."""
    by_tokens = {tuple(r.tolist()): s for s, r in enumerate(responses)}
    found: Dict[int, List[int]] = {}
    tokens, loads, strays, offset = [], [], 0, 0
    width, per, want = rule_split(totals, micro_rows)
    shape_off = 0
    for labels, mask, seg in records:
        shape_off += int(labels.shape[1] != per) + int(labels.shape[2] != width)
        for j in range(labels.shape[0]):
            tokens.append(float(mask[j].sum()))
            loads.append(0)
            for r in range(labels.shape[1]):
                for sid in np.unique(seg[j, r]):
                    if sid == 0:
                        continue
                    sel = (seg[j, r] == sid) & (mask[j, r] > 0)
                    s = by_tokens.get(tuple(labels[j, r][sel].tolist()))
                    if s is None:
                        strays += 1
                    else:
                        found.setdefault(s, []).append(offset + j)
                        loads[-1] += int(totals[s])
        offset += labels.shape[0]
    micro = [found[s][0] if len(found.get(s, [])) == 1 else 0 for s in range(len(responses))]
    unmatched = strays + sum(len(found.get(s, [])) != 1 for s in range(len(responses)))
    rule = list(want)  # the rule's micro-batches that no micro-batch of the program's matched
    extra = 0
    for load in loads:
        if load in rule:
            rule.remove(load)
        else:
            extra += 1
    split = extra + len(rule) + shape_off
    return {"micro": micro, "tokens": tokens, "n_micro": len(tokens), "unmatched": unmatched,
            "split": split}


def published_leaves(model: dict, name: str, t: torch.Tensor) -> list:
    """(name, view) of the published model's parameters that ``t`` holds:
    a fused text ``qkv_proj`` is its q, k and v projections (per kv head:
    the group's q heads, then k, then v), ``gate_up_proj`` its gate and up,
    a vision ``qkv`` its q, k and v thirds. Leaves are compared as the
    published model has them, so that a k bias, whose gradient is nought
    under softmax, is a leaf of its own."""
    if name.endswith(("self_attn.qkv_proj.weight", "self_attn.qkv_proj.bias")):
        h, hkv = model["num_attention_heads"], model["num_key_value_heads"]
        d, per = model["hidden_size"] // h, h // hkv
        g = t.reshape(hkv, per + 2, d, -1)
        base = name.replace("qkv_proj", "{}_proj")
        return [(base.format("q"), g[:, :per]), (base.format("k"), g[:, per]), (base.format("v"), g[:, per + 1])]
    if name.endswith("mlp.gate_up_proj.weight"):
        gate, up = t.chunk(2, 0)
        return [(name.replace("gate_up", "gate"), gate), (name.replace("gate_up", "up"), up)]
    if name.startswith("vision.") and name.endswith(("qkv.weight", "qkv.bias")):
        q, k, v = t.chunk(3, 0)
        return [(name.replace("qkv", x), y) for x, y in (("q", q), ("k", k), ("v", v))]
    return [(name, t)]


@torch.no_grad()
def leaf_norms(model: dict, named, minus: Optional[Dict[str, torch.Tensor]] = None,
               scale: float = 1.0) -> Dict[str, float]:
    """Norms of the published leaves of ``named`` (of their difference from
    ``minus``), times ``scale``."""
    out = {}
    for name, t in named:
        x = t.double()
        if minus is not None:
            x = x - minus[name].double()
        for leaf, view in published_leaves(model, name, x):
            out[leaf] = float(view.norm()) * scale
    return out


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> Dict[str, float]:
    floor = float(np.median([ref[n] for n in ref]))
    return {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], floor, 1e-30)
            for n in ref if keep is None or keep(n)}


def _kept(ref: dict):
    g = ref["first_grad"]
    floor = float(np.median(list(g.values())))
    return lambda n: g[n] >= SMALL_GRADIENT * floor


def worst_leaves(prog: dict, ref: dict, top: int = 3) -> dict:
    """The leaves that set ``grad_leaf`` and ``change_leaf``, with their gaps."""
    out = {}
    for key, gaps in (("grad_leaf", _leaf_gaps(prog["first_grad"], ref["first_grad"])),
                      ("change_leaf", _leaf_gaps(prog["change"], ref["change"], _kept(ref)))):
        out[key] = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    keep = _kept(ref)
    out["left_out_of_change"] = [n for n in ref["first_grad"] if not keep(n)]
    return out


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    out = {k: 0.0 for k in NUMBERS}
    for ps, rs in zip(prog["steps"], ref["steps"]):
        for key, name in (("old", "logp_old"), ("ref", "logp_ref")):
            for s, r in enumerate(rs[key]):
                p = ps[key][s]
                gap = float(np.max(np.abs(p - r))) if len(p) == len(r) else float("inf")
                out[name] = max(out[name], gap)
        out["adv"] = max(out["adv"], float(np.max(np.abs(np.asarray(ps["adv"]) - np.asarray(rs["adv"])))))
        out["loss"] = max(out["loss"], abs(ps["loss"] - rs["loss"]) / max(rs["abs_adv"], 1e-30))
        out["grad_norm"] = max(out["grad_norm"], abs(ps["grad_norm"] - rs["grad_norm"]) / rs["grad_norm"])
    out["grad_leaf"] = max(_leaf_gaps(prog["first_grad"], ref["first_grad"]).values())
    out["change_leaf"] = max(_leaf_gaps(prog["change"], ref["change"], _kept(ref)).values())
    out["unmatched"] = float(prog.get("unmatched", 0))
    out["split"] = float(prog.get("split", 0))
    return out


def load_limits(root: Path, workload: str) -> Optional[dict]:
    path = root / "limits" / f"{workload}.json"
    return json.loads(path.read_text())["limits"] if path.exists() else None


def verdict(numbers: Dict[str, float], limits: Optional[dict]) -> bool:
    """True when every number is within its limit (an exact one at most 0)."""
    if limits is None:
        return False
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
