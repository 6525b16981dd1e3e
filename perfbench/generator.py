"""The one traffic generator: it reads a mix's parameters (``traffic/<mix>.json``)
and makes the work of a run from ``--seed``.

A ``train_phase`` mix is made of units; a unit is the rollout batch of one
``train_step`` call: ``prompts_per_unit`` prompts, each with one image, and
``samples_per_prompt`` responses of each prompt with a score each. Every unit
holds the same sizes (image sides at the quantile midpoints of their range,
response lengths at the quantile midpoints of their log-normal law, each
prompt's image with the same lengths), so two seeds give the same work in
another order; the seed orders prompts and samples and draws every token,
pixel and score.

A prompt is laid out as a chat turn: ``a`` text tokens, the vision start
token, one image token per merged patch, the vision end token, ``b`` text
tokens. Its mRoPE position ids follow the published rule (text positions run
on; an image's tokens take (t, h, w) grid positions after the text before
it; the text after it resumes at the largest position + 1). Patches are the
published processor's layout of a random image: per patch C x T x P x P
normalized pixel values, patches ordered by 2 x 2 merge blocks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np


def smart_resize(height: int, width: int, factor: int, min_pixels: int, max_pixels: int) -> Tuple[int, int]:
    """The published Qwen2-VL processor's resize: both sides a multiple of
    ``factor``, the pixel count inside [min_pixels, max_pixels]."""
    h = round(height / factor) * factor
    w = round(width / factor) * factor
    if h * w > max_pixels:
        beta = math.sqrt(height * width / max_pixels)
        h = max(factor, math.floor(height / beta / factor) * factor)
        w = max(factor, math.floor(width / beta / factor) * factor)
    elif h * w < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h = math.ceil(height * beta / factor) * factor
        w = math.ceil(width * beta / factor) * factor
    return h, w


def mrope_positions(pre: int, grid_hw: Tuple[int, int], merge: int, post: int) -> np.ndarray:
    """(3, L) position ids of [pre text | vision start | image tokens |
    vision end | post text]: ``pre`` counts the text before the vision start
    token, ``post`` the text after the vision end token."""
    lh, lw = grid_hw[0] // merge, grid_hw[1] // merge
    head = np.arange(pre + 1)
    start = pre + 1
    hh = np.repeat(np.arange(lh), lw)
    ww = np.tile(np.arange(lw), lh)
    image = np.stack([np.zeros(lh * lw, dtype=np.int64), hh, ww]) + start
    tail = np.arange(post + 1) + image.max() + 1
    return np.concatenate([np.tile(head, (3, 1)), image, np.tile(tail, (3, 1))], axis=1)


@dataclass
class Prompt:
    ids: np.ndarray        # (Lp,) valid tokens
    positions: np.ndarray  # (3, Lp)
    patches: np.ndarray    # (N, C*T*P*P) float32
    grid: np.ndarray       # (1, 3) int64: t, h, w in patches


@dataclass
class Unit:
    index: int
    prompts: List[Prompt]
    responses: List[np.ndarray]  # per sample, its valid tokens (sample s is prompt s // n)
    scores: np.ndarray           # (samples,) float32
    sample_ids: np.ndarray       # (samples,) run-wide ids

    @property
    def n(self) -> int:
        return len(self.responses) // len(self.prompts)

    def totals(self) -> List[int]:
        """Each sample's prompt + response tokens."""
        return [len(self.prompts[s // self.n].ids) + len(r) for s, r in enumerate(self.responses)]

    def tokens(self) -> int:
        """Prompt + response tokens of every sample: what ``train_step``
        counts as ``num_tokens``."""
        return sum(self.totals())


def strata(mix: dict) -> Tuple[List[int], List[int]]:
    """The image longer sides and the response lengths every unit holds."""
    k = mix["prompts_per_unit"]
    lo, hi = mix["image_longer_side"]
    sides = [int(round(lo + (hi - lo) * (i + 0.5) / k)) for i in range(k)]
    n = k * mix["samples_per_prompt"]
    law = NormalDist(math.log(mix["response_lognormal_median"]), mix["response_lognormal_sigma"])
    lengths = [int(round(math.exp(law.inv_cdf((i + 0.5) / n)))) for i in range(n)]
    lengths = [min(max(x, mix["response_min"]), mix["response_max"]) for x in lengths]
    return sides, lengths


def make_unit(cfg: dict, mix: dict, seed: int, index: int) -> Unit:
    m, proc = cfg["model"], cfg["image_processor"]
    vc = m["vision_config"]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x7AFF1C, int(index)]))
    lo_tok, hi_tok = cfg["text_token_range"]
    sides, lengths = strata(mix)
    n = mix["samples_per_prompt"]
    # every prompt keeps the same image and the same response lengths from
    # seed to seed (prompt i: the i-th side, every k-th length from the i-th),
    # so that a unit's work is the same; the seed orders prompts and samples
    groups = [(side, sorted(lengths)[i::len(sides)]) for i, side in enumerate(sides)]
    order = rng.permutation(len(groups))
    groups = [(groups[i][0], [groups[i][1][j] for j in rng.permutation(n)]) for i in order]
    sides = [g[0] for g in groups]
    lengths = [x for g in groups for x in g[1]]
    ar_w, ar_h = mix["image_aspect"]
    patch, merge, tps = vc["patch_size"], vc["spatial_merge_size"], vc["temporal_patch_size"]
    mean = np.asarray(proc["image_mean"], np.float32)[:, None, None, None]
    std = np.asarray(proc["image_std"], np.float32)[:, None, None, None]
    pre, post = mix["prompt_text_tokens"]
    prompts = []
    for side in sides:
        h, w = smart_resize(round(side * ar_h / ar_w), side, patch * merge,
                            proc["min_pixels"], proc["max_pixels"])
        gh, gw = h // patch, w // patch
        n_patch = gh * gw
        pixels = rng.random((n_patch, vc["in_chans"], 1, patch, patch), dtype=np.float32)
        # a still image fills both temporal slots of a patch
        patches = ((np.repeat(pixels, tps, axis=2) - mean) / std).reshape(n_patch, -1)
        n_img = n_patch // (merge * merge)
        ids = np.concatenate([
            rng.integers(lo_tok, hi_tok, pre), [m["vision_start_token_id"]],
            np.full(n_img, m["image_token_id"]), [m["vision_end_token_id"]],
            rng.integers(lo_tok, hi_tok, post),
        ]).astype(np.int32)
        prompts.append(Prompt(ids, mrope_positions(pre, (gh, gw), merge, post),
                              patches.astype(np.float32), np.asarray([[1, gh, gw]], np.int64)))
    responses = []
    for length in lengths:
        r = rng.integers(lo_tok, hi_tok, length).astype(np.int32)
        if length < mix["response_max"]:
            r[-1] = m["eos_token_id"]  # a response that ends before the limit ends on EOS
        responses.append(r)
    scores = rng.random(len(lengths)).astype(np.float32)
    ids = np.arange(len(lengths), dtype=np.int64) + index * len(lengths)
    return Unit(index, prompts, responses, scores, ids)


def prompt_arrays(unit: Unit, width: int, pad_id: int) -> Dict[str, np.ndarray]:
    """The unit's prompts left-padded to ``width`` (the dataset's layout:
    pad positions 1, segment id 0)."""
    b = len(unit.prompts)
    ids = np.full((b, width), pad_id, np.int32)
    seg = np.zeros((b, width), np.int32)
    pos = np.ones((b, 3, width), np.int32)
    start = np.zeros(b, np.int32)
    for i, p in enumerate(unit.prompts):
        n = len(p.ids)
        ids[i, width - n:] = p.ids
        seg[i, width - n:] = 1
        pos[i, :, width - n:] = p.positions
        start[i] = int(p.positions.max()) + 1
    return {"input_ids": ids, "segment_ids": seg, "position_ids": pos, "gen_pos_start": start}


def response_arrays(unit: Unit, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """(responses, response_mask), each (samples, width), right-padded."""
    out = np.zeros((len(unit.responses), width), np.int32)
    mask = np.zeros((len(unit.responses), width), np.int32)
    for s, r in enumerate(unit.responses):
        out[s, :len(r)] = r
        mask[s, :len(r)] = 1
    return out, mask
