"""The yardstick's arithmetic against counts made by hand."""

import json
from pathlib import Path

import pytest

from perfbench import generator, manifest, work

ROOT = Path(__file__).resolve().parents[2]
CFG = json.loads((ROOT / "perfbench/configs/qwen2_5_vl_3b.json").read_text())
M, VC = CFG["model"], CFG["model"]["vision_config"]


def test_bound_is_the_slower_of_bytes_and_operations():
    assert work.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert work.bound_s(1.0, 989e12) == pytest.approx(1.0)
    assert work.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)


def test_text_forward_by_hand():
    # one 3B layer: qkv 2048 x (16 + 2 * 2) * 128, o 2048 x 2048, MLP 3 x 2048 x 11008
    per_token_layer = 2 * (2048 * 2560 + 2048 * 2048 + 3 * 2048 * 11008)
    length, response = 1000, 400
    head = 2 * 2048 * 151936 * response
    attention = 36 * 4 * 16 * 128 * length * (length + 1) / 2
    assert work.text_forward(M, length, response) == pytest.approx(36 * per_token_layer * length + head + attention)
    ops, n_bytes = work.text_attention(M, length)
    assert ops == pytest.approx(attention)
    assert n_bytes == pytest.approx(36 * 2 * length * 128 * (16 + 16 + 2 + 2))


def test_vision_windows_and_full_blocks_are_per_image():
    # a 36 x 48 patch grid: 18 x 24 merged tokens, 4 x 4-token windows -> 5 x 6 windows,
    # the last row of windows 2 tokens high
    sizes = work.image_windows(VC, (1, 36, 48))
    assert len(sizes) == 30 and sum(sizes) == 36 * 48
    assert sizes.count(64) == 24 and sizes.count(32) == 6
    ops, _ = work.vision_attention(VC, (1, 36, 48))
    by_hand = 4 * 1280 * (28 * (24 * 64 ** 2 + 6 * 32 ** 2) + 4 * (36 * 48) ** 2)
    assert ops == pytest.approx(by_hand)
    # two images are two times one image, never one image of twice the patches
    two = 2 * work.vision_forward(VC, (1, 36, 48))
    assert two < work.vision_forward(VC, (1, 72, 48))


def test_vision_forward_by_hand():
    n = 36 * 48
    linear = 2 * n * 1176 * 1280 + 32 * 2 * n * (4 * 1280 ** 2 + 3 * 1280 * 3420)
    merger = 2 * (n // 4) * (5120 * 5120 + 5120 * 2048)
    assert work.vision_forward(VC, (1, 36, 48)) == pytest.approx(
        linear + merger + work.vision_attention(VC, (1, 36, 48))[0])


def test_unit_counts_five_forwards_and_each_image_once():
    unit = generator.make_unit(CFG, manifest.traffic("update_long"), 5, 0)
    w = work.unit_work(M, unit)
    text = sum(work.text_forward(M, len(unit.prompts[s // 8].ids) + len(r), len(r))
               for s, r in enumerate(unit.responses))
    vision = sum(work.vision_forward(VC, p.grid[0]) for p in unit.prompts)
    assert w["model_ops"] == pytest.approx(5 * (text + vision))
    assert len(unit.prompts) == 4 and len(unit.responses) == 32
