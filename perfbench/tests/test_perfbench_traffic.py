"""The generator makes the same work from the same seed, the same sizes from
every seed, and prompts laid out as the program's data pipeline lays them."""

import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import generator, manifest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
CFG = json.loads((ROOT / "perfbench/configs/qwen2_5_vl_3b.json").read_text())
MIX = manifest.traffic("update_long")
BIG_SEED = 2**31 + 977


def _same(a: generator.Unit, b: generator.Unit) -> bool:
    return (all(np.array_equal(x.ids, y.ids) and np.array_equal(x.patches, y.patches)
                and np.array_equal(x.positions, y.positions) for x, y in zip(a.prompts, b.prompts))
            and all(np.array_equal(x, y) for x, y in zip(a.responses, b.responses))
            and np.array_equal(a.scores, b.scores))


@pytest.mark.parametrize("seed", [0, BIG_SEED, 2**33 + 5])
def test_same_seed_same_unit(seed):
    assert _same(generator.make_unit(CFG, MIX, seed, 1), generator.make_unit(CFG, MIX, seed, 1))


def test_seeds_and_units_differ_in_content_not_in_sizes():
    a, b, c = (generator.make_unit(CFG, MIX, s, u) for s, u in ((1, 0), (2, 0), (1, 1)))
    assert not _same(a, b) and not _same(a, c)
    def pairs(u):  # each prompt's image with its responses' lengths
        return sorted((p.patches.shape[0], tuple(sorted(len(r) for r in u.responses[i * u.n:(i + 1) * u.n])))
                      for i, p in enumerate(u.prompts))

    for x in (b, c):
        assert pairs(x) == pairs(a) and x.tokens() == a.tokens()
    assert [len(r) for r in b.responses] != [len(r) for r in a.responses]


def test_strata_follow_the_mix():
    sides, lengths = generator.strata(MIX)
    assert sides == [548, 684, 820, 956]
    assert len(lengths) == 32 and min(lengths) >= MIX["response_min"] and max(lengths) <= MIX["response_max"]
    assert sorted(lengths)[15] <= MIX["response_lognormal_median"] <= sorted(lengths)[16]


def test_responses_end_on_eos_and_avoid_special_ids():
    u = generator.make_unit(CFG, MIX, 3, 0)
    lo, hi = CFG["text_token_range"]
    for r in u.responses:
        assert r[-1] == CFG["model"]["eos_token_id"]
        assert ((r[:-1] >= lo) & (r[:-1] < hi)).all()


def test_sizes_and_positions_match_the_program_pipeline():
    """The published resize rule and mRoPE layout, held against the port's
    own copies of them."""
    from spatialthinker_torch.data.image import smart_resize_dims
    from spatialthinker_torch.models.qwen2_5_vl.host import get_mrope_position_ids

    p = CFG["image_processor"]
    for w in (480, 548, 684, 820, 956, 1024, 3000):
        h = round(w * 3 / 4)
        assert generator.smart_resize(h, w, 28, p["min_pixels"], p["max_pixels"]) == tuple(
            smart_resize_dims(h, w, factor=28, min_pixels=p["min_pixels"], max_pixels=p["max_pixels"]))
    m = CFG["model"]
    for prompt in generator.make_unit(CFG, MIX, 4, 0).prompts:
        pos, _ = get_mrope_position_ids(
            prompt.ids, prompt.grid, spatial_merge_size=2, image_token_id=m["image_token_id"],
            video_token_id=m["video_token_id"], vision_start_token_id=m["vision_start_token_id"])
        assert np.array_equal(pos, prompt.positions)
        assert (prompt.ids == m["image_token_id"]).sum() * 4 == prompt.patches.shape[0]
