"""The port's reward package (``spatialthinker_torch/rewards``, host code)
against the JAX package's on the same response strings: every score function
of the registry gives equal scores and sub-scores, exactly (the arithmetic is
the same numpy code; the assignment solve is scipy's on both sides here unless
the JAX package's optional C++ solver is built, which returns the same
assignments); ``RewardManager`` places the same reward tensor.
"""

import json

import numpy as np
import pytest

from spatialthinker_tpu.core.batch import RolloutBatch as JaxBatch
from spatialthinker_tpu.rewards import manager as jm
from spatialthinker_tpu.rewards import registry as jr
from spatialthinker_torch.core.batch import RolloutBatch
from spatialthinker_torch.rewards import manager as tm
from spatialthinker_torch.rewards import registry as tr
from spatialthinker_torch.utils.synthetic_tokenizer import SyntheticTokenizer

SCENE = {
    "objects": [{"id": "cat.1", "bbox": [10, 10, 50, 50]}, {"id": "mat.2", "bbox": [0, 40, 100, 100]},
                {"id": "lamp.3", "bbox": [60, 5, 80, 45]}],
    "relationships": [{"subject": "cat.1", "predicate": "on", "object": "mat.2"},
                      {"subject": "lamp.3", "predicate": "right of", "object": "cat.1"}],
}
SHIFTED = {
    "objects": [{"id": "kitten.1", "bbox": [14, 12, 55, 48]}, {"id": "rug.2", "bbox": [0, 35, 95, 100]},
                {"id": "dog.4", "bbox": [70, 60, 90, 90]}],
    "relationships": [{"subject": "kitten.1", "predicate": "sitting on", "object": "rug.2"}],
}
PROBLEM = "Is the cat on the mat? Image size: (100 x 100)"


def trace(scene, answer, think="The cat sits on the mat."):
    return (f"<observe>I see a cat.</observe><scene>{json.dumps(scene)}</scene>"
            f"<think>{think}</think><answer>{answer}</answer>")


SGG_RESPONSES = [
    trace(SCENE, "yes"), trace(SHIFTED, "yes"), trace(SHIFTED, "no"), trace({"objects": [], "relationships": []}, "yes"),
    "<answer>yes</answer>", trace(SCENE, "yes") + "<answer>dup</answer>", "no tags at all", "",
    trace({"objects": [{"id": "cat", "bbox": [1, 2, 3, 4]}], "relationships": []}, "yes"),
]
MATH_RESPONSES = [
    "<think>2+2</think><answer>\\boxed{4}</answer>", "<think>x</think> \\boxed{4}", "\\boxed{5}",
    "<think>half</think><answer>\\boxed{\\frac{1}{2}}</answer>", "the answer is 4", "",
    "<think>a</think><answer>4</answer>", "<think>a</think>\n<answer> 4 </answer>",
]


@pytest.mark.parametrize("name,responses,truth", [
    ("math", MATH_RESPONSES, "4"), ("math", MATH_RESPONSES, "\\frac{1}{2}"), ("r1v", MATH_RESPONSES, "4"),
    ("r1v", MATH_RESPONSES, "0.5"), ("r1v_scene", SGG_RESPONSES + MATH_RESPONSES, "yes"),
])
def test_score_functions_equal(name, responses, truth):
    ours, ref = tr.get_score_function(name), jr.get_score_function(name)
    for response in responses:
        assert ours(response, truth) == ref(response, truth), response


@pytest.mark.parametrize("gt", [trace(SCENE, "yes"), trace(SHIFTED, "no"),
                                trace({"objects": [], "relationships": []}, "yes")],
                         ids=["scene", "shifted", "empty"])
def test_spatial_sgg_equal(gt):
    ours, ref = tr.get_score_function("spatial_sgg"), jr.get_score_function("spatial_sgg")
    seen = set()
    for response in SGG_RESPONSES:
        got, want = ours(response, gt, PROBLEM), ref(response, gt, PROBLEM)
        assert got == want, response
        assert set(got) == {"overall", "format", "count", "accuracy", "spatial_score"}
        seen.add(got["overall"])
        for fn in (ours, ref):  # a problem without the image size is refused alike
            with pytest.raises(ValueError, match="Image size"):
                fn(response, gt, "no size given")
    assert len(seen) > 1  # the cases do not all score alike


def test_registry_names():
    assert sorted(tr._REGISTRY) == sorted(jr._REGISTRY) == ["math", "r1v", "r1v_scene", "spatial_sgg"]
    with pytest.raises(NotImplementedError, match="Unknown score function"):
        tr.get_score_function("no_such_reward")
    tr.register_score_function("constant", lambda response, truth: {"overall": 1.0})
    try:
        assert tr.get_score_function("constant")("a", "b") == {"overall": 1.0}
    finally:
        del tr._REGISTRY["constant"]


@pytest.mark.parametrize("name,workers", [("spatial_sgg", 1), ("spatial_sgg", 4), ("r1v", 2)])
def test_reward_manager_equal(name, workers):
    tok = SyntheticTokenizer()
    texts = SGG_RESPONSES[:6] if name == "spatial_sgg" else MATH_RESPONSES[:6]
    ids = [tok.encode(t) for t in texts]
    width = max(map(len, ids)) + 2
    responses = np.zeros((len(ids), width), np.int32)
    mask = np.zeros((len(ids), width), np.int32)
    for i, row in enumerate(ids):
        responses[i, : len(row)], mask[i, : len(row)] = row, 1
    truth = trace(SCENE, "yes") if name == "spatial_sgg" else "4"
    non = {"ground_truth": np.array([truth] * len(ids), dtype=object),
           "problem": np.array([PROBLEM] * len(ids), dtype=object)}
    tensors = {"responses": responses, "response_mask": mask}
    got_r, got_m = tm.RewardManager(tok, name, num_workers=workers)(RolloutBatch(dict(tensors), dict(non)))
    ref_r, ref_m = jm.RewardManager(tok, name, num_workers=workers)(JaxBatch(dict(tensors), dict(non)))
    np.testing.assert_array_equal(got_r, ref_r)
    assert got_m == ref_m
    assert got_r.shape == responses.shape and (got_r != 0).sum() <= len(ids)


def _tie_prone_scene(rng):
    """A scene graph on a grid (equal boxes, few labels) and a prediction
    holding duplicates of its objects and other grid cells: cost matrices
    with tied entries, where two optimal assignments may differ."""
    labels = ["cat", "dog", "box"]
    cells = [[x, y, x + 20, y + 20] for x in range(0, 100, 20) for y in range(0, 100, 20)]
    n_gt = int(rng.integers(2, 6))
    gt = [{"id": f"{labels[int(rng.integers(3))]}.{i}", "bbox": cells[int(c)]}
          for i, c in enumerate(rng.choice(len(cells), size=n_gt, replace=False))]
    pred = []
    for i in range(int(rng.integers(1, 8))):
        if rng.random() < 0.6:  # a duplicate of a ground-truth object (same label and box)
            o = gt[int(rng.integers(n_gt))]
            pred.append({"id": o["id"].split(".")[0] + f".{10 + i}", "bbox": list(o["bbox"])})
        else:
            pred.append({"id": f"{labels[int(rng.integers(3))]}.{10 + i}", "bbox": cells[int(rng.integers(len(cells)))]})
    rel = lambda objs: [{"subject": objs[0]["id"], "predicate": "left of", "object": objs[-1]["id"]}]  # noqa: E731
    return {"objects": gt, "relationships": rel(gt)}, {"objects": pred, "relationships": rel(pred)}


def test_rewards_equal_on_tied_costs():
    """On tied costs scipy's solver and the JAX package's C++ one may pick
    different optimal mappings (the port does not pin them); the rewards the
    mappings feed are equal all the same."""
    from spatialthinker_tpu.rewards import spatial_sgg as js
    from spatialthinker_torch.rewards import spatial_sgg as ts

    rng = np.random.default_rng(0)
    duplicated = 0
    for _ in range(300):
        gt, pred = _tie_prone_scene(rng)
        boxes = [tuple(o["bbox"]) for o in pred["objects"]]
        duplicated += len(set(boxes)) < len(boxes)
        g, p = (ts._normalize_objects(s["objects"], 100, 100) for s in (gt, pred))
        assert ts.compute_obj_score(g, p) == js.compute_obj_score(g, p)
        assert ts.spatial_reward(pred, gt, 100, 100) == js.spatial_reward(pred, gt, 100, 100)
        assert ts.relaxed_spatial_reward(pred, gt, 100, 100) == js.relaxed_spatial_reward(pred, gt, 100, 100)
    assert duplicated > 100  # the scenes really tie
