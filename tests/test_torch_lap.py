"""The port's assignment solver (``spatialthinker_torch/csrc/lap.py`` over
``csrc/lap.cpp``) against the JAX package's (``spatialthinker_tpu/csrc``)
and scipy's ``linear_sum_assignment``:

- the same mappings as the JAX package's solver, exactly, on seeded random
  rectangular matrices (more rows, more columns, square) and on tied ones
  (a few integer levels, duplicated rows and columns), and scipy's optimal
  cost on each;
- the reward matcher (``rewards/matching.py``) on tie-prone scene graphs:
  the same object and triplet mappings as the JAX package's matcher;
- a build that fails raises with the compiler's output (no scipy
  fallback), and building the solver never starts the CUDA kernels' build.
"""

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from spatialthinker_tpu.csrc import lap as jax_lap
from spatialthinker_torch import csrc
from spatialthinker_torch.csrc import lap


def _cases():
    rng = np.random.default_rng(0)
    for shape in [(1, 1), (3, 7), (7, 3), (6, 6), (12, 5), (5, 12), (20, 20)]:
        for _ in range(8):
            yield "random", rng.normal(size=shape) * 10
            levels = rng.integers(0, 3, size=shape).astype(np.float64)  # many ties
            if shape[0] > 1:
                levels[-1] = levels[0]  # a duplicated row
            yield "tied", levels
    yield "constant", np.ones((4, 6))
    yield "dummy_rows", np.vstack([rng.random((2, 5)), np.full((3, 5), 1e5)])  # the matcher's padding


CASES = list(_cases())


@pytest.mark.parametrize("kind,cost", CASES, ids=[f"{k}_{c.shape[0]}x{c.shape[1]}_{i}"
                                                 for i, (k, c) in enumerate(CASES)])
def test_lap_gives_the_jax_solvers_mappings_and_scipys_cost(kind, cost):
    assert jax_lap._ensure(), "the JAX package's C++ solver must be the one compared"
    rows, cols = lap.solve(cost)
    jrows, jcols = jax_lap.solve(cost)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(cols, jcols)
    srows, scols = linear_sum_assignment(cost)
    assert len(rows) == len(srows) == min(cost.shape) and np.all(np.diff(rows) > 0)
    assert len(set(cols.tolist())) == len(cols)
    assert cost[rows, cols].sum() == pytest.approx(cost[srows, scols].sum(), abs=1e-9)


def test_matcher_mappings_equal_the_jax_matchers_on_tied_costs():
    """The scenes of ``tests/test_torch_rewards.py``'s tie test (duplicated
    predictions on a grid of equal boxes): the port's object and triplet
    mappings equal the JAX package's exactly."""
    from spatialthinker_tpu.rewards import matching as jm
    from spatialthinker_tpu.rewards import spatial_sgg as js
    from spatialthinker_torch.rewards import matching as tm
    from spatialthinker_torch.rewards import spatial_sgg as ts
    from tests.test_torch_rewards import _tie_prone_scene

    rng = np.random.default_rng(1)
    for _ in range(200):
        gt, pred = _tie_prone_scene(rng)
        g, p = (ts._normalize_objects(s["objects"], 100, 100) for s in (gt, pred))
        assert tm.match_objects(g, p) == jm.match_objects(*(js._normalize_objects(s["objects"], 100, 100)
                                                             for s in (gt, pred)))
        assert tm.match_triplets(gt["relationships"], pred["relationships"]) == \
            jm.match_triplets(gt["relationships"], pred["relationships"])


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """A source g++ refuses: ``solve`` raises with g++'s message; nothing
    falls back to scipy."""
    bad = tmp_path / "lap.cpp"
    bad.write_text("extern \"C\" int lap_solve(const double* c, int nr, int nc, int* o) { return oops; }\n")
    monkeypatch.setattr(lap, "SOURCE", bad)
    monkeypatch.setattr(lap, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(lap, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on lap.cpp(.|\\n)*oops"):
        lap.solve(np.eye(3))
    assert not list((tmp_path / "build").glob("*.so"))


def test_building_the_solver_never_starts_the_cuda_build(tmp_path, monkeypatch):
    """The reward path runs without nvcc: a fresh build of the solver calls
    nothing of ``csrc``'s CUDA build."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA build started")

    monkeypatch.setattr(csrc, "build", refuse)
    monkeypatch.setattr(csrc, "library", refuse)
    monkeypatch.setattr(lap, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(lap, "_lib", None)
    rows, cols = lap.solve(np.array([[4.0, 1.0, 3.0], [2.0, 0.0, 5.0], [3.0, 2.0, 2.0]]))
    assert rows.tolist() == [0, 1, 2] and cols.tolist() == [1, 0, 2]
    assert len(list((tmp_path / "build").glob("liblap_*.so"))) == 1
