"""The mesh and the multi-process glue of the port (``spatialthinker_torch/
parallel/{mesh,sharding,multihost}.py``) on 4 gloo ranks on the CPU
(``tests/torch_dist_worker.py``), against the JAX package where it has a
counterpart:

- ``create_mesh``: shapes with the ``fsdp_size=-1`` rule and the same
  assertion messages as JAX's ``create_mesh`` on 4 of the 8 CPU devices; the
  batch (``data x fsdp``), sp (``model``) and norm (``fsdp x model``) groups;
- ``shard_model``: every text layer, vision block and root parameter a
  DTensor, Shard(0) over the 4 ranks (Replicate first under ``data_size=2``),
  the local pieces in ``torch.chunk`` sizes;
- the shipped 3B script's dotlist, uncut, with ``trainer.n_chips=4``: parsed
  as JAX parses it, passing the run's checks on 4 ranks, its mesh 1 x 4 x 1;
- the host helpers, ``initialize_if_needed`` raising, a DTensor refused by
  name at the kernels' input checks, ``DataLoader(process_shard=)`` against
  JAX's, and the config's lifted and kept refusals.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from spatialthinker_tpu.core import config as jc
from spatialthinker_tpu.data.dataset import DataLoader as JaxDataLoader
from spatialthinker_tpu.parallel.mesh import create_mesh as jax_create_mesh
from spatialthinker_torch.core import config as tc
from spatialthinker_torch.data.dataset import DataLoader
from tests.test_torch_config import _dotlist
from tests.torch_dist_worker import ROOT, run_ranks

MESHES = [(1, -1, 1), (2, -1, 1), (1, 2, 2), (2, 1, 2), (3, -1, 1), (1, 3, 1)]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    from tests.test_torch_parity import both_models

    _, model = both_models(seed=3)
    payload = {"meshes": MESHES, "shard_mesh": (2, -1, 1), "kv_heads": 2,
               "state": {k: v.clone() for k, v in model.state_dict().items()},
               "dotlist": _dotlist("spatialthinker_3b_grpo.sh") + ["trainer.n_chips=4"]}
    return run_ranks("mesh", 4, tmp_path_factory.mktemp("mesh"), payload)


@pytest.mark.parametrize("sizes", MESHES, ids=[str(m) for m in MESHES])
def test_create_mesh_shapes_and_messages_match_jax(four_ranks, sizes):
    try:
        want = tuple(jax_create_mesh(*sizes, devices=jax.devices()[:4]).devices.shape)
    except AssertionError as e:
        for r in four_ranks:
            assert r["errors"][sizes] == str(e)
        return
    for r in four_ranks:
        assert r["meshes"][sizes]["shape"] == want


def test_mesh_groups(four_ranks):
    """Rank (d * fsdp + f) * model + m: the batch group fixes m, the sp group
    is the model axis, the norm group the fsdp x model block of one replica."""
    for rank, r in enumerate(four_ranks):
        m = r["meshes"][(2, 1, 2)]
        assert m["batch"] == [rank % 2, rank % 2 + 2] and m["sp"] == [rank // 2 * 2, rank // 2 * 2 + 1]
        assert m["norm"] == m["sp"] and m["batch_rank"] == rank // 2
        m = r["meshes"][(1, 2, 2)]
        assert m["norm"] == [0, 1, 2, 3] and m["batch"] == [rank % 2, rank % 2 + 2]
        m = r["meshes"][(2, -1, 1)]
        assert m["batch"] == [0, 1, 2, 3] and m["sp"] == [rank] and m["norm"] == [rank // 2 * 2, rank // 2 * 2 + 1]


def test_shard_model_places_every_parameter(four_ranks):
    """(data 2, fsdp 2): replicated over data, dim 0 in torch.chunk pieces."""
    for rank, r in enumerate(four_ranks):
        placements = r["placements"]
        assert any(n.startswith("text.layers.") for n in placements)
        assert any(n.startswith("vision.blocks.") for n in placements)
        for name, (place, shape, local) in placements.items():
            assert place == "(Replicate(), Shard(dim=0))", name
            piece = len(np.array_split(np.arange(shape[0]), 2)[0]) if shape[0] % 2 else shape[0] // 2
            want = piece if rank % 2 == 0 else shape[0] - piece
            assert local == (want, *shape[1:]), (name, shape, local)


def test_shipped_3b_dotlist_runs_on_four_ranks(four_ranks):
    argv = _dotlist("spatialthinker_3b_grpo.sh") + ["trainer.n_chips=4"]
    assert tc.to_dict(tc.build_config(argv)) == jc.to_dict(jc.build_config(argv))
    for r in four_ranks:
        assert r["n_chips"] == 4 and r["config_mesh"] == (1, 4, 1)


def test_host_helpers(four_ranks):
    for rank, r in enumerate(four_ranks):
        want = np.concatenate([np.full((i + 1, 2), i) for i in range(4)])
        np.testing.assert_array_equal(r["gathered"], want)
        assert r["objects"] == [{"rank": i} for i in range(4)]
        assert r["rows"] == 9 and r["slice"] == (2 * rank, 2 * rank + 2)


def test_a_dtensor_is_refused_by_name_at_the_kernels(four_ranks):
    refusals = four_ranks[0]["refusals"]
    assert set(refusals) == {"flash", "decode", "w8a8", "silu"}
    for name, arg in (("flash", "q"), ("decode", "k_cache"), ("w8a8", "w"), ("silu", "gu")):
        assert refusals[name].startswith(f"{arg} is a sharded DTensor"), refusals[name]


def test_initialize_if_needed_raises():
    """A group that cannot come up raises (here: a launcher's WORLD_SIZE
    without its rendezvous address); JAX's ``initialize_if_needed`` would
    swallow it."""
    code = ("from spatialthinker_torch.parallel.multihost import initialize_if_needed as f\n"
            "f('cpu')")
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT")}
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=60, env={**env, "WORLD_SIZE": "2", "RANK": "0", "OMP_NUM_THREADS": "1"})
    assert done.returncode != 0 and "MASTER_ADDR" in done.stderr, done.stderr[-2000:]


def test_initialize_if_needed_without_a_launcher_is_one_process(monkeypatch):
    from spatialthinker_torch.parallel import multihost

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize_if_needed("cpu") is False
    assert multihost.world_size() == 1 and multihost.rank() == 0
    assert multihost.allgather_pyobj(5) == [5] and multihost.negotiate_row_count(3) == 3


@pytest.mark.parametrize("shuffle", [True, False])
def test_process_shard_takes_the_jax_loaders_rows(shuffle):
    ds = list(range(24))
    for i in range(3):
        ours = DataLoader(ds, 6, shuffle=shuffle, seed=4, process_shard=(i, 3))
        theirs = JaxDataLoader(ds, 6, shuffle=shuffle, seed=4, process_shard=(i, 3))
        for epoch in range(2):
            assert [list(ours._batch_indices(ours._order(), b)) for b in range(len(ours))] == \
                [list(theirs._batch_indices(theirs._order(), b)) for b in range(len(theirs))]
            ours.epoch += 1
            theirs.epoch += 1


@pytest.mark.parametrize("override", [
    "worker.actor.sharding.fsdp_size=4", "worker.ref.sharding.data_size=2",
    "worker.critic.sharding.fsdp_size=8", "trainer.nnodes=2", "trainer.n_chips=8",
    "worker.actor.ulysses_sequence_parallel_size=2",
])
def test_lifted_mesh_knobs_parse_as_the_jax_tree(override):
    assert tc.to_dict(tc.build_config([override])) == jc.to_dict(jc.build_config([override]))


def test_sequence_parallelism_on_the_model_axis_parses(tmp_path):
    argv = ["worker.actor.ulysses_sequence_parallel_size=2", "worker.actor.sharding.model_size=2",
            "worker.actor.sequence_parallel_backend=ring"]
    assert tc.to_dict(tc.build_config(argv)) == jc.to_dict(jc.build_config(argv))


@pytest.mark.parametrize("override", ["worker.actor.sharding.model_size=2",
                                      "worker.critic.sharding.model_size=4",
                                      "worker.rollout.tensor_parallel_size=2"])
def test_tensor_parallel_knobs_name_a13b(override):
    """The knobs of ROADMAP A13b are accepted beside the paged engine, as the
    JAX tree parses them (a TP rollout runs one paged engine a TP group)."""
    argv = ["worker.actor.sharding.model_size=2", "worker.rollout.name=continuous", override]
    assert tc.to_dict(tc.build_config(argv)) == jc.to_dict(jc.build_config(argv))


@pytest.mark.parametrize("override", ["worker.actor.sharding.data_size=0",
                                      "worker.actor.sharding.fsdp_size=-2",
                                      "worker.actor.sharding.model_size=-1"])
def test_nonpositive_mesh_sizes_raise(override):
    with pytest.raises(ValueError, match="positive"):
        tc.build_config([override])


@pytest.mark.parametrize("extra,world,local,match", [
    (["trainer.n_chips=2"], 4, 4, "n_chips=2 must equal the ranks on this node"),
    (["trainer.n_chips=4", "worker.actor.ulysses_sequence_parallel_size=2",
      "worker.actor.sharding.model_size=4", "worker.actor.sequence_parallel_backend=ring"],
     4, 4, "must equal sharding.model_size=4"),
    (["trainer.n_chips=4", "worker.actor.ulysses_sequence_parallel_size=4",
      "worker.actor.sharding.model_size=4"], 4, 4, "kv heads .2. must be divisible by sp=4"),
    (["trainer.n_chips=2", "worker.actor.ulysses_sequence_parallel_size=2",
      "worker.actor.sharding.model_size=2", "data.max_prompt_length=31"], 2, 2, "sequence length"),
    (["trainer.n_chips=3"], 3, 3, "rollout_batch_size=.* divisible by the 3 processes"),
    # tensor parallelism: JAX's kv-head cap (2 kv heads), and the rows split over the batch ranks only
    (["trainer.n_chips=4", "worker.actor.sharding.model_size=4", "worker.rollout.name=continuous"], 4, 4,
     "model_size=4 must divide the model's num_key_value_heads=2"),
    (["trainer.n_chips=6", "worker.actor.sharding.model_size=2", "worker.rollout.name=continuous"], 6, 6,
     "rollout_batch_size=8 must be divisible by the 3 processes that hold other rows"),
])
def test_mesh_checks_are_the_jax_trainers(extra, world, local, match):
    from spatialthinker_torch.trainer.grpo_trainer import mesh_checks

    cfg = tc.build_config(["data.rollout_batch_size=8", "data.max_response_length=8",
                           "data.max_prompt_length=32", *extra])
    with pytest.raises(ValueError, match=match):
        mesh_checks(cfg, 2, world, local)
