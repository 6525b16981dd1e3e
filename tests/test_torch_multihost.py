"""The trainer on several GPUs, held on the CPU: ranks as spawned gloo
processes (``tests/torch_dist_worker.py``), the JAX package in the pytest
process.

- ``train_step`` on 2 ranks (``fsdp_size=2``: the policy, the reference and
  the optimizer state sharded), each rank holding half of one precomputed
  rollout batch with unequal token counts (24 and 17 response tokens),
  against the JAX trainer's single-process step on the whole batch from the
  same weights: every metric outside timing and perf within 1e-4 (fp32 on
  both sides, other summation orders), the updated parameters in units of lr
  as ``tests/test_torch_train_step.py`` holds them; again with
  ``ref.offload``, with ``optim.stream``, with the KL in the reward (the
  adaptive controller reads the mean KL of all rows), with the critic (GAE,
  the JAX critic's weights carried over, the critic held in units of its lr
  too), and with sequence
  parallelism instead of FSDP (``model_size=2``, sp = 2, ring and Ulysses:
  the two ranks share their rows and split their sequence);
- greedy rollouts on 2 ranks, continuous and paged engines, against the JAX
  trainer's single-process rollout of the same prompts, token for token up
  to near-ties;
- checkpoints: saved by 2 ranks and resumed by one process, saved by one
  process and resumed by 2 ranks, parameters and moments bit for bit.
"""

import numpy as np
import pytest
import torch

from spatialthinker_tpu.core import config as jc
from spatialthinker_tpu.core.batch import RolloutBatch as JaxRolloutBatch
from spatialthinker_tpu.parallel.mesh import create_mesh
from spatialthinker_tpu.trainer.grpo_trainer import GRPOTrainer as JaxTrainer
from spatialthinker_torch.models.qwen2_5_vl import build_model, params_from_jax
from tests.test_torch_parity import CFG, JAX_CFG, VOCAB, both_models
from tests.test_torch_train_step import _params_close
from tests.test_torch_trainer import (
    CRITIC_LR, GAE, NOT_COMPARED, ROWS, _as, _dotlist, _precomputed_rollout, build,
)
from tests.torch_dist_worker import VOCAB as WORKER_VOCAB
from tests.torch_dist_worker import Ranks, reward_fn, run_ranks

import jax

LR = 1e-3
STEP_EXTRA = ["data.max_prompt_length=48", "data.min_pixels=3136", "data.max_pixels=12544",
              "worker.actor.micro_batch_size_per_device_for_update=8",
              "worker.rollout.temperature=0.9", "worker.actor.sharding.fsdp_size=2", "trainer.n_chips=2"]
KL_IN_REWARD = ["algorithm.use_kl_loss=false", "algorithm.kl_type=adaptive", "algorithm.kl_target=0.1",
                "algorithm.kl_horizon=100", "algorithm.kl_penalty=kl", "worker.actor.entropy_coeff=0.01"]
SP2 = ["worker.actor.sharding.fsdp_size=1", "worker.actor.sharding.model_size=2",
       "worker.actor.ulysses_sequence_parallel_size=2"]
# the critic's update in one micro-batch on both sides (its layout is per
# sample: JAX's global micro-batches are not the union of the ranks')
GAE_2 = GAE + ["worker.critic.micro_batch_size_per_device_for_update=8", "algorithm.gamma=0.99",
               "algorithm.lam=0.95"]
# name: (the ranks' extra knobs, the JAX trainer's): one process runs the
# sequence-parallel variants' function without sp
VARIANTS = {"resident": ([], []),
            "ref_offload": (["worker.ref.offload=true"],) * 2,
            "stream": (["worker.actor.optim.stream=true", "worker.actor.optim.strategy=adamw_bf16"],) * 2,
            "kl_in_reward": (KL_IN_REWARD,) * 2,
            "gae": (GAE_2, GAE_2),
            "sp2_ring": (SP2 + ["worker.actor.sequence_parallel_backend=ring"], []),
            "sp2_ulysses": (SP2 + ["worker.actor.sequence_parallel_backend=ulysses"], [])}


def test_worker_vocab_is_the_tests():
    assert WORKER_VOCAB == VOCAB


@pytest.fixture(scope="module")
def two_rank_steps(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("steps")
    _, model = both_models(seed=7)
    single = [d for d in STEP_EXTRA if "fsdp_size" not in d and "n_chips" not in d] + [
        "worker.actor.sharding.fsdp_size=1"]
    trainer, _ = build(tmp_path, *single, model=model)
    rolled = _precomputed_rollout(trainer, multimodal=True)
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    refs = {name: jax_trainer(tmp_path, single, extra, trainer.tokenizer, rolled)
            for name, (_, extra) in VARIANTS.items() if name == "gae"}
    critic = params_from_jax(jax.tree.map(np.asarray, refs["gae"].critic_params), CFG)
    payload = {"dotlist": _dotlist(tmp_path, *STEP_EXTRA), "rows": ROWS, "state": state,
               "variants": {name: port for name, (port, _) in VARIANTS.items()},
               "critic_state": {k: v.clone() for k, v in critic.items()},
               "rolled": {"tensors": rolled.tensors, "non_tensors": rolled.non_tensors}}
    ranks = Ranks("train_step", 2, tmp_path, payload, timeout=400)  # runs while JAX steps below
    want = {}
    for name, (_, extra) in VARIANTS.items():
        same = next((w for n, w in want.items() if VARIANTS[n][1] == extra), None)
        if same is not None:
            want[name] = same
            continue
        ref = refs.get(name) or jax_trainer(tmp_path, single, extra, trainer.tokenizer, rolled)
        metrics = ref.train_step(JaxRolloutBatch(tensors={"input_ids": np.zeros((4, 1), np.int32)}))
        want[name] = (metrics, ref.params, getattr(ref, "critic_params", None))
    return ranks.results(), want


def jax_trainer(tmp_path, single, extra, tokenizer, rolled):
    """The JAX trainer on one device, its rollout the precomputed one, its
    parameters a tree of its own (the JAX update donates what it is given)."""
    ref = JaxTrainer(jc.build_config(_dotlist(tmp_path, *single, *extra)), tokenizer, JAX_CFG,
                     both_models(seed=7)[0], train_dataloader=None, reward_fn=reward_fn,
                     mesh=create_mesh(1, 1, 1, devices=jax.devices()[:1]))
    ref.generate_sequences = lambda batch, sampling, key=None: _as(JaxRolloutBatch, rolled)
    ref.global_step = 1
    return ref


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_two_rank_train_step_matches_jax_single_process(two_rank_steps, variant):
    ranks, want = two_rank_steps
    jax_metrics, jax_params, jax_critic = want[variant]
    got = [r[variant] for r in ranks]
    assert got[0]["tokens"] != got[1]["tokens"]  # unequal token counts per rank (before sp shares them)
    keys = sorted(k for k in jax_metrics if not k.startswith(NOT_COMPARED))
    assert keys == sorted(k for k in got[0]["metrics"] if not k.startswith(NOT_COMPARED))
    for key in keys:
        for r in got:
            np.testing.assert_allclose(r["metrics"][key], jax_metrics[key], atol=1e-4, rtol=1e-4,
                                       err_msg=f"{variant} {key}")
    assert got[0]["metrics"]["reward/parity"] > 0

    for r in got:
        model = build_model(CFG, {k: torch.as_tensor(v) for k, v in r["params"].items()},
                            device="cpu", dtype=torch.float32)
        _params_close(model, jax_params, LR)
        if jax_critic is not None:
            assert r["metrics"]["critic/grad_norm"] > 0
            _params_close(_critic(r["critic"]), jax_critic, CRITIC_LR)


def _critic(state):
    from spatialthinker_torch.trainer.critic import Critic

    backbone = build_model(CFG, {k: torch.as_tensor(v) for k, v in state.items() if not k.startswith("value_head")},
                           device="cpu", dtype=torch.float32)
    critic = Critic(backbone, torch.Generator())
    critic.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return critic


# ---------------------------------------------------------------------------
# rollouts: each rank's engine on its own prompts against JAX's on all of them
# ---------------------------------------------------------------------------

ENGINES = {"continuous": ["worker.rollout.name=continuous", "worker.rollout.page_size=0"],
           "paged": ["worker.rollout.name=continuous", "worker.rollout.page_size=4"]}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_two_rank_greedy_rollouts_match_jax_single_process(tmp_path, engine):
    """Greedy rows of the two ranks (2 prompts x n 2 each, the policy
    gathered from its shards for the engine) against the JAX trainer's
    single-process rollout of the 4 prompts, token for token up to near-ties
    (``tests.test_torch_continuous.assert_same_up_to_ties``)."""
    from collections import namedtuple

    from spatialthinker_torch.core.batch import RolloutBatch
    from spatialthinker_torch.data.dataset import DataLoader
    from tests.test_torch_continuous import assert_same_up_to_ties

    jax_params, model = both_models(seed=4)
    extra = ENGINES[engine]
    trainer, _ = build(tmp_path, *extra, model=model)
    batch = next(iter(DataLoader(trainer.train_dataloader.dataset, 4, shuffle=False)))
    ref = JaxTrainer(jc.build_config(_dotlist(tmp_path, *extra)), trainer.tokenizer, JAX_CFG, jax_params,
                     train_dataloader=None, reward_fn=reward_fn,
                     mesh=create_mesh(1, 1, 1, devices=jax.devices()[:1]))
    want = ref.generate_sequences(_as(JaxRolloutBatch, batch), ref.sampling.override(temperature=0.0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    payload = {"dotlist": _dotlist(tmp_path, *extra, "worker.actor.sharding.fsdp_size=2", "trainer.n_chips=2"),
               "rows": ROWS, "state": state,
               "batch": {"tensors": batch.tensors, "non_tensors": batch.non_tensors}}
    ranks = run_ranks("rollout", 2, tmp_path, payload)
    Rows = namedtuple("Rows", "responses response_mask rollout_log_probs")
    got = Rows(*(np.concatenate([r[k] for r in ranks]) for k in Rows._fields))
    ref_rows = Rows(*(np.asarray(want.tensors[k]) for k in Rows._fields))
    assert got.responses.shape == ref_rows.responses.shape == (8, 8)
    assert assert_same_up_to_ties(got, ref_rows) <= 1


# ---------------------------------------------------------------------------
# checkpoints: saved at one world size, resumed at another
# ---------------------------------------------------------------------------


def _opt_arrays(state):
    return {k: ({n: np.asarray(t.float()) for n, t in v.items()} if isinstance(v, dict) else v)
            for k, v in state.items()}


def test_checkpoints_move_between_world_sizes(tmp_path):
    """A checkpoint saved by 2 ranks (rank 0 writes the whole tensors) loads
    into one process, and one saved by one process loads into 2 ranks: the
    parameters and moments after the load equal those at the save, bit for
    bit."""
    from spatialthinker_torch.parallel.sharding import full_state
    from tests.test_torch_trainer import _reward_fn

    _, model = both_models(seed=6)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    single_dir, duo_dir = tmp_path / "single", tmp_path / "duo"
    trainer, _ = build(tmp_path, f"trainer.save_checkpoint_path={single_dir}", "trainer.save_freq=1", model=model)
    trainer.reward_fn = _reward_fn
    rolled = _precomputed_rollout(trainer, multimodal=False)
    trainer.generate_sequences = lambda batch, sampling, generator=None: _as(type(rolled), rolled)
    trainer.global_step = 1
    trainer.train_step(type(rolled)(tensors={"input_ids": np.zeros((4, 1), np.int32)}))
    trainer.save_checkpoint()
    single = {"params": {k: v.numpy() for k, v in full_state(trainer.model).items()},
              "opt": _opt_arrays(trainer.optimizer.state)}

    payload = {"dotlist": _dotlist(tmp_path, "worker.actor.sharding.fsdp_size=2", "trainer.n_chips=2"),
               "rows": ROWS, "state": state, "save_dir": str(duo_dir),
               "load_dir": str(single_dir / "global_step_1"),
               "rolled": {"tensors": rolled.tensors, "non_tensors": rolled.non_tensors}}
    ranks = run_ranks("checkpoint", 2, tmp_path, payload)

    loaded = ranks[0]["loaded"]
    assert loaded["step"] == 1
    for a, b in ((loaded["params"], single["params"]), (loaded["opt"]["mu"], single["opt"]["mu"]),
                 (loaded["opt"]["nu"], single["opt"]["nu"])):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert loaded["opt"]["count"] == single["opt"]["count"] == 1

    resumed, _ = build(tmp_path, f"trainer.load_checkpoint_path={duo_dir}", model=both_models(seed=8)[1])
    resumed.load_checkpoint()
    saved = ranks[0]["saved"]
    assert resumed.global_step == 1 and resumed.optimizer.state["count"] == saved["opt"]["count"]
    for k, v in resumed.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), saved["params"][k], err_msg=k)
    for kind in ("mu", "nu"):
        for k, v in resumed.optimizer.state[kind].items():
            np.testing.assert_array_equal(v.float().numpy(), saved["opt"][kind][k], err_msg=k)
