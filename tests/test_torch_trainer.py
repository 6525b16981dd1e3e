"""The slice as a whole: the port's trainer entry point
(``spatialthinker_torch/trainer/{grpo_trainer,main,checkpoint}.py``) on the
tiny model with the synthetic tokenizer, on the CPU.

- two steps of ``GRPOTrainer.fit`` (mirrors ``tests/test_e2e_smoke.py``), with
  validation before training: the metric families a run logs, parameters that
  moved, a reference copy that did not;
- the shipped 3B script's own dotlist end to end (its engine knobs kept, its
  deploy-scale knobs cut): the paged engine with W8A8 weights, int4 pools and
  int8 dots, ``rollout/probs_diff_mean`` < 0.05 as the JAX package's smoke;
- ``train_step`` against the JAX trainer's, both trainers starting from the
  same weights, with ``generate_sequences`` replaced on both instances by one
  precomputed rollout batch and the same reward function: every metric outside
  ``timing_s/``, ``timing_per_token_ms/`` and ``perf/`` within 1e-4 (fp32 on
  both sides, other summation orders), updated parameters held in units of lr
  as ``tests/test_torch_train_step.py`` holds them (one Adam step);
- checkpoint save -> load into a freshly built trainer (the initial policy
  again, as a resumed run builds it) -> the same next step (metrics within 1e-6, parameters within 1% of lr: the
  same arithmetic on the same state);
- ``rloo`` with ``disable_kl``, ``use_rollout_log_probs``, ``remax``, KL in the
  reward with the adaptive controller, the dense engine over every cache
  format; ``main([...])`` on a jsonl file of text rows; the knobs the trainer
  rejects.
"""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

from spatialthinker_tpu.core import config as jc
from spatialthinker_tpu.core.batch import RolloutBatch as JaxRolloutBatch
from spatialthinker_tpu.parallel.mesh import create_mesh
from spatialthinker_tpu.trainer.grpo_trainer import GRPOTrainer as JaxTrainer
from spatialthinker_torch.core import config as tc
from spatialthinker_torch.core.batch import RolloutBatch
from spatialthinker_torch.data.dataset import DataLoader, RLHFDataset
from spatialthinker_torch.models.qwen2_5_vl import init_params
from spatialthinker_torch.models.qwen2_5_vl.params import trainer_state_from_jax
from spatialthinker_torch.trainer import main as tm
from tests.test_e2e_smoke import _script_dotlist
from tests.test_torch_parity import CFG, JAX_CFG, both_models, random_image
from tests.test_torch_train_step import _params_close

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
NOT_COMPARED = ("timing_s/", "timing_per_token_ms/", "perf/")
ROWS = [{"problem": f"What is {i} plus {i}? Image size: (100 x 100)", "answer": str(2 * i)}
        for i in range(8)]


def _dotlist(tmp_path, *extra):
    return [
        "data.max_prompt_length=32", "data.max_response_length=8", "data.rollout_batch_size=4",
        "data.num_workers=0", "worker.rollout.n=2", "worker.actor.global_batch_size=8",
        "worker.actor.micro_batch_size_per_device_for_update=1",
        "worker.actor.micro_batch_size_per_device_for_experience=2", f"worker.actor.optim.lr={LR}",
        "worker.actor.model.model_path=tiny", "worker.actor.model.tokenizer_path=synthetic",
        "worker.actor.model.param_dtype=float32", "worker.reward.score_function=r1v",
        "worker.actor.sharding.fsdp_size=1", "trainer.logger=['console']", "trainer.max_steps=2",
        "trainer.total_episodes=2", f"trainer.save_checkpoint_path={tmp_path}/ckpt", *extra,
    ]


def build(tmp_path, *extra, seed=0, rows=ROWS, val_rows=None, model=None):
    cfg = tc.build_config(_dotlist(tmp_path, *extra))
    if model is None:
        model = init_params(CFG, torch.Generator().manual_seed(seed), device="cpu", dtype=torch.float32)
    tok = tm.load_tokenizer(cfg.worker.actor.model.tokenizer_path, CFG)
    ds = RLHFDataset.from_rows(rows, tok, cfg.data, CFG)
    val = RLHFDataset.from_rows(val_rows, tok, cfg.data, CFG) if val_rows else None
    return tm.build_trainer(cfg, tok, model, ds, val), cfg


def _capture(trainer):
    logged = {}
    orig = trainer.tracker.log
    trainer.tracker.log = lambda data, step: (logged.setdefault(step, {}).update(data), orig(data, step))[1]
    return logged


def _sums(model):
    return [float(p.detach().double().sum()) for p in model.parameters()]


def test_fit_two_steps(tmp_path):
    trainer, cfg = build(tmp_path, "trainer.val_before_train=true", "trainer.logger=['console','jsonl']",
                         val_rows=ROWS[:3])
    before, ref_before = _sums(trainer.model), _sums(trainer.ref_model)
    logged = _capture(trainer)
    trainer.fit()
    assert trainer.global_step == 2 and trainer.optimizer.state["count"] == 2
    assert "val/reward_score" in logged[0] and "val/accuracy_reward" in logged[0]
    last = logged[2]
    for key in ("critic/score/mean", "actor/pg_loss", "actor/grad_norm", "actor/kl_loss",
                "response_length/mean", "perf/throughput", "perf/mfu_actor", "reward/overall",
                "critic/advantages/mean", "timing_s/gen", "timing_s/update_actor", "timing_s/reward",
                "timing_s/old", "timing_s/ref", "rollout/probs_diff_mean", "perf/max_memory_allocated_gb"):
        assert key in last and np.isfinite(last[key]), key
    assert last["rollout/probs_diff_mean"] < 1e-3  # same weights, bf16 cache against the fp32 forward
    assert _sums(trainer.model) != before and _sums(trainer.ref_model) == ref_before
    records = [json.loads(line) for line in
               open(f"{tmp_path}/ckpt/{cfg.trainer.experiment_name}_metrics.jsonl")]
    assert [r["step"] for r in records] == [0, 1, 2]
    assert not os.path.exists(f"{tmp_path}/ckpt/global_step_2")  # save_freq=-1


def test_flagship_script_dotlist_runs_e2e(tmp_path):
    """The shipped 3B script's dotlist with its deploy-scale knobs stripped as
    ``tests/test_e2e_smoke.py`` strips them; ``trainer.n_chips`` comes from
    ``scripts/config.yaml`` (4) and is cut to the one device there is."""
    dotlist = _script_dotlist("spatialthinker_3b_grpo.sh")
    keep = [
        d if not d.startswith("config=") else f"config={ROOT}/scripts/config.yaml" for d in dotlist
        if not d.startswith((
            "data.train_files", "data.val_files", "data.rollout_batch_size=",
            "data.max_prompt_length=", "data.max_response_length=",
            "worker.actor.model.model_path=", "worker.actor.global_batch_size=",
            "worker.actor.micro_batch_size", "worker.rollout.n=",
            "worker.rollout.max_num_batched_tokens=", "trainer.",
        ))
    ]
    with pytest.raises(ValueError, match="ROADMAP A13"):  # the yaml's n_chips=4 reaches the trainer
        build(tmp_path, *keep)
    trainer, cfg = build(tmp_path, *keep, "trainer.n_chips=1", "trainer.val_freq=-1", "trainer.save_freq=-1",
                         "trainer.val_before_train=false")
    roll = cfg.worker.rollout
    assert (roll.kv_cache_dtype, roll.quantization, roll.name, roll.page_size, roll.int4_i8dot) == (
        "int4", "int8", "continuous", 1024, True)
    assert roll.prefill_rows == 8 and cfg.worker.reward.score_function == "spatial_sgg"
    logged = _capture(trainer)
    trainer.fit()
    assert trainer.global_step == 2
    last = logged[2]
    for key in ("actor/pg_loss", "reward/overall", "reward/spatial_score", "rollout/probs_diff_mean",
                "rollout/kv_peak_pages", "rollout/kv_total_pages", "rollout/kv_preemptions"):
        assert key in last and np.isfinite(last[key]), key
    assert last["rollout/probs_diff_mean"] < 0.05  # the quantized engine tracks the training forward


# ---------------------------------------------------------------------------
# train_step against the JAX trainer
# ---------------------------------------------------------------------------


def _reward_fn(batch):
    """The same deterministic, non-constant reward for both trainers: a score
    from the response's token ids on its last valid token."""
    resp, mask = batch.tensors["responses"], batch.tensors["response_mask"]
    lengths = mask.sum(-1).astype(np.int64)
    score = ((resp * mask).sum(-1) % 7).astype(np.float32) / 7.0
    out = np.zeros(resp.shape, np.float32)
    out[np.arange(len(resp)), np.maximum(lengths - 1, 0)] = score
    return out, {"overall": score.tolist(), "parity": (score * 2).tolist()}


def _precomputed_rollout(trainer, multimodal):
    """One rollout batch from the port's own dense engine (prompts with and
    without images, ragged responses), as plain arrays."""
    rows = [dict(r) for r in ROWS[:4]]
    if multimodal:
        rows[0] = {**rows[0], "problem": "<image>" + rows[0]["problem"], "image": [random_image(0, 56, 56)]}
        rows[2] = {**rows[2], "problem": "<image>" + rows[2]["problem"], "image": [random_image(1, 56, 84)]}
    ds = RLHFDataset.from_rows(rows, trainer.tokenizer, trainer.config.data, CFG)
    batch = next(iter(DataLoader(ds, 4, shuffle=False)))
    batch.non_tensors["uid"] = np.array([f"prompt-{(3 * i) % 4}" for i in range(4)], dtype=object)
    rolled = trainer.generate_sequences(batch, trainer.sampling)
    mask = rolled.tensors["response_mask"].copy()
    for i, keep in enumerate((8, 3, 5, 8, 1, 8, 6, 2)):  # ragged lengths: the engine rarely samples EOS
        mask[i, keep:] = 0
    rolled.tensors["response_mask"] = mask
    rolled.tensors["responses"] = rolled.tensors["responses"] * mask
    rolled.tensors["rollout_log_probs"] = rolled.tensors["rollout_log_probs"] * mask
    p = rolled.tensors["input_ids"].shape[1]
    rolled.tensors["full_input_ids"][:, p:] = rolled.tensors["responses"]
    rolled.tensors["full_segment_ids"][:, p:] = mask
    return rolled


def _as(cls, rolled):
    return cls(tensors={k: np.array(v) for k, v in rolled.tensors.items()},
               non_tensors={k: v.copy() for k, v in rolled.non_tensors.items()}, meta=dict(rolled.meta))


@pytest.mark.parametrize("variant", ["kl_loss_multimodal", "kl_in_reward_text"])
def test_train_step_matches_jax_trainer(tmp_path, variant):
    multimodal = variant == "kl_loss_multimodal"
    extra = ["data.max_prompt_length=48", "data.min_pixels=3136", "data.max_pixels=12544",
             "worker.actor.micro_batch_size_per_device_for_update=2", "worker.rollout.temperature=0.9"]
    if not multimodal:
        extra += ["algorithm.use_kl_loss=false", "algorithm.kl_type=adaptive", "algorithm.kl_target=0.1",
                  "algorithm.kl_horizon=100", "algorithm.kl_penalty=kl", "worker.actor.entropy_coeff=0.01"]
    jax_params, model = both_models(seed=7)
    trainer, cfg = build(tmp_path, *extra, model=model)
    ref_cfg = jc.build_config([d for d in _dotlist(tmp_path, *extra)])
    assert tc.to_dict(cfg) == jc.to_dict(ref_cfg)
    ref = JaxTrainer(ref_cfg, trainer.tokenizer, JAX_CFG, jax_params, train_dataloader=None,
                     reward_fn=_reward_fn, mesh=create_mesh(1, 1, 1, devices=jax.devices()[:1]))
    trainer.reward_fn = _reward_fn
    rolled = _precomputed_rollout(trainer, multimodal)
    trainer.generate_sequences = lambda batch, sampling, generator=None: _as(RolloutBatch, rolled)
    ref.generate_sequences = lambda batch, sampling, key=None: _as(JaxRolloutBatch, rolled)
    prompts = RolloutBatch(tensors={"input_ids": np.zeros((4, 1), np.int32)})
    trainer.global_step = ref.global_step = 1
    got = trainer.train_step(prompts)
    want = ref.train_step(JaxRolloutBatch(tensors={"input_ids": np.zeros((4, 1), np.int32)}))

    keys = sorted(k for k in want if not k.startswith(NOT_COMPARED))
    assert keys == sorted(k for k in got if not k.startswith(NOT_COMPARED))
    assert {k for k in got if k.startswith(NOT_COMPARED)} == {k for k in want if k.startswith(NOT_COMPARED)}
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=1e-4, err_msg=key)
    assert got["reward/parity"] > 0 and abs(got["critic/advantages/max"]) > 0  # a real update
    assert ("actor/kl_loss" in got) == multimodal and ("actor/entropy_loss" in got) == (not multimodal)
    _params_close(trainer.model, ref.params, LR)
    assert trainer.kl_ctrl.kl_coef == pytest.approx(ref.kl_ctrl.kl_coef, rel=1e-5)
    if not multimodal:
        assert trainer.kl_ctrl.kl_coef != cfg.algorithm.kl_coef  # the adaptive controller moved


CONTINUOUS_W4A8 = ["worker.rollout.name=continuous", "worker.rollout.page_size=0",
                   "worker.rollout.quantization=w4a8", "worker.rollout.kv_cache_dtype=int4",
                   "worker.rollout.int4_i8dot=true"]


def test_train_step_continuous_w4a8_matches_jax_trainer(tmp_path, monkeypatch):
    """The slice as a whole: ``train_step`` with the continuous engine and the
    w4a8 rollout copy, generation included, against the JAX trainer on the
    same batch. The model is the tiny preset widened to E = 128, I = 256 so
    both int4 kernels engage (``tests/test_torch_int4_mlp.w4_configs``); 8
    rows through 16 lanes decode with the int4 MLP. Greedy rollouts on both
    sides (the frameworks' generators differ), the port's decode attention
    swapped for JAX's exact CPU fallback as ``tests/test_torch_continuous.py``
    does, JAX forced onto its int4 path off the TPU; each trainer quantizes
    its own weights at the rollout. Every metric outside timing and perf
    within 1e-4. The port's engine is held against JAX's by
    ``tests.test_torch_continuous.assert_same_up_to_ties`` (an activation on
    a rounding boundary may round one step apart in the two packages); the
    update then runs on JAX's rollout in both trainers, so such a step cannot
    move the metrics."""
    from spatialthinker_tpu.rollout import continuous as jcont
    from spatialthinker_torch.rollout import continuous as tcont
    from tests.test_torch_continuous import _w4a8_models, assert_same_up_to_ties
    from tests.test_torch_rollout import _exact_decode

    monkeypatch.setenv("SPATIALTHINKER_W4", "force")
    monkeypatch.setattr(tcont, "decode_attention", _exact_decode)
    jcfg, jax_params, model = _w4a8_models(seed=9)
    trainer, cfg = build(tmp_path, *CONTINUOUS_W4A8, model=model)
    assert (cfg.worker.rollout.name, cfg.worker.rollout.page_size, cfg.worker.rollout.quantization) == (
        "continuous", 0, "w4a8")
    ref_cfg = jc.build_config(_dotlist(tmp_path, *CONTINUOUS_W4A8))
    ref = JaxTrainer(ref_cfg, trainer.tokenizer, jcfg, jax_params, train_dataloader=None,
                     reward_fn=_reward_fn, mesh=create_mesh(1, 1, 1, devices=jax.devices()[:1]))
    trainer.reward_fn = _reward_fn
    trainer.sampling = trainer.sampling.override(temperature=0.0)
    ref.sampling = ref.sampling.override(temperature=0.0)
    engines, jax_results = [], []
    real_jax, real = jcont.generate_continuous, tcont.generate_continuous
    monkeypatch.setattr(jcont, "generate_continuous",
                        lambda *a, **k: jax_results.append(real_jax(*a, **k)) or jax_results[-1])

    def port_engine(*a, **k):
        engines.append(k)
        got = real(*a, **k)
        assert_same_up_to_ties(got, jax_results[-1])
        return got._replace(**{f: np.asarray(getattr(jax_results[-1], f))
                               for f in ("responses", "response_mask", "rollout_log_probs")})

    monkeypatch.setattr("spatialthinker_torch.trainer.grpo_trainer.generate_continuous", port_engine)
    batch = next(iter(DataLoader(trainer.train_dataloader.dataset, 4, shuffle=False)))
    trainer.global_step = ref.global_step = 1
    want = ref.train_step(_as(JaxRolloutBatch, batch))
    got = trainer.train_step(_as(RolloutBatch, batch))
    assert len(jax_results) == 1 and len(engines) == 1
    assert engines[0]["slots"] == 8 and engines[0]["kv_cache_dtype"] == torch.uint8
    keys = sorted(k for k in want if not k.startswith(NOT_COMPARED))
    assert keys == sorted(k for k in got if not k.startswith(NOT_COMPARED))
    assert not any(k.startswith("rollout/kv_") for k in got)  # no paged telemetry, as in JAX
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=1e-4, err_msg=key)
    assert got["reward/parity"] > 0 and "rollout/probs_diff_mean" in got


def test_trainer_state_from_jax_starts_both_trainers_alike(tmp_path):
    """The JAX trainer's numpy trees (parameters, moments, count, step) load
    into a port trainer that was built from other weights."""
    jax_params, model = both_models(seed=9)
    tree = jax.tree.map(np.asarray, jax_params)
    moments = jax.tree.map(lambda x: (x * 0.5).astype(np.float32), tree)
    state = trainer_state_from_jax(CFG, params=tree, mu=moments, nu=jax.tree.map(np.square, moments),
                                   count=3, step=5)
    trainer, _ = build(tmp_path, seed=1)
    assert _sums(trainer.model) != _sums(model)
    torch.save(state["params"], tmp_path / "params.pt")
    trainer.ckpt.save(state["step"], params=state["params"], opt_state=state["opt_state"],
                      dataloader_state={}, rng_state=None)
    trainer.config.trainer.load_checkpoint_path = f"{tmp_path}/ckpt"
    trainer.load_checkpoint()
    assert trainer.global_step == 5 and trainer.optimizer.state["count"] == 3
    assert _sums(trainer.model) == _sums(model)
    name = "text.norm.weight"
    torch.testing.assert_close(trainer.optimizer.state["mu"][name], 0.5 * dict(model.named_parameters())[name])


# ---------------------------------------------------------------------------
# checkpoints, variants, CLI, rejections
# ---------------------------------------------------------------------------


def test_checkpoint_save_load_same_next_step(tmp_path):
    a, _ = build(tmp_path, "trainer.max_steps=1", "trainer.save_freq=1", "trainer.save_limit=1", seed=0)
    a.reward_fn = _reward_fn
    a.fit()
    assert sorted(os.listdir(f"{tmp_path}/ckpt")) == ["global_step_1", "latest_global_step.txt"]
    # a resumed run builds its policy from the same model path: the reference
    # copy is that initial policy on both sides, the checkpoint brings the rest
    b, _ = build(tmp_path, f"trainer.load_checkpoint_path={tmp_path}/ckpt", seed=0)
    b.reward_fn = _reward_fn
    assert _sums(a.model) != _sums(b.model) and _sums(a.ref_model) == _sums(b.ref_model)
    b.load_checkpoint()
    assert b.global_step == 1 and b.optimizer.state["count"] == a.optimizer.state["count"] == 1
    assert _sums(a.model) == _sums(b.model)
    assert b.train_dataloader.state_dict() == a.train_dataloader.state_dict()
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    batch = next(iter(DataLoader(a.train_dataloader.dataset, 4, shuffle=False)))
    results = []
    for t in (a, b):
        t.global_step += 1
        results.append(t.train_step(copy.deepcopy(batch)))
    for key in results[0]:
        if not key.startswith(NOT_COMPARED):
            np.testing.assert_allclose(results[0][key], results[1][key], atol=1e-6, rtol=1e-6, err_msg=key)
    for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        torch.testing.assert_close(pa, pb, atol=0.01 * LR, rtol=0, msg=name)
    with pytest.raises(ValueError, match="optimizer state"):
        c, _ = build(tmp_path, f"trainer.load_checkpoint_path={tmp_path}/ckpt",
                     "worker.actor.optim.strategy=adamw_bf16")
        c.load_checkpoint()


def test_frozen_vision_tower_on_the_packed_update(tmp_path):
    """``freeze_vision_tower`` on the default packed update: the tower keeps
    its values (weight decay included), and every Adam moment a step uses
    exists from the trainer's construction on, before the page pool is sized
    from free memory: a step allocates none."""
    trainer, _ = build(tmp_path, "worker.actor.model.freeze_vision_tower=true")
    assert trainer.padding_free
    moments = set(trainer.optimizer.state["mu"])
    assert moments and not any(k.startswith("vision.") for k in moments)
    vision = {k: v.clone() for k, v in trainer.model.state_dict().items() if k.startswith("vision.")}
    text = {k: v.clone() for k, v in trainer.model.state_dict().items() if k.startswith("text.")}
    trainer.reward_fn = _reward_fn
    trainer.train_step(next(iter(trainer.train_dataloader)))
    assert set(trainer.optimizer.state["mu"]) == moments and trainer.optimizer.state["count"] == 1
    after = trainer.model.state_dict()
    assert vision and all(torch.equal(after[k], v) for k, v in vision.items())
    assert any(not torch.equal(after[k], v) for k, v in text.items())


@pytest.mark.parametrize("variant", ["rloo_disable_kl", "use_rollout_log_probs", "remax", "reinforce_unpacked"])
def test_train_step_variants(tmp_path, variant):
    extra = {
        "rloo_disable_kl": ["algorithm.adv_estimator=rloo", "algorithm.disable_kl=true"],
        "use_rollout_log_probs": ["worker.rollout.use_rollout_log_probs=true"],
        "remax": ["algorithm.adv_estimator=remax"],
        "reinforce_unpacked": ["algorithm.adv_estimator=reinforce_plus_plus", "worker.actor.padding_free=false",
                               "worker.actor.micro_batch_size_per_device_for_update=4"],
    }[variant]
    trainer, _ = build(tmp_path, *extra)
    trainer.reward_fn = _reward_fn
    metrics = trainer.train_step(next(iter(trainer.train_dataloader)))
    assert np.isfinite(metrics["actor/pg_loss"]) and np.isfinite(metrics["actor/grad_norm"])
    if variant == "rloo_disable_kl":
        assert trainer.ref_model is None and "actor/kl_loss" not in metrics and "timing_s/ref" not in metrics
    else:
        assert "actor/kl_loss" in metrics
    if variant == "use_rollout_log_probs":
        assert metrics["timing_s/old"] < metrics["timing_s/gen"] and "rollout/probs_diff_mean" not in metrics
    else:
        assert "rollout/probs_diff_mean" in metrics
    assert ("timing_s/gen_baseline" in metrics) == (variant == "remax")


@pytest.mark.parametrize("kv,i8dot,prefill_rows", [("bfloat16", False, 0), ("int8", False, 2), ("int4", False, 0),
                                                   ("int4", True, 2)])
def test_dense_engine_knobs_through_generate_sequences(tmp_path, kv, i8dot, prefill_rows):
    """``rollout.name=jax`` (the default) with every cache format: the knobs
    reach the engine, and the engine's log-probs stay near the trainer's own."""
    trainer, cfg = build(tmp_path, f"worker.rollout.kv_cache_dtype={kv}", f"worker.rollout.int4_i8dot={i8dot}",
                         f"worker.rollout.prefill_rows={prefill_rows}", "worker.rollout.quantization=int8")
    assert cfg.worker.rollout.name == "jax"
    rolled = trainer.generate_sequences(next(iter(trainer.train_dataloader)), trainer.sampling)
    assert rolled.tensors["responses"].shape == (8, 8) and rolled.tensors["full_input_ids"].shape[1] == 40
    assert list(rolled.non_tensors["problem"][:2]) == [rolled.non_tensors["problem"][0]] * 2  # [p0 x n, p1 x n]
    old = trainer.compute_log_probs_batched(rolled, trainer.model)
    mask = rolled.tensors["response_mask"].astype(bool)
    assert np.abs(old - rolled.tensors["rollout_log_probs"])[mask].mean() < 0.05
    assert trainer._last_rollout_stats == {}  # no paged telemetry on the dense engine


def test_main_on_a_jsonl_file(tmp_path, monkeypatch):
    path = tmp_path / "train.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in ROWS))
    monkeypatch.setenv("SPATIALTHINKER_PLATFORM", "cpu")
    tm.main(_dotlist(tmp_path, f"data.train_files={path}", f"data.val_files={path}", "data.val_batch_size=4",
                     "trainer.val_before_train=true", "trainer.save_freq=2",
                     "trainer.logger=['console','jsonl']", "trainer.experiment_name=cli"))
    assert sorted(os.listdir(f"{tmp_path}/ckpt")) == ["cli_metrics.jsonl", "global_step_2",
                                                      "latest_global_step.txt"]
    assert sorted(os.listdir(f"{tmp_path}/ckpt/global_step_2")) == ["extra_state.pkl", "opt_state.pt",
                                                                   "params.pt"]
    records = [json.loads(line) for line in open(f"{tmp_path}/ckpt/cli_metrics.jsonl")]
    assert [r["step"] for r in records] == [0, 1, 2] and "val/reward_score" in records[0]
    for family in ("actor/", "critic/score/", "reward/", "timing_s/", "perf/"):
        assert any(k.startswith(family) for k in records[2]), family
    monkeypatch.delenv("SPATIALTHINKER_PLATFORM")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.run_device()
    monkeypatch.setenv("SPATIALTHINKER_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="SPATIALTHINKER_PLATFORM"):
        tm.run_device()


@pytest.mark.parametrize("extra,match", [
    (["trainer.n_chips=2"], "ROADMAP A13"),
    (["algorithm.adv_estimator=gae"], "ROADMAP A10"),
    (["worker.rollout.n=1"], "needs worker.rollout.n > 1"),
    (["worker.actor.global_batch_size=3"], "must be divisible"),
])
def test_trainer_rejects_what_it_cannot_run(tmp_path, extra, match):
    with pytest.raises(ValueError, match=match):
        build(tmp_path, *extra)
