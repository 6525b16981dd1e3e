"""The runner of a ``train_phase`` mix: the training phase of GRPO steps
through ``GRPOTrainer.train_step``, the rollout answered from the made units.

Set-up builds the trainer once (the seed's weights, made by the benchmark on
the card), answers ``generate_sequences`` and ``reward_fn`` on the instance
from the generator's units, and drives the same trainer through the first
``REFERENCE_STEPS`` steps (the warm-up: every phase and shape of the cell
runs there), recording what the program produced. The window then runs whole
units back to back. After it, with ``--trace 1``, one more unit runs under the
profiler. Then the program is freed and the plain reference follows the
recorded steps from the seed.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, generator
from .reference.grpo import follow
from .trace import Spans, summarize
from .weights import make_weights

# The followed steps, the same in every cell: the comparison reads the first
# gradient after step 1, and the reference log-probs, the KL term and Adam's
# moments only differ from the old ones from step 2; every limit is set at 2.
REFERENCE_STEPS = 2


def build_program(cfg: dict, seed: int, device):
    """The trainer of the cell: the configuration's dotlist, the seed's weights."""
    from spatialthinker_torch.core.config import build_config
    from spatialthinker_torch.models.qwen2_5_vl import get_config
    from spatialthinker_torch.models.qwen2_5_vl.params import build_model
    from spatialthinker_torch.trainer.grpo_trainer import GRPOTrainer
    from spatialthinker_torch.utils.synthetic_tokenizer import QwenSyntheticTokenizer

    config = build_config(list(cfg["dotlist"]))
    arch = get_config(cfg["preset"])
    _check_arch(cfg["model"], arch)
    _check_training(cfg["training"], config)
    state = make_weights(cfg["model"], seed, device)
    model = build_model(arch, state, device=device, dtype=getattr(torch, cfg["training"]["param_dtype"]))
    del state
    trainer = GRPOTrainer(config=config, tokenizer=QwenSyntheticTokenizer(model.cfg), model=model,
                          train_dataloader=[], reward_fn=None)
    opt = trainer.optimizer
    if (opt.b1, opt.b2, opt.eps) != (*cfg["training"]["betas"], cfg["training"]["eps"]):
        raise ValueError(f"optimizer constants {(opt.b1, opt.b2, opt.eps)} differ from the configuration's")
    return trainer


def _check_arch(m: dict, arch) -> None:
    t, v = arch.text, arch.vision
    vc = m["vision_config"]
    pairs = {
        "hidden_size": t.hidden_size, "intermediate_size": t.intermediate_size,
        "num_hidden_layers": t.num_hidden_layers, "num_attention_heads": t.num_attention_heads,
        "num_key_value_heads": t.num_key_value_heads, "vocab_size": t.vocab_size,
        "rms_norm_eps": t.rms_norm_eps, "rope_theta": t.rope_theta,
        "tie_word_embeddings": t.tie_word_embeddings, "image_token_id": arch.image_token_id,
        "vision_start_token_id": arch.vision_start_token_id, "eos_token_id": arch.eos_token_id,
        "vision_config.depth": v.depth, "vision_config.hidden_size": v.hidden_size,
        "vision_config.intermediate_size": v.intermediate_size, "vision_config.num_heads": v.num_heads,
        "vision_config.out_hidden_size": v.out_hidden_size, "vision_config.window_size": v.window_size,
        "vision_config.patch_size": v.patch_size,
    }
    for key, got in pairs.items():
        want = vc[key.split(".", 1)[1]] if key.startswith("vision_config.") else m[key]
        if want != got:
            raise ValueError(f"the program's preset has {key}={got}, the configuration {want}")
    if list(m["rope_scaling"]["mrope_section"]) != list(t.mrope_section) or \
            list(vc["fullatt_block_indexes"]) != list(v.fullatt_block_indexes):
        raise ValueError("the program's preset differs from the configuration (mrope / full blocks)")


def _check_training(want: dict, config) -> None:
    a = config.worker.actor
    got = {
        "lr": a.optim.lr, "weight_decay": a.optim.weight_decay, "strategy": a.optim.strategy,
        "betas": list(a.optim.betas), "max_grad_norm": a.max_grad_norm,
        "clip_ratio_low": a.clip_ratio_low, "clip_ratio_high": a.clip_ratio_high,
        "clip_ratio_dual": a.clip_ratio_dual, "use_kl_loss": config.algorithm.use_kl_loss,
        "kl_loss_coef": a.kl_loss_coef, "kl_penalty": a.kl_penalty,
        "temperature": config.worker.rollout.temperature, "param_dtype": a.model.param_dtype,
        "freeze_vision_tower": a.model.freeze_vision_tower,
    }
    for key, value in got.items():
        if want[key] != value:
            raise ValueError(f"the program's {key} is {value!r}, the configuration's {want[key]!r}")


class Traffic:
    """The made units, and the trainer's rollout and reward answered from them."""

    def __init__(self, cfg: dict, mix: dict, seed: int, trainer):
        from spatialthinker_torch.core.batch import RolloutBatch, trim_prompt_padding

        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.units: Dict[int, generator.Unit] = {}
        self._batch, self._trim = RolloutBatch, trim_prompt_padding
        self.width = trainer.config.data.max_prompt_length
        self.resp_width = trainer.config.data.max_response_length
        self.pad = trainer.model_cfg.pad_token_id
        trainer.generate_sequences = self.generate
        trainer.reward_fn = self.reward

    def unit(self, index: int) -> generator.Unit:
        if index not in self.units:
            self.units[index] = generator.make_unit(self.cfg, self.mix, self.seed, index)
        return self.units[index]

    def prompt_batch(self, index: int):
        u = self.unit(index)
        obj = np.empty(len(u.prompts), dtype=object)
        grids = np.empty(len(u.prompts), dtype=object)
        for i, p in enumerate(u.prompts):
            obj[i], grids[i] = p.patches, p.grid
        return self._batch(tensors=generator.prompt_arrays(u, self.width, self.pad),
                           non_tensors={"patches": obj, "image_grid_thw": grids}, meta={"unit": index})

    def generate(self, batch, sampling, generator_=None):
        u = self.unit(batch.meta["unit"])
        base = self._trim(batch)
        rep = base.repeat(u.n, interleave=True) if u.n > 1 else base
        responses, mask = generator.response_arrays(u, self.resp_width)
        return self._batch(
            tensors={**rep.tensors, "responses": responses, "response_mask": mask,
                     "full_input_ids": np.concatenate([rep.tensors["input_ids"], responses], 1),
                     "full_segment_ids": np.concatenate([rep.tensors["segment_ids"], mask], 1)},
            non_tensors={**rep.non_tensors, "sample": u.sample_ids.copy()}, meta=dict(batch.meta))

    def reward(self, rolled):
        u = self.unit(rolled.meta["unit"])
        scores = u.scores[rolled.non_tensors["sample"].astype(np.int64) - u.sample_ids[0]]
        mask = rolled.tensors["response_mask"]
        out = np.zeros(mask.shape, np.float32)
        last = mask.sum(-1).astype(np.int64) - 1
        out[np.arange(len(out)), last] = scores
        return out, {"overall": scores.tolist()}


class Recorder:
    """What the program produced in the followed steps, read around its calls."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.batches: List = []
        self.packed: List[List[tuple]] = []
        inner_update, inner_packed = trainer.update_actor, trainer.packed_update_fn
        self._inner_packed = inner_packed

        def update_actor(batch):
            t = batch.tensors
            self.batches.append({k: np.array(t[k]) for k in ("old_log_probs", "ref_log_probs", "advantages",
                                                            "response_mask")}
                                | {"sample": np.array(batch.non_tensors["sample"])})
            self.packed.append([])
            return inner_update(batch)

        def packed_update(micro, vision=None):
            self.packed[-1].append(tuple(x.detach().cpu().numpy() for x in
                                         (micro.labels, micro.loss_mask, micro.segment_ids)))
            return inner_packed(micro, vision)

        trainer.update_actor = update_actor
        trainer.packed_update_fn = packed_update

    def remove(self) -> None:
        del self.trainer.update_actor  # the class's method again
        self.trainer.packed_update_fn = self._inner_packed

    def step_record(self, k: int, unit: generator.Unit, metrics: dict) -> dict:
        b = self.batches[k]
        pos = b["sample"].astype(np.int64) - unit.sample_ids[0]
        lengths = b["response_mask"].sum(-1).astype(np.int64)
        old, ref, adv = [None] * len(unit.responses), [None] * len(unit.responses), [0.0] * len(unit.responses)
        for row, s in enumerate(pos):
            old[s] = b["old_log_probs"][row, :lengths[row]].astype(np.float64)
            ref[s] = b["ref_log_probs"][row, :lengths[row]].astype(np.float64)
            adv[s] = float(b["advantages"][row, 0])
        return {"old": old, "ref": ref, "adv": adv, "loss": float(metrics["actor/loss"]),
                "grad_norm": float(metrics["actor/grad_norm"])}


def _dotlist_int(cfg: dict, key: str) -> int:
    """A whole-number knob as the configuration's dotlist sets it."""
    values = [d.split("=", 1)[1] for d in cfg["dotlist"] if d.split("=", 1)[0] == key]
    if len(values) != 1:
        raise ValueError(f"the configuration sets {key} {len(values)} times, not once")
    return int(values[0])


def _first_gradient(model: dict, trainer) -> Dict[str, float]:
    """Per-leaf norms of the first gradient as the optimizer got it: its
    first moment after one step is (1 - beta1) times that gradient (zero
    where the step did not happen)."""
    opt = trainer.optimizer
    return check.leaf_norms(model, opt.state["mu"].items(), scale=1.0 / (1.0 - opt.b1))


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault: Optional[Callable] = None, window: bool = True, controls: tuple = ()) -> dict:
    """One run of a train_phase cell. Returns the result's parts: end-to-end
    numbers, the data the per-layer readers read, and the checks. ``fault``
    (``faults.py``) breaks the built trainer underneath the run; ``window``
    False runs only the followed steps and the check; ``controls`` names
    precisions of the reference to put in the program's place as well."""
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    check_s = 0.0  # time spent on the check inside set-up, left out of setup_s

    trainer = build_program(cfg, seed, device)
    traffic = Traffic(cfg, mix, seed, trainer)
    if fault is not None:
        fault(trainer)
    rec = Recorder(trainer)
    n_ref = REFERENCE_STEPS
    prog_steps, step_s = [], []
    first_grad = None
    for k in range(n_ref):
        trainer.global_step += 1
        t0 = time.perf_counter()
        metrics = trainer.train_step(traffic.prompt_batch(k))
        step_s.append(time.perf_counter() - t0)
        c0 = time.perf_counter()
        prog_steps.append(rec.step_record(k, traffic.unit(k), metrics))
        if k == 0:
            first_grad = _first_gradient(cfg["model"], trainer)
        check_s += time.perf_counter() - c0
    c0 = time.perf_counter()
    start = make_weights(cfg["model"], seed, device)
    change = check.leaf_norms(cfg["model"], trainer.model.named_parameters(), minus=start)
    del start
    micro_rows = _dotlist_int(cfg, "worker.actor.micro_batch_size_per_device_for_update")
    partitions = [check.read_partition(p, traffic.unit(k).responses, traffic.unit(k).totals(), micro_rows)
                  for k, p in enumerate(rec.packed)]
    if any(len(p) != 1 for p in rec.packed):
        raise ValueError("a followed step made more than one optimizer step")
    rec.remove()
    sync()
    check_s += time.perf_counter() - c0

    # the window's units, made now: the longest step so far bounds how many fit
    n_cap = int(seconds / max(min(step_s), 1e-3)) + 2
    for k in range(n_ref, n_ref + n_cap + int(trace)):
        traffic.unit(k)
    setup_s = time.perf_counter() - t_start - check_s

    units, tokens, metrics_w = [], 0, []
    window_s = 0.0
    if window:
        t0 = time.perf_counter()
        k = n_ref
        while True:
            trainer.global_step += 1
            metrics_w.append(trainer.train_step(traffic.prompt_batch(k)))
            units.append(traffic.unit(k))
            k += 1
            window_s = time.perf_counter() - t0
            if window_s + window_s / len(units) > seconds:
                break
        tokens = sum(u.tokens() for u in units)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    failed = sum(not np.isfinite(m.get("actor/loss", np.nan)) for m in metrics_w)

    summary, traced_unit = None, None
    if trace and window:
        traced_unit = traffic.unit(n_ref + len(units))
        summary = _traced_unit(trainer, traffic, n_ref + len(units), on_card)

    prog = {"steps": prog_steps, "first_grad": first_grad, "change": change,
            "unmatched": sum(p["unmatched"] for p in partitions),
            "split": sum(p["split"] for p in partitions)}
    ref_units = [traffic.unit(k) for k in range(n_ref)]
    del trainer, traffic, rec
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = follow(cfg["model"], cfg["training"], seed, ref_units, partitions, device)
    reference_s = time.perf_counter() - t0
    numbers = check.compare(prog, ref)
    worst = check.worst_leaves(prog, ref)
    control_numbers, control_worst = {}, {}
    for p in controls:
        record = follow(cfg["model"], cfg["training"], seed, ref_units, partitions, device, precision=p)
        control_numbers[p], control_worst[p] = check.compare(record, ref), check.worst_leaves(record, ref)
    return {
        "setup_s": setup_s, "window_s": window_s, "tokens": tokens, "units": units,
        "unit_metrics": metrics_w, "attempted": len(units), "failed": int(failed),
        "memory_peak_bytes": int(peak), "trace": summary, "traced_unit": traced_unit,
        "numbers": numbers, "worst": worst, "control_numbers": control_numbers,
        "control_worst": control_worst, "reference_s": reference_s, "step_s": step_s,
    }


def _traced_unit(trainer, traffic, index: int, on_card: bool) -> Optional[dict]:
    """One more unit under the profiler, its phases marked."""
    spans = Spans()
    for method, phase in (("generate_sequences", "gen"), ("reward_fn", "reward"),
                          ("compute_log_probs_batched", "log_probs"), ("ref_policy", "ref_restore"),
                          ("compute_advantages", "adv"), ("update_actor", "update")):
        spans.wrap(trainer, method, phase)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    batch = traffic.prompt_batch(index)
    trainer.global_step += 1
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function("bench.unit"):
            trainer.train_step(batch)
    spans.remove()
    return summarize(prof)
