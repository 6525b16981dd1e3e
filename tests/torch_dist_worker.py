"""Ranks of the port's multi-process CPU tests: ``run_ranks`` starts one
process per rank, each a gloo rank of one process group (a file store in the
test's ``tmp_path``, no port), running one task of ``TASKS`` on the payload
the test wrote. Every process has a timeout, so a rank that hangs in a
collective fails the test instead of blocking it.

The ranks import torch and the port only (never JAX); the tests hold what
they return against the JAX package in the pytest process."""

import os
import pickle
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 1024


class Ranks:
    """``world`` gloo ranks running ``task``, started and not yet waited for:
    the test does its own work meanwhile, then calls ``results``."""

    def __init__(self, task: str, world: int, tmp_path, payload=None, timeout: float = 240.0):
        tag = f"{task}_{world}_{time.monotonic_ns()}"
        args = tmp_path / f"{tag}.in"
        args.write_bytes(pickle.dumps(payload))
        self.task, self.outs = task, [tmp_path / f"{tag}.{r}.out" for r in range(world)]
        env = {**os.environ, "OMP_NUM_THREADS": "1", "SPATIALTHINKER_PLATFORM": "cpu"}
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), task, str(r), str(world),
             str(tmp_path / f"{tag}.store"), str(args), str(self.outs[r])],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
        self.deadline = time.monotonic() + timeout

    def results(self):
        """Every rank's result in rank order; a rank that fails or outlives
        the timeout fails the test (and every rank is stopped)."""
        logs = []
        try:
            for p in self.procs:
                out, _ = p.communicate(timeout=max(self.deadline - time.monotonic(), 1.0))
                logs.append(out.decode(errors="replace"))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            assert p.returncode == 0, f"rank {r} of {self.task} exited {p.returncode}\n{log[-6000:]}"
        return [pickle.loads(o.read_bytes()) for o in self.outs]


def run_ranks(task: str, world: int, tmp_path, payload=None, timeout: float = 240.0):
    """Run ``task`` on ``world`` gloo ranks; returns their results in rank order."""
    return Ranks(task, world, tmp_path, payload, timeout).results()


def reward_fn(batch):
    """A deterministic, non-constant reward (the test trainer's): a score from
    the response's token ids on its last valid token."""
    import numpy as np

    resp, mask = batch.tensors["responses"], batch.tensors["response_mask"]
    lengths = mask.sum(-1).astype(np.int64)
    score = ((resp * mask).sum(-1) % 7).astype(np.float32) / 7.0
    out = np.zeros(resp.shape, np.float32)
    out[np.arange(len(resp)), np.maximum(lengths - 1, 0)] = score
    return out, {"overall": score.tolist(), "parity": (score * 2).tolist()}


# ---------------------------------------------------------------------------
# tasks: task(payload) -> result (pickled back to the test)
# ---------------------------------------------------------------------------


def _attention_task(backend: str):
    def task(p):
        import torch
        import torch.distributed as dist

        from spatialthinker_torch.ops import ring, ulysses

        spec = ulysses.UlyssesSpec(dist.group.WORLD, backend=backend)
        fn = ring.ring_attention if backend == "ring" else ulysses.ulysses_attention
        results = []
        for case in p["cases"]:
            q, k, v, seg, do = (torch.as_tensor(case[n]) for n in ("q", "k", "v", "seg", "do"))
            try:
                ql, kl, vl = (ulysses.seq_chunk(t, spec).clone().requires_grad_() for t in (q, k, v))
                out = fn(ql, kl, vl, spec, segment_ids=ulysses.seq_chunk(seg, spec), causal=case["causal"])
                out.backward(ulysses.seq_chunk(do, spec))
            except ValueError as e:
                results.append({"error": str(e)})
                continue
            results.append({n: t.detach().numpy() for n, t in
                            (("out", out), ("dq", ql.grad), ("dk", kl.grad), ("dv", vl.grad))})
        return results
    return task


def _model(p):
    import torch

    from spatialthinker_torch.models.qwen2_5_vl import build_model, qwen25_vl_tiny

    return build_model(qwen25_vl_tiny(VOCAB), p["state"], device="cpu", dtype=torch.float32)


def task_logprobs(p):
    """sp = world log-probs (packed and per-sample) on the same rows."""
    import torch
    import torch.distributed as dist

    from spatialthinker_torch.models.qwen2_5_vl.model import vision_to_device
    from spatialthinker_torch.ops.ulysses import UlyssesSpec
    from spatialthinker_torch.trainer.train_step import (
        PackedTrainBatch, TrainBatch, compute_log_probs, compute_packed_log_probs,
    )

    model = _model(p)
    spec = UlyssesSpec(dist.group.WORLD, backend=p["backend"])
    out = {}
    with torch.no_grad():
        if "packed" in p:
            batch = PackedTrainBatch(*(torch.as_tensor(x) for x in p["packed"]))
            vision = vision_to_device(p.get("packed_vision"), "cpu")
            out["packed"] = model(compute_packed_log_probs, batch, vision, sp=spec,
                                  chunk_size=4)[0].numpy()
        if "train" in p:
            batch = TrainBatch(*(torch.as_tensor(x) for x in p["train"]))
            vision = vision_to_device(p.get("train_vision"), "cpu")
            out["train"] = model(compute_log_probs, batch, vision, sp=spec, chunk_size=4)[0].numpy()
    return out


def _trainer(p, extra=()):
    from spatialthinker_torch.core import config as tc
    from spatialthinker_torch.data.dataset import RLHFDataset
    from spatialthinker_torch.models.qwen2_5_vl import qwen25_vl_tiny
    from spatialthinker_torch.trainer import main as tm

    cfg = tc.build_config(list(p["dotlist"]) + list(extra))
    tok = tm.load_tokenizer("synthetic", qwen25_vl_tiny(VOCAB))
    ds = RLHFDataset.from_rows(p["rows"], tok, cfg.data, qwen25_vl_tiny(VOCAB))
    return tm.build_trainer(cfg, tok, _model(p), ds), cfg


def _full_params(trainer):
    from spatialthinker_torch.parallel.sharding import full_state

    return {k: v.numpy() for k, v in full_state(trainer.model).items()}


def _rank_rows(rolled, trainer=None):
    """This rank's rows of a rollout batch given as its tensors and
    non-tensors: a slice by rank, or under tensor parallelism by the
    trainer's batch index (a TP group holds the same rows)."""
    import numpy as np
    import torch.distributed as dist

    from spatialthinker_torch.core.batch import RolloutBatch

    index, ranks = dist.get_rank(), dist.get_world_size()
    if trainer is not None and trainer.tp is not None:
        index, ranks = trainer.batch_index, trainer.batch_ranks
    n = len(rolled["tensors"]["responses"]) // ranks
    rows = slice(index * n, (index + 1) * n)
    return RolloutBatch(tensors={k: np.array(v[rows]) for k, v in rolled["tensors"].items()},
                        non_tensors={k: v[rows].copy() for k, v in rolled["non_tensors"].items()})


def task_train_step(p):
    """One ``train_step`` per variant on this rank's rows of one precomputed
    rollout batch: metrics, the updated parameters, what stayed resident."""
    import numpy as np
    import torch

    from spatialthinker_torch.core.batch import RolloutBatch
    from spatialthinker_torch.parallel.sharding import full_state, local, local_piece

    results = {}
    for name, extra in p["variants"].items():
        trainer, _ = _trainer(p, extra)
        trainer.reward_fn = reward_fn
        if trainer.critic is not None:  # the JAX critic's weights, this rank's pieces
            with torch.no_grad():
                for n, t in trainer.critic.named_parameters():
                    local(t).copy_(local_piece(p["critic_state"][n], t, n, trainer.tp))
        mine = _rank_rows(p["rolled"], trainer)
        trainer.generate_sequences = lambda batch, sampling, generator=None: mine.select(slice(None))
        trainer.global_step = 1
        metrics = trainer.train_step(RolloutBatch(tensors={"input_ids": np.zeros((len(mine) // 2, 1), np.int32)}))
        results[name] = {"metrics": metrics, "params": _full_params(trainer),
                         "tokens": float(mine.tensors["response_mask"].sum())}
        if trainer.critic is not None:
            results[name]["critic"] = {k: v.numpy() for k, v in full_state(trainer.critic).items()}
    return results


def task_rollout(p):
    """This rank's share of the prompts (by rank, or under tensor parallelism
    by batch index: a TP group shares them) through the trainer's greedy
    rollout, with the bytes of its rollout copy."""
    import numpy as np
    import torch.distributed as dist

    from spatialthinker_torch.core.batch import RolloutBatch

    trainer, _ = _trainer(p)
    rank, world = dist.get_rank(), dist.get_world_size()
    if trainer.tp is not None:  # a TP group shares its prompts
        rank, world = trainer.batch_index, trainer.batch_ranks
    batch = RolloutBatch(**p["batch"])
    n = len(batch) // world
    rolled = trainer.generate_sequences(batch.select(slice(rank * n, (rank + 1) * n)),
                                        trainer.sampling.override(temperature=0.0))
    out = {k: np.asarray(rolled.tensors[k]) for k in ("responses", "response_mask", "rollout_log_probs")}
    out["batch_index"], out["copy_bytes"] = trainer.batch_index, trainer.rollout_copy_bytes
    return out


def _opt_state(trainer):
    """The optimizer state, every moment whole (rank 0's)."""
    state = trainer._full_opt_state(trainer.optimizer.state, trainer.model)
    return {k: ({n: t.float().numpy() for n, t in v.items()} if isinstance(v, dict) else v)
            for k, v in state.items()}


def task_checkpoint(p):
    """A step and a save at this world size; then a load of the checkpoint
    another world size saved. Returns the whole parameters and moments after
    each."""
    import numpy as np

    from spatialthinker_torch.core.batch import RolloutBatch

    trainer, _ = _trainer(p, [f"trainer.save_checkpoint_path={p['save_dir']}", "trainer.save_freq=1"])
    trainer.reward_fn = reward_fn
    mine = _rank_rows(p["rolled"], trainer)
    trainer.generate_sequences = lambda batch, sampling, generator=None: mine.select(slice(None))
    trainer.global_step = 1
    trainer.train_step(RolloutBatch(tensors={"input_ids": np.zeros((len(mine) // 2, 1), np.int32)}))
    trainer.save_checkpoint()
    saved = {"params": _full_params(trainer), "opt": _opt_state(trainer)}
    loaded_trainer, _ = _trainer(p, [f"trainer.load_checkpoint_path={p['load_dir']}"])
    loaded_trainer.load_checkpoint()
    return {"saved": saved, "loaded": {"params": _full_params(loaded_trainer),
                                       "opt": _opt_state(loaded_trainer),
                                       "step": loaded_trainer.global_step}}


def task_mesh(p):
    """Meshes, their groups, the sharded model and the checks of a run,
    on this world."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from spatialthinker_torch.core.config import build_config
    from spatialthinker_torch.parallel import mesh as pm
    from spatialthinker_torch.parallel import multihost as mh
    from spatialthinker_torch.parallel.sharding import local, shard_model
    from spatialthinker_torch.trainer.grpo_trainer import mesh_checks

    ranks = dist.get_process_group_ranks
    out = {"meshes": {}, "errors": {}}
    for sizes in p["meshes"]:
        try:
            m = pm.create_mesh(*sizes, device_type="cpu")
        except AssertionError as e:
            out["errors"][sizes] = str(e)
            continue
        out["meshes"][sizes] = {
            "shape": tuple(m.shape), "batch": ranks(pm.batch_group(m)), "sp": ranks(pm.sp_group(m)),
            "norm": ranks(pm.norm_group(m)), "batch_rank": pm.batch_rank(m)}
    m = pm.create_mesh(*p["shard_mesh"], device_type="cpu")
    model = shard_model(_model(p), m)
    out["placements"] = {n: (str(t.placements), tuple(t.shape), tuple(local(t).shape))
                         for n, t in model.named_parameters()}
    cfg = build_config(p["dotlist"])
    mesh_checks(cfg, p["kv_heads"], dist.get_world_size(), dist.get_world_size())
    sh = cfg.worker.actor.sharding
    out["config_mesh"] = tuple(pm.create_mesh(sh.data_size, sh.fsdp_size, sh.model_size, "cpu").shape)
    out["n_chips"] = cfg.trainer.n_chips
    rank = dist.get_rank()
    out["gathered"] = mh.allgather_host_data(np.full((rank + 1, 2), rank))
    out["objects"] = mh.allgather_pyobj({"rank": rank})
    out["rows"] = mh.negotiate_row_count(3 + 2 * rank)
    out["slice"] = mh.process_local_slice(8)
    # a sharded tensor refused by name at every kernel's input check
    sharded = next(t for t in model.parameters() if isinstance(t, DTensor))
    plain = torch.zeros(1)
    from spatialthinker_torch.ops import decode_attention as da, flash_attention as fa
    from spatialthinker_torch.ops import int8_matmul as i8m, silu_quant as sq

    refusals = {}
    for name, call in (("flash", lambda: fa._check_cuda_inputs(sharded, plain, plain, plain, plain)),
                       ("decode", lambda: da._check_cuda_inputs(plain, sharded, plain, plain, 0, None, None, 0)),
                       ("w8a8", lambda: i8m._check_cuda_inputs(plain, sharded, plain, None, ())),
                       ("silu", lambda: sq._check_cuda_input(sharded))):
        try:
            call()
        except TypeError as e:
            refusals[name] = str(e)
    out["refusals"] = refusals
    return out


def _tp():
    import torch.distributed as dist

    from spatialthinker_torch.parallel.tensor import TPSpec

    return TPSpec(dist.group.WORLD)


def task_tp_shards(p):
    """``shard_for_rank`` then ``gather_full`` of a whole state dict, and
    this rank's shard."""
    from spatialthinker_torch.parallel.tensor import gather_full, shard_for_rank

    tp = _tp()
    mine = shard_for_rank(p["state"], tp.size, tp.rank)
    return {"whole": {k: v.numpy() for k, v in gather_full(mine, tp).items()},
            "mine": {k: tuple(v.shape) for k, v in mine.items()}}


def task_tp_vocab(p):
    """The vocab-parallel log-prob and entropy of this rank's head rows, with
    the gradients of the hidden state and of the rank's rows."""
    import torch

    from spatialthinker_torch.ops.logprobs import log_probs_from_hidden

    tp = _tp()
    out = []
    for case in p["cases"]:
        v = case["head"].shape[0] // tp.size
        hidden = torch.as_tensor(case["hidden"]).requires_grad_()
        head = torch.as_tensor(case["head"][tp.rank * v : (tp.rank + 1) * v]).requires_grad_()
        logp, ent = log_probs_from_hidden(hidden, torch.as_tensor(case["labels"]), head, chunk_size=case["chunk"],
                                          compute_entropy=True, temperature=case["temperature"],
                                          tp=tp, vocab_start=tp.rank * v)
        (logp * torch.as_tensor(case["g_logp"]) + ent * torch.as_tensor(case["g_ent"])).sum().backward()
        out.append({"logp": logp.detach().numpy(), "ent": ent.detach().numpy(),
                    "g_hidden": hidden.grad.numpy(), "g_head": head.grad.numpy()})
    return out


def task_tp_logprobs(p):
    """tp = world log-probs (packed and per-sample) of the TP-local model."""
    import torch

    from spatialthinker_torch.models.qwen2_5_vl.model import vision_to_device
    from spatialthinker_torch.trainer.grpo_trainer import tp_local
    from spatialthinker_torch.trainer.train_step import (
        PackedTrainBatch, TrainBatch, compute_log_probs, compute_packed_log_probs,
    )

    model = tp_local(_model(p), _tp())
    out = {"widths": {n: tuple(t.shape) for n, t in model.named_parameters()}}
    with torch.no_grad():
        batch = PackedTrainBatch(*(torch.as_tensor(x) for x in p["packed"]))
        out["packed"] = model(compute_packed_log_probs, batch, None, chunk_size=4)[0].numpy()
        batch = TrainBatch(*(torch.as_tensor(x) for x in p["train"]))
        vision = vision_to_device(p.get("train_vision"), "cpu")
        out["train"] = model(compute_log_probs, batch, vision, chunk_size=4)[0].numpy()
    return out


def task_tp_quant(p):
    """The TP-local W8A8 rollout copy's int8 weights and scales, and the
    row-parallel inputs ``p["x"]`` of o / down quantized by this rank's
    K columns with the group's row amax (the row quantize's split mode)."""
    import torch

    from spatialthinker_torch.ops.int8_matmul import quantize_rows_split
    from spatialthinker_torch.ops.quant import quantize_model
    from spatialthinker_torch.parallel.sharding import tp_rollout_copy
    from spatialthinker_torch.parallel.tensor import all_reduce_max, shard_for_rank
    from spatialthinker_torch.trainer.grpo_trainer import tp_local

    tp = _tp()
    q = quantize_model(tp_rollout_copy(tp_local(_model(p), tp)))
    out = {k: v.numpy() for k, v in q.state_dict().items() if k.endswith((".qvalue", ".scale"))}
    for name, x in p["x"].items():  # x is the whole (rows, K) input of a row-parallel product
        piece = shard_for_rank({name: torch.as_tensor(x)}, tp.size, tp.rank)[name]
        xq, xs = quantize_rows_split(piece.contiguous(), lambda a: all_reduce_max(a, tp))
        out[f"xq:{name}"], out[f"xs:{name}"] = xq.numpy(), xs.numpy()
    return out


def task_tp_load(p):
    """``trainer.main``'s multi-GPU start at tp = world: the mesh first, then
    the policy loaded from an HF directory as this rank's shard, then the
    trainer on that mesh (the critic's backbone loaded as a shard too):
    what each rank holds."""
    from spatialthinker_torch.core import config as tc
    from spatialthinker_torch.data.dataset import RLHFDataset
    from spatialthinker_torch.parallel.mesh import tp_group
    from spatialthinker_torch.parallel.tensor import TPSpec
    from spatialthinker_torch.trainer import main as tm
    from spatialthinker_torch.trainer.grpo_trainer import run_mesh

    cfg = tc.build_config(list(p["dotlist"]))
    mesh = run_mesh(cfg, tm.model_config(cfg).text.num_key_value_heads, "cpu")
    model = tm.build_model(cfg, device="cpu", tp=TPSpec(tp_group(mesh)))
    tok = tm.load_tokenizer("synthetic", model.cfg)
    trainer = tm.build_trainer(cfg, tok, model, RLHFDataset.from_rows(p["rows"], tok, cfg.data, model.cfg),
                               mesh=mesh)
    return {"kept": trainer.model is model and trainer.tp is model.tp,
            "actor": {k: v.numpy() for k, v in trainer.model.state_dict().items()},
            "critic": {k: v.numpy() for k, v in trainer.critic.state_dict().items()}}


TASKS = {
    "ring": _attention_task("ring"),
    "ulysses": _attention_task("ulysses"),
    "logprobs": task_logprobs,
    "train_step": task_train_step,
    "rollout": task_rollout,
    "checkpoint": task_checkpoint,
    "mesh": task_mesh,
    "tp_shards": task_tp_shards,
    "tp_vocab": task_tp_vocab,
    "tp_logprobs": task_tp_logprobs,
    "tp_quant": task_tp_quant,
    "tp_load": task_tp_load,
}


def main():
    task, rank, world, store, args, out = sys.argv[1:7]
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=int(rank), world_size=int(world))
    try:
        with open(args, "rb") as f:
            payload = pickle.load(f)
        result = TASKS[task](payload)
        with open(out, "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
