"""CLI entry point: ``python -m spatialthinker_torch.trainer.main config=cfg.yaml
key.sub=value ...`` — the grammar of the JAX package's ``trainer/main.py`` and
of the reference (verl/trainer/main.py:88-105, scripts/*.sh).

One process runs on the current CUDA device. Several GPUs: one process per
GPU, ``torchrun --nproc_per_node=N -m spatialthinker_torch.trainer.main ...
trainer.n_chips=N``; each rank takes ``cuda:LOCAL_RANK`` before anything
touches a card, brings the process group up (NCCL; ``parallel/multihost.py``,
also when ``trainer.nnodes`` > 1), builds the model and hands the trainer,
which shards it, its row slice of every batch. ``SPATIALTHINKER_PLATFORM=cpu``
in the environment asks for the CPU instead (smoke runs and tests; gloo
between ranks); without a card and without that request the entry point
raises.

``SPATIALTHINKER_PREFILL_DEQUANT_M`` (the JAX CLI's knob, 0 = off) is read
here, once, and handed to the trainer as ``prefill_dequant_min_m``: the same
environment line works for both packages' CLIs, while the library takes an
argument (``ops.quant.quantize_model``).
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import torch
import torch.distributed as dist

from ..core.config import PPOConfig, build_config, config_summary
from ..data.dataset import DataLoader, RLHFDataset
from ..models.qwen2_5_vl import Qwen25VL, Qwen25VLConfig, get_config, init_params
from ..models.qwen2_5_vl.params import config_from_hf_json, default_device, is_hf_checkpoint_dir, load_params
from ..parallel.multihost import initialize_if_needed, launched
from ..rewards.manager import RewardManager
from ..parallel.mesh import tp_group
from ..parallel.tensor import TPSpec
from .grpo_trainer import GRPOTrainer, run_mesh, tensor_parallel_size, tp_local


def run_device() -> torch.device:
    """The device of a CLI run: the card, or the CPU when
    ``SPATIALTHINKER_PLATFORM=cpu`` asks for it."""
    platform = os.environ.get("SPATIALTHINKER_PLATFORM", "").lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("", "gpu", "cuda"):
        raise ValueError(f"SPATIALTHINKER_PLATFORM={platform!r}: expected 'cpu', 'gpu' or unset")
    return default_device()


def load_tokenizer(path: str, model_cfg: Optional[Qwen25VLConfig] = None):
    """``synthetic`` is the self-contained tokenizer (with ``model_cfg``'s
    special ids when one is given); anything else loads through
    ``transformers``."""
    if path == "synthetic":
        from ..utils.synthetic_tokenizer import QwenSyntheticTokenizer, SyntheticTokenizer

        return SyntheticTokenizer() if model_cfg is None else QwenSyntheticTokenizer(model_cfg)
    from ..utils.tokenizer import get_tokenizer

    return get_tokenizer(path, trust_remote_code=True)


def model_config(config: PPOConfig) -> Qwen25VLConfig:
    """The policy's architecture: the HF directory's ``config.json``, or the preset."""
    model_path = config.worker.actor.model.model_path
    return config_from_hf_json(model_path) if is_hf_checkpoint_dir(model_path) else get_config(model_path)


def build_model(config: PPOConfig, device=None, tp: Optional[TPSpec] = None) -> Qwen25VL:
    """The policy on ``device`` (default: the current CUDA device). Loads HF
    safetensors when the model path is a local checkpoint dir; otherwise
    random weights from a preset, made on the device from ``trainer.seed``
    (smoke runs). ``tp``: this rank's TP shard only -- of the checkpoint as
    it loads (the card never holds the whole model), or of the random
    weights, drawn whole so that every layout holds one model."""
    device = default_device() if device is None else torch.device(device)
    model_path = config.worker.actor.model.model_path
    dtype = getattr(torch, config.worker.actor.model.param_dtype)
    if is_hf_checkpoint_dir(model_path):
        return load_params(model_path, device=device, dtype=dtype, tp=tp)
    generator = torch.Generator(device=device).manual_seed(config.trainer.seed)
    model = init_params(get_config(model_path), generator, device=device, dtype=dtype)
    return model if tp is None else tp_local(model, tp)


def build_trainer(config: PPOConfig, tokenizer, model: Qwen25VL, train_ds, val_ds=None, *,
                  prefill_dequant_min_m: int = 0, mesh=None) -> GRPOTrainer:
    """Loaders, reward manager and trainer around datasets that exist: ``run``
    calls it after loading from files, a caller with rows in memory
    (``RLHFDataset.from_rows``) gets the same trainer. ``prefill_dequant_min_m``
    > 0 turns on the rollout copy's prefill-dequant mode. ``mesh``: the run's
    mesh (``run_mesh``) when the caller built the policy on it."""
    # several GPUs: every rank walks the same global order and takes its rows;
    # the ranks of a TP group (the model axis without sp) take the same rows
    shard = None
    if dist.is_initialized():
        tp = tensor_parallel_size(config)
        shard = (dist.get_rank() // tp, dist.get_world_size() // tp)
    train_loader = DataLoader(
        train_ds, config.data.rollout_batch_size, shuffle=config.data.shuffle,
        seed=config.data.seed, num_workers=config.data.num_workers,
        prefetch_batches=config.data.prefetch_batches, process_shard=shard,
    )
    val_loader = None
    if val_ds is not None:
        val_bs = config.data.val_batch_size if config.data.val_batch_size > 0 else len(val_ds)
        val_loader = DataLoader(val_ds, val_bs, shuffle=False, process_shard=shard)
    reward_cfg = config.worker.reward
    reward_fn = RewardManager(
        tokenizer, reward_cfg.score_function,
        skip_special_tokens=reward_cfg.skip_special_tokens, num_workers=reward_cfg.num_workers,
    )
    return GRPOTrainer(
        config=config, tokenizer=tokenizer, model=model, train_dataloader=train_loader,
        val_dataloader=val_loader, reward_fn=reward_fn, prefill_dequant_min_m=prefill_dequant_min_m, mesh=mesh,
    )


def run(config: PPOConfig, prefill_dequant_min_m: int = 0) -> None:
    on_card = os.environ.get("SPATIALTHINKER_PLATFORM", "").lower() != "cpu"
    if launched() and on_card and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    device = run_device()
    initialize_if_needed(device.type, force=config.trainer.nnodes > 1)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(config_summary(config))
    # several GPUs: the mesh first, so that under TP each rank loads its shard only
    mesh = tp = None
    if dist.is_initialized():
        mesh = run_mesh(config, model_config(config).text.num_key_value_heads, device.type)
        if tensor_parallel_size(config) > 1:
            tp = TPSpec(tp_group(mesh))
    model = build_model(config, device=device, tp=tp)
    tokenizer = load_tokenizer(config.worker.actor.model.tokenizer_path, model.cfg)
    limit = config.worker.rollout.limit_images
    train_ds = RLHFDataset(config.data.train_files, tokenizer, config.data, model.cfg,
                           limit_images=limit)
    val_ds = None
    if config.data.val_files:
        val_ds = RLHFDataset(config.data.val_files, tokenizer, config.data, model.cfg,
                             limit_images=limit)
    build_trainer(config, tokenizer, model, train_ds, val_ds,
                  prefill_dequant_min_m=prefill_dequant_min_m, mesh=mesh).fit()


def main(argv: Optional[list] = None) -> None:
    config = build_config(argv if argv is not None else sys.argv[1:])
    run(config, prefill_dequant_min_m=int(os.environ.get("SPATIALTHINKER_PREFILL_DEQUANT_M", "0")))


if __name__ == "__main__":
    main()
