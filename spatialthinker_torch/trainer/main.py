"""CLI entry point: ``python -m spatialthinker_torch.trainer.main config=cfg.yaml
key.sub=value ...`` — the grammar of the JAX package's ``trainer/main.py`` and
of the reference (verl/trainer/main.py:88-105, scripts/*.sh), one process, one
GPU.

The run uses the current CUDA device. ``SPATIALTHINKER_PLATFORM=cpu`` in the
environment asks for the CPU instead (smoke runs and tests); without a card
and without that request the entry point raises.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import torch

from ..core.config import PPOConfig, build_config, config_summary
from ..data.dataset import DataLoader, RLHFDataset
from ..models.qwen2_5_vl import Qwen25VL, Qwen25VLConfig, get_config, init_params
from ..models.qwen2_5_vl.params import default_device, load_params
from ..rewards.manager import RewardManager
from .grpo_trainer import GRPOTrainer


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


def build_model(config: PPOConfig, device=None) -> Qwen25VL:
    """The policy on ``device`` (default: the current CUDA device). Loads HF
    safetensors when the model path is a local checkpoint dir; otherwise
    random weights from a preset, made on the device from ``trainer.seed``
    (smoke runs)."""
    device = default_device() if device is None else torch.device(device)
    model_path = config.worker.actor.model.model_path
    dtype = getattr(torch, config.worker.actor.model.param_dtype)
    if os.path.isdir(model_path) and any(
        f.endswith(".safetensors") for f in os.listdir(model_path)
    ):
        return load_params(model_path, device=device, dtype=dtype)
    generator = torch.Generator(device=device).manual_seed(config.trainer.seed)
    return init_params(get_config(model_path), generator, device=device, dtype=dtype)


def build_trainer(config: PPOConfig, tokenizer, model: Qwen25VL, train_ds, val_ds=None) -> GRPOTrainer:
    """Loaders, reward manager and trainer around datasets that exist: ``run``
    calls it after loading from files, a caller with rows in memory
    (``RLHFDataset.from_rows``) gets the same trainer."""
    train_loader = DataLoader(
        train_ds, config.data.rollout_batch_size, shuffle=config.data.shuffle,
        seed=config.data.seed, num_workers=config.data.num_workers,
        prefetch_batches=config.data.prefetch_batches,
    )
    val_loader = None
    if val_ds is not None:
        val_bs = config.data.val_batch_size if config.data.val_batch_size > 0 else len(val_ds)
        val_loader = DataLoader(val_ds, val_bs, shuffle=False)
    reward_cfg = config.worker.reward
    reward_fn = RewardManager(
        tokenizer, reward_cfg.score_function,
        skip_special_tokens=reward_cfg.skip_special_tokens, num_workers=reward_cfg.num_workers,
    )
    return GRPOTrainer(
        config=config, tokenizer=tokenizer, model=model, train_dataloader=train_loader,
        val_dataloader=val_loader, reward_fn=reward_fn,
    )


def run(config: PPOConfig) -> None:
    device = run_device()
    print(config_summary(config))
    model = build_model(config, device=device)
    tokenizer = load_tokenizer(config.worker.actor.model.tokenizer_path, model.cfg)
    limit = config.worker.rollout.limit_images
    train_ds = RLHFDataset(config.data.train_files, tokenizer, config.data, model.cfg,
                           limit_images=limit)
    val_ds = None
    if config.data.val_files:
        val_ds = RLHFDataset(config.data.val_files, tokenizer, config.data, model.cfg,
                             limit_images=limit)
    build_trainer(config, tokenizer, model, train_ds, val_ds).fit()


def main(argv: Optional[list] = None) -> None:
    config = build_config(argv if argv is not None else sys.argv[1:])
    run(config)


if __name__ == "__main__":
    main()
