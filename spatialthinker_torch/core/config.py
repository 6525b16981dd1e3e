"""Typed configuration tree: structured dataclass defaults <- YAML file <- CLI dotlist.

The port's own copy of ``spatialthinker_tpu/core/config.py``: the same
dataclasses, field for field, the same ``config=path.yaml key.sub=value``
grammar, so ``scripts/config.yaml`` and the shipped scripts' dotlists parse
into equal trees. What differs is validation. The port runs one process on
one GPU, so the knobs that exist for a TPU mesh or a 16 GB chip are rejected
with the ROADMAP item that brings them, never ignored:

- ``worker.*.sharding.data_size / fsdp_size / model_size`` other than 1 or -1
  (-1 = "every device left", which is the one GPU), ``ulysses_sequence_
  parallel_size`` > 1, ``rollout.tensor_parallel_size`` > 1 and
  ``trainer.nnodes`` > 1: ROADMAP A13 (multi-GPU). ``trainer.n_chips`` parses
  as in the JAX tree (the shipped scripts set it); ``GRPOTrainer`` rejects a
  value above 1.
- ``optim.stream``, ``ref.offload``, ``sharding.host_offload_params`` and
  ``host_offload_optimizer``: ROADMAP A14 (state that lives on the host).

``sharding.remat_policy=dots`` (save matmul outputs) has no counterpart: the
trainer checkpoints layer inputs and says so once. The JAX tree's
``page_size % 256`` rule for int4 pools is a TPU tiling constraint; the
port's paged kernels need an even page only.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------
# Leaf configs
# ---------------------------------------------------------------------------


@dataclass
class DataConfig:
    train_files: str = ""
    val_files: str = ""
    prompt_key: str = "problem"
    answer_key: str = "answer"
    image_key: str = "image"
    mixed_data: bool = False
    text_only: bool = False
    max_prompt_length: int = 2048
    max_response_length: int = 2048
    rollout_batch_size: int = 512
    val_batch_size: int = -1
    format_prompt: str = ""
    shuffle: bool = True
    seed: int = 1
    max_pixels: int = 4_194_304
    min_pixels: int = 262_144
    num_workers: int = 8  # host-side loader threads; 0 = synchronous
    prefetch_batches: int = 2


@dataclass
class ModelConfig:
    model_path: str = "Qwen/Qwen2.5-VL-3B-Instruct"
    tokenizer_path: Optional[str] = None
    enable_gradient_checkpointing: bool = True
    trust_remote_code: bool = False
    freeze_vision_tower: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def post_init(self):
        if self.tokenizer_path is None:
            self.tokenizer_path = self.model_path


@dataclass
class OptimConfig:
    lr: float = 1.0e-6
    weight_decay: float = 1.0e-2
    betas: Tuple[float, float] = (0.9, 0.999)
    strategy: str = "adamw"  # {adamw, adamw_bf16}; adamw_bf16 = AnyPrecision AdamW, bf16 state
    use_kahan_summation: bool = True  # adamw_bf16: False drops the compensation buffer
    lr_warmup_ratio: float = 0.0
    training_steps: int = -1
    stream: bool = False  # host-streamed optimizer of the JAX package: rejected (ROADMAP A14)
    grad_accum_dtype: str = ""  # micro-batch gradient accumulator: "" = float32

    def post_init(self):
        if self.grad_accum_dtype not in ("", "float32", "bfloat16"):
            raise ValueError(
                "worker.*.optim.grad_accum_dtype must be '' (auto), "
                f"'float32', or 'bfloat16'; got {self.grad_accum_dtype!r}"
            )


@dataclass
class ShardingConfig:
    """The JAX tree's mesh axis sizes. The port accepts 1 and -1 ("every
    device left" = the one GPU) and rejects the rest until it has a mesh."""

    data_size: int = 1          # replica/ddp axis
    fsdp_size: int = -1         # parameter-shard axis
    model_size: int = 1         # tensor-parallel axis (megatron-style TP)
    remat: bool = True          # checkpoint every decoder layer and vision block
    remat_policy: str = "dots"  # {dots, full}; the port keeps layer inputs only ("full")
    host_offload_params: bool = False
    host_offload_optimizer: bool = False


@dataclass
class ActorConfig:
    global_batch_size: int = 128
    micro_batch_size_per_device_for_update: int = 4
    micro_batch_size_per_device_for_experience: int = 16
    max_grad_norm: float = 1.0
    clip_ratio_low: float = 0.2
    clip_ratio_high: float = 0.3
    clip_ratio_dual: float = 3.0
    ppo_epochs: int = 1
    padding_free: bool = True
    ulysses_sequence_parallel_size: int = 1
    sequence_parallel_backend: str = "ulysses"  # {ulysses, ring}; inert at size 1
    entropy_coeff: float = 0.0
    use_kl_loss: bool = False       # plumbed from algorithm config
    kl_loss_coef: float = 0.0
    kl_penalty: str = "low_var_kl"
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)

    disable_kl: bool = False  # derived (plumbed by PPOConfig.post_init)


@dataclass
class RefConfig:
    """Reference policy: frozen second param set sharing the actor's graph."""

    micro_batch_size_per_device_for_experience: int = 16
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    offload: bool = False  # host-resident reference copy: rejected (ROADMAP A14)


@dataclass
class CriticConfig:
    global_batch_size: int = 128
    micro_batch_size_per_device_for_update: int = 4
    micro_batch_size_per_device_for_experience: int = 16
    max_grad_norm: float = 1.0
    cliprange_value: float = 0.5
    ppo_epochs: int = 1
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)


@dataclass
class SamplingOverride:
    """Per-validation sampling overrides."""

    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    n: Optional[int] = None


@dataclass
class RolloutConfig:
    name: str = "jax"               # "jax" = the dense engine; "continuous": page_size 0 continuous, > 0 paged
    n: int = 5                      # samples per prompt
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    seed: int = 1
    limit_images: int = 0
    max_num_batched_tokens: int = 8192
    # the paged engine's page pool is sized from the card's free memory x this
    gpu_memory_utilization: float = 0.9
    kv_cache_dtype: str = "bfloat16"  # {bfloat16, int8, int4}
    quantization: str = "none"      # {none, int8 = W8A8 decoder matmuls, w4a8 = + int4 MLP decode copies}
    page_size: int = 128            # tokens per KV page (paged attention granularity)
    kv_pages_override: int = 0      # > 0: fixed page-pool size instead of the measurement
    # int4 KV: both decode-attention dots on int8 operands (q and the softmax
    # weights rounded to int8 in the kernel); inert unless kv_cache_dtype=int4
    int4_i8dot: bool = False
    decode_batch_size: int = -1     # -1: infer from batch
    refill_batch: int = 0           # > 0: cap unique prompts per paged refill prefill
    prefill_chunk_size: int = 2048
    # > 0: prefill in row groups at full sequence length instead of sequence
    # chunks; composes with the token budget (groups are chunked as well when
    # rows * P exceeds max_num_batched_tokens)
    prefill_rows: int = 0
    tensor_parallel_size: int = 1   # > 1 rejected (ROADMAP A13)
    # reuse the engine's sampled-token log-probs as old_log_probs instead of
    # recomputing them with the training forward
    use_rollout_log_probs: bool = False
    val_override_config: SamplingOverride = field(default_factory=SamplingOverride)

    # derived from the data config by post_init
    prompt_length: int = 2048
    response_length: int = 2048


@dataclass
class RewardConfig:
    reward_type: str = "function"
    score_function: str = "r1v"     # {math, r1v, r1v_scene, spatial_sgg}
    skip_special_tokens: bool = True
    num_workers: int = 8            # host-side scorer parallelism


@dataclass
class WorkerConfig:
    actor: ActorConfig = field(default_factory=ActorConfig)
    critic: CriticConfig = field(default_factory=CriticConfig)
    ref: RefConfig = field(default_factory=RefConfig)
    rollout: RolloutConfig = field(default_factory=RolloutConfig)
    reward: RewardConfig = field(default_factory=RewardConfig)


@dataclass
class AlgorithmConfig:
    adv_estimator: str = "grpo"     # {grpo, gae, rloo, reinforce_plus_plus, remax}
    disable_kl: bool = False
    use_kl_loss: bool = True
    kl_penalty: str = "low_var_kl"  # {kl, abs, mse, low_var_kl, full, chi2}
    kl_coef: float = 1.0e-2
    kl_type: str = "fixed"          # {fixed, adaptive}
    kl_target: float = 0.0
    kl_horizon: float = 0.0
    gamma: float = 1.0
    lam: float = 1.0


@dataclass
class TrainerConfig:
    total_episodes: int = 15
    max_steps: int = -1
    logger: List[str] = field(default_factory=lambda: ["console"])
    project_name: str = "spatialthinker_tpu"
    experiment_name: str = "default"
    n_chips: int = 1                # devices per host; GRPOTrainer rejects > 1 (ROADMAP A13)
    nnodes: int = 1
    critic_warmup: int = 0
    val_freq: int = -1
    val_before_train: bool = False
    val_only: bool = False
    val_generations_to_log: int = 3
    save_freq: int = -1
    save_limit: int = -1
    save_checkpoint_path: Optional[str] = None
    load_checkpoint_path: Optional[str] = None
    seed: int = 1
    # torch.profiler traces around the selected train steps, written under profile_dir
    profile_dir: Optional[str] = None
    profile_steps: List[int] = field(default_factory=lambda: [1, 5])


@dataclass
class PPOConfig:
    data: DataConfig = field(default_factory=DataConfig)
    worker: WorkerConfig = field(default_factory=WorkerConfig)
    algorithm: AlgorithmConfig = field(default_factory=AlgorithmConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)

    def post_init(self):
        """Plumb derived values downward (as the JAX tree)."""
        self.worker.rollout.prompt_length = self.data.max_prompt_length
        self.worker.rollout.response_length = self.data.max_response_length
        if self.algorithm.disable_kl:
            self.worker.actor.disable_kl = True
            self.worker.actor.use_kl_loss = False
        else:
            self.worker.actor.use_kl_loss = self.algorithm.use_kl_loss
            self.worker.actor.kl_loss_coef = self.algorithm.kl_coef
            self.worker.actor.kl_penalty = self.algorithm.kl_penalty
        if self.trainer.save_checkpoint_path is None:
            self.trainer.save_checkpoint_path = (
                f"checkpoints/{self.trainer.project_name}/{self.trainer.experiment_name}"
            )
        if self.worker.actor.sequence_parallel_backend not in ("ulysses", "ring"):
            raise ValueError(
                f"actor.sequence_parallel_backend="
                f"{self.worker.actor.sequence_parallel_backend!r}: supported "
                "values are 'ulysses' (head exchange) and 'ring' (KV rotation)"
            )
        for role, sh in (("actor", self.worker.actor.sharding),
                         ("critic", self.worker.critic.sharding),
                         ("ref", self.worker.ref.sharding)):
            if sh.remat_policy not in ("dots", "full"):
                raise ValueError(
                    f"worker.{role}.sharding.remat_policy={sh.remat_policy!r}: "
                    "supported values are 'dots' (save matmul outputs) and "
                    "'full' (save layer inputs only)"
                )
            for axis in ("data_size", "fsdp_size", "model_size"):
                if getattr(sh, axis) not in (1, -1):
                    raise ValueError(
                        f"worker.{role}.sharding.{axis}={getattr(sh, axis)}: the port runs "
                        "one process on one GPU (1, or -1 = every device left); meshes "
                        "come with ROADMAP A13 (multi-GPU)"
                    )
            for knob in ("host_offload_params", "host_offload_optimizer"):
                if getattr(sh, knob):
                    raise ValueError(
                        f"worker.{role}.sharding.{knob} is not ported: parameters, "
                        "moments and the reference copy stay on the GPU (ROADMAP A14)"
                    )
        if self.worker.actor.ulysses_sequence_parallel_size > 1:
            raise ValueError(
                "worker.actor.ulysses_sequence_parallel_size="
                f"{self.worker.actor.ulysses_sequence_parallel_size}: sequence parallelism "
                "comes with ROADMAP A13 (multi-GPU)"
            )
        for role, optim in (("actor", self.worker.actor.optim),
                            ("critic", self.worker.critic.optim)):
            if optim.stream:
                raise ValueError(
                    f"worker.{role}.optim.stream is not ported: the host-streamed "
                    "optimizer exists for a 16 GB chip (ROADMAP A14)"
                )
        if self.worker.ref.offload:
            raise ValueError(
                "worker.ref.offload is not ported: the frozen reference copy stays on "
                "the GPU (ROADMAP A14)"
            )
        if self.trainer.nnodes > 1:
            raise ValueError(
                f"trainer.nnodes={self.trainer.nnodes}: the port runs one process on one "
                "GPU; several hosts come with ROADMAP A13 (multi-GPU)"
            )
        if self.worker.rollout.quantization not in ("none", "int8", "w4a8"):
            raise ValueError(
                f"rollout.quantization={self.worker.rollout.quantization!r}: "
                "supported values are 'none', 'int8' (W8A8) and 'w4a8' (W8A8 + int4 "
                "MLP decode copies)"
            )
        if self.worker.rollout.name not in ("jax", "continuous"):
            raise ValueError(
                f"rollout.name={self.worker.rollout.name!r}: supported values are 'jax' "
                "(the dense engine; the name is the JAX tree's) and 'continuous' "
                "(page_size 0: the continuous engine; page_size > 0: the paged engine)"
            )
        if self.worker.rollout.kv_cache_dtype not in ("bfloat16", "int8", "int4"):
            raise ValueError(
                f"rollout.kv_cache_dtype={self.worker.rollout.kv_cache_dtype!r}: "
                "supported values are 'bfloat16', 'int8' and 'int4' (packed "
                "nibbles)"
            )
        if (self.worker.rollout.kv_cache_dtype == "int4"
                and self.worker.rollout.name == "continuous"
                and self.worker.rollout.page_size > 0
                and self.worker.rollout.page_size % 2 != 0):
            raise ValueError(
                f"rollout.kv_cache_dtype=int4 with the paged engine needs an even "
                f"page_size (got {self.worker.rollout.page_size}): pages pack two "
                "token cells per byte"
            )
        tp = self.worker.rollout.tensor_parallel_size
        if tp > 1:
            raise ValueError(
                f"rollout.tensor_parallel_size={tp}: decode on several GPUs comes with "
                "ROADMAP A13 (multi-GPU)"
            )


# ---------------------------------------------------------------------------
# Merge machinery: dataclass defaults <- YAML dict <- dotlist overrides
# ---------------------------------------------------------------------------


def _coerce(value: Any, target_type: Any) -> Any:
    """Best-effort coercion of a parsed value into the annotated field type."""
    if value is None:
        return None
    origin = getattr(target_type, "__origin__", None)
    if target_type in (int,) and isinstance(value, (str, float)):
        return int(float(value))
    if target_type in (float,) and isinstance(value, (str, int)):
        return float(value)
    if target_type in (bool,) and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    if origin in (list, List) and isinstance(value, str):
        return json.loads(value.replace("'", '"'))
    if origin in (tuple, Tuple) and isinstance(value, (list, str)):
        if isinstance(value, str):
            value = json.loads(value.replace("'", '"'))
        return tuple(value)
    return value


def _merge_into(obj: Any, data: Dict[str, Any], path: str = "") -> None:
    if not is_dataclass(obj):
        raise TypeError(f"cannot merge into non-dataclass at {path!r}")
    field_map = {f.name: f for f in fields(obj)}
    for key, value in data.items():
        if key not in field_map:
            raise KeyError(f"unknown config key: {path + key!r}")
        f = field_map[key]
        current = getattr(obj, key)
        if is_dataclass(current) and isinstance(value, dict):
            _merge_into(current, value, path + key + ".")
        elif is_dataclass(current) and value is None:
            pass
        else:
            setattr(obj, key, _coerce(value, f.type if isinstance(f.type, type) else _resolve_type(f)))


def _resolve_type(f) -> Any:
    """Resolve a (possibly string) field annotation to a runtime type."""
    t = f.type
    if isinstance(t, str):
        simple = {"int": int, "float": float, "bool": bool, "str": str}
        t = simple.get(t.replace("Optional[", "").replace("]", ""), t)
    return t


def _parse_scalar(text: str) -> Any:
    low = text.lower()
    if low in ("null", "none", "~"):
        return None
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    if text.startswith("[") or text.startswith("{"):
        try:
            return json.loads(text.replace("'", '"'))
        except json.JSONDecodeError:
            pass
    return text


def _set_dotted(tree: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def parse_cli(argv: List[str]) -> Tuple[Optional[str], Dict[str, Any]]:
    """Parse ``config=path.yaml a.b.c=value ...`` ."""
    config_path: Optional[str] = None
    overrides: Dict[str, Any] = {}
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"expected key=value, got {arg!r}")
        key, _, raw = arg.partition("=")
        if key == "config":
            config_path = raw
        else:
            _set_dotted(overrides, key, _parse_scalar(raw))
    return config_path, overrides


def build_config(argv: List[str]) -> PPOConfig:
    config_path, overrides = parse_cli(argv)
    cfg = PPOConfig()
    if config_path:
        _merge_into(cfg, load_yaml(config_path))
    if overrides:
        _merge_into(cfg, overrides)
    _deep_post_init(cfg)
    return cfg


def _deep_post_init(obj: Any) -> None:
    """Run post_init hooks depth-first ."""
    if not is_dataclass(obj):
        return
    for f in fields(obj):
        _deep_post_init(getattr(obj, f.name))
    hook = getattr(obj, "post_init", None)
    if callable(hook):
        hook()


def to_dict(obj: Any) -> Any:
    if is_dataclass(obj):
        return {f.name: to_dict(getattr(obj, f.name)) for f in fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    return obj


def config_summary(cfg: PPOConfig) -> str:
    return json.dumps(to_dict(cfg), indent=2, default=str)
