"""The port's config tree (``spatialthinker_torch/core/config.py``) against the
JAX package's: ``build_config`` on ``scripts/config.yaml`` and on every shipped
script's own dotlist gives equal trees, field for field (exact equality: the
values are parsed, not computed). Every knob of the rollout and sharding
sections is read by non-config code of the port or rejected; the mesh knobs
the port rejects raise a ``ValueError`` that names the ROADMAP item which
brings them, the rest their reason, and the Mosaic-only ``page_size % 256`` rule is an even-page rule here.
"""

import os
import re
from dataclasses import fields

import pytest

from spatialthinker_tpu.core import config as jc
from spatialthinker_torch.core import config as tc
from tests.test_e2e_smoke import _script_dotlist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = f"config={ROOT}/scripts/config.yaml"
SCRIPTS = ["spatialthinker_3b_grpo.sh", "spatialthinker_7b_grpo.sh"]


def _dotlist(script):
    return [YAML if d.startswith("config=") else d for d in _script_dotlist(script)]


@pytest.mark.parametrize("argv", [[], [YAML]] + [_dotlist(s) for s in SCRIPTS],
                         ids=["defaults", "config_yaml"] + SCRIPTS)
def test_build_config_equals_the_jax_tree(argv):
    ours, ref = tc.build_config(argv), jc.build_config(argv)
    assert tc.to_dict(ours) == jc.to_dict(ref)
    assert tc.config_summary(ours) == jc.config_summary(ref)


def test_dataclasses_have_the_same_fields_and_defaults():
    for name in ("DataConfig", "ModelConfig", "OptimConfig", "ShardingConfig", "ActorConfig", "RefConfig",
                 "CriticConfig", "SamplingOverride", "RolloutConfig", "RewardConfig", "WorkerConfig",
                 "AlgorithmConfig", "TrainerConfig", "PPOConfig"):
        ours, ref = getattr(tc, name), getattr(jc, name)
        assert [f.name for f in fields(ours)] == [f.name for f in fields(ref)], name
        assert tc.to_dict(ours()) == jc.to_dict(ref()), name


def test_cli_grammar_and_coercion():
    cfg = tc.build_config([YAML, "worker.actor.optim.betas=[0.8,0.95]", "trainer.logger=['console']",
                           "data.max_prompt_length=64", "worker.rollout.val_override_config.n=3",
                           "trainer.load_checkpoint_path=null", "algorithm.disable_kl=true"])
    assert tuple(cfg.worker.actor.optim.betas) == (0.8, 0.95) and cfg.trainer.logger == ["console"]
    assert cfg.worker.rollout.prompt_length == 64 and cfg.worker.rollout.val_override_config.n == 3
    assert cfg.trainer.load_checkpoint_path is None
    assert cfg.worker.actor.disable_kl and not cfg.worker.actor.use_kl_loss
    with pytest.raises(KeyError, match="unknown config key"):
        tc.build_config(["worker.rollout.no_such_knob=1"])
    with pytest.raises(ValueError, match="expected key=value"):
        tc.build_config(["oops"])


NO_IDLE_STAGE = "share one parameter set .no idle stage"  # the JAX tree's reason
# tensor_parallel_size=2 beside model_size 1 is the JAX tree's own refusal
REJECTED = [
    ("worker.rollout.tensor_parallel_size=2", "conflicts with actor.sharding.model_size=1: decode shares"),
    ("worker.critic.optim.stream=true", "JAX critic reads only optim.lr"),
    ("worker.actor.sharding.host_offload_params=true", NO_IDLE_STAGE),
    ("worker.ref.sharding.host_offload_params=true", NO_IDLE_STAGE),
    ("worker.critic.sharding.host_offload_optimizer=true", "JAX critic reads only optim.lr"),
    ("worker.ref.sharding.host_offload_optimizer=true", "reference copy has no optimizer"),
]


@pytest.mark.parametrize("override,item", REJECTED, ids=[o for o, _ in REJECTED])
def test_unported_knobs_raise_with_their_roadmap_item(override, item):
    """A mesh knob names the ROADMAP item that brings it; a knob the JAX
    package refuses (``host_offload_params``) or never reads (the critic's
    and the reference's host-state knobs) gives that reason."""
    with pytest.raises(ValueError, match=item):
        tc.build_config([override])


PAGED_TP = ["worker.actor.sharding.model_size=2", "worker.rollout.name=continuous", "worker.rollout.page_size=256"]


@pytest.mark.parametrize("extra,match", [
    (["worker.rollout.tensor_parallel_size=4"], "conflicts with actor.sharding.model_size=2"),
], ids=["tp_not_model_size"])
def test_tensor_parallel_rollout_refusals(extra, match):
    """A tensor_parallel_size other than 1 or model_size is the JAX tree's
    own refusal, in both trees."""
    with pytest.raises(ValueError, match=match):
        tc.build_config(PAGED_TP + extra)
    with pytest.raises(ValueError, match=match):
        jc.build_config(PAGED_TP + extra)


TP_ACCEPTED = {
    "tp1_rollout": [],
    "tp2_rollout": ["worker.rollout.tensor_parallel_size=2"],
    "w8a8_int4": ["worker.rollout.quantization=int8", "worker.rollout.kv_cache_dtype=int4",
                  "worker.rollout.int4_i8dot=true"],
    # every engine and quantization besides the paged engine on W8A8 under TP
    "model_size_alone": ["worker.rollout.name=jax"],
    "dense": ["worker.rollout.name=jax", "worker.rollout.tensor_parallel_size=2"],
    "dense_int4_i8dot": ["worker.rollout.name=jax", "worker.rollout.tensor_parallel_size=2",
                         "worker.rollout.kv_cache_dtype=int4", "worker.rollout.int4_i8dot=true"],
    "continuous": ["worker.rollout.page_size=0", "worker.rollout.tensor_parallel_size=2",
                   "worker.rollout.kv_cache_dtype=int8"],
    "w4a8": ["worker.rollout.quantization=w4a8", "worker.rollout.tensor_parallel_size=2"],
    "dense_w4a8": ["worker.rollout.name=jax", "worker.rollout.quantization=w4a8",
                   "worker.rollout.kv_cache_dtype=int4", "worker.rollout.int4_i8dot=true"],
    "continuous_w4a8": ["worker.rollout.page_size=0", "worker.rollout.quantization=w4a8"],
    "beside_sp": ["worker.actor.ulysses_sequence_parallel_size=2", "worker.rollout.tensor_parallel_size=2"],
    "beside_ring_sp_dense": ["worker.actor.ulysses_sequence_parallel_size=2",
                             "worker.actor.sequence_parallel_backend=ring", "worker.rollout.tensor_parallel_size=2",
                             "worker.rollout.name=jax"],
}


@pytest.mark.parametrize("extra", list(TP_ACCEPTED.values()), ids=list(TP_ACCEPTED))
def test_tensor_parallel_configs_parse_as_the_jax_tree(extra):
    """Every engine (dense, continuous, paged) and every quantization under
    tensor parallelism gives the JAX tree."""
    argv = PAGED_TP + extra
    assert tc.to_dict(tc.build_config(argv)) == jc.to_dict(jc.build_config(argv))


@pytest.mark.parametrize("override", [
    "worker.actor.optim.stream=true", "worker.ref.offload=true",
    "worker.actor.sharding.host_offload_optimizer=true",
])
def test_host_state_knobs_parse_as_the_jax_tree(override):
    """The three host-state knobs of the actor and the reference are accepted
    and give the JAX tree."""
    ours = tc.build_config([YAML, override])
    assert tc.to_dict(ours) == jc.to_dict(jc.build_config([YAML, override]))


def test_the_7b_dotlist_with_host_state_parses_as_the_jax_tree():
    """The shipped 7B script plus the two knobs that fit it on one GPU."""
    argv = _dotlist("spatialthinker_7b_grpo.sh") + [
        "worker.actor.optim.stream=true", "worker.ref.offload=true"]
    ours = tc.build_config(argv)
    assert tc.to_dict(ours) == jc.to_dict(jc.build_config(argv))
    assert ours.worker.actor.optim.stream and ours.worker.ref.offload
    assert ours.worker.actor.sharding.remat_policy == "dots"


@pytest.mark.parametrize("override,match", [
    ("worker.rollout.quantization=fp8", "quantization"), ("worker.rollout.kv_cache_dtype=fp8", "kv_cache_dtype"),
    ("worker.rollout.name=vllm", "rollout.name"), ("worker.actor.sharding.remat_policy=some", "remat_policy"),
    ("worker.actor.sequence_parallel_backend=tree", "sequence_parallel_backend"),
    ("worker.actor.optim.grad_accum_dtype=float16", "grad_accum_dtype"),
])
def test_unknown_values_raise(override, match):
    with pytest.raises(ValueError, match=match):
        tc.build_config([override])


@pytest.mark.parametrize("extra", [
    ["worker.rollout.quantization=w4a8"],
    ["worker.rollout.name=continuous", "worker.rollout.page_size=0", "worker.rollout.quantization=w4a8",
     "worker.rollout.decode_batch_size=128"],
], ids=["w4a8", "continuous_w4a8"])
def test_w4a8_and_the_continuous_engine_parse_as_the_jax_tree(extra):
    """The knobs that bring the continuous engine and the int4 MLP copies, on
    the shipped 3B dotlist: accepted, and the same tree as JAX's."""
    argv = _dotlist("spatialthinker_3b_grpo.sh") + extra
    ours = tc.build_config(argv)
    assert tc.to_dict(ours) == jc.to_dict(jc.build_config(argv))
    assert ours.worker.rollout.quantization == "w4a8"
    assert ours.worker.rollout.page_size == (0 if len(extra) > 1 else 1024)


def test_int4_pages_need_an_even_size_only():
    """The JAX tree's ``page_size % 256`` rule is a TPU tiling constraint."""
    paged_int4 = ["worker.rollout.name=continuous", "worker.rollout.kv_cache_dtype=int4"]
    with pytest.raises(ValueError, match="256"):
        jc.build_config(paged_int4 + ["worker.rollout.page_size=130"])
    assert tc.build_config(paged_int4 + ["worker.rollout.page_size=130"]).worker.rollout.page_size == 130
    with pytest.raises(ValueError, match="even"):
        tc.build_config(paged_int4 + ["worker.rollout.page_size=129"])
    for mesh in ("-1", "1"):  # "every device left" is the one GPU
        tc.build_config([f"worker.actor.sharding.fsdp_size={mesh}", "trainer.n_chips=4"])


# knobs whose "use" is a validation error or a check in post_init by design
EXEMPT = {"host_offload_params", "data_size", "fsdp_size", "model_size",
          "tensor_parallel_size", "prompt_length"}


@pytest.mark.parametrize("cfg_cls", [tc.RolloutConfig, tc.ShardingConfig])
def test_every_knob_is_read_or_rejected(cfg_cls):
    """The contract of ``tests/test_knobs.py`` on the port: a rollout or
    sharding knob is read outside ``config.py`` or rejected in it."""
    chunks = []
    for root, _, files in os.walk(os.path.join(ROOT, "spatialthinker_torch")):
        for f in files:
            if f.endswith(".py") and f != "config.py":
                with open(os.path.join(root, f)) as fh:
                    chunks.append(fh.read())
    src = "\n".join(chunks)
    missing = [f.name for f in fields(cfg_cls)
               if f.name not in EXEMPT and not re.search(rf"\.{re.escape(f.name)}\b", src)]
    assert not missing, f"{cfg_cls.__name__} knobs accepted but never read: {missing}"
