"""Megatron tensor parallelism on the mesh's ``model`` axis
(``spatialthinker_torch/parallel/tensor.py``), held on the CPU: ranks as
spawned gloo processes (``tests/torch_dist_worker.py``), the JAX package in
the pytest process, the tiny config in fp32.

- the port's split dims equal the ``model`` entries of the JAX package's
  ``param_specs`` on every leaf, and ``shard_for_rank`` then ``gather_full``
  gives the state dict back bit for bit;
- the vocab-parallel log-prob and entropy and their gradients against the
  single-rank function to 1e-6;
- the tp = 2 model's log-probs (per-sample with images, packed) against JAX
  single-device to 1e-5;
- ``train_step`` at tp = 2 (resident, ``ref.offload``, GAE) and at
  fsdp 2 x model 2 on 4 ranks against the JAX trainer's single-process step:
  every metric within 1e-4, parameters in units of lr;
- greedy paged rollouts at ``tensor_parallel_size=2`` (bf16 pools; W8A8 +
  int4 pools + ``int4_i8dot``) against JAX's single-process rollout, token
  for token up to near-ties, both ranks drawing the same tokens;
- the TP W8A8 copy's int8 weights, weight scales and row-parallel activation
  scales equal slices of the single-device copy bit for bit;
- the silu junction's and kernel A's row quantize's plain two-pass splits
  equal their one-pass plain versions bit for bit;
- a checkpoint saved at tp = 2 resumed at world 1, and the reverse, bit for
  bit;
- the policy and the critic loaded from HF directories by each rank as its
  shard (``trainer.main``'s start: the mesh, then ``load_params(tp=)``).
"""

import numpy as np
import pytest
import torch

import jax

from spatialthinker_tpu.core import config as jc
from spatialthinker_tpu.core.batch import RolloutBatch as JaxRolloutBatch
from spatialthinker_tpu.parallel.mesh import create_mesh
from spatialthinker_tpu.parallel.sharding import param_specs
from spatialthinker_tpu.trainer.grpo_trainer import GRPOTrainer as JaxTrainer
from spatialthinker_torch.models.qwen2_5_vl import build_model, params_from_jax
from spatialthinker_torch.ops.logprobs import log_probs_from_hidden
from spatialthinker_torch.ops.silu_quant import (
    fused_silu_quantize_plain, fused_silu_quantize_split, silu_quantize_with_amax_plain, silu_row_amax_plain,
)
from spatialthinker_torch.parallel.tensor import SPLITS, shard_for_rank, split_of
from tests.test_torch_multihost import LR, STEP_EXTRA, _critic, jax_trainer
from tests.test_torch_parity import CFG, JAX_CFG, VOCAB, both_models, random_jax_tree
from tests.test_torch_ring import jax_log_probs, logprob_payload
from tests.test_torch_train_step import _params_close
from tests.test_torch_trainer import CRITIC_LR, GAE, NOT_COMPARED, ROWS, _as, _dotlist, _precomputed_rollout, build
from tests.torch_dist_worker import Ranks, reward_fn, run_ranks

TP2 = ["worker.actor.sharding.fsdp_size=1", "worker.actor.sharding.model_size=2",
       "worker.rollout.name=continuous", "worker.rollout.page_size=4"]
GAE_2 = GAE + ["worker.critic.micro_batch_size_per_device_for_update=8", "algorithm.gamma=0.99",
               "algorithm.lam=0.95"]

# ---------------------------------------------------------------------------
# the rule table against JAX's
# ---------------------------------------------------------------------------

# JAX leaf path (per layer) -> (port parameter name, JAX dim -> port dim)
T, V = "text.layers.0.", "vision.blocks.0."
TRANSPOSED = {0: 1, 1: 0}
JAX_TO_PORT = {
    "text/embed_tokens": ("text.embed_tokens.weight", {0: 0, 1: 1}),
    "text/norm": ("text.norm.weight", {0: 0}),
    "layers/self_attn/qkv_proj": (T + "self_attn.qkv_proj.weight", {0: 0, 1: 1, 2: 0}),
    "layers/self_attn/qkv_bias": (T + "self_attn.qkv_proj.bias", {0: 0, 1: 0}),
    "layers/self_attn/o_proj": (T + "self_attn.o_proj.weight", TRANSPOSED),
    "layers/mlp/gate_up_proj": (T + "mlp.gate_up_proj.weight", {0: 0, 1: 1, 2: 0}),
    "layers/mlp/down_proj": (T + "mlp.down_proj.weight", TRANSPOSED),
    "layers/input_layernorm": (T + "input_layernorm.weight", {0: 0}),
    "layers/post_attention_layernorm": (T + "post_attention_layernorm.weight", {0: 0}),
    "vision/patch_embed": ("vision.patch_embed.weight", TRANSPOSED),
    "blocks/norm1": (V + "norm1.weight", {0: 0}),
    "blocks/norm2": (V + "norm2.weight", {0: 0}),
    "blocks/qkv": (V + "qkv.weight", TRANSPOSED),
    "blocks/qkv_bias": (V + "qkv.bias", {0: 0}),
    "blocks/proj": (V + "proj.weight", TRANSPOSED),
    "blocks/proj_bias": (V + "proj.bias", {0: 0}),
    **{f"blocks/mlp/{k}_proj": (V + f"mlp.{k}_proj.weight", TRANSPOSED) for k in ("gate", "up", "down")},
    **{f"blocks/mlp/{k}_bias": (V + f"mlp.{k}_proj.bias", {0: 0}) for k in ("gate", "up", "down")},
    "merger/ln_q": ("vision.merger.ln_q.weight", {0: 0}),
    **{f"merger/{k}": (f"vision.merger.{k}.weight", TRANSPOSED) for k in ("fc1", "fc2")},
    **{f"merger/{k}_bias": (f"vision.merger.{k}.bias", {0: 0}) for k in ("fc1", "fc2")},
}


def _jax_leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _jax_leaves(v, path)
        else:
            yield path, v


def _port_name(path: str):
    hits = [(suffix, m) for suffix, m in JAX_TO_PORT.items() if path.endswith(suffix)]
    assert len(hits) == 1, (path, hits)
    return hits[0][1]


def test_split_dims_equal_the_jax_model_entries_on_every_leaf():
    tree = random_jax_tree(0)
    specs = dict(_jax_leaves(param_specs(tree)))
    seen = set()
    for path, leaf in _jax_leaves(tree):
        stacked = path.startswith(("text/layers", "vision/blocks"))
        entries = tuple(specs[path]) + (None,) * (np.ndim(leaf) - len(tuple(specs[path])))
        entries = entries[1:] if stacked else entries  # the (L,) dim
        jax_dims = [d for d, e in enumerate(entries) if e == "model" or (isinstance(e, tuple) and "model" in e)]
        name, dims = _port_name(path)
        seen.add(name)
        split = split_of(name)
        if not jax_dims:
            assert split is None, f"{path}: replicated in JAX, split in the port ({split})"
        else:
            assert len(jax_dims) == 1 and split is not None, (path, jax_dims, split)
            assert dims[jax_dims[0]] == split[0], (path, jax_dims, split)
    tied = {"text.lm_head.weight"}  # the tiny model ties its head; the 7B rule below
    assert {n for n in SPLITS} - {n.replace(".0.", ".") for n in seen} == tied
    from spatialthinker_tpu.parallel.sharding import spec_for_path
    assert tuple(spec_for_path("text/lm_head", 2)) == ("fsdp", "model") and split_of("text.lm_head.weight")[0] == 0


@pytest.fixture(scope="module")
def tp_shards(tmp_path_factory):
    state = {k: v.clone() for k, v in both_models(seed=3)[1].state_dict().items()}
    return state, run_ranks("tp_shards", 2, tmp_path_factory.mktemp("shards"), {"state": state})


def test_shard_for_rank_then_gather_full_is_the_state_bit_for_bit(tp_shards):
    state, ranks = tp_shards
    for r, got in enumerate(ranks):
        assert set(got["whole"]) == set(state)
        for k, v in state.items():
            np.testing.assert_array_equal(got["whole"][k], v.numpy(), err_msg=k)
        mine = shard_for_rank(state, 2, r)
        assert got["mine"] == {k: tuple(v.shape) for k, v in mine.items()}
    # whole GQA groups: rank 1's qkv rows are the second kv group's [q heads | k | v]
    qkv = state["text.layers.0.self_attn.qkv_proj.weight"]
    np.testing.assert_array_equal(shard_for_rank({"text.layers.0.self_attn.qkv_proj.weight": qkv}, 2, 1)[
        "text.layers.0.self_attn.qkv_proj.weight"], qkv[qkv.shape[0] // 2:])
    gu = state["text.layers.0.mlp.gate_up_proj.weight"]
    i = gu.shape[0] // 2
    piece = shard_for_rank({"text.layers.0.mlp.gate_up_proj.weight": gu}, 2, 0)["text.layers.0.mlp.gate_up_proj.weight"]
    np.testing.assert_array_equal(piece, torch.cat([gu[: i // 2], gu[i: i + i // 2]]))


# ---------------------------------------------------------------------------
# vocab-parallel log-probs and the TP forward
# ---------------------------------------------------------------------------


def _vocab_cases():
    rng = np.random.default_rng(11)
    cases = []
    for chunk, temperature in ((4, 1.0), (8, 0.7)):
        b, s, e, v = 2, 8, 16, 64
        cases.append(dict(hidden=rng.normal(size=(b, s, e)).astype(np.float32),
                          head=(0.25 * rng.normal(size=(v, e))).astype(np.float32),  # logits ~ N(0, 1)
                          labels=rng.integers(0, v, size=(b, s)), g_logp=rng.normal(size=(b, s)).astype(np.float32),
                          g_ent=rng.normal(size=(b, s)).astype(np.float32), chunk=chunk, temperature=temperature))
    return cases


@pytest.mark.parametrize("i", range(2))
def test_vocab_parallel_log_probs_and_gradients_match_one_rank(tmp_path, i):
    case = _vocab_cases()[i]
    hidden = torch.as_tensor(case["hidden"]).requires_grad_()
    head = torch.as_tensor(case["head"]).requires_grad_()
    logp, ent = log_probs_from_hidden(hidden, torch.as_tensor(case["labels"]), head, chunk_size=case["chunk"],
                                      compute_entropy=True, temperature=case["temperature"])
    (logp * torch.as_tensor(case["g_logp"]) + ent * torch.as_tensor(case["g_ent"])).sum().backward()
    ranks = run_ranks("tp_vocab", 2, tmp_path, {"cases": [case]})
    v = head.shape[0] // 2
    for r, got in enumerate(ranks):
        got = got[0]
        np.testing.assert_allclose(got["logp"], logp.detach().numpy(), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got["ent"], ent.detach().numpy(), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got["g_hidden"], hidden.grad.numpy(), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got["g_head"], head.grad[r * v: (r + 1) * v].numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("multimodal", [True, False], ids=["multimodal", "text"])
def test_tp2_log_probs_match_jax_single_device(tmp_path, multimodal):
    jax_params, vision, payload = logprob_payload(2 if multimodal else 3, multimodal)
    want = jax_log_probs(jax_params, vision, payload)
    for got in run_ranks("tp_logprobs", 2, tmp_path, payload):
        for key in ("train", "packed"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=1e-5, err_msg=key)
        w = got["widths"]  # local widths: tiny has 4 heads / 2 kv heads, I 128, vocab 1,024, vision 2 heads
        assert w["text.layers.0.self_attn.qkv_proj.weight"] == (1 * (2 + 2) * 16, 64)
        assert w["text.layers.0.mlp.gate_up_proj.weight"] == (128, 64)
        assert w["text.embed_tokens.weight"] == (VOCAB // 2, 64)
        assert w["vision.blocks.0.qkv.weight"] == (48, 32) and w["vision.merger.fc2.weight"] == (64, 64)


# ---------------------------------------------------------------------------
# train_step against the JAX trainer
# ---------------------------------------------------------------------------

# name: (world, the ranks' extra knobs, the JAX trainer's)
BASE = [d for d in STEP_EXTRA if "fsdp_size" not in d and "n_chips" not in d]
TP_VARIANTS = {"tp2": (2, [], []),
               "tp2_ref_offload": (2, ["worker.ref.offload=true"], ["worker.ref.offload=true"]),
               "tp2_gae": (2, GAE_2, GAE_2)}


@pytest.fixture(scope="module")
def tp_steps(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("tp_steps")
    _, model = both_models(seed=7)
    single = BASE + ["worker.actor.sharding.fsdp_size=1"]
    trainer, _ = build(tmp_path, *single, model=model)
    rolled = _precomputed_rollout(trainer, multimodal=True)
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    gae = jax_trainer(tmp_path, single, GAE_2, trainer.tokenizer, rolled)
    critic = params_from_jax(jax.tree.map(np.asarray, gae.critic_params), CFG)
    common = {"rows": ROWS, "state": state, "critic_state": {k: v.clone() for k, v in critic.items()},
              "rolled": {"tensors": rolled.tensors, "non_tensors": rolled.non_tensors}}
    two = Ranks("train_step", 2, tmp_path, {
        **common, "dotlist": _dotlist(tmp_path, *BASE, *TP2, "trainer.n_chips=2"),
        "variants": {name: port for name, (_, port, _) in TP_VARIANTS.items()}}, timeout=400)
    four = Ranks("train_step", 4, tmp_path, {
        **common, "dotlist": _dotlist(tmp_path, *BASE, *TP2[1:], "worker.actor.sharding.fsdp_size=2",
                                      "trainer.n_chips=4"),
        "variants": {"fsdp2_tp2": []}}, timeout=400)
    want = {}
    for name, (_, _, extra) in TP_VARIANTS.items():
        ref = gae if name == "tp2_gae" else jax_trainer(tmp_path, single, extra, trainer.tokenizer, rolled)
        metrics = ref.train_step(JaxRolloutBatch(tensors={"input_ids": np.zeros((4, 1), np.int32)}))
        want[name] = (metrics, ref.params, getattr(ref, "critic_params", None))
    want["fsdp2_tp2"] = want["tp2"]
    got = {name: [r[name] for r in two.results()] for name in TP_VARIANTS}
    got["fsdp2_tp2"] = [r["fsdp2_tp2"] for r in four.results()]
    return got, want


@pytest.mark.parametrize("variant", list(TP_VARIANTS) + ["fsdp2_tp2"])
def test_tp_train_step_matches_jax_single_process(tp_steps, variant):
    got, want = tp_steps
    jax_metrics, jax_params, jax_critic = want[variant]
    keys = sorted(k for k in jax_metrics if not k.startswith(NOT_COMPARED))
    assert keys == sorted(k for k in got[variant][0]["metrics"] if not k.startswith(NOT_COMPARED))
    for r in got[variant]:
        for key in keys:
            np.testing.assert_allclose(r["metrics"][key], jax_metrics[key], atol=1e-4, rtol=1e-4,
                                       err_msg=f"{variant} {key}")
        model = build_model(CFG, {k: torch.as_tensor(v) for k, v in r["params"].items()},
                            device="cpu", dtype=torch.float32)
        _params_close(model, jax_params, LR)
        if jax_critic is not None:
            assert r["metrics"]["critic/grad_norm"] > 0
            _params_close(_critic(r["critic"]), jax_critic, CRITIC_LR)
    assert got[variant][0]["metrics"]["actor/grad_norm"] > 0


# ---------------------------------------------------------------------------
# tensor-parallel paged rollouts
# ---------------------------------------------------------------------------

POOLS = {"bf16": [],
         "w8a8_int4_i8dot": ["worker.rollout.quantization=int8", "worker.rollout.kv_cache_dtype=int4",
                             "worker.rollout.int4_i8dot=true", "worker.rollout.page_size=256"]}


@pytest.mark.parametrize("pools", list(POOLS))
def test_tp2_greedy_paged_rollouts_match_jax_single_process(tmp_path, pools):
    """Both ranks of the TP group run one paged engine on the 4 prompts (n 2)
    over their shards: their tokens are equal, and they match the JAX
    trainer's single-process rollout token for token up to near-ties."""
    from collections import namedtuple

    from spatialthinker_torch.data.dataset import DataLoader
    from tests.test_torch_continuous import assert_same_up_to_ties

    jax_params, model = both_models(seed=4)
    extra = ["worker.rollout.name=continuous", "worker.rollout.page_size=4", *POOLS[pools]]  # later wins
    trainer, _ = build(tmp_path, *extra, model=model)
    batch = next(iter(DataLoader(trainer.train_dataloader.dataset, 4, shuffle=False)))
    ref = JaxTrainer(jc.build_config(_dotlist(tmp_path, *extra)), trainer.tokenizer, JAX_CFG, jax_params,
                     train_dataloader=None, reward_fn=reward_fn,
                     mesh=create_mesh(1, 1, 1, devices=jax.devices()[:1]))
    want = ref.generate_sequences(_as(JaxRolloutBatch, batch), ref.sampling.override(temperature=0.0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    payload = {"dotlist": _dotlist(tmp_path, *extra, *TP2[:2], "worker.rollout.tensor_parallel_size=2",
                                   "trainer.n_chips=2"),
               "rows": ROWS, "state": state, "batch": {"tensors": batch.tensors, "non_tensors": batch.non_tensors}}
    ranks = run_ranks("rollout", 2, tmp_path, payload)
    Rows = namedtuple("Rows", "responses response_mask rollout_log_probs")
    for k in Rows._fields:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    got = Rows(*(ranks[0][k] for k in Rows._fields))
    ref_rows = Rows(*(np.asarray(want.tensors[k]) for k in Rows._fields))
    assert got.responses.shape == ref_rows.responses.shape == (8, 8)
    assert assert_same_up_to_ties(got, ref_rows) <= 1
    # each rank's rollout copy holds its shards (the embedding whole), never a whole copy
    whole = sum(v.numel() * v.element_size() for v in state.values())
    assert all(r["batch_index"] == 0 and 0 < r["copy_bytes"] < whole for r in ranks)


# ---------------------------------------------------------------------------
# the policy and the critic loaded from HF directories as each rank's shard
# ---------------------------------------------------------------------------


def test_tp2_ranks_load_their_shards_of_hf_checkpoints(tmp_path):
    """``trainer.main``'s start at tp = 2: each rank loads the policy from an
    HF directory as its shard (``load_params(..., tp=)``) on the run's mesh,
    the trainer keeps that model (no second cut), and the critic's backbone
    loads from its own HF directory as a shard: every tensor equals the
    rank's slice of the whole checkpoint bit for bit."""
    pytest.importorskip("safetensors")
    from spatialthinker_torch.models.qwen2_5_vl.params import load_params
    from spatialthinker_torch.tools.model_merger import export_hf

    dirs = {}
    for role, seed in (("actor", 11), ("critic", 12)):
        dirs[role] = str(tmp_path / f"hf_{role}")
        export_hf(both_models(seed=seed)[1].state_dict(), CFG, dirs[role], dtype="float32")
    dotlist = _dotlist(tmp_path, *GAE, *TP2, "trainer.n_chips=2", f"worker.actor.model.model_path={dirs['actor']}",
                       f"worker.critic.model.model_path={dirs['critic']}")
    ranks = run_ranks("tp_load", 2, tmp_path, {"dotlist": dotlist, "rows": ROWS})
    for r, got in enumerate(ranks):
        assert got["kept"]
        for role in ("actor", "critic"):
            whole = load_params(dirs[role], device="cpu", dtype=torch.float32).state_dict()
            want = shard_for_rank(whole, 2, r)
            held = {k: v for k, v in got[role].items() if not k.startswith("value_head.")}
            assert set(held) == set(want), role
            for k, v in want.items():
                np.testing.assert_array_equal(held[k], v.numpy(), err_msg=f"{role} {k}")


# ---------------------------------------------------------------------------
# the TP W8A8 copy and the silu junction's split
# ---------------------------------------------------------------------------


def test_tp_w8a8_copy_equals_slices_of_the_single_device_copy(tmp_path):
    from spatialthinker_torch.ops.int8_matmul import quantize_rows
    from spatialthinker_torch.ops.quant import quantize_model

    _, model = both_models(seed=5)
    whole = {k: v.numpy() for k, v in quantize_model(model).state_dict().items()
             if k.endswith((".qvalue", ".scale"))}
    rng = np.random.default_rng(5)
    xs = {"text.layers.0.self_attn.o_proj.weight": rng.normal(size=(6, 64)).astype(np.float32),
          "text.layers.1.mlp.down_proj.weight": rng.normal(size=(6, 128)).astype(np.float32)}
    state = {k: v.clone() for k, v in model.state_dict().items()}
    for r, got in enumerate(run_ranks("tp_quant", 2, tmp_path, {"state": state, "x": xs})):
        assert {k for k in got if not k.startswith(("xq:", "xs:"))} == set(whole)
        for k, v in whole.items():
            module = k.rsplit(".", 1)[0] + ".weight"
            split = None if k.startswith("text.embed_tokens") else split_of(module)  # the copy's table is whole
            want = v
            if split is not None and (k.endswith(".qvalue") or split[0] == 0):
                # int8 rows and the scales of column-parallel rows are the rank's slice;
                # a row-parallel weight's channel scales are whole on every rank
                want = shard_for_rank({module: torch.as_tensor(v)}, 2, r)[module].numpy()
            np.testing.assert_array_equal(got[k], want, err_msg=k)
        for name, x in xs.items():  # the rank's K columns of the whole rows' quantize, and its scales
            xq_whole, xs_whole = quantize_rows(torch.as_tensor(x))
            piece = shard_for_rank({name: xq_whole}, 2, r)[name]
            np.testing.assert_array_equal(got[f"xq:{name}"], piece.numpy())
            np.testing.assert_array_equal(got[f"xs:{name}"], xs_whole.numpy())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,i", [(8, 64), (33, 86), (16, 2752)])
def test_silu_split_plain_equals_one_pass_bit_for_bit(m, i, dtype):
    gu = torch.as_tensor(np.random.default_rng(m + i).normal(size=(m, 2 * i)).astype(np.float32)).to(dtype)
    q, s = fused_silu_quantize_plain(gu)
    q2, s2 = silu_quantize_with_amax_plain(gu, silu_row_amax_plain(gu))
    assert torch.equal(q, q2) and torch.equal(s, s2)
    q3, s3 = fused_silu_quantize_split(gu, lambda a: a)
    assert torch.equal(q, q3) and torch.equal(s, s3)
    # the split over two ranks' column halves with the max of their amaxes
    half = i // 2
    parts = [torch.cat([gu[:, c0:c1], gu[:, i + c0:i + c1]], dim=1) for c0, c1 in ((0, half), (half, i))]
    amax = torch.maximum(*(silu_row_amax_plain(p) for p in parts))
    pieces = [silu_quantize_with_amax_plain(p, amax) for p in parts]
    assert torch.equal(torch.cat([p[0] for p in pieces], dim=1), q)
    assert all(torch.equal(p[1], s) for p in pieces)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,tp", [(8, 64, 2), (33, 896, 4), (5, 5504, 2)])
def test_row_quantize_split_plain_equals_one_pass_bit_for_bit(m, k, tp, dtype):
    """Kernel A's row quantize split over ``tp`` column slices (the group's
    max of their amaxes between the passes) equals ``quantize_rows`` of the
    whole row bit for bit, and with the identity for the max it is
    ``quantize_rows`` itself."""
    from spatialthinker_torch.ops import int8_matmul as i8m

    x = torch.as_tensor(np.random.default_rng(m + k).normal(size=(m, k)).astype(np.float32)).to(dtype)
    x[m // 2] = 0
    xq, xs = i8m.quantize_rows(x)
    q1, s1 = i8m.quantize_rows_split(x, lambda a: a)
    assert torch.equal(q1, xq) and torch.equal(s1, xs)
    part = k // tp
    pieces = [x[:, r * part:(r + 1) * part] for r in range(tp)]
    amax = torch.stack([i8m.row_amax_plain(p) for p in pieces]).amax(dim=0)
    outs = [i8m.quantize_rows_with_amax_plain(p, amax) for p in pieces]
    assert torch.equal(torch.cat([o[0] for o in outs], dim=1), xq)
    assert all(torch.equal(o[1], xs) for o in outs)


# ---------------------------------------------------------------------------
# checkpoints between tp = 2 and world 1
# ---------------------------------------------------------------------------


def test_checkpoints_move_between_tp2_and_one_process(tmp_path):
    """A checkpoint saved by a TP group of 2 (whole tensors, the HF layout)
    loads into one process, and one saved by one process loads into the TP
    group: parameters and moments equal those at the save, bit for bit."""
    from spatialthinker_torch.parallel.sharding import full_state
    from tests.test_torch_multihost import _opt_arrays
    from tests.test_torch_trainer import _reward_fn

    _, model = both_models(seed=6)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    single_dir, duo_dir = tmp_path / "single", tmp_path / "duo"
    tp_knobs = ["worker.rollout.name=continuous"]
    trainer, _ = build(tmp_path, *tp_knobs, f"trainer.save_checkpoint_path={single_dir}", "trainer.save_freq=1",
                       model=model)
    trainer.reward_fn = _reward_fn
    rolled = _precomputed_rollout(trainer, multimodal=False)
    trainer.generate_sequences = lambda batch, sampling, generator=None: _as(type(rolled), rolled)
    trainer.global_step = 1
    trainer.train_step(type(rolled)(tensors={"input_ids": np.zeros((4, 1), np.int32)}))
    trainer.save_checkpoint()
    single = {"params": {k: v.numpy() for k, v in full_state(trainer.model).items()},
              "opt": _opt_arrays(trainer.optimizer.state)}

    payload = {"dotlist": _dotlist(tmp_path, *TP2, "trainer.n_chips=2"),
               "rows": ROWS, "state": state, "save_dir": str(duo_dir),
               "load_dir": str(single_dir / "global_step_1"),
               "rolled": {"tensors": rolled.tensors, "non_tensors": rolled.non_tensors}}
    ranks = run_ranks("checkpoint", 2, tmp_path, payload)
    for r, got in enumerate(ranks):  # parameters on every rank, the moments rank 0 writes
        loaded = got["loaded"]
        assert loaded["step"] == 1
        pairs = [(loaded["params"], single["params"])] + [
            (loaded["opt"][k], single["opt"][k]) for k in ("mu", "nu") if r == 0]
        for a, b in pairs:
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    resumed, _ = build(tmp_path, *tp_knobs, f"trainer.load_checkpoint_path={duo_dir}", model=both_models(seed=8)[1])
    resumed.load_checkpoint()
    saved = ranks[0]["saved"]
    assert resumed.global_step == 1 and resumed.optimizer.state["count"] == saved["opt"]["count"]
    for k, v in resumed.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), saved["params"][k], err_msg=k)
    for kind in ("mu", "nu"):
        for k, v in resumed.optimizer.state[kind].items():
            np.testing.assert_array_equal(v.float().numpy(), saved["opt"][kind][k], err_msg=k)
