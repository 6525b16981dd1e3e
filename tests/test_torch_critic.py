"""The critic (``spatialthinker_torch/trainer/critic.py``) against the JAX
package's (``spatialthinker_tpu/trainer/critic.py``) on the tiny config, fp32
on both sides, the same weights carried from a JAX critic tree (a random
backbone + ``value_head``) by ``params_from_jax``:

- ``compute_values`` on a text-only and a multimodal batch (atol 1e-5);
- ``make_critic_update_fn`` over two micro-batches: ``critic/vf_loss``,
  ``critic/vf_clipfrac`` and ``critic/grad_norm`` at 1e-4, every updated
  parameter held in units of lr as ``tests/test_torch_train_step.py`` holds
  them, for both optimizer strategies;
- a non-finite gradient leaves parameters, moments and count unchanged on
  both sides;
- the value head's initialisation (fp32, normal * 0.02, zero bias) and the
  carriers' round trip of a critic tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.data import packing as jpk
from spatialthinker_tpu.trainer import critic as jcr
from spatialthinker_tpu.trainer import train_step as jts
from spatialthinker_torch.data import packing as tpk
from spatialthinker_torch.models.qwen2_5_vl import build_model, init_params, params_from_jax
from spatialthinker_torch.models.qwen2_5_vl.params import params_to_jax
from spatialthinker_torch.trainer import critic as tcr
from spatialthinker_torch.trainer import train_step as tts
from tests.test_torch_parity import CFG, JAX_CFG, random_jax_tree, to_torch
from tests.test_torch_train_step import (
    _jax_vision, _micro, _params_close, _torch_batch, _torch_vision, _vision, rollout_arrays,
    train_batch_arrays,
)

torch.set_num_threads(2)

LR = 1e-3
CLIP = 0.2


def both_critics(seed: int):
    """(JAX critic tree as jnp fp32, the port's ``Critic`` fp32 on the CPU)
    with equal weights: a random backbone and a random value head."""
    tree = random_jax_tree(seed)
    jparams = jcr.init_critic_params(JAX_CFG, jax.random.key(seed), dtype=jnp.float32,
                                     base_params=jax.tree.map(jnp.asarray, tree))
    # a nonzero bias makes the head's layout observable
    jparams["value_head"]["bias"] = jnp.asarray([0.03], jnp.float32)
    np_tree = jax.tree.map(np.asarray, jparams)
    backbone = build_model(CFG, params_from_jax(tree, CFG), device="cpu", dtype=torch.float32)
    critic = tcr.Critic(backbone, torch.Generator())
    critic.load_state_dict(params_from_jax(np_tree, CFG), strict=True)
    return jparams, critic


def critic_arrays(seed: int, multimodal: bool):
    """A rollout batch plus old values and returns (zero past each response)."""
    a = rollout_arrays(seed, multimodal)
    rng = np.random.default_rng(seed + 100)
    mask = a["response_mask"].astype(np.float32)
    a["values"] = (rng.normal(size=mask.shape) * 0.3).astype(np.float32) * mask
    a["returns"] = (rng.normal(size=mask.shape) * 0.5).astype(np.float32) * mask
    return a


@pytest.mark.parametrize("multimodal", [False, True], ids=["text", "multimodal"])
def test_compute_values_matches_jax(multimodal):
    jparams, critic = both_critics(seed=4)
    a = critic_arrays(6, multimodal)
    tb = train_batch_arrays(a)
    rows = range(len(a["responses"]))
    want = jcr.compute_values(jparams, JAX_CFG, jts.TrainBatch(**{k: jnp.asarray(v) for k, v in tb.items()}),
                              _jax_vision(_vision(jpk, JAX_CFG.vision, a, rows)))
    with torch.no_grad():
        got = tcr.compute_values(critic, _torch_batch(tts.TrainBatch, tb),
                                 _torch_vision(_vision(tpk, CFG.vision, a, rows)))
    assert got.dtype == torch.float32 and got.shape == a["response_mask"].shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    dead = a["response_mask"] == 0
    assert dead.any() and np.all(got.numpy()[dead] == 0)  # 0 past each response


def _critic_batches(a):
    tb = {k: _micro(v, 2) for k, v in train_batch_arrays(a).items()}
    vals, rets = _micro(a["values"], 2), _micro(a["returns"], 2)
    jcb = jcr.CriticBatch(train=jts.TrainBatch(**{k: jnp.asarray(v) for k, v in tb.items()}),
                          values=jnp.asarray(vals), returns=jnp.asarray(rets))
    tcb = tcr.CriticBatch(train=_torch_batch(tts.TrainBatch, tb), values=to_torch(vals), returns=to_torch(rets))
    return jcb, tcb


def _visions(a, multimodal):
    if not multimodal:
        return None, None
    halves = ([0, 1], [2, 3])
    jvis = jpk.stack_vision_packs([_vision(jpk, JAX_CFG.vision, a, h) for h in halves], JAX_CFG.vision)
    tvis = tpk.stack_vision_packs([_vision(tpk, CFG.vision, a, h) for h in halves], CFG.vision)
    return _jax_vision(jvis), _torch_vision(tvis)


@pytest.mark.parametrize("strategy,multimodal", [("adamw", True), ("adamw_bf16", False)])
def test_critic_update_matches_jax(strategy, multimodal):
    """One critic update over two micro-batches (remat on both sides)."""
    jparams, critic = both_critics(seed=5)
    a = critic_arrays(7, multimodal)
    jcb, tcb = _critic_batches(a)
    jvis, tvis = _visions(a, multimodal)
    jopt = jts.make_optimizer(LR, strategy=strategy)
    new_params, _, want = jax.jit(jcr.make_critic_update_fn(
        JAX_CFG, jopt, cliprange_value=CLIP, max_grad_norm=1.0, remat=True))(
        jparams, jopt.init(jparams), jcb, jvis)
    opt = tts.make_optimizer(LR, strategy=strategy)
    got = tcr.make_critic_update_fn(critic, opt, cliprange_value=CLIP, max_grad_norm=1.0, remat=True)(tcb, tvis)
    assert got.keys() == want.keys() == {"critic/vf_loss", "critic/vf_clipfrac", "critic/grad_norm"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-4, rtol=1e-4, err_msg=k)
    assert float(got["critic/vf_clipfrac"]) > 0  # the clip is exercised
    assert opt.state["count"] == 1 and all(p.grad is None for p in critic.parameters())
    _params_close(critic, new_params, LR)


def test_critic_update_skips_a_non_finite_gradient():
    jparams, critic = both_critics(seed=6)
    a = critic_arrays(8, False)
    a["returns"][0, 0] = np.nan
    jcb, tcb = _critic_batches(a)
    jopt = jts.make_optimizer(LR)
    jstate = jopt.init(jparams)
    new_params, new_state, want = jax.jit(jcr.make_critic_update_fn(JAX_CFG, jopt, remat=False))(
        jparams, jstate, jcb, None)
    assert not np.isfinite(float(want["critic/grad_norm"]))
    for x, y in zip(jax.tree.leaves((jparams, jstate)), jax.tree.leaves((new_params, new_state))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    opt = tts.make_optimizer(LR)
    opt.init(tts.trainable_parameters(critic))
    before = {k: v.clone() for k, v in critic.state_dict().items()}
    got = tcr.make_critic_update_fn(critic, opt, remat=False)(tcb, None)
    assert not np.isfinite(float(got["critic/grad_norm"]))
    assert all(torch.equal(critic.state_dict()[k], v) for k, v in before.items())
    assert opt.state["count"] == 0
    assert all(float(m.abs().max()) == 0 for m in (*opt.state["mu"].values(), *opt.state["nu"].values()))


def test_value_head_init_and_critic_tree_round_trip():
    backbone = init_params(CFG, torch.Generator().manual_seed(0), device="cpu", dtype=torch.bfloat16)
    critic = tcr.Critic(backbone, torch.Generator().manual_seed(1))
    head = critic.value_head
    assert head.weight.shape == (CFG.text.hidden_size, 1) and head.bias.shape == (1,)
    assert head.weight.dtype == head.bias.dtype == torch.float32
    assert critic.text.norm.weight.dtype == torch.bfloat16  # the backbone keeps its dtype
    assert float(head.bias.detach().abs().max()) == 0
    w = head.weight.detach().numpy().ravel()
    assert abs(w.mean()) < 0.01 and 0.014 < w.std() < 0.026  # normal * 0.02 over E = 64 draws
    again = tcr.Critic(init_params(CFG, torch.Generator().manual_seed(0), device="cpu"),
                       torch.Generator().manual_seed(1))
    assert torch.equal(again.value_head.weight, head.weight)  # drawn from the generator alone
    assert critic.text is backbone.text  # taken over, not copied
    names = {n for n, _ in critic.named_parameters()}
    assert {"value_head.weight", "value_head.bias"} <= names
    assert names - {"value_head.weight", "value_head.bias"} == {n for n, _ in backbone.named_parameters()}

    # JAX's head statistics are the same draw law
    jhead = jcr.init_critic_params(JAX_CFG, jax.random.key(0))["value_head"]
    assert np.asarray(jhead["weight"]).shape == tuple(head.weight.shape)
    # a critic tree carries there and back unchanged
    jparams, critic32 = both_critics(seed=9)
    back = params_to_jax(critic32.state_dict(), CFG)
    assert set(back) == {"text", "vision", "value_head"}
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(x, np.asarray(y))
