"""Every function of the port's ``algos`` package against its JAX counterpart
on the same random arrays (numpy, seeded).

Tolerance: fp32 elementwise math and short reductions on both sides:
atol/rtol 1e-5 (the recurrences of GAE / REINFORCE++ run 12 steps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu import algos as ja
from spatialthinker_torch import algos as ta
from tests.test_torch_parity import to_torch

TOL = dict(atol=1e-5, rtol=1e-5)
B, R, GROUPS = 12, 12, 4


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, R + 1, size=B)
    mask = (np.arange(R)[None, :] < lens[:, None]).astype(np.float32)
    rewards = np.zeros((B, R), np.float32)
    rewards[np.arange(B), lens - 1] = rng.normal(size=B).astype(np.float32)
    gid = rng.permutation(np.repeat(np.arange(GROUPS), B // GROUPS)).astype(np.int32)
    values = (rng.normal(size=(B, R)) * mask).astype(np.float32)
    return rewards, mask, gid, values, rng


def _both(jax_fn, torch_fn, arrays, *static):
    ref = jax_fn(*(jnp.asarray(a) for a in arrays), *static)
    got = torch_fn(*(to_torch(a) for a in arrays), *static)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("name", ["grpo", "rloo", "gae", "reinforce_plus_plus", "remax"])
def test_advantage_estimators_match_jax(name):
    rewards, mask, gid, values, rng = _batch(1)
    if name == "grpo":
        _both(ja.compute_grpo_outcome_advantage, ta.compute_grpo_outcome_advantage,
              (rewards, mask, gid), GROUPS)
    elif name == "rloo":
        _both(ja.compute_rloo_outcome_advantage, ta.compute_rloo_outcome_advantage,
              (rewards, mask, gid), GROUPS)
    elif name == "gae":
        _both(ja.compute_gae_advantage_return, ta.compute_gae_advantage_return,
              (rewards, values, mask), 0.99, 0.95)
    elif name == "reinforce_plus_plus":
        _both(ja.compute_reinforce_plus_plus_outcome_advantage,
              ta.compute_reinforce_plus_plus_outcome_advantage, (rewards, mask), 0.97)
    else:
        baselines = rng.normal(size=B).astype(np.float32)
        _both(ja.compute_remax_outcome_advantage, ta.compute_remax_outcome_advantage,
              (rewards, baselines, mask))


def test_grpo_single_member_group_and_group_relabelling():
    """A group of one gets std 0 (advantage 0 over eps), and advantages do not
    depend on which integer names a group."""
    rewards, mask, gid, _, _ = _batch(2)
    gid = gid.copy()
    gid[0] = GROUPS  # a group of its own
    adv, _ = ta.compute_grpo_outcome_advantage(to_torch(rewards), to_torch(mask), to_torch(gid), GROUPS + 1)
    ref, _ = ja.compute_grpo_outcome_advantage(jnp.asarray(rewards), jnp.asarray(mask), jnp.asarray(gid), GROUPS + 1)
    np.testing.assert_allclose(adv.numpy(), np.asarray(ref), **TOL)
    assert np.all(adv.numpy()[0] == 0.0)
    relabel = np.asarray([3, 0, 4, 1, 2])[gid]
    adv2, _ = ta.compute_grpo_outcome_advantage(to_torch(rewards), to_torch(mask),
                                                to_torch(relabel.astype(np.int32)), GROUPS + 1)
    np.testing.assert_allclose(adv2.numpy(), adv.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("clip", [(0.2, 0.3, 3.0), (0.1, 0.1, 2.0)])
def test_policy_loss_matches_jax(clip):
    _, mask, _, _, rng = _batch(3)
    old = rng.normal(size=(B, R)).astype(np.float32) - 2
    new = old + rng.normal(size=(B, R)).astype(np.float32) * 0.6  # many clipped both ways
    adv = rng.normal(size=(B, R)).astype(np.float32)
    _both(ja.compute_policy_loss, ta.compute_policy_loss, (old, new, adv, mask), *clip)


def test_value_loss_matches_jax():
    _, mask, _, values, rng = _batch(4)
    vpreds = values + rng.normal(size=(B, R)).astype(np.float32)
    returns = rng.normal(size=(B, R)).astype(np.float32)
    _both(ja.compute_value_loss, ta.compute_value_loss, (vpreds, returns, values, mask), 0.5)


@pytest.mark.parametrize("kind", ["kl", "abs", "mse", "low_var_kl", "full", "chi2"])
def test_kl_variants_match_jax(kind):
    rng = np.random.default_rng(5)
    shape = (B, R, 7) if kind == "full" else (B, R)
    lp = rng.normal(size=shape).astype(np.float32) - 1
    ref = lp + rng.normal(size=shape).astype(np.float32) * 1.5  # reaches the clamps
    _both(ja.compute_kl, ta.compute_kl, (lp, ref), kind)


def test_unknown_kl_penalty_raises():
    with pytest.raises(NotImplementedError):
        ta.compute_kl(torch.zeros(2), torch.zeros(2), "nope")


def test_rewards_entropy_and_masked_stats_match_jax():
    rewards, mask, _, values, rng = _batch(6)
    lp = rng.normal(size=(B, R)).astype(np.float32)
    ref = rng.normal(size=(B, R)).astype(np.float32)
    _both(ja.compute_rewards, ta.compute_rewards, (rewards, lp, ref), 0.05)
    logits = rng.normal(size=(B, R, 9)).astype(np.float32) * 3
    _both(ja.entropy_from_logits, ta.entropy_from_logits, (logits,))
    _both(ja.masked_mean, ta.masked_mean, (values, mask))
    _both(ja.masked_var, ta.masked_var, (values, mask))
    _both(ja.masked_var, ta.masked_var, (values, mask), False)
    _both(ja.masked_whiten, ta.masked_whiten, (values, mask))
    np.testing.assert_allclose(
        ta.masked_mean(to_torch(values), to_torch(mask), dim=-1).numpy(),
        np.asarray(ja.masked_mean(jnp.asarray(values), jnp.asarray(mask), axis=-1)), **TOL)


@pytest.mark.parametrize("kind", ["fixed", "adaptive"])
def test_kl_controllers_match_jax(kind):
    args = (kind, 0.05, 0.1, 100.0)
    a, b = ja.get_kl_controller(*args), ta.get_kl_controller(*args)
    for kl in (0.02, 0.3, 0.11):
        a.update(kl, 16)
        b.update(kl, 16)
        assert a.kl_coef == b.kl_coef
    with pytest.raises(ValueError):
        ta.get_kl_controller("adaptive", 0.05, 0.1, 0.0)
    with pytest.raises(ValueError):
        ta.get_kl_controller("nope", 0.05)
