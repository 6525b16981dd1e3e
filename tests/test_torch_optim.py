"""The port's AdamW (``trainer/optim.py``) against the JAX package's
optimizers on given gradients, five steps from equal parameters: strategy
``adamw`` against ``optax.adamw`` and ``adamw_bf16`` against
``any_precision_adamw`` (both through the JAX package's
``apply_optimizer_step``, which folds in the gradient scale and the NaN skip).

Tolerance: fp32 parameters within 1e-6 relative of the lr-sized updates'
scale (atol 2e-7, rtol 1e-6: the bias corrections are computed in double on
one side, fp32 on the other). bf16 parameters, bf16 moments and the Kahan
buffer within one bf16 ulp (rtol 2^-7) after five steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.trainer.train_step import apply_optimizer_step as jax_apply
from spatialthinker_tpu.trainer.train_step import make_optimizer as jax_make_optimizer
from spatialthinker_torch.trainer.optim import AdamW, make_schedule
from spatialthinker_torch.trainer.train_step import make_optimizer
from tests.test_torch_parity import to_torch

SHAPES = {"w": (6, 10), "b": (10,), "deep": (3, 4, 5)}
STEPS = 5
BF16_ULP = 2.0 ** -7


def _problem(seed, dtype):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 10 ** rng.uniform(-3, 0)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    scales = [1.0, 0.5, 0.013, 1.0, 0.25]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jparams = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    tparams = {k: to_torch(v).to(dtype) for k, v in params.items()}
    return jparams, tparams, grads, scales


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _run_both(strategy, dtype, kahan=True, warmup=0, nan_at=None, lr=1e-2):
    jparams, tparams, grads, scales = _problem(3, dtype)
    kw = dict(weight_decay=0.1, betas=(0.9, 0.95), warmup_steps=warmup, strategy=strategy,
              use_kahan_summation=kahan)
    jopt = jax_make_optimizer(lr, **kw)
    jstate = jopt.init(jparams)
    topt = make_optimizer(lr, **kw)
    for i in range(STEPS):
        finite = i != nan_at
        factor = scales[i] if finite else 0.0
        jparams, jstate = jax_apply(
            jopt, {k: jnp.asarray(v) for k, v in grads[i].items()}, jstate, jparams,
            finite=jnp.asarray(finite), grad_scale=jnp.asarray(factor, jnp.float32),
        )
        topt.step(list(tparams.items()), {k: to_torch(v) for k, v in grads[i].items()},
                  finite=finite, grad_scale=factor)
    return jparams, jstate, tparams, topt


@pytest.mark.parametrize("warmup,nan_at", [(0, None), (3, None), (0, 2), (4, 0)],
                         ids=["constant", "warmup", "nan_skip", "warmup_nan_first"])
def test_adamw_matches_optax(warmup, nan_at):
    jparams, jstate, tparams, topt = _run_both("adamw", torch.float32, warmup=warmup, nan_at=nan_at)
    adam = jstate[0]
    assert int(adam.count) == topt.state["count"] == STEPS - (nan_at is not None)
    for k in SHAPES:
        np.testing.assert_allclose(tparams[k].numpy(), _np(jparams[k]), atol=2e-7, rtol=1e-6)
        np.testing.assert_allclose(topt.state["mu"][k].numpy(), _np(adam.mu[k]), atol=1e-9, rtol=1e-5)
        np.testing.assert_allclose(topt.state["nu"][k].numpy(), _np(adam.nu[k]), atol=1e-12, rtol=1e-5)
    assert not topt.state["compensation"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("kahan,warmup,nan_at", [(True, 0, None), (False, 0, None), (True, 3, 1)],
                         ids=["kahan", "no_kahan", "kahan_warmup_nan"])
def test_any_precision_adamw_matches_jax(dtype, kahan, warmup, nan_at):
    jparams, jstate, tparams, topt = _run_both(
        "adamw_bf16", dtype, kahan=kahan, warmup=warmup, nan_at=nan_at)
    assert int(jstate.count) == topt.state["count"] == STEPS - (nan_at is not None)
    rtol = BF16_ULP if dtype == torch.bfloat16 else 1e-5
    for k in SHAPES:
        assert tparams[k].dtype == dtype and topt.state["mu"][k].dtype == torch.bfloat16
        np.testing.assert_allclose(tparams[k].float().numpy(), _np(jparams[k]), atol=1e-6, rtol=rtol)
        np.testing.assert_allclose(topt.state["mu"][k].float().numpy(), _np(jstate.mu[k]),
                                   atol=1e-8, rtol=BF16_ULP)
        np.testing.assert_allclose(topt.state["nu"][k].float().numpy(), _np(jstate.nu[k]),
                                   atol=1e-10, rtol=BF16_ULP)
        if kahan:
            # the remainder is itself a rounding error: one ulp of the parameter
            scale = np.abs(_np(jparams[k])).max() * (BF16_ULP if dtype == torch.bfloat16 else 1e-6)
            np.testing.assert_allclose(topt.state["compensation"][k].float().numpy(),
                                       _np(jstate.compensation[k]), atol=scale, rtol=0)
    if not kahan:
        assert not topt.state["compensation"]


def test_non_finite_step_changes_nothing_and_unknown_strategy_raises():
    _, tparams, grads, _ = _problem(1, torch.float32)
    opt = AdamW(make_schedule(1e-2), strategy="adamw_bf16")
    g = {k: to_torch(v) for k, v in grads[0].items()}
    opt.step(list(tparams.items()), g, grad_scale=1.0)
    snap = {k: v.clone() for k, v in tparams.items()}
    state = {part: {k: v.clone() for k, v in opt.state[part].items()} for part in ("mu", "nu", "compensation")}
    opt.step(list(tparams.items()), {k: v * float("nan") for k, v in g.items()}, finite=False, grad_scale=0.0)
    assert opt.state["count"] == 1
    for k in SHAPES:
        assert torch.equal(tparams[k], snap[k])
        for part in state:
            assert torch.equal(opt.state[part][k], state[part][k])
    with pytest.raises(ValueError):
        AdamW(make_schedule(1e-2), strategy="sgd")


def test_row_chunked_leaf_equals_whole_leaf(monkeypatch):
    """A leaf walked in row chunks (large leaves, to cap fp32 temporaries)
    ends where the whole-leaf update does."""
    from spatialthinker_torch.trainer import optim

    rng = np.random.default_rng(2)
    p0 = to_torch(rng.normal(size=(9, 8)).astype(np.float32)).bfloat16()
    g = to_torch(rng.normal(size=(9, 8)).astype(np.float32))
    outs = []
    for limit in (1 << 24, 16):
        monkeypatch.setattr(optim, "_CHUNK_ELEMENTS", limit)
        p = p0.clone()
        opt = AdamW(make_schedule(1e-2), strategy="adamw_bf16")
        for _ in range(3):
            opt.step([("p", p)], {"p": g}, grad_scale=0.5)
        outs.append((p, opt.state["mu"]["p"], opt.state["compensation"]["p"]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_reset_moments_keeps_the_count_and_restarts_from_zero():
    _, tparams, grads, _ = _problem(3, torch.float32)
    opt = AdamW(make_schedule(1e-2), strategy="adamw_bf16")
    g = {k: to_torch(v) for k, v in grads[0].items()}
    opt.step(list(tparams.items()), g)
    opt.reset_moments()
    assert opt.state["count"] == 1
    assert not (opt.state["mu"] or opt.state["nu"] or opt.state["compensation"])
    opt.step(list(tparams.items()), g)
    assert opt.state["count"] == 2 and set(opt.state["mu"]) == set(g)
