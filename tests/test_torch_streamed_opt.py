"""The port's host-streamed optimizer (``trainer/streamed_opt.py``) on the CPU.

- Against the port's fused ``adamw_bf16`` (``trainer/optim.py``): bit-equal
  after several steps, with and without Kahan, in bf16 and fp32, with the
  slice loop forced on every leaf (``_STREAM_THRESHOLD = 1``, a small
  ``layer_chunk``), as ``tests/test_streamed_opt.py`` forces it in JAX.
- Against the JAX package's ``StreamedAdamW`` on the same numpy parameters
  and gradients, to ``tests/test_torch_optim.py``'s AnyPrecision tolerances:
  bf16 parameters and moments within one bf16 ulp (rtol 2^-7), fp32
  parameters rtol 1e-5, the Kahan buffer within one ulp of the parameter.
- A non-finite step changes nothing; a frozen vision tower gets no moments and
  stays as it was through a streamed update; ``sample_slices`` counts bytes
  as JAX does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.trainer import streamed_opt as jso
from spatialthinker_torch.trainer import streamed_opt as tso
from spatialthinker_torch.trainer.optim import AdamW, make_schedule
from spatialthinker_torch.trainer.streamed_opt import StreamedAdamW
from tests.test_torch_optim import BF16_ULP, _np
from tests.test_torch_parity import to_torch

SHAPES = {"mat": (16, 8), "odd": (7, 3), "stack": (6, 4, 8), "vec": (8,)}  # in JAX's leaf order
STEPS = 4
SCALES = [1.0, 0.5, 0.013, 0.25]


def _state_bytes(opt):
    """Bytes of an optimizer's moments and compensation buffers."""
    return sum(t.numel() * t.element_size() for part in ("mu", "nu", "compensation")
               for t in opt.state[part].values())


def _problem(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 10 ** rng.uniform(-3, 0)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("kahan", [True, False], ids=["kahan", "no_kahan"])
def test_streamed_equals_fused_bit_for_bit(monkeypatch, dtype, kahan):
    monkeypatch.setattr(tso, "_STREAM_THRESHOLD", 1)  # every leaf in row slices
    params, grads = _problem(0)
    fused_p = {k: to_torch(v).to(dtype) for k, v in params.items()}
    streamed_p = {k: v.clone() for k, v in fused_p.items()}
    kw = dict(b1=0.9, b2=0.95, weight_decay=0.1, use_kahan_summation=kahan)
    fused = AdamW(make_schedule(1e-2, 2), strategy="adamw_bf16", **kw)
    streamed = StreamedAdamW(make_schedule(1e-2, 2), layer_chunk=2, **kw)
    streamed.init(streamed_p.items())
    for i in range(STEPS):
        g = {k: to_torch(v) for k, v in grads[i].items()}
        fused.step(list(fused_p.items()), g, grad_scale=SCALES[i])
        streamed.step(list(streamed_p.items()), g, grad_scale=SCALES[i])
    assert streamed.state["count"] == fused.state["count"] == STEPS
    assert streamed.last_apply_stats["measured_slices"] > len(SHAPES)  # sliced
    for k in SHAPES:
        assert torch.equal(streamed_p[k], fused_p[k]), k
        for part in ("mu", "nu") + (("compensation",) if kahan else ()):
            assert torch.equal(streamed.state[part][k], fused.state[part][k]), (part, k)
    assert bool(streamed.state["compensation"]) == kahan


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("kahan,nan_at", [(True, None), (False, None), (True, 1)],
                         ids=["kahan", "no_kahan", "kahan_nan"])
def test_streamed_matches_jax_streamed(monkeypatch, dtype, kahan, nan_at):
    monkeypatch.setattr(tso, "_STREAM_THRESHOLD", 1)
    monkeypatch.setattr(jso, "_STREAM_THRESHOLD", 1)
    params, grads = _problem(1)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jparams = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    tparams = {k: to_torch(v).to(dtype) for k, v in params.items()}
    jopt = jso.StreamedAdamW(1e-2, b1=0.9, b2=0.95, weight_decay=0.1,
                             use_kahan_summation=kahan, layer_chunk=2)
    jstate = jopt.init(jparams)
    topt = StreamedAdamW(make_schedule(1e-2), b1=0.9, b2=0.95, weight_decay=0.1,
                         use_kahan_summation=kahan, layer_chunk=2)
    topt.init(tparams.items())
    for i in range(STEPS):
        finite = i != nan_at
        factor = SCALES[i] if finite else 0.0
        jparams, jstate = jopt.apply(jparams, {k: jnp.asarray(v) for k, v in grads[i].items()}, jstate,
                                     finite=jnp.asarray(finite), grad_scale=jnp.float32(factor))
        topt.step(list(tparams.items()), {k: to_torch(v) for k, v in grads[i].items()},
                  finite=finite, grad_scale=factor)
    assert jstate.count == topt.state["count"] == STEPS - (nan_at is not None)
    assert jopt.last_apply_stats == topt.last_apply_stats
    rtol = BF16_ULP if dtype == torch.bfloat16 else 1e-5
    for k in SHAPES:
        np.testing.assert_allclose(tparams[k].float().numpy(), _np(jparams[k]), atol=1e-6, rtol=rtol)
        np.testing.assert_allclose(topt.state["mu"][k].float().numpy(), _np(jstate.mu[k]),
                                   atol=1e-8, rtol=BF16_ULP)
        np.testing.assert_allclose(topt.state["nu"][k].float().numpy(), _np(jstate.nu[k]),
                                   atol=1e-10, rtol=BF16_ULP)
        if kahan:
            scale = np.abs(_np(jparams[k])).max() * (BF16_ULP if dtype == torch.bfloat16 else 1e-6)
            np.testing.assert_allclose(topt.state["compensation"][k].float().numpy(),
                                       _np(jstate.compensation[k]), atol=scale, rtol=0)


def test_non_finite_step_changes_nothing():
    params, grads = _problem(2)
    tparams = {k: to_torch(v).bfloat16() for k, v in params.items()}
    opt = StreamedAdamW(make_schedule(1e-2))
    opt.init(tparams.items())
    g = {k: to_torch(v) for k, v in grads[0].items()}
    opt.step(list(tparams.items()), g, grad_scale=1.0)
    stats = dict(opt.last_apply_stats)
    snap = {k: v.clone() for k, v in tparams.items()}
    state = {part: {k: v.clone() for k, v in opt.state[part].items()}
             for part in ("mu", "nu", "compensation")}
    opt.step(list(tparams.items()), {k: v * float("nan") for k, v in g.items()}, finite=False,
             grad_scale=0.0)
    assert opt.state["count"] == 1 and opt.last_apply_stats == stats
    for k in SHAPES:
        assert torch.equal(tparams[k], snap[k])
        for part in state:
            assert torch.equal(opt.state[part][k], state[part][k])


def test_sample_slices_count_bytes_as_jax(monkeypatch):
    """The timing knob: the first N slices go through, every slice's bytes
    are counted; the counts equal JAX's on the same shapes."""
    monkeypatch.setattr(tso, "_STREAM_THRESHOLD", 1)
    monkeypatch.setattr(jso, "_STREAM_THRESHOLD", 1)
    params, grads = _problem(3)
    full_p = {k: to_torch(v).clone() for k, v in params.items()}  # not over the numpy arrays
    samp_p = {k: v.clone() for k, v in full_p.items()}
    g = {k: to_torch(v) for k, v in grads[0].items()}
    full, samp = StreamedAdamW(make_schedule(1e-2), layer_chunk=2), StreamedAdamW(make_schedule(1e-2), layer_chunk=2)
    full.init(full_p.items())
    samp.init(samp_p.items())
    full.step(list(full_p.items()), g, grad_scale=1.0)
    samp.step(list(samp_p.items()), g, grad_scale=1.0, sample_slices=2)

    for n in (0, 2):
        jparams = {k: jnp.asarray(v) for k, v in params.items()}  # donated by the apply
        jopt = jso.StreamedAdamW(1e-2, use_kahan_summation=True, layer_chunk=2)
        jopt.apply(jparams, {k: jnp.asarray(v) for k, v in grads[0].items()}, jopt.init(jparams),
                   finite=jnp.asarray(True), grad_scale=jnp.float32(1.0), sample_slices=n)
        assert jopt.last_apply_stats == (samp if n else full).last_apply_stats
    stats = samp.last_apply_stats
    assert stats["measured_slices"] == 2 and 0 < stats["measured_bytes"] < stats["total_bytes"]
    assert stats["total_bytes"] == full.last_apply_stats["total_bytes"] == _state_bytes(full)
    # the first leaf's first two slices moved as in the full step; the rest did not move
    first = next(iter(SHAPES))
    assert torch.equal(samp_p[first][:4], full_p[first][:4])
    assert torch.equal(samp_p[first][4:], to_torch(params[first])[4:])


def test_frozen_vision_tower_gets_no_moments_and_stays():
    """A streamed packed update with ``freeze_vision_tower``: no host moments
    for the tower, the tower bit for bit as it was, the decoder moved."""
    from tests.test_torch_parity import both_models
    from tests.test_torch_train_step import KNOBS, rollout_arrays, _micro, _torch_batch, _torch_vision, _vision
    from spatialthinker_torch.data import packing as tpk
    from spatialthinker_torch.data.text_packing import pack_train_rows
    from spatialthinker_torch.trainer import train_step as tts
    from tests.test_torch_parity import CFG

    _, model = both_models(seed=4)
    opt = tso.make_streamed_optimizer(1e-3)
    opt.init(tts.trainable_parameters(model, freeze_vision_tower=True))
    assert opt.state["mu"] and not any(n.startswith("vision.") for n in opt.state["mu"])
    assert set(opt.state["compensation"]) == set(opt.state["mu"])

    a = rollout_arrays(5, True)
    per_token = {k: a[k] for k in ("old_log_probs", "ref_log_probs", "advantages")}
    packed, slot_map = pack_train_rows(a["input_ids"], a["segment_ids"], a["position_ids"], a["responses"],
                                       a["response_mask"], a["gen_pos_start"], per_token, 64)
    n_rows = packed.input_ids.shape[0]
    rows_of = [[i for i in sorted(range(4), key=lambda i: int(slot_map.dst_start[i]))
                if slot_map.row[i] == g] for g in range(n_rows)]
    pb = {k: _micro(v, n_rows) for k, v in packed._asdict().items()}
    tvis = tpk.stack_vision_packs([_vision(tpk, CFG.vision, a, r) for r in rows_of], CFG.vision)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    update = tts.make_packed_update_fn(model, opt, freeze_vision_tower=True, remat="dots", **KNOBS)
    update(_torch_batch(tts.PackedTrainBatch, pb), _torch_vision(tvis))
    after = model.state_dict()
    assert opt.state["count"] == 1
    assert all(torch.equal(after[k], before[k]) for k in before if k.startswith("vision."))
    assert any(not torch.equal(after[k], before[k]) for k in before if k.startswith("text."))
