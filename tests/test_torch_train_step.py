"""The slice as a whole on the CPU: one JAX tiny tree carried into the port,
one rollout batch (text-only and multimodal) through the port's
``trainer/train_step.py`` and the JAX package's -- log-probs (per-sample and
packed), packed loss = unpacked loss, and one update step with 2
micro-batches through ``make_update_fn`` and ``make_packed_update_fn``:
metrics, gradients and the updated parameters leaf by leaf.

Tolerances (fp32 on both sides, the same math in another summation order
through 2 text layers and 2 vision blocks): log-probs and metrics atol/rtol
1e-4; gradients 2e-4 of each leaf's largest magnitude (a floor of 1e-7).
Updated parameters are held in units of lr: the first Adam step is
``lr * g / (|g| + eps)``, so where |g| ~ eps = 1e-8 (a handful of elements of
a leaf) a 1e-9 difference in g moves the step by a sizeable part of lr, and
everywhere else hardly at all. So: no element further than 1.1 lr from the
JAX package's (a whole step), and at most 1 in 1000 of a leaf's elements
further than 0.05 lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.data import packing as jpk
from spatialthinker_tpu.data.text_packing import pack_train_rows as jax_pack_train_rows
from spatialthinker_tpu.models.qwen2_5_vl import VisionInputs as JaxVisionInputs
from spatialthinker_tpu.trainer import train_step as jts
from spatialthinker_torch.data import packing as tpk
from spatialthinker_torch.data.text_packing import gather_response_values, pack_train_rows
from spatialthinker_torch.models.qwen2_5_vl import VisionInputs, get_mrope_position_ids
from spatialthinker_torch.models.qwen2_5_vl.params import optimizer_state_from_jax, params_to_jax
from spatialthinker_torch.trainer import train_step as tts
from tests.test_torch_parity import CFG, JAX_CFG, both_models, to_torch

TOL = dict(atol=1e-4, rtol=1e-4)
LR = 1e-3
KNOBS = dict(clip_ratio_low=0.2, clip_ratio_high=0.3, clip_ratio_dual=3.0, use_kl_loss=True,
             kl_loss_coef=0.01, kl_penalty="low_var_kl", entropy_coeff=0.001, max_grad_norm=1.0,
             chunk_size=4, temperature=0.9)
GRIDS = [(1, 4, 4), (1, 6, 6)]


def rollout_arrays(seed: int, multimodal: bool, b: int = 4, p: int = 24, r: int = 8):
    """A rollout batch as host arrays: left-padded prompts (each with one
    image when ``multimodal``), mRoPE positions, responses of random length
    and random per-token quantities."""
    rng = np.random.default_rng(seed)
    cfg = CFG
    dim = tpk.patch_dim(cfg.vision)
    ids = np.zeros((b, p), np.int32)
    seg = np.zeros((b, p), np.int32)
    pos = np.ones((b, 3, p), np.int64)
    gen_start = np.zeros(b, np.int64)
    patches, grids = [], []
    for i in range(b):
        text = lambda n: list(rng.integers(8, 900, size=n))  # noqa: E731
        grid = GRIDS[i % 2]
        body = text(int(rng.integers(2, 5)))
        if multimodal:
            n_img = grid[0] * grid[1] * grid[2] // cfg.vision.spatial_merge_unit
            body += [cfg.vision_start_token_id] + [cfg.image_token_id] * n_img + [cfg.vision_end_token_id]
        body += text(int(rng.integers(2, 6)))
        n = len(body)
        ids[i, p - n:] = body
        seg[i, p - n:] = 1
        pos3, _ = get_mrope_position_ids(
            np.asarray(body), np.asarray([grid]) if multimodal else None,
            spatial_merge_size=cfg.vision.spatial_merge_size, image_token_id=cfg.image_token_id,
            video_token_id=cfg.video_token_id, vision_start_token_id=cfg.vision_start_token_id,
        )
        pos[i, :, p - n:] = pos3
        gen_start[i] = pos3.max() + 1
        patches.append(rng.normal(size=(grid[0] * grid[1] * grid[2], dim)).astype(np.float32)
                       if multimodal else None)
        grids.append(np.asarray([grid]) if multimodal else None)
    rlen = rng.integers(2, r + 1, size=b)
    mask = (np.arange(r)[None, :] < rlen[:, None]).astype(np.int32)
    responses = (rng.integers(8, 900, size=(b, r)) * mask).astype(np.int32)
    per_token = {k: (rng.normal(size=(b, r)) * s + m).astype(np.float32) * mask
                 for k, s, m in (("old_log_probs", 0.3, -6.9), ("ref_log_probs", 0.3, -6.9),
                                 ("advantages", 1.0, 0.0))}
    return dict(input_ids=ids, segment_ids=seg, position_ids=pos, gen_pos_start=gen_start,
                responses=responses, response_mask=mask, patches=patches, grids=grids, **per_token)


def train_batch_arrays(a):
    """The TrainBatch fields (host arrays) of a rollout batch."""
    b, r = a["responses"].shape
    gen_pos = a["gen_pos_start"][:, None] + np.arange(r)[None, :]
    full_pos = np.concatenate(
        [a["position_ids"].transpose(1, 0, 2), np.broadcast_to(gen_pos[None], (3, b, r))], axis=2)
    return dict(
        input_ids=np.concatenate([a["input_ids"], a["responses"]], axis=1),
        segment_ids=np.concatenate([a["segment_ids"], a["response_mask"]], axis=1),
        position_ids=full_pos.astype(np.int32), responses=a["responses"],
        response_mask=a["response_mask"].astype(np.float32), old_log_probs=a["old_log_probs"],
        ref_log_probs=a["ref_log_probs"], advantages=a["advantages"],
    )


def _vision(mod, cfg, a, rows):
    return mod.pack_vision_batch([a["patches"][i] for i in rows], [a["grids"][i] for i in rows],
                                 cfg, granularity=64)


def _micro(x, n_micro):
    x = np.asarray(x)
    if x.ndim >= 2 and x.shape[0] == 3:
        return x.reshape(3, n_micro, -1, x.shape[-1]).transpose(1, 0, 2, 3)
    return x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])


def _jax_vision(pack):
    return None if pack is None else JaxVisionInputs(*(jnp.asarray(x) for x in pack[:5]))


def _torch_vision(pack):
    return None if pack is None else VisionInputs(*(to_torch(x) for x in pack))


def _torch_batch(cls, fields):
    def conv(k, v):
        t = to_torch(v)
        return t.long() if k in ("input_ids", "responses", "labels") else t
    return cls(**{k: conv(k, v) for k, v in fields.items()})


@pytest.fixture(scope="module")
def models():
    return both_models(seed=0)


@pytest.mark.parametrize("multimodal", [False, True], ids=["text", "multimodal"])
def test_log_probs_per_sample_and_packed_match_jax(models, multimodal):
    jax_params, model = models
    a = rollout_arrays(1, multimodal)
    tb = train_batch_arrays(a)
    rows = range(len(a["responses"]))
    ref, ref_ent = jts.compute_log_probs(
        jax_params, JAX_CFG, jts.TrainBatch(**{k: jnp.asarray(v) for k, v in tb.items()}),
        _jax_vision(_vision(jpk, JAX_CFG.vision, a, rows)), chunk_size=4, compute_entropy=True,
        temperature=0.9)
    with torch.no_grad():
        got, got_ent = tts.compute_log_probs(
            model, _torch_batch(tts.TrainBatch, tb), _torch_vision(_vision(tpk, CFG.vision, a, rows)),
            chunk_size=4, compute_entropy=True, temperature=0.9)
    mask = a["response_mask"].astype(bool)
    np.testing.assert_allclose(got.numpy()[mask], np.asarray(ref)[mask], **TOL)
    np.testing.assert_allclose(got_ent.numpy()[mask], np.asarray(ref_ent)[mask], **TOL)

    # packed rows: the same log-probs gathered back to the response layout
    packed, slot_map = pack_train_rows(
        a["input_ids"], a["segment_ids"], a["position_ids"], a["responses"], a["response_mask"],
        a["gen_pos_start"], row_len=64)
    order = sorted(rows, key=lambda i: (int(slot_map.row[i]), int(slot_map.dst_start[i])))
    ref_rows = jts.compute_packed_log_probs(
        jax_params, JAX_CFG, jts.PackedTrainBatch(*(jnp.asarray(x) for x in packed)),
        _jax_vision(_vision(jpk, JAX_CFG.vision, a, order)), chunk_size=16, temperature=0.9)[0]
    with torch.no_grad():
        got_rows = tts.compute_packed_log_probs(
            model, _torch_batch(tts.PackedTrainBatch, packed._asdict()),
            _torch_vision(_vision(tpk, CFG.vision, a, order)), chunk_size=16, temperature=0.9)[0]
    np.testing.assert_allclose(got_rows.numpy(), np.asarray(ref_rows), **TOL)
    back = gather_response_values(got_rows.numpy(), slot_map, a["responses"].shape[1])
    np.testing.assert_allclose(back[mask], got.numpy()[mask], **TOL)
    assert slot_map.num_rows < len(a["responses"])  # something was actually packed


def _grads_close(got_tree, ref_tree):
    flat_got = jax.tree_util.tree_leaves_with_path(got_tree)
    flat_ref = jax.tree.leaves(ref_tree)
    assert len(flat_got) == len(flat_ref)
    for (path, g), r in zip(flat_got, flat_ref):
        r = np.asarray(r)
        tol = max(2e-4 * np.abs(r).max(), 1e-7)
        np.testing.assert_allclose(g, r, atol=tol, rtol=0, err_msg=jax.tree_util.keystr(path))


def _params_close(model, ref_tree, lr):
    got = params_to_jax(model.state_dict(), CFG)
    for (path, g), r in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(ref_tree)):
        diff = np.abs(g - np.asarray(r))
        name = jax.tree_util.keystr(path)
        assert diff.max() <= 1.1 * lr + 1e-7, (name, diff.max())
        assert (diff > 0.05 * lr + 1e-7).mean() <= 1e-3, (name, (diff > 0.05 * lr).mean())


@pytest.mark.parametrize("strategy", ["adamw", "adamw_bf16"])
def test_update_step_matches_jax(strategy):
    """One unpacked update with 2 micro-batches on a multimodal batch."""
    jax_params, model = both_models(seed=1)
    a = rollout_arrays(2, True)
    tb = {k: _micro(v, 2) for k, v in train_batch_arrays(a).items()}
    halves = ([0, 1], [2, 3])
    jvis = jpk.stack_vision_packs([_vision(jpk, JAX_CFG.vision, a, h) for h in halves], JAX_CFG.vision)
    tvis = tpk.stack_vision_packs([_vision(tpk, CFG.vision, a, h) for h in halves], CFG.vision)

    jopt = jts.make_optimizer(LR, strategy=strategy)
    jgrad = jts.make_grad_fn(JAX_CFG, remat=True, **KNOBS)
    jbatch = jts.TrainBatch(**{k: jnp.asarray(v) for k, v in tb.items()})
    ref_grads, ref_metrics, ref_finite, ref_factor = jax.jit(jgrad)(jax_params, jbatch, _jax_vision(jvis))
    new_params, _, ref_metrics2 = jax.jit(jts.make_update_fn(JAX_CFG, jopt, remat=True, **KNOBS))(
        jax_params, jopt.init(jax_params), jbatch, _jax_vision(jvis))

    tbatch, tvision = _torch_batch(tts.TrainBatch, tb), _torch_vision(tvis)
    grads, metrics, finite, factor = tts.make_grad_fn(model, remat=True, **KNOBS)(tbatch, tvision)
    assert finite == bool(ref_finite)
    np.testing.assert_allclose(factor, float(ref_factor), rtol=1e-4)
    assert metrics.keys() == ref_metrics.keys()
    for k in ref_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]), err_msg=k, **TOL)
    _grads_close(params_to_jax(grads, CFG), ref_grads)
    assert all(p.grad is None for p in model.parameters())

    opt = tts.make_optimizer(LR, strategy=strategy)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics2 = tts.make_update_fn(model, opt, remat=True, **KNOBS)(tbatch, tvision)
    for k in ref_metrics2:
        np.testing.assert_allclose(float(metrics2[k]), float(ref_metrics2[k]), err_msg=k, **TOL)
    _params_close(model, new_params, LR)
    assert opt.state["count"] == 1
    moved = max(float((model.state_dict()[k] - before[k]).abs().max()) for k in before)
    assert 0.5 * LR < moved < 1.5 * LR


@pytest.mark.parametrize("multimodal", [False, True], ids=["text", "multimodal"])
def test_packed_update_step_matches_jax_and_packed_loss_equals_unpacked(models, multimodal):
    jax_params, model = both_models(seed=2)
    a = rollout_arrays(3, multimodal)
    per_token = {k: a[k] for k in ("old_log_probs", "ref_log_probs", "advantages")}
    args = (a["input_ids"], a["segment_ids"], a["position_ids"], a["responses"], a["response_mask"],
            a["gen_pos_start"], per_token, 64 if multimodal else 40)
    packed, slot_map = pack_train_rows(*args)
    ref_packed, _ = jax_pack_train_rows(*args)
    n_rows = packed.input_ids.shape[0]
    assert n_rows == 2  # two micro-batches of one packed row each
    rows_of = [[i for i in sorted(range(4), key=lambda i: int(slot_map.dst_start[i]))
                if slot_map.row[i] == g] for g in range(n_rows)]

    # packed loss on all rows = unpacked loss on all samples
    loss_kw = {k: v for k, v in KNOBS.items() if k != "max_grad_norm"}
    order = [i for rows in rows_of for i in rows]
    with torch.no_grad():
        loss_p, m_p = tts.packed_actor_loss_fn(
            model, _torch_batch(tts.PackedTrainBatch, packed._asdict()),
            _torch_vision(_vision(tpk, CFG.vision, a, order)), remat=False, **loss_kw)
        loss_u, m_u = tts.actor_loss_fn(
            model, _torch_batch(tts.TrainBatch, train_batch_arrays(a)),
            _torch_vision(_vision(tpk, CFG.vision, a, range(4))), remat=False, **loss_kw)
    np.testing.assert_allclose(float(loss_p), float(loss_u), **TOL)
    for k in m_u:
        np.testing.assert_allclose(float(m_p[k]), float(m_u[k]), err_msg=k, **TOL)

    # one packed update, one row per micro-batch
    pb = {k: _micro(v, n_rows) for k, v in packed._asdict().items()}
    jvis = jpk.stack_vision_packs([_vision(jpk, JAX_CFG.vision, a, r) for r in rows_of], JAX_CFG.vision)
    tvis = tpk.stack_vision_packs([_vision(tpk, CFG.vision, a, r) for r in rows_of], CFG.vision)
    jopt = jts.make_optimizer(LR)
    jbatch = jts.PackedTrainBatch(**{k: jnp.asarray(_micro(v, n_rows)) for k, v in ref_packed._asdict().items()})
    new_params, _, ref_metrics = jax.jit(jts.make_packed_update_fn(JAX_CFG, jopt, remat=True, **KNOBS))(
        jax_params, jopt.init(jax_params), jbatch, _jax_vision(jvis))
    opt = tts.make_optimizer(LR)
    metrics = tts.make_packed_update_fn(model, opt, remat=True, **KNOBS)(
        _torch_batch(tts.PackedTrainBatch, pb), _torch_vision(tvis))
    assert metrics.keys() == ref_metrics.keys()
    for k in ref_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]), err_msg=k, **TOL)
    _params_close(model, new_params, LR)


def test_second_step_from_carried_optimizer_state_matches_jax():
    """Adam state carried from the JAX package into the port's optimizer: a
    step from a warm state agrees too (the count, the moments and the bias
    corrections all enter)."""
    jax_params, model = both_models(seed=3)
    a = rollout_arrays(4, False)
    tb = {k: _micro(v, 2) for k, v in train_batch_arrays(a).items()}
    jbatch = jts.TrainBatch(**{k: jnp.asarray(v) for k, v in tb.items()})
    jopt = jts.make_optimizer(LR, warmup_steps=4)
    jupdate = jax.jit(jts.make_update_fn(JAX_CFG, jopt, remat=False, **KNOBS))
    p1, s1, _ = jupdate(jax_params, jopt.init(jax_params), jbatch, None)
    p2, _, ref_metrics = jupdate(p1, s1, jbatch, None)

    from spatialthinker_torch.models.qwen2_5_vl import build_model, params_from_jax
    model = build_model(CFG, params_from_jax(jax.tree.map(np.asarray, p1), CFG), device="cpu",
                        dtype=torch.float32)
    opt = tts.make_optimizer(LR, warmup_steps=4)
    adam = s1[0]
    opt.state = optimizer_state_from_jax(
        CFG, count=int(adam.count), mu=jax.tree.map(np.asarray, adam.mu),
        nu=jax.tree.map(np.asarray, adam.nu))
    metrics = tts.make_update_fn(model, opt, remat=False, **KNOBS)(_torch_batch(tts.TrainBatch, tb), None)
    for k in ref_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]), err_msg=k, **TOL)
    _params_close(model, p2, LR * 2 / 4)  # the warmup's second step: lr * 1/4
    assert opt.state["count"] == 2


def test_freeze_vision_tower_and_remat_and_nan_skip(models):
    _, model0 = models
    a = rollout_arrays(5, True)
    tb = _torch_batch(tts.TrainBatch, {k: _micro(v, 2) for k, v in train_batch_arrays(a).items()})
    tvis = _torch_vision(tpk.stack_vision_packs(
        [_vision(tpk, CFG.vision, a, h) for h in ([0, 1], [2, 3])], CFG.vision))

    # remat on = off: same gradients, bit for bit on the CPU
    import copy
    model = copy.deepcopy(model0)
    g_on, m_on, _, _ = tts.make_grad_fn(model, remat=True, **KNOBS)(tb, tvis)
    g_off, m_off, _, _ = tts.make_grad_fn(model, remat=False, **KNOBS)(tb, tvis)
    assert g_on.keys() == g_off.keys() == dict(model.named_parameters()).keys()
    for k in g_on:
        torch.testing.assert_close(g_on[k], g_off[k], atol=1e-7, rtol=1e-5, msg=k)
    assert float(m_on["actor/grad_norm"]) > 0
    assert any(float(g_on[k].abs().max()) > 0 for k in g_on if k.startswith("vision."))

    # frozen vision tower: exactly as it was (weight decay included), text moved
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = tts.make_optimizer(1e-2, weight_decay=0.1)
    metrics = tts.make_update_fn(model, opt, remat=False, freeze_vision_tower=True, **KNOBS)(tb, tvis)
    after = model.state_dict()
    assert all(torch.equal(after[k], before[k]) for k in before if k.startswith("vision."))
    assert max(float((after[k] - before[k]).abs().max()) for k in before if k.startswith("text.")) > 0
    assert not any(k.startswith("vision.") for k in opt.state["mu"])
    assert all(p.requires_grad for p in model.parameters())
    frozen_norm = float(metrics["actor/grad_norm"])
    assert 0 < frozen_norm < float(m_on["actor/grad_norm"]) * 1.0001

    # a non-finite gradient leaves parameters, moments and count untouched
    snap = {k: v.clone() for k, v in model.state_dict().items()}
    mu = {k: v.clone() for k, v in opt.state["mu"].items()}
    bad = tb._replace(advantages=tb.advantages * float("nan"))
    metrics = tts.make_update_fn(model, opt, remat=False, **KNOBS)(bad, tvis)
    assert not np.isfinite(float(metrics["actor/grad_norm"]))
    assert all(torch.equal(model.state_dict()[k], snap[k]) for k in snap)
    assert all(torch.equal(opt.state["mu"][k], mu[k]) for k in mu) and opt.state["count"] == 1


def test_packed_update_with_frozen_vision_matches_jax_unpacked_update(models):
    """``freeze_vision_tower`` on the packed update (the trainer's default
    path): every ``vision.*`` parameter stays bit-equal and gets no Adam
    moment, and the text parameters equal those of the JAX package's
    UNPACKED update with the freeze (its packed update ignores the knob, a
    reference caveat) on micro-batches of the same samples as the packed
    rows. Tolerances as in the packed-update parity test above."""
    import copy

    jax_params, model0 = models
    model = copy.deepcopy(model0)
    a = rollout_arrays(3, True)
    per_token = {k: a[k] for k in ("old_log_probs", "ref_log_probs", "advantages")}
    packed, slot_map = pack_train_rows(a["input_ids"], a["segment_ids"], a["position_ids"], a["responses"],
                                       a["response_mask"], a["gen_pos_start"], per_token, 64)
    n_rows = packed.input_ids.shape[0]
    rows_of = [[i for i in sorted(range(4), key=lambda i: int(slot_map.dst_start[i]))
                if slot_map.row[i] == g] for g in range(n_rows)]
    assert n_rows == 2 and [len(r) for r in rows_of] == [2, 2]

    order = [i for rows in rows_of for i in rows]
    tb = {k: _micro(v[:, order] if k == "position_ids" else v[order], n_rows)
          for k, v in train_batch_arrays(a).items()}
    jvis = jpk.stack_vision_packs([_vision(jpk, JAX_CFG.vision, a, r) for r in rows_of], JAX_CFG.vision)
    jopt = jts.make_optimizer(LR, weight_decay=0.1)
    new_params, _, ref_metrics = jax.jit(jts.make_update_fn(
        JAX_CFG, jopt, remat=True, freeze_vision_tower=True, **KNOBS))(
        jax_params, jopt.init(jax_params), jts.TrainBatch(**{k: jnp.asarray(v) for k, v in tb.items()}),
        _jax_vision(jvis))

    tvis = tpk.stack_vision_packs([_vision(tpk, CFG.vision, a, r) for r in rows_of], CFG.vision)
    pb = {k: _micro(v, n_rows) for k, v in packed._asdict().items()}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = tts.make_optimizer(LR, weight_decay=0.1)
    metrics = tts.make_packed_update_fn(model, opt, remat=True, freeze_vision_tower=True, **KNOBS)(
        _torch_batch(tts.PackedTrainBatch, pb), _torch_vision(tvis))
    after = model.state_dict()
    assert all(torch.equal(after[k], before[k]) for k in before if k.startswith("vision."))
    assert not any(k.startswith("vision.") for k in opt.state["mu"])
    assert opt.state["mu"] and all(k.startswith("text.") for k in opt.state["mu"])
    assert all(p.requires_grad for p in model.parameters())
    for k in ref_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]), err_msg=k, **TOL)
    _params_close(model, new_params, LR)
