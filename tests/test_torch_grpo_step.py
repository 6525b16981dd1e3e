"""The per-step glue of ``spatialthinker_torch/trainer/grpo_trainer.py``
against the ``GRPOTrainer`` methods it was lifted from (called unbound on a
stub that carries only the attributes each method reads), and a two-step CPU
run of ``chip_smoke.py``'s GRPO step on the tiny model that checks the
invariants the smoke checks on the card.

Host functions (packing, views, mini-batch order) must agree exactly;
advantages go through fp32 group statistics on both sides: atol/rtol 1e-5.
"""

from types import SimpleNamespace

import copy
import numpy as np
import pytest
import torch

import chip_smoke
from spatialthinker_tpu.core.batch import RolloutBatch as JaxRolloutBatch
from spatialthinker_tpu.trainer.grpo_trainer import GRPOTrainer
from spatialthinker_torch.core.batch import RolloutBatch
from spatialthinker_torch.data import packing as tpk
from spatialthinker_torch.rollout import paged as tp
from spatialthinker_torch.rollout.sampling import SamplingParams
from spatialthinker_torch.trainer import grpo_trainer as gt
from spatialthinker_torch.trainer.train_step import make_optimizer, make_packed_update_fn, make_update_fn
from tests.test_torch_parity import CFG, JAX_CFG, both_models
from tests.test_torch_train_step import rollout_arrays

N = 2  # samples per prompt


def _batches(seed, multimodal=True, b=4):
    """The same rolled-out batch (b prompts x N samples) as the port's and the
    JAX package's RolloutBatch."""
    a = rollout_arrays(seed, multimodal, b=b)
    idx = np.repeat(np.arange(b), N)
    rng = np.random.default_rng(seed + 100)
    r = a["responses"].shape[1]
    rlen = rng.integers(1, r + 1, size=b * N)
    mask = (np.arange(r)[None, :] < rlen[:, None]).astype(np.int32)
    responses = (rng.integers(8, 900, size=(b * N, r)) * mask).astype(np.int32)
    tensors = {k: a[k][idx] for k in ("input_ids", "segment_ids", "position_ids", "gen_pos_start")}
    obj = chip_smoke._objects
    non_tensors = {"patches": obj([a["patches"][i] for i in idx]),
                   "image_grid_thw": obj([a["grids"][i] for i in idx]),
                   "uid": obj([f"uid-{(7 * i) % 5}" for i in idx])}  # unique order != row order
    logp = (rng.normal(size=(b * N, r)) * 0.1 - 5).astype(np.float32) * mask
    out = []
    for cls, fn in ((RolloutBatch, gt.rollout_batch_from_result), (JaxRolloutBatch, None)):
        repeated = cls(tensors=dict(tensors), non_tensors=dict(non_tensors))
        if fn is None:  # assembled as generate_sequences does
            repeated.tensors.update(
                responses=responses, response_mask=mask, rollout_log_probs=logp,
                full_input_ids=np.concatenate([tensors["input_ids"], responses], axis=1),
                full_segment_ids=np.concatenate([tensors["segment_ids"], mask], axis=1))
            out.append(repeated)
        else:
            out.append(fn(repeated, responses, mask, logp))
    scores = np.zeros((b * N, r), np.float32)
    scores[np.arange(b * N), rlen - 1] = rng.random(b * N)
    advantages = rng.normal(size=(b * N, r)).astype(np.float32) * mask
    for batch in out:
        batch.tensors["token_level_rewards"] = scores
        batch.tensors["old_log_probs"] = logp
        batch.tensors["advantages"] = advantages
    return out


def _stub(**kw):
    return SimpleNamespace(_negotiated_max=lambda x: x, model_cfg=JAX_CFG, **kw)


def _copied_images(batch):
    """``batch`` with every image entry copied to an array object of its own:
    no two samples share one, so nothing is packed once for several."""
    batch.non_tensors["patches"] = chip_smoke._objects([np.array(p) for p in batch.non_tensors["patches"]])
    return batch


def _image_tokens(pack, n_tokens, unit):
    """Per merged image token of a pack, in the rows' order: its patch rows,
    rotary ids, full-attention and window segment ids (the layout slot
    ``reverse_index`` names, ``unit`` patches a slot)."""
    rows = pack.reverse_index[:n_tokens, None].astype(np.int64) * unit + np.arange(unit)
    return pack.patches[rows], pack.pos_ids[rows], pack.seg_full[rows], pack.seg_window[rows]


def _same_partition(a, b):
    """``a`` and ``b`` label the same items alike: one label of ``a`` for
    each of ``b`` and back."""
    return len(set(zip(a.tolist(), b.tolist()))) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("images", ["repeated", "distinct"])
def test_assembly_views_and_packing_equal_the_trainer_methods(images):
    """The assembly and the packers against the JAX trainer's methods. The
    vision pack: with every image its own object, equal to the JAX
    trainer's field by field; with each prompt's image one object in its N
    samples (as ``RolloutBatch.repeat`` leaves it), each image held once and
    every image token's patch rows and rotary ids equal to the JAX pack's,
    each image's tokens in one full-attention segment and in the same
    windows in both."""
    ours, theirs = _batches(0)
    if images == "distinct":
        _copied_images(ours)
    assert ours.tensors.keys() == theirs.tensors.keys()
    for k in theirs.tensors:
        np.testing.assert_array_equal(ours.tensors[k], theirs.tensors[k], err_msg=k)
    ref_tb = GRPOTrainer._train_batch_views_np(_stub(), theirs)
    for name, a, b in zip(ref_tb._fields, gt.train_batch_views(ours), ref_tb):
        np.testing.assert_array_equal(a, b, err_msg=name)

    per_token = {k: ours.tensors[k] for k in ("old_log_probs", "advantages")}
    packed, slot_map = gt.pack_rows(ours, per_token=per_token)
    ref_packed, ref_map = GRPOTrainer._pack_rows(_stub(), theirs, per_token=per_token)
    assert slot_map.row_len == ref_map.row_len and slot_map.row_len % 256 == 0
    for name, a, b in zip(packed._fields, packed, ref_packed):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(slot_map.row, ref_map.row)

    unit = CFG.vision.spatial_merge_unit
    for lo, hi in ((None, None), (0, 1)):
        got = gt.vision_for_packed(ours, slot_map, CFG.vision, row_lo=lo, row_hi=hi)
        ref = GRPOTrainer._vision_for_packed(_stub(), theirs, ref_map, row_lo=lo, row_hi=hi)
        if images == "distinct":
            for name in got._fields:
                np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
            continue
        # the samples in the rows' order; each image token labelled by its
        # sample and by its image (the array object the sample shows)
        order = sorted(range(len(ours)), key=lambda i: (slot_map.row[i], slot_map.dst_start[i]))
        objs = [ours.non_tensors["patches"][i] for i in order if lo is None or lo <= slot_map.row[i] < hi]
        first = {}
        for p in objs:
            first.setdefault(id(p), len(first))
        tokens = [len(p) // unit for p in objs]
        sample = np.repeat(np.arange(len(objs)), tokens)
        image = np.repeat([first[id(p)] for p in objs], tokens)
        assert len(first) < len(objs)  # some image is shown by two samples
        held = sum(len(p) for p in {id(p): p for p in objs}.values())
        assert tpk.held_patch_count(got) == held < tpk.held_patch_count(ref) == sum(len(p) for p in objs)
        mine, want = (_image_tokens(v, len(sample), unit) for v in (got, ref))
        np.testing.assert_array_equal(mine[0], want[0], err_msg="patches")
        np.testing.assert_array_equal(mine[1], want[1], err_msg="pos_ids")
        for seg_full, seg_window in (mine[2:], want[2:]):
            assert (seg_full > 0).all() and (seg_window > 0).all()
            assert (seg_full == seg_full[:, :1]).all()  # a merged token's patches: one segment
        # one full-attention segment an image: its samples' tokens share it
        # here, each sample has its own in the JAX pack
        assert _same_partition(image, mine[2][:, 0]) and _same_partition(sample, want[2][:, 0])
        for s in range(len(objs)):  # each sample's image in the same windows in both packs
            at = sample == s
            assert _same_partition(mine[3][at].reshape(-1), want[3][at].reshape(-1))


@pytest.mark.parametrize("estimator", ["grpo", "rloo", "reinforce_plus_plus", "remax", "gae"])
def test_compute_advantages_equals_the_trainer_method(estimator):
    ours, theirs = _batches(1, multimodal=False)
    rng = np.random.default_rng(5)
    for batch in (ours, theirs):
        batch.tensors["reward_baselines"] = np.linspace(-1, 1, len(ours)).astype(np.float32)
        batch.tensors["values"] = np.sin(np.arange(ours.tensors["responses"].size, dtype=np.float32)
                                         ).reshape(ours.tensors["responses"].shape)
    stub = _stub(adv_estimator=estimator,
                 config=SimpleNamespace(algorithm=SimpleNamespace(gamma=0.98, lam=0.9)))
    ref_adv, ref_ret = GRPOTrainer.compute_advantages(stub, theirs)
    adv, ret = gt.compute_advantages(ours, estimator, gamma=0.98, lam=0.9)
    np.testing.assert_allclose(adv, ref_adv, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ret, ref_ret, atol=1e-5, rtol=1e-5)
    if estimator == "grpo":
        # advantages belong to samples, not to row positions: a shuffled batch
        # gives the same advantages, shuffled
        perm = rng.permutation(len(ours))
        adv_p, _ = gt.compute_advantages(ours.select(perm), "grpo")
        np.testing.assert_allclose(adv_p, adv[perm], atol=1e-6, rtol=1e-6)
    with pytest.raises(NotImplementedError):
        gt.compute_advantages(ours, "nope")


def test_iter_minibatches_equals_the_trainer_method():
    ours, theirs = _batches(2, multimodal=False)
    ref = list(GRPOTrainer._iter_minibatches(_stub(global_step=3), theirs, 3, 2, 131))
    got = list(gt.iter_minibatches(ours, 3, 2, 131, global_step=3))
    assert len(got) == len(ref) == 4  # 8 rows: two full mini-batches of 3 per epoch
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.tensors["responses"], b.tensors["responses"])
        assert list(a.non_tensors["uid"]) == list(b.non_tensors["uid"])
    assert gt._fit_n_micro(6, 4) == GRPOTrainer._fit_n_micro(6, 4) == 1
    x = np.arange(3 * 4 * 5).reshape(3, 4, 5)
    np.testing.assert_array_equal(gt._reshape_micro(x, 2), GRPOTrainer._reshape_micro(x, 2))


def test_log_probs_batched_packed_equals_per_sample():
    _, model = both_models(seed=4)
    ours, _ = _batches(3)
    kw = dict(micro_batch_size=3, temperature=0.8, chunk_size=64, device="cpu")
    packed = gt.compute_log_probs_batched(model, ours, padding_free=True, **kw)
    plain = gt.compute_log_probs_batched(model, ours, padding_free=False, **kw)
    mask = ours.tensors["response_mask"].astype(bool)
    assert packed.shape == plain.shape == mask.shape
    np.testing.assert_allclose(packed[mask], plain[mask], atol=1e-4, rtol=1e-4)
    assert np.all(packed[~mask] == 0)


KNOBS = dict(clip_ratio_low=0.2, clip_ratio_high=0.3, clip_ratio_dual=3.0, use_kl_loss=True,
             kl_loss_coef=1e-2, kl_penalty="low_var_kl", max_grad_norm=1.0, remat=True,
             chunk_size=64, temperature=1.0)


def test_a_shared_image_runs_the_tower_once_and_moves_no_number(monkeypatch):
    """The same batch with each prompt's image one object in its N samples
    (each image packed once) and with every image copied to its own object
    (packed once a sample, as before): the tower runs over half the patch
    rows, and the log-probs and the update's gradient, vision leaves
    included, agree within fp32 rounding of sums taken in another order
    (atol 1e-7, rtol 1e-5). The ``distinct_patches`` counters read 1/N of
    ``patches`` where pieces and micro-batches hold whole groups, all of it
    with copies."""
    from spatialthinker_torch.models.qwen2_5_vl import model as model_mod
    from spatialthinker_torch.trainer.train_step import make_packed_grad_fn
    from spatialthinker_torch.utils.spans import Timer, span

    _, model = both_models(seed=8)
    batches = {"shared": _batches(7)[0], "copied": _copied_images(_batches(7)[0])}
    tower_rows = []
    real = model_mod.vision_forward
    monkeypatch.setattr(model_mod, "vision_forward", lambda tower, patches, pos, seg_full, *a, **k: (
        tower_rows.append(int((seg_full > 0).sum())), real(tower, patches, pos, seg_full, *a, **k))[1])
    knobs = {k: v for k, v in KNOBS.items() if k != "max_grad_norm"}
    grad_fn = make_packed_grad_fn(model, max_grad_norm=1.0, **knobs)
    logp, grads, counters, rows = {}, {}, {}, {}
    for name, batch in batches.items():
        tower_rows.clear()
        timer = Timer()
        with timer.active():
            with span("old"):  # pieces of two whole groups
                logp[name] = gt.compute_log_probs_batched(
                    model, batch, micro_batch_size=2 * N, temperature=0.8, chunk_size=64, device="cpu")
            with span("update_actor"), span("pack"):  # one micro-batch
                gt.packed_micro_batches(batch, CFG.vision, 64)
        counters[name] = timer.counters
        ptb, vision = gt.packed_micro_batches(batch, CFG.vision, 2)
        acc, metrics, finite, _ = grad_fn(*gt.copy_to_device(ptb, vision, "cpu"))
        assert finite and float(metrics["actor/grad_norm"]) > 0
        grads[name] = acc
        rows[name] = sum(tower_rows)
    assert 0 < rows["shared"] * N == rows["copied"]
    mask = batches["shared"].tensors["response_mask"].astype(bool)
    np.testing.assert_allclose(logp["shared"][mask], logp["copied"][mask], atol=1e-7, rtol=1e-5)
    assert grads["shared"].keys() == grads["copied"].keys()
    vision_leaves = [n for n in grads["shared"] if n.startswith("vision.")]
    assert vision_leaves and all(grads["shared"][n].abs().max() > 0 for n in vision_leaves)
    for n, g in grads["shared"].items():
        np.testing.assert_allclose(g.numpy(), grads["copied"][n].numpy(), atol=1e-7, rtol=1e-5, err_msg=n)
    patches = gt.patch_count(batches["shared"])
    for phase in ("old", "update_actor"):
        assert counters["shared"][f"{phase}/pack/patches"] == counters["copied"][f"{phase}/pack/patches"]
        assert counters["shared"][f"{phase}/pack/patches"] == patches
        assert counters["shared"][f"{phase}/pack/distinct_patches"] * N == patches
        assert counters["copied"][f"{phase}/pack/distinct_patches"] == patches


def test_the_towers_model_flops_count_each_distinct_image_once():
    """``perf/mfu_actor``'s image patches: one entry per distinct image
    object, so 1/N of the samples' patches where the N samples of a prompt
    share their image, and one entry per sample where each holds a copy."""
    shared, copied = _batches(7)[0], _copied_images(_batches(7)[0])
    per_sample = [int(np.prod(g, axis=-1).sum()) for g in shared.non_tensors["image_grid_thw"]]
    assert gt.distinct_image_patches(shared) == per_sample[::N]
    assert gt.distinct_image_patches(copied) == per_sample
    assert sum(per_sample) == gt.patch_count(shared) > 0


def test_two_grpo_steps_on_the_cpu_keep_the_smoke_invariants():
    """chip_smoke's step sequence on the tiny model: paged rollout -> old and
    ref log-probs -> GRPO advantages -> packed update -> second step from the
    moved policy."""
    _, model = both_models(seed=5)
    ref_model = copy.deepcopy(model).requires_grad_(False)
    ref_before = chip_smoke.checksums(ref_model.parameters())
    a = rollout_arrays(6, True)
    host = dict(input_ids=a["input_ids"], segment_ids=a["segment_ids"],
                position_ids=a["position_ids"].transpose(1, 0, 2), gen_pos_start=a["gen_pos_start"],
                patches_list=a["patches"], grids_list=a["grids"])
    prompts = chip_smoke.prompt_batch(host)
    optimizer = make_optimizer(1e-3)
    inner = make_packed_update_fn(model, optimizer, **KNOBS)
    seen = []

    def packed_update(ptb, vision):
        metrics = inner(ptb, vision)
        seen.append({k: float(v) for k, v in metrics.items()})
        return metrics

    def rollout():
        return tp.generate_paged(
            model, host["input_ids"], host["segment_ids"], host["position_ids"], host["gen_pos_start"],
            max_new_tokens=6, sampling=SamplingParams(temperature=1.0),
            generator=torch.Generator().manual_seed(len(seen)), slots=4, page_size=8,
            decode_chunk_size=3, group_n=N, patches_list=host["patches_list"],
            grids_list=host["grids_list"], vision_bucket=256)

    rng = np.random.default_rng(0)
    for step in (1, 2):
        before = chip_smoke.checksums(model.parameters())
        n_seen = len(seen)
        rolled, metrics, timing = chip_smoke.grpo_step(
            model, ref_model, prompts, rollout, packed_update, step=step, group_n=N, score_rng=rng,
            experience_micro=4, global_batch_size=4, micro_rows=1, temperature=1.0, device="cpu")
        assert len(rolled) == 8 and set(timing) == {"gen", "old", "ref", "adv", "update_actor"}
        assert len(seen) - n_seen == 2  # two optimizer steps per GRPO step
        assert all(np.isfinite(v) for m in seen[n_seen:] for v in m.values())
        assert metrics["actor/grad_norm"] > 0
        first = seen[n_seen]
        # nothing moved between the old log-probs and the first mini-batch
        assert abs(first["actor/ppo_kl"]) < 1e-5
        assert first["actor/pg_clipfrac_higher"] == first["actor/pg_clipfrac_lower"] == 0
        assert chip_smoke.checksums(model.parameters()) != before
        mask = rolled.tensors["response_mask"].astype(bool)
        # fp32 model and fp32-exact plain paged attention: the engine's log-probs
        # are the trainer's up to the bf16 pool rounding of the cached keys/values
        drift = np.abs(rolled.tensors["old_log_probs"] - rolled.tensors["rollout_log_probs"])[mask]
        assert drift.mean() < 2e-2
        # step 1: policy = reference, so ref log-probs = old log-probs
        gap = np.abs(rolled.tensors["ref_log_probs"] - rolled.tensors["old_log_probs"])[mask].max()
        assert (gap < 1e-6) if step == 1 else (gap > 1e-6)
    assert optimizer.state["count"] == 4
    assert chip_smoke.checksums(ref_model.parameters()) == ref_before


def test_update_actor_per_sample_layout_runs_and_moves_the_policy():
    _, model = both_models(seed=6)
    ours, _ = _batches(4)
    ours.tensors["ref_log_probs"] = ours.tensors["old_log_probs"]
    optimizer = make_optimizer(1e-3)
    knobs = {k: v for k, v in KNOBS.items()}
    before = chip_smoke.checksums(model.parameters())
    metrics = gt.update_actor(ours, make_update_fn(model, optimizer, **knobs), CFG.vision,
                              global_batch_size=4, micro_batch_size=2, global_step=1, device="cpu")
    assert optimizer.state["count"] == 2 and np.isfinite(list(metrics.values())).all()
    assert chip_smoke.checksums(model.parameters()) != before


@pytest.mark.parametrize("micro_rows", [1, 2, 64])
def test_packed_micro_batches_cut_the_packed_rows_and_their_vision_packs(micro_rows):
    """The micro-batch layout is the packed rows (padded to whole micro-batches)
    reshaped, and micro-batch g's vision pack holds the images of its rows."""
    ours, _ = _batches(6)
    ours.tensors["ref_log_probs"] = ours.tensors["old_log_probs"] * 0.5
    per_token = {k: ours.tensors[k] for k in ("old_log_probs", "ref_log_probs", "advantages")}
    packed, slot_map = gt.pack_rows(ours, per_token=per_token)
    ptb, vision = gt.packed_micro_batches(ours, CFG.vision, micro_rows)
    n_micro, per, row_len = ptb.input_ids.shape
    n_rows = packed.input_ids.shape[0]
    assert per <= micro_rows and n_micro * per >= n_rows and row_len == slot_map.row_len
    assert ptb.position_ids.shape == (n_micro, 3, per, row_len)
    for name, got, ref in zip(ptb._fields, ptb, packed):
        got, ref = np.asarray(got), np.asarray(ref)
        if name == "position_ids":
            got = got.transpose(1, 0, 2, 3).reshape(3, n_micro * per, row_len)
            np.testing.assert_array_equal(got[:, :n_rows], ref, err_msg=name)
        else:
            got = got.reshape(n_micro * per, row_len)
            np.testing.assert_array_equal(got[:n_rows], ref, err_msg=name)
            assert name != "segment_ids" or not got[n_rows:].any()
    for g in range(n_micro):
        ref = gt.vision_for_packed(ours, slot_map, CFG.vision, row_lo=g * per, row_hi=(g + 1) * per)
        width = ref.patches.shape[0]
        np.testing.assert_array_equal(vision.patches[g, :width], ref.patches)
        np.testing.assert_array_equal(vision.seg_full[g, :width], ref.seg_full)
        assert not vision.seg_full[g, width:].any()
