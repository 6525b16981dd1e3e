"""The host-side helpers the port's trainer brought in (own copies of
framework-free JAX-package modules) against the originals, on the same numpy
inputs. Everything here is integer bookkeeping or a single numpy reduction, so
every comparison is exact: ``balance_order`` / ``get_seqlen_balanced_partitions``,
the ``DataLoader`` (order, prefetch threads, ``state_dict`` resume, ``load_rows``
on a jsonl file), ``repeat`` / ``reorder`` / ``unpad`` /
``trim_response_padding``, ``compute_data_metrics`` and the timing / throughput
metrics, the tracker's jsonl backend, the checkpoint directory contract, the
flops counter (a hand count at the tiny preset, the JAX package's count for one
image, the H100's dense bf16 peak) and ``maybe_trace``.
"""

import json
import os

import numpy as np
import pytest
import torch

from spatialthinker_tpu.core import batch as jb
from spatialthinker_tpu.data import dataset as jd
from spatialthinker_tpu.models.qwen2_5_vl import qwen25_vl_tiny as jax_tiny
from spatialthinker_tpu.trainer import metrics as jmet
from spatialthinker_tpu.utils import flops_counter as jf
from spatialthinker_tpu.utils import seqlen_balancing as js
from spatialthinker_torch.core import batch as tb
from spatialthinker_torch.core.config import DataConfig
from spatialthinker_torch.data import dataset as td
from spatialthinker_torch.models.qwen2_5_vl import qwen25_vl_tiny
from spatialthinker_torch.trainer import metrics as tmet
from spatialthinker_torch.trainer.checkpoint import TRACKER_FILE, CheckpointManager
from spatialthinker_torch.trainer.tracker import Tracker
from spatialthinker_torch.utils import flops_counter as tf
from spatialthinker_torch.utils import seqlen_balancing as ts
from spatialthinker_torch.utils.profiling import device_memory_metrics, maybe_trace
from spatialthinker_torch.utils.synthetic_tokenizer import SyntheticTokenizer


@pytest.mark.parametrize("n,k,seed", [(16, 4, 0), (128, 32, 1), (12, 3, 2), (8, 8, 3), (30, 5, 4)])
def test_balance_order_equal(n, k, seed):
    lens = np.random.default_rng(seed).integers(5, 900, size=n).tolist()
    assert ts.balance_order(lens, k) == js.balance_order(lens, k)
    parts = ts.get_seqlen_balanced_partitions(lens, k, equal_size=True)
    assert parts == js.get_seqlen_balanced_partitions(lens, k, equal_size=True)
    assert sorted(i for p in parts for i in p) == list(range(n))
    loads = [sum(lens[i] for i in p) for p in parts]
    assert max(loads) - min(loads) <= max(lens)  # the partition is balanced, not just a permutation


def _rows(n):
    return [{"problem": f"What is {i} plus {i}?", "answer": str(2 * i)} for i in range(n)]


def _loaders(n, batch_size, **kw):
    tok = SyntheticTokenizer()
    cfg = DataConfig(max_prompt_length=24, max_response_length=4)
    ours = td.DataLoader(td.RLHFDataset.from_rows(_rows(n), tok, cfg, qwen25_vl_tiny()), batch_size, **kw)
    ref = jd.DataLoader(jd.RLHFDataset.from_rows(_rows(n), tok, cfg, jax_tiny()), batch_size, **kw)
    return ours, ref


def _same_batch(a, b):
    assert sorted(a.tensors) == sorted(b.tensors) and sorted(a.non_tensors) == sorted(b.non_tensors)
    for key in a.tensors:
        np.testing.assert_array_equal(a.tensors[key], b.tensors[key], err_msg=key)
    assert list(a.non_tensors["ground_truth"]) == list(b.non_tensors["ground_truth"])


@pytest.mark.parametrize("workers", [0, 3])
def test_dataloader_order_and_resume_equal(workers):
    ours, ref = _loaders(22, 4, shuffle=True, seed=5, num_workers=workers)
    assert len(ours) == len(ref) == 5
    for _ in range(2):  # two epochs: the shuffle is seeded by seed + epoch
        for a, b in zip(ours, ref, strict=True):
            _same_batch(a, b)
    assert ours.state_dict() == ref.state_dict() == {"epoch": 2, "position": 0, "seed": 5}
    it, seen = iter(ours), []
    for _ in range(2):
        seen.append(next(it))
    state = ours.state_dict()
    assert state["position"] == 2
    third = next(it)
    resumed, _ = _loaders(22, 4, shuffle=True, seed=5, num_workers=workers)
    resumed.load_state_dict(state)
    _same_batch(next(iter(resumed)), third)  # a resumed loader goes on where the saved one stood


def test_load_rows_reads_jsonl_and_parquet_dirs(tmp_path):
    path = tmp_path / "rows.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in _rows(5)))
    rows = td.load_rows(str(path))
    assert len(rows) == 5 and rows[3]["answer"] == "6"
    assert td._parse_files("org/name@val") == ("org/name", "val") == jd._parse_files("org/name@val")
    ds = td.RLHFDataset(str(path), SyntheticTokenizer(), DataConfig(max_prompt_length=24), qwen25_vl_tiny(),
                        limit_images=1)
    assert len(ds) == 5 and ds[0]["ground_truth"] == "0"


def _rolled(seed, b=6, p=8, r=600):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 300, size=b)
    lens[0] = min(299, r)  # the longest response
    mask = (np.arange(r)[None] < lens[:, None]).astype(np.int32)
    tensors = {
        "input_ids": rng.integers(1, 90, size=(b, p)).astype(np.int32),
        "responses": rng.integers(1, 90, size=(b, r)).astype(np.int32), "response_mask": mask,
        "token_level_scores": rng.normal(size=(b, r)).astype(np.float32),
        "rollout_log_probs": rng.normal(size=(b, r)).astype(np.float32),
        "full_input_ids": rng.integers(1, 90, size=(b, p + r)).astype(np.int32),
        "full_segment_ids": np.concatenate([np.ones((b, p), np.int32), mask], axis=1),
    }
    non = {"uid": np.array([f"u{i}" for i in range(b)], dtype=object)}
    return tensors, non


def test_batch_helpers_equal():
    tensors, non = _rolled(0)
    ours, ref = tb.RolloutBatch(dict(tensors), dict(non)), jb.RolloutBatch(dict(tensors), dict(non))
    got, want = tb.trim_response_padding(ours), jb.trim_response_padding(ref)
    assert got.tensors["responses"].shape[1] == 512  # 299 valid tokens at most -> two 256 buckets
    for key in want.tensors:
        np.testing.assert_array_equal(got.tensors[key], want.tensors[key], err_msg=key)
    assert tb.trim_response_padding(got) is got  # already trimmed
    np.testing.assert_array_equal(
        tb.trim_response_padding(ours, negotiated_max=700).tensors["responses"], tensors["responses"])
    for interleave in (True, False):
        a, b = ours.repeat(3, interleave=interleave), ref.repeat(3, interleave=interleave)
        np.testing.assert_array_equal(a.tensors["input_ids"], b.tensors["input_ids"])
        assert list(a.non_tensors["uid"]) == list(b.non_tensors["uid"])
    order = np.random.default_rng(1).permutation(len(ours))
    ours.reorder(order)
    ref.reorder(order)
    np.testing.assert_array_equal(ours.tensors["responses"], ref.tensors["responses"])
    assert list(ours.non_tensors["uid"]) == list(ref.non_tensors["uid"])
    padded, pad = tb.pad_to_divisor(ours, 4)
    assert pad == 2 and len(tb.unpad(padded, pad)) == len(ours) and tb.unpad(ours, 0) is ours
    np.testing.assert_array_equal(tb.unpad(padded, pad).tensors["responses"], ours.tensors["responses"])


@pytest.mark.parametrize("with_drift", [False, True])
def test_data_timing_and_throughput_metrics_equal(with_drift):
    tensors, _ = _rolled(2, r=64)
    rng = np.random.default_rng(3)
    arrays = dict(
        token_level_scores=tensors["token_level_scores"],
        token_level_rewards=tensors["token_level_scores"] - 0.01,
        advantages=rng.normal(size=(6, 64)).astype(np.float32),
        returns=rng.normal(size=(6, 64)).astype(np.float32),
        response_mask=tensors["response_mask"], prompt_mask=np.ones((6, 8), np.int32),
        max_response_length=64, max_prompt_length=8,
    )
    if with_drift:
        arrays.update(old_log_probs=rng.normal(size=(6, 64)).astype(np.float32),
                      rollout_log_probs=tensors["rollout_log_probs"])
    got, want = tmet.compute_data_metrics(**arrays), jmet.compute_data_metrics(**arrays)
    assert got == want
    assert ("rollout/probs_diff_mean" in got) == ("rollout/probs_diff_max" in got) == with_drift
    timing = {"gen": 1.5, "old": 0.25, "step": 3.0}
    assert tmet.compute_timing_metrics(timing, 1000) == jmet.compute_timing_metrics(timing, 1000)
    assert tmet.compute_throughput_metrics(1000, 3.0, 1) == jmet.compute_throughput_metrics(1000, 3.0, 1)
    assert tmet.reduce_metrics({"a": [1.0, 3.0]}) == {"a": 2.0}


def test_flops_counter_counts_alike_against_the_h100_peak():
    """The count at the tiny preset against a hand count (text E 64, I 128,
    2 layers, 4 / 2 heads of 16, vocab 1,024; vision E 32, I 64, 2 blocks of
    which 1 full, windows of 8 x 8 patches, 1,176 values a patch, merge unit
    4): each image's attention stays inside it. The JAX package's counter
    takes a batch's patches as one image, so it gives the same count for one
    image and for text alone, and a larger one for several images."""
    ours, ref = tf.FlopsCounter(qwen25_vl_tiny(), "cpu"), jf.FlopsCounter(jax_tiny())
    lens, images = [100, 37, 512], [16, 100]
    for patches in ([64], []):
        assert ours.estimate_flops(lens, 2.0, image_patches=patches)[0] == pytest.approx(
            ref.estimate_flops(lens, 2.0, vision_patches=float(sum(patches)))[0], rel=1e-12)
    achieved, promised = ours.estimate_flops(lens, 2.0, image_patches=images)
    text = sum(lens) * (2 * 2 * (64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 128) + 2 * 64 * 1024) \
        + 2 * 4 * 4 * 16 * sum(s * s for s in lens)
    vision = sum(images) * (2 * 2 * (32 * 96 + 32 * 32 + 3 * 32 * 64) + 2 * (4 * 32 * 32 + 32 * 64)
                            + 2 * 1176 * 32) \
        + 4 * 32 * (16 * (16 + 16) + 100 * (64 + 100))  # window block min(64, n), full block n
    assert achieved == pytest.approx((text + vision) / 2.0 / 1e12, rel=1e-12)
    assert ref.estimate_flops(lens, 2.0, vision_patches=float(sum(images)))[0] > achieved
    assert promised == 1.0  # the CPU's nominal figure keeps MFU finite in tests
    assert tf.device_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert tf.compute_mfu(ours, lens, 2.0, 1, ppo_epochs=2, image_patches=images) == achieved * 3 * 2 / promised


def test_tracker_checkpoint_contract_and_profiling(tmp_path):
    tracker = Tracker(["console", "jsonl"], "proj", "exp", base_dir=str(tmp_path))
    tracker.log({"a/b": 1.5, "n": 2}, 1)
    tracker.log_generations([("in", "out", "label", 0.5)], 1)
    tracker.finish()
    rec = json.loads((tmp_path / "exp_metrics.jsonl").read_text().splitlines()[0])
    assert rec["step"] == 1 and rec["a/b"] == 1.5

    ckpt = CheckpointManager(str(tmp_path / "ck"), save_limit=2)
    assert ckpt.latest_step(str(tmp_path)) is None  # nothing there yet
    gen = torch.Generator().manual_seed(3)
    for step in (1, 2, 3):
        ckpt.save(step, params={"w": torch.full((2,), float(step))},
                  opt_state={"count": step, "mu": {"w": torch.zeros(2)}, "nu": {"w": torch.ones(2)},
                             "compensation": {}},
                  dataloader_state={"epoch": 0, "position": step, "seed": 1}, rng_state=gen.get_state())
    names = sorted(os.listdir(tmp_path / "ck"))
    assert names == ["global_step_2", "global_step_3", TRACKER_FILE]  # save_limit pruned step 1
    assert sorted(os.listdir(tmp_path / "ck" / "global_step_3")) == ["extra_state.pkl", "opt_state.pt", "params.pt"]
    assert ckpt.latest_step() == 3
    for path in (str(tmp_path / "ck"), str(tmp_path / "ck" / "global_step_3")):
        state = ckpt.load(path)
        assert state["step"] == 3 and state["opt_state"]["count"] == 3
        assert torch.equal(state["params"]["w"], torch.full((2,), 3.0))
        assert state["dataloader_state"]["position"] == 3
        assert torch.equal(state["rng_state"], gen.get_state())
    assert ckpt.load(str(tmp_path / "nowhere")) is None
    assert CheckpointManager(None).save(1, params={}, opt_state={}, dataloader_state={}, rng_state=None) is None

    assert device_memory_metrics("cpu") == {"perf/max_memory_allocated_gb": 0.0, "perf/memory_in_use_gb": 0.0,
                                            "perf/memory_limit_gb": 0.0}
    with maybe_trace(str(tmp_path / "tr"), step=1, enabled_steps=(1,)):
        torch.ones(8, 8).sum()
    with maybe_trace(str(tmp_path / "tr"), step=2, enabled_steps=(1,)):
        pass
    assert os.listdir(tmp_path / "tr") == ["step_1.json"]
