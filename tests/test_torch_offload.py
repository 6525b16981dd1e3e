"""State that lives on the host, on the CPU: ``parallel/offload.py`` and the
trainer's ``worker.ref.offload``, ``sharding.host_offload_optimizer`` and
``optim.stream`` on the tiny preset.

- a round trip of a nested state restores every leaf's device, dtype and
  values (and ``into=`` writes over the host copies it is given);
- the ref log-probs, and the whole step, with ``ref.offload`` equal those
  without, exactly (the same weights through the same arithmetic);
- one step with ``host_offload_optimizer`` equals one without, bit for bit,
  and leaves the state on the host;
- a step under ``optim.stream`` equals one under the fused ``adamw_bf16``,
  bit for bit; a trainer saved under ``stream`` and loaded into a fresh one
  takes the same next step (metrics within 1e-6, parameters within 1% of lr,
  as ``tests/test_torch_trainer.py`` holds the fused round trip); a
  checkpoint of fp32 moments is refused by a streamed run;
- the trainer CLI with ``optim.stream=true ref.offload=true``: two steps
  with the same metric families as without them.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from spatialthinker_torch.data.dataset import DataLoader
from spatialthinker_torch.parallel.offload import (
    HostLeaf, host_bytes, is_offloaded, offload_to_host, restore_from_host,
)
from spatialthinker_torch.trainer import main as tm
from tests.test_torch_streamed_opt import _state_bytes
from tests.test_torch_trainer import LR, NOT_COMPARED, ROWS, _dotlist, _reward_fn, _sums, build

torch.set_num_threads(2)

STREAM = ["worker.actor.optim.stream=true"]
REF_OFFLOAD = ["worker.ref.offload=true"]
OFFLOAD_OPT = ["worker.actor.sharding.host_offload_optimizer=true"]


def test_round_trip_restores_device_dtype_and_values():
    rng = np.random.default_rng(0)
    state = {"count": 3, "mu": {"a": torch.tensor(rng.normal(size=(3, 4))).bfloat16(),
                                "b": torch.tensor(rng.normal(size=(5,))).float()},
             "nested": [torch.arange(6, dtype=torch.int32).reshape(2, 3), (torch.ones(2, dtype=torch.float16),)]}
    host = offload_to_host(state)
    assert is_offloaded(host) and not is_offloaded(state) and host["count"] == 3
    assert isinstance(host["mu"]["a"], HostLeaf) and host["mu"]["a"].device == torch.device("cpu")
    assert host_bytes(host) == 3 * 4 * 2 + 5 * 4 + 6 * 4 + 2 * 2
    back = restore_from_host(host)
    flat = lambda t: [t["mu"]["a"], t["mu"]["b"], t["nested"][0], t["nested"][1][0]]  # noqa: E731
    for got, want in zip(flat(back), flat(state)):
        assert got.device == want.device and got.dtype == want.dtype and torch.equal(got, want)
    assert type(back["nested"][1]) is tuple and back["count"] == 3
    # the host copies are copies: changing the source changes nothing
    state["mu"]["a"].zero_()
    assert not torch.equal(restore_from_host(host)["mu"]["a"], state["mu"]["a"])
    # into=: written over, the same host buffers
    again = offload_to_host(state, into=host)
    assert again["mu"]["a"].buffer is host["mu"]["a"].buffer
    assert torch.equal(restore_from_host(again)["mu"]["a"], state["mu"]["a"])


def _step(trainer, batch):
    trainer.reward_fn = _reward_fn
    trainer.global_step += 1
    return trainer.train_step(copy.deepcopy(batch))


def _first_batch(trainer):
    return next(iter(DataLoader(trainer.train_dataloader.dataset, 4, shuffle=False)))


def _assert_same_step(a, b, got_a, got_b):
    assert got_a.keys() == got_b.keys()
    for key in got_a:
        if not key.startswith(NOT_COMPARED):
            assert got_a[key] == got_b[key], key
    for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), name


def test_ref_offload_gives_the_same_ref_log_probs_and_step(tmp_path):
    base, _ = build(tmp_path, seed=3)
    off, _ = build(tmp_path, *REF_OFFLOAD, seed=3)
    assert off.ref_model is None and is_offloaded(off.ref_host) and base.ref_host is None
    assert host_bytes(off.ref_host) == sum(p.numel() * p.element_size() for p in off.model.parameters())
    batch = _first_batch(base)
    rolled = base.generate_sequences(copy.deepcopy(batch), base.sampling)
    ref_base = base.compute_log_probs_batched(rolled, base.ref_policy())
    ref_off = off.compute_log_probs_batched(rolled, off.ref_policy())
    np.testing.assert_array_equal(ref_off, ref_base)
    assert off.host_state_stats["ref_restore_bytes"] == host_bytes(off.ref_host)
    _assert_same_step(base, off, _step(base, batch), _step(off, batch))
    # the host copy is the initial policy; the policy moved
    restored = off.ref_policy()
    assert _sums(restored) == _sums(base.ref_model) != _sums(off.model)


def test_host_offload_optimizer_step_equals_the_resident_one(tmp_path):
    extra = ["worker.actor.optim.strategy=adamw_bf16"]
    base, _ = build(tmp_path, *extra, seed=4)
    off, _ = build(tmp_path, *extra, *OFFLOAD_OPT, seed=4)
    assert off.offload_opt and is_offloaded(off.optimizer.state)
    batch = _first_batch(base)
    _assert_same_step(base, off, _step(base, batch), _step(off, batch))
    assert is_offloaded(off.optimizer.state) and off.optimizer.state["count"] == 1
    for kind in ("mu", "nu", "compensation"):
        assert base.optimizer.state[kind].keys() == off.optimizer.state[kind].keys()
        for name, t in base.optimizer.state[kind].items():
            assert torch.equal(off.optimizer.state[kind][name].buffer, t), (kind, name)


def test_stream_step_equals_the_fused_one(tmp_path):
    """``optim.stream`` with ``strategy=adamw`` runs bf16 moments (with the JAX
    package's warning) and a bf16 gradient accumulator: the same step as the
    fused ``adamw_bf16`` with ``grad_accum_dtype=bfloat16``."""
    fused, _ = build(tmp_path, "worker.actor.optim.strategy=adamw_bf16",
                     "worker.actor.optim.grad_accum_dtype=bfloat16", seed=5)
    streamed, _ = build(tmp_path, *STREAM, seed=5)
    assert not streamed.optimizer.state["mu"]["text.norm.weight"].is_cuda
    batch = _first_batch(fused)
    _assert_same_step(fused, streamed, _step(fused, batch), _step(streamed, batch))
    for kind in ("mu", "nu", "compensation"):
        for name, t in fused.optimizer.state[kind].items():
            assert torch.equal(streamed.optimizer.state[kind][name], t), (kind, name)
    assert streamed.host_state_stats["apply_bytes_each_way"] == _state_bytes(streamed.optimizer)


def test_stream_checkpoint_resumes_to_the_same_next_step(tmp_path):
    a, _ = build(tmp_path, *STREAM, "trainer.max_steps=1", "trainer.save_freq=1", seed=6)
    a.reward_fn = _reward_fn
    a.fit()
    b, _ = build(tmp_path, *STREAM, f"trainer.load_checkpoint_path={tmp_path}/ckpt", seed=6)
    b.load_checkpoint()
    assert b.global_step == 1 and b.optimizer.state["count"] == 1
    assert _sums(a.model) == _sums(b.model)
    for kind in ("mu", "nu", "compensation"):
        for name, t in a.optimizer.state[kind].items():
            assert torch.equal(b.optimizer.state[kind][name], t), (kind, name)
    batch = _first_batch(a)
    results = [_step(t, batch) for t in (a, b)]
    for key in results[0]:
        if not key.startswith(NOT_COMPARED):
            np.testing.assert_allclose(results[0][key], results[1][key], atol=1e-6, rtol=1e-6, err_msg=key)
    for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        torch.testing.assert_close(pa, pb, atol=0.01 * LR, rtol=0, msg=name)
    # fp32 moments (strategy=adamw, resident) do not load into a streamed run, nor back
    fused, _ = build(tmp_path / "fused", "trainer.max_steps=1", "trainer.save_freq=1", seed=6)
    fused.reward_fn = _reward_fn
    fused.fit()
    c, _ = build(tmp_path, *STREAM, f"trainer.load_checkpoint_path={tmp_path}/fused/ckpt")
    with pytest.raises(ValueError, match="optim.stream keeps bf16 moments"):
        c.load_checkpoint()
    d, _ = build(tmp_path, f"trainer.load_checkpoint_path={tmp_path}/ckpt")
    with pytest.raises(ValueError, match="optimizer state"):
        d.load_checkpoint()


def _cli(tmp_path, monkeypatch, name, *extra):
    path = tmp_path / "train.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in ROWS))
    monkeypatch.setenv("SPATIALTHINKER_PLATFORM", "cpu")
    tm.main(_dotlist(tmp_path, f"data.train_files={path}", "trainer.logger=['console','jsonl']",
                     f"trainer.experiment_name={name}", *extra))
    return [json.loads(line) for line in open(f"{tmp_path}/ckpt/{name}_metrics.jsonl")]


def test_cli_with_stream_and_ref_offload(tmp_path, monkeypatch):
    plain = _cli(tmp_path, monkeypatch, "plain")
    host = _cli(tmp_path, monkeypatch, "host", *STREAM, *REF_OFFLOAD)
    assert [r["step"] for r in host] == [r["step"] for r in plain] == [1, 2]
    families = ("actor/", "critic/score/", "reward/", "timing_s/", "perf/", "rollout/")
    for got, want in zip(host, plain):
        for family in families:
            keys = sorted(k for k in want if k.startswith(family))
            assert keys and keys == sorted(k for k in got if k.startswith(family)), family
        assert all(np.isfinite(v) for k, v in got.items() if k != "step")
    assert "timing_s/ref" in host[-1]
    assert os.path.exists(f"{tmp_path}/ckpt/host_metrics.jsonl")
