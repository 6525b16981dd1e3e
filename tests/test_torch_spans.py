"""The port's span recorder (``utils/spans.py`` ``Timer``) on the CPU.

- nesting (``parent/child``), accumulation of a repeated path (seconds and
  calls), counters under the open span, self time (a span less its
  children), the step number and the tracker's ``spans/`` family, on a clock
  the test sets;
- no recorder active: ``span`` and ``count`` record nothing; the profiler
  off: no range is entered; on: each span is the range ``st/<path>``;
- one ``train_step`` at the tiny preset with images: the returned keys keep
  only the top-level phases under ``timing_s/`` (no span leaks into them),
  ``step_spans`` holds every span and counter of the log-prob pieces and the
  update, ``init_spans`` the constructor's, and under ``ref.offload`` /
  ``host_offload_optimizer`` / ``optim.stream`` the host-state spans, which
  feed ``host_state_stats``; the same step under ``torch.profiler`` shows the
  spans as ``st/`` ranges of the host.
"""

import threading

import numpy as np
import pytest
import torch

from spatialthinker_torch.core.batch import RolloutBatch
from spatialthinker_torch.utils import spans
from spatialthinker_torch.utils.spans import Timer, count, current_timer, span
from tests.test_torch_trainer import _as, _precomputed_rollout, _reward_fn, build

torch.set_num_threads(2)

MULTIMODAL = ["data.max_prompt_length=48", "data.min_pixels=3136", "data.max_pixels=12544"]
PHASES = {"gen", "reward", "balance", "old", "ref", "adv", "update_actor", "step"}
STEP_SPANS = {f"{phase}/{part}" for phase in ("old", "ref") for part in ("pack", "h2d", "forward")} | {
    "update_actor/pack", "update_actor/h2d", "update_actor/grad", "update_actor/apply"}
HOST_STATE = {
    "plain": ([], set()),
    "offload": (["worker.ref.offload=true", "worker.actor.sharding.host_offload_optimizer=true"],
                {"ref/restore", "update_actor/opt_restore", "update_actor/opt_offload"}),
    "stream": (["worker.ref.offload=true", "worker.actor.optim.stream=true"], {"ref/restore"}),
}


def _clock(monkeypatch):
    now = [0.0]
    monkeypatch.setattr(spans.time, "perf_counter", lambda: now[0])
    return now


def test_spans_nest_accumulate_and_count(monkeypatch):
    now = _clock(monkeypatch)
    timer = Timer(step=7)
    with timer.active():
        assert current_timer() is timer
        for _ in range(2):
            with span("old"):
                now[0] += 1
                with span("pack"):
                    now[0] += 2
                    count("rows", 3)
                with span("forward") as forward:
                    now[0] += 4
                count("pieces")
        with span("adv"):
            now[0] += 0.5
            # another thread's spans go to the process's recorder (autograd runs a
            # CUDA backward on a thread of its own, the step's thread waiting on it)
            worker = threading.Thread(target=lambda: count("backward"))
            worker.start()
            worker.join()
    assert current_timer() is None
    assert timer.step == 7 and timer.end - timer.start == 14.5 and forward.seconds == 4
    assert timer.timing == {"old": 14, "adv": 0.5}
    assert (timer.seconds("old"), timer.calls("old")) == (14, 2)
    assert (timer.seconds("old/pack"), timer.calls("old/pack")) == (4, 2)
    assert timer.self_seconds("old") == 14 - 4 - 8 and timer.self_seconds("old/pack") == 4
    assert [(s.path, s.parent) for s in timer.spans[:3]] == [("old", None), ("old/pack", "old"),
                                                              ("old/forward", "old")]
    assert timer.counters == {"old/pack/rows": 6, "old/pieces": 2, "adv/backward": 1}
    flat = timer.flat()
    assert (flat["spans/old_s"], flat["spans/old/forward_s"], flat["spans/old/pack_calls"]) == (14, 8, 2)
    assert flat["spans/old/pack/rows"] == 6 and flat["spans/adv_calls"] == 1


def test_no_recorder_records_nothing_and_the_profiler_sees_each_span(monkeypatch):
    idle = Timer()  # made, never active
    with span("old") as s:
        count("rows", 5)
    assert s is None and current_timer() is None and idle.spans == [] and idle.counters == {}

    entered = []

    class Range:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Range)
    timer = Timer()
    with timer.active(), span("old"), span("pack"):
        pass
    assert entered == [] and timer.calls("old/pack") == 1  # the profiler is off: no range
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with timer.active(), span("old"), span("pack"):
            pass
    assert entered == ["st/old", "st/old/pack"] and timer.calls("old/pack") == 2
    # a recorder made active inside another hands the context back, also on an error
    with pytest.raises(RuntimeError), timer.active(), Timer().active():
        raise RuntimeError
    assert current_timer() is None


def _multimodal_trainer(tmp_path, extra):
    trainer, _ = build(tmp_path, *MULTIMODAL, *extra)
    trainer.reward_fn = _reward_fn
    rolled = _precomputed_rollout(trainer, True)
    trainer.generate_sequences = lambda batch, sampling, generator=None: _as(RolloutBatch, rolled)
    trainer.global_step = 1
    return trainer, RolloutBatch(tensors={"input_ids": np.zeros((4, 1), np.int32)})


@pytest.mark.parametrize("host_state", sorted(HOST_STATE))
def test_train_step_records_its_spans_beside_the_same_metrics(tmp_path, host_state):
    extra, host_spans = HOST_STATE[host_state]
    trainer, prompts = _multimodal_trainer(tmp_path, extra)
    init = trainer.init_spans
    assert {s.path for s in init.spans} == {"init", "init/ref_copy", "init/optimizer", "init/update_fns"}
    assert init.seconds("init") >= init.seconds("init/ref_copy") + init.seconds("init/optimizer") > 0
    got = trainer.train_step(prompts)
    rec = trainer.step_spans
    assert {k[len("timing_s/"):] for k in got if k.startswith("timing_s/")} == PHASES
    assert not any(k.startswith("spans/") for k in got)
    assert rec.step == 1 and {s.path for s in rec.spans} == PHASES - {"step"} | STEP_SPANS | host_spans
    for phase in PHASES - {"step"}:
        assert got[f"timing_s/{phase}"] == rec.seconds(phase) == rec.timing[phase]
    assert got["timing_s/step"] == rec.end - rec.start
    # 8 samples in pieces of 2; the update's one mini-batch in micro-batches of at most 1 row
    assert rec.counters["old/pieces"] == rec.counters["ref/pieces"] == 4 == rec.calls("old/pack")
    assert rec.counters["old/pack/rows"] >= 4 and rec.counters["update_actor/pack/micro_batches"] >= 1
    patches = sum(len(p) for p in _precomputed_rollout(trainer, True).non_tensors["patches"] if p is not None)
    assert rec.counters["old/pack/patches"] == rec.counters["update_actor/pack/patches"] == patches > 0
    assert rec.counters["old/h2d/bytes"] > 0 and rec.counters["update_actor/h2d/bytes"] > 0
    assert rec.calls("update_actor/grad") == rec.calls("update_actor/apply") == 1
    if "ref/restore" in host_spans:
        assert trainer.host_state_stats["ref_restore_s"] == rec.seconds("ref/restore") > 0
    if host_state == "stream":
        assert trainer.host_state_stats["apply_s"] == rec.seconds("update_actor/apply") > 0


def test_train_step_spans_are_host_ranges_of_the_profiler(tmp_path):
    trainer, prompts = _multimodal_trainer(tmp_path, [])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.train_step(prompts)
    ranges = {e.name() for e in prof.profiler.kineto_results.events() if e.name().startswith("st/")}
    assert ranges == {f"st/{s.path}" for s in trainer.step_spans.spans}
    assert {"st/old/pack", "st/ref/h2d", "st/update_actor/grad", "st/update_actor/apply"} <= ranges


def test_idle_seconds_go_to_the_innermost_span():
    """``profile_spans.py``'s reading of a traced unit, on intervals set by
    hand: the device's union and gaps, each gap cut at the spans' ends and
    given to the innermost span around each piece."""
    import profile_spans as ps

    busy, gaps = ps.busy_and_gaps([(2, 4), (3, 5), (8, 9), (20, 30)], 0, 12)
    assert busy == 3 + 1 and gaps == [(0, 2), (5, 8), (9, 12)]
    ranges = [(0, 12, "update_actor"), (1, 6, "update_actor/pack"), (7, 11, "update_actor/grad"),
              (10, 11, "update_actor/grad/x")]
    by_span = ps.idle_by_span(gaps + [(12, 13)], ranges)
    assert by_span == {"update_actor": 1 + 1 + 1, "update_actor/pack": 1 + 1, "update_actor/grad": 1 + 1,
                       "update_actor/grad/x": 1, ps.NONE: 1}
    assert sum(by_span.values()) == sum(b - a for a, b in gaps) + 1
    assert [p for p in by_span if p != ps.NONE and ps.is_host_work(p)] == ["update_actor/pack"]
    assert ps.innermost(sorted(ranges), [r[0] for r in sorted(ranges)], 10.5) == "update_actor/grad/x"


def test_profile_spans_reads_a_tiny_cell_on_the_cpu():
    """``profile_spans.py`` end to end at the benchmark's tiny CPU size: the
    constructor's spans, a unit's record (each phase's packs holding the
    images its samples share once), and the traced unit, where no
    device interval exists, so all of it is idle and the idle by span adds up
    to it, the packing's share inside."""
    import json
    from pathlib import Path

    import profile_spans as ps

    tiny = Path(ps.ROOT) / "perfbench" / "tests"
    cfg, mix = (json.loads((tiny / f).read_text()) for f in ("tiny.json", "tiny_mix.json"))
    res = ps.measure(cfg, mix, 2**31 + 7, 1, torch.device("cpu"))
    assert set(res["init"]["spans"]) == {"init", "init/ref_copy", "init/optimizer", "init/update_fns"}
    (unit,) = res["units"]
    assert STEP_SPANS <= set(unit["spans"]) and unit["pack_s"] > 0 and unit["h2d_bytes"] > 0
    # 8 samples a prompt: a pack holds each prompt's image once
    share = unit["distinct_share"]
    assert set(share) == {"old", "ref", "update_actor"} and all(0 < v < 1 for v in share.values())
    old = unit["spans"]["old"]
    assert old["self_s"] == pytest.approx(old["s"] - sum(unit["spans"][f"old/{p}"]["s"]
                                                         for p in ("pack", "h2d", "forward")))
    s = res["traced"]["summary"]
    assert s["busy_s"] == 0 and s["idle_s"] == pytest.approx(s["window_s"]) and s["st_events_on_device"] == 0
    assert sum(s["idle_by_span_s"].values()) == pytest.approx(s["idle_s"])
    assert 0 < s["pack_idle_s"] < s["idle_s"] and s["idle_by_span_s"]["update_actor/grad"] > 0
    assert all(v > 0 for v in res["span_cost_s"].values())
