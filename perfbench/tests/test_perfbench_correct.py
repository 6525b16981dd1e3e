"""``correct`` at a size a CPU test run can hold: the program agrees with
the plain reference, and comes out not correct when the timed path is broken
underneath (a step that leaves the state unchanged, half of the batch left
out with the mean over the rest, a produced log-prob altered), and when the
control, the reference one precision below the configuration's, stands in
its place. The run is driven as ``run.py`` drives it, past the look for a
chip, at the port's tiny preset and a small mix of the cell's kind."""

import json
import time
from pathlib import Path

import pytest
import torch

from perfbench import check, train_phase
from perfbench.faults import FAULTS

HERE = Path(__file__).resolve().parent
CFG = json.loads((HERE / "tiny.json").read_text())
MIX = json.loads((HERE / "tiny_mix.json").read_text())
# this size's own limits: the cell's are set at 3B on the card (tiny_limits.json says why)
LIMITS = json.loads((HERE / "tiny_limits.json").read_text())["limits"]
SEED = 2**31 + 41


def _run(fault=None, controls=()):
    return train_phase.run(CFG, MIX, SEED, 0.5, False, torch.device("cpu"), time.perf_counter(),
                           fault=fault, controls=controls)


@pytest.fixture(scope="module")
def sound():
    return _run(controls=("fp8",))


def test_the_program_agrees_with_the_reference(sound):
    assert check.verdict(sound["numbers"], LIMITS), sound["numbers"]
    assert sound["numbers"]["unmatched"] == 0 and sound["numbers"]["split"] == 0
    assert sound["attempted"] >= 1


def test_the_rule_split_by_hand():
    # width: 2 x the mean 180 = 360 -> 512; first fit by decreasing length:
    # rows 300 + 200 = 500 and 200 + 100 + 100 = 400
    assert check.rule_split([100, 200, 300, 100, 200], 2) == (512, 2, [900])
    assert check.rule_split([100, 200, 300, 100, 200], 1) == (512, 1, [500, 400])
    # width 2 x 284 = 568 -> 768; rows 500 + 10 + 10, 450, 450: three rows at
    # most two a micro-batch make two micro-batches of two rows, one padded
    assert check.rule_split([450, 10, 500, 450, 10], 2) == (768, 2, [970, 450])


def test_a_split_off_the_rule_reads_as_split(sound):
    r = _run(FAULTS["resplit"])
    assert r["numbers"]["split"] > 0 and r["numbers"]["unmatched"] == 0


def test_the_control_is_not_correct(sound):
    control, prog = sound["control_numbers"]["fp8"], sound["numbers"]
    assert not check.verdict(control, LIMITS), control
    assert control["logp_old"] > 5 * prog["logp_old"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    r = _run(FAULTS[fault])
    assert not check.verdict(r["numbers"], LIMITS), r["numbers"]
