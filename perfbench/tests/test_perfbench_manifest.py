"""BENCHMARK.json keeps to the benchmark's rules, and every name in it
resolves to its files."""

import json
import re
from pathlib import Path

import pytest

from perfbench import manifest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][0] == "python3" and len(BENCH["command"]) <= 32
    for word in BENCH["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries_have_their_keys_and_names(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert set(e) <= KEYS[group] and set(e) >= KEYS[group] - {"workloads"}
        assert NAME.match(e["name"])
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_every_name_resolves():
    cells = {w["name"] for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        mix = manifest.traffic(w["traffic"])
        assert hasattr(manifest.runner(mix), "run")
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert hasattr(manifest.reader(m["name"]), "read")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"] if m["name"] == "setup_s"} == {"setup_s"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in manifest.metrics_for(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = manifest.metrics_for(BENCH, cell, True)
    assert per and all(m["moves"] in e2e for m in per)


def test_layers_are_one_name_each_and_rooflines_are_shares():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("config", [c["file"] for c in BENCH["configs"]])
def test_configuration_matches_the_program_preset(config):
    """The file's published numbers are the ones the port's preset holds."""
    from perfbench.train_phase import _check_arch
    from spatialthinker_torch.models.qwen2_5_vl import get_config

    cfg = json.loads((ROOT / config).read_text())
    _check_arch(cfg["model"], get_config(cfg["preset"]))
    assert cfg["source"].startswith("https://")


@pytest.mark.parametrize("config", [c["file"] for c in BENCH["configs"]])
def test_configuration_dotlist_builds_the_stated_training(config):
    from perfbench.train_phase import _check_training
    from spatialthinker_torch.core.config import build_config

    cfg = json.loads((ROOT / config).read_text())
    _check_training(cfg["training"], build_config(list(cfg["dotlist"])))
