"""A later change adds a traffic mix, a metric or a cell with new files and
new entries only: none of the files already there is edited."""

import hashlib
import json
import shutil
from pathlib import Path

from perfbench import manifest

ROOT = Path(__file__).resolve().parents[2]


def _digests(base: Path) -> dict:
    return {p.relative_to(base): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(base.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_mix_a_metric_and_a_cell_take_new_files_only(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    base = tmp_path / "perfbench"
    before = _digests(base)
    mix = manifest.traffic("update_long")
    mix["response_lognormal_median"] = 96
    (base / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (base / "metrics" / "dummy_metric.train.py").write_text(
        "def read(run):\n    return None if not run.units else float(len(run.units))\n")
    (base / "limits" / "qwen2_5_vl_3b.dummy_mix.json").write_text(
        (base / "limits" / "qwen2_5_vl_3b.update_long.json").read_text())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "qwen2_5_vl_3b.dummy_mix", "config": "qwen2_5_vl_3b",
                               "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy_metric.train", "unit": "units", "better": "higher",
                               "source": "host_clock", "layer": "device", "moves": "train_tokens_per_s",
                               "workloads": ["qwen2_5_vl_3b.dummy_mix"]})
    after = _digests(base)
    assert {k: v for k, v in after.items() if k in before} == before
    assert manifest.traffic("dummy_mix", base)["response_lognormal_median"] == 96
    assert manifest.runner(manifest.traffic("dummy_mix", base)).__name__ == "perfbench.train_phase"

    class Run:
        units = [object(), object()]

    assert manifest.reader("dummy_metric.train", base).read(Run()) == 2.0
    names = [m["name"] for m in manifest.metrics_for(bench, "qwen2_5_vl_3b.dummy_mix", True)]
    assert names == ["dummy_metric.train"]
