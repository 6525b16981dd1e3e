"""The port's eval harness (``spatialthinker_torch/eval``) against the JAX
package's (``spatialthinker_tpu/eval``), on the CPU, with no network and no
hub: the cases of ``tests/test_eval.py`` on the port's own copies (registry,
templates, answer extraction, metrics, the harness end to end with a patched
loader, ``post_with_retry`` with a patched ``requests.post``); both packages'
``run_evaluation`` over one fake provider and the same rows, records and
summaries identical; the CLI's arguments (``torch`` in place of ``jax``) and
its ``torch`` provider built on a patched loader; ``TorchProvider`` inside the
harness on the tiny model, resumed."""

import json

import numpy as np
import pytest
import torch

from spatialthinker_tpu.eval import extraction as jx
from spatialthinker_tpu.eval import harness as jh
from spatialthinker_tpu.eval import metrics as jm
from spatialthinker_tpu.eval import registry as jr
from spatialthinker_tpu.eval import templates as jt
from spatialthinker_torch.eval import __main__ as cli
from spatialthinker_torch.eval import extraction as tx
from spatialthinker_torch.eval import harness as th
from spatialthinker_torch.eval import metrics as tm
from spatialthinker_torch.eval import providers as tp
from spatialthinker_torch.eval import registry as tr
from spatialthinker_torch.eval import templates as tt
from spatialthinker_torch.eval.extraction import (
    judge_answer, repair_answer_tags, strip_option_prefix, to_option_letter,
)
from spatialthinker_torch.eval.metrics import (
    accuracy_with_stderr, per_task_accuracy, summarize, view_consistency,
)
from spatialthinker_torch.eval.registry import REGISTRY, get_dataset_spec
from spatialthinker_torch.eval.templates import SPATIAL_THINKER_TEMPLATE, format_instruction


def test_registry_has_all_reference_benchmarks():
    expected = {
        "mathvista", "mathverse", "mathvision", "sftseed", "hallusionbench",
        "emma-math", "emma-chem", "emma-code", "emma-physics", "mmmu-pro-vision",
        "cv-bench", "cv-bench-2D", "cv-bench-3D", "3dsrbench", "3dsrbench_full",
        "blink-spatial", "blink-depth", "blink-object", "blink-counting",
        "blink-multi-view", "blink-jigsaw", "realworld_qa", "spatialbench",
        "mmvp", "lego", "mathvista_mcq", "mathverse_vision_mcq", "mmmu_pro",
        "mmmu_pro_vision_only", "spatialreasoner", "robospatial",
        "robospatial_rgb", "stvqa",
    }
    assert expected.issubset(set(REGISTRY))
    spec = get_dataset_spec("cv-bench")
    assert spec.tasks == {"Count": 788, "Relation": 650, "Distance": 600, "Depth": 600}
    assert get_dataset_spec("blink-jigsaw").image_field == ["image_1", "image_2", "image_3"]
    with pytest.raises(KeyError):
        get_dataset_spec("nope")


@pytest.mark.parametrize("name", sorted(jr.REGISTRY))
def test_registry_entry_equals_jax(name):
    assert tr.REGISTRY[name].__dict__ == jr.REGISTRY[name].__dict__


def test_templates():
    out = format_instruction("Where is the cat?", template="reasoning")
    assert out.startswith("You FIRST think") and "Where is the cat?" in out
    out = format_instruction("Which is closer?", options=["table", "chair"], template="default")
    assert "(A) table" in out and "(B) chair" in out
    out = format_instruction("Q?", image_size=(640, 480), template="spatial_thinker")
    assert "<observe>" in out and "(640 x 480)" in out
    assert "Image size" in SPATIAL_THINKER_TEMPLATE
    assert tt.SPATIAL_THINKER_TEMPLATE_FULL == jt.SPATIAL_THINKER_TEMPLATE_FULL


@pytest.mark.parametrize("template", ["vision", "yes_no", "reasoning", "no_reasoning", "reasoning_end",
                                      "spatial_thinker", "default"])
@pytest.mark.parametrize("options", [None, ["red mug", "blue cup", "laptop"]])
def test_template_equals_jax(template, options):
    kw = dict(options=options, image_size=(640, 480), template=template)
    assert tt.format_instruction("Is the mug left of the laptop?", **kw) == \
        jt.format_instruction("Is the mug left of the laptop?", **kw)


def test_repair_answer_tags():
    assert repair_answer_tags("<think>x</think><answer> (A) cat </answer>") == "(A) cat"
    assert repair_answer_tags("blah Answer: 42") == "42"
    assert repair_answer_tags("no tags at all") == "no tags at all"
    assert repair_answer_tags("partial (B) dog</answer>") == "partial (B) dog"
    assert repair_answer_tags("<answer>unclosed tail") == "unclosed tail"


def test_option_letter_mapping():
    choices = ["red apple", "green pear", "blue berry"]
    assert to_option_letter("(B) green pear", choices) == "B"
    assert to_option_letter("green pear", choices) == "B"
    assert to_option_letter("The answer is (C).", choices) == "C"
    assert strip_option_prefix("(A) cat") == "cat"
    assert strip_option_prefix("B) dog") == "dog"


def test_judge_answer_mcq():
    ok, pred, gt = judge_answer("<answer>(A) 3 objects</answer>", "(A)", choices=["3 objects", "4 objects"])
    assert ok and pred == "A" and gt == "A"
    ok, _, _ = judge_answer("<answer>4 objects</answer>", "(A)", choices=["3 objects", "4 objects"])
    assert not ok


def test_judge_answer_hallusion_yes_no():
    ok, pred, gt = judge_answer("<answer>Yes</answer>", "1", yes_no_numeric=True)
    assert ok and pred == "A" and gt == "A"
    ok, _, _ = judge_answer("<answer>No</answer>", "1", yes_no_numeric=True)
    assert not ok


def test_judge_answer_freeform_math():
    ok, _, _ = judge_answer("<answer>0.5</answer>", "1/2", strip_gt_braces=False)
    assert ok


JUDGE_CASES = [
    ("<answer>(A) 3 objects</answer>", "(A)", ["3 objects", "4 objects"], False, True),
    ("<answer>4 objects</answer>", "(A)", ["3 objects", "4 objects"], False, True),
    ("I think B) dog. Answer: (B)", "(B)", ["cat", "dog"], False, True),
    ("<answer>Yes</answer>", "1", None, True, True),
    ("<answer>No</answer>", "0.", None, True, True),
    ("<answer>0.5</answer>", "1/2", None, False, False),
    ("<answer>\\frac{1}{2}</answer>", "{0.5}", None, False, True),
    ("<answer>(C).</answer>", "C", None, False, True),
    ("no tags, just 7", "7", None, False, True),
    ("<think>long</think>", "(D)", ["a", "b", "c", "d"], False, True),
]


@pytest.mark.parametrize("text,gt,choices,yes_no,strip", JUDGE_CASES)
def test_judge_answer_equals_jax(text, gt, choices, yes_no, strip):
    kw = dict(choices=choices, yes_no_numeric=yes_no, strip_gt_braces=strip)
    assert tx.judge_answer(text, gt, **kw) == jx.judge_answer(text, gt, **kw)
    assert tx.extract_reasoning(text) == jx.extract_reasoning(text)


def test_metrics():
    acc, err = accuracy_with_stderr(75, 100)
    assert acc == 0.75 and err == pytest.approx(np.sqrt(0.75 * 0.25 / 100))
    records = [{"correct": 1, "task": "Count"}, {"correct": 0, "task": "Count"},
               {"correct": 1, "task": "Depth"}]
    per = per_task_accuracy(records)
    assert per["Count"][0] == 0.5 and per["Depth"][0] == 1.0
    for tasks in (None, {"Count": 2, "Depth": 1, "Distance": 0}):
        for paired in (False, True):
            assert summarize(records, tasks, paired) == jm.summarize(records, tasks, paired)


def test_view_consistency_pairs():
    records = [{"correct": 1}, {"correct": 1}, {"correct": 1}, {"correct": 0}]
    vc, _ = view_consistency(records)
    assert vc == 0.5  # first pair consistent, second not
    assert tm.view_consistency(records) == jm.view_consistency(records)


def _rows(n=6):
    return [{"instruction": f"q{i}", "images": [], "response": "(A)", "choices": ["yes", "no"],
             "options": None, "task": "Count" if i % 2 else "Depth"} for i in range(n)]


class FakeProvider:
    def __init__(self):
        self.calls = 0

    def generate(self, prompts, images):
        self.calls += 1
        return [f"<think>t</think><answer>{'yes' if 'q0' in p or 'q2' in p or 'q4' in p else 'no'}</answer>"
                for p in prompts]


def test_harness_end_to_end(tmp_path, monkeypatch):
    rows = _rows()
    monkeypatch.setattr(th, "load_benchmark", lambda spec, n=-1: rows)
    out_file = str(tmp_path / "out.json")
    config = th.EvalConfig(dataset="cv-bench", template="reasoning", batch_size=3, output_file=out_file)
    summary = th.run_evaluation(FakeProvider(), config)
    assert summary["n"] == 6 and summary["accuracy"] == pytest.approx(0.5)
    data = json.load(open(out_file))
    assert len(data["records"]) == 6
    again = FakeProvider()
    assert th.run_evaluation(again, config)["n"] == 6  # resumed: everything was done
    assert again.calls == 0


@pytest.mark.parametrize("dataset,template", [("cv-bench", "spatial_thinker"), ("3dsrbench_full", "reasoning"),
                                              ("hallusionbench", "yes_no"), ("realworld_qa", "default")])
def test_run_evaluation_equals_jax(tmp_path, monkeypatch, dataset, template):
    """Both harnesses over one fake provider and the same rows: the records
    written and the summaries returned are identical."""
    from PIL import Image

    rng = np.random.default_rng(3)
    image = Image.fromarray((rng.random((48, 64, 3)) * 255).astype(np.uint8))  # as ``datasets`` gives them
    rows = [{"instruction": f"q{i}", "images": [image] if i % 3 else [], "response": ["(A)", "1", "B"][i % 3],
             "choices": ["yes", "no"] if i % 2 else None, "options": None,
             "task": ["Count", "Depth", "Relation"][i % 3]} for i in range(7)]
    monkeypatch.setattr(th, "load_benchmark", lambda spec, n=-1: rows)
    monkeypatch.setattr(jh, "load_benchmark", lambda spec, n=-1: rows)
    out = {}
    for name, mod in (("torch", th), ("jax", jh)):
        path = tmp_path / f"{name}.json"
        summary = mod.run_evaluation(FakeProvider(), mod.EvalConfig(
            dataset=dataset, template=template, batch_size=3, output_file=str(path)))
        out[name] = (summary, json.load(open(path)))
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["n"] == 7


class FakeResp:
    def __init__(self, status):
        self.status_code = status

    def raise_for_status(self):
        import requests

        if self.status_code >= 400:
            raise requests.HTTPError(f"HTTP {self.status_code}", response=self)

    def json(self):
        return {"ok": True}


def test_post_with_retry_recovers_from_429(monkeypatch):
    import requests

    calls = {"n": 0}

    def fake_post(url, headers=None, json=None, timeout=None):
        calls["n"] += 1
        return FakeResp(429 if calls["n"] < 3 else 200)

    monkeypatch.setattr(requests, "post", fake_post)
    resp = tp.post_with_retry("http://x", headers={}, json_body={}, _sleep=lambda s: None)
    assert resp.status_code == 200 and calls["n"] == 3


def test_post_with_retry_gives_up(monkeypatch):
    import requests

    sleeps = []
    monkeypatch.setattr(requests, "post", lambda *a, **k: FakeResp(500))
    with pytest.raises(requests.HTTPError):
        tp.post_with_retry("http://x", headers={}, json_body={}, max_retries=2, _sleep=sleeps.append)
    assert sleeps == [2.0, 4.0]  # exponential backoff, none after the last try


def test_post_with_retry_no_retry_on_client_error(monkeypatch):
    import requests

    calls = {"n": 0}

    def fake_post(*a, **k):
        calls["n"] += 1
        return FakeResp(400)

    monkeypatch.setattr(requests, "post", fake_post)
    with pytest.raises(requests.HTTPError):
        tp.post_with_retry("http://x", headers={}, json_body={}, _sleep=lambda s: None)
    assert calls["n"] == 1


@pytest.mark.parametrize("provider,url", [("openai", "api.openai.com"), ("anthropic", "api.anthropic.com")])
def test_hosted_providers_build_their_requests(monkeypatch, provider, url):
    from PIL import Image

    sent = []

    class Resp:
        def json(self):
            return ({"choices": [{"message": {"content": "A"}}]} if provider == "openai"
                    else {"content": [{"text": "A"}]})

    monkeypatch.setattr(tp, "post_with_retry", lambda u, **kw: sent.append((u, kw)) or Resp())
    cls = tp.OpenAIProvider if provider == "openai" else tp.AnthropicProvider
    out = cls("m", max_tokens=7, api_key="k").generate(["Q?"], [[Image.new("RGB", (4, 4))]])
    assert out == ["A"] and len(sent) == 1 and url in sent[0][0]
    body = sent[0][1]["json_body"]
    assert body["model"] == "m" and body["max_tokens"] == 7 and body["messages"][0]["content"][-1]["text"] == "Q?"


def test_cli_arguments():
    with pytest.raises(SystemExit):
        cli.parse_args(["--dataset", "cv-bench", "--provider", "jax"])
    args = cli.parse_args(["--dataset", "cv-bench"])
    assert args.provider == "torch" and args.template == "spatial_thinker" and args.batch_size == 8
    assert args.max_new_tokens == 2048 and args.num_samples == -1 and not args.no_resume
    for p in cli.PROVIDERS:
        assert cli.parse_args(["--dataset", "mmvp", "--provider", p]).provider == p
    assert set(cli.PROVIDERS) == {"torch", "hf", "openai", "anthropic"}


def test_cli_torch_provider_on_a_patched_loader(tmp_path, monkeypatch):
    """``--provider torch`` builds a ``TorchProvider`` over ``load_params``'s
    model (patched: a tiny random model on the CPU) and runs the harness."""
    from spatialthinker_torch.models.qwen2_5_vl import init_params, params as tparams
    from spatialthinker_torch.trainer import main as tmain
    from spatialthinker_torch.utils.synthetic_tokenizer import QwenSyntheticTokenizer
    from tests.test_torch_parity import CFG

    loaded = {}

    def fake_load(path, device=None, dtype=None):
        loaded.update(path=path, device=device, dtype=dtype)
        return init_params(CFG, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)

    monkeypatch.setattr(tparams, "load_params", fake_load)
    monkeypatch.setattr(tparams, "default_device", lambda: torch.device("cpu"))
    monkeypatch.setattr(tmain, "load_tokenizer", lambda path, cfg=None: QwenSyntheticTokenizer(cfg))
    provider = cli.build_provider(cli.parse_args(["--dataset", "mmvp", "--model", "/ckpt", "--max-new-tokens", "3"]))
    assert isinstance(provider, tp.TorchProvider) and provider.max_new_tokens == 3
    assert loaded == {"path": "/ckpt", "device": torch.device("cpu"), "dtype": torch.bfloat16}
    monkeypatch.setattr(th, "load_benchmark", lambda spec, n=-1: _rows(2))
    monkeypatch.setattr(cli, "build_provider", lambda args: provider)
    summary = cli.main(["--dataset", "cv-bench", "--output", str(tmp_path / "o.json"), "--batch-size", "2"])
    assert summary["n"] == 2 and set(summary) == {"accuracy", "stderr", "n", "Count_acc", "Count_stderr",
                                                  "Relation_acc", "Relation_stderr", "Distance_acc",
                                                  "Distance_stderr", "Depth_acc", "Depth_stderr"}


def test_torch_provider_through_the_harness_resumed(tmp_path, monkeypatch):
    """The tiny model through ``TorchProvider`` inside ``run_evaluation``:
    cv-bench-shaped rows with images, 2 - 4 choices; a resumed call generates
    nothing and returns the same summary."""
    from spatialthinker_torch.models.qwen2_5_vl import init_params
    from spatialthinker_torch.utils.synthetic_tokenizer import QwenSyntheticTokenizer
    from tests.test_torch_parity import CFG, random_image

    model = init_params(CFG, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    provider = tp.TorchProvider(model, CFG, QwenSyntheticTokenizer(CFG), max_new_tokens=4,
                                max_prompt_length=256, min_pixels=3136, max_pixels=12544)
    tasks = ["Count", "Relation", "Distance", "Depth"]
    rows = [{"instruction": f"How many mugs? ({i})", "images": [random_image(i, 56, 84)], "response": "(A)",
             "choices": ["one", "two", "three", "four"][: 2 + i % 3], "options": None, "task": tasks[i % 4]}
            for i in range(4)]
    monkeypatch.setattr(th, "load_benchmark", lambda spec, n=-1: rows)
    calls = []
    real = provider.generate
    provider.generate = lambda p, im: calls.append(len(p)) or real(p, im)
    config = th.EvalConfig(dataset="cv-bench", batch_size=2, output_file=str(tmp_path / "r.json"))
    first = th.run_evaluation(provider, config)
    assert calls == [2, 2] and first["n"] == 4
    records = json.load(open(tmp_path / "r.json"))["records"]
    assert len(records) == 4 and all(isinstance(r["raw_output"], str) for r in records)
    assert th.run_evaluation(provider, config) == first and calls == [2, 2]
    assert records[0]["prompt"].endswith(f"(84 x 56)\n\nNow answer the following question:\n{rows[0]['instruction']}")


def test_image_size_of_arrays_and_pil_images():
    from PIL import Image

    arr = np.zeros((480, 640, 3), np.uint8)
    assert th._image_size([arr]) == th._image_size([Image.fromarray(arr)]) == (640, 480)
    assert th._image_size([]) is None
