"""The port's synthesis pipeline (``spatialthinker_torch/data_gen``) against
the JAX package's (``spatialthinker_tpu/data_gen``), on the CPU with no
network: each case of ``tests/test_data_gen.py`` run through both packages on
the same inputs (the LLM callers mocked), outputs equal; the LLM callers'
requests against the JAX package's with ``requests.post`` mocked; one
``preprocess`` run of each package's CLI on in-memory scene-graph rows (the
hub loader and ``requests.post`` patched), CSVs equal; the package imports
neither torch nor the JAX package."""

import json
import subprocess
import sys

import numpy as np
import pytest

from spatialthinker_tpu import data_gen as jd
from spatialthinker_tpu.data_gen import __main__ as jcli
from spatialthinker_tpu.data_gen import llm as jllm
from spatialthinker_torch import data_gen as td
from spatialthinker_torch.data_gen import __main__ as tcli
from spatialthinker_torch.data_gen import llm as tllm

PACKAGES = (jd, td)


def _both(name, *args, **kwargs):
    """``name`` of both packages on the same arguments: (JAX's, the port's)."""
    return tuple(getattr(pkg, name)(*args, **kwargs) for pkg in PACKAGES)


def test_normalize_and_expand():
    for token in ("Chairs", "children", "boxes", "glasses", "berries", "bus", "Dress", "a"):
        want, got = _both("normalize_token", token)
        assert got == want
    assert td.normalize_token("Chairs") == "chair" and td.normalize_token("children") == "child"
    assert td.normalize_token("boxes") == "box"
    want, words = _both("expand_question_words", "How many chairs are next to the table?")
    assert words == want
    assert "chair" in words and "table" in words and "how" not in words and "the" not in words


def test_map_objects_and_relationships():
    objs = [{"id": "chair.1", "bbox": [0, 0, 1, 1]}, {"id": "chair.2", "bbox": [1, 1, 2, 2]},
            {"id": "lamp.3", "bbox": [2, 2, 3, 3]}]
    rels = [{"subject": "chair.1", "predicate": "next to", "object": "table.9"},
            {"subject": "lamp.3", "predicate": "on", "object": "desk.4"}]
    words = td.expand_question_words("How many chairs are near the table?")
    want, got = _both("map_objects", objs, words)
    assert got == want and len(got) == 2
    want, got = _both("map_relationships", rels, words)
    assert got == want and len(got) == 1


@pytest.mark.parametrize("text", ['text {"a": 1} tail', "```json\n{\"q\": \"x\"}\n```", 'pre {"a": {"b": 2}} post'])
def test_extract_json(text):
    want, got = _both("extract_json_from_output", text)
    assert got == want and isinstance(json.loads(got), dict)
    for bad in ("no object here", "{ unbalanced"):
        for pkg in PACKAGES:
            with pytest.raises(ValueError):
                pkg.extract_json_from_output(bad)


def test_compute_data_stats():
    assert _both("compute_data_stats", [])[0] == _both("compute_data_stats", [])[1]
    rows = [{"category": "count", "level": "easy"}, {"category": "relation", "level": "hard"}]
    want, (stats, last) = _both("compute_data_stats", rows)
    assert (stats, last) == want
    assert stats["count"] == "50.0%" and stats["hard"] == "50.0%" and "relation" in last


@pytest.mark.parametrize("options,letter", [(["2", "3", "4", "5"], "B"), (["7", "3", "4", "5"], "B"),
                                            (["2", "3"], "A"), (["(A) 9", "(B) 8"], "c")])
def test_correct_count_answer(options, letter):
    words = td.expand_question_words("How many chairs are there?")
    objs = [{"id": "chair.1", "bbox": []}, {"id": "chair.2", "bbox": []}]
    want, got = _both("correct_count_answer", words, objs, list(options), letter)
    assert got == want
    assert got[0][ord(got[1]) - 65] == "2"


def test_shuffle_options_deterministic():
    options = ["red", "green", "blue", "yellow"]
    for key in ("some question", "another", "q7"):
        want, got = _both("shuffle_options_deterministic", list(options), "B", key)
        assert got == want and got[0][ord(got[1]) - 65] == "green"


class _FakeImage:
    size = (640, 480)


def _fake_llm_factory():
    count = {"n": 0}

    def call(prompt):
        count["n"] += 1
        cat = ["count", "relation", "depth"][count["n"] % 3]
        return json.dumps({
            "question": f"How many chairs are visible? v{count['n']}",
            "options": ["(A) 1", "(B) 2", "(C) 3", "(D) 4"],
            "answer": "B", "category": cat, "level": ["easy", "medium", "hard"][count["n"] % 3],
            "rating": 5 + count["n"] % 3,
        })

    return call


def _scene_rows(n):
    return [{"image_id": i, "image": _FakeImage(),
             "objects": json.dumps([{"id": "chair.1", "bbox": [0, 0, 10, 10]},
                                    {"id": "chair.2", "bbox": [5, 5, 15, 15]}]),
             "relationships": json.dumps([{"subject": "chair.1", "predicate": "next to", "object": "chair.2"}])}
            for i in range(n)]


def _without_images(rows):
    return [{k: v for k, v in r.items() if k != "images"} for r in rows]


def test_generate_questions_pipeline(tmp_path):
    prompts = {}
    outs = []
    for pkg in PACKAGES:
        llm = _fake_llm_factory()
        seen = prompts.setdefault(pkg.__name__, [])
        rows = pkg.generate_questions(lambda p, llm=llm, seen=seen: seen.append(p) or llm(p), _scene_rows(3),
                                      out_csv=str(tmp_path / f"{pkg.__name__}.csv"), save_every=2)
        outs.append(rows)
    want, got = outs
    assert _without_images(got) == _without_images(want)
    assert prompts["spatialthinker_torch.data_gen"] == prompts["spatialthinker_tpu.data_gen"]
    assert (tmp_path / "spatialthinker_torch.data_gen.csv").read_text() == \
        (tmp_path / "spatialthinker_tpu.data_gen.csv").read_text()
    assert len(got) == 3 and all("<scene>" in r["answer"] and "<answer>" in r["answer"] for r in got)
    assert "Image size: (640 x 480)" in got[0]["problem"]


def _hf_rows():
    rows = []
    for i in range(20):
        cat = "relation" if i < 10 else ["count", "depth"][i % 2]
        rows.append({"question_only": f"q{i}", "problem": f"prefix\nq{i}",
                     "question_with_options": f"q{i}\n\nOptions:\n(A) 1", "options": ["1", "2", "3", "4"],
                     "answer": "<scene>{}</scene>\n<answer>A</answer>", "category": cat,
                     "level": ["easy", "hard"][i % 2], "rating": i, "images": _FakeImage()})
    return rows


def test_build_hf_and_splits():
    want, got = (pkg.build_hf_dataset(_hf_rows(), target_size=8, relation_fraction=0.5) for pkg in PACKAGES)
    assert _without_images(got) == _without_images(want)
    assert [r["category"] for r in got].count("relation") == 4
    assert all("answer_letter" in r and "answer_only" in r for r in got)
    (je, jh), (easy, hard) = (pkg.easy_hard_splits(rows) for pkg, rows in zip(PACKAGES, (want, got)))
    assert _without_images(easy) == _without_images(je) and _without_images(hard) == _without_images(jh)
    assert all(r["level"] in ("easy", "medium") for r in easy) and all(r["level"] == "hard" for r in hard)


def test_cross_validate_pass_at_k():
    rows = [{"question_only": "q", "options": ["1", "2"], "images": _FakeImage(),
             "answer": "<answer>A</answer>", "answer_letter": "A"},
            {"question_only": "q2", "options": ["1", "2"], "images": _FakeImage(),
             "answer": "<answer>(B) 2</answer>"}]
    calls = {}
    kept = []
    for pkg in PACKAGES:
        log = calls.setdefault(pkg.__name__, [])
        kept.append(pkg.cross_validate(rows, lambda q, o, i, log=log: log.append(q) or "(a)", attempts=2,
                                       retry_attempts=1))
    assert kept[0] == kept[1] and len(kept[1]) == 1 and kept[1][0]["answer_letter"] == "A"
    assert calls["spatialthinker_tpu.data_gen"] == calls["spatialthinker_torch.data_gen"] == ["q", "q2", "q2", "q2"]


# ---------------------------------------------------------------------------
# the LLM callers and the CLI, requests.post mocked
# ---------------------------------------------------------------------------


class _Resp:
    def __init__(self, body, status=200):
        self.body, self.status_code = body, status

    def json(self):
        return self.body

    def raise_for_status(self):
        if self.status_code >= 400:
            import requests

            raise requests.HTTPError(f"HTTP {self.status_code}", response=self)


def _recording_post(replies):
    sent = []

    def post(url, headers=None, json=None, timeout=None):
        sent.append({"url": url, "headers": headers, "json": json, "timeout": timeout})
        return replies.pop(0) if isinstance(replies, list) else replies

    return sent, post


def test_llm_callers_send_the_jax_packages_requests(monkeypatch):
    """Both callers post the JAX package's bodies to its endpoints and read
    the same field of the reply; the port retries a 429 through
    ``post_with_retry`` (no sleep of its own) and raises a 4xx at once."""
    import requests
    from PIL import Image

    image = Image.fromarray((np.arange(48).reshape(4, 4, 3) % 255).astype(np.uint8))
    sent_by = {}
    for mod in (jllm, tllm):
        sent, post = _recording_post(_Resp({"content": [{"text": "made"}],
                                            "choices": [{"message": {"content": "(B)"}}]}))
        monkeypatch.setattr(requests, "post", post)
        assert mod.call_anthropic("hello", api_key="k1") == "made"
        assert mod.call_openai_vision("Which?", ["x", "y"], image, api_key="k2") == "(B)"
        sent_by[mod.__name__] = sent
    assert sent_by["spatialthinker_torch.data_gen.llm"] == sent_by["spatialthinker_tpu.data_gen.llm"]
    sleeps = []
    monkeypatch.setattr("time.sleep", sleeps.append)
    sent, post = _recording_post([_Resp({}, 429), _Resp({"content": [{"text": "late"}]})])
    monkeypatch.setattr(requests, "post", post)
    assert tllm.call_anthropic("hello", api_key="k") == "late" and len(sent) == 2 and sleeps == [1.0]
    sent, post = _recording_post(_Resp({}, 401))
    monkeypatch.setattr(requests, "post", post)
    with pytest.raises(requests.HTTPError):
        tllm.call_anthropic("hello", api_key="k")
    assert len(sent) == 1


class _Rows:
    """An in-memory stand-in for the hub's scene-graph split: len, select, iteration."""

    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def select(self, indices):
        return _Rows([self.rows[i] for i in indices])

    def __iter__(self):
        return iter(self.rows)


def test_preprocess_cli_on_in_memory_rows(tmp_path, monkeypatch):
    """``preprocess`` of both CLIs on the same 3 scene-graph rows (the hub
    loader patched to return them, capped at 2 by ``--data-cap``), the
    question model answered through a patched ``requests.post``: the same
    requests and the same CSV."""
    import datasets
    import requests

    def load_dataset(name, split):
        assert (name, split) == ("JosephZ/vg150_train_sgg_prompt", "train")
        return _Rows(_scene_rows(3))

    monkeypatch.setattr(datasets, "load_dataset", load_dataset)
    sent_by = {}
    for name, run in (("jax", lambda argv: (monkeypatch.setattr(sys, "argv", ["data_gen", *argv]), jcli.main())),
                      ("torch", tcli.main)):
        llm = _fake_llm_factory()
        sent = sent_by.setdefault(name, [])

        def post(url, headers=None, json=None, timeout=None, llm=llm, sent=sent):
            sent.append((url, json))
            return _Resp({"content": [{"text": llm(json["messages"][0]["content"])}]})

        monkeypatch.setattr(requests, "post", post)
        run(["preprocess", "--data-cap", "2", "--out", str(tmp_path / f"{name}.csv")])
    assert len(sent_by["torch"]) == 2 and sent_by["torch"] == sent_by["jax"]
    got = (tmp_path / "torch.csv").read_text()
    assert got == (tmp_path / "jax.csv").read_text() and "How many chairs" in got


def test_the_package_imports_neither_torch_nor_the_jax_package():
    code = ("import sys; import spatialthinker_torch.data_gen, spatialthinker_torch.data_gen.llm, "
            "spatialthinker_torch.data_gen.__main__; "
            "print(sorted(m for m in sys.modules if m in ('torch', 'jax') or m.startswith('spatialthinker_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
