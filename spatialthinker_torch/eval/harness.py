"""Evaluation harness (the port's own copy of
``spatialthinker_tpu/eval/harness.py``): load a registered benchmark,
batch-generate with a provider, judge the answers, accumulate accuracy
(overall, per task, view consistency), save to and resume from the output
JSON. ``datasets`` is imported only when a benchmark is loaded."""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .extraction import extract_reasoning, judge_answer
from .metrics import summarize
from .registry import DatasetSpec, get_dataset_spec
from .templates import format_instruction
from .providers import Provider


@dataclass
class EvalConfig:
    dataset: str
    template: str = "spatial_thinker"
    num_samples: int = -1          # -1 = whole set
    batch_size: int = 8
    output_file: Optional[str] = None
    resume: bool = True
    seed: int = 0


def load_benchmark(spec: DatasetSpec, num_samples: int = -1) -> List[Dict[str, Any]]:
    """Load + normalize rows to {instruction, images, response, choices,
    options, task}."""
    import datasets

    if spec.subset:
        ds = datasets.load_dataset(spec.name, spec.subset, split=spec.split)
    else:
        ds = datasets.load_dataset(spec.name, split=spec.split)
    if num_samples > 0:
        ds = ds.select(range(min(num_samples, len(ds))))

    rows = []
    image_fields = (
        spec.image_field if isinstance(spec.image_field, list)
        else ([spec.image_field] if spec.image_field else [])
    )
    for item in ds:
        images = [item[f] for f in image_fields if item.get(f) is not None]
        if spec.image_field == "images" and isinstance(item.get("images"), list):
            images = item["images"]
        rows.append(
            {
                "instruction": str(item.get(spec.instruction_field, "")) if spec.instruction_field else "",
                "images": images,
                "response": str(item[spec.response_field]),
                "choices": item.get(spec.choices_field) if spec.choices_field else None,
                "options": item.get(spec.options_field) if spec.options_field else None,
                "task": item.get(spec.task_field) if spec.task_field else None,
            }
        )
    return rows


def _load_resume(output_file: Optional[str]) -> List[Dict]:
    if output_file and os.path.exists(output_file):
        with open(output_file) as f:
            data = json.load(f)
        return data.get("records", [])
    return []


def _save(output_file: Optional[str], records: List[Dict], summary: Dict) -> None:
    if not output_file:
        return
    os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    with open(output_file, "w") as f:
        json.dump({"summary": summary, "records": records}, f, indent=1, default=str)


def _image_size(images: List[Any]):
    if not images:
        return None
    img = images[0]
    if hasattr(img, "shape"):  # an (H, W, C) array; its ``size`` is the element count
        h, w = img.shape[:2]
        return (w, h)
    if hasattr(img, "size"):
        return img.size  # PIL (W, H)
    return None


def run_evaluation(provider: Provider, config: EvalConfig) -> Dict[str, float]:
    spec = get_dataset_spec(config.dataset)
    rows = load_benchmark(spec, config.num_samples)

    records: List[Dict] = _load_resume(config.output_file) if config.resume else []
    start = len(records)
    paired = config.dataset == "3dsrbench_full"
    yes_no_numeric = config.dataset == "hallusionbench"

    for batch_start in range(start, len(rows), config.batch_size):
        batch = rows[batch_start : batch_start + config.batch_size]
        prompts = []
        for row in batch:
            opts = row["options"] or row["choices"]
            prompts.append(
                format_instruction(
                    row["instruction"],
                    options=list(opts) if opts else None,
                    image_size=_image_size(row["images"]),
                    template=config.template,
                )
            )
        outputs = provider.generate(prompts, [r["images"] for r in batch])

        for row, prompt, output in zip(batch, prompts, outputs):
            correct, pred, gt = judge_answer(
                output,
                row["response"],
                choices=list(row["choices"]) if row["choices"] else None,
                yes_no_numeric=yes_no_numeric,
                strip_gt_braces=config.dataset not in ("realworld_qa", "spatialbench", "mathvista"),
            )
            records.append(
                {
                    "prompt": prompt,
                    "pred_answer": pred,
                    "correct_answer": gt,
                    "reasoning": extract_reasoning(output),
                    "raw_output": output,
                    "correct": int(correct),
                    "task": row["task"],
                }
            )

        done = len(records)
        acc = sum(r["correct"] for r in records) / done
        err = math.sqrt(max(acc * (1 - acc), 0) / done)
        print(f"[{config.dataset}] {done}/{len(rows)} acc={acc * 100:.2f} ± {err * 100:.2f}", flush=True)
        if done % (config.batch_size * 2) == 0 or done >= len(rows):
            _save(config.output_file, records, summarize(records, spec.tasks, paired))

    summary = summarize(records, spec.tasks, paired)
    _save(config.output_file, records, summary)
    return summary
