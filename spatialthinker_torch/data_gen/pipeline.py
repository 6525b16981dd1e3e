"""STVQA synthesis pipeline: scene-graph-grounded MCQ generation with live
balance feedback, count auto-correction, category balancing, deterministic
option shuffling, LLM cross-validation, and easy/hard splits (the port's copy
of ``spatialthinker_tpu/data_gen/pipeline.py``, function for function; no
torch: the pipeline is host code around LLM calls).

Stages:
  generate_questions   one balanced MCQ per scene graph (count answers
                       corrected inline by correct_count_answer)
  build_hf_dataset     category balance, rating order, option shuffle
  cross_validate       pass@k agreement of a checker model
  easy_hard_splits     by difficulty level

``pandas`` (the CSV writes) is imported where it is used.
"""

from __future__ import annotations

import ast
import json
import os
import re
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .lemma import expand_question_words, map_objects, map_relationships, normalize_token
from .prompts import CATEGORIES, LEVELS, QUESTION_GEN_PROMPT, QUESTION_PREFIX

SOURCE_DS = "JosephZ/vg150_train_sgg_prompt"
OPTION_PREFIX_RE = re.compile(r"^\([A-D]\)\s*")


# ---------------------------------------------------------------- utilities


def extract_json_from_output(output: str) -> str:
    """Pull the first JSON object out of an LLM reply (handles ``` fences)."""
    fenced = re.search(r"```(?:json)?\s*(\{.*?\})\s*```", output, re.DOTALL)
    if fenced:
        return fenced.group(1)
    start = output.find("{")
    if start == -1:
        raise ValueError("no JSON object in model output")
    depth = 0
    for i in range(start, len(output)):
        if output[i] == "{":
            depth += 1
        elif output[i] == "}":
            depth -= 1
            if depth == 0:
                return output[start : i + 1]
    raise ValueError("unbalanced JSON in model output")


def compute_data_stats(rows: Sequence[Dict]) -> Tuple[Dict[str, str], str]:
    """Category/level percentage table + last-3 values string, fed back into
    the generation prompt to balance the dataset."""
    total = len(rows)
    stats: Dict[str, str] = {}
    if total == 0:
        for key in CATEGORIES + LEVELS:
            stats[key] = "0.0%"
        return stats, "No data yet"
    cat_counts = Counter(r.get("category") for r in rows)
    level_counts = Counter(r.get("level") for r in rows)
    for cat in CATEGORIES:
        stats[cat] = f"{cat_counts.get(cat, 0) / total * 100:.1f}%"
    for level in LEVELS:
        stats[level] = f"{level_counts.get(level, 0) / total * 100:.1f}%"
    stats["total_samples"] = str(total)
    last = rows[-3:]
    last_vals = (
        f"Categories: {[r.get('category') for r in last]}, "
        f"Levels: {[r.get('level') for r in last]}"
    )
    return stats, last_vals


def strip_option_prefixes(options: Sequence[str]) -> List[str]:
    return [OPTION_PREFIX_RE.sub("", opt).strip() for opt in options]


def correct_count_answer(
    question_words, filtered_objects: List[dict], options: List[str], answer_letter: str
) -> Tuple[List[str], str, bool]:
    """Recount question-matched objects and fix the stored answer when the LLM
    miscounted (reference generate_data.py:353-398). Returns (options, letter,
    changed)."""
    root_count: Counter = Counter()
    for obj in filtered_objects:
        root = normalize_token(obj["id"].split(".")[0])
        if root:
            root_count[root] += 1
    matching_total = sum(c for root, c in root_count.items() if root in question_words)
    count_str = str(matching_total)

    options = strip_option_prefixes(options)
    idx = ord(answer_letter.upper()) - ord("A")
    current = options[idx] if 0 <= idx < len(options) else None
    if current == count_str:
        return options, answer_letter.upper(), False
    if count_str in options:
        return options, chr(ord("A") + options.index(count_str)), True
    if 0 <= idx < len(options):
        options[idx] = count_str
        return options, answer_letter.upper(), True
    options[0] = count_str
    return options, "A", True


# ------------------------------------------------------------ generation


def generate_questions(
    call_model: Callable[[str], str],
    dataset: Sequence[Dict],
    *,
    out_csv: str = "data/spatialthinker_vqa_train.csv",
    resume_rows: Optional[List[Dict]] = None,
    save_every: int = 10,
) -> List[Dict]:
    """For each VG image+scene-graph row, ask the LLM for one balanced MCQ,
    filter the scene graph to question-relevant objects, auto-correct counts,
    and assemble the training row (problem / options / tagged answer)."""
    rows: List[Dict] = list(resume_rows or [])

    for item in dataset:
        image = item["image"]
        width, height = _image_size(image)
        objects = _maybe_json(item["objects"])
        relationships = _maybe_json(item["relationships"])
        scene_json = json.dumps({"objects": objects, "relationships": relationships})

        stats, last_vals = compute_data_stats(rows)
        stats_str = "\n".join(f"{k}: {v}" for k, v in stats.items())
        stats_str += f"\nAvoid repeating the most recent categories/levels: {last_vals}"
        prompt = QUESTION_GEN_PROMPT.replace("$DATA_STATS$", stats_str) + scene_json

        output = call_model(prompt)
        parsed = json.loads(extract_json_from_output(output))
        question = parsed["question"]
        options = parsed["options"]
        if isinstance(options, str):
            options = ast.literal_eval(options)
        answer_letter = str(parsed["answer"]).strip().upper()[:1]
        category = parsed["category"]
        if category.startswith("REL_"):
            category = "relation"
        level = parsed["level"]
        rating = parsed.get("rating", 0)

        question_words = expand_question_words(question)
        filtered_objects = map_objects(objects, question_words)
        filtered_relationships = map_relationships(relationships, question_words)
        filtered_scene = json.dumps(
            {"objects": filtered_objects, "relationships": filtered_relationships}
        )

        options_clean = strip_option_prefixes(options)
        changed = False
        if category == "count":
            options_clean, answer_letter, changed = correct_count_answer(
                question_words, filtered_objects, options_clean, answer_letter
            )

        options_text = "\n".join(options)
        question_with_options = f"{question}\n\nOptions:\n{options_text}"
        prefix = QUESTION_PREFIX.format(W=width, H=height)
        scene_for_answer = scene_json if changed else filtered_scene
        rows.append(
            {
                "image_id": item.get("image_id"),
                "images": image,
                "problem": f"{prefix}\n{question_with_options}",
                "question_only": question,
                "question_with_options": question_with_options,
                "question_words": sorted(question_words),
                "options": options_clean,
                "answer": f"<scene>{scene_for_answer}</scene>\n<answer>{answer_letter}</answer>",
                "category": category,
                "level": level,
                "rating": rating,
                "full_scene_graph": scene_json,
            }
        )
        if save_every and len(rows) % save_every == 0:
            _save_csv(rows, out_csv)
    if out_csv:
        _save_csv(rows, out_csv)
    return rows


# ------------------------------------------------------------- HF assembly


def shuffle_options_deterministic(options: List[str], answer_letter: str, key: str) -> Tuple[List[str], str]:
    """Deterministic option shuffle keyed on the question hash (reference
    generate_data.py:605-644) so regeneration is stable."""
    import hashlib

    idx = ord(answer_letter.upper()) - ord("A")
    answer_text = options[idx]
    seed = int.from_bytes(hashlib.blake2b(key.encode(), digest_size=8).digest(), "little")
    order = sorted(range(len(options)), key=lambda i: (seed >> (i * 8)) & 0xFF)
    shuffled = [options[i] for i in order]
    new_letter = chr(ord("A") + shuffled.index(answer_text))
    return shuffled, new_letter


def build_hf_dataset(
    rows: List[Dict],
    *,
    target_size: int = 10_000,
    relation_fraction: float = 0.5,
) -> List[Dict]:
    """Category balancing (50% relation, rest uniform), rating-sorted top-N,
    deterministic option shuffling, derived answer columns
    (reference generate_hf_data, :438-788)."""
    by_cat: Dict[str, List[Dict]] = {}
    for r in rows:
        by_cat.setdefault(r["category"], []).append(r)
    for cat in by_cat:
        by_cat[cat].sort(key=lambda r: -float(r.get("rating", 0) or 0))

    relation_target = int(target_size * relation_fraction)
    others = [c for c in by_cat if c != "relation"]
    per_other = (target_size - relation_target) // max(len(others), 1)

    selected: List[Dict] = by_cat.get("relation", [])[:relation_target]
    for cat in others:
        selected.extend(by_cat[cat][:per_other])

    out = []
    for r in selected:
        options, letter = shuffle_options_deterministic(
            list(r["options"]), _answer_letter(r["answer"]), r["question_only"]
        )
        answer_text = options[ord(letter) - ord("A")]
        scene = re.search(r"<scene>(.*?)</scene>", r["answer"], re.DOTALL)
        scene_str = scene.group(1) if scene else "{}"
        options_block = "\n".join(f"({chr(65 + i)}) {o}" for i, o in enumerate(options))
        question_with_options = f"{r['question_only']}\n\nOptions:\n{options_block}"
        prefix_match = r["problem"].split("\n")[0]
        out.append(
            {
                **r,
                "options": options,
                "question_with_options": question_with_options,
                "problem": f"{prefix_match}\n{question_with_options}",
                "answer": f"<scene>{scene_str}</scene>\n<answer>({letter}) {answer_text}</answer>",
                "answer_only": f"({letter}) {answer_text}",
                "answer_letter": letter,
                "answer_text": answer_text,
            }
        )
    return out


# ------------------------------------------------------------- validation


def cross_validate(
    rows: List[Dict],
    call_vision_model: Callable[[str, List[str], Any], str],
    *,
    attempts: int = 2,
    retry_attempts: int = 2,
) -> List[Dict]:
    """pass@2(+2) validation (reference validate_with_gpt4o, :916-1027): keep a
    row if the checker model reproduces the stored answer within `attempts`
    tries (plus `retry_attempts` on disagreement)."""
    kept = []
    for r in rows:
        letter = r.get("answer_letter") or _answer_letter(r["answer"])
        ok = False
        for _ in range(attempts + retry_attempts):
            pred = call_vision_model(r["question_only"], list(r["options"]), r["images"])
            pred_letter = re.sub(r"[^A-D]", "", pred.upper()[:4])[:1]
            if pred_letter == letter:
                ok = True
                break
        if ok:
            kept.append(r)
    return kept


def easy_hard_splits(rows: List[Dict]) -> Tuple[List[Dict], List[Dict]]:
    """Split by difficulty level (easy+medium vs hard; reference :804-846)."""
    easy = [r for r in rows if r.get("level") in ("easy", "medium")]
    hard = [r for r in rows if r.get("level") == "hard"]
    return easy, hard


# ------------------------------------------------------------------ helpers


def _maybe_json(value):
    return json.loads(value) if isinstance(value, str) else value


def _image_size(image):
    if hasattr(image, "size"):
        return image.size
    if hasattr(image, "shape"):
        h, w = image.shape[:2]
        return (w, h)
    return (0, 0)


def _answer_letter(tagged_answer: str) -> str:
    m = re.search(r"<answer>\s*\(?([A-D])", tagged_answer)
    return m.group(1) if m else "A"


def _save_csv(rows: List[Dict], path: str) -> None:
    import pandas as pd

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pd.DataFrame(rows).drop(columns=["images"], errors="ignore").to_csv(path, index=False)
