"""Scene-graph parsing and schema validation for <observe><scene><think><answer>
traces (behavioral parity: verl/utils/reward_score/spatial_sgg.py:504-642)."""

from __future__ import annotations

import json
import re
from typing import Dict, Tuple

REQUIRED_KEYS_OBJ = {"id", "bbox"}
REQUIRED_KEYS_REL = {"subject", "predicate", "object"}

_ID_RE = re.compile(r"[a-zA-Z_]+\.\d+")
_ANSWER_RE = re.compile(r"<answer>(.*?)</answer>", re.DOTALL)
_SCENE_RE = re.compile(r"<scene>(.*?)</scene>", re.DOTALL)
_IMAGE_SIZE_RE = re.compile(r"Image size: \((.*?) x (.*?)\)")


def is_valid_id_format(s: str) -> bool:
    """ids must look like 'name.N' (e.g. 'chair.2')."""
    return bool(_ID_RE.fullmatch(s))


def is_valid_object(obj) -> bool:
    if not isinstance(obj, dict):
        return False
    if not REQUIRED_KEYS_OBJ.issubset(obj.keys()):
        return False
    if not all(key in REQUIRED_KEYS_OBJ for key in obj.keys()):  # no extra keys
        return False
    if not isinstance(obj["id"], str) or not is_valid_id_format(obj["id"]):
        return False
    bbox = obj["bbox"]
    if not isinstance(bbox, list) or len(bbox) != 4:
        return False
    return all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in bbox)


def is_valid_relation(rel) -> bool:
    if not isinstance(rel, dict):
        return False
    if not REQUIRED_KEYS_REL.issubset(rel.keys()):
        return False
    if not all(isinstance(rel[k], str) for k in ("subject", "predicate", "object")):
        return False
    return is_valid_id_format(rel["subject"]) and is_valid_id_format(rel["object"])


def extract_answer(text: str) -> str:
    match = _ANSWER_RE.search(text)
    return match.group(1).strip() if match else ""


def extract_scene(text: str) -> Dict:
    match = _SCENE_RE.search(text)
    if not match:
        return {}
    try:
        parsed = json.loads(match.group(1).strip())
        return parsed if isinstance(parsed, dict) else {}
    except Exception:
        return {}


def extract_image_size(problem: str) -> Tuple[int, int]:
    match = _IMAGE_SIZE_RE.search(problem)
    if not match:
        raise ValueError("Image size not found in problem — required for spatial reward scoring.")
    return int(match.group(1)), int(match.group(2))


def format_reward(text: str) -> float:
    """1.0 iff all four tags appear exactly once AND the scene JSON is schema-valid
    with unique object ids (reference spatial_sgg.py:564-606)."""
    try:
        has_all = all(
            re.search(rf"<{tag}>.*?</{tag}>", text, re.DOTALL)
            for tag in ("observe", "think", "scene", "answer")
        )
        if not has_all:
            return 0.0
        if any(text.count(f"<{tag}>") != 1 for tag in ("observe", "think", "scene", "answer")):
            return 0.0
        scene = extract_scene(text)
        if not scene or not isinstance(scene, dict):
            return 0.0
        objs = scene.get("objects", [])
        rels = scene.get("relationships", [])
        if not isinstance(objs, list) or not isinstance(rels, list):
            return 0.0
        if not all(is_valid_object(o) for o in objs):
            return 0.0
        if not all(is_valid_relation(r) for r in rels):
            return 0.0
        ids = [o.get("id", "") for o in objs]
        if len(ids) != len(set(ids)):
            return 0.0
        return 1.0
    except Exception:
        return 0.0
