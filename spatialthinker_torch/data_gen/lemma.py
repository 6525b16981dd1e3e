"""Lightweight noun normalization for question-word <-> scene-graph matching
(the port's copy of ``spatialthinker_tpu/data_gen/lemma.py``).

Rule-based singular/plural normalization with the common irregulars; where
NLTK and its WordNet corpus are installed, their lemmatizer instead (probed
once at import, as the JAX package does, so both packages normalize alike).
"""

from __future__ import annotations

import re
from typing import List, Set

try:
    from nltk.stem import WordNetLemmatizer

    _LEMMATIZER = WordNetLemmatizer()
    _LEMMATIZER.lemmatize("chairs")  # probe: raises if the wordnet corpus is absent
except Exception:
    _LEMMATIZER = None

IRREGULAR = {
    "men": "man", "women": "woman", "children": "child", "people": "person",
    "feet": "foot", "teeth": "tooth", "geese": "goose", "mice": "mouse",
    "leaves": "leaf", "knives": "knife", "shelves": "shelf", "wolves": "wolf",
    "loaves": "loaf", "lives": "life", "wives": "wife", "halves": "half",
    "glasses": "glass", "buses": "bus", "dishes": "dish", "boxes": "box",
    "benches": "bench", "watches": "watch", "sheep": "sheep", "deer": "deer",
}

_STOPWORDS = {
    "the", "a", "an", "is", "are", "was", "were", "of", "in", "on", "at", "to",
    "and", "or", "how", "many", "much", "what", "which", "where", "who", "does",
    "do", "there", "this", "that", "these", "those", "image", "picture", "photo",
    "shown", "visible", "scene", "between", "than", "with", "from", "it", "its",
}


def normalize_token(token: str) -> str:
    """Lowercase, strip punctuation, singularize."""
    t = re.sub(r"[^a-z]", "", token.lower())
    if not t:
        return ""
    if _LEMMATIZER is not None:
        return _LEMMATIZER.lemmatize(t)
    if t in IRREGULAR:
        return IRREGULAR[t]
    if t.endswith("ies") and len(t) > 4:
        return t[:-3] + "y"
    if t.endswith("ses") or t.endswith("xes") or t.endswith("zes") or t.endswith("ches") or t.endswith("shes"):
        return t[:-2]
    if t.endswith("s") and not t.endswith("ss") and len(t) > 3:
        return t[:-1]
    return t


def expand_question_words(question: str) -> Set[str]:
    """Normalized content words of a question, with singular+plural variants
    so scene-graph ids match either form."""
    words = set()
    for raw in re.findall(r"[A-Za-z]+", question.lower()):
        if raw in _STOPWORDS:
            continue
        norm = normalize_token(raw)
        if norm:
            words.add(norm)
            words.add(raw)
    return words


def map_objects(objects: List[dict], question_words: Set[str]) -> List[dict]:
    """Keep scene-graph objects whose root name matches a question word
    (reference generate_data.py:137-147)."""
    out = []
    for obj in objects:
        root = normalize_token(obj["id"].split(".")[0])
        if root in question_words:
            out.append(obj)
    return out


def map_relationships(relationships: List[dict], question_words: Set[str]) -> List[dict]:
    """Keep relationships whose subject or object matches a question word."""
    out = []
    for rel in relationships:
        subj = normalize_token(rel["subject"].split(".")[0])
        obj = normalize_token(rel["object"].split(".")[0])
        if subj in question_words or obj in question_words:
            out.append(rel)
    return out
