"""Curated semantic-feature vectors for the Visual Genome label vocabulary.

The reference scores label similarity with spaCy ``en_core_web_md`` word
vectors (verl/utils/reward_score/spatial_sgg.py:12-39). This
host has no spaCy and zero network egress, so the zero-egress default backend
is this curated table: each common VG object/predicate word carries a small
set of semantic features (person/animal/vehicle/furniture/..., and for
predicates contact/above/proximity/...), and the vector is the L2-normalized
concatenation of

    [ multi-hot feature block * sqrt(0.65) | word-identity one-hot * sqrt(0.35) ]

so two words sharing ALL features score 0.65 (the spaCy-md ballpark for close
synonyms like man/person ~0.6-0.8), partial overlap scores proportionally
lower, and disjoint feature sets score ~0. Words outside the vocabulary fall
back per-phrase to the char-ngram hash backend (semantic.TableBackend).

For exact reference parity, export the real spaCy vectors on a networked
machine (scripts/export_spacy_vectors.py) and point
``SPATIALTHINKER_SEMSIM_TABLE`` at the resulting .npz — the same TableBackend
loads it in place of this table.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

FEATURE_SHARE = 0.65  # sim of two distinct words with identical feature sets

# word -> semantic features. Nouns cover the high-frequency VG object labels
# (the distribution the spatial reward's Hungarian matcher sees); predicate
# entries cover the relationship vocabulary used by match_triplets.
WORD_FEATURES: Dict[str, Tuple[str, ...]] = {
    # --- people -----------------------------------------------------------
    "man": ("person", "male", "adult"),
    "woman": ("person", "female", "adult"),
    "person": ("person", "adult"),
    "people": ("person", "group"),
    "boy": ("person", "male", "child"),
    "girl": ("person", "female", "child"),
    "child": ("person", "child"),
    "kid": ("person", "child"),
    "lady": ("person", "female", "adult"),
    "guy": ("person", "male", "adult"),
    "player": ("person", "sports"),
    "rider": ("person", "motion"),
    # --- animals ----------------------------------------------------------
    "dog": ("animal", "mammal", "pet"),
    "cat": ("animal", "mammal", "pet"),
    "horse": ("animal", "mammal", "livestock", "ride"),
    "sheep": ("animal", "mammal", "livestock"),
    "cow": ("animal", "mammal", "livestock"),
    "elephant": ("animal", "mammal", "wild"),
    "zebra": ("animal", "mammal", "wild"),
    "giraffe": ("animal", "mammal", "wild"),
    "bear": ("animal", "mammal", "wild"),
    "bird": ("animal", "bird"),
    "duck": ("animal", "bird", "water"),
    "fish": ("animal", "water"),
    # --- vehicles ---------------------------------------------------------
    "car": ("vehicle", "road", "wheeled"),
    "truck": ("vehicle", "road", "wheeled", "large"),
    "bus": ("vehicle", "road", "wheeled", "large", "transit"),
    "van": ("vehicle", "road", "wheeled"),
    "taxi": ("vehicle", "road", "wheeled", "transit"),
    "bike": ("vehicle", "road", "wheeled", "ride", "two wheel"),
    "bicycle": ("vehicle", "road", "wheeled", "ride", "two wheel"),
    "motorcycle": ("vehicle", "road", "wheeled", "ride", "two wheel"),
    "train": ("vehicle", "rail", "large", "transit"),
    "boat": ("vehicle", "water"),
    "ship": ("vehicle", "water", "large"),
    "plane": ("vehicle", "air", "large"),
    "airplane": ("vehicle", "air", "large"),
    "skateboard": ("vehicle", "ride", "sports", "board"),
    "surfboard": ("vehicle", "ride", "sports", "board", "water"),
    "skis": ("vehicle", "ride", "sports", "snow"),
    "snowboard": ("vehicle", "ride", "sports", "board", "snow"),
    # --- furniture / indoor ------------------------------------------------
    "table": ("furniture", "surface", "indoor"),
    "desk": ("furniture", "surface", "indoor", "work"),
    "chair": ("furniture", "seating", "indoor"),
    "couch": ("furniture", "seating", "indoor", "soft"),
    "sofa": ("furniture", "seating", "indoor", "soft"),
    "bench": ("furniture", "seating", "outdoor"),
    "bed": ("furniture", "indoor", "soft", "sleep"),
    "shelf": ("furniture", "storage", "indoor"),
    "cabinet": ("furniture", "storage", "indoor"),
    "drawer": ("furniture", "storage", "indoor"),
    "counter": ("furniture", "surface", "indoor"),
    "lamp": ("light", "indoor", "appliance"),
    "light": ("light",),
    "mirror": ("indoor", "glass", "flat"),
    "rug": ("textile", "indoor", "floor"),
    "carpet": ("textile", "indoor", "floor"),
    "curtain": ("textile", "indoor", "window adj"),
    "pillow": ("textile", "indoor", "soft", "sleep"),
    "blanket": ("textile", "indoor", "soft", "sleep"),
    "towel": ("textile", "indoor", "soft"),
    "clock": ("indoor", "device", "round"),
    "picture": ("indoor", "flat", "art"),
    "painting": ("indoor", "flat", "art"),
    "television": ("electronics", "indoor", "screen"),
    "tv": ("electronics", "indoor", "screen"),
    "laptop": ("electronics", "screen", "work", "portable"),
    "computer": ("electronics", "screen", "work"),
    "monitor": ("electronics", "screen", "work"),
    "keyboard": ("electronics", "work", "input"),
    "mouse": ("electronics", "work", "input", "small"),
    "phone": ("electronics", "screen", "portable", "small"),
    "remote": ("electronics", "input", "small", "portable"),
    "oven": ("appliance", "indoor", "kitchen", "hot"),
    "stove": ("appliance", "indoor", "kitchen", "hot"),
    "microwave": ("appliance", "indoor", "kitchen", "hot"),
    "refrigerator": ("appliance", "indoor", "kitchen", "cold", "large"),
    "fridge": ("appliance", "indoor", "kitchen", "cold", "large"),
    "sink": ("appliance", "indoor", "water fixture"),
    "toilet": ("appliance", "indoor", "water fixture", "bathroom"),
    "bathtub": ("appliance", "indoor", "water fixture", "bathroom"),
    # --- tableware / food ---------------------------------------------------
    "plate": ("tableware", "flat", "round"),
    "bowl": ("tableware", "container", "round"),
    "cup": ("tableware", "container", "drink"),
    "mug": ("tableware", "container", "drink"),
    "glass": ("tableware", "container", "drink", "glass"),
    "bottle": ("container", "drink"),
    "jar": ("container",),
    "fork": ("tableware", "utensil"),
    "knife": ("tableware", "utensil", "sharp"),
    "spoon": ("tableware", "utensil"),
    "pot": ("tableware", "container", "kitchen"),
    "pan": ("tableware", "kitchen", "flat"),
    "pizza": ("food", "meal", "round", "flat"),
    "sandwich": ("food", "meal"),
    "cake": ("food", "sweet"),
    "donut": ("food", "sweet", "round"),
    "bread": ("food",),
    "apple": ("food", "fruit", "round"),
    "banana": ("food", "fruit"),
    "orange": ("food", "fruit", "round"),
    "broccoli": ("food", "vegetable"),
    "carrot": ("food", "vegetable"),
    "hot dog": ("food", "meal"),
    # --- clothing -----------------------------------------------------------
    "shirt": ("clothing", "torso"),
    "jacket": ("clothing", "torso", "outer"),
    "coat": ("clothing", "torso", "outer"),
    "sweater": ("clothing", "torso", "soft"),
    "dress": ("clothing", "torso", "female"),
    "pants": ("clothing", "legs"),
    "jeans": ("clothing", "legs"),
    "shorts": ("clothing", "legs"),
    "skirt": ("clothing", "legs", "female"),
    "hat": ("clothing", "headwear"),
    "cap": ("clothing", "headwear"),
    "helmet": ("clothing", "headwear", "protective"),
    "shoe": ("clothing", "footwear"),
    "shoes": ("clothing", "footwear"),
    "boot": ("clothing", "footwear"),
    "sneaker": ("clothing", "footwear", "sports"),
    "glove": ("clothing", "hand"),
    "sock": ("clothing", "footwear", "soft"),
    "tie": ("clothing", "accessory", "torso"),
    "scarf": ("clothing", "accessory", "soft"),
    "glasses": ("accessory", "glass", "face"),
    "sunglasses": ("accessory", "glass", "face", "outdoor"),
    "watch": ("accessory", "device", "small", "hand"),
    "bag": ("accessory", "container", "carry"),
    "backpack": ("accessory", "container", "carry"),
    "purse": ("accessory", "container", "carry", "female"),
    "umbrella": ("accessory", "carry", "rain"),
    # --- structures / outdoor -----------------------------------------------
    "building": ("structure", "large", "outdoor"),
    "house": ("structure", "large", "outdoor", "home"),
    "tower": ("structure", "large", "outdoor", "tall"),
    "bridge": ("structure", "large", "outdoor", "span"),
    "wall": ("structure", "flat", "vertical"),
    "roof": ("structure", "top"),
    "floor": ("structure", "flat", "ground", "indoor"),
    "ceiling": ("structure", "flat", "top", "indoor"),
    "window": ("structure", "glass", "opening"),
    "door": ("structure", "opening", "vertical"),
    "fence": ("structure", "outdoor", "barrier"),
    "gate": ("structure", "outdoor", "barrier", "opening"),
    "stairs": ("structure", "steps"),
    "road": ("ground", "outdoor", "path", "road"),
    "street": ("ground", "outdoor", "path", "road"),
    "sidewalk": ("ground", "outdoor", "path"),
    "path": ("ground", "outdoor", "path"),
    "grass": ("ground", "outdoor", "plant"),
    "field": ("ground", "outdoor", "open"),
    "dirt": ("ground", "outdoor"),
    "sand": ("ground", "outdoor", "beach"),
    "beach": ("ground", "outdoor", "beach", "water adj"),
    "snow": ("ground", "outdoor", "snow", "cold"),
    "water": ("water", "outdoor"),
    "ocean": ("water", "outdoor", "large"),
    "sea": ("water", "outdoor", "large"),
    "lake": ("water", "outdoor"),
    "river": ("water", "outdoor"),
    "sky": ("sky", "outdoor", "top"),
    "cloud": ("sky", "outdoor", "soft"),
    "sun": ("sky", "outdoor", "light", "round"),
    "mountain": ("nature", "outdoor", "large", "tall"),
    "hill": ("nature", "outdoor", "large"),
    "rock": ("nature", "outdoor", "hard"),
    "stone": ("nature", "outdoor", "hard"),
    "tree": ("plant", "outdoor", "tall"),
    "bush": ("plant", "outdoor"),
    "plant": ("plant",),
    "flower": ("plant", "decorative"),
    "leaf": ("plant", "small"),
    "branch": ("plant", "part"),
    # --- street furniture / misc objects ------------------------------------
    "sign": ("sign", "outdoor", "flat", "info"),
    "pole": ("outdoor", "tall", "thin", "vertical"),
    "post": ("outdoor", "tall", "thin", "vertical"),
    "street light": ("light", "outdoor", "tall"),
    "traffic light": ("light", "outdoor", "sign", "info"),
    "hydrant": ("outdoor", "water fixture", "small"),
    "fire hydrant": ("outdoor", "water fixture", "small"),
    "trash can": ("container", "outdoor", "waste"),
    "box": ("container",),
    "basket": ("container", "carry"),
    "book": ("indoor", "flat", "info", "paper"),
    "paper": ("flat", "info", "paper"),
    "pen": ("utensil", "work", "small", "thin"),
    "ball": ("sports", "round", "toy"),
    "kite": ("toy", "outdoor", "air", "sports"),
    "frisbee": ("toy", "outdoor", "sports", "round", "flat"),
    "bat": ("sports", "thin"),
    "racket": ("sports",),
    "toy": ("toy",),
    "teddy bear": ("toy", "soft", "animal like"),
    "doll": ("toy", "person like"),
    "vase": ("container", "decorative", "indoor"),
    "candle": ("light", "indoor", "decorative", "small"),
    "flag": ("textile", "outdoor", "sign"),
    "banner": ("textile", "sign", "info"),
    "wheel": ("part", "round", "vehicle part"),
    "tire": ("part", "round", "vehicle part"),
    "handle": ("part", "small"),
    "leg": ("part", "body", "thin"),
    "arm": ("part", "body", "thin"),
    "hand": ("part", "body", "hand"),
    "head": ("part", "body", "top", "round"),
    "face": ("part", "body", "face"),
    "hair": ("part", "body", "top", "soft"),
    "ear": ("part", "body", "face", "small"),
    "eye": ("part", "body", "face", "small"),
    "nose": ("part", "body", "face", "small"),
    "tail": ("part", "body", "animal part", "thin"),
    "foot": ("part", "body", "footwear adj"),
    # --- predicates: spatial ------------------------------------------------
    "on": ("rel contact", "rel above"),
    "atop": ("rel contact", "rel above"),
    "on top of": ("rel contact", "rel above"),
    "above": ("rel above",),
    "over": ("rel above",),
    "below": ("rel below",),
    "under": ("rel below",),
    "beneath": ("rel below",),
    "underneath": ("rel below",),
    "in": ("rel inside",),
    "inside": ("rel inside",),
    "within": ("rel inside",),
    "near": ("rel proximity",),
    "beside": ("rel proximity", "rel side"),
    "next to": ("rel proximity", "rel side"),
    "next": ("rel proximity", "rel side"),
    "by": ("rel proximity",),
    "close to": ("rel proximity",),
    "adjacent to": ("rel proximity", "rel side"),
    "left of": ("rel side", "rel left"),
    "right of": ("rel side", "rel right"),
    "behind": ("rel depth", "rel back"),
    "in front of": ("rel depth", "rel front"),
    "front of": ("rel depth", "rel front"),
    "against": ("rel contact", "rel side"),
    "between": ("rel proximity", "rel between"),
    "at": ("rel proximity",),
    "along": ("rel proximity", "rel path"),
    "across": ("rel path",),
    "around": ("rel proximity", "rel surround"),
    "attached to": ("rel contact", "rel attached"),
    "mounted on": ("rel contact", "rel attached", "rel above"),
    "hanging on": ("rel contact", "rel attached", "rel below"),
    "hanging from": ("rel contact", "rel attached", "rel below"),
    "part of": ("rel attached", "rel part"),
    "covering": ("rel contact", "rel surround"),
    "covered by": ("rel contact", "rel surround"),
    # --- predicates: actions -------------------------------------------------
    "holding": ("rel action", "rel hold"),
    "carrying": ("rel action", "rel hold", "rel motion"),
    "wearing": ("rel action", "rel wear"),
    "wears": ("rel action", "rel wear"),
    "has": ("rel possession",),
    "have": ("rel possession",),
    "of": ("rel possession", "rel part"),
    "with": ("rel possession", "rel proximity"),
    "riding": ("rel action", "rel ride", "rel motion"),
    "sitting on": ("rel contact", "rel above", "rel sit"),
    "sitting in": ("rel inside", "rel sit"),
    "sitting at": ("rel proximity", "rel sit"),
    "standing on": ("rel contact", "rel above", "rel stand"),
    "standing in": ("rel inside", "rel stand"),
    "standing next to": ("rel proximity", "rel side", "rel stand"),
    "lying on": ("rel contact", "rel above", "rel lie"),
    "laying on": ("rel contact", "rel above", "rel lie"),
    "walking on": ("rel contact", "rel motion"),
    "walking in": ("rel inside", "rel motion"),
    "running on": ("rel contact", "rel motion"),
    "looking at": ("rel action", "rel gaze"),
    "watching": ("rel action", "rel gaze"),
    "facing": ("rel gaze", "rel front"),
    "eating": ("rel action", "rel eat"),
    "drinking": ("rel action", "rel eat"),
    "playing": ("rel action", "rel play"),
    "playing with": ("rel action", "rel play"),
    "using": ("rel action",),
    "touching": ("rel contact", "rel action"),
    "leaning on": ("rel contact", "rel side"),
    "leaning against": ("rel contact", "rel side"),
    "parked on": ("rel contact", "rel above", "rel still"),
    "parked in": ("rel inside", "rel still"),
    "driving on": ("rel contact", "rel motion"),
    "driving": ("rel action", "rel motion"),
    "flying in": ("rel inside", "rel motion", "rel air"),
    "flying over": ("rel above", "rel motion", "rel air"),
    "throwing": ("rel action", "rel motion"),
    "catching": ("rel action", "rel motion"),
    "pulling": ("rel action", "rel motion"),
    "pushing": ("rel action", "rel motion"),
}


def build_table() -> Tuple[List[str], np.ndarray]:
    """Materialize (words, vectors) from WORD_FEATURES (deterministic)."""
    words = sorted(WORD_FEATURES)
    feats = sorted({f for fs in WORD_FEATURES.values() for f in fs})
    f_index = {f: i for i, f in enumerate(feats)}
    n, nf = len(words), len(feats)
    a = np.sqrt(FEATURE_SHARE)
    b = np.sqrt(1.0 - FEATURE_SHARE)
    vectors = np.zeros((n, nf + n), dtype=np.float64)
    for i, w in enumerate(words):
        fs = WORD_FEATURES[w]
        block = np.zeros(nf)
        for f in fs:
            block[f_index[f]] = 1.0
        norm = np.linalg.norm(block)
        if norm > 0:
            vectors[i, :nf] = (block / norm) * a
        vectors[i, nf + i] = b
    return words, vectors


def write_npz(path: str) -> None:
    words, vectors = build_table()
    np.savez_compressed(path, words=np.array(words), vectors=vectors.astype(np.float32))
