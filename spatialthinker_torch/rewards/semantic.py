"""Label semantic similarity for scene-graph matching.

The reference computes cosine similarity between spaCy ``en_core_web_md`` word
vectors (verl/utils/reward_score/spatial_sgg.py:12-39). spaCy
is an optional dependency here; similarity is a pluggable backend:

- ``SpacyBackend``     — exact reference parity when spaCy + en_core_web_md are
                         installed.
- ``TableBackend``     — cosine over a word->vector table loaded from an .npz
                         (e.g. exported spaCy md vectors); multi-word labels
                         average their token vectors, like spaCy docs do.
- ``HashNgramBackend`` — dependency-free fallback: deterministic char-ngram
                         feature hashing + cosine. Identical strings score 1.0,
                         morphological variants score high, unrelated labels
                         score near 0. Used when no vector table is available.

All backends share label normalization with the reference: strip trailing
``.N`` ids, unify ``_``/``-`` to spaces, lowercase.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache
from typing import Optional, Protocol, Sequence

import numpy as np


def refine_node_edge(label: str) -> str:
    """Unify case/punct so 'fire-hydrant' == 'fire hydrant' (reference :25-27)."""
    return label.replace("_", " ").replace("-", " ").strip().lower()


def clean_label(label: str) -> str:
    """Keep 'chair' from 'chair.5' then normalize (reference sem_sim :33-39)."""
    return refine_node_edge(label.split(".")[0])


class SimilarityBackend(Protocol):
    def similarity(self, a: str, b: str) -> float: ...


class HashNgramBackend:
    """Char-ngram feature-hashed embeddings; deterministic, no deps.

    Properties relied on by the reward: sim(x, x) == 1.0, sim is symmetric,
    values in [-1, 1] with unrelated labels near 0.
    """

    def __init__(self, dim: int = 256, ngram_range=(2, 4)):
        self.dim = dim
        self.ngram_range = ngram_range
        self._vec = lru_cache(maxsize=8192)(self._vector_uncached)

    def _vector_uncached(self, text: str) -> np.ndarray:
        v = np.zeros(self.dim, dtype=np.float64)
        words = text.split()
        for word in words:
            padded = f"^{word}$"
            for n in range(self.ngram_range[0], self.ngram_range[1] + 1):
                for i in range(max(1, len(padded) - n + 1)):
                    gram = padded[i : i + n]
                    h = int.from_bytes(hashlib.blake2b(gram.encode(), digest_size=8).digest(), "little")
                    v[h % self.dim] += 1.0 if (h >> 63) & 1 == 0 else -1.0
            # whole-word feature dominates so exact word matches align strongly
            hw = int.from_bytes(hashlib.blake2b(word.encode(), digest_size=8).digest(), "little")
            v[hw % self.dim] += 4.0 if (hw >> 62) & 1 == 0 else -4.0
        norm = np.linalg.norm(v)
        return v / norm if norm > 0 else v

    def similarity(self, a: str, b: str) -> float:
        ca, cb = clean_label(a), clean_label(b)
        if ca == cb:
            return 1.0
        return float(np.dot(self._vec(ca), self._vec(cb)))


class TableBackend:
    """Cosine over a word->vector table (npz with 'words' and 'vectors'), or
    directly over a (words, vectors) pair (the in-repo curated VG table)."""

    def __init__(self, npz_path: Optional[str] = None, words=None, vectors=None):
        if npz_path is not None:
            data = np.load(npz_path, allow_pickle=True)
            words = [str(w) for w in data["words"]]
            vectors = np.asarray(data["vectors"], dtype=np.float64)
        else:
            words = [str(w) for w in words]
            vectors = np.asarray(vectors, dtype=np.float64)
        self.index = {w: i for i, w in enumerate(words)}
        norms = np.linalg.norm(vectors, axis=1, keepdims=True)
        self.vectors = vectors / np.where(norms == 0, 1.0, norms)
        self.dim = vectors.shape[1]
        self._phrase = lru_cache(maxsize=8192)(self._phrase_uncached)
        self._fallback = HashNgramBackend()

    def _phrase_uncached(self, text: str) -> Optional[np.ndarray]:
        vecs = [self.vectors[self.index[w]] for w in text.split() if w in self.index]
        if not vecs:
            return None
        v = np.mean(vecs, axis=0)
        norm = np.linalg.norm(v)
        return v / norm if norm > 0 else v

    def similarity(self, a: str, b: str) -> float:
        ca, cb = clean_label(a), clean_label(b)
        if ca == cb:
            return 1.0
        va, vb = self._phrase(ca), self._phrase(cb)
        if va is None or vb is None:
            return self._fallback.similarity(ca, cb)
        return float(np.dot(va, vb))


class SpacyBackend:
    """Exact reference parity when spaCy en_core_web_md is installed."""

    def __init__(self, model: str = "en_core_web_md"):
        import spacy  # noqa: deferred import, optional dep

        self.nlp = spacy.load(model, disable=["parser", "ner", "tagger"])
        self._doc = lru_cache(maxsize=4096)(self.nlp)

    def similarity(self, a: str, b: str) -> float:
        return float(self._doc(clean_label(a)).similarity(self._doc(clean_label(b))))


_BACKEND: Optional[SimilarityBackend] = None


def _default_backend() -> SimilarityBackend:
    """Resolution order: spaCy (exact reference parity) -> exported .npz
    (SPATIALTHINKER_SEMSIM_TABLE, see scripts/export_spacy_vectors.py) ->
    the in-repo curated VG feature table (zero-egress default; OOV phrases
    fall back per-phrase to char-ngram hashing inside TableBackend)."""
    try:
        return SpacyBackend()
    except Exception:
        pass
    import os

    npz = os.environ.get("SPATIALTHINKER_SEMSIM_TABLE")
    if npz:
        try:
            return TableBackend(npz)
        except Exception:
            pass
    try:
        from .vg_table import build_table

        words, vectors = build_table()
        return TableBackend(words=words, vectors=vectors)
    except Exception:
        return HashNgramBackend()


def get_backend() -> SimilarityBackend:
    global _BACKEND
    if _BACKEND is None:
        _BACKEND = _default_backend()
    return _BACKEND


def set_backend(backend: SimilarityBackend) -> None:
    global _BACKEND
    _BACKEND = backend


def sem_sim(a: str, b: str) -> float:
    return get_backend().similarity(a, b)


def sim_matrix(labels_a: Sequence[str], labels_b: Sequence[str]) -> np.ndarray:
    """Pairwise similarity matrix (N, M); vectorized entry point for cost matrices."""
    backend = get_backend()
    out = np.empty((len(labels_a), len(labels_b)), dtype=np.float64)
    for i, a in enumerate(labels_a):
        for j, b in enumerate(labels_b):
            out[i, j] = backend.similarity(a, b)
    return out
