"""A deterministic self-contained tokenizer for offline smoke runs and tests
(the port's own copy of the JAX package's ``utils/synthetic_tokenizer.py``),
and its variant with the special ids of a given Qwen2.5-VL config.

``SyntheticTokenizer`` maps special tokens to the tiny model's reserved ids
(V-1 .. V-7) and hashes everything else word-level into the ordinary-vocab
range; decode is exact for encoded text (id -> word memo).
``QwenSyntheticTokenizer`` keeps a config's ids instead (for the 3B and 7B:
image 151655, vision start/end 151652/151653, ``<|im_end|>`` 151645, pad
``<|endoftext|>`` 151643). Its words hash below the lowest special id, so no
word collides with one, and with CRC-32 rather than Python's per-process
salted ``hash``, so a prompt encodes to the same ids in every run.
"""

from __future__ import annotations

import re
import zlib
from typing import Dict, List

from ..models.qwen2_5_vl.config import Qwen25VLConfig


class SyntheticTokenizer:
    SPECIALS = [
        "<|image_pad|>",
        "<|video_pad|>",
        "<|vision_start|>",
        "<|vision_end|>",
        "<|im_end|>",
        "<|im_start|>",
        "<|endoftext|>",
    ]

    def __init__(self, vocab_size: int = 1024):
        self.vocab_size = vocab_size
        # mirror qwen25_vl_tiny reserved ids: image=V-1, video=V-2, vis_start=V-3,
        # vis_end=V-4, eos(<|im_end|>)=V-5, im_start=V-6, endoftext=V-7
        self.special_to_id = {tok: vocab_size - 1 - i for i, tok in enumerate(self.SPECIALS)}
        self.id_to_special = {v: k for k, v in self.special_to_id.items()}
        self.eos_token_id = self.special_to_id["<|im_end|>"]
        self.pad_token_id = 0
        self._id_to_word: Dict[int, str] = {}
        self._pattern = re.compile(
            "(" + "|".join(re.escape(s) for s in self.SPECIALS) + r")|(\S+)|(\s+)"
        )
        self._word_base = 8
        self._word_range = vocab_size - 16 - self._word_base

    def _word_id(self, word: str) -> int:
        h = (hash(word) & 0x7FFFFFFF) % self._word_range + self._word_base
        self._id_to_word[h] = word
        return h

    def encode(self, text: str) -> List[int]:
        ids = []
        for m in self._pattern.finditer(text):
            special, word, _space = m.groups()
            if special:
                ids.append(self.special_to_id[special])
            elif word:
                ids.append(self._word_id(word))
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        words = []
        for i in ids:
            i = int(i)
            if i in self.id_to_special:
                if not skip_special_tokens:
                    words.append(self.id_to_special[i])
            elif i in self._id_to_word:
                words.append(self._id_to_word[i])
            elif i != self.pad_token_id:
                words.append(f"<unk{i}>")
        return " ".join(words)

    def batch_decode(self, seqs, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(s, skip_special_tokens) for s in seqs]


class QwenSyntheticTokenizer(SyntheticTokenizer):
    def __init__(self, cfg: Qwen25VLConfig):
        super().__init__(cfg.text.vocab_size)
        self.special_to_id = {
            "<|image_pad|>": cfg.image_token_id,
            "<|video_pad|>": cfg.video_token_id,
            "<|vision_start|>": cfg.vision_start_token_id,
            "<|vision_end|>": cfg.vision_end_token_id,
            "<|im_end|>": cfg.eos_token_id,
            "<|im_start|>": cfg.eos_token_id - 1,  # Qwen's sits right below <|im_end|>
            "<|endoftext|>": cfg.pad_token_id,
        }
        self.id_to_special = {v: k for k, v in self.special_to_id.items()}
        self.eos_token_id = cfg.eos_token_id
        self.pad_token_id = cfg.pad_token_id
        self._word_range = min(self.special_to_id.values()) - self._word_base

    def _word_id(self, word: str) -> int:
        h = zlib.crc32(word.encode()) % self._word_range + self._word_base
        self._id_to_word[h] = word
        return h
