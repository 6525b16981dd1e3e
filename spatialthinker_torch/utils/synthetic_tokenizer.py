"""The shared word-hashing ``SyntheticTokenizer`` (framework-free, in the JAX
package's ``utils``) with the special ids of a given Qwen2.5-VL config.

Its defaults put the specials at V-1 .. V-7, the tiny config's ids; the 3B
and 7B configs keep Qwen's ids (image 151655, vision start/end 151652/151653,
``<|im_end|>`` 151645, pad ``<|endoftext|>`` 151643). Words hash below the
lowest special id, so no word collides with one, and with CRC-32 rather than
Python's per-process salted ``hash``, so a prompt encodes to the same ids in
every run.
"""

from __future__ import annotations

import zlib

from spatialthinker_tpu.utils.synthetic_tokenizer import SyntheticTokenizer

from ..models.qwen2_5_vl.config import Qwen25VLConfig


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
