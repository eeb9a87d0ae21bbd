"""Byte-level tokenizer — a copy of ``ray_tpu/llm/tokenizer.py:ByteTokenizer``.

Kept here rather than imported: importing ``ray_tpu.llm`` loads JAX."""

from __future__ import annotations

from typing import List


class ByteTokenizer:
    """UTF-8 bytes + BOS(256)/EOS(257); vocab_size 258."""

    BOS = 256
    EOS = 257

    vocab_size = 258

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.BOS] + ids) if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        data = bytes(i for i in ids if i < 256)
        return data.decode("utf-8", errors="replace")
