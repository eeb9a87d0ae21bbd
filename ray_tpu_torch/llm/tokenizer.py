"""Tokenizers — copies of ``ray_tpu/llm/tokenizer.py``'s.

Kept here rather than imported: importing ``ray_tpu.llm`` loads JAX.  The
default is a byte-level tokenizer (vocab 256 + BOS/EOS); a HuggingFace
tokenizer can be dropped in via ``HFTokenizer`` when local tokenizer
files exist (no network fetch happens here)."""

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


class HFTokenizer:
    """Wrap a locally available HuggingFace tokenizer (no downloads)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = self._tok.vocab_size
        self.EOS = self._tok.eos_token_id

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        return self._tok.encode(text)

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids)
