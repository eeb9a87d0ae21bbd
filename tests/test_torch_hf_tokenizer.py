"""``ray_tpu_torch.llm.tokenizer.HFTokenizer``, the copy of the JAX
package's HuggingFace wrapper: it loads only local files, and imports
``transformers`` only when it is constructed.  A stub ``transformers``
module stands in for the library (no tokenizer files are needed)."""

import sys
import types

import pytest

from ray_tpu_torch.llm import tokenizer as tok


class _StubTokenizer:
    vocab_size = 300
    eos_token_id = 299

    def encode(self, text):
        return [ord(c) for c in text]

    def decode(self, ids):
        return "".join(chr(i) for i in ids)


@pytest.fixture
def stub_transformers(monkeypatch):
    calls = []

    class AutoTokenizer:
        @staticmethod
        def from_pretrained(path, **kwargs):
            calls.append((path, kwargs))
            return _StubTokenizer()

    monkeypatch.setitem(sys.modules, "transformers",
                        types.SimpleNamespace(AutoTokenizer=AutoTokenizer))
    return calls


def test_hf_tokenizer_loads_local_files_only(stub_transformers):
    t = tok.HFTokenizer("/models/tok")
    assert stub_transformers == [("/models/tok", {"local_files_only": True})]
    assert t.vocab_size == 300 and t.EOS == 299
    ids = t.encode("hi", add_bos=True)
    assert ids == [104, 105]
    assert t.decode(ids) == "hi"


def test_hf_tokenizer_without_transformers_raises(monkeypatch):
    # A None entry makes ``import transformers`` raise ImportError.
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        tok.HFTokenizer("/models/tok")


def test_hf_tokenizer_is_not_exported_from_llm():
    import ray_tpu_torch.llm as llm

    assert not hasattr(llm, "HFTokenizer")
