"""A run with the timed path broken underneath comes out not correct:
a token altered where it is produced, and a decode step that leaves the
cache as it was."""

from benchmark.run import execute
from benchmark.tests import tiny

SEED = 2 ** 31 + 777


def test_altered_token_is_not_correct(monkeypatch):
    from ray_tpu_torch.llm import continuous_batching as cb

    decode = cb.BucketProgram.decode

    def shifted(self, tokens, pos):
        return decode(self, tokens, pos).roll(1, dims=-1)

    monkeypatch.setattr(cb.BucketProgram, "decode", shifted)
    res = execute(tiny.serve_cell(), SEED, 2.0, False, device="cpu")
    assert not res["correct"]
    assert res["compared"]["max_logit_gap"]["value"] > 0.05


def test_unchanged_cache_is_not_correct(monkeypatch):
    from ray_tpu_torch.models import gpt2_decode

    monkeypatch.setattr(gpt2_decode, "write_token_to_cache",
                        lambda cache, new, pos: None)
    res = execute(tiny.serve_cell(), SEED + 1, 2.0, False, device="cpu")
    assert not res["correct"]


def test_sound_run_is_correct():
    res = execute(tiny.serve_cell(), SEED + 2, 2.0, False, device="cpu")
    assert res["correct"]
