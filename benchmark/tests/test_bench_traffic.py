"""The one generator: the same seed gives the same work, every seed the
same sizes in another order, inside the mix's declared ranges."""

import collections

import numpy as np
import pytest

from benchmark import harness, traffic

MIXES = ["serve-decode", "serve-prefill"]
BIG_SEED = 2 ** 31 + 987654321


def _mix(name):
    return harness.load_json(harness.HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_serving_requests_repeat_for_a_seed(name):
    mix = _mix(name)
    a = traffic.serving_requests(mix, BIG_SEED, 30)
    b = traffic.serving_requests(mix, BIG_SEED, 30)
    assert a == b
    c = traffic.serving_requests(mix, BIG_SEED + 1, 30)
    assert [r["prompt"] for r in a] != [r["prompt"] for r in c]


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_offers_the_same_sizes(name):
    mix = _mix(name)
    a = traffic.serving_requests(mix, 7, 30)
    b = traffic.serving_requests(mix, BIG_SEED, 30)

    def sizes(reqs):
        return collections.Counter((r["prompt_tokens"], r["max_tokens"])
                                   for r in reqs)

    assert sizes(a) != collections.Counter() and len(a) == len(b)
    assert sorted(r["prompt_tokens"] for r in a) == sorted(
        r["prompt_tokens"] for r in b)
    assert sorted(r["max_tokens"] for r in a) == sorted(
        r["max_tokens"] for r in b)
    assert [r["due_s"] for r in a] == [r["due_s"] for r in b]
    assert [r["max_tokens"] for r in a] != [r["max_tokens"] for r in b]


@pytest.mark.parametrize("name", MIXES)
def test_sizes_inside_the_declared_ranges(name):
    mix = _mix(name)
    reqs = traffic.serving_requests(mix, 3, 30)
    p, o = mix["prompt_tokens"], mix["output_tokens"]
    for r in reqs:
        assert p["min"] <= r["prompt_tokens"] <= p["max"]
        assert o["min"] <= r["max_tokens"] <= o["max"]
        assert len(r["prompt"]) == r["prompt_tokens"] - 1
        assert all(32 <= ord(ch) < 127 for ch in r["prompt"])
        # The engine stops a request at max_seq_len - 1 cached tokens.
        assert (r["prompt_tokens"] + r["max_tokens"]
                <= mix["engine"]["max_seq_len"] - 1)
    due = [r["due_s"] for r in reqs]
    assert due == sorted(due) and due[-1] > 30
    mean = len([d for d in due if d < 30]) / 30
    assert 0.6 * mix["rate_per_s"] < mean < 1.4 * mix["rate_per_s"]
    lengths = np.array([r["prompt_tokens"] for r in reqs])
    if p["dist"] == "lognormal":
        assert abs(np.median(lengths) / p["median"] - 1) < 0.15


def test_prompts_are_unique():
    for name in MIXES:
        reqs = traffic.serving_requests(_mix(name), 11, 30)
        assert len({r["prompt"] for r in reqs}) == len(reqs)


def test_warmup_spans_the_prompt_range():
    mix = _mix("serve-prefill")
    w = traffic.warmup_requests(mix, 5)
    n = [r["prompt_tokens"] for r in w]
    assert min(n) == mix["prompt_tokens"]["min"]
    assert max(n) == mix["prompt_tokens"]["max"]
