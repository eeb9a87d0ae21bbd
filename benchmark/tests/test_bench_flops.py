"""Operation and byte counts against shapes worked by hand."""

import pytest

from benchmark import flops


def test_flash_forward_cost():
    c = flops.flash_fwd_cost(8, 1024, 16, 64)
    assert c["flops"] == 4 * 8 * 16 * 64 * (1024 * 1025 // 2)
    assert c["bytes"] == 4 * 8 * 1024 * 16 * 64 * 2 + 8 * 16 * 1024 * 4
    # PERF.md's bound at this shape: 0.0202 ms, by bytes.
    assert flops.bound_s(c) * 1e3 == pytest.approx(0.0202, abs=1e-4)


@pytest.mark.parametrize("prompt,n_out", [(1, 1), (5, 2), (128, 320),
                                          (256, 767)])
def test_decode_live_positions_by_counting(prompt, n_out):
    want = sum(prompt + j for j in range(1, n_out))
    assert flops.decode_live_positions(prompt, n_out) == want


def test_decode_bytes_and_serve_flops():
    live = flops.decode_live_positions(100, 3)  # 101 + 102
    b = flops.decode_attention_bytes(live, 2, 36, 20, 64)
    assert b == 36 * (2 * 203 * 20 * 64 * 2 + 2 * 2 * 20 * 64 * 2)
    f = flops.serve_flops(36, 20, 1280, 50304, prompt_tokens=100,
                          prefills=1, decode_tokens=2,
                          prefill_pairs=100 * 101 // 2,
                          decode_positions=live)
    blocks, unembed = 36 * 12 * 1280 ** 2, 50304 * 1280
    assert f == (2 * blocks * 100 + 2 * unembed + 2 * (blocks + unembed) * 2
                 + 4 * 64 * 20 * 36 * (5050 + 203))
