"""The port's scaling harness (``ray_tpu_torch.parallel.scaling_bench``),
the twin of tests/test_scaling_bench.py: the curve's structure and
retention accounting over worlds of 1, 2 and 4 gloo processes, and the
ring/Ulysses parity with the dense loss in a world of 4.  The JAX
harness's SP parity on the virtual devices is checked beside it: both
packages must find ring and Ulysses equal to dense."""

import pytest

from ray_tpu.parallel.scaling_bench import run_sp_parity as jrun_sp_parity
from ray_tpu_torch.parallel.scaling_bench import (
    run_scaling_curve,
    run_sp_parity,
)


def test_scaling_curve_structure(monkeypatch):
    from ray_tpu_torch.util import flight_recorder

    recorded = []
    monkeypatch.setattr(flight_recorder, "record_scaling_efficiency",
                        lambda *a: recorded.append(a))
    curve = run_scaling_curve((1, 2, 4), n_steps=2, seq_len=64,
                              device="cpu")
    # A CPU world's retention is not an interconnect figure.
    assert recorded == []
    assert [row["devices"] for row in curve] == [1, 2, 4]
    for row in curve:
        assert row["step_time_s"] > 0
        assert row["step_time_unpartitioned_s"] > 0
        assert row["tokens_per_sec_per_device"] > 0
        # Calibrated ratio (t_unpartitioned / t_partitioned), clipped at
        # 1.0; a measured value must land in a sane noisy band.
        assert 0 < row["retention"] <= 1.0
        ratio = row["step_time_unpartitioned_s"] / row["step_time_s"]
        assert row["retention"] == pytest.approx(min(ratio, 1.0), abs=1e-3)


def test_sp_parity_losses_match():
    parity = run_sp_parity(seq_len=64, device="cpu")
    assert parity["ring_matches_dense"], parity
    assert parity["ulysses_matches_dense"], parity
    assert set(parity["losses"]) == {"dense", "ring", "ulysses"}
    jparity = jrun_sp_parity(seq_len=64)
    assert set(jparity) == set(parity)
    assert jparity["ring_matches_dense"] and jparity["ulysses_matches_dense"]
    assert parity["losses"]["dense"] == pytest.approx(
        parity["losses"]["ring"], abs=1e-3)


def test_harness_runs_on_the_cards_unless_asked(monkeypatch):
    """Asked for no device, the harness takes the cards, as the JAX one
    takes the chips: with none it raises rather than timing CPU worlds,
    and counts beyond the cards are left out."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scaling_curve((1,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_sp_parity()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run_scaling_curve((1, 2)) == []
    assert run_sp_parity() == {"skipped": "needs >=2 devices"}
