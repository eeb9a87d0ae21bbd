"""Trial schedulers (reference: ray ``python/ray/tune/schedulers/`` —
FIFO, ASHA/async-hyperband, HyperBand brackets, median stopping, and
population-based training).

Protocol: ``on_result(trial_id, metrics, **info) -> "CONTINUE" | "STOP"``;
``info`` may carry ``config`` and ``checkpoint``.  A scheduler that clones
trials (PBT) also implements ``pop_clones() -> [(config, checkpoint)]``,
which the Tuner drains into new trials.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Tuple


class FIFOScheduler:
    def on_result(self, trial_id: str, metrics: Dict, **info) -> str:
        return "CONTINUE"


class ASHAScheduler:
    """Asynchronous Successive Halving: at each rung (grace_period ×
    reduction_factor^k iterations), stop trials not in the top 1/rf of
    completed rung results (ray ``tune/schedulers/async_hyperband.py``)."""

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: int = 4,
        time_attr: str = "training_iteration",
    ):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        # rung level -> list of recorded metric values
        self._rungs: Dict[int, List[float]] = {}
        r = grace_period
        self._rung_levels = []
        while r < max_t:
            self._rung_levels.append(r)
            r *= reduction_factor

    def on_result(self, trial_id: str, metrics: Dict, **info) -> str:
        t = metrics.get(self.time_attr)
        value = metrics.get(self.metric)
        if t is None or value is None:
            return "CONTINUE"
        if t >= self.max_t:
            return "STOP"
        for rung in reversed(self._rung_levels):
            if t == rung:
                recorded = self._rungs.setdefault(rung, [])
                recorded.append(float(value))
                if len(recorded) < self.rf:
                    return "CONTINUE"  # not enough peers to judge
                ordered = sorted(
                    recorded, reverse=(self.mode == "max")
                )
                cutoff_idx = max(0, len(ordered) // self.rf - 1)
                cutoff = ordered[cutoff_idx]
                good = (
                    value >= cutoff if self.mode == "max" else value <= cutoff
                )
                return "CONTINUE" if good else "STOP"
        return "CONTINUE"


class MedianStoppingRule:
    """Stop a trial whose best result so far is worse than the median of
    other trials' running averages at the same step (reference:
    ``tune/schedulers/median_stopping_rule.py``)."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 grace_period: int = 1,
                 time_attr: str = "training_iteration",
                 min_samples_required: int = 3):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.time_attr = time_attr
        self.min_samples = min_samples_required
        self._history: Dict[str, List[float]] = {}

    def on_result(self, trial_id: str, metrics: Dict, **info) -> str:
        t = metrics.get(self.time_attr)
        value = metrics.get(self.metric)
        if t is None or value is None:
            return "CONTINUE"
        self._history.setdefault(trial_id, []).append(float(value))
        if t < self.grace_period:
            return "CONTINUE"
        other_avgs = [
            sum(v) / len(v)
            for tid, v in self._history.items()
            if tid != trial_id and v
        ]
        if len(other_avgs) < self.min_samples:
            return "CONTINUE"
        other_avgs.sort()
        median = other_avgs[len(other_avgs) // 2]
        mine = self._history[trial_id]
        best = max(mine) if self.mode == "max" else min(mine)
        bad = best < median if self.mode == "max" else best > median
        return "STOP" if bad else "CONTINUE"


class HyperBandScheduler:
    """HyperBand as a set of ASHA brackets with staggered grace periods
    (reference: ``tune/schedulers/hyperband.py``; the async-bracket framing
    follows the ASHA paper's recommendation)."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 max_t: int = 81, reduction_factor: int = 3,
                 time_attr: str = "training_iteration"):
        self.brackets: List[ASHAScheduler] = []
        grace = 1
        while grace < max_t:
            self.brackets.append(
                ASHAScheduler(
                    metric=metric, mode=mode, max_t=max_t,
                    grace_period=grace, reduction_factor=reduction_factor,
                    time_attr=time_attr,
                )
            )
            grace *= reduction_factor
        self._assignment: Dict[str, int] = {}
        self._next = 0

    def on_result(self, trial_id: str, metrics: Dict, **info) -> str:
        idx = self._assignment.get(trial_id)
        if idx is None:
            idx = self._next % len(self.brackets)
            self._assignment[trial_id] = idx
            self._next += 1
        return self.brackets[idx].on_result(trial_id, metrics, **info)


class PopulationBasedTraining:
    """PBT (reference: ``tune/schedulers/pbt.py``): at each perturbation
    interval, trials in the bottom quantile stop and are replaced by clones
    of a top-quantile trial — config mutated, training state restored from
    the donor's last reported checkpoint."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 perturbation_interval: int = 4,
                 quantile_fraction: float = 0.25,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 time_attr: str = "training_iteration",
                 seed: int = 0):
        assert mode in ("min", "max")
        assert 0 < quantile_fraction <= 0.5
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.quantile = quantile_fraction
        self.mutations = hyperparam_mutations or {}
        self.time_attr = time_attr
        self._rng = random.Random(seed)
        # trial_id -> {"score", "config", "checkpoint"}
        self._state: Dict[str, dict] = {}
        self._clones: List[Tuple[dict, Any]] = []
        self.num_perturbations = 0

    def _mutate(self, config: dict) -> dict:
        out = dict(config)
        for key, spec in self.mutations.items():
            if callable(getattr(spec, "sample", None)):
                out[key] = spec.sample(self._rng)
            elif isinstance(spec, (list, tuple)):
                out[key] = self._rng.choice(list(spec))
            elif callable(spec):
                out[key] = spec()
            elif isinstance(out.get(key), (int, float)):
                # resample-by-perturbation: ×0.8 or ×1.2 (reference default)
                factor = self._rng.choice([0.8, 1.2])
                val = out[key] * factor
                if isinstance(out[key], int):
                    # round, and force at least ±1 so small ints (1, 2)
                    # don't truncate to 0 or get stuck forever
                    val = round(val)
                    if val == out[key]:
                        val = out[key] + (1 if factor > 1 else -1)
                    out[key] = max(1, int(val))
                else:
                    out[key] = float(val)
        return out

    def on_result(self, trial_id: str, metrics: Dict, **info) -> str:
        t = metrics.get(self.time_attr)
        value = metrics.get(self.metric)
        if value is None:
            return "CONTINUE"
        self._state[trial_id] = {
            "score": float(value),
            "config": info.get("config", {}),
            "checkpoint": info.get("checkpoint"),
        }
        if info.get("terminal"):
            # Trial is ending via stop criteria: its score stays as a donor
            # comparator, but it must never be exploited (a clone per
            # finished trial would keep the experiment alive forever).
            return "CONTINUE"
        if t is None or t % self.interval != 0:
            return "CONTINUE"
        scores = sorted(
            (s["score"] for s in self._state.values()),
            reverse=(self.mode == "max"),
        )
        if len(scores) < 3:
            return "CONTINUE"
        k = max(1, int(len(scores) * self.quantile))
        top_cut, bottom_cut = scores[k - 1], scores[-k]
        mine = self._state[trial_id]["score"]
        in_bottom = (
            mine <= bottom_cut if self.mode == "max" else mine >= bottom_cut
        )
        if not in_bottom:
            return "CONTINUE"
        donors = [
            s for s in self._state.values()
            if (s["score"] >= top_cut if self.mode == "max"
                else s["score"] <= top_cut)
        ]
        if not donors:
            return "CONTINUE"
        donor = self._rng.choice(donors)
        self._clones.append(
            (self._mutate(donor["config"]), donor["checkpoint"])
        )
        self.num_perturbations += 1
        self._state.pop(trial_id, None)
        return "STOP"

    def pop_clones(self) -> List[Tuple[dict, Any]]:
        clones, self._clones = self._clones, []
        return clones


class PB2(PopulationBasedTraining):
    """Population Based Bandits (reference: ``tune/schedulers/pb2.py``,
    Parker-Holder et al. 2020): PBT where the explore step picks new
    hyperparameters by maximizing a GP-UCB acquisition fit on observed
    (config, score-improvement) data, instead of random perturbation.
    The GP is a small native numpy RBF-kernel regressor over configs
    normalized into [0,1]^d by ``hyperparam_bounds``.
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 perturbation_interval: int = 4,
                 quantile_fraction: float = 0.25,
                 hyperparam_bounds: Optional[Dict[str, Tuple[float, float]]] = None,
                 ucb_kappa: float = 1.5,
                 n_candidates: int = 64,
                 seed: int = 0):
        super().__init__(
            metric=metric, mode=mode,
            perturbation_interval=perturbation_interval,
            quantile_fraction=quantile_fraction,
            hyperparam_mutations=None, seed=seed,
        )
        if not hyperparam_bounds:
            raise ValueError("PB2 requires hyperparam_bounds={key: (lo, hi)}")
        self.bounds = dict(hyperparam_bounds)
        self.kappa = ucb_kappa
        self.n_candidates = n_candidates
        # Observations: (normalized config vector, score improvement).
        self._gp_x: List[List[float]] = []
        self._gp_y: List[float] = []
        self._last_score: Dict[str, float] = {}

    # ----------------------------------------------------------------- data
    def _norm(self, config: dict) -> List[float]:
        out = []
        for k, (lo, hi) in self.bounds.items():
            v = float(config.get(k, lo))
            out.append((v - lo) / max(hi - lo, 1e-12))
        return out

    def on_result(self, trial_id: str, metrics: Dict, **info) -> str:
        value = metrics.get(self.metric)
        if value is not None:
            prev = self._last_score.get(trial_id)
            if prev is not None:
                delta = float(value) - prev
                if self.mode == "min":
                    delta = -delta  # improvement = decrease
                self._gp_x.append(self._norm(info.get("config", {})))
                self._gp_y.append(delta)
            self._last_score[trial_id] = float(value)
        return super().on_result(trial_id, metrics, **info)

    # -------------------------------------------------------------- explore
    def _mutate(self, config: dict) -> dict:
        """GP-UCB over the bounded keys (the PB2 explore step)."""
        import numpy as np

        out = dict(config)
        if len(self._gp_y) < 3:
            for k, (lo, hi) in self.bounds.items():
                out[k] = lo + self._rng.random() * (hi - lo)
            return out
        X = np.asarray(self._gp_x[-64:], dtype=float)
        y = np.asarray(self._gp_y[-64:], dtype=float)
        y_std = y.std() or 1.0
        yn = (y - y.mean()) / y_std
        ell, noise = 0.2, 1e-3
        def rbf(A, B):
            d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / (ell * ell))
        K = rbf(X, X) + noise * np.eye(len(X))
        Kinv_y = np.linalg.solve(K, yn)
        cands = np.asarray(
            [
                [self._rng.random() for _ in self.bounds]
                for _ in range(self.n_candidates)
            ]
        )
        Ks = rbf(cands, X)
        mu = Ks @ Kinv_y
        var = np.maximum(
            1.0 - np.einsum("ij,jk,ik->i", Ks, np.linalg.inv(K), Ks), 1e-9
        )
        ucb = mu + self.kappa * np.sqrt(var)
        best = cands[int(np.argmax(ucb))]
        for i, (k, (lo, hi)) in enumerate(self.bounds.items()):
            val = lo + float(best[i]) * (hi - lo)
            if isinstance(config.get(k), int):
                val = int(round(val))
            out[k] = val
        return out
