"""Tree-structured Parzen Estimator search — the native model-based
searcher.

Reference surface: ray ``python/ray/tune/search/`` wraps external
model-based searchers (optuna/hyperopt — both TPE at their core); here the
algorithm is implemented natively so the framework has a self-contained
model-based option (round-1 gap: grid/random only).

Classic TPE (Bergstra et al., NeurIPS 2011): keep all observed
(config, score) pairs; split them into the best ``gamma`` fraction l(x)
and the rest g(x); model each hyperparameter dimension with a 1-D Parzen
(kernel density) estimator per split; sample candidates from l and pick
the one maximizing l(x)/g(x).  Continuous domains use gaussian kernels
(log-space for ``loguniform``), integers round, categoricals use smoothed
frequency weights.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

from .search import _Domain, choice, loguniform, randint, uniform


class Searcher:
    """Sequential suggestion interface (reference: tune.search.Searcher)."""

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, metrics: Dict[str, Any]):
        raise NotImplementedError


class TPESearcher(Searcher):
    def __init__(
        self,
        space: Dict[str, Any],
        metric: str = "loss",
        mode: str = "min",
        n_startup_trials: int = 8,
        gamma: float = 0.25,
        n_candidates: int = 24,
        seed: Optional[int] = None,
    ):
        for k, v in space.items():
            if isinstance(v, _Domain) and not isinstance(
                v, (uniform, loguniform, randint, choice)
            ):
                raise ValueError(f"unsupported domain for TPE: {k}={v!r}")
        self.space = space
        self.metric = metric
        self.mode = mode
        self.n_startup = n_startup_trials
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._live: Dict[str, Dict[str, Any]] = {}
        self._obs: List[Tuple[Dict[str, Any], float]] = []

    # ------------------------------------------------------------- protocol
    def suggest(self, trial_id: str) -> Dict[str, Any]:
        if len(self._obs) < self.n_startup:
            config = self._sample_random()
        else:
            config = self._sample_tpe()
        self._live[trial_id] = config
        return config

    def on_trial_complete(self, trial_id: str, metrics: Dict[str, Any]):
        config = self._live.pop(trial_id, None)
        if config is None or self.metric not in metrics:
            return
        score = float(metrics[self.metric])
        if self.mode == "max":
            score = -score
        self._obs.append((config, score))

    # ------------------------------------------------------------- sampling
    def _sample_random(self) -> Dict[str, Any]:
        out = {}
        for k, dom in self.space.items():
            out[k] = dom.sample(self.rng) if isinstance(dom, _Domain) else dom
        return out

    def _split(self):
        ranked = sorted(self._obs, key=lambda o: o[1])
        n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
        return ranked[:n_good], ranked[n_good:]

    def _sample_tpe(self) -> Dict[str, Any]:
        good, bad = self._split()
        best_cfg, best_ratio = None, -math.inf
        for _ in range(self.n_candidates):
            cfg, log_l, log_g = {}, 0.0, 0.0
            for key, dom in self.space.items():
                if not isinstance(dom, _Domain):
                    cfg[key] = dom
                    continue
                val, ll, lg = self._sample_dim(key, dom, good, bad)
                cfg[key] = val
                log_l += ll
                log_g += lg
            ratio = log_l - log_g
            if ratio > best_ratio:
                best_cfg, best_ratio = cfg, ratio
        return best_cfg or self._sample_random()

    # One dimension: draw from the good-split KDE, return the value and its
    # log-density under both splits.
    def _sample_dim(self, key, dom, good, bad):
        if isinstance(dom, choice):
            weights_g = self._cat_weights(key, dom, good)
            val = self.rng.choices(dom.values, weights=weights_g)[0]
            idx = dom.values.index(val)
            weights_b = self._cat_weights(key, dom, bad)
            return (
                val,
                math.log(weights_g[idx] / sum(weights_g)),
                math.log(weights_b[idx] / sum(weights_b)),
            )
        lo, hi, to_x, from_x = self._bounds(dom)
        xs_g = [to_x(c[key]) for c, _ in good]
        xs_b = [to_x(c[key]) for c, _ in bad]
        sigma = max((hi - lo) / max(2, len(xs_g)), 1e-12)
        center = self.rng.choice(xs_g) if xs_g else self.rng.uniform(lo, hi)
        x = min(max(self.rng.gauss(center, sigma), lo), hi)
        val = from_x(x)
        if isinstance(dom, randint):
            val = int(min(max(round(val), dom.low), dom.high - 1))
            x = float(val)
        return (
            val,
            self._kde_logpdf(x, xs_g, sigma, lo, hi),
            self._kde_logpdf(x, xs_b, sigma, lo, hi),
        )

    def _cat_weights(self, key, dom, split):
        counts = [1.0] * len(dom.values)  # +1 smoothing
        for cfg, _ in split:
            try:
                counts[dom.values.index(cfg[key])] += 1.0
            except (ValueError, KeyError):
                pass
        return counts

    @staticmethod
    def _bounds(dom):
        if isinstance(dom, loguniform):
            return (
                math.log(dom.low), math.log(dom.high), math.log, math.exp,
            )
        if isinstance(dom, randint):
            return float(dom.low), float(dom.high - 1), float, float
        return dom.low, dom.high, float, float

    @staticmethod
    def _kde_logpdf(x, xs, sigma, lo, hi):
        # Mixture of gaussians around observations + one uniform component
        # (keeps densities positive everywhere, the TPE prior smoothing).
        span = max(hi - lo, 1e-12)
        parts = [1.0 / span]
        for c in xs:
            z = (x - c) / sigma
            parts.append(
                math.exp(-0.5 * z * z) / (sigma * math.sqrt(2 * math.pi))
            )
        return math.log(sum(parts) / len(parts))
