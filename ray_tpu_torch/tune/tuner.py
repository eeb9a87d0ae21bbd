"""Tuner — trial orchestration loop.

Reference architecture (ray ``python/ray/tune/tuner.py:43`` +
``tune/execution/tune_controller.py:68``): an event loop manages trials as
remote actors, consuming search-algorithm variants, feeding results to the
scheduler (ASHA early stopping), bounded by max_concurrent_trials.  Trials
here are actors running the trainable function with a session that queues
``report`` results (same session machinery as Train, which is how the
reference layers Train-on-Tune).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.serialization import dumps_function, loads_function

from .schedulers import FIFOScheduler
from .search import generate_variants


@dataclasses.dataclass
class TuneConfig:
    num_samples: int = 1
    max_concurrent_trials: int = 2
    metric: str = "loss"
    mode: str = "min"
    scheduler: Any = None
    # Sequential model-based searcher (e.g. TPESearcher); when set,
    # configs are suggested lazily as capacity frees and completed results
    # feed the model (reference: tune.search.Searcher protocol).
    search_alg: Any = None
    seed: Optional[int] = None
    # Stop criteria applied to every trial's metrics, e.g.
    # {"training_iteration": 20} (reference: RunConfig(stop=...)).
    stop: Optional[Dict[str, float]] = None


@dataclasses.dataclass
class TrialResult:
    trial_id: str
    config: Dict[str, Any]
    metrics: Dict[str, Any]
    metrics_history: List[Dict[str, Any]]
    error: Optional[str] = None
    stopped_early: bool = False


class ResultGrid:
    def __init__(self, results: List[TrialResult], metric: str, mode: str):
        self.results = results
        self._metric = metric
        self._mode = mode

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        scored = [
            r for r in self.results
            if r.error is None and metric in (r.metrics or {})
        ]
        if not scored:
            raise ValueError("no successful trials with the target metric")
        return (max if mode == "max" else min)(
            scored, key=lambda r: r.metrics[metric]
        )

    def __len__(self):
        return len(self.results)


@ray_tpu_torch.remote
class _TrialActor:
    """Runs one trial; queues reported metrics for the controller."""

    def __init__(self, trial_id: str):
        self.trial_id = trial_id
        self._lock = threading.Lock()
        self._queue: List[Dict[str, Any]] = []
        self._stop = False

    def run(self, fn_payload: bytes, config: Dict[str, Any],
            start_checkpoint=None, stop_criteria=None):
        from ray_tpu_torch.train.session import TrainContext, _clear_session, _set_session

        fn = loads_function(fn_payload)
        iteration = [0]

        ctx = TrainContext(
            world_rank=0, world_size=1, local_rank=0, node_rank=0,
            trial_name=self.trial_id, _report_fn=None,
            latest_checkpoint=start_checkpoint,
        )

        def report_fn(metrics, checkpoint):
            iteration[0] += 1
            metrics = dict(metrics)
            metrics.setdefault("training_iteration", iteration[0])
            if checkpoint is not None:
                ctx.latest_checkpoint = checkpoint
            with self._lock:
                self._queue.append((metrics, checkpoint))
            # Stop criteria apply synchronously (a fast trainable would
            # otherwise race past the controller's asynchronous poll).
            if _met_stop_criteria(metrics, stop_criteria):
                raise _EarlyStop()
            if self._stop:
                raise _EarlyStop()

        ctx._report_fn = report_fn
        _set_session(ctx)
        try:
            fn(config)
            return {"ok": True, "stopped": False}
        except _EarlyStop:
            return {"ok": True, "stopped": True}
        finally:
            _clear_session()

    def poll(self):
        with self._lock:
            q, self._queue = self._queue, []
            return q

    def request_stop(self):
        self._stop = True
        return True


class _EarlyStop(BaseException):
    pass


def _met_stop_criteria(metrics: Dict[str, Any],
                       stop: Optional[Dict[str, float]]) -> bool:
    return bool(stop) and any(
        metrics.get(k) is not None and metrics[k] >= v
        for k, v in stop.items()
    )


def _all_subclasses(cls):
    for sub in cls.__subclasses__():
        yield sub
        yield from _all_subclasses(sub)


def _as_function_trainable(trainable):
    """Accept both function trainables (``fn(config)``) and class
    trainables exposing the Algorithm lifecycle (``setup/train/stop`` —
    e.g. an rllib Algorithm class or AlgorithmConfig).  Class trainables
    wrap into a report loop (reference: class Trainable adaptation)."""
    from ..rllib.algorithm import Algorithm, AlgorithmConfig

    if isinstance(trainable, type) and issubclass(trainable, Algorithm):
        algo_cls = trainable

        def run_algo(config):
            from ray_tpu_torch.train import session as train_session

            cfg_cls = None
            for sub in _all_subclasses(AlgorithmConfig):
                if sub.ALGO_CLS is algo_cls:
                    cfg_cls = sub
                    break
            algo_cfg = (cfg_cls or AlgorithmConfig)()
            if config:
                algo_cfg.training(**config)
            algo = algo_cls(algo_cfg)
            try:
                while True:
                    result = algo.train()
                    train_session.report(result)
            finally:
                algo.stop()

        return run_algo
    if not callable(trainable):
        raise TypeError(f"trainable must be callable, got {trainable!r}")
    return trainable


class Tuner:
    def __init__(
        self,
        trainable: Callable[[Dict[str, Any]], None],
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
    ):
        self.trainable = _as_function_trainable(trainable)
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()

    def fit(self) -> ResultGrid:
        from ray_tpu_torch.core.usage import record_library_usage

        record_library_usage("tune")
        cfg = self.tune_config
        scheduler = cfg.scheduler or FIFOScheduler()
        searcher = cfg.search_alg
        payload = dumps_function(self.trainable)
        if searcher is None:
            variants = generate_variants(
                self.param_space, cfg.num_samples, cfg.seed
            )
            pending = [
                (f"trial_{i:04d}", variant, None)
                for i, variant in enumerate(variants)
            ]
            to_suggest = 0
            next_trial = len(pending)
        else:
            pending = []
            to_suggest = cfg.num_samples
            next_trial = cfg.num_samples
        running: Dict[str, dict] = {}
        results: List[TrialResult] = []

        while pending or running or to_suggest > 0:
            while (
                searcher is not None
                and to_suggest > 0
                and len(pending) + len(running) < cfg.max_concurrent_trials
            ):
                tid = f"trial_{cfg.num_samples - to_suggest:04d}"
                to_suggest -= 1
                pending.append((tid, searcher.suggest(tid), None))
            while pending and len(running) < cfg.max_concurrent_trials:
                trial_id, variant, start_ckpt = pending.pop(0)
                # max_concurrency: poll()/request_stop() must stay responsive
                # while run() executes the trainable.
                actor = _TrialActor.options(max_concurrency=4).remote(trial_id)
                running[trial_id] = {
                    "actor": actor,
                    "config": variant,
                    "ref": actor.run.remote(
                        payload, variant, start_ckpt, cfg.stop
                    ),
                    "history": [],
                    "stopped": False,
                }
            time.sleep(0.05)
            for trial_id, st in list(running.items()):
                for metrics, checkpoint in ray_tpu_torch.get(
                    st["actor"].poll.remote(), timeout=60
                ):
                    st["history"].append(metrics)
                    terminal = _met_stop_criteria(metrics, cfg.stop)
                    decision = scheduler.on_result(
                        trial_id, metrics,
                        config=st["config"], checkpoint=checkpoint,
                        terminal=terminal,
                    )
                    if decision != "STOP" and terminal:
                        decision = "STOP"
                    if decision == "STOP" and not st["stopped"]:
                        st["stopped"] = True
                        st["actor"].request_stop.remote()
                ready, _ = ray_tpu_torch.wait([st["ref"]], timeout=0)
                if ready:
                    error = None
                    stopped = st["stopped"]
                    try:
                        out = ray_tpu_torch.get(st["ref"], timeout=10)
                        stopped = stopped or out.get("stopped", False)
                    except Exception as e:  # noqa: BLE001
                        error = str(e)
                    # Final drain after completion — a fast trial may have
                    # reported everything before the first poll, so these
                    # results must still reach the scheduler (PBT clone
                    # decisions depend on them).
                    try:
                        for metrics, ckpt in ray_tpu_torch.get(
                            st["actor"].poll.remote(), timeout=30
                        ):
                            st["history"].append(metrics)
                            scheduler.on_result(
                                trial_id, metrics,
                                config=st["config"], checkpoint=ckpt,
                                terminal=_met_stop_criteria(
                                    metrics, cfg.stop
                                ),
                            )
                    except Exception:
                        pass
                    if searcher is not None:
                        final = dict(st["history"][-1]) if st["history"] else {}
                        if error is not None:
                            final["error"] = True
                        # Always fires (even for crashed/report-less trials)
                        # so the searcher's live-trial table cannot leak.
                        searcher.on_trial_complete(trial_id, final)
                    results.append(
                        TrialResult(
                            trial_id=trial_id,
                            config=st["config"],
                            metrics=st["history"][-1] if st["history"] else {},
                            metrics_history=st["history"],
                            error=error,
                            stopped_early=stopped,
                        )
                    )
                    try:
                        ray_tpu_torch.kill(st["actor"])
                    except Exception:
                        pass
                    del running[trial_id]
            # PBT-style clones: enqueue replacements for exploited trials
            # (checked after draining so end-of-trial decisions count).
            if hasattr(scheduler, "pop_clones"):
                for clone_cfg, clone_ckpt in scheduler.pop_clones():
                    pending.append(
                        (f"trial_{next_trial:04d}", clone_cfg, clone_ckpt)
                    )
                    next_trial += 1
        return ResultGrid(results, cfg.metric, cfg.mode)
