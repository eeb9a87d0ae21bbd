"""The port's Tune against the JAX package's, on the CPU.

The search space's variants, ``TPESearcher``, ASHA, HyperBand, the median
rule, PBT and PB2 run the cases of ``tests/test_tune_schedulers.py``,
``tests/test_tune_tpe_pb2.py`` and ``tests/test_data_tune.py``'s Tune
class on the same seeds through ``ray_tpu.tune`` and
``ray_tpu_torch.tune``: the same configs, the same decisions, clones and
suggestions.  The ``Tuner`` programs (best pick, ASHA, stop criteria, PBT
with checkpoint clones, a TPE search and a class trainable, an
``Algorithm`` subclass) run in one cluster per package, the JAX one shut
down before the port's starts, and give the same best trial, metrics and
trial counts.  ``mlp_forward`` on parameters carried from JAX equals the
JAX one within 1e-6.
"""

import math
import random

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.rllib.algorithm as jalgo
import ray_tpu.tune as jtune
import ray_tpu_torch
import ray_tpu_torch.rllib as trllib
import ray_tpu_torch.tune as ttune

def _objective_value(x, y):
    return (x - 0.3) ** 2 + (y - 0.7) ** 2


# ------------------------------------------- offline: searchers, schedulers
def case_variants(tune):
    space = {"a": tune.grid_search([1, 2]), "b": tune.choice([5, 6, 7]),
             "c": tune.uniform(0, 1), "d": tune.loguniform(1e-4, 1e-1),
             "e": tune.randint(0, 100), "f": "fixed"}
    from_grid = tune.search.generate_variants(
        {"a": tune.grid_search([1, 2]), "b": tune.choice([5])}, 3)
    return tune.search.generate_variants(space, 3, seed=5), from_grid


def case_tpe_moves_toward_optimum(tune):
    tpe = tune.TPESearcher({"x": tune.uniform(0, 1), "y": tune.uniform(0, 1)},
                           metric="loss", mode="min", n_startup_trials=8,
                           seed=7)
    scores = []
    for i in range(48):
        cfg = tpe.suggest(f"t{i}")
        scores.append(_objective_value(cfg["x"], cfg["y"]))
        tpe.on_trial_complete(f"t{i}", {"loss": scores[-1]})
    return scores


def case_tpe_beats_random(tune):
    tpe = tune.TPESearcher({"x": tune.uniform(0, 1), "y": tune.uniform(0, 1)},
                           metric="loss", mode="min", n_startup_trials=8,
                           seed=3)
    best = float("inf")
    for i in range(40):
        cfg = tpe.suggest(f"t{i}")
        loss = _objective_value(cfg["x"], cfg["y"])
        best = min(best, loss)
        tpe.on_trial_complete(f"t{i}", {"loss": loss})
    rng = random.Random(3)
    rand = min(_objective_value(rng.uniform(0, 1), rng.uniform(0, 1))
               for _ in range(40))
    return best, rand


def case_tpe_categorical_and_log(tune):
    tpe = tune.TPESearcher({"lr": tune.loguniform(1e-5, 1e-1),
                            "act": tune.choice(["relu", "gelu", "tanh"])},
                           metric="loss", mode="min", n_startup_trials=4,
                           seed=0)
    for i in range(30):
        cfg = tpe.suggest(f"t{i}")
        loss = (math.log10(cfg["lr"]) + 3) ** 2 + (
            0.0 if cfg["act"] == "gelu" else 1.0)
        tpe.on_trial_complete(f"t{i}", {"loss": loss})
    return [tpe.suggest(f"p{i}") for i in range(8)]


def case_median_stopping(tune):
    rule = tune.MedianStoppingRule(metric="score", mode="max", grace_period=2)
    out = [rule.on_result(tid, {"score": v, "training_iteration": t})
           for t in (1, 2, 3) for tid, v in (("a", 10), ("b", 9), ("c", 11))]
    return out + [rule.on_result("d", {"score": 1, "training_iteration": t})
                  for t in (1, 2)]


def case_hyperband(tune):
    hb = tune.HyperBandScheduler(metric="loss", mode="min", max_t=9,
                                 reduction_factor=3)
    out = [hb.on_result(t, {"loss": 1.0 + i, "training_iteration": it})
           for it in (1, 3, 9) for i, t in enumerate(("t0", "t1", "t2"))]
    return len(hb.brackets), dict(hb._assignment), out


def case_asha(tune):
    asha = tune.ASHAScheduler(metric="loss", mode="min", max_t=8,
                              grace_period=2, reduction_factor=2)
    return [asha.on_result(f"q{q}", {"loss": q / step,
                                     "training_iteration": step})
            for step in range(1, 9) for q in (1.0, 10.0, 20.0, 30.0)]


def case_pbt_exploit(tune):
    pbt = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        quantile_fraction=0.34, hyperparam_mutations={"lr": [0.1, 0.01]})
    out = [pbt.on_result(tid, {"score": s, "training_iteration": 2},
                         config={"lr": lr}, checkpoint=ck)
           for tid, s, lr, ck in (("good", 10, 1.0, {"w": "good"}),
                                  ("mid", 5, 0.5, None),
                                  ("bad", 1, 0.001, None))]
    return out, pbt.pop_clones(), pbt.num_perturbations


def case_pbt_off_interval(tune):
    pbt = tune.PopulationBasedTraining(metric="score", mode="max",
                                       perturbation_interval=4)
    out = [pbt.on_result(tid, {"score": v, "training_iteration": 3},
                         config={})
           for tid, v in (("a", 10), ("b", 5), ("c", 1))]
    return out, pbt.pop_clones()


def case_pb2_requires_bounds(tune):
    try:
        tune.PB2(metric="score", mode="max")
    except ValueError as e:
        return type(e).__name__
    return None


def case_pb2_explores_and_clones(tune):
    pb2 = tune.PB2(metric="score", mode="max", perturbation_interval=1,
                   quantile_fraction=0.34,
                   hyperparam_bounds={"lr": (0.001, 0.1)}, seed=0)
    out = [pb2.on_result(tid, {"score": score * step,
                               "training_iteration": step},
                         config={"lr": lr}, checkpoint=f"ck-{tid}-{step}",
                         terminal=False)
           for step in (1, 2)
           for tid, lr, score in (("a", 0.05, 1.0), ("b", 0.02, 0.8),
                                  ("c", 0.001, 0.1))]
    return out, pb2.pop_clones()


def case_pb2_gp_explore(tune):
    pb2 = tune.PB2(metric="score", mode="max", perturbation_interval=1,
                   hyperparam_bounds={"lr": (0.0, 1.0)}, seed=2)
    for lr in (0.1, 0.3, 0.5, 0.7, 0.9):
        pb2._gp_x.append([lr])
        pb2._gp_y.append(lr)
    return pb2._mutate({"lr": 0.2})


CASES = {f.__name__[len("case_"):]: f for f in (
    case_variants, case_tpe_moves_toward_optimum, case_tpe_beats_random,
    case_tpe_categorical_and_log, case_median_stopping, case_hyperband,
    case_asha, case_pbt_exploit, case_pbt_off_interval,
    case_pb2_requires_bounds, case_pb2_explores_and_clones,
    case_pb2_gp_explore)}


def _check(name, out):
    """What the JAX package's tests assert of each case."""
    if name == "variants":
        variants, from_grid = out
        assert len(variants) == 6 and len(from_grid) == 6
        assert all(v["b"] == 5 for v in from_grid)
    elif name == "tpe_moves_toward_optimum":
        assert sum(out[-16:]) / 16 < sum(out[:8]) / 8 * 0.6
    elif name == "tpe_beats_random":
        assert out[0] <= out[1]
    elif name == "tpe_categorical_and_log":
        assert sum(c["act"] == "gelu" for c in out) / len(out) >= 0.5
    elif name == "median_stopping":
        assert out == ["CONTINUE"] * 10 + ["STOP"]
    elif name == "hyperband":
        n, assignment, decisions = out
        assert n == 2 and assignment == {"t0": 0, "t1": 1, "t2": 0}
        assert decisions[-3:] == ["STOP"] * 3
    elif name == "asha":
        assert "STOP" in out
    elif name == "pbt_exploit":
        decisions, clones, n = out
        assert decisions == ["CONTINUE", "CONTINUE", "STOP"] and n == 1
        assert len(clones) == 1 and clones[0][1] == {"w": "good"}
        assert clones[0][0]["lr"] in (0.1, 0.01)
    elif name == "pbt_off_interval":
        assert out == (["CONTINUE"] * 3, [])
    elif name == "pb2_requires_bounds":
        assert out == "ValueError"
    elif name == "pb2_explores_and_clones":
        clones = out[1]
        assert clones and all(0.001 <= c["lr"] <= 0.1 and k.startswith("ck-")
                              for c, k in clones)
    elif name == "pb2_gp_explore":
        assert out["lr"] > 0.5


@pytest.mark.parametrize("name", sorted(CASES))
def test_offline_case_matches_jax(name):
    got, want = CASES[name](ttune), CASES[name](jtune)
    assert got == want, (got, want)
    _check(name, got)


# ------------------------------------------------ the Tuner, in a cluster
def prog_tuner_picks_best(rt, tune, rllib):
    pkg = rt.__name__

    def trainable(config):
        import importlib

        train = importlib.import_module(pkg + ".train")
        train.report({"loss": (config["x"] - 3) ** 2})

    grid = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([0, 1, 3, 7])},
        tune_config=tune.TuneConfig(num_samples=1, metric="loss", mode="min",
                                    max_concurrent_trials=2)).fit()
    best = grid.get_best_result()
    return {"n": len(grid), "best_x": best.config["x"],
            "best_loss": best.metrics["loss"],
            "losses": sorted(r.metrics["loss"] for r in grid.results)}


def prog_asha_stops_bad_trials(rt, tune, rllib):
    pkg = rt.__name__

    def trainable(config):
        import importlib

        train = importlib.import_module(pkg + ".train")
        for step in range(1, 9):
            train.report({"loss": config["quality"] / step,
                          "training_iteration": step})

    sched = tune.ASHAScheduler(metric="loss", mode="min", max_t=8,
                               grace_period=2, reduction_factor=2)
    grid = tune.Tuner(
        trainable,
        param_space={"quality": tune.grid_search([1.0, 10.0, 20.0, 30.0])},
        tune_config=tune.TuneConfig(num_samples=1, metric="loss", mode="min",
                                    scheduler=sched,
                                    max_concurrent_trials=4)).fit()
    best = grid.get_best_result()
    return {"n": len(grid), "best_quality": best.config["quality"],
            "any_stopped": any(r.stopped_early for r in grid.results)}


def prog_stop_criteria(rt, tune, rllib):
    pkg = rt.__name__

    def trainable(config):
        import importlib

        train = importlib.import_module(pkg + ".train")
        for i in range(100):
            train.report({"loss": 1.0 / (i + 1)})

    grid = tune.Tuner(
        trainable, param_space={},
        tune_config=tune.TuneConfig(num_samples=1,
                                    stop={"training_iteration": 5})).fit()
    best = grid.get_best_result()
    return {"within": best.metrics["training_iteration"] <= 6,
            "stopped_early": best.stopped_early}


def prog_pbt_clone_restores_checkpoint(rt, tune, rllib):
    pkg = rt.__name__

    def trainable(config):
        import importlib
        import time as _time

        train = importlib.import_module(pkg + ".train")
        Queue = importlib.import_module(pkg + ".util.queue").Queue
        barrier = Queue(name="pbt_test_barrier", get_if_exists=True)
        barrier.put(1)
        deadline = _time.monotonic() + 60
        while barrier.qsize() < 3 and _time.monotonic() < deadline:
            _time.sleep(0.05)
        ckpt = train.get_checkpoint()
        start = ckpt["step"] if ckpt else 0
        for i in range(start, start + 12):
            _time.sleep(0.1)
            train.report({"score": config["base"] + i},
                         checkpoint={"step": i + 1})

    pbt = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=3,
        quantile_fraction=0.34, hyperparam_mutations={"base": [50, 60]})
    grid = tune.Tuner(
        trainable,
        param_space={"base": tune.grid_search([0, 20, 40])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=pbt, max_concurrent_trials=3,
                                    stop={"training_iteration": 12})).fit()
    return {"perturbed": pbt.num_perturbations >= 1,
            "cloned": len(grid.results) >= 4,
            "best_at_least_40": grid.get_best_result().metrics["score"] >= 40}


def prog_tpe_end_to_end(rt, tune, rllib):
    pkg = rt.__name__

    def trainable(config):
        import importlib

        train = importlib.import_module(pkg + ".train")
        train.report({"loss": (config["x"] - 0.5) ** 2})

    searcher = tune.TPESearcher({"x": tune.uniform(0, 1)}, metric="loss", mode="min",
                                n_startup_trials=3, seed=1)
    grid = tune.Tuner(
        trainable,
        tune_config=tune.TuneConfig(num_samples=8, max_concurrent_trials=2,
                                    metric="loss", mode="min",
                                    search_alg=searcher)).fit()
    return {"n": len(grid),
            "good": grid.get_best_result().metrics["loss"] < 0.1}


def prog_class_trainable(rt, tune, rllib):
    class Approach(rllib.Algorithm):
        """Steps x toward 3 by ``lr`` of the gap; reports the squared gap."""

        def setup(self, config):
            self.x, self.lr = 0.0, config.lr

        def training_step(self):
            self.x += self.lr * (3.0 - self.x)
            return {"loss": (3.0 - self.x) ** 2}

    grid = tune.Tuner(
        Approach, param_space={"lr": tune.grid_search([0.1, 0.5])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    stop={"training_iteration": 3})).fit()
    best = grid.get_best_result()
    return {"n": len(grid), "best_lr": best.config["lr"],
            "best_history": [m["loss"] for m in best.metrics_history],
            "iterations": sorted(r.metrics["training_iteration"]
                                 for r in grid.results)}


PROGRAMS = {f.__name__[len("prog_"):]: f for f in (
    prog_tuner_picks_best, prog_asha_stops_bad_trials, prog_stop_criteria,
    prog_pbt_clone_restores_checkpoint, prog_tpe_end_to_end,
    prog_class_trainable)}

EXPECTED = {  # what the JAX package's tests assert
    "tuner_picks_best": {"n": 4, "best_x": 3, "best_loss": 0,
                         "losses": [0, 4, 9, 16]},
    "asha_stops_bad_trials": {"n": 4, "best_quality": 1.0,
                              "any_stopped": True},
    "stop_criteria": {"within": True, "stopped_early": True},
    "pbt_clone_restores_checkpoint": {"perturbed": True, "cloned": True,
                                      "best_at_least_40": True},
    "tpe_end_to_end": {"n": 8, "good": True},
}


def _run_all(rt, tune, rllib):
    return {name: prog(rt, tune, rllib) for name, prog in PROGRAMS.items()}


@pytest.fixture(scope="module")
def jax_results():
    import ray_tpu.rllib.algorithm as rllib

    ray_tpu.init(num_cpus=8)
    try:
        return _run_all(ray_tpu, jtune, rllib)
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def port_results(jax_results):
    ray_tpu_torch.init(num_cpus=8)
    try:
        yield _run_all(ray_tpu_torch, ttune, trllib)
    finally:
        ray_tpu_torch.shutdown()


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_tuner_program_matches_jax(name, jax_results, port_results):
    assert port_results[name] == jax_results[name], (
        port_results[name], jax_results[name])
    if name in EXPECTED:
        assert port_results[name] == EXPECTED[name], port_results[name]


def test_class_trainable_reports_each_iteration(port_results):
    got = port_results["class_trainable"]
    assert got["n"] == 2 and got["best_lr"] == 0.5
    assert got["iterations"] == [3, 3]
    assert got["best_history"] == [(3.0 * 0.5 ** k) ** 2 for k in (1, 2, 3)]


# ------------------------------------------------------------- the MLP
@pytest.mark.parametrize("sizes", [(4, 32, 2), (8, 64, 64, 3)])
def test_mlp_forward_matches_jax(sizes):
    jparams = jalgo.init_mlp(jax.random.PRNGKey(0), sizes)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    x = np.random.default_rng(1).standard_normal((16, sizes[0])).astype(
        np.float32)
    want = np.asarray(jalgo.mlp_forward(jparams, x, len(sizes) - 1))
    got = trllib.mlp_forward(tparams, torch.from_numpy(x), len(sizes) - 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np_twin = trllib.mlp_forward_np({k: np.array(v) for k, v in
                                     jparams.items()}, x, len(sizes) - 1)
    np.testing.assert_allclose(np_twin, want, rtol=1e-6, atol=1e-6)


def test_init_mlp_draws_from_its_generator():
    sizes = (4, 32, 2)
    a = trllib.init_mlp(torch.Generator().manual_seed(3), sizes)
    b = trllib.init_mlp(torch.Generator().manual_seed(3), sizes)
    assert sorted(a) == ["b0", "b1", "w0", "w1"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["w0"].shape == (4, 32) and a["b1"].dtype == torch.float32
    # He scale on the hidden layer, a near-zero head.
    assert 0.3 < float(a["w0"].std()) < 1.1
    assert float(a["w1"].abs().max()) < 0.1
