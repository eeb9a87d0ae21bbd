"""Anakin — vectorized envs + learner together on the card.

Podracer (arxiv 2104.06272) §2: when the environment itself is written
in tensor ops, the entire rollout+learn cycle runs on the accelerator —
a loop of T vectorized env/policy steps, then the update, repeated U
times a ``training_step``, replicated over devices with gradients
averaged over the replicas.  Parameters, optimizer state, env states,
observations and trajectories NEVER leave the device inside a
``training_step``: the loops are Python loops over tensors that never
read a value back (no ``.item()``, no ``.cpu()``), so the host only
enqueues work, and the step's summary comes back in one transfer at its
end.  Against the host-loop IMPALA (Python envs in runner actors, one
RPC round per rollout) ``bench_rl`` measures the ratio in one
interleaved window.

The loss is IMPALA's V-trace (``rllib.impala.make_vtrace_loss``) over
the env axis; on-policy the importance ratios are exactly 1, so it
reduces to n-step actor-critic — but the SAME code path serves both, and
the same trained policy can later be served by Sebulba runners.

Devices: ``AnakinConfig.num_devices`` replicas over a device list — the
first cards (``device=None``, 0 = every card) or that many replicas of a
named device (``device="cpu"``: CPU replicas, as the tests run it).
Each replica steps its own envs from its own generator; the mean of the
replicas' losses is the global mean (every replica has E envs), so its
gradient is the ``pmean`` of theirs, and one Adam step updates the
params, held on the first device.  ``anakin_actor`` wraps a trainer in
a remote actor leasing a card (``num_gpus``) or pinned to a
``PodracerPlacement`` bundle, so the placement-group scheduler
arbitrates chip sharing cluster-wide.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ..algorithm import Algorithm, AlgorithmConfig
from ..impala import make_vtrace_loss

import ray_tpu_torch


class AnakinConfig(AlgorithmConfig):
    """Fluent config for the Anakin trainer.

    ``environment()`` takes a *torch env instance* (``CartPoleTorch``-style
    functional ``reset``/``step`` with auto-reset), not a maker — the env
    is stepped inside the trainer's loop, not instantiated per actor.
    """

    def __init__(self):
        super().__init__()
        self.torch_env: Optional[Any] = None
        self.num_envs_per_device = 64
        self.unroll_length = 16
        self.updates_per_step = 32  # updates per training_step
        self.num_devices = 0  # 0 = every card (1 replica of a named device)
        self.device = None  # None = the cards; "cpu" = CPU replicas
        self.hidden = 32
        self.lr = 3e-3
        self.entropy_coeff = 0.01
        self.value_coeff = 0.5
        self.vtrace_clip_rho = 1.0
        self.vtrace_clip_c = 1.0

    def environment(self, env) -> "AnakinConfig":  # type: ignore[override]
        self.torch_env = env
        return self


def replica_devices(device, num_devices: int) -> List[Any]:
    """The replicas' devices: the first ``num_devices`` cards (0 = all;
    more than there are raises), or ``num_devices`` replicas (at least
    one) of the device the caller named."""
    import torch

    from ray_tpu_torch.device import resolve_device

    if device is None:
        resolve_device(None)  # raises without a card
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        if num_devices:
            if num_devices > len(cards):
                raise ValueError(
                    f"num_devices={num_devices} > {len(cards)} local devices"
                )
            cards = cards[:num_devices]
        return cards
    return [resolve_device(device)] * max(1, num_devices)


class Anakin(Algorithm):
    """On-card trainer: U updates of T vectorized env steps a
    ``training_step``, with one host transfer (the summary)."""

    def setup(self, config: AnakinConfig) -> None:
        from ..algorithm import Adam, seeded_generator
        from ..env import CartPoleTorch
        from ..ppo import _init_policy

        env = (config.torch_env if config.torch_env is not None
               else CartPoleTorch())
        if not hasattr(env, "num_actions"):
            raise ValueError(
                "Anakin needs a discrete-action torch env (num_actions); "
                f"got {type(env).__name__}"
            )
        self.env = env
        self.devices = replica_devices(config.device, config.num_devices)
        D = len(self.devices)
        E = config.num_envs_per_device
        T = config.unroll_length
        U = config.updates_per_step
        self._shape = (D, E, T, U)

        self.params = _init_policy(
            seeded_generator(self.devices[0], config.seed),
            env.observation_size, env.num_actions, config.hidden,
        )
        self.tx = Adam(config.lr)
        self.opt_state = self.tx.init(self.params)
        self._loss_fn = make_vtrace_loss(
            gamma=config.gamma,
            rho_bar=config.vtrace_clip_rho,
            c_bar=config.vtrace_clip_c,
            value_coeff=config.value_coeff,
            entropy_coeff=config.entropy_coeff,
        )
        # Each replica: its own generator, envs and current observations.
        self._gens = [seeded_generator(d, config.seed, 1, r)
                      for r, d in enumerate(self.devices)]
        self._env_state, self._obs = [], []
        for d, g in zip(self.devices, self._gens):
            state, obs = env.reset(g, E, d)
            self._env_state.append(state)
            self._obs.append(obs)
        self.total_env_steps = 0
        self.total_updates = 0

    # ------------------------------------------------------------- the loop
    def _rollout(self, r: int, params) -> Dict[str, Any]:
        """T env steps of replica ``r``'s E envs under ``params`` (no
        grad): the (E, T, ...) trajectory batch the loss takes."""
        import torch

        from ..ppo import _policy_forward
        from ..rl_module import action_logp, categorical

        T = self._shape[2]
        gen, state, obs = self._gens[r], self._env_state[r], self._obs[r]
        cols = {k: [] for k in ("obs", "actions", "rewards", "dones",
                                "logp_old")}
        for _ in range(T):
            logits, _ = _policy_forward(params, obs)
            actions = categorical(gen, logits)
            cols["obs"].append(obs)
            cols["actions"].append(actions)
            cols["logp_old"].append(action_logp(logits, actions))
            state, obs, rew, done = self.env.step(gen, state, actions)
            cols["rewards"].append(rew)
            cols["dones"].append(done.float())
        self._env_state[r], self._obs[r] = state, obs
        _, last_values = _policy_forward(params, obs)
        batch = {k: torch.stack(v, 1) for k, v in cols.items()}
        batch["last_value"] = last_values
        return batch

    def _one_update(self):
        """Rollouts on every replica, then one step on the mean of their
        losses; returns replica 0's (loss, reward mean, done rate) as
        device tensors."""
        import torch

        from ..algorithm import value_and_grad

        D = len(self.devices)
        with torch.no_grad():
            local = [{k: v.to(d) for k, v in self.params.items()}
                     for d in self.devices]
            batches = [self._rollout(r, local[r]) for r in range(D)]

        def mean_loss(p, batches):
            losses = [self._loss_fn({k: v.to(d) for k, v in p.items()},
                                    b)[0]
                      for d, b in zip(self.devices, batches)]
            return sum(loss.to(self.devices[0]) for loss in losses) / D, \
                losses[0].detach()

        _, loss0, grads = value_and_grad(mean_loss, self.params, batches)
        self.params, self.opt_state = self.tx.step(
            self.params, grads, self.opt_state)
        b0 = batches[0]
        return torch.stack([loss0, b0["rewards"].mean(),
                            b0["dones"].mean()])

    # ------------------------------------------------------------ lifecycle
    def training_step(self) -> Dict[str, Any]:
        import torch

        from ray_tpu_torch.util import flight_recorder

        D, E, T, U = self._shape
        t0 = time.perf_counter()
        metrics = torch.stack([self._one_update() for _ in range(U)])
        # Mean over the chunk; the last update's loss is kept separately
        # as the freshest learning signal.  The one host transfer.
        loss_last, loss_mean, reward_mean, done_rate = torch.stack([
            metrics[-1, 0], metrics[:, 0].mean(), metrics[:, 1].mean(),
            metrics[:, 2].mean()]).cpu().tolist()
        summary = {"loss": loss_last, "loss_mean": loss_mean,
                   "reward_mean": reward_mean, "done_rate": done_rate}
        dt = time.perf_counter() - t0
        env_steps = D * E * T * U
        self.total_env_steps += env_steps
        self.total_updates += U
        flight_recorder.record_rl_rollout("anakin", env_steps, dt, devices=D)
        flight_recorder.record_rl_update("anakin", n=U)
        return {
            "num_env_steps_sampled": env_steps,
            "env_steps_per_s": env_steps / max(dt, 1e-9),
            "num_learner_updates": U,
            "episode_len_mean": 1.0 / max(done_rate, 1e-6),
            "num_devices": D,
            "total_env_steps": self.total_env_steps,
            **summary,
        }

    def evaluate(self, num_envs: int = 16, seed: int = 0) -> float:
        """Mean greedy first-episode return of the current policy over
        ``num_envs`` fresh envs, stepped on the first device."""
        import torch

        from ..algorithm import seeded_generator
        from ..ppo import _policy_forward

        env, device = self.env, self.devices[0]
        max_steps = int(getattr(env, "max_steps", 200))
        gen = seeded_generator(device, seed)
        with torch.no_grad():
            state, obs = env.reset(gen, num_envs, device)
            alive = torch.ones(num_envs, device=device)
            ret = torch.zeros(num_envs, device=device)
            for _ in range(max_steps):
                logits, _ = _policy_forward(self.params, obs)
                actions = torch.argmax(logits, -1)
                state, obs, rew, done = env.step(gen, state, actions)
                ret = ret + rew * alive
                alive = alive * (1.0 - done.float())
            return float(ret.mean())

    def resize(self, num_devices: int) -> Dict[str, Any]:
        """Elastic world-size change: re-form the replicas over
        ``num_devices`` devices without losing learning progress.

        Params come off the device (``get_state``), the trainer is rebuilt
        for the new device set (``setup``), and the params go back bit for
        bit (``set_state`` — the optimizer state re-initializes, the same
        policy as a restore-from-checkpoint crossover).  Step counters
        survive the rebuild; per-replica batch shape is unchanged, so the
        GLOBAL batch scales with the replica count — callers accounting
        for lr/batch coupling read ``num_devices`` out of the returned
        dict."""
        from ray_tpu_torch.util import flight_recorder

        old = len(self.devices)
        if num_devices == old:
            return {"num_devices": old, "previous": old}
        state = self.get_state()
        steps, updates = self.total_env_steps, self.total_updates
        self.config.num_devices = num_devices
        self.setup(self.config)
        self.set_state(state)
        self.total_env_steps, self.total_updates = steps, updates
        flight_recorder.record_elastic_resize(
            "grow" if num_devices > old else "shrink"
        )
        return {"num_devices": len(self.devices), "previous": old}

    def get_state(self) -> Dict[str, Any]:
        from ..algorithm import to_numpy

        return {"params": to_numpy(self.params)}

    def set_state(self, state: Dict[str, Any]) -> None:
        from ..algorithm import to_tensors

        self.params = to_tensors(state["params"], self.devices[0])
        self.opt_state = self.tx.init(self.params)


AnakinConfig.ALGO_CLS = Anakin


# ------------------------------------------------- placement composition
@ray_tpu_torch.remote
class AnakinWorker:
    """An Anakin trainer wrapped in an actor so the scheduler decides which
    card it may bind — the chip-sharing story: several Anakin jobs (or
    Anakin next to serving) each lease a card share (``num_gpus``) or pin
    to a ``PodracerPlacement`` actor bundle (``chips_per_actor``) and see
    only their share (``CUDA_VISIBLE_DEVICES``)."""

    def __init__(self, config: AnakinConfig):
        self.algo = Anakin(config)

    def train(self) -> Dict[str, Any]:
        return self.algo.train()

    def evaluate(self, num_envs: int = 16, seed: int = 0) -> float:
        return self.algo.evaluate(num_envs, seed)

    def get_state(self) -> Dict[str, Any]:
        return self.algo.get_state()

    def set_state(self, state: Dict[str, Any]) -> None:
        self.algo.set_state(state)

    def resize(self, num_devices: int) -> Dict[str, Any]:
        return self.algo.resize(num_devices)

    def prepare_evict(self) -> bytes:
        """Checkpoint-then-evict hook: pickle the learner state so the
        runtime parks it in the cluster KV (namespace ``eviction``)
        before this trainer's bundle is reclaimed — a preempted Anakin
        job resumes from here bit-identical (docs/scheduling.md)."""
        import pickle

        return pickle.dumps(self.get_state())


def anakin_actor(config: AnakinConfig, scheduling_strategy=None,
                 **actor_options):
    """Spawn an ``AnakinWorker`` (optionally pinned to a placement-group
    bundle via ``scheduling_strategy=placement.actor_strategy(i)``, or
    leasing a card share with ``num_gpus=...``)."""
    opts = dict(actor_options)
    if scheduling_strategy is not None:
        opts["scheduling_strategy"] = scheduling_strategy
    if opts:
        return AnakinWorker.options(**opts).remote(config)
    return AnakinWorker.remote(config)
