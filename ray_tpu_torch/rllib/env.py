"""Built-in environments (gym-API compatible, zero external deps).

The RL workload for BASELINE.md north-star config #3 is PPO; CartPole is the
standard smoke env.  Implemented in numpy with the classic dynamics so tests
run anywhere.

Two families live here:

- ``CartPole`` / ``Pendulum`` — stateful numpy envs for host-side
  env-runner actors (PPO/IMPALA/Sebulba samplers; no torch import).
- ``CartPoleTorch`` / ``PendulumTorch`` — functional twins on tensors
  with identical dynamics, batched over a leading env axis: ``reset``
  and ``step`` are functions of (generator, state) whose every random
  draw comes from the ``torch.Generator`` passed in, on the state's
  device.  These are what the Anakin trainer steps *on the card*: a
  batch of env instances inside its rollout+learn loop (Podracer, arxiv
  2104.06272).  ``step`` auto-resets: the returned state/obs belong to a
  fresh episode wherever ``done`` is True, while ``reward``/``done``
  always describe the transition that just happened (the standard
  gymnax/Anakin convention — a bootstrap value of the post-reset obs is
  harmless because the loss discounts through ``done``).
"""

from __future__ import annotations

import numpy as np


class CartPole:
    """Classic cart-pole balancing; observation (4,), actions {0, 1}."""

    observation_size = 4
    num_actions = 2

    def __init__(self, seed: int = 0, max_steps: int = 200):
        self.rng = np.random.default_rng(seed)
        self.max_steps = max_steps
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.length = 0.5
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold = 12 * 2 * np.pi / 360
        self.x_threshold = 2.4
        self.state = None
        self.steps = 0

    def reset(self):
        self.state = self.rng.uniform(-0.05, 0.05, size=4).astype(np.float32)
        self.steps = 0
        return self.state.copy()

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        total_mass = self.masspole + self.masscart
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array([x, x_dot, theta, theta_dot], np.float32)
        self.steps += 1
        done = bool(
            abs(x) > self.x_threshold
            or abs(theta) > self.theta_threshold
            or self.steps >= self.max_steps
        )
        return self.state.copy(), 1.0, done, {}


class Pendulum:
    """Classic pendulum swing-up — the continuous-control smoke env
    (observation (3,), one action in [-2, 2])."""

    observation_size = 3
    action_size = 1
    action_low = -2.0
    action_high = 2.0

    def __init__(self, seed: int = 0, max_steps: int = 200):
        self.rng = np.random.default_rng(seed)
        self.max_steps = max_steps
        self.g, self.m, self.l, self.dt = 10.0, 1.0, 1.0, 0.05
        self.state = None
        self.steps = 0

    def _obs(self):
        th, thdot = self.state
        return np.array([np.cos(th), np.sin(th), thdot], np.float32)

    def reset(self):
        self.state = np.array(
            [self.rng.uniform(-np.pi, np.pi), self.rng.uniform(-1.0, 1.0)]
        )
        self.steps = 0
        return self._obs()

    def step(self, action):
        th, thdot = self.state
        u = float(np.clip(np.asarray(action).reshape(-1)[0], -2.0, 2.0))
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = thdot + (
            3 * self.g / (2 * self.l) * np.sin(th)
            + 3.0 / (self.m * self.l ** 2) * u
        ) * self.dt
        thdot = float(np.clip(thdot, -8.0, 8.0))
        th = th + thdot * self.dt
        self.state = np.array([th, thdot])
        self.steps += 1
        done = self.steps >= self.max_steps
        return self._obs(), -cost, done, {}


# ------------------------------------------------------------- torch twins
def _uniform(generator, shape, device, low: float, high: float):
    import torch

    u = torch.rand(shape, generator=generator, device=device)
    return low + (high - low) * u


class CartPoleTorch:
    """Functional CartPole on tensors with auto-reset, batched over envs.

    State is ``{"phys": (E, 4) f32, "steps": (E,) i32}``; ``reset`` and
    ``step`` are pure functions of (generator, state), so a rollout is a
    loop of tensor ops that never syncs with the host.  Dynamics are the
    numpy ``CartPole``'s, verbatim — parity is pinned in
    tests/test_torch_rllib_envs.py.
    """

    observation_size = 4
    num_actions = 2

    def __init__(self, max_steps: int = 200):
        self.max_steps = max_steps
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.length = 0.5
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold = 12 * 2 * np.pi / 360
        self.x_threshold = 2.4

    def reset(self, generator, num_envs: int, device=None):
        import torch

        device = generator.device if device is None else device
        phys = _uniform(generator, (num_envs, 4), device, -0.05, 0.05)
        state = {"phys": phys,
                 "steps": torch.zeros(num_envs, dtype=torch.int32,
                                      device=device)}
        return state, phys

    def obs(self, state):
        return state["phys"]

    def step(self, generator, state, actions):
        import torch

        phys = state["phys"]
        x, x_dot, theta, theta_dot = phys.unbind(-1)
        force = torch.where(actions == 1, self.force_mag, -self.force_mag)
        costheta, sintheta = torch.cos(theta), torch.sin(theta)
        total_mass = self.masspole + self.masscart
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        phys = torch.stack([x, x_dot, theta, theta_dot], -1).float()
        steps = state["steps"] + 1
        done = (
            (torch.abs(x) > self.x_threshold)
            | (torch.abs(theta) > self.theta_threshold)
            | (steps >= self.max_steps)
        )
        # The reset noise of every env is drawn, and kept where done.
        reset_state, _ = self.reset(generator, phys.shape[0], phys.device)
        new_state = {
            "phys": torch.where(done[:, None], reset_state["phys"], phys),
            "steps": torch.where(done, reset_state["steps"], steps),
        }
        reward = torch.ones_like(x)
        return new_state, new_state["phys"], reward, done


class PendulumTorch:
    """Functional Pendulum swing-up on tensors with auto-reset, batched
    over envs.

    State ``{"phys": (E, 2) f32 (theta, theta_dot), "steps": (E,) i32}``;
    continuous actions (``(E,)`` or ``(E, 1)``) clipped to [-2, 2];
    episodes truncate at ``max_steps`` (the only ``done`` source,
    matching the numpy env).
    """

    observation_size = 3
    action_size = 1
    action_low = -2.0
    action_high = 2.0

    def __init__(self, max_steps: int = 200):
        self.max_steps = max_steps
        self.g, self.m, self.l, self.dt = 10.0, 1.0, 1.0, 0.05

    def reset(self, generator, num_envs: int, device=None):
        import torch

        device = generator.device if device is None else device
        th = _uniform(generator, (num_envs,), device, -np.pi, np.pi)
        thdot = _uniform(generator, (num_envs,), device, -1.0, 1.0)
        state = {
            "phys": torch.stack([th, thdot], -1),
            "steps": torch.zeros(num_envs, dtype=torch.int32,
                                 device=device),
        }
        return state, self.obs(state)

    def obs(self, state):
        import torch

        th, thdot = state["phys"].unbind(-1)
        return torch.stack([torch.cos(th), torch.sin(th), thdot], -1)

    def step(self, generator, state, actions):
        import torch

        th, thdot = state["phys"].unbind(-1)
        u = torch.clamp(actions.reshape(th.shape[0], -1)[:, 0], -2.0, 2.0)
        norm_th = torch.remainder(th + np.pi, 2 * np.pi) - np.pi
        cost = norm_th**2 + 0.1 * thdot**2 + 0.001 * u**2
        thdot = thdot + (
            3 * self.g / (2 * self.l) * torch.sin(th)
            + 3.0 / (self.m * self.l**2) * u
        ) * self.dt
        thdot = torch.clamp(thdot, -8.0, 8.0)
        th = th + thdot * self.dt
        steps = state["steps"] + 1
        done = steps >= self.max_steps
        reset_state, _ = self.reset(generator, th.shape[0], th.device)
        phys = torch.stack([th, thdot], -1).float()
        new_state = {
            "phys": torch.where(done[:, None], reset_state["phys"], phys),
            "steps": torch.where(done, reset_state["steps"], steps),
        }
        return new_state, self.obs(new_state), -cost, done
