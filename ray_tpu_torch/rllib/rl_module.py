"""RLModule — the model abstraction of the learner stack.

Reference: ray ``rllib/core/rl_module/rl_module.py`` (+
``multi_rl_module.py``): one object owns the neural nets and exposes three
forward passes — inference (greedy/deterministic), exploration (sampling),
train (everything the loss needs) — so algorithms, env runners, and
learners share a single model definition.

Here an RLModule is a *stateless* bundle of functions over an explicit
params tree (nested dicts of tensors), so every forward runs on whatever
device its params live on and params ship to env-runner actors as plain
numpy arrays — no module pickling, no ``nn.Module`` wrappers.  Every
random draw comes from a ``torch.Generator`` the caller passes, on the
params' device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np


@dataclasses.dataclass
class RLModuleSpec:
    """Builds an RLModule (reference ``RLModuleSpec.build``)."""

    module_class: type
    model_config: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def build(self, obs_size: int, action_size: int) -> "RLModule":
        return self.module_class(obs_size, action_size, **self.model_config)


class RLModule:
    """Pure-function model bundle.  Subclasses define the architecture."""

    def __init__(self, obs_size: int, action_size: int, **model_config):
        self.obs_size = obs_size
        self.action_size = action_size
        self.model_config = model_config

    # -- params ------------------------------------------------------------
    def init_state(self, generator) -> Dict[str, Any]:
        """Params drawn from ``generator``, on its device."""
        raise NotImplementedError

    # -- forwards (pure) ----------------------------------------------------
    def forward_inference(self, params, batch) -> Dict[str, Any]:
        """Deterministic outputs for serving/eval."""
        raise NotImplementedError

    def forward_exploration(self, params, batch, generator) -> Dict[str, Any]:
        """Sampling outputs for env runners."""
        raise NotImplementedError

    def forward_train(self, params, batch) -> Dict[str, Any]:
        """Everything the loss needs (logits, values, q-values, …)."""
        raise NotImplementedError


def _mlp_init(generator, sizes, out_scale=0.01):
    import torch

    device = generator.device
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        scale = (2.0 / fan_in) ** 0.5 if i < len(sizes) - 2 else out_scale
        params[f"w{i}"] = torch.randn(
            (fan_in, fan_out), generator=generator, device=device) * scale
        params[f"b{i}"] = torch.zeros(fan_out, device=device)
    return params


def _as_input(x, like):
    """Observations given as numpy (as env runners and tests pass them)
    become f32 tensors on the params' device."""
    import torch

    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, np.float32), device=like.device)


def _mlp_apply(params, x, n_layers, activation="tanh"):
    import torch

    act = {"tanh": torch.tanh, "relu": torch.relu}[activation]
    x = _as_input(x, params["w0"])
    for i in range(n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            x = act(x)
    return x


def categorical(generator, logits):
    """One draw per row of ``logits`` (``jax.random.categorical``'s
    Gumbel-max): a single ``torch.rand`` from ``generator``, no host sync."""
    import torch

    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def action_logp(logits, actions):
    """log pi(actions) under categorical ``logits`` (last axis)."""
    import torch

    logp_all = torch.log_softmax(logits, -1)
    return torch.gather(logp_all, -1, actions.long()[..., None])[..., 0]


class DiscretePolicyModule(RLModule):
    """Categorical policy + value head over a shared MLP torso (the default
    module shape PPO/IMPALA-style algorithms consume)."""

    def init_state(self, generator):
        hidden = self.model_config.get("hidden", 64)
        return {
            "pi": _mlp_init(generator,
                            [self.obs_size, hidden, self.action_size]),
            "vf": _mlp_init(generator, [self.obs_size, hidden, 1],
                            out_scale=1.0),
        }

    def _heads(self, params, obs):
        logits = _mlp_apply(params["pi"], obs, 2)
        value = _mlp_apply(params["vf"], obs, 2)[..., 0]
        return logits, value

    def forward_inference(self, params, batch):
        import torch

        logits, value = self._heads(params, batch["obs"])
        return {"actions": torch.argmax(logits, -1), "logits": logits,
                "vf_preds": value}

    def forward_exploration(self, params, batch, generator):
        logits, value = self._heads(params, batch["obs"])
        actions = categorical(generator, logits)
        return {"actions": actions, "logits": logits, "vf_preds": value,
                "action_logp": action_logp(logits, actions)}

    def forward_train(self, params, batch):
        logits, value = self._heads(params, batch["obs"])
        return {"logits": logits, "vf_preds": value}


class SACModule(RLModule):
    """Tanh-squashed gaussian policy + twin Q networks (reference
    ``rllib/algorithms/sac/``'s default RLModule)."""

    LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0

    def init_state(self, generator):
        hidden = self.model_config.get("hidden", 64)
        qin = self.obs_size + self.action_size
        return {
            "pi": _mlp_init(
                generator,
                [self.obs_size, hidden, hidden, 2 * self.action_size]
            ),
            "q1": _mlp_init(generator, [qin, hidden, hidden, 1],
                            out_scale=1.0),
            "q2": _mlp_init(generator, [qin, hidden, hidden, 1],
                            out_scale=1.0),
        }

    def _pi(self, params, obs):
        import torch

        out = _mlp_apply(params["pi"], obs, 3, activation="relu")
        mean, log_std = torch.chunk(out, 2, dim=-1)
        log_std = torch.clamp(log_std, self.LOG_STD_MIN, self.LOG_STD_MAX)
        return mean, log_std

    def sample_action(self, params, obs, generator=None, eps=None):
        """Reparameterized tanh-gaussian sample with squash-corrected
        log-prob.  The standard normal noise ``eps`` is drawn from
        ``generator`` unless it is passed in (parity tests pass the JAX
        package's draw)."""
        import torch

        mean, log_std = self._pi(params, obs)
        std = torch.exp(log_std)
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator,
                              device=mean.device)
        pre = mean + std * eps
        action = torch.tanh(pre)
        logp = (
            -0.5 * (eps ** 2 + 2 * log_std + np.log(2 * np.pi))
        ).sum(-1)
        # tanh change-of-variables correction
        logp = logp - torch.log(1 - action ** 2 + 1e-6).sum(-1)
        return action, logp

    def q_values(self, params, obs, actions):
        import torch

        obs = _as_input(obs, params["q1"]["w0"])
        actions = _as_input(actions, params["q1"]["w0"])
        x = torch.cat([obs, actions], dim=-1)
        q1 = _mlp_apply(params["q1"], x, 3, activation="relu")[..., 0]
        q2 = _mlp_apply(params["q2"], x, 3, activation="relu")[..., 0]
        return q1, q2

    def forward_inference(self, params, batch):
        import torch

        mean, _ = self._pi(params, batch["obs"])
        return {"actions": torch.tanh(mean)}

    def forward_exploration(self, params, batch, generator):
        actions, logp = self.sample_action(params, batch["obs"], generator)
        return {"actions": actions, "action_logp": logp}

    def forward_train(self, params, batch):
        q1, q2 = self.q_values(params, batch["obs"], batch["actions"])
        return {"q1": q1, "q2": q2}


class MultiRLModule:
    """module_id -> RLModule (+ per-module params) — the multi-agent
    surface (reference ``multi_rl_module.py``)."""

    def __init__(self, modules: Dict[str, RLModule]):
        self.modules = dict(modules)

    def init_state(self, generator):
        """Each module's params in sorted-id order, drawn in turn from
        ``generator``."""
        return {
            mid: m.init_state(generator)
            for mid, m in sorted(self.modules.items())
        }

    def __getitem__(self, module_id: str) -> RLModule:
        return self.modules[module_id]

    def keys(self):
        return self.modules.keys()
