"""DreamerV3 — model-based RL: learn a world model, act in imagination.

Reference: ray ``rllib/algorithms/dreamerv3/`` (TF implementation of
Hafner et al. 2023), and the JAX package's ``rllib/dreamerv3.py``, whose
design this keeps: the world model, the imagination rollout and both
updates run on the learner's device (``resolve_device(config.device)``,
the card unless the config names another) — the loops over time are
Python loops of tensor ops that never read a value back, so the imagined
trajectories never leave the device — while env runners stay CPU actors
with a numpy forward (same split as every other algorithm here).

Faithful pieces: RSSM with categorical latents (straight-through
gradients), KL balancing with free bits (beta_dyn/beta_rep), symlog
observation/reward regression, continue head, lambda-return targets, and
return-normalized actor advantages.  Documented simplifications vs the
paper: MLP encoder/decoder only (vector observations), MSE-on-symlog
instead of two-hot distributional heads, REINFORCE gradients for both
discrete and continuous actors, and a plain ring sequence buffer.

Random draws: every function that draws takes its noise as an optional
argument (``gumbel`` for a categorical latent or a discrete action, the
Gaussian ``eps`` of a continuous action), else draws it from the
``torch.Generator`` it is given.  ``jax.random.categorical(key, logits)``
is ``argmax(logits + gumbel(key, logits.shape))``, so the same Gumbel
noise picks the same indices in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

import ray_tpu_torch

from .algorithm import Algorithm, AlgorithmConfig


# ------------------------------------------------------------------ helpers
def symlog(x):
    import torch

    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    import torch

    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def _mlp_init(generator, sizes, scale_last=1.0):
    import torch

    device = generator.device
    params = []
    for i, (fi, fo) in enumerate(zip(sizes[:-1], sizes[1:])):
        s = scale_last if i == len(sizes) - 2 else (2.0 / fi) ** 0.5
        params.append({
            "w": torch.randn((fi, fo), generator=generator,
                             device=device) * s,
            "b": torch.zeros(fo, dtype=torch.float32, device=device),
        })
    return params


def _mlp(params, x):
    import torch

    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.where(x > 0, x, 0.01 * x)  # leaky relu
    return x


def _gru_init(generator, in_size, hidden):
    import torch

    device = generator.device
    s = (1.0 / (in_size + hidden)) ** 0.5
    return {
        "wi": torch.randn((in_size, 3 * hidden), generator=generator,
                          device=device) * s,
        "wh": torch.randn((hidden, 3 * hidden), generator=generator,
                          device=device) * s,
        "b": torch.zeros(3 * hidden, dtype=torch.float32, device=device),
    }


def _gru(params, h, x):
    import torch

    gates = x @ params["wi"] + h @ params["wh"] + params["b"]
    r, u, c = torch.chunk(gates, 3, dim=-1)
    r, u = torch.sigmoid(r), torch.sigmoid(u)
    c = torch.tanh(r * c)
    return u * h + (1 - u) * c


def gumbel(shape, generator):
    """Standard Gumbel noise drawn from ``generator`` on its device, as
    ``jax.random.gumbel`` makes it: ``-log(-log(u))``, u uniform in
    [tiny, 1)."""
    import torch

    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@dataclasses.dataclass
class _Hyper:
    deter: int = 64          # GRU state size
    stoch: int = 8           # categorical latent variables
    classes: int = 8         # classes per latent
    hidden: int = 64
    seq_len: int = 16
    batch_size: int = 8
    horizon: int = 8         # imagination length
    gamma: float = 0.985
    lam: float = 0.95
    free_bits: float = 1.0
    beta_dyn: float = 0.5
    beta_rep: float = 0.1
    entropy: float = 3e-3
    wm_lr: float = 3e-3
    ac_lr: float = 1e-3
    buffer_capacity: int = 20_000
    min_buffer: int = 512
    train_ratio: int = 4     # WM/AC updates per train() call
    num_env_runners: int = 1
    rollout_steps: int = 256
    seed: int = 0
    device: Any = None       # the learner's device; None = the card


class DreamerV3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.hp = _Hyper()
        for k, v in dataclasses.asdict(self.hp).items():
            setattr(self, k, v)

    def training(self, **kwargs) -> "DreamerV3Config":
        super().training(**kwargs)
        for f in dataclasses.fields(_Hyper):
            setattr(self.hp, f.name, getattr(self, f.name))
        return self

    def debugging(self, seed: int = 0) -> "DreamerV3Config":
        super().debugging(seed)
        self.hp.seed = seed
        return self

    def env_runners(self, n, rollout_steps=None) -> "DreamerV3Config":
        super().env_runners(n, rollout_steps)
        self.hp.num_env_runners = n
        if rollout_steps is not None:
            self.hp.rollout_steps = rollout_steps
        return self


# ----------------------------------------------------------- the optimizer
def clip_by_global_norm(grads, max_norm: float):
    """``optax.clip_by_global_norm``: one norm over the whole tree, and
    ``where(norm < max, g, g / norm * max)`` leaf by leaf, on the device
    (no value is read back)."""
    import torch

    from .algorithm import tree_map, tree_paths

    norm = torch.sqrt(sum((g * g).sum() for _, g in tree_paths(grads)))
    keep = norm < max_norm
    return tree_map(lambda g: torch.where(keep, g, g / norm * max_norm),
                    grads)


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(max_norm), adam(lr))`` over a tree
    of tensors, as a pure function of (params, grads, state)."""

    def __init__(self, lr: float, max_norm: float = 100.0):
        from .algorithm import Adam

        self.adam = Adam(lr)
        self.max_norm = max_norm

    def init(self, params):
        return self.adam.init(params)

    def step(self, params, grads, state):
        return self.adam.step(
            params, clip_by_global_norm(grads, self.max_norm), state)


# ------------------------------------------------------------- world model
def init_world_model(generator, hp: _Hyper, obs_size: int, action_size: int):
    zdim = hp.stoch * hp.classes
    return {
        "enc": _mlp_init(generator, [obs_size, hp.hidden, hp.hidden]),
        "gru": _gru_init(generator, zdim + action_size, hp.deter),
        "prior": _mlp_init(generator, [hp.deter, hp.hidden, zdim]),
        "post": _mlp_init(generator, [hp.deter + hp.hidden, hp.hidden, zdim]),
        "dec": _mlp_init(generator, [hp.deter + zdim, hp.hidden, obs_size]),
        "rew": _mlp_init(generator, [hp.deter + zdim, hp.hidden, 1], 0.01),
        "cont": _mlp_init(generator, [hp.deter + zdim, hp.hidden, 1], 0.01),
    }


def _unimix(logits, hp: _Hyper):
    """Log of the 1%-uniform mixture (paper's unimix; keeps KL finite)."""
    import torch

    return torch.log(0.99 * torch.softmax(logits, -1) + 0.01 / hp.classes)


def _sample_latent(logits, hp: _Hyper, generator=None, gumbel_noise=None):
    """Straight-through one-hot sample of the categorical latents; the
    Gumbel noise ([..., stoch, classes]) is drawn from ``generator``
    unless passed."""
    import torch
    import torch.nn.functional as F

    logits = logits.reshape(logits.shape[:-1] + (hp.stoch, hp.classes))
    logits = _unimix(logits, hp)
    if gumbel_noise is None:
        gumbel_noise = gumbel(logits.shape, generator)
    idx = torch.argmax(logits + gumbel_noise, -1)
    one_hot = F.one_hot(idx, hp.classes).to(logits.dtype)
    probs = torch.softmax(logits, -1)
    st = one_hot + probs - probs.detach()
    return st.reshape(st.shape[:-2] + (hp.stoch * hp.classes,)), logits


def _kl(lhs_logits, rhs_logits):
    """KL(lhs || rhs) summed over latents, mean over batch dims."""
    import torch

    lp = torch.log_softmax(lhs_logits, -1)
    lq = torch.log_softmax(rhs_logits, -1)
    p = torch.exp(lp)
    return (p * (lp - lq)).sum(-1).sum(-1)


def make_wm_loss(hp: _Hyper):
    """``loss_fn(wm, batch, generator=None, noise=None) -> (loss, (feat,
    metrics))``; ``noise`` is the posterior's Gumbel noise, [T, B, stoch,
    classes], drawn from ``generator`` unless passed."""
    import torch
    import torch.nn.functional as F

    def wm_loss(wm, obs, actions, is_first, noise):
        """obs [B,T,O]; actions [B,T,A] (a_{t} taken AT t); is_first [B,T].
        Returns loss + posterior features for imagination starts."""
        B, T = obs.shape[:2]
        zdim = hp.stoch * hp.classes
        embed = _mlp(wm["enc"], symlog(obs))  # [B,T,H]
        h = obs.new_zeros((B, hp.deter))
        z = obs.new_zeros((B, zdim))
        # a_{t-1} feeds step t: shift actions right by one.
        act_prev = torch.cat(
            [torch.zeros_like(actions[:, :1]), actions[:, :-1]], 1)
        hs, zs, posts, priors = [], [], [], []
        for t in range(T):
            # Episode boundary: reset recurrent + latent state.
            mask = (1.0 - is_first[:, t])[:, None]
            h, z = h * mask, z * mask
            a_prev = act_prev[:, t] * mask
            h = _gru(wm["gru"], h, torch.cat([z, a_prev], -1))
            prior_logits = _mlp(wm["prior"], h)
            post_logits = _mlp(wm["post"], torch.cat([h, embed[:, t]], -1))
            z, post_l = _sample_latent(post_logits, hp,
                                       gumbel_noise=noise[t])
            prior_l = _unimix(prior_logits.reshape(
                prior_logits.shape[:-1] + (hp.stoch, hp.classes)), hp)
            hs.append(h)
            zs.append(z)
            posts.append(post_l)
            priors.append(prior_l)
        hs, zs = torch.stack(hs, 1), torch.stack(zs, 1)  # [B,T,·]
        post_l, prior_l = torch.stack(posts, 1), torch.stack(priors, 1)
        feat = torch.cat([hs, zs], -1)
        obs_hat = _mlp(wm["dec"], feat)
        rew_hat = _mlp(wm["rew"], feat)[..., 0]
        cont_hat = _mlp(wm["cont"], feat)[..., 0]
        return feat, obs_hat, rew_hat, cont_hat, post_l, prior_l

    def loss_fn(wm, batch, generator=None, noise=None):
        obs, actions = batch["obs"], batch["actions"]
        rewards, dones = batch["rewards"], batch["dones"]
        is_first = batch["is_first"]
        if noise is None:
            B, T = obs.shape[:2]
            noise = gumbel((T, B, hp.stoch, hp.classes), generator)
        feat, obs_hat, rew_hat, cont_hat, post_l, prior_l = wm_loss(
            wm, obs, actions, is_first, noise)
        pred = (
            ((obs_hat - symlog(obs)) ** 2).sum(-1)
            + (rew_hat - symlog(rewards)) ** 2
        ).mean()
        cont = -(
            (1.0 - dones) * F.logsigmoid(cont_hat)
            + dones * F.logsigmoid(-cont_hat)
        ).mean()
        dyn = torch.clamp_min(_kl(post_l.detach(), prior_l),
                              hp.free_bits).mean()
        rep = torch.clamp_min(_kl(post_l, prior_l.detach()),
                              hp.free_bits).mean()
        loss = pred + cont + hp.beta_dyn * dyn + hp.beta_rep * rep
        metrics = {"wm_loss": loss, "pred": pred, "kl_dyn": dyn,
                   "kl_rep": rep}
        return loss, (feat, {k: v.detach() for k, v in metrics.items()})

    return loss_fn


# ------------------------------------------------------ actor-critic heads
def init_actor_critic(generator, hp: _Hyper, action_size: int,
                      discrete: bool):
    feat = hp.deter + hp.stoch * hp.classes
    out = action_size if discrete else 2 * action_size
    return {
        "actor": _mlp_init(generator, [feat, hp.hidden, out], 0.01),
        "critic": _mlp_init(generator, [feat, hp.hidden, 1], 0.01),
    }


def ac_noise(hp: _Hyper, discrete: bool, action_size: int, n: int,
             generator):
    """An imagination's draws for ``n`` starts: ``{"action": [H, n, A]}``
    (Gumbel noise for a discrete action, Gaussian ``eps`` for a
    continuous one) and ``{"latent": [H, n, stoch, classes]}``."""
    import torch

    shape = (hp.horizon, n, action_size)
    act = (gumbel(shape, generator) if discrete
           else torch.randn(shape, generator=generator,
                            device=generator.device))
    return {"action": act,
            "latent": gumbel((hp.horizon, n, hp.stoch, hp.classes),
                             generator)}


def lambda_returns(rew, cont, values, hp: _Hyper):
    """TD(lambda) returns [H, N] by a reverse loop; ``values`` are aligned
    with the post-step states."""
    import torch

    disc = cont * hp.gamma
    acc = values[-1]
    rets = [None] * len(rew)
    for t in reversed(range(len(rew))):
        acc = rew[t] + disc[t] * ((1 - hp.lam) * values[t] + hp.lam * acc)
        rets[t] = acc
    return torch.stack(rets)


def make_ac_update(hp: _Hyper, discrete: bool, action_size: int):
    """``(policy, imagine, update)``.  ``imagine`` and ``update`` take
    ``noise`` as ``ac_noise`` makes it, drawn from ``generator`` unless
    passed; ``policy`` takes one step's action noise."""
    import torch
    import torch.nn.functional as F

    def policy(ac, feat, generator=None, noise=None):
        out = _mlp(ac["actor"], feat)
        if discrete:
            if noise is None:
                noise = gumbel(out.shape, generator)
            a = torch.argmax(out + noise, -1)
            logp_all = torch.log_softmax(out, -1)
            logp = logp_all.gather(-1, a[:, None])[:, 0]
            ent = -(torch.softmax(out, -1) * logp_all).sum(-1)
            return F.one_hot(a, action_size).to(out.dtype), logp, ent
        mean, log_std = torch.chunk(out, 2, -1)
        log_std = torch.clamp(log_std, -5.0, 1.0)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=generator.device)
        eps = noise
        a = torch.tanh(mean + eps * torch.exp(log_std))
        logp = (
            -0.5 * (eps ** 2 + 2 * log_std + np.log(2 * np.pi))
            - torch.log1p(-a ** 2 + 1e-6)
        ).sum(-1)
        ent = (log_std + 0.5 * np.log(2 * np.pi * np.e)).sum(-1)
        return a, logp, ent

    def imagine(wm, ac, feat0, generator=None, noise=None):
        """Roll the prior forward under the actor for hp.horizon steps."""
        if noise is None:
            noise = ac_noise(hp, discrete, action_size, feat0.shape[0],
                             generator)
        h, z = feat0[:, :hp.deter], feat0[:, hp.deter:]
        cols = ([], [], [], [], [], [])
        for t in range(hp.horizon):
            feat = torch.cat([h, z], -1)
            a, logp, ent = policy(ac, feat, noise=noise["action"][t])
            h = _gru(wm["gru"], h, torch.cat([z, a], -1))
            z, _ = _sample_latent(_mlp(wm["prior"], h), hp,
                                  gumbel_noise=noise["latent"][t])
            feat2 = torch.cat([h, z], -1)
            rew = symexp(_mlp(wm["rew"], feat2)[..., 0])
            cont = torch.sigmoid(_mlp(wm["cont"], feat2)[..., 0])
            for col, x in zip(cols, (feat, feat2, logp, ent, rew, cont)):
                col.append(x)
        return tuple(torch.stack(col) for col in cols)  # time-major [H,N,·]

    def update(wm, ac, feat0, ret_std, generator=None, noise=None):
        from .algorithm import tree_map, value_and_grad

        if noise is None:
            noise = ac_noise(hp, discrete, action_size, feat0.shape[0],
                             generator)
        wm = tree_map(lambda t: t.detach(), wm)

        def ac_loss(ac):
            traj = imagine(wm, ac, feat0, noise=noise)
            feat, feat2, logp, ent, rew, cont = traj
            values = _mlp(ac["critic"], feat2)[..., 0]
            values_se = symexp(values)
            rets = lambda_returns(rew, cont, values_se.detach(), hp)
            # Return normalization (paper: scale by S = EMA of the return
            # spread); advantage = (ret - v) / max(1, S).
            adv = ((rets - values_se) / max(1.0, float(ret_std))).detach()
            # Discount weights so later imagined steps count less once a
            # predicted episode end passed.
            weights = torch.cumprod(
                torch.cat([torch.ones_like(cont[:1]), cont[:-1]], 0), 0,
            ).detach()
            actor = -(weights * (logp * adv + hp.entropy * ent)).mean()
            critic = (
                weights * (_mlp(ac["critic"], feat2.detach())[..., 0]
                           - symlog(rets).detach()) ** 2
            ).mean()
            new_std = rets.std(correction=0) + 1e-6
            return actor + critic, (rets.mean().detach(), new_std.detach())

        loss, (ret_mean, new_std), grads = value_and_grad(ac_loss, ac)
        return loss, grads, ret_mean, new_std

    return policy, imagine, update


def make_train_once(hp: _Hyper, discrete: bool, action_size: int,
                    wm_tx, ac_tx):
    """One world-model and one actor-critic update:
    ``train_once(wm, ac, wm_opt, ac_opt, batch, ret_std, generator,
    noise=None) -> (wm, ac, wm_opt, ac_opt, new_std, metrics)``, every
    output on the params' device.  ``noise`` is ``{"wm": ..., "ac":
    {...}}`` as ``make_wm_loss`` and ``make_ac_update`` take it."""
    from .algorithm import value_and_grad

    wm_loss = make_wm_loss(hp)
    _, _, ac_update = make_ac_update(hp, discrete, action_size)

    def train_once(wm, ac, wm_opt, ac_opt, batch, ret_std, generator,
                   noise=None):
        noise = noise or {}
        _wml, (feat, metrics), wm_grads = value_and_grad(
            wm_loss, wm, batch, generator, noise.get("wm"))
        wm, wm_opt = wm_tx.step(wm, wm_grads, wm_opt)
        feat0 = feat.reshape(-1, feat.shape[-1]).detach()
        acl, ac_grads, ret_mean, new_std = ac_update(
            wm, ac, feat0, ret_std, generator, noise.get("ac"))
        ac, ac_opt = ac_tx.step(ac, ac_grads, ac_opt)
        metrics = dict(metrics)
        metrics.update(ac_loss=acl, imag_return=ret_mean)
        return wm, ac, wm_opt, ac_opt, new_std, metrics

    return train_once


# --------------------------------------------- numpy forward (env runners)
def _mlp_np(params, x):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = np.where(x > 0, x, np.float32(0.01) * x)
    return x


def _sigmoid_np(x):
    return 1.0 / (1.0 + np.exp(-x))


def _softmax_np(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def act_np(wm, ac, hp: _Hyper, discrete: bool, obs, h, z, a_prev, first,
           latent_noise, action_noise):
    """One runner step through the posterior filter and the actor, in
    numpy: ``(action, h, z)``.  ``latent_noise`` is Gumbel noise [stoch,
    classes]; ``action_noise`` Gumbel [A] (discrete) or Gaussian [A]."""
    mask = np.float32(1.0) - np.float32(first)
    h, z, a_prev = h * mask, z * mask, a_prev * mask
    g = wm["gru"]
    gates = (np.concatenate([z, a_prev]) @ g["wi"] + h @ g["wh"] + g["b"])
    r, u, c = np.split(gates, 3)
    r, u = _sigmoid_np(r), _sigmoid_np(u)
    h = u * h + (1 - u) * np.tanh(r * c)
    emb = _mlp_np(wm["enc"], np.sign(obs) * np.log1p(np.abs(obs)))
    post = _mlp_np(wm["post"], np.concatenate([h, emb]))
    logits = np.log(0.99 * _softmax_np(post.reshape(hp.stoch, hp.classes))
                    + 0.01 / hp.classes)
    z = np.eye(hp.classes, dtype=np.float32)[
        np.argmax(logits + latent_noise, -1)].reshape(-1)
    out = _mlp_np(ac["actor"], np.concatenate([h, z]))
    if discrete:
        a = np.zeros(out.shape[-1], np.float32)
        a[int(np.argmax(out + action_noise))] = 1.0
    else:
        mean, log_std = np.split(out, 2)
        log_std = np.clip(log_std, -5.0, 1.0)
        a = np.tanh(mean + action_noise * np.exp(log_std))
    return (np.asarray(a, np.float32), np.asarray(h, np.float32),
            np.asarray(z, np.float32))


# ------------------------------------------------------------- env runner
@ray_tpu_torch.remote
class _DreamerRunner:
    """CPU env actor: acts through the world model's posterior filter
    (encoder + GRU) with the broadcast params snapshot (numpy)."""

    def __init__(self, env_payload, hp: _Hyper, obs_size, action_size,
                 discrete, runner_idx):
        from ray_tpu_torch.core.serialization import loads_function

        self.env = loads_function(env_payload)()
        self.hp = hp
        self.discrete = discrete
        self.action_size = action_size
        self.idx = runner_idx
        self.obs = self.env.reset()
        self.h = np.zeros(hp.deter, np.float32)
        self.z = np.zeros(hp.stoch * hp.classes, np.float32)
        self.prev_action = np.zeros(action_size, np.float32)
        self.first = True
        self._t = 0
        self.episode_return = 0.0
        self.completed: list = []

    def sample(self, wm, ac, n_steps, random_actions=False):
        rng = np.random.default_rng((self.hp.seed, self.idx, self._t))
        rows = {k: [] for k in
                ("obs", "actions", "rewards", "dones", "is_first")}
        for _ in range(n_steps):
            if random_actions:
                if self.discrete:
                    a = np.zeros(self.action_size, np.float32)
                    a[rng.integers(self.action_size)] = 1.0
                else:
                    a = rng.uniform(-1, 1, self.action_size).astype(
                        np.float32
                    )
            else:
                latent_noise = rng.gumbel(
                    size=(self.hp.stoch, self.hp.classes))
                action_noise = (rng.gumbel(size=self.action_size)
                                if self.discrete
                                else rng.standard_normal(self.action_size))
                a, self.h, self.z = act_np(
                    wm, ac, self.hp, self.discrete,
                    np.asarray(self.obs, np.float32), self.h, self.z,
                    self.prev_action, self.first,
                    latent_noise.astype(np.float32),
                    action_noise.astype(np.float32),
                )
            env_a = int(np.argmax(a)) if self.discrete else a * getattr(
                self.env, "action_high", 1.0
            )
            next_obs, reward, done, _ = self.env.step(env_a)
            rows["obs"].append(np.asarray(self.obs, np.float32))
            rows["actions"].append(a)
            rows["rewards"].append(np.float32(reward))
            rows["dones"].append(np.float32(done))
            rows["is_first"].append(np.float32(self.first))
            self.first = False
            self.prev_action = a
            self.episode_return += reward
            self._t += 1
            if done:
                self.completed.append(self.episode_return)
                self.episode_return = 0.0
                self.obs = self.env.reset()
                self.first = True
                self.h = np.zeros_like(self.h)
                self.z = np.zeros_like(self.z)
                self.prev_action = np.zeros_like(self.prev_action)
            else:
                self.obs = next_obs
        eps, self.completed = self.completed, []
        return {k: np.asarray(v) for k, v in rows.items()}, eps


# ----------------------------------------------------------------- buffer
class SequenceBuffer:
    """Flat ring of transitions; samples fixed-length windows (episode
    boundaries handled by the stored is_first flags, paper-style)."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._data: Optional[Dict[str, np.ndarray]] = None
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def add_batch(self, batch: Dict[str, np.ndarray]):
        n = len(batch["obs"])
        if self._data is None:
            self._data = {
                k: np.zeros((self.capacity,) + np.asarray(v).shape[1:],
                            np.asarray(v).dtype)
                for k, v in batch.items()
            }
        for i in range(n):  # ring-write row by row (n << capacity)
            for k, v in batch.items():
                self._data[k][self._next] = v[i]
            self._next = (self._next + 1) % self.capacity
            self._size = min(self._size + 1, self.capacity)

    def __len__(self):
        return self._size

    def sample(self, batch_size: int, seq_len: int) -> Dict[str, np.ndarray]:
        starts = self._rng.integers(
            0, self._size - seq_len, size=batch_size
        )
        out = {
            k: np.stack([v[s:s + seq_len] for s in starts])
            for k, v in self._data.items()
        }
        # A window that straddles the ring's write head or an episode cut
        # is still trainable: is_first resets the RSSM state mid-window.
        out["is_first"][:, 0] = 1.0
        return out


# -------------------------------------------------------------- algorithm
class DreamerV3(Algorithm):
    def setup(self, config: DreamerV3Config):
        from ray_tpu_torch.core.serialization import dumps_function
        from ray_tpu_torch.device import resolve_device

        from .algorithm import seeded_generator

        hp = self.hp = config.hp
        env_maker = config.env_maker
        if env_maker is None:
            from .env import Pendulum

            env_maker = Pendulum
        probe = env_maker()
        self.obs_size = probe.observation_size
        self.discrete = hasattr(probe, "num_actions")
        self.action_size = (
            probe.num_actions if self.discrete else probe.action_size
        )
        self.device = resolve_device(hp.device)
        self.wm = init_world_model(
            seeded_generator(self.device, hp.seed, 0), hp, self.obs_size,
            self.action_size)
        self.ac = init_actor_critic(
            seeded_generator(self.device, hp.seed, 1), hp, self.action_size,
            self.discrete)
        # The learner's draws (latents, imagined actions).
        self._gen = seeded_generator(self.device, hp.seed, 2)
        self.wm_tx = ClippedAdam(hp.wm_lr)
        self.ac_tx = ClippedAdam(hp.ac_lr)
        self.wm_opt = self.wm_tx.init(self.wm)
        self.ac_opt = self.ac_tx.init(self.ac)
        self.ret_std = np.float32(1.0)
        self._train_once = make_train_once(
            hp, self.discrete, self.action_size, self.wm_tx, self.ac_tx)
        self.buffer = SequenceBuffer(hp.buffer_capacity, seed=hp.seed)
        env_payload = dumps_function(env_maker)
        self.runners = [
            _DreamerRunner.remote(
                env_payload, hp, self.obs_size, self.action_size,
                self.discrete, i,
            )
            for i in range(max(1, hp.num_env_runners))
        ]
        self._episode_returns: list = []
        self._total_steps = 0

    def training_step(self) -> Dict[str, Any]:
        from .algorithm import to_numpy, to_tensors

        hp = self.hp
        random_phase = len(self.buffer) < hp.min_buffer
        wm, ac = (None, None) if random_phase else (
            to_numpy(self.wm), to_numpy(self.ac))
        refs = [
            r.sample.remote(wm, ac, hp.rollout_steps, random_phase)
            for r in self.runners
        ]
        for batch, eps in ray_tpu_torch.get(refs, timeout=600):
            self.buffer.add_batch(batch)
            self._episode_returns.extend(eps)
            self._total_steps += len(batch["obs"])
        metrics: Dict[str, Any] = {}
        if len(self.buffer) >= hp.min_buffer:
            for _ in range(hp.train_ratio):
                batch = to_tensors(
                    self.buffer.sample(hp.batch_size, hp.seq_len),
                    self.device)
                (self.wm, self.ac, self.wm_opt, self.ac_opt,
                 new_std, metrics) = self._train_once(
                    self.wm, self.ac, self.wm_opt, self.ac_opt,
                    batch, self.ret_std, self._gen,
                )
                # EMA of the imagined-return spread (normalizer): the one
                # value an update reads back.
                self.ret_std = 0.99 * self.ret_std + 0.01 * float(new_std)
        recent = self._episode_returns[-20:]
        return {
            "total_steps": self._total_steps,
            "buffer_size": len(self.buffer),
            "episode_return_mean": (
                float(np.mean(recent)) if recent else None
            ),
            **{k: float(v) for k, v in metrics.items()},
        }

    def get_state(self):
        from .algorithm import to_numpy

        def opt(state):
            return {"count": state["count"], "mu": to_numpy(state["mu"]),
                    "nu": to_numpy(state["nu"])}

        return {
            "wm": to_numpy(self.wm), "ac": to_numpy(self.ac),
            "wm_opt": opt(self.wm_opt), "ac_opt": opt(self.ac_opt),
            "ret_std": self.ret_std,
        }

    def set_state(self, state):
        from .algorithm import to_tensors

        def opt(s):
            return {"count": s["count"],
                    "mu": to_tensors(s["mu"], self.device),
                    "nu": to_tensors(s["nu"], self.device)}

        self.wm = to_tensors(state["wm"], self.device)
        self.ac = to_tensors(state["ac"], self.device)
        self.wm_opt = opt(state["wm_opt"])
        self.ac_opt = opt(state["ac_opt"])
        self.ret_std = state["ret_std"]

    def cleanup(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001
                pass


DreamerV3Config.ALGO_CLS = DreamerV3
