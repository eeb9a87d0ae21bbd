"""Algorithm base + config builder.

Reference: ``Algorithm`` (ray ``rllib/algorithms/algorithm.py:212`` — a
Tune Trainable whose ``step()`` runs one sample+learn iteration) and the
``AlgorithmConfig`` fluent builder (``rllib/algorithms/algorithm_config.py``).
Learners are PyTorch updates on the card; env runners stay CPU actors.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Dict, Optional

import numpy as np


class AlgorithmConfig:
    """Fluent builder: ``.environment(...).env_runners(...).training(...)``."""

    ALGO_CLS: Optional[type] = None

    def __init__(self):
        self.env_maker: Optional[Callable] = None
        self.num_env_runners: int = 2
        self.rollout_steps: int = 256
        self.gamma: float = 0.99
        self.lr: float = 3e-3
        self.seed: int = 0

    def environment(self, env_maker: Callable) -> "AlgorithmConfig":
        self.env_maker = env_maker
        return self

    def env_runners(
        self, num_env_runners: int, rollout_steps: Optional[int] = None
    ) -> "AlgorithmConfig":
        self.num_env_runners = num_env_runners
        if rollout_steps is not None:
            self.rollout_steps = rollout_steps
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k) or callable(getattr(self, k)):
                # Fail loudly: a swallowed typo is a silently wrong run.
                raise ValueError(
                    f"unknown training option {k!r} for "
                    f"{type(self).__name__}"
                )
            setattr(self, k, v)
        return self

    def debugging(self, seed: int = 0) -> "AlgorithmConfig":
        self.seed = seed
        return self

    def build(self) -> "Algorithm":
        assert self.ALGO_CLS is not None, "config has no bound algorithm"
        return self.ALGO_CLS(self)


class Algorithm:
    """Train/save/restore lifecycle (Tune-Trainable-compatible: pass
    ``lambda config: algo.train()`` style loops, or use directly)."""

    def __init__(self, config: AlgorithmConfig):
        from ray_tpu_torch.core.usage import record_library_usage

        record_library_usage("rllib")
        self.config = config
        self.iteration = 0
        self.setup(config)

    # -- subclass surface ---------------------------------------------------
    def setup(self, config: AlgorithmConfig) -> None:
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass

    def cleanup(self) -> None:
        pass

    # -- public lifecycle ---------------------------------------------------
    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        result = self.training_step()
        result.setdefault("training_iteration", self.iteration)
        return result

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        state = {"iteration": self.iteration, "state": self.get_state()}
        with open(path, "wb") as f:
            pickle.dump(state, f)
        return path

    def restore(self, checkpoint_path: str) -> None:
        if os.path.isdir(checkpoint_path):
            checkpoint_path = os.path.join(
                checkpoint_path, "algorithm_state.pkl"
            )
        with open(checkpoint_path, "rb") as f:
            state = pickle.load(f)
        self.iteration = state["iteration"]
        self.set_state(state["state"])

    def stop(self) -> None:
        self.cleanup()


# --------------------------------------------------------- shared mlp module
def init_mlp(generator, sizes, out_scale: float = 0.01):
    """He-init MLP params; final layer near-zero (policy/Q head), drawn
    from ``generator`` (a ``torch.Generator``) on its device."""
    import torch

    device = generator.device
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        last = i == len(sizes) - 2
        scale = out_scale if last else (2.0 / fan_in) ** 0.5
        params[f"w{i}"] = torch.randn(
            (fan_in, fan_out), generator=generator, device=device
        ) * scale
        params[f"b{i}"] = torch.zeros(fan_out, dtype=torch.float32,
                                      device=device)
    return params


def mlp_forward(params, x, n_layers: int):
    import torch

    for i in range(n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            x = torch.tanh(x)
    return x


def mlp_forward_np(params, x, n_layers: int):
    """Numpy twin for CPU env runners (no torch import in samplers)."""
    for i in range(n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            x = np.tanh(x)
    return x


# --------------------------------------------------- learner building blocks
# Parameter trees are nested dicts and lists of tensors (or a bare tensor,
# such as SAC's log-alpha): the learners' stand-in for JAX pytrees.
class _Index(int):
    """A list position in a tree path (a dict key may be an int too)."""


def tree_paths(tree, prefix=()):
    """``[(path, leaf)]`` in sorted-key and list order, as
    ``jax.tree.leaves``."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_paths(tree[k], prefix + (k,))
        return out
    if isinstance(tree, list):
        out = []
        for i, node in enumerate(tree):
            out += tree_paths(node, prefix + (_Index(i),))
        return out
    return [(prefix, tree)]


def tree_unflatten(paths, leaves):
    if len(paths) == 1 and paths[0] == ():
        return leaves[0]
    out: Dict[Any, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return _lists(out)


def _lists(node):
    """The nodes keyed by list positions, back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, _Index) for k in node):
        return [node[i] for i in range(len(node))]
    return node


def tree_map(fn, *trees):
    paths = [p for p, _ in tree_paths(trees[0])]
    cols = [[leaf for _, leaf in tree_paths(t)] for t in trees]
    return tree_unflatten(paths, [fn(*xs) for xs in zip(*cols)])


def to_numpy(tree):
    """A tree of tensors → the same tree of numpy arrays (on the host)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def to_tensors(tree, device):
    """A tree of arrays or tensors → f32 tensors on ``device`` (copies)."""
    import torch

    return tree_map(
        lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(device)
        if not isinstance(a, torch.Tensor)
        else a.detach().to(device=device, dtype=torch.float32, copy=True),
        tree,
    )


def seeded_generator(device, *key: int):
    """A ``torch.Generator`` on ``device`` seeded from the integers ``key``
    (``numpy.random.SeedSequence`` mixes them, so ``(seed, i)`` streams
    do not alias as ``seed + i`` ones would) — the learners' stand-in for
    ``jax.random.PRNGKey`` and ``fold_in``."""
    import torch

    seed = int(np.random.SeedSequence([int(k) for k in key])
               .generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def value_and_grad(loss_fn, params, *args, wrt=None):
    """``(loss, aux, grads)`` of ``loss_fn(params, *args) -> (loss, aux)``
    with respect to ``params`` (or to the top-level subtrees named in
    ``wrt``: the others enter as constants); ``grads`` has the shape of
    what it is taken against."""
    import torch

    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, aux = loss_fn(live, *args)
    target = live if wrt is None else {k: live[k] for k in wrt}
    paths_leaves = tree_paths(target)
    leaves = [leaf for _, leaf in paths_leaves]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # A leaf the loss does not reach has a zero gradient, as in JAX.
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    return (loss.detach(), aux,
            tree_unflatten([p for p, _ in paths_leaves], grads))


class Adam:
    """``optax.adam(lr)`` over a tree of tensors, as a pure function of
    (params, grads, state): the same moments, bias correction and order of
    operations (``torch.optim.Adam`` with betas (0.9, 0.999) and eps 1e-8
    is the same update, but owns its parameters).  ``init`` gives the
    state, ``step`` the new params and state; one ``_foreach`` launch per
    operation over every leaf."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params) -> Dict[str, Any]:
        import torch

        zeros = lambda t: torch.zeros_like(t, dtype=torch.float32)  # noqa: E731
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    def step(self, params, grads, state):
        import torch

        paths = [p for p, _ in tree_paths(params)]
        p = [leaf for _, leaf in tree_paths(params)]
        g = [leaf for _, leaf in tree_paths(grads)]
        mu = [leaf for _, leaf in tree_paths(state["mu"])]
        nu = [leaf for _, leaf in tree_paths(state["nu"])]
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul(mu, b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
            torch._foreach_mul(nu, b2))
        count = state["count"] + 1
        # optax reckons the bias corrections in the default float: f32,
        # or f64 where JAX runs in 64 bits (the leaves' dtype here).
        ft = np.float64 if p and p[0].dtype == torch.float64 else np.float32
        one, n = ft(1), ft(count)
        mu_hat = torch._foreach_div(mu, float(one - ft(b1) ** n))
        nu_hat = torch._foreach_div(nu, float(one - ft(b2) ** n))
        upd = torch._foreach_div(
            mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps))
        new = torch._foreach_add(p, torch._foreach_mul(upd, -self.lr))
        return tree_unflatten(paths, new), {
            "count": count, "mu": tree_unflatten(paths, mu),
            "nu": tree_unflatten(paths, nu)}
