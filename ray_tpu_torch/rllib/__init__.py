"""``ray_tpu_torch.rllib`` — reinforcement learning on the core actor
runtime.

Only the algorithm base, its config builder and the shared MLP are ported
yet: Tune's class trainables build on them.  The algorithms themselves
(PPO, DQN, IMPALA/APPO, BC/MARWIL, SAC, ...) wait for ROADMAP A4.
"""

from .algorithm import (  # noqa: F401
    Algorithm,
    AlgorithmConfig,
    init_mlp,
    mlp_forward,
    mlp_forward_np,
)
