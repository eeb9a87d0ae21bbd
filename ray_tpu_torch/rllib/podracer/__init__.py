"""``ray_tpu_torch.rllib.podracer`` — Podracer architectures for scalable
RL.

Reference: "Podracer architectures for scalable Reinforcement Learning"
(arxiv 2104.06272).  Two trainers on top of the task/actor/placement-
group/collective runtime:

- **Anakin** (``anakin.py``): envs AND learner together on the card —
  vectorized torch envs stepped in a loop of tensor ops, replicas over
  devices with averaged gradients, parameters never leave the card
  inside a ``training_step``.  Use when the env is (re)writable in
  tensor ops: env throughput scales with cards, not Python.
- **Sebulba** (``sebulba.py``): host-side env-runner actors (arbitrary
  Python envs) doing batched inference on their leased card shares,
  trajectories queued to the learner's card with bounded-staleness
  V-trace correction (IMPALA's loss) and parameter broadcast over the
  zero-copy ``StageChannel`` path.  Use when the env cannot be written
  in tensor ops.

``docs/rllib.md`` has the decision table, placement shapes, and knobs.
"""

from .anakin import Anakin, AnakinConfig  # noqa: F401
from .sebulba import (  # noqa: F401
    Sebulba,
    SebulbaConfig,
    SebulbaEnvRunner,
    evaluate_policy_numpy,
)
