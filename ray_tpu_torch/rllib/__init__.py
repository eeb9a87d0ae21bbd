"""``ray_tpu_torch.rllib`` — reinforcement learning on the core actor
runtime.

Reference: ray ``rllib/`` — Algorithm (a Tune Trainable) coordinating env
runner actors for sampling and PyTorch learners for SGD on the card
(``device="cpu"`` on a config runs them on the CPU); algorithms: PPO, DQN
(double/PER), IMPALA/APPO (V-trace), SAC, BC/MARWIL, CQL/IQL (offline),
independent multi-agent learning, the Podracer trainers (Anakin,
Sebulba), and DreamerV3 (a world model, acting in imagination).
"""

from .actor_manager import FaultTolerantActorManager  # noqa: F401
from .connectors import (  # noqa: F401
    ClipActions,
    ComputeGAE,
    Connector,
    ConnectorPipeline,
    NormalizeAdvantages,
    NormalizeObs,
    ObsToFloatBatch,
    ScaleActions,
)
from .algorithm import (  # noqa: F401
    Algorithm,
    AlgorithmConfig,
    init_mlp,
    mlp_forward,
    mlp_forward_np,
)
from .bc import BC, BCConfig, MARWIL, MARWILConfig  # noqa: F401
from .dqn import DQN, DQNConfig  # noqa: F401
from .dreamerv3 import DreamerV3, DreamerV3Config  # noqa: F401
from .env import CartPole, CartPoleTorch, Pendulum, PendulumTorch  # noqa: F401
from .impala import (  # noqa: F401
    APPO,
    APPOConfig,
    IMPALA,
    IMPALAConfig,
    make_vtrace_loss,
    make_vtrace_update,
)
from .podracer import (  # noqa: F401
    Anakin,
    AnakinConfig,
    Sebulba,
    SebulbaConfig,
)
from .ppo import PPO, PPOConfig, TorchLearner  # noqa: F401
from .replay import PrioritizedReplayBuffer, ReplayBuffer  # noqa: F401
from .rl_module import (  # noqa: F401
    DiscretePolicyModule,
    MultiRLModule,
    RLModule,
    RLModuleSpec,
    SACModule,
)
from .sac import SAC, SACConfig  # noqa: F401
from .offline import OfflineData, record_transitions  # noqa: F401
from .cql import CQL, CQLConfig  # noqa: F401
from .iql import IQL, IQLConfig, IQLModule  # noqa: F401
from .multi_agent import (  # noqa: F401
    ALL_DONE,
    IndependentTrainer,
    MultiAgentEnv,
    MultiAgentEpisode,
    TwoAgentCoopEnv,
    collect_episodes,
)
