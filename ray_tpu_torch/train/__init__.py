from .backend import (  # noqa: F401
    AccelerateBackend,
    Backend,
    TensorflowBackend,
    TorchBackend,
)
from .checkpoint import Checkpoint  # noqa: F401
from .config import (  # noqa: F401
    CheckpointConfig,
    CollectiveConfig,
    FailureConfig,
    PipelineConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from .pipeline import (  # noqa: F401
    PipelinedTrainer,
    StageModule,
    build_1f1b_schedule,
    gpt2_stage_modules,
)
from .session import (  # noqa: F401
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
    should_stop,
)
from .trainer import (  # noqa: F401
    DataParallelTrainer,
    TensorflowTrainer,
    TorchTrainer,
)
