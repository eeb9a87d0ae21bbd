from .collective import (  # noqa: F401
    allgather,
    allreduce,
    alltoall,
    barrier,
    broadcast,
    collective_stats,
    destroy_collective_group,
    get_collective_group_size,
    get_group,
    get_rank,
    init_collective_group,
    init_local_group,
    is_group_initialized,
    recv,
    reducescatter,
    send,
)
from .device_objects import (  # noqa: F401
    DeviceObjectStore,
    DeviceRef,
    RemoteDeviceObjectError,
    device_object_store,
)
from .dist_group import DistGroup  # noqa: F401
from .local_group import LocalGroup  # noqa: F401
from .p2p import Mailbox, StageChannel, local_mailbox  # noqa: F401
from .tuner import get_tuner, reset_tuner  # noqa: F401
from .types import Backend, GroupInfo, ReduceOp, Topology  # noqa: F401
from .experimental import (  # noqa: F401
    RemoteCommunicatorManager,
    create_collective_group,
    get_collective_groups,
)
from .experimental import (  # noqa: F401
    destroy_collective_group as destroy_actor_collective_group,
)
