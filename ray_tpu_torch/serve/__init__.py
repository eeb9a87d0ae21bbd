from .api import (  # noqa: F401
    delete,
    deploy_config,
    get_handle,
    run,
    shutdown,
    start_http_proxy,
    status,
    stop_http_proxy,
)
from .grpc_ingress import start_grpc_ingress, stop_grpc_ingress  # noqa: F401
from .batching import batch  # noqa: F401
from .deployment import Application, Deployment, deployment  # noqa: F401
from .request_router import (  # noqa: F401
    PowerOfTwoChoicesRouter,
    PrefixAwareRouter,
    RequestRouter,
)
from .handle import (  # noqa: F401
    DeploymentHandle,
    DeploymentResponse,
    DeploymentResponseGenerator,
)
from .multiplex import get_multiplexed_model_id, multiplexed  # noqa: F401
