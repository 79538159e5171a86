"""ray_tpu_torch.serve — model serving: deployments behind a router and a
controller, the HTTP proxy, the tenancy plane, and the LLM engines on the
card (`serve.llm`). Port of `ray_tpu.serve`."""

from ..core.exceptions import (  # noqa: F401 - serve-facing typed errors
    BackPressureError,
    DeploymentUnavailableError,
    ReplicaDrainingError,
    RequestTimeoutError,
)
from .api import (  # noqa: F401
    delete,
    get_handle,
    run,
    shutdown,
    start_http,
    status,
)
from .context import (  # noqa: F401
    get_request_deadline,
    get_request_priority,
    get_request_tenant,
    remaining_s,
)
from .deployment import (  # noqa: F401
    Application,
    AutoscalingConfig,
    Deployment,
    DeploymentConfig,
    deployment,
)
from .multiplex import get_multiplexed_model_id, multiplexed  # noqa: F401
from .router import DeploymentHandle  # noqa: F401
from .tenancy import TenantSpec, set_tenant  # noqa: F401
