"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu.

The JAX package `ray_tpu` stays the reference; this package mirrors its
module paths and names so each piece has an obvious counterpart:

- the runtime (`api`, `core`): init/shutdown, @remote tasks and actors,
  put/get/wait over a tiered object store (CUDA tensors stay on the card),
  streaming generators and placement groups over the logical nodes of
  one process, with the process's CUDA devices as the `GPU` resource,
  and cluster mode (`init(head=True)` / `init(address=...)`, node agents
  started with `python -m ray_tpu_torch start` or `cluster_utils`):
  remote tasks and actors, chunked object transfer, borrowed refs;
- `ops`: layer primitives, flash attention and ragged paged attention,
  the two attention functions backed by hand-written CUDA kernels for
  Hopper (sm_90a) with a plain PyTorch version beside each;
- `models`: the decoder-only transformer (GPT-2 / Llama families), its
  presets and a converter from the JAX parameter pytree;
- `serve`: deployments behind a router and a controller, the HTTP proxy,
  and `serve.llm` — the engines, `LLMServer`, `build_llm_app` and the
  OpenAI-compatible frontend;
- `train`, `data`: the trainer, checkpoints and the LM batch feed.

It imports `torch` and never `jax` or `ray_tpu`. Entry points run on the
CUDA device unless the caller passes `device="cpu"`; with no CUDA device
they raise instead of falling back.
"""

__version__ = "0.1.0"

from .api import (  # noqa: F401,E402
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    list_actors,
    nodes,
    placement_group,
    put,
    remote,
    remove_placement_group,
    shutdown,
    wait,
)
from .core.exceptions import (  # noqa: F401,E402
    ActorDiedError,
    ActorError,
    ActorUnavailableError,
    BackPressureError,
    DeploymentUnavailableError,
    GetTimeoutError,
    ObjectLostError,
    ObjectStoreFullError,
    OutOfResourcesError,
    PlacementGroupUnschedulableError,
    ProfilingError,
    RayTpuError,
    ReplicaDrainingError,
    RequestTimeoutError,
    RuntimeNotInitializedError,
    TaskCancelledError,
    TaskError,
)
from .core.runtime import ActorHandle, ObjectRef  # noqa: F401,E402
from .core.scheduler import (  # noqa: F401,E402
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)
from .core.streaming import ObjectRefGenerator  # noqa: F401,E402
