"""ray_tpu_torch.util — observability (metrics, state API, flight recorder,
goodput accounting, watchdogs, profiling, postmortem bundles) and the
state-tree walker the checkpoints and the cost layer share. Ports of
`ray_tpu.util`'s modules of the same names, with `ActorPool` and `Queue`
over the port's thread actors and `multiprocessing.Pool` over its
process-executor tasks."""

from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    cluster_prometheus_text,
    get_or_create_counter,
    get_or_create_gauge,
    get_or_create_histogram,
    merge_cluster_expositions,
    register_runtime_gauges,
    registry,
    start_metrics_server,
)
from .state import (  # noqa: F401
    chrome_tracing_dump,
    cluster_metrics,
    get_profile,
    get_trace,
    head_summary,
    list_actors,
    list_nodes,
    list_objects,
    list_profiles,
    list_tasks,
    list_traces,
    node_stats,
    profile,
    profile_artifact,
    status_report,
    summary,
    trace_dump,
)
from . import goodput, postmortem, tracing, watchdog  # noqa: F401
from .actor_pool import ActorPool  # noqa: F401
from .events import (  # noqa: F401
    EVENT_KINDS,
    EventLog,
    event_kinds,
    register_event_kind,
)
from .goodput import GoodputAccountant, serve_slo_report  # noqa: F401
from .postmortem import build_bundle, load_bundle  # noqa: F401
from .queue import Empty, Full, Queue  # noqa: F401
from .profiling import (  # noqa: F401
    ProfilingError,
    StepCost,
    annotate,
    capture_local_profile,
    device_peaks,
    device_trace,
    profiler_server_port,
    roofline,
    start_device_trace,
    start_profiler_server,
    step_annotation,
    step_cost,
    stop_device_trace,
)
from . import multiprocessing  # noqa: F401,E402
