"""Metrics: Counter/Gauge/Histogram registry with Prometheus exposition.

Port of `ray_tpu/util/metrics.py`: one registry per process, callback
gauges sampled at scrape time (`register_runtime_gauges` samples the
runtime's object store and task log), the Prometheus text format, the
merge of several nodes' expositions under a `node_id` label, and a stdlib
HTTP endpoint. Without a cluster `/metrics/cluster` serves this process's
registry labelled with the head node's id ("local" outside a runtime), as
the JAX package does; the fan-out over node agents comes with ROADMAP
A6b (federation).
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

TagDict = Dict[str, str]


def _tags_key(tags: Optional[TagDict]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((tags or {}).items()))


def _escape_label(value: Any) -> str:
    """Escape a label VALUE per the Prometheus exposition spec
    (backslash, double-quote, newline) — raw occurrences of any of these
    make the whole scrape payload unparseable."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    """HELP text escaping: backslash and newline only (quotes are legal)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


class _Metric:
    def __init__(self, name: str, description: str = "", tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._lock = threading.Lock()
        _registry().register(self)


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[tuple, float] = {}  # guarded-by: _lock

    def inc(self, value: float = 1.0, tags: Optional[TagDict] = None) -> None:
        key = _tags_key(tags)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def collect(self):
        with self._lock:
            return [(dict(k), v) for k, v in self._values.items()]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, description="", tag_keys=(), fn: Optional[Callable[[], Any]] = None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[tuple, float] = {}
        self._fn = fn  # callback gauge: sampled at scrape time
        self._fn_warned = False

    def set(self, value: float, tags: Optional[TagDict] = None) -> None:
        with self._lock:
            self._values[_tags_key(tags)] = float(value)

    def collect(self):
        if self._fn is not None:
            try:
                sampled = self._fn()
            except Exception as exc:  # noqa: BLE001 - a sampler must not kill the scrape
                # One WARNING event per gauge lifetime: a permanently
                # broken sampler used to return [] forever, silently.
                if not self._fn_warned:
                    self._fn_warned = True
                    from .events import emit

                    emit("WARNING", "metrics",
                         f"callback gauge {self.name} sampler raised; "
                         f"series suppressed until it recovers: {exc!r}",
                         kind="metrics.sampler_error", metric=self.name)
                return []
            # A callback may honor tag_keys by returning tagged samples:
            # an iterable of (tags_dict, value) pairs. A bare number stays
            # the single untagged series.
            if isinstance(sampled, (int, float)):
                return [({}, float(sampled))]
            return [(dict(tags or {}), float(value)) for tags, value in sampled]
        with self._lock:
            return [(dict(k), v) for k, v in self._values.items()]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, description="", boundaries: Sequence[float] = (), tag_keys=()):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries) or [0.01, 0.1, 1.0, 10.0]
        self._counts: Dict[tuple, List[int]] = {}
        self._sums: Dict[tuple, float] = {}
        self._totals: Dict[tuple, int] = {}

    def observe(self, value: float, tags: Optional[TagDict] = None) -> None:
        key = _tags_key(tags)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.boundaries) + 1))
            counts[bisect.bisect_left(self.boundaries, value)] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def collect(self):
        with self._lock:
            out = []
            for key, counts in self._counts.items():
                out.append(
                    (dict(key), {
                        "buckets": list(zip(self.boundaries, counts)),
                        "sum": self._sums[key],
                        "count": self._totals[key],
                    })
                )
            return out


class MetricsRegistry:
    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> None:
        with self._lock:
            self._metrics[metric.name] = metric

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    def prometheus_text(self) -> str:
        """Prometheus exposition format (the /metrics payload)."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            lines.append(f"# HELP {m.name} {_escape_help(m.description)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for tags, value in m.collect():
                label = (
                    "{" + ",".join(
                        f'{k}="{_escape_label(v)}"' for k, v in sorted(tags.items())
                    ) + "}"
                    if tags
                    else ""
                )
                if m.kind == "histogram":
                    # bucket lines carry the metric's tag labels plus le, so
                    # tagged histograms stay distinct series
                    tag_part = "".join(
                        f'{k}="{_escape_label(v)}",' for k, v in sorted(tags.items())
                    )
                    cumulative = 0
                    for bound, count in value["buckets"]:
                        cumulative += count
                        lines.append(
                            f'{m.name}_bucket{{{tag_part}le="{bound}"}} {cumulative}'
                        )
                    lines.append(
                        f'{m.name}_bucket{{{tag_part}le="+Inf"}} {value["count"]}'
                    )
                    lines.append(f"{m.name}_sum{label} {value['sum']}")
                    lines.append(f"{m.name}_count{label} {value['count']}")
                else:
                    lines.append(f"{m.name}{label} {value}")
        return "\n".join(lines) + "\n"


_REGISTRY: Optional[MetricsRegistry] = None
_REG_LOCK = threading.Lock()


def _registry() -> MetricsRegistry:
    global _REGISTRY
    with _REG_LOCK:
        if _REGISTRY is None:
            _REGISTRY = MetricsRegistry()
        return _REGISTRY


def registry() -> MetricsRegistry:
    return _registry()


def get_or_create_counter(name: str, description: str = "",
                          tag_keys: Sequence[str] = ()) -> Counter:
    """Idempotent Counter accessor for emitters that may re-run (runtime
    re-init, module reload): returns the registered series instead of
    shadowing it with a fresh zeroed one."""
    existing = _registry().get(name)
    if isinstance(existing, Counter):
        return existing
    return Counter(name, description, tag_keys)


def get_or_create_gauge(name: str, description: str = "",
                        tag_keys: Sequence[str] = (),
                        fn: Optional[Callable[[], Any]] = None) -> Gauge:
    """Idempotent Gauge accessor (see get_or_create_counter)."""
    existing = _registry().get(name)
    if isinstance(existing, Gauge):
        return existing
    return Gauge(name, description, tag_keys, fn=fn)


# Shared boundaries for per-phase step-time histograms
# (raytpu_train_step_seconds{run,bucket}, train/steplog): phase durations
# span sub-millisecond host bookkeeping up to multi-second checkpoint
# saves, so the grid is log-spaced across five decades.
STEP_SECONDS_BOUNDARIES = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def get_or_create_histogram(name: str, description: str = "",
                            boundaries: Sequence[float] = (),
                            tag_keys: Sequence[str] = ()) -> Histogram:
    """Idempotent Histogram accessor (see get_or_create_counter) — the
    span-derived latency observers run on every task/request, so they
    must hit the registered series, never shadow it with a zeroed one."""
    existing = _registry().get(name)
    if isinstance(existing, Histogram):
        return existing
    return Histogram(name, description, boundaries, tag_keys)


def register_runtime_gauges() -> None:
    """Callback gauges over live runtime internals (scrape-time sampling)."""
    from ..core import runtime as rt

    def usage(key):
        def sample():
            if not rt.is_initialized():
                return 0.0
            return float(rt.get_runtime().object_store.usage()[key])

        return sample

    Gauge("raytpu_object_store_host_bytes", "host-tier bytes", fn=usage("host_bytes"))
    Gauge("raytpu_object_store_num_objects", "objects in store", fn=usage("num_objects"))

    def tasks_finished():
        if not rt.is_initialized():
            return 0.0
        return float(len(rt.get_runtime().task_events()))

    Gauge("raytpu_tasks_finished_total", "completed task events", fn=tasks_finished)


# ------------------------------------------------------ head-side federation


def _inject_label(line: str, key: str, value: str) -> str:
    """Add one label to a Prometheus sample line. Label VALUES may
    contain spaces/braces inside quotes, but metric NAMES cannot — so
    the first '{' (when it precedes the first space) marks an existing
    label set, else the first space splits name from value."""
    brace = line.find("{")
    space = line.find(" ")
    pair = f'{key}="{_escape_label(value)}"'
    if brace != -1 and (space == -1 or brace < space):
        return f"{line[:brace + 1]}{pair},{line[brace + 1:]}"
    if space == -1:
        return line  # malformed; pass through untouched
    return f"{line[:space]}{{{pair}}}{line[space:]}"


def merge_cluster_expositions(parts: Dict[str, str],
                              label: str = "node_id") -> str:
    """Merge per-node Prometheus expositions into ONE parseable payload:
    every sample line gains a `node_id` label, HELP/TYPE headers are
    emitted once per metric family, and each family's samples stay
    grouped under its header (the exposition-format grouping rule).

    `parts` maps node id hex -> that node's /metrics text (the
    `metrics_snapshot` RPC payload)."""
    families: List[str] = []          # first-seen order
    headers: Dict[str, List[str]] = {}  # family -> [# HELP, # TYPE]
    samples: Dict[str, List[str]] = {}  # family -> labeled sample lines
    for node_hex, text in parts.items():
        family = None
        for line in (text or "").splitlines():
            if not line.strip():
                continue
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                name = line.split(" ", 3)[2]
                if name not in headers:
                    headers[name] = []
                    families.append(name)
                    samples[name] = []
                # keep the first node's header text (identical by
                # construction; divergence would mean version skew)
                if len(headers[name]) < 2 and line not in headers[name]:
                    headers[name].append(line)
                family = name
                continue
            labeled = _inject_label(line, label, node_hex)
            if family is not None:
                samples[family].append(labeled)
            else:  # headerless line (foreign exporter): own family
                name = line.split("{", 1)[0].split(" ", 1)[0]
                if name not in headers:
                    headers[name] = []
                    families.append(name)
                    samples[name] = []
                samples[name].append(labeled)
    lines: List[str] = []
    for fam in families:
        lines.extend(headers[fam])
        lines.extend(samples[fam])
    return "\n".join(lines) + "\n"


def cluster_prometheus_text() -> str:
    """The /metrics/cluster payload without a cluster: this process's
    registry labelled with the head node's id ("local" outside a
    runtime), as JAX's answer without one. The fan-out over node agents
    comes with ROADMAP A6b (federation)."""
    from ..core import runtime as rt

    local_text = registry().prometheus_text()
    if not rt.is_initialized():
        return merge_cluster_expositions({"local": local_text})
    local_hex = rt.get_runtime().scheduler.head_node().node_id.hex()
    return merge_cluster_expositions({local_hex: local_text})


def start_metrics_server(host: str = "127.0.0.1", port: int = 0) -> int:
    """Expose /metrics (this process) and /metrics/cluster (the same
    series, node_id-labeled: `cluster_prometheus_text`); returns the
    bound port."""
    import socketserver
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            path = self.path.rstrip("/") or "/metrics"
            if path == "/metrics/cluster":
                body = cluster_prometheus_text().encode()
            elif path in ("", "/metrics"):
                body = registry().prometheus_text().encode()
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    class Server(ThreadingHTTPServer):
        daemon_threads = True

        def server_bind(self):
            # skip getfqdn (hangs without DNS egress)
            socketserver.TCPServer.server_bind(self)
            self.server_name = self.server_address[0]
            self.server_port = self.server_address[1]

    server = Server((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True, name="metrics-http")
    thread.start()
    return server.server_address[1]
