"""Profiling plane: device/host capture + step cost accounting.

Port of `ray_tpu/util/profiling.py`, on torch.profiler where JAX has
jax.profiler and XLA's cost model:

1. The **device trace** (`start_device_trace` / `stop_device_trace` /
   `device_trace`) with typed errors (`ProfilingError`): a
   `torch.profiler.profile` over CUDA and CPU activity when a card is
   present (CPU alone without one, or for a `device="cpu"` caller),
   exported as a chrome trace (`*.trace.json.gz`); `annotate` and
   `step_annotation` name host regions in it; `capture_local_profile` is a
   time-boxed device trace plus a host-side sampling profile
   (`HostProfiler`), collected as bounded artifact bytes. Kineto's CUPTI
   records every kernel of the process, whatever thread launched it; host
   ops of other threads may be missing. The profiler may drop records of
   CUDA-graph kernels but never adds any. JAX's profiler server
   (`jax.profiler.start_server`) has no torch counterpart:
   `start_profiler_server` raises NotImplementedError and
   `profiler_server_port()` is None.
2. The **cost layer**: `step_cost` counts the FLOPs and bytes of one call
   of a step, `device_peaks` prices them against the card, and `roofline`
   turns (cost, step time) into MFU and roofline fractions.
3. The **ProfileStore**: captured artifacts registered on the runtime so
   `state.list_profiles()` / `get_profile()` reach them, and `trace_dump`
   merges a capture's device events into the Perfetto export
   (`load_device_trace_events` aligns them to the wall clock through the
   trace's own base time).

JAX reads `compiled.cost_analysis()`, XLA's count of the compiled program;
PyTorch has no compiled program to ask. `step_cost` therefore runs the
step once on meta tensors (shapes, no data, no device work) under a
`TorchDispatchMode` that counts each aten op:
- FLOPs by `torch.utils.flop_counter`'s formulas (the matrix products);
- bytes as the op's tensor inputs read plus its outputs written once
  (views and uninitialised allocations move nothing), the sum XLA's
  "bytes accessed" makes per op;
- the hand-written kernels are custom ops (`ops/attention.py`,
  `ops/ragged_paged_attention.py`): on meta tensors their fakes run, and
  their flop formulas count their products (XLA counts nothing inside a
  Pallas call).
The run works on meta copies of the arguments, so the live state (which
the port's steps update in place) is not touched. Elementwise arithmetic
has no flop formula and adds bytes only: the FLOPs are the products'.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import json
import os
import socket
import sys
import tempfile
import threading
import time
from collections import OrderedDict, defaultdict
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..core.exceptions import ProfilingError
from .tree import flatten, rebuild

# ----------------------------------------------------- device trace (typed)

# Module-level latch: one trace per process. The latch raises typed errors
# before touching the profiler, and lets captures report "busy" instead of
# colliding.
_trace_lock = threading.Lock()
_trace_logdir: Optional[str] = None
_trace_prof: Optional[profile] = None


def _activities(device: Optional[str]) -> List[ProfilerActivity]:
    """CUDA + CPU activity when a card is present (or asked for), CPU alone
    for a `device="cpu"` caller or without a card."""
    want_cuda = torch.cuda.is_available() if device is None else device == "cuda"
    if want_cuda and not torch.cuda.is_available():
        raise ProfilingError("a CUDA device trace was asked for, but there is no CUDA device")
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA] if want_cuda else [ProfilerActivity.CPU]


def start_device_trace(logdir: str, *, perfetto: bool = True,
                       device: Optional[str] = None) -> None:
    """Begin capturing a torch.profiler trace whose chrome-trace export
    lands in `logdir` at stop (view with ui.perfetto.dev; `perfetto` is
    JAX's flag and the export is Perfetto-loadable either way). `device`
    None traces the card's kernels when a card is present; "cpu" traces
    host ops only. Raises `ProfilingError` when a trace is already
    active or the profiler fails to start."""
    global _trace_logdir, _trace_prof
    with _trace_lock:
        if _trace_logdir is not None:
            raise ProfilingError(
                f"a device trace into {_trace_logdir!r} is already active; "
                f"stop it before starting another"
            )
        prof = profile(activities=_activities(device))
        try:
            prof.start()
        except Exception as exc:  # noqa: BLE001 - typed boundary
            raise ProfilingError(f"torch.profiler failed to start: {exc!r}") from exc
        _trace_logdir, _trace_prof = logdir, prof


def stop_device_trace() -> None:
    """Stop the active device trace and export it into its logdir as
    `<host>.<pid>.trace.json.gz`. Raises `ProfilingError` when no trace is
    active or the export fails."""
    global _trace_logdir, _trace_prof
    with _trace_lock:
        if _trace_logdir is None:
            raise ProfilingError("no active device trace to stop")
        logdir, prof = _trace_logdir, _trace_prof
        _trace_logdir = _trace_prof = None
        try:
            prof.stop()
            os.makedirs(logdir, exist_ok=True)
            raw = os.path.join(logdir, "trace.json")
            prof.export_chrome_trace(raw)
            with open(raw, "rb") as src:
                data = src.read()
            os.remove(raw)
            name = f"{socket.gethostname()}.{os.getpid()}.trace.json.gz"
            with gzip.open(os.path.join(logdir, name), "wb") as dst:
                dst.write(data)
        except Exception as exc:  # noqa: BLE001 - typed boundary
            raise ProfilingError(f"stopping the device trace failed: {exc!r}") from exc


def device_trace_active() -> bool:
    return _trace_logdir is not None


@contextlib.contextmanager
def device_trace(logdir: str, *, device: Optional[str] = None) -> Iterator[None]:
    """Context manager form: everything dispatched inside is captured.
    Synchronise inside the block: kernels still running when the trace
    stops are cut off."""
    start_device_trace(logdir, device=device)
    try:
        yield
    finally:
        stop_device_trace()


# --------------------------------------------------------- profiler server


def start_profiler_server(port: int = 9999):
    """JAX serves a live profiling endpoint (`jax.profiler.start_server`,
    attached to with TensorBoard/xprof); torch.profiler has no
    counterpart, so this raises. Capture with `device_trace` or
    `state.profile()` instead."""
    raise NotImplementedError(
        "start_profiler_server: torch.profiler has no live profiler server "
        "(jax.profiler.start_server); capture with device_trace or state.profile()"
    )


def profiler_server_port() -> Optional[int]:
    """Port of the live profiler server: always None (see
    start_profiler_server)."""
    return None


# ----------------------------------------------------------- annotations


def annotate(name: str, **kwargs: Any):
    """Named host-side region that shows up in torch.profiler traces (the
    counterpart of jax.profiler.TraceAnnotation); keyword metadata rides
    as the region's args string."""
    args = ",".join(f"{k}={v}" for k, v in sorted(kwargs.items())) or None
    return record_function(name, args)


@contextlib.contextmanager
def step_annotation(step: int, name: str = "train") -> Iterator[None]:
    """Marks a step boundary in the trace as the region `<name>#<step>`
    (the counterpart of jax.profiler.StepTraceAnnotation)."""
    with record_function(f"{name}#{step}"):
        yield


# ------------------------------------------------------ host-side profiling


class HostProfiler:
    """Time-boxed sampling profiler over EVERY thread of this process
    (``sys._current_frames()`` at a fixed interval). cProfile instruments
    only the installing thread, which is useless for profiling work that
    happens on engine/actor/task threads — sampling sees them all,
    stdlib-only, at bounded overhead."""

    def __init__(self, interval_s: float = 0.005):
        self.interval_s = interval_s
        self._counts: Dict[Tuple[str, str], int] = {}
        self._samples = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ray_tpu_torch-host-profiler"
        )
        self._thread.start()

    def _loop(self) -> None:
        names = {}
        while not self._stop.wait(self.interval_s):
            if not names:
                names = {t.ident: t.name for t in threading.enumerate()}
            self._samples += 1
            for tid, frame in list(sys._current_frames().items()):
                if frame is None:
                    continue
                stack: List[str] = []
                depth = 0
                while frame is not None and depth < 24:
                    code = frame.f_code
                    stack.append(
                        f"{os.path.basename(code.co_filename)}:"
                        f"{frame.f_lineno}:{code.co_name}"
                    )
                    frame = frame.f_back
                    depth += 1
                key = (names.get(tid, str(tid)), ";".join(reversed(stack)))
                self._counts[key] = self._counts.get(key, 0) + 1

    def stop(self) -> str:
        """Stop sampling; returns a text report: per-thread top stacks by
        sample count (a flamegraph collapses from the same lines)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        lines = [
            f"# host sampling profile: {self._samples} samples @ "
            f"{self.interval_s * 1e3:.1f}ms"
        ]
        ranked = sorted(self._counts.items(), key=lambda kv: -kv[1])[:200]
        for (tname, stack), count in ranked:
            lines.append(f"{count}\t{tname}\t{stack}")
        return "\n".join(lines) + "\n"


# --------------------------------------------------------- local capture

# latch naming the capture currently running in this process (None = idle)
_capture_lock = threading.Lock()
_active_capture: Optional[str] = None
# summary of the most recent finished capture (node_snapshot)
_last_capture: Optional[Dict[str, Any]] = None


def capture_local_profile(duration_s: Optional[float] = None, *,
                          device: bool = True, host: bool = True,
                          profile_id: str = "",
                          workload: Optional[Callable[[], Any]] = None,
                          ) -> Dict[str, Any]:
    """One time-boxed capture of THIS process: a torch.profiler device
    trace (the card's kernels when a card is present) and/or a host
    sampling profile, returned as bounded artifact bytes — the whole of
    the in-process `profile_capture`.

    Returns {"meta": {...}, "artifacts": {name: bytes}}. As in JAX, a
    degraded capture (the profiler busy or failing) does not raise: the
    meta's "device" records what happened ("ok", "busy: ...", "error:
    ..."), and a caller that needs the card's trace checks it. The meta's
    `started_at` is taken once the profiler runs, so the window
    [started_at, started_at + duration_s] is what the capture covers."""
    import shutil

    from ..core.config import cfg

    global _active_capture, _last_capture
    if duration_s is None:
        duration_s = cfg.profile_default_duration_s
    duration_s = max(0.05, float(duration_s))
    meta: Dict[str, Any] = {
        "profile_id": profile_id,
        "started_at": time.time(),
        "duration_s": duration_s,
        "pid": os.getpid(),
        "profiler_port": profiler_server_port(),
        "device": "skipped",
        "host": "skipped",
    }
    artifacts: Dict[str, bytes] = {}
    with _capture_lock:
        if _active_capture is not None:
            meta["device"] = meta["host"] = f"busy: capture {_active_capture}"
            return {"meta": meta, "artifacts": artifacts}
        _active_capture = profile_id or "local"
    logdir = None
    sampler = None
    try:
        if device:
            logdir = tempfile.mkdtemp(prefix="ray_tpu_torch_prof_")
            try:
                start_device_trace(logdir)
                meta["device"] = "ok"
            except ProfilingError as exc:
                meta["device"] = f"error: {exc}"
                shutil.rmtree(logdir, ignore_errors=True)
                logdir = None
        if host:
            sampler = HostProfiler(interval_s=cfg.profile_host_sample_s)
            sampler.start()
            meta["host"] = "ok"
        # the window opens once the profiler runs (starting it can take a
        # while): what it recorded lies in [started_at, started_at + duration]
        meta["started_at"] = time.time()
        if workload is not None:
            deadline = time.time() + duration_s
            while time.time() < deadline:
                workload()
        else:
            time.sleep(duration_s)
    finally:
        if logdir is not None:
            try:
                stop_device_trace()
                artifacts.update(_collect_trace_artifacts(
                    logdir, cfg.profile_max_artifact_bytes
                ))
            except ProfilingError as exc:
                meta["device"] = f"error: {exc}"
            shutil.rmtree(logdir, ignore_errors=True)
        if sampler is not None:
            artifacts["host_profile.txt"] = sampler.stop().encode()
        with _capture_lock:
            _active_capture = None
    meta["bytes"] = sum(len(b) for b in artifacts.values())
    meta["artifact_names"] = sorted(artifacts)
    _last_capture = {
        "profile_id": profile_id, "ts": meta["started_at"],
        "duration_s": duration_s, "bytes": meta["bytes"],
        "device": meta["device"], "host": meta["host"],
    }
    return {"meta": meta, "artifacts": artifacts}


def _collect_trace_artifacts(logdir: str, max_bytes: int) -> Dict[str, bytes]:
    """Gather the profiler's output files as {relative_name: bytes},
    bounded: the chrome traces (the mergeable/viewable ones) first, then
    everything else by size ascending."""
    files: List[Tuple[str, str]] = []
    for root, _dirs, names in os.walk(logdir):
        for name in names:
            full = os.path.join(root, name)
            files.append((os.path.relpath(full, logdir), full))
    files.sort(key=lambda t: (
        0 if t[0].endswith(".trace.json.gz") else 1,
        os.path.getsize(t[1]),
    ))
    out: Dict[str, bytes] = {}
    budget = max_bytes
    for rel, full in files:
        size = os.path.getsize(full)
        if size > budget:
            continue
        with open(full, "rb") as f:
            out[rel.replace(os.sep, "/")] = f.read()
        budget -= size
    return out


def node_snapshot() -> Dict[str, Any]:
    """This process's profiling status (`state.status_report(verbose=
    True)`): the profiler-server port (None: see start_profiler_server),
    whether a capture is running, and the last finished capture's
    summary."""
    with _capture_lock:
        active = _active_capture
    return {
        "server_port": profiler_server_port(),
        "active_capture": active,
        "last_capture": dict(_last_capture) if _last_capture else None,
    }


# ------------------------------------------------- device trace -> Perfetto

# chrome-trace categories of the card's own activity in a Kineto trace
_DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})


def load_device_trace_events(artifacts: Dict[str, bytes], *,
                             started_at: float, lane_prefix: str = "device",
                             max_events: Optional[int] = None,
                             ) -> List[Dict[str, Any]]:
    """Parse a capture's chrome-trace artifact (`*.trace.json.gz`) into
    trace events aligned to wall-clock time, ready to merge into the span
    export. torch.profiler's timestamps are microseconds after the trace's
    own base time (`baseTimeNanoseconds`, wall-clock nanoseconds), so each
    event is offset by that base; `started_at` (the capture's start, JAX's
    offset) is not needed for it. Lanes become "<lane_prefix>:<process
    name>", so runtime spans and the card's kernels sit side by side in
    one Perfetto view. Events are capped (the card's activity first, then
    the longest) to keep the export loadable. A trace without its base
    time raises `ProfilingError`: no offset is guessed."""
    from ..core.config import cfg

    if max_events is None:
        max_events = cfg.profile_merge_max_events
    raw = None
    for name in sorted(artifacts):
        if name.endswith(".trace.json.gz"):
            raw = artifacts[name]
            break
    if raw is None:
        return []
    try:
        data = json.loads(gzip.decompress(raw))
    except Exception as exc:  # noqa: BLE001 - corrupt artifact boundary
        raise ProfilingError(f"undecodable device trace artifact: {exc!r}") from exc
    if not isinstance(data, dict) or "baseTimeNanoseconds" not in data:
        raise ProfilingError("the device trace carries no baseTimeNanoseconds: "
                             "its events cannot be placed on the wall clock")
    offset_us = float(data["baseTimeNanoseconds"]) / 1e3
    events = data.get("traceEvents", [])
    proc_names: Dict[Any, str] = {}
    thread_names: Dict[Tuple[Any, Any], str] = {}
    for e in events:
        if e.get("ph") != "M":
            continue
        if e.get("name") == "process_name":
            proc_names[e.get("pid")] = e.get("args", {}).get("name", "")
        elif e.get("name") == "thread_name":
            thread_names[(e.get("pid"), e.get("tid"))] = (
                e.get("args", {}).get("name", "")
            )
    xs = [e for e in events if e.get("ph") == "X"]
    # the card's tracks are the point; host tracks only ride along when
    # there is budget left after them
    xs.sort(key=lambda e: (
        0 if e.get("cat") in _DEVICE_CATS else 1,
        -float(e.get("dur", 0.0)),
    ))
    xs = xs[:max_events]
    out: List[Dict[str, Any]] = []
    for e in xs:
        pid = e.get("pid")
        proc = proc_names.get(pid) or str(pid)
        out.append({
            "name": e.get("name", "?"),
            "cat": "device" if e.get("cat") in _DEVICE_CATS else "host",
            "ph": "X",
            "ts": offset_us + float(e.get("ts", 0.0)),
            "dur": float(e.get("dur", 0.0)),
            "pid": f"{lane_prefix}:{proc}",
            "tid": thread_names.get((pid, e.get("tid")), str(e.get("tid"))),
            "args": e.get("args", {}),
        })
    out.sort(key=lambda e: e["ts"])
    return out


# ------------------------------------------------------------ profile store


class ProfileStore:
    """The runtime's registry of captures: bounded LRU of records (meta +
    per-node artifact bytes). The state API (`list_profiles`,
    `get_profile`, `profile_artifact`) reads from here; capture metas are
    also put in the control store's `_profiles` table."""

    def __init__(self, capacity: Optional[int] = None):
        from ..core.config import cfg

        self._capacity = capacity or cfg.profile_store_capacity
        self._records: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._artifacts: Dict[str, Dict[Tuple[str, str], bytes]] = {}
        self._lock = threading.Lock()

    def add(self, record: Dict[str, Any],
            artifacts: Dict[Tuple[str, str], bytes]) -> None:
        with self._lock:
            pid = record["profile_id"]
            self._records[pid] = record
            self._artifacts[pid] = dict(artifacts)
            while len(self._records) > self._capacity:
                old, _ = self._records.popitem(last=False)
                self._artifacts.pop(old, None)

    def list(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._records.values()]

    def get(self, profile_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            rec = self._records.get(profile_id)
            return dict(rec) if rec is not None else None

    def artifact(self, profile_id: str, node_hex: str,
                 name: str) -> Optional[bytes]:
        with self._lock:
            return self._artifacts.get(profile_id, {}).get((node_hex, name))

    def artifacts_for(self, profile_id: str,
                      node_hex: Optional[str] = None) -> Dict[str, bytes]:
        """All of one capture's artifacts (optionally one node's), keyed
        `node_hex/name` — what the Perfetto merge reads."""
        with self._lock:
            blobs = self._artifacts.get(profile_id, {})
            return {
                f"{nh}/{name}": data
                for (nh, name), data in blobs.items()
                if node_hex is None or nh == node_hex
            }


# ----------------------------------------------------- cost model / roofline

# Published peaks (NVIDIA's data sheet, H100 SXM, dense, no sparsity):
# bf16 tensor-core FLOP/s and HBM3 bandwidth. Not measured; the same
# numbers chip_smoke.py prices its kernel bounds with.
_PEAK_FLOPS: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989e12,
}
_PEAK_HBM_BPS: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
# Unknown devices (and the CPU) get nominal peaks so the fractions stay
# defined; `estimated` flags them as not a hardware claim.
_FALLBACK_PEAK_FLOPS = 1e12
_FALLBACK_HBM_BPS = 100e9


def device_peaks(device: Any = None) -> Dict[str, Any]:
    """Peak FLOPs/s and HBM bandwidth of the given device (default: the
    current CUDA device when there is one). `estimated=True` marks the
    fallback used for unknown kinds and the CPU."""
    kind = "unknown"
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else None
    )
    if dev is not None and dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
    elif dev is not None and dev.type == "cpu":
        kind = "cpu"
    known = kind in _PEAK_FLOPS
    return {
        "device_kind": kind,
        "peak_flops": _PEAK_FLOPS.get(kind, _FALLBACK_PEAK_FLOPS),
        "peak_hbm_bps": _PEAK_HBM_BPS.get(kind, _FALLBACK_HBM_BPS),
        "estimated": not known,
    }


@dataclasses.dataclass
class StepCost:
    """The counted cost of one call of a step, normalized as JAX's
    `cost_analysis()` one. `flops` / `bytes_accessed` are per device per
    call (one device here); `buckets` holds each op's FLOPs and bytes
    under "flops <op>" / "bytes <op>" (a kernel under its custom op's
    name, "ray_tpu_torch.flash_attention_fwd")."""

    flops: float
    bytes_accessed: float
    buckets: Dict[str, float]
    device_kind: str
    n_devices: int
    peak_flops: float           # per device
    peak_hbm_bps: float         # per device
    estimated_peaks: bool

    @property
    def total_flops(self) -> float:
        return self.flops * self.n_devices

    @property
    def total_bytes(self) -> float:
        return self.bytes_accessed * self.n_devices

    def top_buckets(self, k: int = 5) -> List[Tuple[str, float]]:
        ranked = sorted(self.buckets.items(), key=lambda kv: -abs(kv[1]))
        return ranked[:k]


# allocations that write nothing, and a reshape of a fresh tensor: no bytes move
_NO_TRAFFIC = frozenset(
    getattr(torch.ops.aten, name)
    for name in ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                 "_unsafe_view")
)


def _nbytes(values) -> int:
    leaves, _ = tree_flatten(values)
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


class _CostCount(TorchDispatchMode):
    """Counts FLOPs (flop_counter's formulas) and bytes (tensor inputs read
    + outputs written) of every op dispatched inside it: aten's and the
    kernels' custom ops."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.buckets: Dict[str, float] = defaultdict(float)

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        if flops:
            self.buckets[f"flops {name}"] += flops
        if nbytes:
            self.buckets[f"bytes {name}"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        flops = float(formula(*args, **kwargs, out_val=out)) if formula is not None else 0.0
        nbytes = 0
        if not func.is_view and packet not in _NO_TRAFFIC:
            schema = func._schema
            # reads: every tensor argument; writes: the arguments the op
            # mutates (in place, or out=) and the fresh outputs it returns
            nbytes = _nbytes((args, kwargs))
            named = dict(zip((a.name for a in schema.arguments), args))
            named.update(kwargs)
            for arg in schema.arguments:
                if arg.alias_info is not None and arg.alias_info.is_write:
                    nbytes += _nbytes(named.get(arg.name))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for ret, value in zip(schema.returns, outs):
                if ret.alias_info is None:
                    nbytes += _nbytes(value)
        self.add(str(packet).replace("aten.", ""), flops, nbytes)
        return out


def _meta_leaf(_path: str, leaf: Any) -> Any:
    """A meta tensor of the leaf's shape and dtype (a leaf that requires
    grad keeps requiring it); other values are kept."""
    if not isinstance(leaf, torch.Tensor):
        return leaf
    out = torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
    return out.requires_grad_(True) if leaf.requires_grad and leaf.is_leaf else out


def step_cost(fn: Callable, *args: Any, **kwargs: Any) -> StepCost:
    """FLOPs/bytes of one call of `fn(*args, **kwargs)`, counted on meta
    copies of the arguments (so `fn` must run on meta tensors: build a
    step with device="meta"), priced against the device the arguments'
    tensors live on. One eager run of the step on the host: callers cache
    the result."""
    device = next((leaf.device for _, leaf in flatten((args, kwargs))
                   if isinstance(leaf, torch.Tensor)), None)
    meta_args, meta_kwargs = rebuild((args, kwargs), _meta_leaf)
    count = _CostCount()
    try:
        with count:
            fn(*meta_args, **meta_kwargs)
    except Exception as exc:  # noqa: BLE001 - typed boundary
        raise ProfilingError(f"counting the step failed: {exc!r}") from exc
    if count.flops <= 0 and count.bytes <= 0:
        raise ProfilingError("the count found no flops/bytes in this step")
    peaks = device_peaks(device)
    return StepCost(
        flops=count.flops,
        bytes_accessed=count.bytes,
        buckets=dict(count.buckets),
        device_kind=peaks["device_kind"],
        n_devices=1,
        peak_flops=peaks["peak_flops"],
        peak_hbm_bps=peaks["peak_hbm_bps"],
        estimated_peaks=peaks["estimated"],
    )


def roofline(cost: StepCost, step_time_s: float) -> Dict[str, Any]:
    """Price one step against the roofline. `mfu` is the model-FLOPs
    utilization (achieved / peak matmul throughput), `hbm_fraction` the
    share of peak HBM bandwidth the step's byte traffic implies; whichever
    fraction is higher names the binding resource. Per-device cost over
    per-device peak: the step time is wall time."""
    if step_time_s <= 0:
        raise ProfilingError(f"step_time_s must be positive, got {step_time_s}")
    mfu = cost.flops / (step_time_s * cost.peak_flops)
    hbm = cost.bytes_accessed / (step_time_s * cost.peak_hbm_bps)
    return {
        "mfu": mfu,
        "hbm_fraction": hbm,
        "bound": "memory" if hbm > mfu else "compute",
        "flops_per_device": cost.flops,
        "total_flops": cost.total_flops,
        "bytes_per_device": cost.bytes_accessed,
        "step_time_s": step_time_s,
        "n_devices": cost.n_devices,
        "device_kind": cost.device_kind,
        "estimated_peaks": cost.estimated_peaks,
    }
