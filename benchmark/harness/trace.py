"""The device trace of a `--trace 1` run, read once into plain records.

`Trace.start()` / `stop()` run `torch.profiler` (CPU and CUDA activity)
over a window. After it stops, the profiler's raw events are read straight
from its results (`kineto_results.events()`), without building the
profiler's function-event tree, which costs seconds per hundred thousand
kernels. What is kept:

- every device activity (kernels, copies, sets) inside the window: name,
  start, duration and the correlation id of the host call that launched
  it (every kernel of one CUDA graph replay carries its
  `cudaGraphLaunch`'s id, so a replay's kernels group by it);
- the host's operations (CPU ops and annotations), to name what the host
  was doing in the device's longest idle gaps.

`busy_s` is the union of the device intervals within the window (seconds
in which some operation ran on the card), `window_s` the window's length
on the host clock, so 1 - busy / window is the idle share. The profiler
adds host time to every operation, so the idle share read here is an upper
bound of an untraced run's. Device times themselves are the card's.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
GROUPS = (  # a kernel's group by its name: the first match wins
    ("flash_bwd_dkv", ("flash_bwd_dkv",)),
    ("flash_bwd_dq", ("flash_bwd_dq",)),
    ("flash_fwd", ("flash_fwd",)),
    ("ragged", ("ragged",)),
    ("matmul", ("gemm", "nvjet", "sm90_xmma", "cutlass", "cublas")),
    ("optimizer (foreach)", ("multi_tensor_apply", "foreach")),
    ("softmax / logsumexp", ("softmax", "logsumexp")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized")),
    ("copy", ("memcpy", "memset", "copy")),
)


def group(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return "other"


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    correlation: int


@dataclasses.dataclass
class HostOp:
    name: str
    start_ns: int
    dur_ns: int


def short_name(name: str) -> str:
    """A kernel's name without its argument list and namespaces, at most
    90 characters (`void (anonymous namespace)::ragged_wgmma<128, true>(...)`
    -> `ragged_wgmma<128, true>`)."""
    name = re.sub(r"^void ", "", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):  # drop the argument list: the first "(" at depth 0
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    name = name[:cut]
    name = re.sub(r"\(anonymous namespace\)::", "", name)
    name = re.sub(r"^(at::native::|at::|cutlass::|)", "", name)
    return name[:90]


class Trace:
    """A window's device activity: `start()`, then `stop()`."""

    def __init__(self):
        self.device: List[DeviceOp] = []
        self.host: List[HostOp] = []
        self.t0_ns = 0  # the window on the profiler's clock (ns since the epoch)
        self.t1_ns = 0
        self.p0 = 0.0  # and on the host's perf_counter
        self.p1 = 0.0
        self.stop_s = 0.0  # host seconds the profiler's stop took
        self.read_s = 0.0  # host seconds spent reading its results
        self._prof = None

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def start(self, cpu: bool = True) -> "Trace":
        """Start the profiler (CUDA activity, and the host's operations
        with `cpu`); the window opens now."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        activities = ([ProfilerActivity.CPU] if cpu or not cuda else []) + (
            [ProfilerActivity.CUDA] if cuda else [])
        self._prof = profile(activities=activities)
        self._prof.start()
        self.t0_ns, self.p0 = time.time_ns(), time.perf_counter()
        return self

    def stop(self, until: Optional[float] = None) -> "Trace":
        """Stop the profiler and read its events up to `until` (the host's
        perf_counter; default now): the window is [start, until]. Call it
        only where no other thread launches work on the card: a stop under
        a running engine (a thread replaying graphs) never returned on the
        H100."""
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now_ns, now = time.time_ns(), time.perf_counter()
        self._prof.stop()
        self.stop_s = time.perf_counter() - now
        self.p1 = now if until is None else min(until, now)
        self.t1_ns = now_ns - round((now - self.p1) * 1e9)
        t = time.perf_counter()
        self._read(self._prof)
        self.read_s = time.perf_counter() - t
        self._prof = None
        return self

    def _read(self, prof) -> None:
        """Keep the device's kernels, copies and sets, and the host's
        operations; leave out the device-side copies of host annotations
        (a `record_function` range projected onto the card's timeline,
        which spans idle time too)."""
        from torch.autograd import DeviceType

        annotations = set()
        for e in prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            if start + dur < self.t0_ns or start > self.t1_ns or dur <= 0:
                continue
            kind = e.activity_type() if hasattr(e, "activity_type") else None
            user = e.is_user_annotation() if hasattr(e, "is_user_annotation") else False
            if e.device_type() == DeviceType.CUDA:
                if user or (kind is not None and kind not in DEVICE_KINDS):
                    continue
                self.device.append(DeviceOp(e.name(), start, dur, e.correlation_id()))
            elif kind in (None, "cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"):
                if user or kind == "user_annotation":
                    annotations.add(e.name())
                self.host.append(HostOp(e.name(), start, dur))
        self.device = sorted((op for op in self.device if op.name not in annotations),
                             key=lambda d: d.start_ns)

    # ------------------------------------------------------------ readings

    def busy_s(self) -> float:
        """Seconds inside the window in which some device operation ran."""
        total, end = 0, self.t0_ns
        for op in self.device:
            s, e = max(op.start_ns, end), min(op.start_ns + op.dur_ns, self.t1_ns)
            if e > s:
                total += e - s
            end = max(end, op.start_ns + op.dur_ns)
        return total / 1e9

    def seconds_by(self, match) -> float:
        """Device seconds of the operations whose name `match` accepts."""
        return sum(op.dur_ns for op in self.device if match(op.name)) / 1e9

    def count_by(self, match) -> int:
        return sum(1 for op in self.device if match(op.name))

    def by_group(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for op in self.device:
            out[group(op.name)] += op.dur_ns / 1e9
        return dict(out)

    def launches(self) -> Dict[int, List[DeviceOp]]:
        """Device operations by the host call that launched them (one CUDA
        graph replay, one eager launch)."""
        out: Dict[int, List[DeviceOp]] = defaultdict(list)
        for op in self.device:
            out[op.correlation].append(op)
        return out

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        by_name: Dict[str, int] = defaultdict(int)
        for op in self.device:
            by_name[op.name] += op.dur_ns
        total: Dict[str, float] = defaultdict(float)
        for name, ns in by_name.items():
            total[short_name(name) or "(unnamed)"] += ns / 1e9
        return sorted(total.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """The n longest stretches with nothing on the device, each named
        by the host operation that overlaps it most (`idle: <op>`), or
        `idle: no host op` where the trace holds none."""
        gaps: List[Tuple[int, int]] = []
        end = self.t0_ns
        for op in self.device:
            if op.start_ns > end:
                gaps.append((end, op.start_ns))
            end = max(end, op.start_ns + op.dur_ns)
        if self.t1_ns > end:
            gaps.append((end, self.t1_ns))
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(self.host, key=lambda h: h.start_ns)
        starts = [h.start_ns for h in host]
        longest = max((h.dur_ns for h in host), default=0)
        out = []
        for s, e in gaps[:n]:
            best: Optional[str] = None
            best_overlap = 0
            # only host ops that start late enough to reach the gap
            for h in host[bisect.bisect_left(starts, s - longest):bisect.bisect_right(starts, e)]:
                ov = min(e, h.start_ns + h.dur_ns) - max(s, h.start_ns)
                if ov > best_overlap:
                    best, best_overlap = h.name, ov
            out.append((f"idle: {best[:80] if best else 'no host op'}", (e - s) / 1e9))
        return out

    def breakdown(self) -> Dict[str, List[List]]:
        return {"device_ops": [[k, v] for k, v in self.top_ops()],
                "idle_gaps": [[k, v] for k, v in self.idle_gaps()]}
