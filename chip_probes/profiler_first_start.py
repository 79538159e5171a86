"""Probe: how long a process's first profile capture (torch.profiler
over CPU + CUDA activity) holds its Python threads, with Llama-3-8B's paged engine
serving greedy requests meanwhile (torch_cluster_udfs.ClusterLLM, as a
node agent hosts it). Each variant runs in a process of its own, since
only a process's first start is in question:

- thread: no priming; the capture (profiling.capture_local_profile, 2 s)
  runs on a new thread, as an RPC handler does;
- main: no priming; the capture runs on the main thread;
- prime: the profiler's CPU + CUDA tracing started and stopped once
  (`prime`, no export) right after torch's import, before the process
  holds a CUDA context; the capture on a new thread;
- ctx: as prime, but once the process holds a CUDA context (one small
  tensor on the card) and before the engine is built;
- idle: one 0.2 s capture once the engine is built and idle, then the
  capture under traffic on a new thread.

Per variant: whether priming made a CUDA context, the priming's seconds,
decode tok/s before and after the capture, the capture's seconds, the
longest gap of a 10 ms ticker thread during the capture (the time the
other threads were held), and the K5 / K1 kernels in the capture's
trace. A capture that holds the threads for over 8 s dumps every
thread's stack to the variant's stderr. Needs one GPU.

    python3 chip_probes/profiler_first_start.py [variant ...]   (from the repository root)
"""
import gzip
import json
import os
import subprocess
import sys
import threading
import time

VARIANTS = ("thread", "prime", "main", "ctx", "idle")
CHILD_TIMEOUT_S = 200
CAPTURE_S = 2.0


def prime() -> bool:
    """Start and stop the profiler's CPU + CUDA tracing once, with no
    export and no CUDA context made: the stop skips the synchronize
    `torch.autograd.profiler.profile` does on exit."""
    import torch
    from torch.autograd import _disable_profiler
    from torch.autograd.profiler import profile as autograd_profile

    if not torch.cuda.is_available():
        return False
    prof = autograd_profile(use_device="cuda", use_kineto=True)
    prof._prepare_trace()
    prof._start_trace()
    _disable_profiler()
    return True


def child(variant: str) -> dict:
    import faulthandler

    import torch

    sys.path.insert(0, os.getcwd())
    from ray_tpu_torch.util import profiling

    out: dict = {"variant": variant}
    if variant == "ctx":
        torch.zeros(1, device="cuda")
    if variant in ("prime", "ctx"):
        t = time.perf_counter()
        out["primed"] = prime()
        out["prime_s"] = time.perf_counter() - t
        out["context_after_prime"] = torch.cuda.is_initialized()
        smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.split()
        out["in_compute_apps_after_prime"] = str(os.getpid()) in smi
    import numpy as np

    import chip_smoke as cs
    import torch_cluster_udfs as udfs
    from ray_tpu_torch.models import get_config

    config = get_config(cs.MODEL)
    rng = np.random.default_rng(cs.SEED)
    lengths = np.linspace(64, 900, cs.N_REQUESTS).astype(int)
    prompts = [rng.integers(0, config.vocab_size, n).tolist() for n in lengths]
    t = time.perf_counter()
    llm = udfs.ClusterLLM(cs.MODEL, cs.SEED, cs.N_REQUESTS)
    out["build_s"] = time.perf_counter() - t
    if variant == "idle":
        t = time.perf_counter()
        warm = profiling.capture_local_profile(0.2, host=False)
        out["idle_capture_s"] = time.perf_counter() - t
        out["idle_capture_device"] = warm["meta"]["device"]

    stop = threading.Event()
    ticks: list = []
    calls: list = []  # (t_done, decode tok/s)
    errors: list = []

    def ticker():
        while not stop.is_set():
            ticks.append(time.perf_counter())
            time.sleep(0.01)

    def serve():
        i = 0
        while not stop.is_set():
            try:
                res = llm.serve_once(prompts[i % len(prompts)], cs.MAX_TOKENS, cs.TAIL_GAP)
                calls.append((time.perf_counter(), res["decode_tok_s"]))
            except BaseException as exc:  # noqa: BLE001 - reported
                errors.append(repr(exc))
                return
            i += 1

    threads = [threading.Thread(target=ticker, daemon=True, name="ticker"),
               threading.Thread(target=serve, daemon=True, name="serve")]
    for th in threads:
        th.start()
    while len(calls) < 3 and not errors:
        time.sleep(0.05)
    box: dict = {}

    def capture():
        box["res"] = profiling.capture_local_profile(CAPTURE_S, host=False)

    faulthandler.dump_traceback_later(8.0, repeat=True, file=sys.stderr)
    t0 = time.perf_counter()
    if variant == "main":
        capture()
    else:
        th = threading.Thread(target=capture, name="capture")
        th.start()
        th.join(120)
    t1 = time.perf_counter()
    faulthandler.cancel_dump_traceback_later()
    out["capture_s"] = t1 - t0
    n_at_capture = len(calls)
    while len(calls) < n_at_capture + 2 and not errors:
        time.sleep(0.05)
    stop.set()
    for th in threads:
        th.join(120)
    inside = [b - a for a, b in zip(ticks, ticks[1:]) if b > t0 and a < t1]
    out["max_tick_gap_s"] = max(inside, default=None)
    out["decode_tok_s_before"] = [round(r, 1) for t, r in calls if t < t0]
    out["decode_tok_s_after"] = [round(r, 1) for t, r in calls if t > t1]
    out["errors"] = errors
    res = box.get("res")
    if res is None:
        out["capture"] = "did not return"
        return out
    out["capture_device"] = res["meta"]["device"]
    kernels = {"ragged": 0, "flash_fwd": 0, "device_events": 0}
    for name, data in res["artifacts"].items():
        if name.endswith(".trace.json.gz"):
            for e in json.loads(gzip.decompress(data)).get("traceEvents", []):
                if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
                    continue
                kernels["device_events"] += 1
                if "ragged" in e.get("name", "") and "combine" not in e["name"]:
                    kernels["ragged"] += 1
                elif "flash_fwd" in e.get("name", ""):
                    kernels["flash_fwd"] += 1
    out["trace"] = kernels
    return out


def main(variants) -> int:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    card = cs.phase_env()
    cs.phase_build()
    os.makedirs("chiprun_out", exist_ok=True)
    for v in variants:
        t = time.perf_counter()
        try:
            p = subprocess.run([sys.executable, __file__, "--child", v], capture_output=True,
                               text=True, timeout=CHILD_TIMEOUT_S)
            rc, stdout, stderr = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as exc:
            rc, stdout, stderr = "timeout", exc.stdout or "", exc.stderr or ""
            stdout = stdout.decode() if isinstance(stdout, bytes) else stdout
            stderr = stderr.decode() if isinstance(stderr, bytes) else stderr
        with open(f"chiprun_out/profiler_first_start.{v}.err", "w") as f:
            f.write(stderr)
        lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
        rec = json.loads(lines[-1]) if lines else {"variant": v}
        rec.update(rc=rc, wall_s=round(time.perf_counter() - t, 2))
        print(f"[{card}] {json.dumps(rec)}", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(child(sys.argv[2])), flush=True)
    else:
        sys.exit(main(sys.argv[1:] or VARIANTS))
