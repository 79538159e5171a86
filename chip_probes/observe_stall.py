"""Probe: which condition gives the serve run's ~0.15 s start stall.
A: timed runs back to back (gc.collect between); B: each after a
profiled repeat; C: each after a profiled repeat and a 3 s sleep.
Per run: wall, TTFT p50, GC pauses (count, sum, max by generation).
Needs one GPU.

    python3 chip_probes/observe_stall.py   (from the repository root)
"""
import gc
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

pauses = []
_t = {}


def _cb(phase, info):
    if phase == "start":
        _t["t"] = time.perf_counter()
    else:
        pauses.append((info["generation"], time.perf_counter() - _t.get("t", time.perf_counter())))


def run(engine, prompts, label, on):
    cs._marks_on(on)
    gc.collect()
    del pauses[:]
    wall, t_start, stamps, _ = cs._serve_run(engine, prompts)
    r = cs._rates(wall, t_start, stamps, cs.N_REQUESTS * cs.MAX_TOKENS)
    g2 = [d for g, d in pauses if g == 2]
    print(f"[probe2] {label} marks {'on ' if on else 'off'}: wall {wall:.4f} ttft_p50 "
          f"{r['ttft_p50_s']:.4f}; gc pauses {len(pauses)} sum {sum(d for _, d in pauses):.4f} "
          f"max {max((d for _, d in pauses), default=0):.4f}; gen2 {len(g2)} sum {sum(g2):.4f}",
          flush=True)
    return wall


def main():
    cs.phase_env()
    cs.phase_build()
    server, config, prompts, outs, *_rest, direct = cs.phase_serve()
    engine = server.engine
    gc.callbacks.append(_cb)
    walls = {}
    for label in ("A", "B", "C", "A"):
        ws = []
        for i in range(14):
            if label in ("B", "C"):
                gc.collect()
                cs._idle_share_of_repeat(lambda: cs._serve_run(engine, prompts))
                if label == "C":
                    time.sleep(3.0)
            ws.append(run(engine, prompts, label, i % 2 == 0))
        walls.setdefault(label, []).extend(ws)
        print(f"[probe2] {label}: runs over 0.62 s {sum(w > 0.62 for w in ws)} of {len(ws)}; "
              f"median {statistics.median(ws):.4f}", flush=True)
    gc.callbacks.remove(_cb)
    cs._marks_on(True)
    server.shutdown()


if __name__ == "__main__":
    main()
