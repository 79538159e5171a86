"""Probe: in a serve run with the ~0.15 s start stall, how many requests
the engine's first admission saw, and which passes ran (stats delta).
Needs one GPU.

    python3 chip_probes/observe_admits.py   (from the repository root)
"""
import gc
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

seen = []


def main():
    cs.phase_env()
    cs.phase_build()
    server, config, prompts, outs, *_rest, direct = cs.phase_serve()
    engine = server.engine
    orig_admit = engine._admit
    orig_drain = engine._drain_submits

    def admit():
        if seen is not None and len(seen) < 6:
            seen.append((time.perf_counter(), engine._queue.qsize(), len(engine._fair),
                         sum(1 for s in engine.slots if not s.free)))
        return orig_admit()

    engine._admit = admit
    for i in range(40):
        on = i % 2 == 0
        cs._marks_on(on)
        gc.collect()
        del seen[:]
        s0 = engine.stats()
        wall, t_start, stamps, _ = cs._serve_run(engine, prompts)
        d = cs._stats_delta(engine, s0)
        ttfts = sorted(round(st[0][0] - t_start, 3) for st in stamps)
        passes = {k[7:]: int(v) for k, v in d.items() if k.startswith("passes.") and v}
        first = [(round(t - t_start, 4), q, f, o) for t, q, f, o in seen[:4]]
        print(f"[probe3] {'on ' if on else 'off'} wall {wall:.4f} ttfts {ttfts} passes {passes} "
              f"first admits (t, queued, fair, occupied) {first}", flush=True)
    engine._admit = orig_admit
    cs._marks_on(True)
    server.shutdown()


if __name__ == "__main__":
    main()
