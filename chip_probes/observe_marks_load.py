"""Probe: the observe phase's marks on / off wall ratio, alone and under
host CPU load from busy-loop processes, after the serve phases that
precede it in chip_smoke.py. Needs one GPU.

    python3 chip_probes/observe_marks_load.py   (from the repository root)
"""
import multiprocessing as mp
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402


def hog(deadline):
    x = 0
    while time.time() < deadline:
        x += 1


def marks(engine, prompts, label, n=2):
    for i in range(n):
        try:
            cs._observe_marks_cost(engine, prompts, {})
            print(f"[probe] {label} #{i}: within bound", flush=True)
        except AssertionError as exc:
            print(f"[probe] {label} #{i}: {exc}", flush=True)


def main():
    t0 = time.perf_counter()
    cs.phase_env()
    cs.phase_build()
    server, config, prompts, outs, *_rest, direct = cs.phase_serve()
    engine = server.engine
    marks(engine, prompts, "after serve", 1)
    cs.phase_check(server, config, prompts, outs)
    cs.phase_spec(server, config, prompts, outs)
    cs.phase_dense(server, config, prompts, outs)
    cs.phase_overload(server, config)
    cs.phase_deploy(server, config, prompts, outs, direct)
    marks(engine, prompts, "after deploy, no load", 2)
    for n in (4, 8):
        ctx = mp.get_context("spawn")
        hogs = [ctx.Process(target=hog, args=(time.time() + 300,)) for _ in range(n)]
        for h in hogs:
            h.start()
        try:
            marks(engine, prompts, f"{n} busy processes", 2)
        finally:
            for h in hogs:
                h.terminate()
                h.join()
    marks(engine, prompts, "after load, no load", 1)
    server.shutdown()
    print(f"[probe] total {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
