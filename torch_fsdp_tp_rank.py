"""One rank of chip_smoke.py's `fsdp_tp` phase: FSDP and tensor-parallel
training on the card.

    (imported by the ranks of a MultihostWorkerGroup; not run directly)

`fsdp_tp_rank(config)` runs in each process of a `MultihostWorkerGroup`
(module-level, so the worker protocol's standard pickle sends it by
reference) and returns its numbers. `config["mode"]` picks the run:

- "gpt2_fsdp2_tp2": GPT-2 124M (f32 compute) on `MeshSpec(fsdp=2, tp=2)`
  with `override_rules(default_rules(), vocab=None)` (50257 does not
  divide by 2) through `create_train_state` / `make_train_step`, then a
  checkpoint of the sharded state restored and held bitwise;
- "gpt2_lmtrainer": a bare `LMTrainer` on GPT-2 124M (bf16 compute) in a
  gang of 2, which takes JAX's default mesh, fsdp = 2, fed the global
  batch (the trainer cuts its rows);
- "llama_tp2": Llama-3-8B's full width at `n_layers` layers (bf16) on
  `MeshSpec(tp=2)` with the default rules: vocab-parallel embedding and
  loss, 16 of 32 query and 4 of 8 kv heads per rank.

Every run starts from `init_params(config, seed)` on the card, as the
phase's one-process reference does, and step i takes the global batch
`config["tokens"][i]`, as the reference's step i does. Each step is
timed on the host clock to a device synchronisation, and split by the
step's wires (`step.spmd.stats()`, CUDA events around each collective):
the fsdp gather, the fsdp reduce-scatter, the tp all-reduces, the dp /
fsdp all-reduce of the gradients and the metrics' all-reduces; compute
is the rest. The flash kernels' launches are counted over the run's
steps.
"""

from __future__ import annotations

import time

import numpy as np

LABELS = ("fsdp_gather", "fsdp_scatter", "tp_allreduce", "dp_sync", "fsdp_sync", "metrics")


def _model(config: dict):
    import torch

    from ray_tpu_torch.models import get_config

    model = get_config(config["model"])
    if config.get("n_layers"):
        model = model.replace(n_layers=config["n_layers"])
    if config.get("f32"):
        model = model.replace(dtype=torch.float32)
    return model


def _timed(step_fn, spmd, steps_out: list, splits_out: list):
    """The step, timed to a device synchronisation, its collectives split
    out by label."""
    import torch

    def timed(state, batch):
        spmd.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        steps_out.append((time.perf_counter() - t, metrics["loss"].item()))
        stats = spmd.stats()
        splits_out.append({k: {"seconds": v["seconds"], "bytes": v["bytes"], "calls": v["calls"]}
                           for k, v in stats.items()})
        return state, metrics

    return timed


def fsdp_tp_rank(config: dict) -> dict:
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.ops import KERNELS
    from ray_tpu_torch.parallel import (
        MeshSpec, build_mesh, data_sharding, default_rules, override_rules,
    )
    from ray_tpu_torch.train import (
        CheckpointManager, LMTrainer, create_train_state, default_optimizer, make_train_step,
        state_specs,
    )
    from ray_tpu_torch.util.tree import flatten

    rank = dist.get_rank()
    mode, model = config["mode"], _model(config)
    tokens = np.asarray(config["tokens"])  # (steps, global batch, seq + 1)
    steps = len(tokens)
    opt = default_optimizer(config["lr"], warmup_steps=config["warmup_steps"],
                            total_steps=config["total_steps"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings, splits = [], []
    out = {"mode": mode, "rank": rank, "device": torch.cuda.get_device_name(0)}
    if mode == "gpt2_lmtrainer":
        trainer = LMTrainer(model, optimizer=opt, seed=config["seed"],
                            total_steps=config["total_steps"])
        mesh, spmd = trainer.mesh, trainer.step_fn.spmd
        trainer.step_fn = _timed(trainer.step_fn, spmd, timings, splits)
        for kernel in KERNELS:
            kernel.launches = 0
        last = trainer.train([{"tokens": t} for t in tokens], num_steps=steps,
                             report_every=steps, report_fn=lambda m: None)
        out["report"] = {k: last.get(k) for k in ("num_tokens", "tokens_per_sec", "step_flops",
                                                  "mfu")}
        out["num_params"] = trainer.num_params
    else:
        rules = override_rules(default_rules(), vocab=None) if config.get("vocab_whole") \
            else default_rules()
        mesh = build_mesh(MeshSpec(**config["mesh"]), ["cuda"])
        state = create_train_state(model, opt, config["seed"], mesh=mesh, rules=rules)
        step = make_train_step(model, opt, mesh=mesh, rules=rules)
        spmd = step.spmd
        timed = _timed(step, spmd, timings, splits)
        rows = data_sharding(mesh)
        batches = [{"tokens": rows.shard(torch.from_numpy(t)).to(mesh.device)} for t in tokens]
        for kernel in KERNELS:
            kernel.launches = 0
        for batch in batches:
            state, _ = timed(state, batch)
        if config.get("checkpoint"):
            t = time.perf_counter()
            mgr = CheckpointManager(config["checkpoint"], mesh=mesh)
            mgr.save(steps, state, specs=state_specs(state, model, rules))
            saved_s = time.perf_counter() - t
            fresh = create_train_state(model, opt, config["seed"] + 1, mesh=mesh, rules=rules)
            restored = mgr.restore(fresh, device="cuda")
            torch.cuda.synchronize()
            out["checkpoint"] = dict(
                bitwise=all(torch.equal(a, b) for (_, a), (_, b) in
                            zip(flatten(state), flatten(restored)) if isinstance(a, torch.Tensor)),
                step=restored.step, save_s=saved_s,
                bytes=sum(t.numel() * t.element_size() for _, t in flatten(state)
                          if isinstance(t, torch.Tensor)))
            mgr.close()
            del fresh, restored
        del state
    out.update(
        mesh=mesh.spec.describe(), coords=mesh.coords, backend=mesh.backend,
        losses=[loss for _, loss in timings], step_s=[s for s, _ in timings], splits=splits,
        split_group={g: v for g, v in spmd.split.items()},
        launches={k.name: k.launches for k in KERNELS},
        peak_bytes=torch.cuda.max_memory_allocated())
    return out
