"""One rank of chip_smoke.py's `dp` phase: data-parallel LMTrainer runs.

    (imported by the ranks of a MultihostWorkerGroup; not run directly)

`dp_rank(config)` is the train function a `TrainController` runs in each
process of a `MultihostWorkerGroup` (module-level, so the worker
protocol's standard pickle sends it by reference). For each sync mode
it builds `LMTrainer(mesh_spec=MeshSpec(dp=n))` on the rank's CUDA device
from the phase's seed and optimizer (`model_overrides` replace fields of
the named config: the phase's depth cut), feeds it `lm_batch_iterator(
sharding=data_sharding(mesh))` over the same global window every step,
and reports through `train.report`: the losses, each step's wall time
(ended by a device synchronisation), the wire's bytes and seconds by
label, JAX's estimate of the sync's seconds, the peak allocated bytes,
the flash kernels' launches, and the check of the stage-1 error-feedback
residual against half of its block's step. The residual check recomputes
the last step's stage-1 input (the same gradients: the kernels are
deterministic) before that step; its launches are left out of the counts.
"""

from __future__ import annotations

import time

import numpy as np


class _Window:
    """The global batch's window, flattened, once per step."""

    def __init__(self, tokens: np.ndarray, steps: int):
        self.tokens = tokens
        self.steps = steps

    def iter_blocks(self):
        for _ in range(self.steps):
            yield {"tokens": self.tokens.reshape(-1)}


def _flags(mode: str) -> dict:
    return dict(dp_allreduce_dtype="int8" if "int8" in mode else "f32",
                dp_shard_update="shard" in mode)


def _stage1_scales(trainer, tokens, block: int):
    """The block scales of the next step's stage-1 quantizer input: this
    rank's gradient rows plus its residual."""
    import torch

    from ray_tpu_torch.train import loss_and_grads, tree_leaves
    from ray_tpu_torch.train.lm import _to_rows
    from ray_tpu_torch.parallel.collectives import quantize_int8_block

    n = trainer.mesh.shape["dp"]
    _, _, grads = loss_and_grads(trainer.config, trainer.state.params, tokens)
    with torch.no_grad():
        rows = torch.cat([_to_rows(g, n, block) for g in grads], dim=1)
        rows += torch.cat([e[0] for e in tree_leaves(trainer.state.ef)], dim=1)
        return quantize_int8_block(rows, block)[1]


def _ef_check(trainer, scales, block: int, shard_update: bool) -> dict:
    """Largest |residual| / (half its block's step) over the stage-1 rows:
    every row under the sharded update, the rows other than this rank's
    own otherwise (its own row also holds the stage-2 residual)."""
    import torch

    from ray_tpu_torch.train import tree_leaves

    n, me = trainer.mesh.shape["dp"], trainer.mesh.axis_index("dp")
    ef = torch.cat([e[0] for e in tree_leaves(trainer.state.ef)], dim=1)
    rows = [r for r in range(n) if shard_update or r != me]
    half = 0.5 * scales[rows].repeat_interleave(block, dim=-1)
    ratio = (ef[rows].abs() / half).max().item()
    return {"ef_max_over_half_step": ratio, "ef_elements": ef[rows].numel()}


def dp_rank(config: dict) -> int:
    import gc

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.core.config import cfg
    from ray_tpu_torch.data import lm_batch_iterator
    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.ops import KERNELS
    from ray_tpu_torch.parallel import MeshSpec, data_sharding
    from ray_tpu_torch.train import LMTrainer, default_optimizer, report, tree_leaves
    from ray_tpu_torch.train.lm import _rows_k

    rank, n = dist.get_rank(), dist.get_world_size()
    model = get_config(config["model"]).replace(**config.get("model_overrides", {}))
    tokens = np.asarray(config["tokens"])
    steps, block = config["steps"], cfg.dp_quant_block
    for mode in config["modes"]:
        flags = _flags(mode)
        shard = flags["dp_shard_update"]
        opt = default_optimizer(config["lr"], warmup_steps=config["warmup_steps"],
                                total_steps=config["total_steps"],
                                shard_axis="dp" if shard else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = LMTrainer(model, mesh_spec=MeshSpec(dp=n), optimizer=opt, seed=config["seed"],
                            total_steps=config["total_steps"], device="cuda", **flags)
        batches = lm_batch_iterator(_Window(tokens, steps), tokens.shape[1] - 1, tokens.shape[0],
                                    sharding=data_sharding(trainer.mesh))
        losses, step_s, probe = [], [], {}
        inner = trainer.step_fn

        def timed(state, batch, inner=inner):
            if trainer.state.ef is not None and len(losses) == steps - 1:
                # the residual check's probe, before the last step
                before = {k.name: k.launches for k in KERNELS}
                probe["scales"] = _stage1_scales(trainer, batch["tokens"], block)
                probe["launches"] = {k.name: k.launches - before[k.name] for k in KERNELS}
            t = time.perf_counter()
            state, metrics = inner(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            losses.append(metrics["loss"].item())
            return state, metrics

        trainer.step_fn = timed
        for kernel in KERNELS:
            kernel.launches = 0
        inner.wire.reset()
        last = trainer.train(batches, num_steps=steps, report_every=steps, report_fn=lambda m: None)
        launches = {k.name: k.launches - probe.get("launches", {}).get(k.name, 0) for k in KERNELS}
        out = {
            "mode": mode, "rank": rank, "dp_sync_mode": trainer.dp_sync_mode,
            "losses": losses, "step_s": step_s, "wire": inner.wire.stats(),
            "dp_sync_bytes": trainer.dp_sync_bytes, "dp_sync_est_s": trainer._dp_sync_est_s,
            "n_params": trainer.num_params, "peak_bytes": torch.cuda.max_memory_allocated(),
            "rows_elements": n * sum(_rows_k(p.numel(), n, block)
                                     for p in tree_leaves(trainer.state.params)),
            "launches": launches, "device": torch.cuda.get_device_name(trainer.device),
            "backend": trainer.mesh.backend, "quant_block": block,
            "report": {k: last.get(k) for k in ("mfu", "step_flops", "step_time_s", "dp_sync_s",
                                               "tokens_per_sec", "num_tokens")},
        }
        if "scales" in probe:
            out.update(_ef_check(trainer, probe["scales"], block, shard))
        report(out)
        del trainer, batches, inner, timed, probe
        gc.collect()
        torch.cuda.empty_cache()
    return rank
