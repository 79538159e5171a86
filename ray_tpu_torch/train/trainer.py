"""User-facing trainers: the generic gang `Trainer` and `LMTrainer`.

Port of `ray_tpu/train/trainer.py`:
- `Trainer`: run any train_loop_per_worker on a gang of N thread actors
  with failure handling (reference parity: DataParallelTrainer); datasets
  passed as `datasets={name: ds}` are split across the ranks
  (`train.get_dataset_shard`). With `ScalingConfig(use_gpu=True)` each
  rank asks for a GPU and `fit()` raises without a CUDA device.
- `LMTrainer`: the same constructor and `train(...)` signature, the same
  report keys and the same step-log decomposition, with `restore`,
  `maybe_restore` and `save_checkpoint` on the port's
  `CheckpointManager`. It is a host-side object: the step is the port's
  eager train step, and Python feeds batches and drains metrics. In a
  torch.distributed job of n ranks (a `MultihostWorkerGroup` rank) it
  trains over JAX's default mesh, fsdp = n, or the `mesh_spec` given (dp,
  fsdp and tp; the parameters split by `rules`, default
  `default_rules()`, through `parallel.spmd`). Over dp it has JAX's dp
  sync modes (`dp_allreduce_dtype`, `dp_shard_update`), their `dp_sync_mode`
  and `dp_sync_bytes`, and JAX's host estimate of the sync's seconds
  (bytes / `steplog_dp_bandwidth_gbs`) in the reports and in the step
  log's `dp_sync` bucket. On one device an int8 or sharded-update sync
  runs the standard step (`dp_sync_mode` "xla_psum", `dp_sync_bytes` 0),
  as JAX's does.

What differs from JAX, and why:
- One process per device: `device` (default "cuda", raising without a
  CUDA device; "cpu" runs the plain paths) is this rank's device. The
  default mesh is JAX's, `MeshSpec().with_devices(world size)`: fsdp over
  the job's ranks.
- A batch that `lm_batch_iterator(sharding=)` or `iter_torch_batches(
  sharding=)` placed is this rank's rows over (dp, fsdp), the same on
  every tp rank; any other batch is the global one, and the trainer
  takes this rank's rows of it (JAX's step places a global array by its
  sharding the same way). tokens/s counts the global batch, as JAX's
  does.
- Device work is queued, as JAX's dispatch is asynchronous: only sampled
  steps synchronise the device (JAX's `block_until_ready`), and a report
  reads its metrics back (JAX's `float()` does too).
- MFU and the roofline come from `util/profiling.step_cost`, which counts
  the step on meta tensors where JAX reads the compiled step's
  `cost_analysis()`: this rank's forward, backward and update on its rows
  and blocks (the collectives are not counted: on meta tensors they make
  shapes only); the count runs at the first
  report that needs it and is cached, as JAX's AOT compile is.
- As in JAX, `train` reports through `session.report` inside a gang
  rank, keyed by the gang's run name and the rank's `world_rank`; outside
  a gang `report_fn` is a no-op, `run_name` "local" and the rank 0.
  Sampled-step records travel in each report's reserved `_steplog` key.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..core.config import cfg
from ..models.transformer import TransformerConfig, count_params, logical_axes
from ..ops.losses import auto_loss_chunk
from ..parallel.collectives import dp_sync_bytes
from ..parallel.mesh import MeshSpec, build_mesh, data_sharding
from ..parallel.sharding import default_rules
from ..parallel.spmd import ModelSharding
from . import steplog
from .checkpoint import CheckpointManager
from .config import CheckpointConfig, RunConfig, ScalingConfig
from .controller import Result, TrainController
from .lm import (
    AdamWState,
    TrainState,
    _make_sharded_step,
    create_train_state,
    default_optimizer,
    make_train_step,
    state_specs,
)


class Trainer:
    """Generic gang trainer: `fit()` = start controller, return Result.
    The run's controller stays readable as `self.controller` (its stall
    watchdog, goodput accountant and world sizes)."""

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        train_loop_config: Optional[Dict[str, Any]] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        self.train_fn = train_loop_per_worker
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.train_config = train_loop_config
        # name -> data.Dataset: streaming_split across the gang at start;
        # workers read their per-rank split via train.get_dataset_shard
        self.datasets = datasets
        self.controller: Optional[TrainController] = None

    def fit(self) -> Result:
        if self.scaling.use_gpu:
            resolve_device("cuda")  # a GPU gang without a card raises, not queues
        self.controller = TrainController(
            self.train_fn, self.scaling, self.run_config, self.train_config,
            datasets=self.datasets,
        )
        return self.controller.run()


class LMTrainer:
    """Language-model trainer: the train step + a batch iterator + checkpoints.

    A host-side object, not an actor: the device runs the step; Python
    only feeds batches and drains metrics.
    """

    def __init__(
        self,
        config: TransformerConfig,
        *,
        mesh_spec: Optional[MeshSpec] = None,
        optimizer=None,
        learning_rate: float = 3e-4,
        total_steps: int = 1000,
        grad_accum: int = 1,
        z_loss_coeff: float = 0.0,
        checkpoint_config: Optional[CheckpointConfig] = None,
        rules=None,
        seed: int = 0,
        loss_chunk: Optional[int] = None,
        dp_allreduce_dtype: Optional[str] = None,
        dp_shard_update: Optional[bool] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.config = config
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        self.mesh = build_mesh(mesh_spec or MeshSpec().with_devices(world), [device])
        self.device = self.mesh.device
        self.rules = rules or default_rules()
        # dp sync knobs: explicit args win, cfg flags are the default
        if dp_allreduce_dtype is None:
            dp_allreduce_dtype = cfg.dp_allreduce_dtype
        if dp_shard_update is None:
            dp_shard_update = cfg.dp_shard_update
        n_dp = self.mesh.shape["dp"]
        explicit_dp = (dp_shard_update or dp_allreduce_dtype == "int8") and n_dp > 1
        self.dp_sync_mode = (
            f"{dp_allreduce_dtype}" + ("+shard_update" if dp_shard_update else "")
            if explicit_dp else "xla_psum"
        )
        self.optimizer = optimizer or default_optimizer(
            learning_rate, total_steps=total_steps,
            shard_axis="dp" if (explicit_dp and dp_shard_update) else None,
        )
        self.total_steps = total_steps
        self.state = create_train_state(
            self.config, self.optimizer, seed, mesh=self.mesh, rules=self.rules,
            dp_shard_update=explicit_dp and dp_shard_update,
            dp_error_feedback=explicit_dp and dp_allreduce_dtype == "int8",
        )
        # JAX's state shardings: which leaves are this rank's block
        self.state_specs = state_specs(self.state, config, self.rules,
                                       dp_shard_update=explicit_dp and dp_shard_update)
        self._step_kwargs = dict(z_loss_coeff=z_loss_coeff, grad_accum=grad_accum)
        self._loss_chunk = loss_chunk
        self.step_fn = make_train_step(
            self.config, self.optimizer, mesh=self.mesh, loss_chunk=loss_chunk,
            dp_allreduce_dtype=dp_allreduce_dtype, dp_shard_update=dp_shard_update,
            rules=self.rules, **self._step_kwargs)
        # the step's collectives on a mesh whose rules split parameters
        self._spmd = getattr(self.step_fn, "spmd", None)
        self.dp_sync_bytes = dp_sync_bytes(
            self.num_params, n_dp,
            mode=dp_allreduce_dtype, shard_update=dp_shard_update,
            block=cfg.dp_quant_block,
        ) if explicit_dp else dp_sync_bytes(self.num_params, n_dp)
        # per-step dp_sync ESTIMATE for the step-phase decomposition
        # (train/steplog): wire bytes over the assumed interconnect
        # bandwidth — 0 on a single replica, where nothing syncs
        self._dp_sync_est_s = (
            self.dp_sync_bytes / (cfg.steplog_dp_bandwidth_gbs * 1e9) if n_dp > 1 else 0.0
        )
        self._batch_sharding = data_sharding(self.mesh)
        # the step's counted cost (util/profiling), computed the first time
        # a report needs it (one run of the step on meta tensors; disable
        # with profile_cost_accounting=False)
        self._step_cost = None
        self.ckpt_config = checkpoint_config
        self.ckpt_mgr: Optional[CheckpointManager] = None
        if checkpoint_config and checkpoint_config.checkpoint_dir:
            self.ckpt_mgr = CheckpointManager(
                checkpoint_config.checkpoint_dir,
                max_to_keep=checkpoint_config.max_to_keep,
                async_save=checkpoint_config.async_save,
                mesh=self.mesh,
            )

    @property
    def num_params(self) -> int:
        """The model's parameters (the global leaves' elements, where this
        rank holds blocks)."""
        if self._spmd is None:
            return count_params(self.state.params)
        return self._spmd.num_params(self.state.params)

    def restore(self, step: Optional[int] = None) -> int:
        """Resume from a checkpoint; returns the restored step."""
        if self.ckpt_mgr is None:
            raise RuntimeError("no checkpoint_dir configured")
        self.state = self.ckpt_mgr.restore(self.state, step, device=self.device)
        return int(self.state.step)

    def maybe_restore(self) -> Optional[int]:
        if self.ckpt_mgr is not None and self.ckpt_mgr.latest_step() is not None:
            return self.restore()
        return None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _place(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows: a batch placed by a sharding is kept; a global
        one is cut to this rank's block of rows."""
        if self.mesh.size == 1 or getattr(batch, "sharding", None) is not None:
            return batch
        return {"tokens": self._batch_sharding.shard(batch["tokens"])}

    def _land(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Have the batch on the device before a sampled step's dispatch,
        so h2d separates from device compute in the timeline: a prefetched
        batch waits only for its own copies' event; a host batch is copied
        here, behind the work already queued."""
        ready = getattr(batch, "ready", None)
        if ready is not None:
            ready.synchronize()
            return batch
        tokens = batch["tokens"]
        if tokens.device != self.device:
            batch = {"tokens": tokens.to(self.device)}
            self._sync()
        return batch

    def train(
        self,
        batches: Iterable[Dict[str, Any]],
        *,
        num_steps: Optional[int] = None,
        report_every: int = 10,
        report_fn: Optional[Callable[[Dict[str, Any]], None]] = None,
        run_name: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Drive the step over a batch iterator. Returns final metrics incl.
        tokens/sec. `report_fn` defaults to session.report when inside a
        worker, else a no-op. `run_name` keys the step-forensics records
        (default: the session's run name, else "local")."""
        from .session import _local

        session = getattr(_local, "session", None)
        if report_fn is None:
            report_fn = session.report if session is not None else (lambda m: None)
        if run_name is None:
            run_name = session.context.run_name if session is not None else "local"
        rank = session.context.world_rank if session is not None else 0

        ckpt_every = self.ckpt_config.checkpoint_every if self.ckpt_config else 0
        # step forensics (train/steplog): every sample_every-th step is
        # decomposed into typed phase buckets. ONLY sampled steps sync the
        # device; the rest keep the queue running ahead.
        sample_every = steplog.sample_every() if steplog.enabled() else 0
        pending_steps: list = []
        t0 = time.perf_counter()
        tokens_done = 0.0
        last_metrics: Dict[str, Any] = {}
        steps = 0
        window_t0, window_steps = t0, 0
        # per-window phase seconds: a goodput accountant re-attributes
        # these out of the step_compute bucket
        window_input_wait = 0.0
        window_ckpt_save = 0.0
        window_dp_sync = 0.0
        data_parts = self._batch_sharding.parts(0)[0]
        batch_iter = iter(batches)
        while True:
            t_step0 = time.perf_counter()
            try:
                batch = next(batch_iter)  # input pipeline wait happens HERE
            except StopIteration:
                break
            t_data = time.perf_counter()
            window_input_wait += t_data - t_step0
            if num_steps is not None and steps >= num_steps:
                break
            sampled = sample_every > 0 and steps % sample_every == 0
            if isinstance(batch["tokens"], np.ndarray):
                batch = {"tokens": torch.from_numpy(batch["tokens"])}
            batch = self._place(batch)
            tokens = batch["tokens"]
            if sampled:
                # the ONE deliberate sync before dispatch: land the batch
                batch = self._land(batch)
            t_h2d = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            if sampled:
                self._sync()
            t_dev = time.perf_counter()
            steps += 1
            window_steps += 1
            window_dp_sync += self._dp_sync_est_s
            tokens_done += float(tokens.shape[0] * data_parts * (tokens.shape[1] - 1))
            t_rep0 = time.perf_counter()
            if steps % report_every == 0 or (num_steps is not None and steps == num_steps):
                metrics = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                elapsed = now - t0
                metrics["tokens_per_sec"] = tokens_done / max(elapsed, 1e-9)
                metrics["step"] = int(self.state.step)
                metrics["input_wait_s"] = round(window_input_wait, 6)
                metrics["ckpt_save_s"] = round(window_ckpt_save, 6)
                metrics["dp_sync_s"] = round(window_dp_sync, 6)
                window_input_wait = window_ckpt_save = window_dp_sync = 0.0
                # MFU/roofline from the step's counted cost over this
                # window's measured step time (the first window absorbs the
                # first steps' set-up, so its MFU reads low)
                metrics.update(self.profiling_metrics(
                    batch, (now - window_t0) / max(window_steps, 1)
                ))
                window_t0, window_steps = now, 0
                last_metrics = metrics
                # sampled-step records + the worker's monotonic clock ride
                # the report on RESERVED keys
                payload = dict(metrics)
                payload["_mono"] = time.perf_counter()
                if pending_steps:
                    payload["_steplog"] = pending_steps
                    pending_steps = []
                report_fn(payload)
            t_rep1 = time.perf_counter()
            ckpt_dur = 0.0
            if ckpt_every and steps % ckpt_every == 0 and self.ckpt_mgr is not None:
                t_ck = time.perf_counter()
                self.save_checkpoint()
                ckpt_dur = time.perf_counter() - t_ck
                window_ckpt_save += ckpt_dur
            if sampled:
                pending_steps.append(self._mark_sampled_step(
                    run_name, rank, int(self.state.step),
                    data_wait=t_data - t_step0,
                    h2d=t_h2d - t_data,
                    device=t_dev - t_h2d,
                    report=t_rep1 - t_rep0,
                    ckpt=ckpt_dur,
                    wall=time.perf_counter() - t_step0,
                ))
                del pending_steps[:-64]  # bounded if reports never drain
        if pending_steps and session is not None:
            # trailing sampled steps with no report behind them: ship a
            # reserved-keys-only report (the controller drops it from
            # metric publication after popping the steplog payload)
            report_fn({"_steplog": pending_steps,
                       "_mono": time.perf_counter()})
        if self.ckpt_mgr is not None and self.ckpt_config.checkpoint_every:
            self.save_checkpoint()
            self.ckpt_mgr.wait_until_finished()
        return last_metrics

    def _mark_sampled_step(self, run: str, rank: int, step: int, *,
                           data_wait: float, h2d: float, device: float,
                           report: float, ckpt: float,
                           wall: float) -> Dict[str, Any]:
        """Decompose one SAMPLED step into the typed steplog buckets.

        The step is one device interval on the host's clock (dispatch to
        synchronise): dp_sync is JAX's wire-byte ESTIMATE
        (cfg.steplog_dp_bandwidth_gbs; exactly 0 on one replica),
        fwd_bwd_compute the rest of the interval, and optimizer_update
        stays 0 (inside the same interval). `other` is wall minus every
        measured bucket, so the recorded buckets sum EXACTLY to wall_s."""
        dp_sync = min(self._dp_sync_est_s, device)
        fwd_bwd = device - dp_sync
        measured = data_wait + h2d + device + report + ckpt
        other = wall - measured
        if other < 0.0:  # clock jitter: wall is then the measured sum
            other, wall = 0.0, measured
        steplog.mark("data_wait", data_wait, run=run, rank=rank, step=step)
        steplog.mark("h2d", h2d, run=run, rank=rank, step=step)
        steplog.mark("fwd_bwd_compute", fwd_bwd, run=run, rank=rank, step=step)
        steplog.mark("dp_sync", dp_sync, run=run, rank=rank, step=step, estimated=True)
        steplog.mark("optimizer_update", 0.0, run=run, rank=rank, step=step)
        steplog.mark("ckpt_save", ckpt, run=run, rank=rank, step=step)
        steplog.mark("report", report, run=run, rank=rank, step=step)
        steplog.mark("other", other, run=run, rank=rank, step=step, wall_s=wall)
        return {
            "run": run, "rank": rank, "step": step,
            "node": steplog._default_node(), "ts": time.time(),
            "wall_s": wall,
            "buckets": {
                "data_wait": data_wait, "h2d": h2d,
                "fwd_bwd_compute": fwd_bwd, "dp_sync": dp_sync,
                "optimizer_update": 0.0, "ckpt_save": ckpt,
                "report": report, "other": other,
            },
        }

    def step_cost(self, batch: Dict[str, Any]):
        """The counted cost of the train step at this batch's shapes
        (util/profiling StepCost), cached after the first call."""
        if self._step_cost is None:
            from ..util import profiling

            tokens = torch.as_tensor(self._place(batch)["tokens"])
            chunk = self._loss_chunk
            if chunk is None:  # what the live step's auto choice picks on its device
                micro = tokens.shape[0] // self._step_kwargs["grad_accum"]
                chunk = auto_loss_chunk(micro, tokens.shape[1] - 1, self.config.vocab_size,
                                        device=self.device)
            # the optimizer of the sharded update clips over the ranks: the
            # count prices the same update on whole leaves, on one device
            optimizer = dataclasses.replace(self.optimizer, shard_axis=None)
            if self._spmd is not None:
                # this rank's blocks through the mesh's collectives, which
                # make shapes only on meta tensors (its own wires: the
                # step's counts stay the step's)
                spmd = ModelSharding(self.mesh, logical_axes(self.config), self.rules)
                meta_step = _make_sharded_step(self.config, optimizer, spmd, torch.device("meta"),
                                               loss_chunk=chunk, **self._step_kwargs)
            else:
                meta_step = make_train_step(self.config, optimizer, device="meta",
                                            loss_chunk=chunk, dp_allreduce_dtype="f32",
                                            dp_shard_update=False, **self._step_kwargs)
            # this rank's step on its rows, with the moments in the params'
            # layout (the sharded update's rows are priced as whole leaves)
            meta = TrainState(step=self.state.step, params=self.state.params, opt_state=AdamWState(
                count=self.state.opt_state.count, mu=self.state.params, nu=self.state.params))
            self._step_cost = profiling.step_cost(meta_step, meta, {"tokens": tokens})
        return self._step_cost

    def profiling_metrics(self, batch: Dict[str, Any],
                          step_time_s: float) -> Dict[str, Any]:
        """MFU + roofline fractions for one measured step time, from the
        step's counted FLOPs and bytes — NOT hand-derived 6ND constants.
        Empty dict when the count fails (cost accounting must never fail
        a training run)."""
        try:
            from ..util import profiling

            if not cfg.profile_cost_accounting:
                return {"step_time_s": step_time_s}
            cost = self.step_cost(batch)
            roof = profiling.roofline(cost, max(step_time_s, 1e-9))
            return {
                "step_time_s": step_time_s,
                "mfu": roof["mfu"],
                "step_flops": cost.total_flops,
                "step_bytes": cost.total_bytes,
                "roofline_hbm": roof["hbm_fraction"],
                "roofline_bound": roof["bound"],
                "dp_sync_mode": self.dp_sync_mode,
                "dp_sync_bytes": self.dp_sync_bytes,
            }
        except Exception:  # noqa: BLE001 - accounting must not kill training
            return {}

    def save_checkpoint(self) -> int:
        step = int(self.state.step)
        self.ckpt_mgr.save(step, self.state, specs=self.state_specs)
        return step
