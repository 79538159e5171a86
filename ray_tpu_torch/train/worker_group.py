"""Gang of train-worker actors (reference parity: WorkerGroup + RayTrainWorker,
train/_internal/worker_group.py:19,102; gang scheduling via a PACK placement
group, backend_executor.py:230).

Port of `ray_tpu/train/worker_group.py` on the port's thread actors: each
worker actor hosts the user's train loop in one thread and stays
responsive to polls on a second (max_concurrency=2 — the same split the
reference gets from its session thread). A worker that uses the card asks
for `{"GPU": 1}` (`ScalingConfig(use_gpu=True)`), where JAX's asks for a
TPU.

A failed loop leaves nothing of itself behind: its frames' locals (the
model, optimizer state and batches on the card) are cleared before the
error propagates, so the `TaskError` the controller reads, and its
traceback, keep no device memory alive into the next attempt.
"""

from __future__ import annotations

import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional

from .. import api
from ..core.scheduler import PlacementGroup, PlacementGroupSchedulingStrategy
from .session import Session, TrainContext, _set_session


class TrainWorker:
    """Actor body. Created via api.remote inside WorkerGroup.start()."""

    def __init__(
        self, rank: int, world_size: int, run_name: str,
        trial_dir: "Optional[str]" = None,
        checkpoint_keep: "Optional[int]" = None,
        protect_step: "Optional[int]" = None,
        dataset_shards: "Optional[Dict[str, Any]]" = None,
    ):
        self._context = TrainContext(
            world_rank=rank, world_size=world_size, run_name=run_name,
            trial_dir=trial_dir,
        )
        self._session = Session(self._context, checkpoint_keep=checkpoint_keep)
        # the step the controller will resume from: pruning spares it
        self._session.protect_step = protect_step
        # this rank's streaming_split DataIterators (in-process actors
        # receive them zero-copy; train.get_dataset_shard reads them)
        self._session.dataset_shards = dict(dataset_shards or {})
        self._done = False
        self._error: Optional[str] = None

    def run(self, train_fn: Callable, config: Dict[str, Any]):
        _set_session(self._session)
        try:
            result = train_fn(config) if config is not None else train_fn()
            self._done = True
            return result
        except BaseException as e:
            self._error = repr(e)
            self._done = True
            # the loop's frames have unwound: drop their locals so the
            # error (kept by the TaskError) holds no model or batch
            traceback.clear_frames(e.__traceback__)
            raise
        finally:
            _set_session(None)

    def poll(self, since: int, should_checkpoint: bool = False,
             preempted: bool = False, preempt_deadline: float = 0.0):
        # preemption flags ride the poll call (controller -> session); the
        # train loop observes them between steps via
        # train.should_checkpoint()/train.is_preempted()
        if should_checkpoint or preempted:
            self._session.set_preemption(
                should_checkpoint, preempted, preempt_deadline
            )
        reports = self._session.drain(since)
        return {
            "reports": [
                (r.metrics, r.checkpoint_step, r.world_rank, r.time) for r in reports
            ],
            "done": self._done,
            "error": self._error,
        }

    def rank(self) -> int:
        return self._context.world_rank

    def ping(self) -> str:
        return "ok"


class WorkerGroup:
    """N gang-scheduled TrainWorker actors + their placement group."""

    def __init__(
        self,
        num_workers: int,
        resources_per_worker: Dict[str, float],
        run_name: str = "train_run",
        trial_dir: Optional[str] = None,
        pg: Optional[PlacementGroup] = None,
        checkpoint_keep: Optional[int] = None,
        protect_step: Optional[int] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        self.num_workers = num_workers
        self.resources_per_worker = resources_per_worker
        self.run_name = run_name
        # name -> Dataset: streaming_split(num_workers) at start(); each
        # worker's Session receives its own per-rank DataIterator
        self.datasets = datasets or {}
        # session checkpoint retention + the pending-restore step pruning
        # must spare (plumbed into every worker's Session)
        self.checkpoint_keep = checkpoint_keep
        self.protect_step = protect_step
        # Shared checkpoint dir for report(checkpoint=...)/get_checkpoint()
        # (all ranks see the same dir, like the reference's shared
        # StorageContext; by convention rank 0 writes).
        if trial_dir is None:
            trial_dir = tempfile.mkdtemp(prefix=f"ray_tpu_train_{run_name}_")
        self.trial_dir = trial_dir
        # An externally shared pg (e.g. reused across TrainController
        # restart attempts) is waited on, not created, and never removed.
        self.pg: Optional[PlacementGroup] = pg
        self._owns_pg = pg is None
        self.workers: List[Any] = []
        # the DataIterators handed to this gang's workers: shutdown()
        # closes them so a restart attempt's fresh streaming_split does
        # not race a leaked pump thread from the previous attempt
        self._split_iters: List[Any] = []
        # telemetry: wall timestamp of each worker's newest report,
        # updated by poll() — the stall watchdog's straggler ranking
        # reads gang progress from here
        self.last_report_ts: List[float] = [0.0] * num_workers
        # telemetry: sampled step-phase records (train/steplog) each
        # worker has shipped on the report plane — a zero here with
        # cfg.train_step_log on means that rank's forensics are dark
        self.steplog_records: List[int] = [0] * num_workers

    def start(self) -> None:
        if self.pg is None:
            bundles = [
                dict(self.resources_per_worker) for _ in range(self.num_workers)
            ]
            self.pg = api.placement_group(bundles, strategy="PACK")
            self._owns_pg = True
        if not self.pg.ready(timeout=30):
            raise TimeoutError(
                f"placement group for {self.run_name} not placed within 30s"
            )
        if self.pg.removed:
            raise RuntimeError(
                f"placement group for {self.run_name} was removed"
            )
        actor_cls = api.remote(TrainWorker)

        # gang feed: one streaming execution per dataset, split into
        # per-rank ref-passing iterators (rank i fetches its own blocks).
        # equal=True: strict round-robin delivery of complete rounds
        # only, so every rank receives the same number of blocks and dp
        # ranks cannot disagree on step counts
        shards_by_rank: List[Dict[str, Any]] = [
            {} for _ in range(self.num_workers)
        ]
        for ds_name, ds in self.datasets.items():
            splits = ds.streaming_split(self.num_workers, equal=True)
            self._split_iters.extend(splits)
            for i, it in enumerate(splits):
                shards_by_rank[i][ds_name] = it

        self.workers = [
            actor_cls.options(
                max_concurrency=2,
                resources=dict(self.resources_per_worker),
                num_cpus=0,
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=self.pg, placement_group_bundle_index=i
                ),
                name=f"{self.run_name}-worker-{i}",
            ).remote(i, self.num_workers, self.run_name, self.trial_dir,
                     self.checkpoint_keep, self.protect_step,
                     shards_by_rank[i])
            for i in range(self.num_workers)
        ]
        api.get([w.ping.remote() for w in self.workers], timeout=30)

    def run_async(self, train_fn: Callable, config: Optional[Dict[str, Any]]):
        """Kick off the loop on every worker; returns the result refs."""
        return [w.run.remote(train_fn, config) for w in self.workers]

    def poll(self, since: List[int], should_checkpoint: bool = False,
             preempted: bool = False, preempt_deadline: float = 0.0):
        polls = api.get(
            [
                w.poll.remote(s, should_checkpoint, preempted, preempt_deadline)
                for w, s in zip(self.workers, since)
            ],
            timeout=60,
        )
        for i, p in enumerate(polls):
            for _metrics, _ckpt, _rank, ts in p.get("reports", ()):
                if i < len(self.last_report_ts):
                    self.last_report_ts[i] = max(self.last_report_ts[i], ts)
                if isinstance(_metrics, dict) and i < len(self.steplog_records):
                    recs = _metrics.get("_steplog")
                    if isinstance(recs, (list, tuple)):
                        self.steplog_records[i] += len(recs)
        return polls

    def step_timestamps(self) -> List[float]:
        """Per-worker newest report wall timestamps (0.0 = no report
        yet) — gang progress for straggler ranking."""
        return list(self.last_report_ts)

    def steplog_record_counts(self) -> List[int]:
        """Per-worker sampled step-phase records shipped so far (the
        train/steplog forensics feed riding the report plane)."""
        return list(self.steplog_records)

    def finish(self, result_refs, timeout=None):
        """Block for the run() results, raising any worker exception."""
        return api.get(result_refs, timeout=timeout)

    def shutdown(self) -> None:
        # stop this gang's ingest before killing its consumers: the
        # split pump exits, upstream submission stops, and staged block
        # refs drop (a restart attempt re-splits the same Datasets)
        for it in self._split_iters:
            it.close()
        self._split_iters = []
        for w in self.workers:
            api.kill(w)
        if self.pg is not None and self._owns_pg:
            api.remove_placement_group(self.pg)
            self.pg = None
        self.workers = []
