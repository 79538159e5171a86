"""Per-worker train session: report()/get_context()/checkpoints
(reference parity: ray.train.report + TrainContext + ray.train.Checkpoint,
train/_internal/session.py, train/_checkpoint.py:56).

Port of `ray_tpu/train/session.py`. Session checkpoints are written with
the standard `pickle` where JAX's use `cloudpickle`: a checkpoint object
that only cloudpickle can serialize (a lambda, a local class) fails to
pickle here (ROADMAP §C). Gang ranks are thread actors of one process,
so the cross-process flag probe (`_flag_probe`) is never set; preemption
flags reach a session through the controller's poll, as in JAX's
in-process gangs.

Checkpoint trust model (trust-but-verify): every pickle checkpoint commit
writes a sidecar manifest (per-file size + sha256, atomic tmp+replace —
the manifest IS the commit marker). Restore verifies the newest
checkpoint against its manifest; a torn/bit-rotted file is QUARANTINED
(renamed out of the naming scheme, WARNING event,
raytpu_train_ckpt_fallback_total) and the restore falls back to the
newest checkpoint that verifies, instead of feeding garbage into the
optimizer or crashing the run. Checkpoints without a manifest (written
before this scheme, or cloned by PBT exploit) are accepted as-is.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import threading
import time
from typing import Any, Callable, Dict, List, Optional

# sidecar next to each ckpt_*.pkl; written LAST (atomic), so its presence
# means the data file was fully committed
MANIFEST_SUFFIX = ".manifest.json"
# quarantined checkpoints leave the ckpt_*.pkl naming scheme entirely
QUARANTINE_SUFFIX = ".corrupt"


@dataclasses.dataclass
class TrainContext:
    world_rank: int
    world_size: int
    run_name: str
    trial_dir: Optional[str] = None


@dataclasses.dataclass
class Report:
    metrics: Dict[str, Any]
    checkpoint_step: Optional[int]
    world_rank: int
    time: float


class Session:
    """Accumulates worker reports; the controller polls them off."""

    def __init__(self, context: TrainContext,
                 checkpoint_keep: Optional[int] = None):
        self.context = context
        self._reports: List[Report] = []
        self._lock = threading.Lock()
        # retention: how many session checkpoints survive pruning
        # (RunConfig.checkpoint.session_keep > RAY_TPU_TRAIN_CKPT_KEEP)
        self.checkpoint_keep = checkpoint_keep
        # a restore is pending on this step (controller resume target):
        # pruning must never delete it out from under the restart
        self.protect_step: Optional[int] = None
        # --- preemption flags (set by the controller through the poll
        # plane; observed by the train loop via should_checkpoint()/
        # is_preempted() between steps) ---
        self._should_checkpoint = False
        self._preempted = False
        self._preempt_deadline = 0.0
        # cross-process sessions (multihost, ROADMAP A4) read the
        # controller's flags through a probe instead of the in-memory fields
        self._flag_probe: Optional[Callable[[], Dict[str, Any]]] = None
        # streaming-data gang feed: name -> DataIterator for THIS rank's
        # split of each Dataset passed to the trainer (populated by
        # WorkerGroup.start via streaming_split; read by
        # train.get_dataset_shard inside the loop)
        self.dataset_shards: Dict[str, Any] = {}

    def _keep(self) -> int:
        if self.checkpoint_keep is not None:
            return max(1, int(self.checkpoint_keep))
        from ..core.config import cfg

        return max(1, int(cfg.train_ckpt_keep))

    # -------------------------------------------------------------- preemption

    def set_preemption(self, should_checkpoint: bool, preempted: bool,
                       deadline: float = 0.0) -> None:
        """Controller-side push (rides the poll RPC): the gang's node is
        being preempted — checkpoint NOW if you can."""
        with self._lock:
            self._should_checkpoint = self._should_checkpoint or should_checkpoint
            self._preempted = self._preempted or preempted
            if deadline:
                self._preempt_deadline = deadline

    def _probe_flags(self) -> None:
        if self._flag_probe is None:
            return
        try:
            flags = self._flag_probe() or {}
        except Exception:  # noqa: BLE001 - a broken probe must not kill the loop
            return
        self.set_preemption(
            bool(flags.get("should_checkpoint")),
            bool(flags.get("preempted")),
            float(flags.get("deadline") or 0.0),
        )

    def should_checkpoint(self) -> bool:
        """True when the controller asked for an out-of-band (emergency)
        checkpoint — e.g. a preemption notice landed. One-shot: cleared
        by the next report() that carries a checkpoint."""
        self._probe_flags()
        with self._lock:
            return self._should_checkpoint

    def is_preempted(self) -> bool:
        """True once this gang's run is being preempted: the loop may
        stop early after checkpointing instead of burning the window."""
        self._probe_flags()
        with self._lock:
            return self._preempted

    def preempt_deadline(self) -> float:
        self._probe_flags()
        with self._lock:
            return self._preempt_deadline

    # ----------------------------------------------------------------- reports

    def report(
        self,
        metrics: Dict[str, Any],
        checkpoint_step: Optional[int] = None,
        checkpoint: Any = None,
    ) -> None:
        if checkpoint is not None:
            checkpoint_step = self.save_checkpoint(checkpoint, checkpoint_step)
        with self._lock:
            if checkpoint_step is not None:
                # the emergency-checkpoint request is satisfied
                self._should_checkpoint = False
            self._reports.append(
                Report(
                    metrics=dict(metrics),
                    checkpoint_step=checkpoint_step,
                    world_rank=self.context.world_rank,
                    time=time.time(),
                )
            )

    # ------------------------------------------------------------ checkpoints
    # Object checkpoints live in the trial dir as atomic pickle files —
    # the substrate for Tune trial restore and PBT exploit/explore
    # (reference: tune/execution/experiment_state.py, Checkpoint dirs).

    def save_checkpoint(self, obj: Any, step: Optional[int] = None) -> int:
        trial_dir = self.context.trial_dir
        if trial_dir is None:
            raise RuntimeError(
                "report(checkpoint=...) requires a trial_dir (runs launched "
                "by Tuner/Trainer set one automatically)"
            )
        os.makedirs(trial_dir, exist_ok=True)
        gc_torn_checkpoints(trial_dir)
        if step is None:
            # Monotonic across actor restarts: a fresh Session must write
            # AFTER whatever already exists on disk, or the pruner would
            # delete the new files as "oldest" and loads would return
            # stale pre-crash state.
            existing = list_checkpoints(trial_dir)
            step = (
                int(existing[-1][len("ckpt_"):-len(".pkl")]) + 1
                if existing else 0
            )
        path = os.path.join(trial_dir, f"ckpt_{step:08d}.pkl")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)  # atomic: readers never see partial writes
        _write_manifest(path)  # commit marker: size+sha256 of the data file
        self._prune_checkpoints(
            trial_dir, keep=self._keep(), protect_step=self.protect_step
        )
        return step

    @staticmethod
    def _prune_checkpoints(trial_dir: str, keep: int,
                           protect_step: Optional[int] = None) -> None:
        protected = (
            f"ckpt_{protect_step:08d}.pkl" if protect_step is not None else None
        )
        for old in list_checkpoints(trial_dir)[:-keep]:
            if old == protected:
                continue  # a restore is pending on this step
            for victim in (old, old + MANIFEST_SUFFIX):
                try:
                    os.unlink(os.path.join(trial_dir, victim))
                except OSError:
                    pass

    def load_checkpoint(self) -> Any:
        """Latest VERIFIED checkpoint object in this trial's dir, or None."""
        return load_trial_checkpoint(self.context.trial_dir)

    def drain(self, since: int) -> List[Report]:
        with self._lock:
            return self._reports[since:]

    @property
    def num_reports(self) -> int:
        with self._lock:
            return len(self._reports)


_local = threading.local()


def _set_session(session: Optional[Session]) -> None:
    _local.session = session


def get_session() -> Session:
    session = getattr(_local, "session", None)
    if session is None:
        raise RuntimeError(
            "no active train session — report()/get_context() are only valid "
            "inside a train_loop_per_worker"
        )
    return session


def report(
    metrics: Dict[str, Any],
    checkpoint_step: Optional[int] = None,
    checkpoint: Any = None,
) -> None:
    """ray.train.report equivalent: stream metrics (and optionally persist
    a checkpoint object / note a completed checkpoint step)."""
    get_session().report(metrics, checkpoint_step, checkpoint)


def should_checkpoint() -> bool:
    """True when the controller requested an out-of-band checkpoint (a
    preemption warning landed): save + report a checkpoint NOW — the node
    dies when the warning window expires."""
    return get_session().should_checkpoint()


def is_preempted() -> bool:
    """True once this run is being preempted; the controller will restart
    the gang on surviving nodes from the latest checkpoint."""
    return get_session().is_preempted()


def get_checkpoint() -> Any:
    """Latest persisted checkpoint for this trial, or None on a fresh
    start (reference: ray.train.get_checkpoint). How trainables resume
    after a failure, a Tuner.restore, or a PBT exploit."""
    return get_session().load_checkpoint()


def list_checkpoints(trial_dir: Optional[str]) -> List[str]:
    """Checkpoint filenames in a trial dir, oldest→latest. The ONE place
    that knows the naming scheme (save/prune/load/PBT-clone all use it)."""
    if trial_dir is None or not os.path.isdir(trial_dir):
        return []
    return sorted(
        f for f in os.listdir(trial_dir)
        if f.startswith("ckpt_") and f.endswith(".pkl")
    )


# ---------------------------------------------------------- verification

def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            digest.update(block)
    return digest.hexdigest()


def _write_manifest(ckpt_path: str) -> None:
    """Commit a checkpoint: sidecar manifest with the data file's size +
    sha256, written tmp + os.replace so the commit itself is atomic."""
    name = os.path.basename(ckpt_path)
    manifest = {
        "files": {
            name: {
                "size": os.path.getsize(ckpt_path),
                "sha256": _sha256_file(ckpt_path),
            }
        },
        "committed_at": time.time(),
    }
    mpath = ckpt_path + MANIFEST_SUFFIX
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, mpath)


def verify_checkpoint(trial_dir: str, name: str) -> Optional[str]:
    """Check one checkpoint file against its manifest. Returns None when
    it verifies (or has no manifest — pre-manifest/PBT-cloned files are
    trusted as before), else the failure reason."""
    path = os.path.join(trial_dir, name)
    mpath = path + MANIFEST_SUFFIX
    if not os.path.exists(mpath):
        return None  # legacy/cloned checkpoint: nothing to verify against
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        expected = manifest["files"][name]
    except (OSError, ValueError, KeyError) as exc:
        return f"unreadable manifest: {exc!r}"
    try:
        size = os.path.getsize(path)
    except OSError as exc:
        return f"missing data file: {exc!r}"
    if size != expected.get("size"):
        return f"size mismatch: {size} != {expected.get('size')}"
    digest = _sha256_file(path)
    if digest != expected.get("sha256"):
        return f"checksum mismatch: {digest[:12]} != {str(expected.get('sha256'))[:12]}"
    return None


def quarantine_checkpoint(trial_dir: str, name: str, reason: str) -> None:
    """Move a failed checkpoint out of the naming scheme (it stops being
    a restore candidate), emit the event, bump the fallback counter."""
    from ..util.events import emit
    from ..util.metrics import get_or_create_counter

    for victim in (name, name + MANIFEST_SUFFIX):
        src = os.path.join(trial_dir, victim)
        try:
            os.replace(src, src + QUARANTINE_SUFFIX)
        except OSError:
            pass
    emit("WARNING", "train",
         f"quarantined corrupt checkpoint {name}: {reason}",
         kind="ckpt.quarantine", trial_dir=trial_dir, checkpoint=name)
    get_or_create_counter(
        "raytpu_train_ckpt_fallback_total",
        "Checkpoint restores that fell back past a corrupt/torn "
        "checkpoint (quarantined).",
        ("store",),
    ).inc(tags={"store": "session"})


def gc_torn_checkpoints(trial_dir: Optional[str]) -> int:
    """Remove write leftovers a crash can strand: *.tmp staging files and
    manifests whose data file is gone. Returns how many were removed."""
    if trial_dir is None or not os.path.isdir(trial_dir):
        return 0
    removed = 0
    for name in os.listdir(trial_dir):
        path = os.path.join(trial_dir, name)
        torn = name.startswith("ckpt_") and name.endswith(".tmp")
        if not torn and name.endswith(MANIFEST_SUFFIX):
            torn = not os.path.exists(
                os.path.join(trial_dir, name[: -len(MANIFEST_SUFFIX)])
            )
        if torn:
            try:
                os.unlink(path)
                removed += 1
            except OSError:
                pass
    return removed


def load_trial_checkpoint(trial_dir: Optional[str]) -> Any:
    """Newest checkpoint that VERIFIES against its manifest, or None.
    Corrupt/torn candidates are quarantined and the search falls back to
    the next-newest instead of raising — a bit-flipped latest checkpoint
    must cost a few steps, not the run."""
    tried: set = set()
    while True:
        ckpts = [c for c in list_checkpoints(trial_dir) if c not in tried]
        if not ckpts:
            return None
        newest = ckpts[-1]
        tried.add(newest)  # bounded even if the quarantine rename fails
        reason = verify_checkpoint(trial_dir, newest)
        if reason is None:
            try:
                with open(os.path.join(trial_dir, newest), "rb") as f:
                    return pickle.load(f)
            except Exception as exc:  # noqa: BLE001 - undecodable = corrupt
                reason = f"unpickling failed: {exc!r}"
        quarantine_checkpoint(trial_dir, newest, reason)


def get_context() -> TrainContext:
    return get_session().context


def get_dataset_shard(name: str = "train"):
    """ray.train.get_dataset_shard equivalent: this rank's DataIterator
    over its streaming_split of the Dataset passed as
    `Trainer(datasets={name: ds})`. The split is strict round-robin with
    equal=True, so every rank receives the same number of blocks; fetch
    is local per rank (the pump never materializes blocks). Iterate with
    `iter_torch_batches` (drop_last=True default), `iter_batches(
    batch_size, drop_last=True)` or `data.lm_batch_iterator` so every dp
    rank agrees on step counts — a ragged last step deadlocks a
    multi-rank gang."""
    shards = get_session().dataset_shards
    if name not in shards:
        raise KeyError(
            f"no dataset shard named {name!r} — pass datasets={{{name!r}: ds}} "
            f"to the trainer (available: {sorted(shards)})"
        )
    return shards[name]
