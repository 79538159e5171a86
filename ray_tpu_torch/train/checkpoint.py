"""Checkpoint persistence: step directories, verified restore, async save.

Port of `ray_tpu/train/checkpoint.py`'s `write_step_manifest`,
`verify_step_dir` and `CheckpointManager` on the port's own writer. JAX's
writer is orbax, which has no torch counterpart; the manager around it
behaves as JAX's does:

- `<dir>/<step>/` per step, whose MANIFEST (relative path -> size +
  sha256 of every file in the directory) and COMMIT marker are written
  last. A step directory without COMMIT is torn and is garbage-collected
  when a manager opens the directory (`ckpt.gc` event).
- `restore()` verifies the chosen step against its manifest first; a
  corrupt or torn step is QUARANTINED (renamed to `<step>.corrupt-<ts>`,
  `ckpt.quarantine` event, `raytpu_train_ckpt_fallback_total`) and the
  restore falls back to the newest step that verifies.
- `max_to_keep` keeps the newest committed steps; `async_save=True`
  writes on a thread (`wait_until_finished` joins it).

The format is the port's own: each step directory holds `state.bin`, the
tensors' bytes back to back (each at a 64-byte offset), and `index.json`,
which names every leaf by its path in the state tree with its dtype, shape
and offset, and holds the tree's Python scalars (the step counts). A step
is written into `<step>.tmp-<pid>` and renamed into place once its
manifest and COMMIT are in it. Reading an orbax directory (the JAX
package's checkpoints) is out of scope.

A data-parallel state (a manager given a mesh of n > 1 ranks, and the
state's leaf specs, `train.lm.state_specs`) is saved by every rank into
one step directory, as orbax writes each process's addressable shards:
the replicated leaves and the scalars once, by rank 0 (`state.bin`,
`index.json`), and each rank's block of the rank-sharded leaves (the
rows-layout moments and `ef`) in `rank<r>.bin` / `rank<r>.json`;
`index.json` records the layout (ranks, and each sharded leaf's spec and
global shape). The ranks meet at two barriers of a gloo group of their
own (on the writer thread, apart from the step's collectives): once every
rank's files are in the temporary directory, rank 0 writes the manifest
over all of them and COMMIT and renames the directory; after the second
barrier every rank sees the step. A restore reads the replicated leaves
and this rank's block, bitwise; a checkpoint of another number of ranks
raises (no resharding).

The port's train step updates its tensors in place, where JAX arrays are
immutable and orbax may read them later. So `save()` copies every tensor
to host memory (pinned, for CUDA tensors, and synchronised on an event)
before it returns; only the file write runs on the writer thread.
`restore(target, step=None, device=...)` rebuilds the target's tree from
the file: tensors on `device`, in the target's dtypes, and leaf tensors
with `requires_grad` where the target's are.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from ..util.tree import flatten, rebuild

MANIFEST_NAME = "_raytpu_manifest.json"
COMMIT_NAME = "_RAYTPU_COMMIT"
DATA_NAME = "state.bin"
INDEX_NAME = "index.json"
_ALIGN = 64  # bytes: every tensor starts at a multiple, so any dtype view of it is aligned


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            digest.update(block)
    return digest.hexdigest()


def _step_files(step_dir: str) -> List[str]:
    """Every regular file under a step dir, relative paths, excluding our
    own manifest/commit sidecars."""
    out: List[str] = []
    for root, _dirs, files in os.walk(step_dir):
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), step_dir)
            if rel in (MANIFEST_NAME, COMMIT_NAME):
                continue
            out.append(rel)
    return sorted(out)


def write_step_manifest(step_dir: str) -> Dict[str, Any]:
    """Manifest + COMMIT for a fully-written step dir. Both writes are
    atomic (tmp + os.replace): a crash leaves the dir uncommitted, never
    half-committed."""
    manifest = {
        "files": {
            rel: {
                "size": os.path.getsize(os.path.join(step_dir, rel)),
                "sha256": _sha256_file(os.path.join(step_dir, rel)),
            }
            for rel in _step_files(step_dir)
        },
        "committed_at": time.time(),
    }
    mpath = os.path.join(step_dir, MANIFEST_NAME)
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, mpath)
    cpath = os.path.join(step_dir, COMMIT_NAME)
    tmp = cpath + ".tmp"
    with open(tmp, "w") as f:
        f.write("committed\n")
    os.replace(tmp, cpath)
    return manifest


def verify_step_dir(step_dir: str) -> Optional[str]:
    """None when the step dir verifies (COMMIT present, every manifest
    entry matches on size + sha256, no manifest-unknown payload files),
    else the failure reason. Dirs with no COMMIT are uncommitted by
    definition."""
    if not os.path.isdir(step_dir):
        return "missing step dir"
    if not os.path.exists(os.path.join(step_dir, COMMIT_NAME)):
        return "no COMMIT marker (uncommitted/torn save)"
    mpath = os.path.join(step_dir, MANIFEST_NAME)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        entries = manifest["files"]
    except (OSError, ValueError, KeyError) as exc:
        return f"unreadable manifest: {exc!r}"
    on_disk = set(_step_files(step_dir))
    missing = set(entries) - on_disk
    if missing:
        return f"manifest files missing on disk: {sorted(missing)[:3]}"
    for rel, expected in entries.items():
        path = os.path.join(step_dir, rel)
        size = os.path.getsize(path)
        if size != expected.get("size"):
            return f"{rel}: size mismatch ({size} != {expected.get('size')})"
        if _sha256_file(path) != expected.get("sha256"):
            return f"{rel}: checksum mismatch"
    return None


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass
class _Snapshot:
    """One save's host copy: the bytes of every tensor back to back in one
    (pinned, for CUDA tensors) buffer, and the index that names them."""

    index: Dict[str, Any]
    data: torch.Tensor  # uint8, host


def _snapshot(state: Any, buffer: Optional[torch.Tensor],
              keep: Optional[Callable[[str], bool]] = None, data_file: str = DATA_NAME,
              scalars: bool = True) -> _Snapshot:
    """Copy every tensor of `state` (those whose path `keep` accepts) into
    a host buffer (reusing `buffer` when it has the size) and wait for the
    copies: once this returns the caller may update the state in place.
    The index names `data_file` for its tensors; `scalars=False` leaves
    the Python scalars out."""
    tensors: Dict[str, Any] = {}
    saved_scalars: Dict[str, Any] = {}
    leaves = []
    offset = 0
    for path, leaf in flatten(state):
        if isinstance(leaf, torch.Tensor):
            if keep is not None and not keep(path):
                continue
            nbytes = leaf.numel() * leaf.element_size()
            tensors[path] = {"dtype": _dtype_name(leaf.dtype), "shape": list(leaf.shape),
                             "offset": offset, "nbytes": nbytes, "file": data_file}
            leaves.append((offset, leaf))
            offset += -(-nbytes // _ALIGN) * _ALIGN
        elif leaf is None or isinstance(leaf, (bool, int, float, str)):
            if scalars:
                saved_scalars[path] = leaf
        else:
            raise TypeError(f"checkpoint: cannot save {type(leaf).__name__} at {path!r}")
    on_card = any(t.is_cuda for _, t in leaves)
    if buffer is None or buffer.numel() != offset or buffer.is_pinned() != on_card:
        buffer = torch.empty(offset, dtype=torch.uint8, pin_memory=on_card)
    for start, leaf in leaves:
        nbytes = leaf.numel() * leaf.element_size()
        dst = buffer[start:start + nbytes].view(leaf.dtype).view(leaf.shape)
        dst.copy_(leaf.detach(), non_blocking=leaf.is_cuda)
    if on_card:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    return _Snapshot({"tensors": tensors, "scalars": saved_scalars}, buffer)


def _dead_writer_tmp(name: str) -> bool:
    """True for `<step>.tmp-<pid>` whose writer process is gone."""
    step, _, pid = name.partition(".tmp-")
    if not (step.isdigit() and pid.isdigit()):
        return False
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return True
    except PermissionError:  # alive, another user's
        return False
    return False


def _write_files(tmp: str, snaps: Dict[str, _Snapshot]) -> None:
    """Each snapshot as `<name>.bin` + its index `<name>.json` (the
    replicated part is `state.bin` + `index.json`)."""
    for name, snap in snaps.items():
        data, index = _part_names(name)
        with open(os.path.join(tmp, data), "wb") as f:
            f.write(snap.data.numpy().data)
        with open(os.path.join(tmp, index), "w") as f:
            json.dump(snap.index, f)


def _part_names(name: str) -> Tuple[str, str]:
    if name == "state":
        return DATA_NAME, INDEX_NAME
    return f"{name}.bin", f"{name}.json"


def _write_step(directory: str, step: int, snaps: Dict[str, _Snapshot]) -> None:
    """Write one snapshot as `<directory>/<step>/`: data, index, manifest
    and COMMIT into a temporary directory, then one rename."""
    tmp = os.path.join(directory, f"{step}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    _write_files(tmp, snaps)
    write_step_manifest(tmp)
    os.replace(tmp, os.path.join(directory, str(step)))


def _read_step(step_dir: str, target: Any, device: torch.device, rank: int = 0,
               ranks: int = 1) -> Any:
    with open(os.path.join(step_dir, INDEX_NAME)) as f:
        index = json.load(f)
    saved_ranks = index.get("layout", {}).get("ranks", 1)
    if saved_ranks != ranks:
        raise ValueError(f"{step_dir}: saved by {saved_ranks} ranks, restored by {ranks}: "
                         f"a checkpoint restores on as many ranks as saved it")
    entries = dict(index["tensors"])
    if saved_ranks > 1:
        with open(os.path.join(step_dir, _part_names(f"rank{rank}")[1])) as f:
            entries.update(json.load(f)["tensors"])
    data: Dict[str, torch.Tensor] = {}

    def leaf(path: str, want: Any) -> Any:
        if isinstance(want, torch.Tensor):
            entry = entries.get(path)
            if entry is None:
                raise KeyError(f"{step_dir}: no tensor at {path!r}")
            if list(want.shape) != entry["shape"]:
                raise ValueError(f"{step_dir}: {path!r} has shape {entry['shape']}, "
                                 f"the target {list(want.shape)}")
            name = entry.get("file", DATA_NAME)
            if name not in data:
                data[name] = torch.from_numpy(
                    np.fromfile(os.path.join(step_dir, name), dtype=np.uint8))
            start = entry["offset"]
            saved = data[name][start:start + entry["nbytes"]].view(getattr(torch, entry["dtype"]))
            out = saved.view(entry["shape"]).to(device=device, dtype=want.dtype, copy=True)
            return out.requires_grad_(True) if want.requires_grad else out
        if path in index["scalars"]:
            return index["scalars"][path]
        raise KeyError(f"{step_dir}: no value at {path!r}")

    return rebuild(target, leaf)


def _sharded_paths(specs: Optional[Dict[str, Any]], mesh: Any) -> Dict[str, Any]:
    """{path: spec} of the leaves whose spec splits them over an axis of
    size > 1: this rank holds a block of each."""
    if mesh is None or mesh.size == 1 or not specs:
        return {}

    def splits(entry) -> bool:
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        return any(mesh.shape[a] > 1 for a in axes)

    return {path: spec for path, spec in specs.items() if any(splits(e) for e in spec)}


class CheckpointManager:
    """Step-indexed checkpoint directory with retention + verification.

    save() accepts a tree of dicts, lists, tuples and dataclasses over
    tensors and Python scalars (e.g. TrainState); restore() takes a
    target tree of the same structure (real or meta tensors) and returns
    a new one. With a `mesh` of n > 1 ranks every rank makes the same
    calls in the same order (one gloo group of the manager's own is built
    here, a collective call): the leaves that `specs` splits over the mesh
    are saved and restored per rank."""

    def __init__(
        self,
        directory: Union[str, os.PathLike],
        *,
        max_to_keep: int = 3,
        async_save: bool = False,
        mesh: Any = None,
    ):
        self.directory = os.path.abspath(os.fspath(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.rank = self.mesh.rank if self.mesh is not None else 0
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        self._pending: Optional[int] = None  # the step the writer is writing
        self._buffers: Dict[str, torch.Tensor] = {}  # host buffers, reused across saves
        self._group = None
        self._token = str(os.getpid())
        if self.mesh is not None:
            import torch.distributed as dist

            # the ranks' barriers run on the writer thread, on a group apart
            # from the step's; rank 0's pid names the shared temporary dir
            self._group = dist.new_group(backend="gloo")
            token = [self._token]
            dist.broadcast_object_list(token, src=0, group=self._group)
            self._token = token[0]
        if self.rank == 0:
            self._gc_uncommitted()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _step_dirs(self) -> List[int]:
        """Integer-named step directories on disk, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory) if name.isdigit())

    def _gc_uncommitted(self) -> int:
        """Remove integer-named step dirs without a COMMIT marker and the
        temporary dirs of writers that died: a crash strands them, and an
        uncommitted dir must never be offered for restore. (JAX leaves
        them alone in a directory no committed save ever reached, for
        orbax layouts that predate its manifest; the port has no such
        layout.) A temporary dir whose writer process still runs is in
        flight and stays."""
        from ..util.events import emit

        removed = 0
        for name in sorted(os.listdir(self.directory)):
            path = os.path.join(self.directory, name)
            if name.isdigit():
                if os.path.exists(os.path.join(path, COMMIT_NAME)):
                    continue
            elif not _dead_writer_tmp(name):
                continue
            emit("WARNING", "train",
                 f"GC'd uncommitted checkpoint step dir {name} "
                 f"(torn save)", kind="ckpt.gc", directory=self.directory)
            shutil.rmtree(path, ignore_errors=True)
            removed += 1
        return removed

    def save(self, step: int, state: Any, *, force: bool = False,
             specs: Optional[Dict[str, Any]] = None) -> bool:
        """Save `state` as step `step`; False (nothing written) when a step
        at or past it exists already, as orbax's `should_save` decides
        (`force=True` saves regardless, but never over an existing step).
        Returns once every tensor is copied to host: with async_save the
        write, manifest and COMMIT finish on the writer thread. `specs`
        ({leaf path: PartitionSpec}) names the rank-sharded leaves."""
        self.wait_until_finished()
        latest = self.latest_step()
        if not force and latest is not None and latest >= step:
            return False
        if os.path.exists(self._step_dir(step)):
            raise FileExistsError(f"checkpoint step {step} exists under {self.directory}")
        snaps = self._snapshots(state, specs)
        if not self.async_save:
            self._write(step, snaps)
            return True
        self._pending = step
        self._writer = threading.Thread(
            target=self._write_async, args=(step, snaps), daemon=True, name="ckpt-writer")
        self._writer.start()
        return True

    def _snapshots(self, state: Any, specs: Optional[Dict[str, Any]]) -> Dict[str, _Snapshot]:
        """The host copies this rank writes: the whole state on one rank;
        in a gang, the replicated part on rank 0 and each rank's block of
        the sharded leaves."""
        sharded = _sharded_paths(specs, self.mesh)
        parts: Dict[str, Any] = {}
        if self.mesh is None:
            parts["state"] = dict()
        else:
            if self.rank == 0:
                parts["state"] = dict(keep=lambda path: path not in sharded)
            name = f"rank{self.rank}"
            parts[name] = dict(keep=lambda path: path in sharded, data_file=f"{name}.bin",
                               scalars=False)
        snaps = {}
        for name, kwargs in parts.items():
            snaps[name] = _snapshot(state, self._buffers.get(name), **kwargs)
            self._buffers[name] = snaps[name].data
        if self.mesh is not None and self.rank == 0:
            layout = {}
            for path, leaf in flatten(state):
                if path in sharded:
                    spec = sharded[path]
                    layout[path] = {"spec": [list(e) if isinstance(e, tuple) else e for e in spec],
                                    "global_shape": _global_shape(self.mesh, spec, leaf.shape)}
            snaps["state"].index["layout"] = {"ranks": self.mesh.size, "sharded": layout}
        return snaps

    def _write(self, step: int, snaps: Dict[str, _Snapshot]) -> None:
        if self.mesh is None:
            _write_step(self.directory, step, snaps)
        else:
            self._write_gang(step, snaps)
        if self.max_to_keep and self.rank == 0:  # retention: the newest max_to_keep steps
            for old in self._step_dirs()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def _write_gang(self, step: int, snaps: Dict[str, _Snapshot]) -> None:
        """Every rank's files into one temporary dir; rank 0 commits it
        once all are there; every rank returns once it is committed."""
        import torch.distributed as dist

        tmp = os.path.join(self.directory, f"{step}.tmp-{self._token}")
        if self.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        dist.barrier(group=self._group)
        _write_files(tmp, snaps)
        dist.barrier(group=self._group)
        if self.rank == 0:
            write_step_manifest(tmp)
            os.replace(tmp, self._step_dir(step))
        dist.barrier(group=self._group)

    def _write_async(self, step: int, snaps: Dict[str, _Snapshot]) -> None:
        try:
            self._write(step, snaps)
        except BaseException as exc:  # noqa: BLE001 - re-raised by wait_until_finished
            self._writer_error = exc

    def _quarantine(self, step: int, reason: str) -> None:
        from ..util.events import emit
        from ..util.metrics import get_or_create_counter

        step_dir = self._step_dir(step)
        target = f"{step_dir}.corrupt-{int(time.time())}"
        try:
            os.replace(step_dir, target)
        except OSError:
            shutil.rmtree(step_dir, ignore_errors=True)
            target = "(removed)"
        emit("WARNING", "train",
             f"quarantined corrupt checkpoint step {step}: {reason}",
             kind="ckpt.quarantine",
             directory=self.directory, step=step, quarantined_to=target)
        get_or_create_counter(
            "raytpu_train_ckpt_fallback_total",
            "Checkpoint restores that fell back past a corrupt/torn "
            "checkpoint (quarantined).",
            ("store",),
        ).inc(tags={"store": "torch"})

    def restore(self, state_target: Any, step: Optional[int] = None, *,
                device: Union[str, torch.device] = "cuda") -> Any:
        """Restore into the structure of `state_target` (real or meta
        tensors give the dtypes and shapes), with its tensors on `device`.
        step=None → newest VERIFIED step; an explicitly requested step
        that fails verification is quarantined (by rank 0, in a gang) and
        the restore falls back to the newest step that verifies. In a gang
        each rank reads the replicated leaves and its own block of the
        sharded ones, as the step's index lays them out."""
        dev = resolve_device(device)
        self.wait_until_finished()
        candidates = sorted(self.all_steps(), reverse=True)
        if step is not None:
            # requested step first, then newest-first fallback
            candidates = [step] + [s for s in candidates if s != step]
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        ranks = self.mesh.size if self.mesh is not None else 1
        for candidate in candidates:
            reason = verify_step_dir(self._step_dir(candidate))
            if reason is None:
                return _read_step(self._step_dir(candidate), state_target, dev, self.rank, ranks)
            if self.rank == 0:
                self._quarantine(candidate, reason)
        raise FileNotFoundError(
            f"no VALID checkpoints under {self.directory} (all candidates "
            f"failed verification and were quarantined)"
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """Steps on disk, and the one the writer is writing."""
        steps = set(self._step_dirs())
        if self._pending is not None:
            steps.add(self._pending)
        return sorted(steps)

    def wait_until_finished(self) -> None:
        """Join the writer thread; re-raise what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
            self._pending = None
        if self._writer_error is not None:
            exc, self._writer_error = self._writer_error, None
            raise RuntimeError(f"checkpoint write failed: {exc!r}") from exc

    def close(self) -> None:
        self.wait_until_finished()
        self._buffers.clear()


def _global_shape(mesh: Any, spec: Any, shape: Any) -> List[int]:
    """The global shape of a leaf whose local block has `shape`."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        for axis in axes:
            out[dim] *= mesh.shape[axis]
    return out
