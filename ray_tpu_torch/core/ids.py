"""Unique identifiers for tasks, objects, actors, nodes and jobs.

A copy of `ray_tpu/core/ids.py` (the port imports nothing of `ray_tpu`).
Object ids embed the id of the creating task plus a return index, and
every id carries its job: given an ObjectID the runtime can always recover
which task produced it, which is what lineage reconstruction replays.
Fixed-width hex strings: ids never cross a wire here.
"""

from __future__ import annotations

import os
import threading

_JOB_NBYTES = 4
_UNIQUE_NBYTES = 12
_OBJECT_INDEX_NBYTES = 4


class BaseID:
    """A fixed-width, hashable, hex-rendered identifier."""

    __slots__ = ("_hex",)
    NBYTES = _UNIQUE_NBYTES

    def __init__(self, hex_str: str):
        if len(hex_str) != self.NBYTES * 2:
            raise ValueError(
                f"{type(self).__name__} expects {self.NBYTES * 2} hex chars, "
                f"got {len(hex_str)}"
            )
        self._hex = hex_str

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(os.urandom(cls.NBYTES).hex())

    @classmethod
    def nil(cls) -> "BaseID":
        return cls("0" * (cls.NBYTES * 2))

    def is_nil(self) -> bool:
        return self._hex == "0" * (self.NBYTES * 2)

    def hex(self) -> str:
        return self._hex

    def __hash__(self):
        return hash((type(self).__name__, self._hex))

    def __eq__(self, other):
        return type(other) is type(self) and other._hex == self._hex

    def __repr__(self):
        return f"{type(self).__name__}({self._hex})"


class JobID(BaseID):
    NBYTES = _JOB_NBYTES

    _counter = 0
    _lock = threading.Lock()

    @classmethod
    def next(cls) -> "JobID":
        with cls._lock:
            cls._counter += 1
            return cls(cls._counter.to_bytes(cls.NBYTES, "big").hex())


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class ActorID(BaseID):
    NBYTES = _JOB_NBYTES + _UNIQUE_NBYTES

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(job_id.hex() + os.urandom(_UNIQUE_NBYTES).hex())

    def job_id(self) -> JobID:
        return JobID(self._hex[: _JOB_NBYTES * 2])


class TaskID(BaseID):
    NBYTES = _JOB_NBYTES + _UNIQUE_NBYTES

    @classmethod
    def of(cls, job_id: JobID) -> "TaskID":
        return cls(job_id.hex() + os.urandom(_UNIQUE_NBYTES).hex())

    def job_id(self) -> JobID:
        return JobID(self._hex[: _JOB_NBYTES * 2])


class ObjectID(BaseID):
    """Derived from the creating TaskID plus a return index.

    Mirrors the ownership model of the reference (ObjectID = TaskID ⊕ index,
    src/ray/common/id.h): given an ObjectID you can always recover which task
    produced it, which is what makes lineage reconstruction possible.
    """

    NBYTES = TaskID.NBYTES + _OBJECT_INDEX_NBYTES

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.hex() + index.to_bytes(_OBJECT_INDEX_NBYTES, "big").hex())

    @classmethod
    def for_put(cls, job_id: JobID) -> "ObjectID":
        # ray.put objects are "owned" by a synthetic put-task.
        return cls.for_task_return(TaskID.of(job_id), 0)

    def task_id(self) -> TaskID:
        return TaskID(self._hex[: TaskID.NBYTES * 2])

    def return_index(self) -> int:
        return int(self._hex[TaskID.NBYTES * 2 :], 16)


class PlacementGroupID(BaseID):
    pass
