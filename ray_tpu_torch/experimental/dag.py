"""Compiled actor graphs: bind actor methods into a static graph, compile
once, execute many times over preallocated channels.

Port of `ray_tpu/experimental/dag.py` (reference: Ray Compiled Graphs,
dag_node.py bind, compiled_dag_node.py:805). Compiling launches one loop
per bound actor (through `__ray_apply__`, inside the actor: its worker
process for a process actor), which reads its inputs from channels,
calls the bound method and writes its output, until teardown; execute()
feeds the input channel and returns a future, so executions pipeline
without a task submission per call.

    with InputNode() as inp:
        x = preproc.transform.bind(inp)
        y = model.infer.bind(x)
    dag = y.experimental_compile()
    fut = dag.execute(batch)      # pipelined; returns a future
    out = fut.get()
    dag.teardown()

Each actor in the graph gives its execution thread to the loop until
teardown(). When any bound actor is a process actor, every edge is a
shared-memory channel (`ShmChannel`, at most SHM_CHANNEL_CAPACITY bytes
pickled per value, no CUDA tensors); an all-thread graph keeps the
in-process `Channel`, which passes objects (CUDA tensors included)
without a copy.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .channel import Channel, ChannelClosedError, ChannelReader
from .shm_channel import ShmChannel

# payload bound per shm edge (pickled); in-process edges are unbounded
SHM_CHANNEL_CAPACITY = 4 << 20


class _DagError:
    """An upstream exception flowing through the graph instead of a value."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class DAGNode:
    """Base: anything bindable into the graph."""

    def __init__(self):
        self._consumers = 0

    def experimental_compile(self) -> "CompiledDAG":
        return CompiledDAG([self])


class InputNode(DAGNode):
    """The DAG's single input (reference dag/input_node.py)."""

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        return None


class ClassMethodNode(DAGNode):
    """actor.method.bind(...) — one stage of the graph."""

    def __init__(self, handle, method_name: str, args: Tuple, kwargs: Dict):
        super().__init__()
        self.handle = handle
        self.method_name = method_name
        self.args = args
        for k, v in kwargs.items():
            if isinstance(v, DAGNode):
                raise ValueError(
                    f"kwarg {k!r} is a DAGNode; upstream values must be "
                    "positional in bind()"
                )
        self.kwargs = kwargs

    def bind_downstream_count(self) -> int:
        return self._consumers


class MultiOutputNode(DAGNode):
    """Wrap several leaves so execute() returns a list (reference
    dag/output_node.py)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__()
        self.outputs = list(outputs)

    def experimental_compile(self) -> "CompiledDAG":
        return CompiledDAG(self.outputs)


class _DAGFuture:
    """Result handle for one execute(); resolves in submission order."""

    def __init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def get(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("compiled DAG result not ready")
        if self._error is not None:
            raise self._error
        return self._value

    def _resolve(self, value: Any) -> None:
        if isinstance(value, _DagError):
            self._error = value.exc
        elif isinstance(value, list) and any(
            isinstance(v, _DagError) for v in value
        ):
            self._error = next(v.exc for v in value if isinstance(v, _DagError))
        else:
            self._value = value
        self._event.set()


def _dag_actor_loop(instance, method_name, arg_spec, readers, writer):
    """Runs INSIDE the actor (via __ray_apply__), pinned to its executor
    thread: read inputs → invoke the bound method → write output, until
    the upstream channel closes. Errors flow through as _DagError so the
    whole pipeline stays in lockstep and the failure surfaces at the
    output future, exactly one execution late of nothing."""
    method = getattr(instance, method_name)
    while True:
        try:
            chan_vals = [r.read() for r in readers]
        except ChannelClosedError:
            writer.close()
            return
        err = next((v for v in chan_vals if isinstance(v, _DagError)), None)
        if err is not None:
            out: Any = err
        else:
            args = [
                chan_vals[i] if kind == "chan" else const
                for kind, i, const in arg_spec
            ]
            try:
                out = method(*args)
            except BaseException as exc:  # noqa: BLE001 - ferried downstream
                out = _DagError(exc)
        try:
            writer.write(out)
        except ChannelClosedError:
            return


class CompiledDAG:
    def __init__(self, outputs: List[DAGNode]):
        self._outputs = outputs
        self._use_shm = False
        self._input_channel: Optional[Any] = None
        self._node_channels: Dict[int, Any] = {}
        self._output_readers: List[Any] = []
        self._loop_refs: List[Any] = []
        self._pending: "deque[_DAGFuture]" = deque()
        self._lock = threading.Lock()
        # serializes execute(): future-append order MUST equal input-write
        # order or concurrent executes cross-deliver results. Separate
        # from _lock so teardown() stays reachable while a write blocks.
        self._submit_lock = threading.Lock()
        self._torn_down = False
        self._compile()

    # ---------------------------------------------------------------- compile

    def _compile(self) -> None:
        # discover nodes + consumer counts
        nodes: List[ClassMethodNode] = []
        seen: Dict[int, DAGNode] = {}
        input_node: Optional[InputNode] = None
        consumers: Dict[int, int] = {}

        def visit(node: DAGNode) -> None:
            nonlocal input_node
            if id(node) in seen:
                return
            seen[id(node)] = node
            if isinstance(node, InputNode):
                if input_node is not None and input_node is not node:
                    raise ValueError(
                        "DAG has multiple InputNodes; build the whole graph "
                        "from ONE InputNode (the reference enforces this too)"
                    )
                input_node = node
                return
            if not isinstance(node, ClassMethodNode):
                raise TypeError(f"cannot compile node of type {type(node).__name__}")
            runtime = node.handle._runtime
            if runtime.actor_runtime(node.handle._actor_id).executor != "thread":
                self._use_shm = True  # cross-process edges: shm channels
            upstream = [a for a in node.args if isinstance(a, DAGNode)]
            if not upstream:
                raise ValueError(
                    f"node {node.method_name!r} has no upstream input; bind "
                    "it to InputNode or another node (a loop with no reader "
                    "would free-run)"
                )
            nodes.append(node)
            for arg in upstream:
                consumers[id(arg)] = consumers.get(id(arg), 0) + 1
                visit(arg)

        for out in self._outputs:
            consumers[id(out)] = consumers.get(id(out), 0) + 1
            visit(out)
        if input_node is None:
            raise ValueError("DAG has no InputNode")
        # One node per actor: each node dedicates the actor's (single)
        # executor thread to its loop, so a second node on the same actor
        # would never start and the DAG would hang at the first execute.
        actor_ids = [n.handle._actor_id for n in nodes]
        if len(set(actor_ids)) != len(actor_ids):
            raise ValueError(
                "an actor is bound to more than one DAG node; compiled "
                "DAGs dedicate one actor per node — use separate actors "
                "(or one method that does both steps)"
            )

        # one channel per producer, sized by its consumer count; mixed
        # thread/process DAGs use shm channels on EVERY edge (uniformity
        # beats per-edge type dispatch, and in-process reads of an shm
        # channel are still just mmap reads)
        def make_channel(n_readers: int):
            if self._use_shm:
                return ShmChannel(
                    capacity=SHM_CHANNEL_CAPACITY, num_readers=max(1, n_readers)
                )
            return Channel(num_readers=max(1, n_readers))

        self._input_channel = make_channel(consumers.get(id(input_node), 0))
        for node in nodes:
            self._node_channels[id(node)] = make_channel(
                consumers.get(id(node), 0)
            )
        next_reader: Dict[int, int] = {}

        def channel_for(node: DAGNode):
            if isinstance(node, InputNode):
                return self._input_channel
            return self._node_channels[id(node)]

        def reader_for(node: DAGNode):
            chan = channel_for(node)
            if self._use_shm:
                rid = next_reader.get(id(chan), 0)
                next_reader[id(chan)] = rid + 1
                return chan.reader(rid)
            return ChannelReader(chan)

        # launch the per-actor loops (downstream-first so readers attach
        # before any write can land)
        for node in nodes:
            readers: List[ChannelReader] = []
            arg_spec: List[Tuple[str, int, Any]] = []
            for arg in node.args:
                if isinstance(arg, DAGNode):
                    arg_spec.append(("chan", len(readers), None))
                    readers.append(reader_for(arg))
                else:
                    arg_spec.append(("const", -1, arg))
            ref = node.handle.__ray_apply__.remote(
                _dag_actor_loop, node.method_name, arg_spec, readers,
                self._node_channels[id(node)],
            )
            self._loop_refs.append(ref)
        self._output_readers = [reader_for(out) for out in self._outputs]
        self._collector = threading.Thread(
            target=self._collect, daemon=True, name="compiled-dag-collector"
        )
        self._collector.start()

    # ---------------------------------------------------------------- execute

    def execute(self, value: Any = None, timeout: Optional[float] = None) -> _DAGFuture:
        """Feed one input; returns a future. Executions pipeline: stage k
        of call i runs concurrently with stage k-1 of call i+1."""
        with self._submit_lock:
            with self._lock:
                if self._torn_down:
                    raise RuntimeError("compiled DAG is torn down")
                fut = _DAGFuture()
                self._pending.append(fut)
            # The blocking write runs outside self._lock (teardown needs it
            # to close the channel, which is what unblocks this write) but
            # INSIDE the submit lock, keeping append order == write order.
            try:
                self._input_channel.write(value, timeout=timeout)
            except BaseException:
                with self._lock:
                    # never leave an orphaned future: it would swallow the
                    # NEXT execution's result and desynchronize the rest
                    try:
                        self._pending.remove(fut)
                    except ValueError:
                        pass  # collector already resolved it
                raise
        return fut

    def _collect(self) -> None:
        while True:
            try:
                values = [r.read() for r in self._output_readers]
            except (ChannelClosedError, TimeoutError):
                with self._lock:
                    pending = list(self._pending)
                    self._pending.clear()
                err = RuntimeError("compiled DAG torn down with executions pending")
                for fut in pending:
                    fut._resolve(_DagError(err))
                return
            with self._lock:
                fut = self._pending.popleft() if self._pending else None
            if fut is not None:
                fut._resolve(values[0] if len(values) == 1 else values)

    # --------------------------------------------------------------- teardown

    def teardown(self, timeout: float = 10.0) -> None:
        """Close the graph: loops drain and exit, actors are released."""
        with self._lock:
            if self._torn_down:
                return
            self._torn_down = True
        self._input_channel.close()
        from .. import api

        for ref in self._loop_refs:
            try:
                api.get(ref, timeout=timeout)
            except Exception:
                pass  # loop errors already surfaced via _DagError values
        if self._use_shm:
            self._input_channel.unlink()
            for chan in self._node_channels.values():
                chan.close()
                chan.unlink()

    def __del__(self):
        try:
            self.teardown(timeout=1.0)
        except Exception:
            pass
