"""Chaos injection: schedule perturbation for fault-tolerance testing.

Port of `ray_tpu/core/chaos.py`, with JAX's config, environment grammar
and injection order. Probabilistic failures and delays fire at the
execution boundary: a task's run in the scheduler, an actor method call,
a task a node agent runs for a remote owner. An injected failure is
`ChaosInjectedError`, an ordinary task error (retriable under
`max_retries`), so the recovery paths run exactly as for a real fault.

Configure it with `set_chaos(...)` or through the environment, read at
`init`: RAY_TPU_CHAOS="failure_prob=0.3,delay_s=0.01,max_injections=5,
name_filter=flaky".

`kill_node=1` escalates an injection from a task error to the death of
the process (`os._exit(137)`): armed on a node agent, a task matching
`name_filter` takes the whole agent down mid-task, as a host loss does,
and the cluster finds out through heartbeat staleness.

`preempt_node=1` models an announced node loss: the matching task's node
enters PREEMPTING with a `preempt_warning_s` window (announced on the GCS
pub/sub, so schedulers stop placing there and train controllers take an
emergency checkpoint), and dies only after the window. Whoever registered
the preemption hook does the draining (`core/runtime.py` for logical
nodes of one process, `core/cluster.py` for a whole node agent); chaos
only pulls the trigger.

The RPC knobs (`rpc_error_prob`, `rpc_delay_s`, `rpc_drop_prob`) act in
`RpcClient.call` before the frame is sent (`rpc_action`).

`kill_head=1` is the head's drill: the head process dies (`os._exit(137)`,
no final snapshot) from its GCS snapshot loop once `delay_s` has passed
since chaos was armed (`maybe_kill_head`), never from `maybe_inject`, so
no task can take the head down. The WAL, `--restore` and the
reconciliation after it are what must survive it.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Optional

import numpy as np

class ChaosInjectedError(RuntimeError):
    """Raised by the chaos layer in place of running the task body."""


@dataclasses.dataclass
class ChaosConfig:
    failure_prob: float = 0.0
    delay_s: float = 0.0
    max_injections: int = -1  # -1 = unlimited
    name_filter: Optional[str] = None  # substring match on the task's name
    seed: int = 0
    kill_node: bool = False  # a matching task kills THIS process (node death)
    # kill_head=1 kills the HEAD process (os._exit) from its snapshot loop
    # once `delay_s` has passed since chaos was armed (maybe_kill_head)
    kill_head: bool = False
    # RPC-layer injection (RpcClient.call): transport errors, added
    # latency and connection drops
    rpc_error_prob: float = 0.0
    rpc_delay_s: float = 0.0
    rpc_drop_prob: float = 0.0
    # announced preemption: the matching task's node drains for
    # preempt_warning_s, then dies
    preempt_node: bool = False
    preempt_warning_s: float = 5.0


class _ChaosState:
    def __init__(self):
        self.config: Optional[ChaosConfig] = None
        self.injected = 0
        self.rng = np.random.default_rng(0)
        self.lock = threading.Lock()
        self.armed_ts = 0.0  # monotonic time of the last set_chaos()
        # callable(node, warning_s, reason) installed by the runtime: node
        # is the scheduler's logical Node when known (task and actor
        # boundaries), None for "this whole process" (the agent boundary)
        self.preempt_hook = None


_state = _ChaosState()


def set_chaos(
    failure_prob: float = 0.0,
    delay_s: float = 0.0,
    max_injections: int = -1,
    name_filter: Optional[str] = None,
    seed: int = 0,
    kill_node: bool = False,
    rpc_error_prob: float = 0.0,
    rpc_delay_s: float = 0.0,
    rpc_drop_prob: float = 0.0,
    preempt_node: bool = False,
    preempt_warning_s: float = 5.0,
    kill_head: bool = False,
) -> None:
    with _state.lock:
        _state.config = ChaosConfig(
            failure_prob, delay_s, max_injections, name_filter, seed,
            kill_node, kill_head, rpc_error_prob, rpc_delay_s,
            rpc_drop_prob, preempt_node, preempt_warning_s,
        )
        _state.injected = 0
        _state.armed_ts = time.monotonic()
        _state.rng = np.random.default_rng(seed)


def set_preemption_hook(hook) -> None:
    """Register the callable that drains and kills a node when a
    preempt_node injection fires: hook(node, warning_s, reason). The
    runtime installs its own at init; tests may swap it."""
    _state.preempt_hook = hook


def trigger_preemption(node, warning_s: float, reason: str,
                       mode: str = "spot_preempt") -> bool:
    """Pull the announced-preemption trigger outside the task boundary:
    emit the chaos.injected event, then run the registered hook. False
    when no hook is installed (the runtime has shut down)."""
    hook = _state.preempt_hook
    if hook is None:
        return False
    node_id = getattr(node, "node_id", None)
    from ..util.events import emit

    emit("WARNING", "chaos", f"chaos injected {mode}: {reason}",
         kind="chaos.injected", mode=mode,
         node=node_id.hex() if node_id is not None else None)
    hook(node, warning_s, reason)
    return True


def clear_chaos() -> None:
    with _state.lock:
        _state.config = None
        _state.injected = 0


def num_injected() -> int:
    return _state.injected


def load_from_env() -> None:
    """Arm chaos from RAY_TPU_CHAOS (JAX's grammar: comma-separated
    key=value, unknown keys ignored)."""
    raw = os.environ.get("RAY_TPU_CHAOS")
    if not raw:
        return
    kwargs = {}
    for part in raw.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k in ("failure_prob", "delay_s", "rpc_error_prob", "rpc_delay_s",
                 "rpc_drop_prob", "preempt_warning_s"):
            kwargs[k] = float(v)
        elif k in ("max_injections", "seed"):
            kwargs[k] = int(v)
        elif k in ("kill_node", "preempt_node", "kill_head"):
            kwargs[k] = v.strip().lower() in ("1", "true", "yes", "on")
        elif k == "name_filter":
            kwargs[k] = v
    set_chaos(**kwargs)


def maybe_inject(task_name: str, node=None) -> None:
    """Called before a task body runs. `node` is the logical Node running
    the task where the boundary knows it (the local scheduler, an actor's
    mailbox); None at the agent boundary, where the target of a node-level
    injection is this whole process."""
    config = _state.config
    if config is None:
        return
    if config.name_filter and config.name_filter not in task_name:
        return
    # decide and count under the lock; sleep OUTSIDE it, so injected delays
    # stay concurrent across threads. Delays count against max_injections.
    delay = 0.0
    fail_ordinal = 0
    kill = False
    preempt = False
    with _state.lock:
        if 0 <= config.max_injections <= _state.injected:
            return
        if config.preempt_node and _state.preempt_hook is not None:
            _state.injected += 1
            preempt = True
        if not preempt and config.kill_node:
            _state.injected += 1
            kill = True
        if not kill and not preempt and config.delay_s > 0:
            delay = config.delay_s
            _state.injected += 1
        if (
            not kill
            and not preempt
            and config.failure_prob > 0
            # a failure is an injection of its own even when a delay fired
            # in the same call: re-check the budget and count it apart, so
            # max_injections bounds the total and fail ordinals are unique
            and not (0 <= config.max_injections <= _state.injected)
            and _state.rng.random() < config.failure_prob
        ):
            _state.injected += 1
            fail_ordinal = _state.injected
    if preempt or kill or delay > 0 or fail_ordinal:
        # the event lands BEFORE the perturbation: a postmortem must show
        # the injection even when it is os._exit
        mode = ("preempt_node" if preempt else "kill_node" if kill
                else "delay" if delay > 0 else "failure")
        node_id = getattr(node, "node_id", None)
        from ..util.events import emit

        emit("WARNING", "chaos", f"chaos injected {mode} via task {task_name!r}",
             kind="chaos.injected", mode=mode,
             node=node_id.hex() if node_id is not None else None)
    if preempt:
        # announced death: the hook drains the task's node for the window
        # and kills it afterwards; the triggering task itself runs on
        hook = _state.preempt_hook
        if hook is not None:  # may race a runtime shutdown
            hook(node, config.preempt_warning_s,
                 f"chaos: preemption notice via task {task_name!r}")
        return
    if kill:
        # abrupt node death: no cleanup, no deregistration
        os._exit(137)
    if delay > 0:
        time.sleep(delay)
    if fail_ordinal:
        raise ChaosInjectedError(
            f"chaos: injected failure in task {task_name!r} (#{fail_ordinal})"
        )


def maybe_kill_head() -> None:
    """Called from the HEAD's snapshot loop. With `kill_head` armed and
    `delay_s` passed since arming, the head dies at once (os._exit(137):
    no cleanup, no final snapshot). Counts against max_injections, so a
    restarted head that reads the same RAY_TPU_CHAOS does not die again
    unless armed anew."""
    config = _state.config
    if config is None or not config.kill_head:
        return
    with _state.lock:
        if 0 <= config.max_injections <= _state.injected:
            return
        if time.monotonic() - _state.armed_ts < config.delay_s:
            return
        _state.injected += 1
    from ..util.events import emit

    emit("WARNING", "chaos", "chaos injected kill_head: head dies now",
         kind="chaos.injected", mode="kill_head")
    os._exit(137)


def rpc_action(method: str) -> Optional[dict]:
    """Called by RpcClient.call before touching the wire: the perturbation
    for this call, {"delay": seconds, "fail": bool, "drop": bool}, or None.
    `fail` is a transport error before the frame is sent (the client's
    retry policy may resend it); `drop` severs the client's persistent
    connection first. All three count against max_injections and honour
    name_filter (matched on the RPC method's name)."""
    config = _state.config
    if config is None:
        return None
    if not (config.rpc_error_prob or config.rpc_delay_s or config.rpc_drop_prob):
        return None
    if config.name_filter and config.name_filter not in method:
        return None
    action = {"delay": 0.0, "fail": False, "drop": False}
    with _state.lock:
        if 0 <= config.max_injections <= _state.injected:
            return None
        if config.rpc_delay_s > 0:
            action["delay"] = config.rpc_delay_s
            _state.injected += 1
        if (
            config.rpc_drop_prob > 0
            and not (0 <= config.max_injections <= _state.injected)
            and _state.rng.random() < config.rpc_drop_prob
        ):
            action["drop"] = True
            _state.injected += 1
        if (
            config.rpc_error_prob > 0
            and not (0 <= config.max_injections <= _state.injected)
            and _state.rng.random() < config.rpc_error_prob
        ):
            action["fail"] = True
            _state.injected += 1
    if action["delay"] or action["fail"] or action["drop"]:
        return action
    return None
