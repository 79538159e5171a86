"""Functions and classes that ray_tpu_torch's node agents import.

    (imported by node agents and by their callers; not run directly)

A cluster ships a task's function and an actor's class to a node agent
with the standard pickle, by reference (`ray_tpu_torch/core/cluster.py`),
so they must live in a module the agent can import: this one, at the root
of the checkout (`cluster_utils.Cluster.add_node` puts the driver's
`sys.path[0]` on the agent's PYTHONPATH). It imports only the standard
library and numpy when it loads; what needs the port imports it inside
the function.

- the CPU tests (`tests/test_torch_cluster.py`,
  `tests/test_torch_cluster_actors.py`): small functions and actors whose
  pids, values, errors and restarts the tests compare, and `TinyLLM`, a
  tiny Llama `LLMServer` hosted on an agent.
- `chip_smoke.py`'s `cluster` phase: `seeded_bytes` / `seeded_cuda_bf16`
  (the 1 GiB CPU and 256 MiB CUDA tensors made from a seed on both sides),
  `Noop` (the call round trip), `wire_stats` and `ClusterLLM`
  (Llama-3-8B's paged `LLMServer` on the agent's card, its launch counts
  and the dense check `dense_check_stats`, which `chip_smoke.py`'s own
  dense check also runs).
- federation (`tests/test_torch_federation.py`): `mark_request` and
  `mark_steps` record request and step marks on an agent, `agent_capture`
  keeps an agent busy while a capture runs.
- data on the cluster (`tests/test_torch_data_cluster.py`):
  `square_and_log`, `AddOffset`, `double_items`, `add_one_items`.
- `chip_smoke.py`'s `head_restart` phase: `ClusterLLM.serve_once` (one
  greedy request through the agent's engine and its dense check),
  `reset_counts` and `stats` (the launches since the reset and the card's
  allocated bytes).
- the capacity plane, jobs and DCN (`tests/test_torch_dcn.py`,
  `tests/test_torch_cuda.py`, `chip_smoke.py`'s `capacity` phase):
  `replica` / `replica_field` fetch a replicated pytree on the agent that
  holds it, `replica_digests` hashes its leaves and `replica_q8_errors`
  holds an int8 replica against the exact one there; `flash_fwd_check`
  launches the flash forward kernel on an agent's card and returns its
  error against the plain version, the pid and the launch count, and
  `flash_fwd_out` returns the kernel's output itself.
- the cluster-hosted gangs (`train.ClusterWorkerGroup`): `gang_steps`, a
  toy checkpoint-aware loop (`tests/test_torch_cluster_pg.py`'s re-mesh
  drill), and `gang_lm`, data-parallel `LMTrainer` steps with checkpoints
  and an emergency checkpoint on a preemption notice
  (`tests/test_torch_cluster_pg.py`'s gang against JAX's dp=2 run,
  `tests/test_torch_cuda.py`'s card gang, `chip_smoke.py`'s `gang` phase).
"""

from __future__ import annotations

import os
import time

import numpy as np


# ----------------------------------------------------------------- tasks


def replica(key: str):
    """The pytree replicated to this node under `key` (parallel/dcn)."""
    from ray_tpu_torch.parallel import fetch_replica

    return fetch_replica(key)


def replica_field(key: str, name: str):
    return replica(key)[name]


def leaf_digests(tree) -> dict:
    """{path: (dtype, shape, blake2b of the bytes)} of a pytree's tensor
    and array leaves, so two processes can compare trees bit for bit
    without shipping them."""
    import dataclasses
    import hashlib

    import torch

    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}/{i}")
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{path}/{f.name}")
        elif isinstance(x, torch.Tensor):
            t = x.detach().cpu().contiguous()
            raw = (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()
            out[path] = (str(t.dtype), tuple(t.shape), hashlib.blake2b(raw.tobytes()).hexdigest())
        elif isinstance(x, np.ndarray):
            out[path] = (x.dtype.str, x.shape, hashlib.blake2b(x.tobytes()).hexdigest())
        else:
            out[path] = repr(x)

    walk(tree, "")
    return out


def replica_digests(key: str) -> dict:
    """`leaf_digests` of the replica under `key`, with the device of every
    tensor leaf (the replica materializes on the CPU)."""
    import torch

    tree = replica(key)
    devices = set()

    def note(x):
        if isinstance(x, torch.Tensor):
            devices.add(str(x.device))
        elif isinstance(x, dict):
            for v in x.values():
                note(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                note(v)
        elif hasattr(x, "__dataclass_fields__"):
            for name in x.__dataclass_fields__:
                note(getattr(x, name))

    note(tree)
    return {"digests": leaf_digests(tree), "devices": sorted(devices), "pid": os.getpid()}


def replica_q8_errors(exact_key: str, q8_key: str) -> dict:
    """Each float leaf's largest error in the int8 replica against the
    exact one (both on this node), over the leaf's largest magnitude, and
    whether every other leaf arrived exact."""
    import torch

    exact, q8 = leaf_tensors(replica(exact_key)), leaf_tensors(replica(q8_key))
    worst, exact_others = {}, True
    for path, a in exact.items():
        b = q8[path]
        if isinstance(a, torch.Tensor) and a.is_floating_point() and a.numel() >= 4096:
            denom = max(float(a.abs().max()), 1e-9)
            worst[path] = float((b.float() - a.float()).abs().max()) / denom
            exact_others &= b.dtype == a.dtype and tuple(b.shape) == tuple(a.shape)
        elif isinstance(a, torch.Tensor):
            exact_others &= bool(torch.equal(a, b))
        else:
            exact_others &= a == b
    return {"worst_rel": max(worst.values()), "float_leaves": len(worst),
            "others_exact": bool(exact_others)}


def leaf_tensors(tree, path: str = "") -> dict:
    """{path: leaf} of a pytree of dicts, sequences and dataclasses."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(leaf_tensors(v, f"{path}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(leaf_tensors(v, f"{path}/{i}"))
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            out.update(leaf_tensors(getattr(tree, name), f"{path}/{name}"))
    else:
        out[path] = tree
    return out


def flash_fwd_check(seed: int, shape, dtype: str = "bfloat16", causal: bool = True,
                    device: str = "cuda") -> dict:
    """The flash forward kernel on this process's card against its plain
    version on the same inputs (made from `seed`): the largest error, the
    kernel's launches in this call, this pid, and whether the two outputs
    are bitwise equal. On device="cpu" the wrapper takes the plain version
    (a CPU rehearsal: no launch)."""
    import torch

    from ray_tpu_torch.ops import FLASH_FWD
    from ray_tpu_torch.ops.attention import _flash_fwd_plain, flash_attention_with_lse

    b, h, s, d = shape
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, d, generator=gen).to(device, getattr(torch, dtype))
               for _ in range(3))
    before = FLASH_FWD.launches
    out, _ = flash_attention_with_lse(q, k, v, causal=causal)
    launches = FLASH_FWD.launches - before
    ref, _ = _flash_fwd_plain(q, k, v, causal, 1.0 / d ** 0.5)
    return {"max_abs_err": float((out.float() - ref.float()).abs().max()),
            "bitwise": bool(torch.equal(out, ref)), "launches": launches,
            "pid": os.getpid(), "finite": bool(torch.isfinite(out).all()),
            "device": torch.cuda.get_device_name(0) if out.is_cuda else "cpu"}


def flash_fwd_out(seed: int, shape, dtype: str = "bfloat16", causal: bool = True):
    """The flash forward kernel's output on inputs made from `seed` (a
    CUDA tensor: it lands on the caller's card)."""
    import torch

    from ray_tpu_torch.ops.attention import flash_attention_with_lse

    b, h, s, d = shape
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, d, generator=gen).to("cuda", getattr(torch, dtype))
               for _ in range(3))
    return flash_attention_with_lse(q, k, v, causal=causal)[0]


def pid() -> int:
    return os.getpid()


def hold_pid(seconds: float) -> int:
    """Hold a CPU for `seconds`, then return this process's pid."""
    time.sleep(seconds)
    return os.getpid()


def arange_f64(n: int):
    return np.arange(n, dtype=np.float64)


def ones_f32(n: int):
    return np.ones(n, dtype=np.float32)


def total(x) -> float:
    return float(np.asarray(x).sum())


def item(x, i: int) -> float:
    return float(x[i])


def const(value):
    return value


def raise_value_error(message: str):
    raise ValueError(message)


def gen_pid(n: int):
    for i in range(n):
        yield (i, os.getpid())


def gen_full(n: int, size: int):
    for i in range(n):
        yield np.full(size, i, dtype=np.float64)


def sum_nested(wrapped) -> float:
    """`wrapped["ref"]` is an ObjectRef unpickled here: a borrowed
    reference, fetched from its owner."""
    import ray_tpu_torch

    return float(ray_tpu_torch.get(wrapped["ref"], timeout=30).sum())


def pid_of_arg(arr) -> int:
    return os.getpid()


def flood(log_path: str, hold_s: float) -> int:
    """Append 'S <ns>' / 'E <ns>' around a hold (O_APPEND atomic writes):
    the test reads the largest overlap of the intervals."""
    fd = os.open(log_path, os.O_WRONLY | os.O_APPEND)
    try:
        os.write(fd, f"S {time.monotonic_ns()}\n".encode())
        time.sleep(hold_s)
        os.write(fd, f"E {time.monotonic_ns()}\n".encode())
    finally:
        os.close(fd)
    return os.getpid()


def drip(i: int) -> int:
    time.sleep(0.15)
    return i


def slow_answer() -> int:
    time.sleep(1.0)
    return 41 + 1


def agent_stats() -> dict:
    from ray_tpu_torch.core.runtime import get_runtime

    return dict(get_runtime().cluster.agent_stats)


def ledger_available() -> dict:
    """This node's own view of its free resources (its ledger)."""
    from ray_tpu_torch.core.runtime import get_runtime

    return get_runtime().scheduler.head_node().resources.available()


class Member:
    """A bundle actor that reports where it runs."""

    def where(self) -> int:
        return os.getpid()


def wire_stats() -> dict:
    """This process's tensor-reducer counters (`core/rpc.py`)."""
    from ray_tpu_torch.core import rpc

    return dict(rpc.stats)


def seeded_bytes(seed: int, nbytes: int):
    """A CPU uint8 tensor of `nbytes` bytes from `seed` (numpy's PCG64):
    the same bytes in every process."""
    import torch

    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, nbytes, dtype=np.uint8))


def seeded_cuda_bf16(seed: int, numel: int):
    """A bf16 tensor on the current CUDA device from `seed` (the device's
    Philox generator): the same bits on every H100."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(numel, dtype=torch.bfloat16, device="cuda", generator=g)


def mark_request(rid: str) -> int:
    """An engine hop's marks of request `rid` on this node (submitted,
    first token with its TTFT buckets, finished); returns the pid."""
    from ray_tpu_torch.serve import reqlog

    reqlog.mark(rid, "engine.submitted", tenant="fed")
    reqlog.mark(rid, "engine.first_token", tenant="fed", ttft_s=0.5, queue_wait_s=0.25,
                preempt_wait_s=0.0, prefill_compute_s=0.25)
    reqlog.mark(rid, "engine.finished", tenant="fed")
    return os.getpid()


def mark_steps(run: str, steps: int) -> int:
    """Sampled-step marks of rank 1 of `run` on this node; returns the pid."""
    from ray_tpu_torch.train import steplog

    for step in range(steps):
        steplog.mark("data_wait", 0.25, run=run, rank=1, step=step)
        steplog.mark("fwd_bwd_compute", 0.01, run=run, rank=1, step=step)
        steplog.mark("other", 0.001, run=run, rank=1, step=step)
    return os.getpid()


def busy_matmuls(seconds: float) -> int:
    """Keep this node's CPU busy with small matrix products for
    `seconds` (a capture's workload); returns how many ran."""
    import torch

    x = torch.randn(128, 128)
    n = 0
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        x = torch.tanh(x @ x.T / 128.0)
        n += 1
    return n


def square_and_log(block, log_path: str):
    """A map udf that appends this process's pid to `log_path` and holds
    briefly, so blocks overlap across nodes."""
    fd = os.open(log_path, os.O_WRONLY | os.O_APPEND)
    try:
        os.write(fd, f"{os.getpid()}\n".encode())
    finally:
        os.close(fd)
    time.sleep(0.15)
    return {"item": block["item"] ** 2}


def double_items(block):
    return {"item": block["item"] * 2}


def add_one_items(block):
    return {"item": block["item"] + 1}


class AddOffset:
    """A stateful map udf (ActorPoolStrategy)."""

    def __init__(self, offset):
        self.offset = offset

    def __call__(self, block):
        return {"item": block["item"] + self.offset}


# ---------------------------------------------------------------- actors


class Counter:
    def __init__(self, start: int):
        self.value = start

    def add(self, n: int) -> int:
        self.value += n
        return self.value

    def pid(self) -> int:
        return os.getpid()


class Where:
    def where(self) -> int:
        return os.getpid()


class Flaky:
    def boom(self):
        raise RuntimeError("actor kaboom")

    def slow(self) -> str:
        time.sleep(5.0)
        return "done"


class Holder:
    def __init__(self):
        self.held = None

    def hold(self, wrapped) -> bool:
        self.held = wrapped["ref"]
        return True

    def value_sum(self) -> float:
        import ray_tpu_torch

        return float(ray_tpu_torch.get(self.held, timeout=30).sum())

    def release(self) -> bool:
        import gc

        self.held = None
        gc.collect()
        return True


class Survivor:
    def __init__(self):
        self.calls = 0

    def bump(self):
        self.calls += 1
        return (os.getpid(), self.calls)


class Mortal:
    def ping(self) -> int:
        return os.getpid()


class Slow:
    def nap(self, seconds: float) -> str:
        time.sleep(seconds)
        return "rested"

    def quick(self) -> int:
        return os.getpid()


class CudaHolder:
    """Holds `numel` f32 elements on this node's card (the stats
    snapshot's CUDA block reads them)."""

    def __init__(self, numel: int):
        import torch

        self.held = torch.ones(numel, device="cuda")

    def allocated(self) -> int:
        import torch

        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()


class Noop:
    def ping(self) -> None:
        return None


class TinyLLM:
    """A port `LLMServer` on the CPU of a node agent (`config` a
    TransformerConfig), on weights passed as a dict of tensors or as
    {"ref": an ObjectRef to one} (a borrowed reference:
    the agent pulls it from its owner over the chunked transfer)."""

    def __init__(self, config, params, engine_kwargs: dict):
        import ray_tpu_torch
        from ray_tpu_torch.serve.llm import LLMServer, PagedEngineConfig

        if isinstance(params, dict) and "ref" in params:
            params = ray_tpu_torch.get(params["ref"], timeout=60)
        self.server = LLMServer(config, params=params,
                                engine_config=PagedEngineConfig(**engine_kwargs), device="cpu")

    def generate(self, prompts, max_tokens: int):
        """Greedy tokens of every prompt, submitted together."""
        streams = [self.server.engine.submit(list(p), max_tokens=max_tokens) for p in prompts]
        return [s.result(timeout=120) for s in streams]

    def pid(self) -> int:
        return os.getpid()

    def shutdown(self) -> bool:
        self.server.shutdown()
        return True


def dense_check_stats(params, config, prompts, outs, picks, tail_gap: float) -> dict:
    """Teacher-forced dense forward over prompt + generated tokens of the
    requests `picks`: per position the gap between the dense argmax's
    logit and the engine token's. Returns worst gap, exact matches,
    positions, positions over `tail_gap`, and per request its worst gap,
    where, the row's max logit and its positions over `tail_gap`. The one
    definition of the dense check: `chip_smoke.py`'s phases and
    `ClusterLLM` call it."""
    import torch

    from ray_tpu_torch.models import forward

    device = next(iter(params.values())).device if isinstance(params, dict) else "cuda"
    worst, exact, total, over_tail, per = 0.0, 0, 0, 0, {}
    with torch.no_grad():
        for i in picks:
            seq = list(prompts[i]) + list(outs[i])
            tokens = torch.tensor([seq[:-1]], device=device)
            logits = forward(params, tokens, config)[0].float()
            if not torch.isfinite(logits).all():
                raise AssertionError("non-finite dense logits")
            rows = logits[len(prompts[i]) - 1:]
            chosen = torch.tensor(outs[i], device=device)
            top = rows.max(dim=-1).values
            gap = top - rows.gather(1, chosen[:, None])[:, 0]
            hit = rows.argmax(dim=-1) == chosen
            worst = max(worst, gap.max().item())
            exact += int(hit.sum())
            total += len(outs[i])
            over = int((gap > tail_gap).sum())
            over_tail += over
            at = int(gap.argmax())
            per[i] = (gap[at].item(), at, top[at].item(), over)
    return dict(worst=worst, exact=exact, total=total, over_tail=over_tail, per=per)


class ClusterLLM:
    """`chip_smoke.py`'s cluster phase, hosted on a node agent's card:
    Llama-3-8B's paged `LLMServer` (bf16 weights from `seed`, every pass
    captured up front; `n_layers` cuts its depth), the serve phase's
    requests submitted together, and the dense check on this node, where
    the weights are."""

    def __init__(self, model: str, seed: int, max_slots: int, n_layers=None):
        import torch

        from ray_tpu_torch.models import get_config
        from ray_tpu_torch.serve.llm import LLMServer, PagedConfig, PagedEngineConfig

        t0 = time.perf_counter()
        self.config = get_config(model).replace(param_dtype=torch.bfloat16)
        if n_layers is not None:
            self.config = self.config.replace(n_layers=n_layers)
        self.server = LLMServer(
            self.config, engine_config=PagedEngineConfig(max_slots=max_slots, precompile=True,
                                                         paged=PagedConfig()),
            seed=seed, device="cuda")
        torch.cuda.synchronize()
        self.build_s = time.perf_counter() - t0

    def info(self) -> dict:
        import torch

        return dict(pid=os.getpid(), build_s=self.build_s,
                    device=torch.cuda.get_device_name(torch.cuda.current_device()),
                    allocated=torch.cuda.memory_allocated(),
                    captures=len(self.server.engine.passes()))

    def serve(self, prompts, max_tokens: int, tail_gap: float, picks) -> dict:
        """Counts to 0, the requests submitted together (one thread per
        stream), counts read; then the dense check. Returns the tokens,
        the decode rate and the launches of the ragged kernel (through its
        wrapper + graph replays x captured) and of the flash forward (the
        dense check, through its wrapper)."""
        import threading

        from ray_tpu_torch.ops import FLASH_FWD, KERNELS, RAGGED

        engine = self.server.engine
        engine.generate([1] * 64, 2)  # warm: the eager sampler, the pinned allocator
        for k in KERNELS:
            k.launches = 0
        before = engine.stats()
        stamps = [[] for _ in prompts]
        t_start = time.perf_counter()
        streams = [engine.submit(list(p), max_tokens=max_tokens) for p in prompts]

        def consume(i):
            for token in streams[i]:
                stamps[i].append((time.perf_counter(), token))

        threads = [threading.Thread(target=consume, args=(i,)) for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        wall = time.perf_counter() - t_start
        after = engine.stats()
        outs = [[tok for _, tok in st] for st in stamps]
        ragged = RAGGED.launches + int(after.get(f"launches.{RAGGED.name}", 0)
                                       - before.get(f"launches.{RAGGED.name}", 0))
        first = min(st[0][0] for st in stamps)
        last = max(st[-1][0] for st in stamps)
        decode = sum(len(st) - 1 for st in stamps) / (last - first)
        flash_before = FLASH_FWD.launches
        t0 = time.perf_counter()
        check = dense_check_stats(engine.params, self.config, prompts, outs, picks, tail_gap)
        return dict(outs=outs, wall_s=wall, decode_tok_s=decode, check=check,
                    check_s=time.perf_counter() - t0,
                    launches={RAGGED.name: ragged, FLASH_FWD.name: FLASH_FWD.launches - flash_before})

    def reset_counts(self) -> None:
        """Set the kernels' launch counts to 0 (and take the engine's graph
        launches as the baseline) before a run `stats()` reads."""
        from ray_tpu_torch.ops import KERNELS

        for k in KERNELS:
            k.launches = 0
        self._base = self.server.engine.stats()

    def serve_once(self, prompt, max_tokens: int, tail_gap: float) -> dict:
        """One greedy request through the engine, then the dense check of
        its tokens: the tokens, the request's id (its reqlog marks'
        `rid`), this process's pid, the wall and decode rate, the check's
        stats (`dense_check_stats`) and seconds."""
        t0 = time.perf_counter()
        stream = self.server.engine.submit(list(prompt), max_tokens=max_tokens)
        stamps = [(time.perf_counter(), tok) for tok in stream]
        wall = time.perf_counter() - t0
        tokens = [tok for _, tok in stamps]
        decode = ((len(stamps) - 1) / (stamps[-1][0] - stamps[0][0])
                  if len(stamps) > 1 and stamps[-1][0] > stamps[0][0] else 0.0)
        t1 = time.perf_counter()
        check = dense_check_stats(self.server.engine.params, self.config, [prompt], [tokens],
                                  [0], tail_gap)
        return dict(tokens=tokens, rid=stream.request_id, pid=os.getpid(), wall_s=wall,
                    decode_tok_s=decode, check=check, check_s=time.perf_counter() - t1)

    def stats(self) -> dict:
        """Launches since `reset_counts()` (ragged: through its wrapper +
        graph replays x captured; flash forward: through its wrapper) and
        the card's allocated bytes."""
        import torch

        from ray_tpu_torch.ops import KERNELS, RAGGED

        after = self.server.engine.stats()
        base = getattr(self, "_base", {})
        key = f"launches.{RAGGED.name}"
        launches = {k.name: k.launches for k in KERNELS}
        launches[RAGGED.name] += int(after.get(key, 0) - base.get(key, 0))
        return dict(launches=launches, allocated=torch.cuda.memory_allocated())

    def shutdown(self) -> bool:
        self.server.shutdown()
        return True


# ------------------------------------------------------------ train gangs


def gang_steps(config: dict) -> int:
    """A toy loop of the gang's control plane (no collectives): a falling
    loss per step, each step a checkpoint, resumed after
    `config["resume_from_step"]` (the controller's latest checkpoint).
    Returns the first step this attempt ran."""
    from ray_tpu_torch.train import report

    resume = config.get("resume_from_step")
    start = resume + 1 if resume is not None else 0
    for step in range(start, config["total_steps"]):
        time.sleep(config["step_s"])
        report({"loss": 1.0 / (step + 1.0), "step": step}, checkpoint_step=step)
    return start


def gang_lm(config: dict) -> list:
    """One rank of a data-parallel language-model gang: `LMTrainer(
    mesh_spec=MeshSpec(dp=world))` on `config["device"]` (`model_overrides`
    replace fields of the named config, a dtype by its torch name), the same global
    batch `config["tokens"]` every step (this rank's rows), so the batch at
    step s depends on s and the seed alone. The state starts from
    `config["init"]` (numpy, e.g. JAX's initial state) or from the seed.

    With `ckpt_dir`, the state is saved after every `ckpt_every`-th step
    and when the controller asks for an emergency checkpoint; the ranks
    decide together (one all-reduce a step carries the flags and every
    rank's kernel launches), so they save the same step. A resumed attempt
    restores the step after `resume_from_step`. After an emergency
    checkpoint under a preemption notice the loop stops. Each step
    reports its index, its loss, its seconds (ended by a device
    synchronisation), the attempt's first step and the launches of K1 /
    K2 (dkv, dq) by rank, then sleeps `step_pause_s` (a drill's pacing,
    outside the step). Outside a gang (no session) it runs the same steps
    in one process. Returns the losses of this attempt."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.ops import FLASH_BWD_DKV, FLASH_BWD_DQ, FLASH_FWD
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.train import (CheckpointConfig, LMTrainer, default_optimizer,
                                     train_state_from_numpy)
    from ray_tpu_torch.train.session import _local

    session = getattr(_local, "session", None)  # None: one process, outside a gang

    torch.set_num_threads(config.get("threads", torch.get_num_threads()))
    distributed = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if distributed else 0
    world = dist.get_world_size() if distributed else 1
    kernels = (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ)
    for k in kernels:
        k.launches = 0
    model = get_config(config["model"]).replace(**{
        k: getattr(torch, v) if k.endswith("dtype") else v
        for k, v in config.get("model_overrides", {}).items()})
    opt = default_optimizer(config["lr"], total_steps=config["total_steps"],
                            **{k: config[k] for k in ("warmup_steps",) if k in config})
    ckpt_dir = config.get("ckpt_dir")
    trainer = LMTrainer(
        model, mesh_spec=MeshSpec(dp=world), optimizer=opt, seed=config.get("seed", 0),
        total_steps=config["total_steps"], device=config["device"],
        dp_allreduce_dtype="f32", dp_shard_update=False,
        checkpoint_config=(CheckpointConfig(checkpoint_dir=ckpt_dir, checkpoint_every=0,
                                            async_save=False) if ckpt_dir else None))
    if config.get("init") is not None:
        trainer.state = train_state_from_numpy(config["init"], model, mesh=trainer.mesh)
    resume = config.get("resume_from_step")
    start = 0
    if resume is not None:
        start = trainer.restore(resume + 1)
    batch = trainer._place({"tokens": torch.from_numpy(np.asarray(config["tokens"]))})
    batch = {"tokens": batch["tokens"].to(trainer.device)}
    cuda = trainer.device.type == "cuda"
    # the per-step all-reduce's device: gloo reduces CPU tensors, NCCL CUDA ones
    flag_device = trainer.device if distributed and dist.get_backend() == "nccl" else "cpu"
    every = config.get("ckpt_every", 0)
    losses = []
    for step in range(start, config["steps"]):
        t = time.perf_counter()
        trainer.state, metrics = trainer.step_fn(trainer.state, batch)
        loss = metrics["loss"].item()  # reads the device: the step is done
        if cuda:
            torch.cuda.synchronize(trainer.device)
        step_s = time.perf_counter() - t
        losses.append(loss)
        votes = torch.zeros(2 + 3 * world, dtype=torch.int64)
        votes[0] = int(bool(ckpt_dir) and ((every and (step + 1) % every == 0)
                                           or (session is not None and session.should_checkpoint())))
        votes[1] = int(session is not None and session.is_preempted())
        votes[2 + 3 * rank: 5 + 3 * rank] = torch.tensor([k.launches for k in kernels])
        if distributed:
            votes = votes.to(flag_device)
            dist.all_reduce(votes, op=dist.ReduceOp.MAX)
            votes = votes.cpu()
        saved = None
        if votes[0]:
            trainer.save_checkpoint()
            saved = step
        launches = votes[2:].view(world, 3).tolist()
        if session is not None:
            session.report({"step": step, "loss": loss, "step_s": step_s, "rank": rank,
                            "start": start, "launches": launches}, checkpoint_step=saved)
        if votes[1] and saved is not None:
            break  # the emergency checkpoint is down: leave the window to the restart
        time.sleep(config.get("step_pause_s", 0.0))
    return losses
