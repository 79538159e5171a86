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
    captured up front), the serve phase's requests submitted together,
    and the dense check on this node, where the weights are."""

    def __init__(self, model: str, seed: int, max_slots: int):
        import torch

        from ray_tpu_torch.models import get_config
        from ray_tpu_torch.serve.llm import LLMServer, PagedConfig, PagedEngineConfig

        t0 = time.perf_counter()
        self.config = get_config(model).replace(param_dtype=torch.bfloat16)
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
