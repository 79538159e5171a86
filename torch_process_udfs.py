"""Functions and classes that ray_tpu_torch's process workers import.

    (imported by worker processes and by their callers; not run directly)

A process-executor task, a process actor and a map stage with
`executor="process"` send their function or class to the worker with the
standard pickle, by reference (`ray_tpu_torch/core/worker_pool.py`), so
it must live in a module the worker can import: this one, at the root of
the checkout, like the gang ranks' `torch_dp_rank.py`. It imports only
the standard library and numpy when it loads, so a JAX worker importing
it (the CPU tests run the same programs through both packages) starts
without torch; what needs the port imports it inside the function.

- `chip_smoke.py`'s `process` phase: `normalize_text` and
  `tokenize_pack` (the per-document ingest UDF: normalise, encode with
  `ByteTokenizer`, pack windows of `WINDOW` tokens), the `Preproc`
  process actor (tokenises and pads prompts) and the `LM` thread actor
  (GPT-2 on the card, the next-token argmax as a CPU array).
- the CPU tests (`tests/test_torch_worker_pool.py`, `_health.py`,
  `_dag.py`, `_native_store.py`, `_data.py`, `_util_pool.py`): small
  functions and actors whose results, pids, errors and restarts the
  tests compare.
"""

from __future__ import annotations

import importlib
import os
import time

import numpy as np

WINDOW = 1025  # GPT-2's training window: 1024 inputs + the last target
EOT = 0  # the document separator: byte 0 never occurs in the corpus's text
_PUNCT = ".,;:!?\"'()[]{}"


# ------------------------------------------------------------- chip_smoke


def normalize_text(text: str) -> str:
    """Lower-case every word, strip its punctuation, write numbers as
    `<num>` and collapse the whitespace: a Python loop over the words,
    which holds the interpreter lock."""
    words = []
    for word in text.split():
        w = word.strip(_PUNCT).lower()
        if not w:
            continue
        if w.isdigit():
            w = "<num>"
        words.append(w)
    return " ".join(words)


def tokenize_pack(block):
    """The ingest UDF: each document of a block ({"text": uint8 (n, width),
    "len": (n,)} of ASCII bytes) normalised and byte-encoded, the block's
    documents joined by EOT, cut into windows of WINDOW tokens (the
    remainder dropped): {"tokens": int32 (windows, WINDOW)}."""
    from ray_tpu_torch.serve.llm.openai import ByteTokenizer

    stream = []
    for row, n in zip(block["text"], block["len"]):
        stream.extend(ByteTokenizer.encode(normalize_text(row[:n].tobytes().decode("ascii"))))
        stream.append(EOT)
    n_windows = len(stream) // WINDOW
    tokens = np.asarray(stream[:n_windows * WINDOW], dtype=np.int32)
    return {"tokens": tokens.reshape(n_windows, WINDOW)}


class Preproc:
    """A process actor in front of the model: tokenises prompts and pads
    them to `seq` tokens."""

    def __init__(self, seq: int):
        self.seq = seq

    def transform(self, prompts):
        from ray_tpu_torch.serve.llm.openai import ByteTokenizer

        out = np.zeros((len(prompts), self.seq), np.int64)
        for i, prompt in enumerate(prompts):
            ids = ByteTokenizer.encode(normalize_text(prompt))[:self.seq]
            out[i, :len(ids)] = ids
        return out


class LM:
    """A thread actor holding a model on the card: infer() returns the
    next-token argmax at every position as a CPU array (the logits of 8 x
    1024 positions would not fit a shared-memory edge)."""

    def __init__(self, model: str, seed: int, device: str = "cuda"):
        from ray_tpu_torch.models import get_config, init_params

        self.config = get_config(model)
        self.device = device
        self.params = init_params(self.config, seed, device=device)

    def infer(self, tokens):
        import torch

        from ray_tpu_torch.models import forward

        with torch.no_grad():
            logits = forward(self.params, torch.as_tensor(tokens, device=self.device), self.config)
            return logits.argmax(-1).cpu().numpy()


# -------------------------------------------------------------- CPU tests


def square(x):
    return x * x


def add_mul(a, b):
    return a + b, a * b


def getpid(*_):
    return os.getpid()


def read_env(name):
    return os.environ.get(name)


def crash():
    os._exit(42)


def crash_once(path):
    """Kill the worker the first time (leaving a marker), answer after."""
    if not os.path.exists(path):
        open(path, "w").close()
        os._exit(3)
    return "recovered"


def boom(msg):
    raise ValueError(msg)


def sleep_double(x, seconds):
    time.sleep(seconds)
    return x * 2


def chdir_away(path):
    os.chdir(path)
    return os.getcwd()


def cwd():
    return os.getcwd()


def import_attr(module: str, attr: str):
    """(cwd, module.attr): a module that only a runtime env's working_dir
    or py_modules makes importable."""
    return os.getcwd(), getattr(importlib.import_module(module), attr)


def array_view_info(arr):
    """What a worker sees of an array argument."""
    return float(np.sum(arr)), tuple(arr.shape), bool(arr.flags.writeable), arr.base is not None


def block_view_info(block):
    return {k: (float(np.sum(v)), bool(v.flags.writeable)) for k, v in sorted(block.items())}


def tag_pid(block):
    return {"x": block["x"] * 3 + 1,
            "pid": np.full(len(block["x"]), os.getpid(), dtype=np.int64)}


def is_even(row):
    return int(row["x"]) % 2 == 0


def row_plus(row):
    return {"x": row["x"] + 100}


class Counter:
    def __init__(self, start=0):
        self.n = start

    def incr(self, k=1):
        self.n += k
        return self.n

    def pid(self):
        return os.getpid()

    def die(self):
        os._exit(1)


class EnvProbe:
    """A process actor that reads its runtime env."""

    def probe(self, module: str, attr: str, var: str):
        return os.getcwd(), os.environ.get(var), getattr(importlib.import_module(module), attr)


class Tagger:
    """A stateful Data udf: __init__ once per actor."""

    def __init__(self, base):
        self.base = base
        self.pid = os.getpid()

    def __call__(self, block):
        n = len(block["x"])
        return {"y": block["x"] + self.base, "pid": np.full(n, self.pid, dtype=np.int64)}


class Adder:
    def __init__(self, inc):
        self.inc = inc
        self.calls = 0

    def add(self, x):
        self.calls += 1
        return x + self.inc

    def add2(self, x, y):
        return x + y

    def pid_and(self, x):
        return os.getpid(), x + self.inc

    def unwrap(self, t):
        return t

    def boom(self, x):
        if x % 2 == 0:
            raise ValueError(f"bad input {x}")
        return x

    def ncalls(self):
        return self.calls


class Stage:
    """A process actor between two shared-memory channels."""

    def __init__(self, inbound, outbound):
        self.inbound = inbound      # a ShmChannelReader, reopened in the worker
        self.outbound = outbound    # a ShmChannel (the writer's end)

    def pump(self, n):
        for _ in range(n):
            self.outbound.write(self.inbound.read(timeout=30) * 2)
        return "done"


def read_channel(channel, reader_id, n):
    """Read n values from a shared-memory channel (in a worker process)."""
    return [channel.read(reader_id, timeout=30) for _ in range(n)]


def cuda_state():
    """(pid, torch imported, CUDA initialised) in the calling process."""
    import sys

    torch = sys.modules.get("torch")
    return os.getpid(), torch is not None, bool(torch is not None and torch.cuda.is_initialized())


def cuda_state_after(seconds):
    """cuda_state() after a sleep: tasks that overlap land on distinct
    workers of a pool."""
    time.sleep(seconds)
    return cuda_state()


def instance_cuda_state(_instance):
    """cuda_state() inside an actor (through __ray_apply__)."""
    return cuda_state()


def compute_app_pids():
    """Pids that hold a CUDA context, as `nvidia-smi --query-compute-apps`
    lists them."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout
    return sorted(int(x) for x in out.split() if x.strip().isdigit())


def live_children(parent=None):
    """Pids of a process's children that have not exited (zombies, which
    have, left out), read from /proc: the tests' check that a shutdown
    left no worker behind."""
    parent = os.getpid() if parent is None else parent
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[1]) == parent and fields[0] != "Z":
            out.append(int(name))
    return out


def wait_no_children(before=(), timeout=10.0):
    """Wait until this process has no live child but those in `before`
    (children that were there when a test started); returns the others
    left."""
    deadline = time.monotonic() + timeout
    while True:
        left = sorted(set(live_children()) - set(before))
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.05)
