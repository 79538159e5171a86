"""ray_tpu_torch.train.checkpoint against the JAX package's manager on
the CPU.

The drills of tests/test_train_preemption.py run on both managers side
by side on the same values (a torn save, a flipped byte, retention):
each must reach the same surviving steps and restore the same step, and
the port's must fire its event and counter. Values restore bitwise (the
port's format stores the bytes; JAX's orbax restores f32 exactly), so
every comparison here is exact.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.train import checkpoint as jckpt
from ray_tpu_torch.train import checkpoint as tckpt
from ray_tpu_torch.train.lm import AdamWState, TrainState
from ray_tpu_torch.util import events as tevents
from ray_tpu_torch.util import metrics as tmetrics


def _fallbacks() -> float:
    counter = tmetrics.registry().get("raytpu_train_ckpt_fallback_total")
    if counter is None:
        return 0.0
    return sum(v for tags, v in counter.collect() if tags.get("store") == "torch")


def _flip_byte(path: str) -> None:
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))


def _payload(step_dir: str, manifest_name: str) -> str:
    """The largest manifested payload file of a step dir."""
    with open(os.path.join(step_dir, manifest_name)) as f:
        files = json.load(f)["files"]
    return os.path.join(step_dir, max(files, key=lambda rel: files[rel]["size"]))


def test_manifest_commit_fallback_and_gc_match_jax(tmp_path):
    """tests/test_train_preemption.py::test_orbax_manifest_commit_fallback_and_gc
    on both managers: a flipped byte in step 2 is quarantined and the
    restore falls back to step 1 (the port's counter and ckpt.quarantine
    event fire); a torn step dir is GC'd when a manager opens the
    directory (ckpt.gc); both end with the same steps and values."""
    results = {}
    for name, mod, value, zeros in (
        ("jax", jckpt, lambda k: {"w": jnp.arange(8.0) * k}, {"w": jnp.zeros(8)}),
        ("torch", tckpt, lambda k: {"w": torch.arange(8.0) * k}, {"w": torch.zeros(8)}),
    ):
        d = str(tmp_path / name)
        kw = {} if name == "jax" else {"device": "cpu"}
        mgr = mod.CheckpointManager(d, max_to_keep=5)
        mgr.save(1, value(1.0))
        mgr.save(2, value(2.0))
        step_dir = os.path.join(d, "2")
        assert os.path.exists(os.path.join(step_dir, mod.COMMIT_NAME))
        assert mod.verify_step_dir(step_dir) is None
        _flip_byte(_payload(step_dir, mod.MANIFEST_NAME))
        assert "checksum mismatch" in mod.verify_step_dir(step_dir)
        before = _fallbacks()
        restored = mgr.restore(zeros, **kw)
        fell_back = _fallbacks() - before
        latest = mgr.latest_step()
        quarantined = sorted(n.split("-")[0] for n in os.listdir(d) if ".corrupt" in n)
        mgr.close()
        torn = os.path.join(d, "7")
        os.makedirs(torn)
        with open(os.path.join(torn, "junk"), "wb") as f:  # a torn save's leftovers
            f.write(b"partial")
        mgr2 = mod.CheckpointManager(d, max_to_keep=5)
        assert not os.path.exists(torn)
        restored2 = mgr2.restore(zeros, **kw)
        results[name] = dict(
            restored=np.asarray(restored["w"]), restored2=np.asarray(restored2["w"]),
            latest=latest, steps=mgr2.all_steps(), quarantined=quarantined, fell_back=fell_back)
        mgr2.close()
    mine, ref = results["torch"], results["jax"]
    np.testing.assert_array_equal(mine["restored"], np.arange(8.0))
    np.testing.assert_array_equal(mine["restored"], ref["restored"])
    np.testing.assert_array_equal(mine["restored2"], ref["restored2"])
    assert mine["latest"] == ref["latest"] == 1
    assert mine["steps"] == ref["steps"] == [1]
    assert mine["quarantined"] == ref["quarantined"] == ["2.corrupt"]
    assert mine["fell_back"] == 1
    kinds = [e["kind"] for e in tevents.events().list(source="train", limit=1000)
             if e.get("extra", {}).get("directory") == str(tmp_path / "torch")]
    assert kinds.count("ckpt.quarantine") == 1 and kinds.count("ckpt.gc") == 1


def test_retention_and_requested_step_match_jax(tmp_path):
    """max_to_keep keeps the same newest steps in both managers; a save of
    a step at or below the latest is skipped (False) in both; restore(step)
    of an older kept step returns that step's values."""
    kept = {}
    for name, mod, make, zeros in (
        ("jax", jckpt, lambda k: {"w": jnp.full(4, float(k))}, {"w": jnp.zeros(4)}),
        ("torch", tckpt, lambda k: {"w": torch.full((4,), float(k))}, {"w": torch.zeros(4)}),
    ):
        kw = {} if name == "jax" else {"device": "cpu"}
        mgr = mod.CheckpointManager(str(tmp_path / name), max_to_keep=3)
        assert [mgr.save(s, make(s)) for s in (1, 2, 3, 4, 5)] == [True] * 5
        assert mgr.save(5, make(9)) is False and mgr.save(4, make(9)) is False
        kept[name] = (mgr.all_steps(), np.asarray(mgr.restore(zeros, step=4, **kw)["w"]))
        mgr.close()
    assert kept["torch"][0] == kept["jax"][0] == [3, 4, 5]
    np.testing.assert_array_equal(kept["torch"][1], kept["jax"][1])


def _state(seed: int, dtype=torch.float32) -> TrainState:
    gen = torch.Generator().manual_seed(seed)
    params = {"wte": torch.randn(5, 3, generator=gen).to(dtype),
              "blocks": {"w": torch.randn(2, 3, 4, generator=gen).to(dtype)}}
    params = {k: ({kk: vv.requires_grad_() for kk, vv in v.items()} if isinstance(v, dict)
                  else v.requires_grad_()) for k, v in params.items()}
    mu = {"wte": torch.randn(5, 3, generator=gen), "blocks": {"w": torch.randn(2, 3, 4, generator=gen)}}
    nu = {"wte": torch.rand(5, 3, generator=gen), "blocks": {"w": torch.rand(2, 3, 4, generator=gen)}}
    return TrainState(step=seed, params=params, opt_state=AdamWState(count=seed, mu=mu, nu=nu))


def _leaves(tree):
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def test_async_save_snapshots_before_returning(tmp_path):
    """The port's step updates its tensors in place: an async save copies
    every tensor before it returns, so updating the state right after the
    call does not reach the file. The restored tree takes the target's
    structure, dtypes and requires_grad, with the saved step counts."""
    mgr = tckpt.CheckpointManager(tmp_path, async_save=True)
    state = _state(3)
    saved = [t.detach().clone() for t in _leaves(state.params)]
    assert mgr.save(3, state)
    assert mgr.latest_step() == 3  # in flight counts, as orbax's does
    with torch.no_grad():
        for t in _leaves(state.params):
            t.add_(100.0)  # the next step's in-place update
    mgr.wait_until_finished()
    assert os.listdir(tmp_path) == ["3"]
    assert tckpt.verify_step_dir(str(tmp_path / "3")) is None
    back = mgr.restore(_state(9), device="cpu")
    assert isinstance(back, TrainState) and back.step == 3 and back.opt_state.count == 3
    for a, b in zip(saved, _leaves(back.params)):
        assert torch.equal(a, b) and b.requires_grad and b.is_leaf
    # the target's dtype wins: bf16 targets get the saved f32 values rounded
    half = mgr.restore(_state(9, dtype=torch.bfloat16), device="cpu")
    assert half.params["wte"].dtype == torch.bfloat16
    assert torch.equal(half.params["wte"], saved[0].to(torch.bfloat16))
    # a target whose shapes differ is refused
    wrong = _state(9)
    wrong.params["wte"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(wrong, device="cpu")
    mgr.close()


def test_meta_target_and_torn_temporary_dirs(tmp_path):
    """restore() takes an abstract target (meta tensors give the shapes and
    dtypes); a temporary dir whose writer died is GC'd like a torn step
    dir, one whose writer runs stays; an empty directory has nothing to
    restore."""
    mgr = tckpt.CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state(1), device="cpu")
    state = _state(4)
    mgr.save(4, state)
    meta = _state(0)
    meta.params = {k: ({kk: torch.empty_like(vv, device="meta") for kk, vv in v.items()}
                       if isinstance(v, dict) else torch.empty_like(v, device="meta"))
                   for k, v in meta.params.items()}
    back = mgr.restore(meta, device="cpu")
    assert torch.equal(back.params["blocks"]["w"], state.params["blocks"]["w"])
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    os.makedirs(tmp_path / f"5.tmp-{dead.pid}")  # its writer died mid-save
    os.makedirs(tmp_path / f"6.tmp-{os.getpid()}")  # a writer still at work
    tckpt.CheckpointManager(tmp_path)
    assert sorted(os.listdir(tmp_path)) == ["4", f"6.tmp-{os.getpid()}"]
