"""One rank of chip_smoke.py's `a7` phase: sequence, expert and pipeline
parallelism on the card.

    (imported by the ranks of a MultihostWorkerGroup; not run directly)

`a7_rank(config)` runs in each process of a `MultihostWorkerGroup`
(module-level, so the worker protocol's standard pickle sends it by
reference) and returns its numbers. `config["mode"]` picks the run:

- "sp": `MeshSpec(sp=2)`. Global q / k / v at `config["shape"]` (B, Hq,
  Hkv, S, D) in bf16 from a seeded torch.Generator on the card (every
  rank draws the same); this rank's sequence block through
  `ring_attention` (fused: each ring block through the flash forward
  kernel) and `ulysses_attention` (the flash forward and backward
  kernels), forward and gradient. Then, uncounted, the references in
  this process: the flash forward kernel over the whole sequence,
  `mha_reference` in f32 on this rank's query rows against the keys they
  see, and `flash_attention`'s gradient over the whole sequence (forward
  and backward kernels). Outputs are compared elementwise, gradients by
  their relative norm.
- "ep": `MeshSpec(ep=2)`. The MoE model `config["n_layers"]` deep from
  `init_params(config, seed)`, this rank's experts kept; `moe_loss` and
  its gradient on `config["tokens"]`. Each gradient leaf comes back as
  (expert or None, norm, dot with the parameter) rows: small numbers the
  parent holds against one process that holds every expert.
- "pp": `MeshSpec(pp=2)`. Llama-3-8B's width `config["n_layers"]` deep:
  `create_pp_train_state` then `make_pp_train_step` for each schedule in
  turn ("gpipe", "1f1b"), each from the same fresh state, over the
  batches `config["tokens"]`; losses, step times, and each schedule's
  peak allocated bytes above the resident state, of its forward and
  backward alone (one uncounted call on the first batch, no update) and
  of each step (the optimizer's temporaries included).

Kernel launches are counted over the main-path calls only (counts set
to 0 before, read after); the reference calls come after the read.
"""

from __future__ import annotations

import gc
import time

import numpy as np


def a7_rank(config: dict) -> dict:
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"mode": config["mode"], "rank": dist.get_rank(),
           "device": torch.cuda.get_device_name(0)}
    out.update({"sp": _sp, "ep": _ep, "pp": _pp}[config["mode"]](config))
    # the next mode runs in this process too: give the card back to the gang
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _launches():
    from ray_tpu_torch.ops import KERNELS

    return {k.name: k.launches for k in KERNELS}


def _reset_launches():
    from ray_tpu_torch.ops import KERNELS

    for k in KERNELS:
        k.launches = 0


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _sp(config: dict) -> dict:
    import torch

    from ray_tpu_torch.ops import (
        FLASH_FWD, flash_attention, flash_attention_with_lse, mha_reference, ring_attention,
        ulysses_attention,
    )
    from ray_tpu_torch.ops.ring_attention import sequence_block
    from ray_tpu_torch.parallel import MeshSpec, Wire, build_mesh

    mesh = build_mesh(MeshSpec(sp=2))
    rank, n = mesh.axis_index("sp"), mesh.shape["sp"]
    b, hq, hkv, s, d = config["shape"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(config["seed"])

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    q, k, v, do = randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d), randn(b, hq, s, d)
    qb, kb, vb, dob = (sequence_block(t, mesh) for t in (q, k, v, do))
    wire = Wire.for_axis(mesh, "sp")
    res = {}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    # the first collective on the fresh sp group pays gloo's connection
    # set-up: a first call, timed apart and not counted
    _, res["ring_first_call_s"] = timed(lambda: ring_attention(qb, kb, vb, mesh=mesh, causal=True))
    _reset_launches()
    ring, res["ring_fwd_s"] = timed(lambda: ring_attention(qb, kb, vb, mesh=mesh, causal=True,
                                                           wire=wire))
    res["ring_fwd_k1"] = FLASH_FWD.launches
    uly, res["ulysses_fwd_s"] = timed(lambda: ulysses_attention(qb, kb, vb, mesh=mesh,
                                                                causal=True, wire=wire))
    res["fwd_bytes"] = {k: v["bytes"] for k, v in wire.stats().items()}
    grads = {}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        leaves = [t.detach().requires_grad_() for t in (qb, kb, vb)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()

        def run():
            o = fn(*leaves, mesh=mesh, causal=True, wire=wire)
            return torch.autograd.grad(o, leaves, dob)

        grads[name], res[f"{name}_grad_s"] = timed(run)
        res[f"{name}_grad_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    res["launches"] = _launches()
    res["bytes"] = {k: v["bytes"] for k, v in wire.stats().items()}

    # references in this process (uncounted); mha_reference a group of
    # query heads at a time: its f32 scores are (S/n x S) a head
    with torch.no_grad():
        full, _ = flash_attention_with_lse(q, k, v, causal=True)
        full_b = sequence_block(full, mesh)
        end = (rank + 1) * (s // n)
        group = hq // hkv
        ref32 = torch.cat([
            mha_reference(qb[:, h * group:(h + 1) * group].float(),
                          k[:, h:h + 1, :end].float(), v[:, h:h + 1, :end].float(), causal=True)
            for h in range(hkv)], dim=1)
    res["ring_vs_k1"] = (ring.float() - full_b.float()).abs().max().item()
    res["ulysses_vs_k1"] = (uly.float() - full_b.float()).abs().max().item()
    res["ring_vs_ref32"] = (ring.float() - ref32).abs().max().item()
    res["ulysses_vs_ref32"] = (uly.float() - ref32).abs().max().item()
    atol, rtol = config["atol"], config["rtol"]
    res["outputs_ok"] = all(torch.allclose(x.float(), y.float(), atol=atol, rtol=rtol)
                            for x in (ring, uly) for y in (full_b, ref32))
    del ref32, full
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    ref_grads = torch.autograd.grad(flash_attention(*leaves, causal=True), leaves, do)
    ref_blocks = [sequence_block(g, mesh) for g in ref_grads]
    for name, got in grads.items():
        res[f"{name}_grad_rel"] = {x: _rel(g, r) for x, g, r in zip(("dq", "dk", "dv"), got,
                                                                      ref_blocks)}
        res[f"{name}_grad_max_abs"] = {x: (g.float() - r.float()).abs().max().item()
                                       for x, g, r in zip(("dq", "dk", "dv"), got, ref_blocks)}
    return res


def _leaf_stats(path: str, grad, param, first: int) -> list:
    """(expert, |g|, g . w, |w|) rows of one gradient leaf g of parameter
    w: one row per expert for the expert stacks (global expert index), one
    row with expert None otherwise. f64 sums, an expert at a time."""
    def row(e, g, p):
        g, p = g.double(), p.detach().double()
        return e, float(g.norm()), float((g * p).sum()), float(p.norm())

    if path.split("/")[-1].startswith("we_"):
        return [row(first + e, grad[:, e], param[:, e]) for e in range(grad.shape[1])]
    return [row(None, grad, param)]


def moe_grad_stats(params, tokens, config, spmd=None) -> dict:
    """moe_loss on `tokens` and, per gradient leaf, `_leaf_stats` rows: run
    by the ranks and by the phase's one-process reference alike."""
    import torch

    from ray_tpu_torch.models.moe import moe_loss
    from ray_tpu_torch.util.tree import flatten

    paths, leaves = zip(*flatten(params))
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss, (ce, aux, ntok) = moe_loss(params, tokens, config, spmd=spmd)
    grads = list(torch.autograd.grad(loss, leaves))
    if spmd is not None:
        spmd.sync_grads(list(paths), grads)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    first = spmd.expert_range(config.n_experts)[0] if spmd is not None else 0
    stats = {p: _leaf_stats(p, g, w, first) for p, g, w in zip(paths, grads, leaves)}
    return dict(loss=loss.item(), ce=ce.item(), aux=aux.item(), stats=stats, wall_s=wall)


def _ep(config: dict) -> dict:
    import torch

    from ray_tpu_torch.models.moe import init_params, logical_axes, mixtral_8x7b
    from ray_tpu_torch.parallel import (
        MeshSpec, ModelSharding, build_mesh, default_rules, shard_tree,
    )
    from ray_tpu_torch.util.tree import flatten

    model = mixtral_8x7b().replace(n_layers=config["n_layers"])
    mesh = build_mesh(MeshSpec(ep=2))
    full = init_params(model, config["seed"], device="cuda")
    params = shard_tree(full, logical_axes(model), default_rules(), mesh)
    del full
    torch.cuda.empty_cache()
    params = {k: ({kk: t.requires_grad_() for kk, t in v.items()} if isinstance(v, dict)
                  else v.requires_grad_()) for k, v in params.items()}
    spmd = ModelSharding(mesh, logical_axes(model))
    tokens = torch.from_numpy(np.asarray(config["tokens"])).cuda()
    expert_bytes = sum(t.numel() * t.element_size() for p, t in flatten(params)
                       if p.split("/")[-1].startswith("we_"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spmd.reset()
    _reset_launches()
    res = moe_grad_stats(params, tokens, model, spmd)
    res.update(launches=_launches(), expert_range=spmd.expert_range(model.n_experts),
               split=dict(spmd.split), expert_bytes=expert_bytes,
               param_bytes=sum(t.numel() * t.element_size() for _, t in flatten(params)),
               peak_bytes=torch.cuda.max_memory_allocated(),
               collectives={k: dict(v) for k, v in spmd.stats().items()})
    return res


def _pp(config: dict) -> dict:
    import torch

    from ray_tpu_torch.models import get_config
    from ray_tpu_torch.parallel import (
        MeshSpec, build_mesh, create_pp_train_state, make_pp_loss_and_grad, make_pp_train_step,
    )
    from ray_tpu_torch.train import default_optimizer
    from ray_tpu_torch.util.tree import flatten

    model = get_config(config["model"]).replace(n_layers=config["n_layers"])
    mesh = build_mesh(MeshSpec(pp=2))
    tokens = np.asarray(config["tokens"])
    opt = default_optimizer(config["lr"], warmup_steps=config["warmup_steps"],
                            total_steps=config["total_steps"])
    res = {"schedules": {}}
    launches = {}
    for schedule in ("gpipe", "1f1b"):
        state = create_pp_train_state(model, opt, config["seed"], mesh)
        batches = [torch.from_numpy(t).cuda() for t in tokens]
        state_bytes = sum(t.numel() * t.element_size() for _, t in flatten(state)
                          if isinstance(t, torch.Tensor))
        # the schedule's forward and backward alone (no update): its peak
        # over the resident state is the activations' and the stash's
        loss_and_grad = make_pp_loss_and_grad(model, mesh, config["microbatches"],
                                              schedule=schedule)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss_and_grad(state.params, batches[0])
        torch.cuda.synchronize()
        fwd_bwd_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.empty_cache()
        step = make_pp_train_step(model, opt, mesh, num_microbatches=config["microbatches"],
                                  schedule=schedule)
        _reset_launches()
        losses, times, peaks = [], [], []
        for batch in batches:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t = time.perf_counter()
            state, metrics = step(state, {"tokens": batch})
            loss = metrics["loss"].item()
            times.append(time.perf_counter() - t)
            losses.append(loss)
            peaks.append(torch.cuda.max_memory_allocated() - base)
        for name, n in _launches().items():
            launches[name] = launches.get(name, 0) + n
        res["schedules"][schedule] = dict(
            losses=losses, step_s=times, step_peak_bytes=peaks, state_bytes=state_bytes,
            fwd_bwd_peak_bytes=fwd_bwd_peak, grad_norm=metrics["grad_norm"].item(),
            wire={k: dict(v) for k, v in step.wires["pp"].stats().items()})
        del state, step, metrics
        gc.collect()
        torch.cuda.empty_cache()
    res["launches"] = launches
    res["stage"] = mesh.axis_index("pp")
    return res
