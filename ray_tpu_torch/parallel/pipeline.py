"""Pipeline parallelism: microbatched schedules over the `pp` axis.

Port of `ray_tpu/parallel/pipeline.py`. Stage s of S holds layers
[s L/S, (s+1) L/S) (the blocks' leading axis split over pp,
`pp_state_specs`); the embedding, final norm and head are replicated on
every stage. JAX writes the pipeline as one program, a `lax.scan` over
ticks with `ppermute` between stages, and gets the backward from AD. No
partitioner or cross-process autograd exists here, so the port writes the
schedules out, with the same tick arithmetic:

- GPipe (`spmd_pipeline`): at tick t stage s runs microbatch t - s, for
  M + S - 1 ticks, every activation kept; then the backward runs the
  ticks in reverse, stage s taking microbatch M - 1 - (u - (S - 1 - s))
  at tick u. `_GPipe` is an autograd Function around the two, so the
  loss of `make_pp_loss_fn` is differentiable on every rank, as JAX's
  is: the Function's backward calls `torch.autograd.grad` on each kept
  stage output with the gradient received from the next stage.
- 1F1B (`spmd_pipeline_1f1b`): the forward of microbatch m at stage s
  runs at tick s + m and its backward at tick 2(S-1) - s + m, M + 2(S-1)
  ticks; a stage keeps at most min(M, 2S-1) stashed inputs (not
  activations) and recomputes its forward from the stashed input in the
  backward.

Activations go forward and their gradients back by the `Wire`'s
neighbour shift (`Wire.shift`, JAX's `ppermute`), which every rank calls
at every tick, so the ranks' collectives meet in the same order. A stage
runs only the ticks it has work in (JAX's masked ticks compute zeros);
the embedding runs on stage 0 and the head and loss on the last stage
only, as JAX's `lax.cond` has them. The loss is summed over pp and
averaged over dp; the replicated leaves' gradients are summed over pp
(stage 0 holds the embedding's, the last stage the head's) and every
gradient is averaged over dp.

A mesh with an axis other than dp and pp above 1 raises: JAX's
`pp_state_specs` shards the blocks over pp only and its step replicates
the rest over the other axes; the port runs dp x pp.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..util.tree import flatten
from .collectives import Wire
from .mesh import Mesh, NamedSharding, PartitionSpec
from .spmd import _Reduce

Params = Dict[str, Any]


def _stage_fn(config, rope_tables) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    """This stage's layers over one microbatch of activations."""
    from ..models.transformer import _block

    def stage_fn(blocks: Params, x: torch.Tensor) -> torch.Tensor:
        remat = config.remat and torch.is_grad_enabled()
        for i in range(next(iter(blocks.values())).shape[0]):
            lp = {name: w[i] for name, w in blocks.items()}
            if remat:
                x = checkpoint(_block, x, lp, config, rope_tables, None, use_reentrant=False)
            else:
                x = _block(x, lp, config, rope_tables, None)
        return x

    return stage_fn


def _grad(y: torch.Tensor, inputs: List[torch.Tensor], dy: torch.Tensor) -> List[torch.Tensor]:
    """d(y . dy) / d inputs, zeros for an input y does not reach."""
    grads = torch.autograd.grad(y, inputs, dy, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]


# ------------------------------------------------------------------- GPipe


class _GPipe(torch.autograd.Function):
    """GPipe's schedule: the forward ticks keep each microbatch's stage
    graph; the backward runs the ticks in reverse through them."""

    @staticmethod
    def forward(ctx, stage_fn, wire: Wire, names, microbatches, *leaves):
        n_stages, s = wire.size, wire.rank
        num_mb = microbatches.shape[0]
        params = {k: v.detach().requires_grad_() for k, v in zip(names, leaves)}
        need_dx = s > 0 or ctx.needs_input_grad[3]
        outputs = torch.zeros_like(microbatches)
        kept: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        buf = torch.zeros_like(microbatches[0])
        ticks = num_mb + n_stages - 1
        for t in range(ticks):
            m = t - s
            y = torch.zeros_like(buf)
            if 0 <= m < num_mb:
                x = (microbatches[m] if s == 0 else buf).detach().requires_grad_(need_dx)
                with torch.enable_grad():
                    y = stage_fn(params, x)
                kept[m] = (x, y)
                y = y.detach()
                if s == n_stages - 1:
                    outputs[m] = y
            if t < ticks - 1:
                with wire.region("pp_shift", y.device):
                    buf = wire.shift(y)
        ctx.stage = (wire, params, kept, need_dx, num_mb)
        return outputs

    @staticmethod
    def backward(ctx, g_outputs):
        wire, params, kept, need_dx, num_mb = ctx.stage
        del ctx.stage
        n_stages, s = wire.size, wire.rank
        leaves = list(params.values())
        d_params = [torch.zeros_like(p) for p in leaves]
        d_mb = torch.zeros_like(g_outputs) if s == 0 and need_dx else None
        buf = torch.zeros_like(g_outputs[0])
        ticks = num_mb + n_stages - 1
        for u in range(ticks):
            m = num_mb - 1 - (u - (n_stages - 1 - s))
            dx = torch.zeros_like(buf)
            if 0 <= m < num_mb:
                dy = g_outputs[m] if s == n_stages - 1 else buf
                x, y = kept.pop(m)
                grads = _grad(y, ([x] if need_dx else []) + leaves, dy)
                if need_dx:
                    dx = grads.pop(0)
                    if d_mb is not None:
                        d_mb[m] = dx
                torch._foreach_add_(d_params, grads)
            if u < ticks - 1:
                with wire.region("pp_shift", dx.device):
                    buf = wire.shift(dx, -1)
        return (None, None, None, d_mb, *d_params)


def spmd_pipeline(
    stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
    stage_params: Params,
    microbatches: torch.Tensor,
    *,
    wire: Wire,
) -> torch.Tensor:
    """GPipe over the pp `wire`. stage_fn(stage_params, x) applies this
    stage's layers to one microbatch; microbatches (M, mb, ...) are the
    stage-0 inputs (read on stage 0 only). Returns (M, mb, ...): every
    microbatch through all S stages on the LAST stage, zeros elsewhere.
    Differentiable in stage_params and (on stage 0) microbatches; every
    rank of the wire must run the backward, as every rank ran the
    forward."""
    names = list(stage_params)
    return _GPipe.apply(stage_fn, wire, names, microbatches, *stage_params.values())


# -------------------------------------------------------------------- 1F1B


def spmd_pipeline_1f1b(
    stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
    head_vjp_fn: Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, List, torch.Tensor]],
    stage_params: Params,
    microbatches: torch.Tensor,
    targets: torch.Tensor,
    *,
    wire: Wire,
):
    """One-forward-one-backward over the pp `wire`: every tick runs one
    microbatch's forward and one's backward a stage, so a microbatch's
    backward starts as soon as its forward reaches the last stage:

        fwd of microbatch m at stage s: tick  s + m
        bwd of microbatch m at stage s: tick  2(S-1) - s + m

    M + 2(S-1) ticks. A stage stashes its inputs in a ring of min(M,
    2S-1) slots (the pipeline's depth, not the microbatch count) and
    recomputes its forward from the stashed input in the backward.

    head_vjp_fn(y, tgt) -> (loss_mb, d_head_leaves, dy) runs on the last
    stage only, already scaled for the 1/M loss mean; a leaf the head does
    not reach may have None for its gradient. Returns (loss_sum, d_stage (a
    dict like stage_params), d_head (a list with None for the leaves no
    microbatch reached; None off the last stage), dx_microbatches (stage
    0's, zeros elsewhere)); callers sum over pp."""
    n_stages, s = wire.size, wire.rank
    last = n_stages - 1
    num_mb = microbatches.shape[0]
    ring = min(num_mb, 2 * n_stages - 1)
    names = list(stage_params)
    params = [stage_params[k].detach().requires_grad_() for k in names]
    d_stage = [torch.zeros_like(p) for p in params]
    d_head: Optional[List[torch.Tensor]] = None
    dx_out = torch.zeros_like(microbatches)
    loss_acc = torch.zeros((), dtype=torch.float32, device=microbatches.device)
    stash: List[Optional[torch.Tensor]] = [None] * ring
    fwd_buf = torch.zeros_like(microbatches[0])
    bwd_buf = torch.zeros_like(microbatches[0])
    ticks = num_mb + 2 * (n_stages - 1)
    for t in range(ticks):
        # forward
        m_f = t - s
        y = torch.zeros_like(fwd_buf)
        if 0 <= m_f < num_mb:
            x_in = microbatches[m_f] if s == 0 else fwd_buf
            with torch.no_grad():
                y = stage_fn(dict(zip(names, params)), x_in)
            stash[m_f % ring] = x_in.detach()
        # the last stage's loss head: m_b == m_f there
        m_b = t - (2 * (n_stages - 1) - s)
        bwd_valid = 0 <= m_b < num_mb
        dy_in = bwd_buf
        if s == last and bwd_valid:
            loss_mb, d_head_mb, dy_in = head_vjp_fn(y, targets[m_b])
            loss_acc = loss_acc + loss_mb
            d_head = d_head or [None] * len(d_head_mb)
            for i, g in enumerate(d_head_mb):
                if g is not None:
                    d_head[i] = g if d_head[i] is None else d_head[i].add_(g)
        # backward, recomputing the stage's forward from the stashed input
        dx = torch.zeros_like(bwd_buf)
        if bwd_valid:
            x_saved = stash[m_b % ring].requires_grad_()
            with torch.enable_grad():
                y_re = stage_fn(dict(zip(names, params)), x_saved)
            grads = _grad(y_re, [x_saved] + params, dy_in)
            dx = grads[0]
            torch._foreach_add_(d_stage, grads[1:])
            if s == 0:
                dx_out[m_b] = dx
        # communicate
        if t < ticks - 1:
            with wire.region("pp_shift", y.device):
                fwd_buf = wire.shift(y)
                bwd_buf = wire.shift(dx, -1)
    return loss_acc, dict(zip(names, d_stage)), d_head, dx_out


# --------------------------------------------------------------- the losses


def _check_mesh(config, mesh: Mesh) -> int:
    n_stages = mesh.shape["pp"]
    others = [a for a in mesh.axis_names if a not in ("dp", "pp") and mesh.shape[a] > 1]
    if others:
        raise NotImplementedError(
            f"a pipeline over {mesh.spec.describe()}: JAX's pipeline step shards the blocks "
            f"over pp only (pp_state_specs) and replicates every other leaf, so neither "
            f"package shards parameters over {others} under pp; the pipeline runs dp x pp")
    if config.n_layers % n_stages != 0:
        raise ValueError(f"n_layers={config.n_layers} not divisible by pp={n_stages}")
    return n_stages


def _split_blocks(params: Params) -> Tuple[Params, Params]:
    return params["blocks"], {k: v for k, v in params.items() if k != "blocks"}


def _prep(config, tokens: torch.Tensor, num_microbatches: int):
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    b = inp.shape[0]
    if b % num_microbatches:
        raise ValueError(f"per-dp-shard batch {b} not divisible by "
                         f"num_microbatches={num_microbatches}")
    rope_tables = None
    if config.pos_emb != "learned":
        from ..ops import rope_frequencies

        rope_tables = rope_frequencies(config.head_dim, config.max_seq, config.rope_theta,
                                       device=tokens.device)
    return inp, tgt, rope_tables


def _embed(config, rest: Params, inp: torch.Tensor) -> torch.Tensor:
    dt = config.dtype
    x = rest["wte"][inp.long()].to(dt)
    if config.pos_emb == "learned":
        x = x + rest["wpe"][: inp.shape[1]].to(dt)[None]
    return x


def _head_loss(config, rest: Params, y: torch.Tensor, tgt: torch.Tensor,
               z_loss_coeff: float) -> torch.Tensor:
    from ..models.transformer import _norm
    from ..ops import cross_entropy_loss

    yn = _norm(y, rest["lnf_scale"], rest.get("lnf_bias"), config.norm)
    head = rest["lm_head"] if "lm_head" in rest else rest["wte"].T
    logits = yn @ head.to(config.dtype)
    loss, _ = cross_entropy_loss(logits, tgt, z_loss_coeff=z_loss_coeff)
    return loss.float()


def _stage_inputs(config, rest: Params, inp: torch.Tensor, n: int, stage: int):
    """(the embedding (B, S, E) on stage 0, None elsewhere; the stage-0
    inputs as (M, mb, S, E): the embedding's microbatches on stage 0,
    zeros elsewhere)."""
    b, seq = inp.shape
    if stage == 0:
        x = _embed(config, rest, inp)
        return x, x.reshape(n, b // n, seq, x.shape[-1])
    shape = (n, b // n, seq, config.d_model)
    return None, torch.zeros(shape, dtype=config.dtype, device=inp.device)


def make_pp_loss_fn(
    config,
    mesh: Mesh,
    num_microbatches: int,
    *,
    z_loss_coeff: float = 0.0,
) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    """loss(params, tokens) under GPipe, with this stage's blocks and the
    replicated rest in `params` and this dp rank's rows (B/dp, S+1) in
    `tokens`. The loss is the global one (summed over pp, averaged over
    dp) on every rank. Differentiable: `torch.autograd.grad` of it on
    every rank (every rank must run it) gives this rank's share of JAX's
    gradients, which `make_pp_loss_and_grad` sums over the ranks. The
    function's `wires` attribute holds its pp and dp wires."""
    n_stages = _check_mesh(config, mesh)
    pp_wire, dp_wire = Wire.for_axis(mesh, "pp"), Wire.for_axis(mesh, "dp")
    stage = mesh.axis_index("pp")

    def loss_fn(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        blocks, rest = _split_blocks(params)
        inp, tgt, rope_tables = _prep(config, tokens, num_microbatches)
        _, x_mb = _stage_inputs(config, rest, inp, num_microbatches, stage)
        y_mb = spmd_pipeline(_stage_fn(config, rope_tables), blocks, x_mb, wire=pp_wire)
        if stage == n_stages - 1:
            loss = _head_loss(config, rest, y_mb.reshape(*inp.shape, -1), tgt, z_loss_coeff)
        else:
            # zero, but on the pipeline's graph: this rank's backward runs it too
            loss = y_mb.float().sum() * 0.0
        loss = _Reduce.apply(loss, pp_wire, "pp")
        if dp_wire.size > 1:
            loss = _Reduce.apply(loss, dp_wire, "dp") / dp_wire.size
        return loss

    loss_fn.wires = {"pp": pp_wire, "dp": dp_wire}
    return loss_fn


@torch.no_grad()
def _sync(wires: Dict[str, Wire], grads: Params) -> Params:
    """In place, a rank's share of the gradients into JAX's: the
    replicated leaves' summed over pp, every leaf's summed over dp (each
    share already carries its 1/dp). Returns `grads`."""
    rest = [p for p, _ in flatten(grads) if not p.startswith("blocks/")]
    leaves = dict(flatten(grads))
    for axis, paths in (("pp", rest), ("dp", list(leaves))):
        wire = wires[axis]
        if wire.size == 1 or not paths:
            continue
        flat = torch.cat([leaves[p].reshape(-1).float() for p in paths])
        with wire.region(f"{axis}_sync", flat.device):
            wire.all_reduce(flat)
        for p, part in zip(paths, torch.split(flat, [leaves[p].numel() for p in paths])):
            leaves[p].copy_(part.view(leaves[p].shape))
    return grads


def _fill(like: Params, values: Dict[str, torch.Tensor], prefix: str) -> Params:
    """A tree shaped like `like` with the leaves `values` holds by path."""
    return {k: _fill(v, values, f"{prefix}{k}/") if isinstance(v, dict) else values[f"{prefix}{k}"]
            for k, v in like.items()}


def make_pp_loss_and_grad(
    config,
    mesh: Mesh,
    num_microbatches: int,
    *,
    z_loss_coeff: float = 0.0,
    schedule: str = "gpipe",
) -> Callable[[Params, torch.Tensor], Tuple[torch.Tensor, Params]]:
    """(loss, grads) under `schedule` ("gpipe": autograd through
    `make_pp_loss_fn`; "1f1b": the interleaved schedule), grads a tree
    like params (this stage's blocks), summed as JAX's are (the
    replicated leaves' over pp, every leaf's over dp). The two schedules'
    gradients are the same function's."""
    if schedule == "1f1b":
        return make_pp_loss_and_grad_1f1b(config, mesh, num_microbatches,
                                          z_loss_coeff=z_loss_coeff)
    if schedule != "gpipe":
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    loss_fn = make_pp_loss_fn(config, mesh, num_microbatches, z_loss_coeff=z_loss_coeff)

    def loss_and_grad(params: Params, tokens: torch.Tensor):
        loss = loss_fn(params, tokens)
        paths, leaves = zip(*flatten(params))
        grads = dict(zip(paths, _grad(loss, list(leaves), torch.ones_like(loss))))
        return loss.detach(), _sync(loss_fn.wires, _fill(params, grads, ""))

    loss_and_grad.wires = loss_fn.wires
    return loss_and_grad


def make_pp_loss_and_grad_1f1b(
    config,
    mesh: Mesh,
    num_microbatches: int,
    *,
    z_loss_coeff: float = 0.0,
) -> Callable[[Params, torch.Tensor], Tuple[torch.Tensor, Params]]:
    """(loss, grads) under 1F1B: the embedding's forward and backward on
    stage 0 outside the ticks (its input gradients come back from the
    stage-0 backward), the loss head inside the last stage's ticks, the
    stage gradients summed tick by tick. Gradients are the GPipe path's;
    only the schedule and its memory differ."""
    n_stages = _check_mesh(config, mesh)
    pp_wire, dp_wire = Wire.for_axis(mesh, "pp"), Wire.for_axis(mesh, "dp")
    stage = mesh.axis_index("pp")
    inv_m = 1.0 / num_microbatches

    def loss_and_grad(params: Params, tokens: torch.Tensor):
        blocks, rest = _split_blocks(params)
        inp, tgt, rope_tables = _prep(config, tokens, num_microbatches)
        rest_paths, rest_leaves = zip(*flatten(rest))
        rest_leaves = [t.detach().requires_grad_() for t in rest_leaves]
        rest_p = _fill(rest, dict(zip(rest_paths, rest_leaves)), "")
        with torch.enable_grad():
            x, x_mb = _stage_inputs(config, rest_p, inp, num_microbatches, stage)
        tgt_mb = tgt.reshape(num_microbatches, -1, tgt.shape[1])

        def head_vjp_fn(y, t):
            y_req = y.detach().requires_grad_()
            with torch.enable_grad():
                loss = _head_loss(config, rest_p, y_req, t, z_loss_coeff) * inv_m
            # None for the leaves the head does not reach (the embedding
            # when untied): no full-size zeros a microbatch
            grads = torch.autograd.grad(loss, rest_leaves + [y_req], allow_unused=True)
            return loss.detach(), grads[:-1], grads[-1]

        loss, d_blocks, d_head, dx_mb = spmd_pipeline_1f1b(
            _stage_fn(config, rope_tables), head_vjp_fn, blocks, x_mb.detach(), tgt_mb,
            wire=pp_wire)
        d_rest = list(d_head or [None] * len(rest_leaves))
        if x is not None:
            embed_grads = torch.autograd.grad(x, rest_leaves, dx_mb.reshape(x.shape),
                                              allow_unused=True)
            for i, g in enumerate(embed_grads):
                if g is not None:
                    d_rest[i] = g if d_rest[i] is None else d_rest[i].add_(g)
        d_rest = [torch.zeros_like(t) if g is None else g for g, t in zip(d_rest, rest_leaves)]
        with torch.no_grad(), pp_wire.region("metrics", loss.device):
            loss = pp_wire.all_reduce(loss.clone())
            if dp_wire.size > 1:
                loss = dp_wire.all_reduce(loss) / dp_wire.size
        flat = dict(zip((f"blocks/{k}" for k in d_blocks), d_blocks.values()))
        flat.update(zip(rest_paths, d_rest))
        grads = _fill(params, flat, "")
        if dp_wire.size > 1:
            for path, g in flatten(grads):
                g.div_(dp_wire.size)
        return loss, _sync(loss_and_grad.wires, grads)

    loss_and_grad.wires = {"pp": pp_wire, "dp": dp_wire}
    return loss_and_grad


# --------------------------------------------------------- state and step


def pp_state_specs(config, state: Any) -> Dict[str, PartitionSpec]:
    """{leaf path: PartitionSpec} of a pipeline TrainState: every `blocks`
    leaf (the params' and the moments') splits its leading layer axis
    over pp; everything else is replicated."""
    del config  # the layout depends on the tree's paths only, as in JAX
    return {path: PartitionSpec("pp") if "blocks" in path.split("/") else PartitionSpec()
            for path, leaf in flatten(state) if isinstance(leaf, torch.Tensor)}


def create_pp_train_state(
    config,
    optimizer,
    seed: int,
    mesh: Mesh,
    *,
    params: Optional[Params] = None,
):
    """A TrainState in the pipeline layout: params from `init_params(config,
    seed)` (every rank draws the same ones) or copies of `params` (the
    global tree, e.g. JAX's carried with `params_from_numpy(...,
    dtype=torch.float32)`), this stage's blocks kept, on the mesh's
    device, and zero moments."""
    from ..models.transformer import init_params
    from ..train.lm import TrainState

    _check_mesh(config, mesh)
    dev = mesh.device
    if params is None:
        params = init_params(config, seed, device=dev)
    stage = NamedSharding(mesh, PartitionSpec("pp"))

    def own(path: str, t: torch.Tensor) -> torch.Tensor:
        t = stage.shard(t) if path.startswith("blocks/") else t
        return t.detach().to(dev).clone().requires_grad_(True)

    values = {path: own(path, t) for path, t in flatten(params)}
    params = _fill(params, values, "")
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def make_pp_train_step(
    config,
    optimizer,
    mesh: Mesh,
    *,
    num_microbatches: int,
    z_loss_coeff: float = 0.0,
    schedule: str = "gpipe",
):
    """One dp x pp training step with `train.lm.make_train_step`'s
    TrainState and metrics contract: step(state, {"tokens": this dp rank's
    rows (B/dp, S+1)}) updates the state in place and returns it with
    {"loss", "grad_norm" (before the clip), "num_tokens"}, f32 device
    tensors over the global batch.

    schedule: "gpipe" (every microbatch's activations kept through the
    forward) or "1f1b" (at most 2S-1 stashed inputs a stage, the stage
    forward recomputed in the backward). The gradients are the same
    function's. The returned function's `wires` attribute holds the pp
    and dp wires (their `stats()`: "pp_shift", "pp_sync", "dp_sync",
    "metrics")."""
    from ..train.lm import tree_leaves

    loss_and_grad = make_pp_loss_and_grad(config, mesh, num_microbatches,
                                          z_loss_coeff=z_loss_coeff, schedule=schedule)
    pp_wire = loss_and_grad.wires["pp"]
    dp = mesh.shape["dp"]

    def step(state, batch: Dict[str, torch.Tensor]):
        tokens = batch["tokens"].to(mesh.device)
        loss, grads = loss_and_grad(state.params, tokens)
        leaves = tree_leaves(grads)
        paths = [p for p, _ in flatten(grads)]
        with torch.no_grad():
            sq = [g.float().square().sum(dtype=torch.float64) for g in leaves]
            blocks_sq = torch.stack([q for p, q in zip(paths, sq) if p.startswith("blocks/")]).sum()
            rest_sq = torch.stack([q for p, q in zip(paths, sq) if not p.startswith("blocks/")]).sum()
            with pp_wire.region("metrics", blocks_sq.device):
                pp_wire.all_reduce(blocks_sq)
            gnorm = (blocks_sq + rest_sq).sqrt().float()
        state.opt_state = optimizer.update(leaves, state.opt_state, state.params, norm=gnorm)
        state.step += 1
        ntok = torch.tensor(float(tokens.shape[0] * (tokens.shape[1] - 1) * dp),
                            device=tokens.device)
        return state, {"loss": loss.float(), "grad_norm": gnorm, "num_tokens": ntok}

    step.wires = loss_and_grad.wires
    return step
