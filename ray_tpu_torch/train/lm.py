"""LM training compute core: train state, optimizer, train and eval steps.

Port of `ray_tpu/train/lm.py`: `default_optimizer` → `create_train_state`
→ `make_train_step` → `make_eval_step`, with JAX's names and signatures.
An explicit `device` (default "cuda", raising without a CUDA device;
"cpu" runs the plain paths) or a `mesh` (`parallel.build_mesh`: this
rank's device and its dp process group) takes the JAX mesh's place. On
the card the step runs the model in its compute dtype over f32 master
weights, and attention's gradient comes from the flash backward kernels
(`ops.flash_attention`).

Data parallelism (a mesh with dp = n > 1, one process per rank):
- The implicit step (f32 sync, no sharded update) gives JAX's GSPMD
  result: each rank runs its rows of the batch, and one all-reduce of
  the token-weighted gradients makes the loss the global token mean and
  the gradients that loss's gradients.
- `dp_allreduce_dtype="int8"` / `dp_shard_update=True` take the explicit
  step (`_make_explicit_dp_step`), each branch as JAX wrote it: gradients
  in the (n, k) rows layout, the error-feedback residual added before the
  sync, the int8 block-quantized all-reduce or reduce-scatter, `own / n`,
  Adam's moments and `ef` in the rows layout with each rank holding its
  row, the dp-wide norm through `clip_by_global_norm_sharded`, the
  all-gather of the new params, `loss` averaged and `num_tokens` summed
  over the ranks. The rows of every leaf travel in one collective (each
  leaf's row is a whole number of quantizer blocks, so the values are
  those of JAX's collective per leaf).
- Under a dp mesh, `batch["tokens"]` is this rank's rows of the global
  batch (`parallel.data_sharding(mesh).shard(global)`, which
  `lm_batch_iterator(sharding=)` does).

What differs from JAX, and why:
- The step runs eagerly, not as one jitted program. Parameters and Adam
  moments are updated in place under `torch.no_grad()`, the counterpart of
  JAX's donated state buffers: `step(state, batch)` returns the same
  `TrainState` object, advanced.
- The optimizer is plain functions on tensor lists (`torch._foreach_*`)
  with optax's arithmetic: an `init` / `update` pair like an optax
  `GradientTransformation`, except that `update` applies the update to the
  parameters itself (optax returns updates for `apply_updates`).
- Step counts live on the host as Python ints (JAX keeps them on the
  device); the learning rate and bias corrections are host scalars, so the
  step reads nothing back from the device.
- `TrainState` has no `rng`: no JAX step reads its key (the model has no
  dropout), so the port drops it. A rank's rows-layout leaves (the
  moments under `dp_shard_update`, `ef`) hold its block only: (1, k) and
  (1, n, k) where JAX's global arrays are (n, k) and (n, n, k).
- `create_train_state` returns the state; `state_specs` gives JAX's
  state shardings as {leaf path: PartitionSpec}.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .._device import resolve_device
from ..models.convert import params_from_numpy
from ..models.transformer import (
    TransformerConfig,
    forward,
    forward_hidden,
    init_params,
    lm_head_weights,
    logical_axes,
)
from ..ops.losses import auto_loss_chunk, cross_entropy_loss, fused_linear_cross_entropy
from ..parallel.collectives import (
    Wire,
    psum_scatter_rows,
    quantized_psum_rows,
    quantized_psum_scatter_rows,
)
from ..parallel.mesh import Mesh, PartitionSpec
from ..parallel.sharding import LogicalRules, default_rules, tree_specs
from ..util.tree import flatten

Params = Dict[str, Any]
Metrics = Dict[str, torch.Tensor]


def tree_leaves(tree: Params) -> List[torch.Tensor]:
    """The tensors of a nested parameter dict, in insertion order."""
    out: List[torch.Tensor] = []
    for value in tree.values():
        if isinstance(value, dict):
            out.extend(tree_leaves(value))
        else:
            out.append(value)
    return out


def _tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Params) -> Params:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


# ----------------------------------------------------------------- optimizer


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear from init_value to
    peak_value over warmup_steps, then cosine down to end_value at
    decay_steps (which counts the warmup), held there after."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        span = decay_steps - warmup_steps
        t = min(count - warmup_steps, span)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / span))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


@dataclasses.dataclass
class AdamWState:
    """Adam moments (trees like the params) and the number of updates
    applied so far (optax's `count`, here a host int)."""

    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """clip_by_global_norm → AdamW with a learning-rate schedule, as the
    optax chain of `ray_tpu.train.lm.default_optimizer`.

    `init(params)` returns the state; `update(grads, state, params)`
    clips `grads` in place, updates the moments and the parameters in
    place and returns the state.

    `shard_axis` (JAX's `default_optimizer(shard_axis=)`): the updates are
    this rank's shards of the global tree (the dp_shard_update path), and
    the clip takes the dp-wide norm (`clip_by_global_norm_sharded`) over
    the `wire` that `update` is given."""

    schedule: Callable[[int], float]
    b1: float
    b2: float
    eps: float
    weight_decay: float
    grad_clip: float
    shard_axis: Optional[str] = None

    def init(self, params: Params) -> AdamWState:
        return AdamWState(count=0, mu=_tree_map(torch.zeros_like, params),
                          nu=_tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: AdamWState, params: Params, *,
               wire: Optional[Wire] = None) -> AdamWState:
        p = tree_leaves(params)
        g = list(grads)
        mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
        if self.shard_axis:
            if wire is None:
                raise ValueError(f"an optimizer with shard_axis={self.shard_axis!r} updates "
                                 "shards: it runs inside the explicit dp step, which passes "
                                 "the axis' wire")
            clip_by_global_norm_sharded(g, self.grad_clip, wire)
        else:
            _clip_by_norm(g, global_norm(g), self.grad_clip)
        # optax.scale_by_adam: moments, bias correction at count + 1, eps
        # outside the square root
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        count_inc = state.count + 1
        mu_hat = torch._foreach_div(mu, 1.0 - self.b1 ** count_inc)
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** count_inc)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        # optax.add_decayed_weights on every leaf (no mask), then
        # scale_by_learning_rate at the schedule's value for this count
        if self.weight_decay:
            torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -self.schedule(state.count))
        torch._foreach_add_(p, upd)
        state.count = count_inc
        return state


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm), f32."""
    return _sumsq(tensors).sqrt().float()


def _sumsq(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The sum of the f32 squares, accumulated in f64: the sum then hardly
    depends on its order, so the dp-sharded clip (partial sums over each
    rank's rows, then over the ranks) rounds to the same norm as the
    replicated one, and the two updates stay bitwise equal (under bf16
    compute any difference would grow step by step)."""
    return torch.stack([t.float().square().sum(dtype=torch.float64) for t in tensors]).sum()


def _clip_by_norm(g: List[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """optax.clip_by_global_norm, in place: (t / norm) * max_norm only when
    norm >= max_norm (no epsilon, unlike torch's clip_grad_norm_)."""
    clip = norm >= max_norm
    torch._foreach_div_(g, torch.where(clip, norm, torch.ones_like(norm)))
    torch._foreach_mul_(g, torch.where(clip, torch.full_like(norm, max_norm),
                                       torch.ones_like(norm)))


def clip_by_global_norm_sharded(updates: List[torch.Tensor], max_norm: float,
                                wire: Wire) -> torch.Tensor:
    """optax.clip_by_global_norm for updates that are SHARDS of the global
    tree (the dp_shard_update path), in place: the sum of squares is
    summed over the ranks of `wire` so the trigger and scale match the
    replicated clip exactly. Returns the global norm."""
    sumsq = _sumsq(updates)
    with wire.region("metrics", sumsq.device):
        wire.all_reduce(sumsq)
    norm = sumsq.sqrt().float()
    _clip_by_norm(updates, norm, max_norm)
    return norm


def default_optimizer(
    learning_rate: float = 3e-4,
    *,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
    shard_axis: Optional[str] = None,
) -> Optimizer:
    """AdamW + warmup-cosine schedule + global-norm clip (the GPT/Llama
    recipe), with optax's numbers: the schedule starts at 0 (the first
    update moves nothing), peaks at `learning_rate` after `warmup_steps`
    and ends at 0.1 * learning_rate at max(total_steps, warmup_steps + 1);
    Adam eps 1e-8.

    shard_axis: set to the dp mesh axis when the optimizer will run on
    cross-replica shards (dp_shard_update) — the global-norm clip then
    sums the squared norm across shards instead of under-reading it."""
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=learning_rate,
        warmup_steps=warmup_steps,
        decay_steps=max(total_steps, warmup_steps + 1),
        end_value=learning_rate * 0.1,
    )
    return Optimizer(schedule=schedule, b1=b1, b2=b2, eps=1e-8,
                     weight_decay=weight_decay, grad_clip=grad_clip, shard_axis=shard_axis)


# --------------------------------------------------------------- train state


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params  # leaf tensors with requires_grad, f32 masters
    opt_state: AdamWState
    # error-feedback residual of the int8-quantized gradient sync: per
    # param leaf, this rank's (1, n, k) block of JAX's (n, n, k) rows
    # buffer; None unless built with dp_error_feedback
    ef: Any = None


# ----------------------------------------------- cross-replica rows layout
#
# The explicit data-parallel sync paths (quantized all-reduce, sharded
# weight update — arxiv 2004.13336) move each gradient/param leaf through a
# (n, k) "rows" layout: flatten, zero-pad to n*k with k a multiple of the
# quantizer block, reshape — row r is the chunk replica r owns. Padding
# lanes stay exactly zero through adam (zero grad -> zero update), so the
# round trip is lossless.


def _rows_k(size: int, n: int, block: int) -> int:
    k = -(-size // n)
    return -(-k // block) * block


def _to_rows(x: torch.Tensor, n: int, block: int) -> torch.Tensor:
    k = _rows_k(x.numel(), n, block)
    flat = x.reshape(-1).float()
    return F.pad(flat, (0, n * k - x.numel())).reshape(n, k)


def _from_rows(rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return rows.reshape(-1)[: like.numel()].reshape(like.shape).to(like.dtype)


def _mentions(spec: PartitionSpec, axis: str) -> bool:
    return any(entry == axis or (isinstance(entry, tuple) and axis in entry) for entry in spec)


def _check_pure_dp(param_specs: Any) -> None:
    """The explicit dp sync paths assume params replicated across `dp` —
    they move whole leaves through the rows layout."""
    bad = [spec for _, spec in _spec_items(param_specs) if _mentions(spec, "dp")]
    if bad:
        raise ValueError(
            "explicit dp sync (dp_shard_update / int8 all-reduce) requires "
            f"params replicated over the dp axis; got specs {bad[:3]}"
        )


def _spec_items(spec_tree: Any, prefix: str = ""):
    """(path, spec) over a tree of dicts whose leaves are PartitionSpecs."""
    if isinstance(spec_tree, PartitionSpec):
        yield prefix.rstrip("/"), spec_tree
        return
    for key, child in spec_tree.items():
        yield from _spec_items(child, f"{prefix}{key}/")


def infer_state_specs(state: Any, param_specs: Any) -> Dict[str, PartitionSpec]:
    """PartitionSpec of every tensor leaf of a state tree, as {path: spec}:
    a leaf whose tree-path suffix is a param path (the params themselves,
    Adam's mu / nu) gets that param's spec; everything else (counts,
    scalars) is replicated."""
    by_path = {tuple(path.split("/")): spec for path, spec in _spec_items(param_specs)}
    out: Dict[str, PartitionSpec] = {}
    for path, leaf in flatten(state):
        if not isinstance(leaf, torch.Tensor):
            continue
        keys = tuple(path.split("/"))
        out[path] = next((by_path[keys[i:]] for i in range(len(keys)) if keys[i:] in by_path),
                         PartitionSpec())
    return out


def state_specs(state: TrainState, config: TransformerConfig,
                rules: Optional[LogicalRules] = None, *,
                dp_shard_update: bool = False) -> Dict[str, PartitionSpec]:
    """JAX's state shardings of `create_train_state` as {leaf path: spec}:
    params by the rules, moments inheriting their param's spec, the
    rows-layout moments (dp_shard_update) and `ef` split over dp on their
    leading axis."""
    param_specs = tree_specs(logical_axes(config), rules or default_rules())
    specs = infer_state_specs(state, param_specs)
    for path in specs:
        rows_moment = dp_shard_update and path.startswith(("opt_state/mu/", "opt_state/nu/"))
        if rows_moment or path.startswith("ef/"):
            specs[path] = PartitionSpec("dp")
    return specs


def _dp_size(mesh: Optional[Mesh]) -> int:
    return mesh.shape["dp"] if mesh is not None else 1


def create_train_state(
    config: TransformerConfig,
    optimizer: Optimizer,
    seed: int = 0,
    *,
    params: Optional[Params] = None,
    device: Union[str, torch.device] = "cuda",
    mesh: Optional[Mesh] = None,
    rules: Optional[LogicalRules] = None,
    dp_shard_update: bool = False,
    dp_error_feedback: bool = False,
    dp_quant_block: Optional[int] = None,
) -> TrainState:
    """A fresh TrainState: params from `init_params(config, seed)` (every
    rank of a mesh draws the same ones), or copies of `params` (e.g. JAX
    weights carried with `params_from_numpy(..., dtype=torch.float32)`),
    and zero moments; on the mesh's device when a mesh is given, else on
    `device`.

    dp_shard_update stores Adam's moments in the cross-replica rows layout,
    this rank's row only (each replica keeps 1/n of them — arxiv
    2004.13336); dp_error_feedback adds the int8-sync residual buffer,
    this rank's (1, n, k) block per leaf."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    n_dp = _dp_size(mesh)
    if dp_quant_block is None:
        from ..core.config import cfg

        dp_quant_block = cfg.dp_quant_block
    if dp_shard_update or dp_error_feedback:
        _check_pure_dp(tree_specs(logical_axes(config), rules or default_rules()))
    if params is None:
        params = init_params(config, seed, device=dev)
    params = _tree_map(lambda t: t.detach().to(dev).clone().requires_grad_(True), params)
    if dp_shard_update:
        def row(p):
            return torch.zeros((1, _rows_k(p.numel(), n_dp, dp_quant_block)),
                               dtype=torch.float32, device=dev)

        opt_state = AdamWState(count=0, mu=_tree_map(row, params), nu=_tree_map(row, params))
    else:
        opt_state = optimizer.init(params)
    ef = None
    if dp_error_feedback:
        ef = _tree_map(lambda p: torch.zeros(
            (1, n_dp, _rows_k(p.numel(), n_dp, dp_quant_block)), dtype=torch.float32,
            device=dev), params)
    return TrainState(step=0, params=params, opt_state=opt_state, ef=ef)


def _adam_state(opt_state: Any) -> Any:
    """The node of an optax state tree that carries Adam's moments (its
    ScaleByAdamState: `count`, `mu`, `nu`), found by walking tuples."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for child in opt_state:
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def train_state_from_numpy(
    state: Any,
    config: TransformerConfig,
    device: Union[str, torch.device] = "cuda",
    *,
    mesh: Optional[Mesh] = None,
) -> TrainState:
    """The port's TrainState from a JAX `TrainState` whose leaves are numpy
    arrays (`jax.tree.map(np.asarray, state)`, or any object with `step`,
    `params` and an optax `opt_state`): f32 params with requires_grad,
    the AdamW moments and count (optax's ScaleByAdamState, found in the
    chain's state), the step and `ef`, on `device` (the mesh's, when one is
    given). A run continues from it as the JAX run would from `state`: the
    schedule reads the same count.

    Rows-layout leaves (the moments of a dp_shard_update state, (n, k) per
    param, and `ef`, (n, n, k)) are global in JAX: this rank keeps its row
    (its coordinate on the mesh's dp axis)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    row = mesh.axis_index("dp") if mesh is not None else 0
    adam = _adam_state(state.opt_state)
    if adam is None:
        raise ValueError("opt_state holds no Adam moments (no node with mu and nu)")

    def tree(values):
        return params_from_numpy(values, config, device=dev, dtype=torch.float32)

    def moments(values):
        shapes = {p: np.shape(v) for p, v in flatten(values)}
        if all(shapes[p] == np.shape(v) for p, v in flatten(state.params)):
            return tree(values)
        return _tree_map(lambda t: t[row:row + 1].clone(), _numpy_tree(values, dev))

    params = _tree_map(lambda t: t.requires_grad_(True), tree(state.params))
    opt_state = AdamWState(count=int(adam.count), mu=moments(adam.mu), nu=moments(adam.nu))
    ef = getattr(state, "ef", None)
    if ef is not None:
        ef = _tree_map(lambda t: t[row:row + 1].clone(), _numpy_tree(ef, dev))
    return TrainState(step=int(state.step), params=params, opt_state=opt_state, ef=ef)


def _numpy_tree(values: Any, dev: torch.device) -> Params:
    """A tree of numpy arrays as f32 tensors on `dev`, keys as they are."""
    if isinstance(values, dict):
        return {k: _numpy_tree(v, dev) for k, v in values.items()}
    return torch.from_numpy(np.ascontiguousarray(np.asarray(values, dtype=np.float32))).to(dev)


# ---------------------------------------------------------------- the steps


def loss_and_grads(
    config: TransformerConfig,
    params: Params,
    tokens: torch.Tensor,
    *,
    z_loss_coeff: float = 0.0,
    grad_accum: int = 1,
    loss_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """(loss, num_tokens, grads) for tokens (B, S+1): the forward and
    backward of one train step. Microbatch gradients are summed, then
    scaled by 1/grad_accum, as JAX's scan does. grads follow
    `tree_leaves(params)`.

    loss_chunk > 0 takes the fused chunked head + loss; None picks it with
    `auto_loss_chunk` from the device's memory; 0 forces the dense loss."""
    leaves = tree_leaves(params)
    dev = tokens.device

    def loss_fn(tok):
        targets = tok[:, 1:]
        chunk = loss_chunk
        if chunk is None:
            chunk = auto_loss_chunk(tok.shape[0], tok.shape[1] - 1, config.vocab_size, device=dev)
        if chunk:
            hidden = forward_hidden(params, tok[:, :-1], config)
            return fused_linear_cross_entropy(
                hidden, lm_head_weights(params, config), targets,
                chunk=chunk, z_loss_coeff=z_loss_coeff,
            )
        logits = forward(params, tok[:, :-1], config)
        return cross_entropy_loss(logits, targets, z_loss_coeff=z_loss_coeff)

    if grad_accum == 1:
        loss, ntok = loss_fn(tokens)
        return loss.detach(), ntok, list(torch.autograd.grad(loss, leaves))
    if tokens.shape[0] % grad_accum:
        raise ValueError(f"batch {tokens.shape[0]} not divisible by grad_accum {grad_accum}")
    grads: Optional[List[torch.Tensor]] = None
    total_loss = torch.zeros((), dtype=torch.float32, device=dev)
    total_ntok = torch.zeros((), dtype=torch.float32, device=dev)
    for mb in tokens.view(grad_accum, tokens.shape[0] // grad_accum, *tokens.shape[1:]):
        loss, ntok = loss_fn(mb)
        mb_grads = torch.autograd.grad(loss, leaves)
        if grads is None:
            grads = list(mb_grads)
        else:
            torch._foreach_add_(grads, mb_grads)
        total_loss = total_loss + loss.detach()
        total_ntok = total_ntok + ntok
    scale = 1.0 / grad_accum
    torch._foreach_mul_(grads, scale)
    return total_loss * scale, total_ntok, grads


def make_train_step(
    config: TransformerConfig,
    optimizer: Optimizer,
    *,
    z_loss_coeff: float = 0.0,
    grad_accum: int = 1,
    loss_chunk: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    mesh: Optional[Mesh] = None,
    dp_allreduce_dtype: Optional[str] = None,
    dp_shard_update: Optional[bool] = None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Metrics]]:
    """One training step. batch = {"tokens": (B, S+1) int}: under a dp
    mesh, this rank's rows of the global batch. The state is updated in
    place (the counterpart of JAX's donation) and returned; metrics =
    {"loss", "grad_norm" (before the clip), "num_tokens"} as f32 device
    tensors over the global batch, read back by nothing inside the step.

    dp_allreduce_dtype / dp_shard_update (None = read cfg flags) move the
    data-parallel gradient sync onto the explicit path: "int8"
    block-quantizes the all-reduce wire with error feedback (EQuARX),
    dp_shard_update reduce-scatters grads and shards the weight update +
    Adam state across replicas (reduce-scatter -> shard-local update ->
    all-gather params, arxiv 2004.13336). Both need a state built by
    create_train_state with matching flags. On one replica both run the
    standard step, as JAX's do.

    The phases carry `torch.profiler` labels "steplog.fwd_bwd_compute",
    "steplog.dp_sync" and "steplog.optimizer_update", as the JAX step's
    named scopes do. Under a dp mesh the returned function has a `wire`
    attribute (`parallel.Wire` of the dp group): the bytes and seconds of
    its collectives, labelled "dp_sync" (the gradient sync), "dp_gather"
    (the sharded update's parameter all-gather) and "metrics"."""
    from ..core.config import cfg

    if dp_allreduce_dtype is None:
        dp_allreduce_dtype = cfg.dp_allreduce_dtype
    if dp_shard_update is None:
        dp_shard_update = cfg.dp_shard_update
    dev = mesh.device if mesh is not None else resolve_device(device)
    n_dp = _dp_size(mesh)

    def microbatch_grads(params: Params, tokens: torch.Tensor):
        return loss_and_grads(config, params, tokens, z_loss_coeff=z_loss_coeff,
                              grad_accum=grad_accum, loss_chunk=loss_chunk)

    if n_dp > 1 and (dp_shard_update or dp_allreduce_dtype == "int8"):
        return _make_explicit_dp_step(
            optimizer, mesh, microbatch_grads,
            dp_allreduce_dtype=dp_allreduce_dtype,
            dp_shard_update=dp_shard_update,
            dp_quant_block=cfg.dp_quant_block,
        )
    wire = Wire.for_axis(mesh, "dp") if n_dp > 1 else None

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, Metrics]:
        tokens = batch["tokens"].to(dev)
        with record_function("steplog.fwd_bwd_compute"):
            loss, ntok, grads = microbatch_grads(state.params, tokens)
        if wire is not None:
            loss, ntok, grads = _implicit_dp_sync(wire, dev, loss, ntok, grads)
        with record_function("steplog.optimizer_update"):
            gnorm = global_norm(grads)
            state.opt_state = optimizer.update(grads, state.opt_state, state.params)
        state.step += 1
        metrics = {
            "loss": loss.float(),
            "grad_norm": gnorm,
            "num_tokens": ntok.float(),
        }
        return state, metrics

    if wire is not None:
        step.wire = wire
    return step


@torch.no_grad()
def _implicit_dp_sync(wire: Wire, dev: torch.device, loss: torch.Tensor, ntok: torch.Tensor,
                      grads: List[torch.Tensor]):
    """JAX's GSPMD data parallelism on the ranks' rows: the global loss is
    the token mean over every rank's rows, and its gradients are the
    ranks' gradients weighted by their share of the tokens, summed by one
    f32 all-reduce of every leaf at once."""
    with wire.region("metrics", dev):
        totals = wire.all_reduce(torch.stack([loss.float() * ntok.float(), ntok.float()]))
    with record_function("steplog.dp_sync"), wire.region("dp_sync", dev):
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        flat.mul_(ntok.float() / totals[1])
        wire.all_reduce(flat)
    synced = [part.view(g.shape).to(g.dtype)
              for part, g in zip(torch.split(flat, [g.numel() for g in grads]), grads)]
    return totals[0] / totals[1], totals[1], synced


def _make_explicit_dp_step(optimizer: Optimizer, mesh: Mesh, microbatch_grads, *,
                           dp_allreduce_dtype: str, dp_shard_update: bool, dp_quant_block: int):
    """The explicit data-parallel step: grads sync through the hand-built
    collectives of `parallel.collectives` on the dp group.

    Per replica: local grads -> rows layout -> [int8-quantized] all-reduce
    or reduce-scatter -> (replicated | shard-local) optimizer update ->
    [all-gather params]. Error feedback keeps the int8 wire honest: each
    replica's quantization residual re-enters its next-step gradient.
    Every leaf's rows travel side by side in one (n, sum of k) matrix."""
    axis = "dp"
    n = mesh.shape[axis]  # build_mesh makes pure-dp meshes only
    quantized = dp_allreduce_dtype == "int8"
    if dp_allreduce_dtype not in ("f32", "int8"):
        raise ValueError(f"unknown dp_allreduce_dtype {dp_allreduce_dtype!r}")
    dev = mesh.device
    wire = Wire.for_axis(mesh, axis)
    my = mesh.axis_index(axis)
    block = dp_quant_block

    def split(cat: torch.Tensor, widths: List[int]) -> List[torch.Tensor]:
        return list(torch.split(cat, widths, dim=-1))

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, Metrics]:
        tokens = batch["tokens"].to(dev)
        with record_function("steplog.fwd_bwd_compute"):
            loss, ntok, grads = microbatch_grads(state.params, tokens)
        params = tree_leaves(state.params)
        with torch.no_grad():
            grows = [_to_rows(g, n, block) for g in grads]
            widths = [r.shape[1] for r in grows]
            rows = torch.cat(grows, dim=1)
            del grows, grads
            if quantized:
                if state.ef is None:
                    raise ValueError(
                        "int8 dp all-reduce needs the error-feedback buffer; build the "
                        "state with create_train_state(dp_error_feedback=True)"
                    )
                ef = tree_leaves(state.ef)
                rows += torch.cat([e[0] for e in ef], dim=1)
            if dp_shard_update:
                with record_function("steplog.dp_sync"), wire.region("dp_sync", dev):
                    if quantized:
                        own, err = quantized_psum_scatter_rows(rows, wire, block=block)
                    else:
                        own = psum_scatter_rows(rows, wire)
                own = own / n
                if quantized:
                    for e, part in zip(ef, split(err, widths)):
                        e[0].copy_(part)
                own_leaves = split(own, widths)
                # this rank's rows of the params and of the moments, as trees
                # keyed like the leaves ((1, k) moment leaves arrive as views)
                p_shard = {str(i): _to_rows(p, n, block)[my] for i, p in enumerate(params)}
                opt = state.opt_state
                local = AdamWState(
                    count=opt.count,
                    mu={str(i): m[0] for i, m in enumerate(tree_leaves(opt.mu))},
                    nu={str(i): v[0] for i, v in enumerate(tree_leaves(opt.nu))})
                with wire.region("metrics", dev):
                    gnorm = wire.all_reduce(_sumsq(own_leaves)).sqrt().float()
                with record_function("steplog.optimizer_update"):
                    optimizer.update(own_leaves, local, p_shard, wire=wire)
                opt.count = local.count
                with wire.region("dp_gather", dev):
                    new_rows = wire.all_gather(torch.cat(list(p_shard.values())))
                for p, r in zip(params, split(new_rows, widths)):
                    p.copy_(_from_rows(r, p))
            else:
                with record_function("steplog.dp_sync"), wire.region("dp_sync", dev):
                    reduced, err = quantized_psum_rows(rows, wire, block=block)
                for e, part in zip(ef, split(err, widths)):
                    e[0].copy_(part)
                reduced /= n
                g_sync = [_from_rows(r, p) for r, p in zip(split(reduced, widths), params)]
                with record_function("steplog.optimizer_update"):
                    gnorm = global_norm(g_sync)
                    optimizer.update(g_sync, state.opt_state, state.params)
            with wire.region("metrics", dev):
                totals = wire.all_reduce(torch.stack([loss.float(), ntok.float()]))
        state.step += 1
        metrics = {
            "loss": totals[0] / n,
            "grad_norm": gnorm,
            "num_tokens": totals[1],
        }
        return state, metrics

    step.wire = wire
    return step


def make_eval_step(
    config: TransformerConfig, device: Union[str, torch.device] = "cuda"
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Metrics]:
    """Eval loss on batch = {"tokens": (B, S+1)}: {"eval_loss", "num_tokens"}."""
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_fn(state: TrainState, batch: Dict[str, torch.Tensor]) -> Metrics:
        tokens = batch["tokens"].to(dev)
        logits = forward(state.params, tokens[:, :-1], config)
        loss, ntok = cross_entropy_loss(logits, tokens[:, 1:])
        return {"eval_loss": loss.float(), "num_tokens": ntok}

    return eval_fn
