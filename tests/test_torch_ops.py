"""ray_tpu_torch.ops against ray_tpu.ops on the CPU.

The same inputs, drawn with numpy from a seed, go through the JAX function
and its port. On the CPU the port's attention functions take their plain
PyTorch versions; the JAX side runs its Pallas kernels in interpret mode
(as tests/test_ops.py and tests/test_ragged_attention.py do) and its
references. Tolerance for everything here: atol = rtol = 1e-5, the size of
f32 rounding when the two libraries sum in different orders.
"""

import subprocess
import sys
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import layers as jlayers
from ray_tpu.ops.attention import flash_attention as jflash
from ray_tpu.ops.attention import flash_attention_with_lse as jflash_lse
from ray_tpu.ops.attention import mha_reference as jmha
from ray_tpu.ops.ragged_paged_attention import ragged_paged_attention as jragged
from ray_tpu.serve.llm.paged import _gather_ref_attention as jgather
from ray_tpu_torch import ops as tops
from ray_tpu_torch.ops import layers as tlayers
from ray_tpu_torch.serve.llm.paged import _gather_ref_attention as tgather
from ray_tpu_torch.serve.llm.paged import paged_attention as tpaged_attention

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _close(jax_out, torch_out, **tol):
    np.testing.assert_allclose(
        np.asarray(jax_out), torch_out.detach().numpy(), **(tol or TOL)
    )


# ------------------------------------------------------------------ layers


def test_norms_and_activations_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    scale = rng.standard_normal((32,)).astype(np.float32)
    bias = rng.standard_normal((32,)).astype(np.float32)
    up = rng.standard_normal((3, 5, 32)).astype(np.float32)
    _close(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(scale)),
           tlayers.rmsnorm(_t(x), _t(scale)))
    _close(jlayers.layernorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)),
           tlayers.layernorm(_t(x), _t(scale), _t(bias)))
    _close(jlayers.gelu(jnp.asarray(x)), tlayers.gelu(_t(x)))
    _close(jlayers.swiglu(jnp.asarray(x), jnp.asarray(up)),
           tlayers.swiglu(_t(x), _t(up)))


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    d, max_seq = 16, 64
    jcos, jsin = jlayers.rope_frequencies(d, max_seq, theta)
    tcos, tsin = tlayers.rope_frequencies(d, max_seq, theta)
    _close(jcos, tcos)
    _close(jsin, tsin)
    x = rng.standard_normal((2, 3, 10, d)).astype(np.float32)
    pos = rng.integers(0, max_seq, size=(2, 10)).astype(np.int32)
    _close(jlayers.apply_rope(jnp.asarray(x), jcos, jsin),
           tlayers.apply_rope(_t(x), tcos, tsin))
    _close(jlayers.apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos)),
           tlayers.apply_rope(_t(x), tcos, tsin, _t(pos)))


# ------------------------------------------------------------------- flash


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v


# The port's forward is held against K1 (`_fwd_pallas`, interpret mode) and
# against K3's interpret twin (`_fwd_pipe_interp`: the skewed schedule with
# two score slots). 64-row blocks leave two kv tiles at S 96 and S 80, so the
# pipelined path does not fall back to the classic kernel. All three sum
# the same f32 terms tile by tile; 1e-5 (the file's TOL) covers the port's
# one-pass sums in another order.
_FWD_IMPLS = ("pallas", "pallas_pipelined")


@pytest.mark.parametrize("implementation", _FWD_IMPLS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("gqa", [False, True])
def test_flash_forward_matches_jax_pallas(causal, gqa, implementation):
    """S = 96 is not a multiple of the 64-row blocks: the JAX wrapper pads
    and masks (padded lengths), the port masks at kv_len directly."""
    q, k, v = _qkv(0, 2, 4, 2 if gqa else 4, 96, 32)
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                 implementation=implementation, block_q=64, block_kv=64)
    out = tops.flash_attention(_t(q), _t(k), _t(v), causal=causal, implementation=implementation)
    _close(ref, out)


@pytest.mark.parametrize("implementation", _FWD_IMPLS)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_lse_matches_jax_pallas(causal, implementation):
    q, k, v = _qkv(1, 1, 4, 2, 80, 32)
    jout, jlse = jflash_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, implementation=implementation,
                            block_q=64, block_kv=64)
    out, lse = tops.flash_attention_with_lse(_t(q), _t(k), _t(v), causal=causal)
    assert lse.shape == (1, 4, 80, 1) and lse.dtype == torch.float32
    _close(jout, out)
    _close(jlse, lse)


@pytest.mark.parametrize("implementation", [None, "pallas", "pallas_pipelined", "xla"])
def test_flash_entry_points_take_jax_keywords(implementation):
    """flash_attention and flash_attention_with_lse take JAX's keyword set,
    block sizes included (hints to the port, whose card tiles are fixed),
    and give JAX's output for each implementation."""
    q, k, v = _qkv(4, 1, 4, 2, 80, 32)
    kw = dict(causal=True, sm_scale=0.2, block_q=64, block_kv=32, implementation=implementation)
    jx = [jnp.asarray(a) for a in (q, k, v)]
    tx = [_t(a) for a in (q, k, v)]
    _close(jflash(*jx, **kw), tops.flash_attention(*tx, **kw))
    jout, jlse = jflash_lse(*jx, **kw)
    out, lse = tops.flash_attention_with_lse(*tx, **kw)
    _close(jout, out)
    _close(jlse, lse)


def test_flash_forward_plain_rounds_p_before_pv():
    """The contract the bf16 forward kernel keeps: scores and the row sum in
    f32, p rounded to bf16 before P.V, f32 accumulation, one rounding of O.
    `_flash_fwd_plain` equals that written out per head, and differs from
    the same computation with p left in f32."""
    from ray_tpu_torch.ops.attention import _flash_fwd_plain

    q, k, v = (_t(x).to(torch.bfloat16) for x in _qkv(9, 1, 4, 2, 48, 16))
    out, lse = _flash_fwd_plain(q, k, v, True, 0.25)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want, unrounded, want_lse = (torch.empty(q.shape) for _ in range(3))
    keep = torch.tril(torch.ones(48, 48, dtype=torch.bool))
    for h in range(4):
        qh, kh, vh = q[0, h].float(), k[0, h // 2].float(), v[0, h // 2].float()
        s = torch.where(keep, qh @ kh.T * 0.25, torch.tensor(-1e30))
        m = s.max(dim=-1, keepdim=True).values
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        want[0, h] = p.to(torch.bfloat16).float() @ vh / l
        unrounded[0, h] = p @ vh / l
        want_lse[0, h] = (m + torch.log(l)).expand(-1, 16)
    torch.testing.assert_close(out, want.to(torch.bfloat16), atol=0, rtol=0)
    torch.testing.assert_close(lse, want_lse[..., :1], atol=1e-6, rtol=1e-6)
    assert not torch.equal(out, unrounded.to(torch.bfloat16))


@pytest.mark.parametrize("causal", [False, True])
def test_mha_reference_matches_jax_with_kv_len(causal):
    q, k, v = _qkv(2, 2, 4, 2, 24, 16)
    ref = jmha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, kv_len=17)
    out = tops.mha_reference(_t(q), _t(k), _t(v), causal=causal, kv_len=17)
    _close(ref, out)


def test_flash_forward_refuses_gradients():
    """flash_attention carries a gradient (its backward is the flash
    backward's plain version here); flash_attention_with_lse stays
    forward-only, as in JAX."""
    q, k, v = (_t(x).requires_grad_() for x in _qkv(3, 1, 2, 2, 8, 16))
    out = tops.flash_attention(q, k, v)
    out.sum().backward()
    assert all(t.grad is not None and t.grad.shape == t.shape for t in (q, k, v))
    with pytest.raises(NotImplementedError, match="forward-only"):
        tops.flash_attention_with_lse(q, k, v)
    with torch.no_grad():
        assert tops.flash_attention_with_lse(q, k, v)[0].shape == (1, 2, 8, 16)
    with pytest.raises(ValueError, match="unknown attention implementation"):
        tops.flash_attention(q, k, v, implementation="mosaic")


# JAX implementation each port implementation is held against; on the CPU
# the port's None / "pallas" / "pallas_pipelined" all take the flash
# backward's plain version, "xla" runs mha_reference under torch autograd
_BWD_PAIRS = {
    "plain_vs_jax_xla": (None, "xla", {}),
    "plain_vs_jax_pallas": ("pallas", "pallas", dict(block_q=64, block_kv=64)),
    "plain_vs_jax_pipelined": ("pallas_pipelined", "pallas_pipelined", dict(block_kv=32)),
    "xla_vs_jax_xla": ("xla", "xla", {}),
}


@pytest.mark.parametrize("pair", list(_BWD_PAIRS))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("gqa", [False, True])
def test_flash_backward_matches_jax(pair, causal, gqa):
    """Gradients of sum(flash(q, k, v) * dO). S = 80 is not a multiple of
    the port's 64-row tiles; JAX pads: to 128 for "pallas" (K2 in
    interpret mode) and to 3 kv tiles of 32 for "pallas_pipelined" (K4's
    interpret twin `_bwd_pipe_interp`)."""
    import jax

    port_impl, jax_impl, blocks = _BWD_PAIRS[pair]
    q, k, v = _qkv(5, 1, 4, 2 if gqa else 4, 80, 32)
    do = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        o = jflash(q_, k_, v_, causal=causal, implementation=jax_impl, **blocks)
        return jnp.sum(o * jnp.asarray(do))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, causal=causal, implementation=port_impl)
    out.backward(_t(do))
    for jg, t in zip(jgrads, (tq, tk, tv)):
        _close(jg, t.grad)
    assert tops.FLASH_BWD_DKV.launches == 0 and tops.FLASH_BWD_DQ.launches == 0


def test_flash_backward_plain_is_the_kernel_contract():
    """_flash_bwd_plain against autograd of the reference in f32: the
    explicit formulas (P from lse, dS = P (dP - delta) scale, GQA group
    sums) are the gradient of the forward."""
    from ray_tpu_torch.ops.attention import _flash_bwd_plain, _flash_fwd_plain

    q, k, v = (_t(x) for x in _qkv(7, 2, 4, 2, 70, 16))
    do = _t(np.random.default_rng(8).standard_normal(q.shape).astype(np.float32))
    for causal in (False, True):
        out, lse = _flash_fwd_plain(q, k, v, causal, 0.25)
        grads = _flash_bwd_plain(q, k, v, out, lse, do, causal, 0.25)
        rq, rk, rv = (x.clone().requires_grad_() for x in (q, k, v))
        tops.mha_reference(rq, rk, rv, causal=causal, sm_scale=0.25).backward(do)
        for g, ref in zip(grads, (rq.grad, rk.grad, rv.grad)):
            torch.testing.assert_close(g, ref, **TOL)


# ------------------------------------------------------------------ ragged

BQ = 8


def _mixed_batch(seed=0, hq=4, hkv=2, d=16, ps=8, pool=40, maxp=8):
    """A mixed ragged batch: a prefill chunk at offset 0 (page-misaligned),
    chunks continuing at nonzero offsets (one full, one partial), two decode
    lanes, a verify-shaped region with q_len 4, and an inactive lane.
    Pad rows fill every region past q_len; table entries past a sequence's
    pages point at the scratch page 0."""
    rng = np.random.default_rng(seed)
    q_lens = np.array([13, 16, 11, 1, 1, 4, 0], np.int32)
    kv_lens = np.array([13, 32, 43, 37, 5, 20, 0], np.int32)
    counts = np.array([2, 2, 2, 1, 1, 1, 1], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    t = int(counts.sum()) * BQ
    tables = np.zeros((len(q_lens), maxp), np.int32)
    nxt = 1
    for s in range(len(q_lens)):
        for j in range((int(kv_lens[s]) + ps - 1) // ps):
            tables[s, j] = nxt
            nxt += 1
    assert nxt <= pool
    q = rng.standard_normal((hq, t, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, pool, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, pool, ps, d)).astype(np.float32)
    return q, kp, vp, starts, counts, q_lens, kv_lens, tables


@pytest.mark.parametrize("shape", [(4, 2, 16), (2, 2, 64)], ids=["gqa_d16", "mha_d64"])
def test_ragged_plain_matches_jax_kernel_and_reference(shape):
    hq, hkv, d = shape
    args = _mixed_batch(hq=hq, hkv=hkv, d=d)
    jargs = [jnp.asarray(a) for a in args]
    kernel = np.asarray(jragged(*jargs, block_q=BQ, interpret=True))
    ref = np.asarray(jragged(*jargs, block_q=BQ, use_kernel=False))
    out = tops.ragged_paged_attention(*[_t(a) for a in args], block_q=BQ)
    _close(kernel, out)
    _close(ref, out)
    # inactive lane: exact zeros; pad rows: finite
    lo = int(args[3][-1]) * BQ
    assert torch.all(out[:, lo : lo + BQ] == 0)
    assert torch.isfinite(out).all()
    # CPU tensors take the plain version: the kernel never launched
    assert tops.RAGGED.launches == 0


def test_decode_adapter_matches_jax_gather_reference():
    rng = np.random.default_rng(4)
    b, hq, hkv, d, ps, maxp, pool = 3, 4, 2, 16, 8, 4, 16
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kc = rng.standard_normal((hkv, pool, ps, d)).astype(np.float32)
    vc = rng.standard_normal((hkv, pool, ps, d)).astype(np.float32)
    tables = np.array([[1, 2, 3, 0], [4, 0, 0, 0], [5, 6, 7, 8]], np.int32)
    lengths = np.array([19, 1, 32], np.int32)
    ref = jgather(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                  jnp.asarray(tables), jnp.asarray(lengths))
    out = tpaged_attention(_t(q), _t(kc), _t(vc), _t(tables), _t(lengths), page_size=ps)
    _close(ref, out)
    _close(ref, tgather(_t(q), _t(kc), _t(vc), _t(tables), _t(lengths)))


# ------------------------------------------------------------------ package


def test_port_imports_neither_jax_nor_ray_tpu():
    code = (
        "import sys\n"
        "import ray_tpu_torch, ray_tpu_torch.ops, ray_tpu_torch.models\n"
        "import ray_tpu_torch.serve.llm, ray_tpu_torch.train, ray_tpu_torch.ops.losses\n"
        "import ray_tpu_torch.core.config, ray_tpu_torch.core.exceptions\n"
        "import ray_tpu_torch.serve.tenancy, ray_tpu_torch.serve.context\n"
        "import ray_tpu_torch.util.logs, ray_tpu_torch.util.events, ray_tpu_torch.util.metrics\n"
        "import ray_tpu_torch.util.profiling, ray_tpu_torch.util.tree, ray_tpu_torch.parallel.mesh\n"
        "import ray_tpu_torch.parallel.collectives, ray_tpu_torch.train.config\n"
        "import ray_tpu_torch.train.checkpoint, ray_tpu_torch.train.steplog\n"
        "import ray_tpu_torch.train.trainer, ray_tpu_torch.data.dataset, ray_tpu_torch.data.lm\n"
        "import ray_tpu_torch.api, ray_tpu_torch.core.ids, ray_tpu_torch.core.resources\n"
        "import ray_tpu_torch.core.object_store, ray_tpu_torch.core.gcs, ray_tpu_torch.core.scheduler\n"
        "import ray_tpu_torch.core.actors, ray_tpu_torch.core.streaming, ray_tpu_torch.core.runtime\n"
        "import ray_tpu_torch.util.tracing, ray_tpu_torch.serve.deployment, ray_tpu_torch.serve.multiplex\n"
        "import ray_tpu_torch.serve.reqlog, ray_tpu_torch.serve.router, ray_tpu_torch.serve.controller\n"
        "import ray_tpu_torch.serve.api, ray_tpu_torch.serve.llm.openai, ray_tpu_torch.serve.llm.server\n"
        "import ray_tpu_torch.util.state, ray_tpu_torch.util.watchdog, ray_tpu_torch.util.goodput\n"
        "import ray_tpu_torch.util.postmortem, ray_tpu_torch.util\n"
        "import ray_tpu_torch.data, ray_tpu_torch.data.block, ray_tpu_torch.data.datasource\n"
        "import ray_tpu_torch.data.executor, ray_tpu_torch.util.actor_pool, ray_tpu_torch.util.queue\n"
        "import ray_tpu_torch.train.session, ray_tpu_torch.train.worker_group\n"
        "import ray_tpu_torch.train.controller, ray_tpu_torch.train.multihost\n"
        "import ray_tpu_torch.parallel, ray_tpu_torch.parallel.sharding, ray_tpu_torch.parallel.spmd\n"
        "import ray_tpu_torch.core.worker_pool, ray_tpu_torch.core.worker_main\n"
        "import ray_tpu_torch.ops.ring_attention, ray_tpu_torch.ops.ulysses\n"
        "import ray_tpu_torch.models.moe, ray_tpu_torch.models.vit, ray_tpu_torch.models.convert\n"
        "import ray_tpu_torch.parallel.pipeline, chip_smoke, torch_a7_rank\n"
        "import ray_tpu_torch.core.runtime_env, ray_tpu_torch.core.native_store\n"
        "import ray_tpu_torch.core.health, ray_tpu_torch.util.multiprocessing\n"
        "import ray_tpu_torch.experimental, ray_tpu_torch.experimental.channel\n"
        "import ray_tpu_torch.experimental.shm_channel, ray_tpu_torch.experimental.dag\n"
        "import torch_process_udfs\n"
        "import ray_tpu_torch.core.rpc, ray_tpu_torch.core.gcs_service\n"
        "import ray_tpu_torch.core.object_transfer, ray_tpu_torch.core.cluster\n"
        "import ray_tpu_torch.cluster_utils, ray_tpu_torch.cli, torch_cluster_udfs\n"
        "import ray_tpu_torch.core.chaos, ray_tpu_torch.train.cluster_gang\n"
        "import ray_tpu_torch.core.capacity, ray_tpu_torch.core.autoscaler, ray_tpu_torch.jobs\n"
        "import ray_tpu_torch.launcher, ray_tpu_torch.parallel.dcn, torch_capacity_job\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from ray_tpu_torch.models import get_config, init_cache, init_params
    from ray_tpu_torch.serve.llm import (
        EngineConfig, LLMEngine, LLMServer, PagedConfig, PagedEngineConfig, PagedLLMEngine,
    )
    from ray_tpu_torch.serve.llm.paged import init_paged_cache

    config = get_config("llama-tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_paged_cache(config, PagedConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(config, 2, 16)
    for engine_config in (None, EngineConfig(), PagedEngineConfig()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LLMServer("llama-tiny", engine_config=engine_config)
    cpu_params = init_params(config, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedLLMEngine(config, cpu_params)
    # the dense engine's default device, and the cache it would build there
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(config, cpu_params, EngineConfig(max_slots=2, max_seq=16))
    from ray_tpu_torch.train import (
        create_train_state, default_optimizer, make_eval_step, make_train_step,
    )

    opt = default_optimizer(1e-3, total_steps=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(config, opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(config, opt, params=cpu_params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(config, opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(config)
    assert create_train_state(config, opt, params=cpu_params, device="cpu").step == 0
    # the trainer, a checkpoint restore and the LM batch feed place on the card too
    from ray_tpu_torch.data import lm_batch_iterator
    from ray_tpu_torch.train import CheckpointManager, LMTrainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMTrainer(get_config("gpt2-tiny"))
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        state = create_train_state(config, opt, params=cpu_params, device="cpu")
        mgr.save(0, state)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mgr.restore(state)
        assert mgr.restore(state, device="cpu").step == 0

    class Blocks:
        def iter_blocks(self):
            yield {"tokens": np.arange(40)}

    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_batch_iterator(Blocks(), 8, 2)
    batch = next(lm_batch_iterator(Blocks(), 8, 2, device="cpu"))
    assert batch["tokens"].device.type == "cpu" and batch.ready is None
    # the serve deployment path: app builders check the device before any
    # replica is built, and the runtime advertises no GPU
    from ray_tpu_torch.serve.llm import build_llm_app, build_openai_app, serve_openai

    for paged in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_llm_app("llama-tiny", paged=paged)
        assert build_llm_app("llama-tiny", paged=paged, device="cpu").deployment.name == "llm"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_openai_app(model="llama-tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_openai(model="llama-tiny")
    apps, routes = build_openai_app(model="llama-tiny", device="cpu")
    assert routes == {"llama-tiny": "openai-llama-tiny"} and len(apps) == 1


def test_parse_sass_counts_opcodes_per_function():
    """chip_smoke.py's build phase reads wgmma (HGMMA) and asynchronous
    copies (LDGSTS, UTMALDG) per kernel from `cuobjdump -sass`; predicated
    instructions count, the encoding lines and other opcodes do not."""
    from ray_tpu_torch.ops._build import parse_sass

    text = (
        "\tcode for sm_90a\n"
        "\t\tFunction : _Z5dkv_bf16\n"
        "        /*0000*/   LDGSTS.E.BYPASS.LTC128B.128 [R3], desc[UR4][R4.64] ;  /* 0x0 */\n"
        "                                                                       /* 0x000fe4 */\n"
        "        /*0010*/   @!P0 HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;     /* 0x1 */\n"
        "        /*0020*/   HGMMA.64x64x16.F32.BF16 R24, R88, gdesc[UR8], R24 ;   /* 0x2 */\n"
        "        /*0030*/   FFMA R1, R2, R3, R4 ;                                 /* 0x3 */\n"
        "\t\tFunction : _Z5dkv_f32\n"
        "        /*0000*/   FFMA R1, R2, R3, R4 ;                                 /* 0x3 */\n"
    )
    counts = parse_sass(text, ("HGMMA", "LDGSTS", "UTMALDG"))
    assert counts == {
        "_Z5dkv_bf16": {"HGMMA": 2, "LDGSTS": 1, "UTMALDG": 0},
        "_Z5dkv_f32": {"HGMMA": 0, "LDGSTS": 0, "UTMALDG": 0},
    }


def test_library_name_follows_included_headers(tmp_path):
    """A kernel's library is cached under a hash of its source and of the
    headers it includes by a quoted name, nested ones too: an edited header
    rebuilds every source that includes it and no other."""
    from ray_tpu_torch.ops import _build

    (tmp_path / "inner.cuh").write_text("// inner\n")
    (tmp_path / "tiles.cuh").write_text('#include "inner.cuh"\n#include <stdint.h>\n')
    (tmp_path / "a.cu").write_text('#include <cuda_runtime.h>\n  #  include "tiles.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    assert _build._source_files(tmp_path / "a.cu") == [
        tmp_path / "a.cu", tmp_path / "tiles.cuh", tmp_path / "inner.cuh"]
    before = {n: _build._lib_path(tmp_path / n).name for n in ("a.cu", "b.cu")}
    assert before["a.cu"].startswith("a-") and before["a.cu"].endswith(".so")
    (tmp_path / "inner.cuh").write_text("// inner, edited\n")
    after = {n: _build._lib_path(tmp_path / n).name for n in ("a.cu", "b.cu")}
    assert after["a.cu"] != before["a.cu"] and after["b.cu"] == before["b.cu"]
    # the flash and ragged sources include the shared Hopper header of csrc/
    for name in ("flash_attention_fwd.cu", "flash_attention_bwd.cu", "ragged_paged_attention.cu"):
        assert _build.CSRC / "hopper_tiles.cuh" in _build._source_files(_build.CSRC / name)


def test_ragged_split_plan_fills_the_card_from_host_sizes(monkeypatch):
    """The bf16 decode kernel's split of each lane's kv walk (in 64-position
    tiles) comes from host-known sizes only: the serve run's decode step (8
    lanes x 8 kv heads, 16 pages of 64) gets 4 splits of 4 tiles, 256
    blocks for 132 SMs of two blocks each (8 of 2 when aiming at four);
    lanes enough to fill the card alone keep one split; a run never falls
    below 2 tiles, and every tile belongs to a split."""
    from ray_tpu_torch.ops.ragged_paged_attention import _split_plan

    rpa = sys.modules["ray_tpu_torch.ops.ragged_paged_attention"]  # the package's name is the function's

    assert _split_plan(8, 8, 16, 64, 132) == (4, 4)
    monkeypatch.setattr(rpa, "_SPLIT_TARGET_WAVES", 4)
    assert _split_plan(8, 8, 16, 64, 132) == (8, 2)
    monkeypatch.undo()
    assert _split_plan(256, 8, 16, 64, 132) == (1, 16)
    assert _split_plan(1, 1, 3, 16, 132) == (1, 2)
    assert _split_plan(8, 8, 0, 64, 132) == (1, 2)
    for lanes, heads, pages, ps in ((8, 8, 16, 64), (3, 2, 100, 40), (1, 8, 512, 128)):
        n, per = _split_plan(lanes, heads, pages, ps, 132)
        tiles = -(-pages * ps // 64)
        assert per >= 2 and (n - 1) * per < tiles <= n * per


@pytest.mark.parametrize("rows", [1, 2, 3, 9, 27, 256])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_ragged_decode_workspace_aligns_the_accumulators(rows, head_dim):
    """The decode workspace holds every partial row's (m, l) pair, then
    their accumulators: these start on 16 bytes (the combine's float4 loads
    at D 128) for any row count, odd ones included, after all the pairs and
    before the end."""
    from ray_tpu_torch.ops.ragged_paged_attention import _workspace_layout

    floats, acc_offset = _workspace_layout(rows, head_dim)
    assert (acc_offset * 4) % 16 == 0
    assert 2 * rows <= acc_offset < 2 * rows + 4
    assert floats == acc_offset + rows * head_dim
