"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's compute plane.

The JAX package `ray_tpu` stays the reference; this package mirrors its
module paths and names so each piece has an obvious counterpart:

- `ops`: layer primitives, flash attention and ragged paged attention,
  the two attention functions backed by hand-written CUDA kernels for
  Hopper (sm_90a) with a plain PyTorch version beside each;
- `models`: the decoder-only transformer (GPT-2 / Llama families), its
  presets and a converter from the JAX parameter pytree;
- `serve.llm`: the paged KV pool, the device passes of the paged engine,
  the continuous-batching `PagedLLMEngine` and `LLMServer`.

It imports `torch` and never `jax` or `ray_tpu`. Entry points run on the
CUDA device unless the caller passes `device="cpu"`; with no CUDA device
they raise instead of falling back.
"""

__version__ = "0.1.0"
