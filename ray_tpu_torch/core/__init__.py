"""ray_tpu_torch.core — the runtime: ids, the object store, the scheduler,
actors, streaming generators, the control store, the flag registry and
the typed errors (ports of `ray_tpu.core`)."""
