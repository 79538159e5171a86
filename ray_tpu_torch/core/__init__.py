"""ray_tpu_torch.core — the port's copies of the runtime's host-only pieces
that serving reads: the flag registry and the typed errors."""
