"""ray_tpu_torch.util — host-side observability: log capture, the event
log, the metrics registry and the cost layer of profiling (ports of
`ray_tpu.util.logs`, `.events`, `.metrics` and `.profiling`), and the
state-tree walker the checkpoints and the cost layer share."""
