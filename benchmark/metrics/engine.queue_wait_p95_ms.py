"""engine.queue_wait_p95_ms: the 95th percentile of the time each of the
window's requests waited in the engine's admit queues before a slot took
it (the engine's own queue-wait observations at each first token,
`serve.tenancy.drain_queue_wait_window`)."""

from benchmark.harness.readers import p95


def read(run):
    value = p95(run.queue_waits)
    return None if value is None else 1e3 * value
