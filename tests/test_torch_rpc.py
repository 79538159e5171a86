"""The port's RPC layer, chunked object transfer and GCS service
(`ray_tpu_torch/core/rpc.py`, `object_transfer.py`, `gcs_service.py`):
every case of `tests/test_rpc.py` run on the port, the wire's tensors,
and the wire held against the JAX package's across packages — a port
client on a JAX server and the reverse, with and without a token, a port
pull from a JAX transfer server and a port GcsClient on a JAX GCS.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.core.gcs import GlobalControlStore
from ray_tpu_torch.core.gcs_service import GcsClient, serve_gcs
from ray_tpu_torch.core.ids import JobID, ObjectID
from ray_tpu_torch.core.object_store import ObjectStore
from ray_tpu_torch.core import object_transfer as tot
from ray_tpu_torch.core.object_transfer import (
    CHUNK_BYTES,
    ObjectTransferServer,
    fetch_object,
    push_object,
)
from ray_tpu_torch.core import rpc as trpc
from ray_tpu_torch.core.rpc import RpcClient, RpcError, RpcServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.pathsep.join(
    [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=REPO, env=ENV,
                          capture_output=True, text=True, timeout=120)


# --------------------------------------------------------------------- rpc


def test_rpc_roundtrip_and_errors():
    server = RpcServer({
        "add": lambda a, b: a + b,
        "fail": lambda: (_ for _ in ()).throw(ValueError("remote boom")),
        "echo_kw": lambda **kw: kw,
    })
    try:
        client = RpcClient(server.url)
        assert client.call("add", 2, 3) == 5
        assert client.add(10, b=20) == 30  # attr sugar
        assert client.call("echo_kw", x=1) == {"x": 1}
        with pytest.raises(ValueError, match="remote boom"):
            client.call("fail")
        with pytest.raises(AttributeError, match="no rpc method"):
            client.call("nope")
        client.close()
    finally:
        server.stop()


def test_rpc_oserror_from_handler_is_not_retried():
    """A handler exception that subclasses OSError re-raises typed WITHOUT
    being mistaken for a transport failure: no teardown, no re-execution."""
    calls = {"n": 0}

    def missing():
        calls["n"] += 1
        raise FileNotFoundError("no such working_dir")

    server = RpcServer({"missing": missing, "ok": lambda: 1})
    try:
        client = RpcClient(server.url, retries=3, retry_wait_s=0.01)
        with pytest.raises(FileNotFoundError, match="no such working_dir"):
            client.call("missing")
        assert calls["n"] == 1, "handler was re-executed by transport retry"
        assert client.call("ok") == 1
        assert client._sock is not None  # the connection survived
        client.close()
    finally:
        server.stop()


def test_rpc_reconnects_after_server_restart():
    server = RpcServer({"val": lambda: 1}, port=0)
    port = server.address[1]
    client = RpcClient(f"127.0.0.1:{port}", retries=5, retry_wait_s=0.2)
    assert client.call("val") == 1
    server.stop()
    box = {}

    def restart():
        time.sleep(0.4)
        box["server"] = RpcServer({"val": lambda: 2}, port=port)

    t = threading.Thread(target=restart)
    t.start()
    try:
        assert client.call("val") == 2  # retried across the outage
    finally:
        t.join()
        box["server"].stop()
        client.close()


def test_rpc_dead_server_raises_rpc_error():
    client = RpcClient("127.0.0.1:1", timeout=0.5, retries=0)
    with pytest.raises(RpcError):
        client.call("anything")


def test_rpc_concurrent_clients():
    server = RpcServer({"square": lambda x: x * x})
    try:
        results = {}

        def worker(i):
            c = RpcClient(server.url)
            results[i] = [c.square(j) for j in range(20)]
            c.close()

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(results[i] == [j * j for j in range(20)] for i in range(8))
    finally:
        server.stop()


# ----------------------------------------------------------- object transfer


def test_pull_and_push_objects_chunked():
    store = ObjectStore()
    server = ObjectTransferServer(store)
    try:
        big = np.arange(3 * CHUNK_BYTES // 8, dtype=np.float64)  # > 2 windows
        oid = ObjectID.for_put(JobID.next())
        store.put(oid, big)
        np.testing.assert_array_equal(fetch_object(server.address, oid.hex()), big)
        oid2 = ObjectID.for_put(JobID.next())
        push_object(server.address, oid2.hex(), {"nested": [1, 2, 3]})
        assert store.get(oid2, timeout=5) == {"nested": [1, 2, 3]}
        # tensors both ways: bf16 (its uint16 view on the wire), a
        # non-contiguous view, a 0-d and an empty tensor, a Parameter
        t = torch.randn(3 * CHUNK_BYTES // 2, dtype=torch.float32).to(torch.bfloat16)
        value = {"bf16": t, "view": torch.arange(12.0).reshape(3, 4)[:, 1:],
                 "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4),
                 "param": torch.nn.Parameter(torch.ones(3))}
        oid3 = ObjectID.for_put(JobID.next())
        store.put(oid3, value)
        back = fetch_object(server.address, oid3.hex())
        assert back["bf16"].dtype == torch.bfloat16 and torch.equal(back["bf16"], t)
        assert torch.equal(back["view"], value["view"]) and back["view"].is_contiguous()
        assert back["scalar"].shape == () and back["empty"].shape == (0, 4)
        assert isinstance(back["param"], torch.nn.Parameter) and back["param"].requires_grad
        oid4 = ObjectID.for_put(JobID.next())
        push_object(server.address, oid4.hex(), t)
        assert torch.equal(store.get(oid4, timeout=5), t)
    finally:
        server.stop()


def test_abandoned_transfer_swept_by_ttl(monkeypatch):
    """A client that begins a pull and dies must not pin the payload in
    the serving process forever: stale transfers are TTL-swept."""
    store = ObjectStore()
    server = ObjectTransferServer(store)
    try:
        oid = ObjectID.for_put(JobID.next())
        store.put(oid, np.arange(1000))
        client = RpcClient(server.address)
        info = client.call("pull_begin", oid.hex())  # ...then "die"
        assert info["transfer_id"] in server._outgoing
        monkeypatch.setattr(tot, "TRANSFER_TTL_S", 0.0)
        client.call("pull_begin", oid.hex())  # any later begin sweeps
        assert info["transfer_id"] not in server._outgoing
        client.close()
    finally:
        server.stop()


@pytest.mark.parametrize("payload", ["numpy", "cpu_tensor", "bf16_tensor"])
def test_transfer_streams_without_monolithic_copy(payload):
    """Out-of-band pickle-5 transfer: the payload's buffer is served as
    windows of the ORIGINAL memory — the sender never builds a monolithic
    payload-sized pickle (torch's own pickling of a tensor would: a
    torch.save blob of its storage)."""
    store = ObjectStore()
    server = ObjectTransferServer(store)
    try:
        n = 3 * CHUNK_BYTES // 8
        big = {"numpy": lambda: np.arange(n, dtype=np.float64),
               "cpu_tensor": lambda: torch.arange(n, dtype=torch.float64),
               "bf16_tensor": lambda: torch.arange(4 * n, dtype=torch.bfloat16)}[payload]()
        base = big.numpy() if isinstance(big, torch.Tensor) and big.dtype != torch.bfloat16 \
            else big.view(torch.uint16).numpy() if isinstance(big, torch.Tensor) else big
        oid = ObjectID.for_put(JobID.next())
        store.put(oid, big)
        client = RpcClient(server.address)
        info = client.call("pull_begin", oid.hex())
        tr = server._outgoing[info["transfer_id"]]
        assert info["meta_nbytes"] < 4096  # the meta pickle holds no payload
        assert any(
            len(mv) == base.nbytes and np.shares_memory(np.frombuffer(mv, np.uint8),
                                                        base.view(np.uint8))
            for mv in tr.buffers
        ), "the out-of-band buffer is a copy, not the payload's memory"
        client.call("pull_end", info["transfer_id"])
        client.close()
    finally:
        server.stop()


def test_cross_process_object_pull():
    """A SEPARATE OS process serves its store; we pull (a CPU tensor too)."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from ray_tpu_torch.core.ids import JobID, ObjectID
        from ray_tpu_torch.core.object_store import ObjectStore
        from ray_tpu_torch.core.object_transfer import ObjectTransferServer

        store = ObjectStore()
        oid = ObjectID.for_put(JobID.next())
        store.put(oid, (np.arange(100000), torch.arange(1000, dtype=torch.bfloat16)))
        server = ObjectTransferServer(store)
        print(server.address, oid.hex(), flush=True)
        sys.stdin.readline()  # hold until the parent is done
    """)
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=ENV,
                            stdout=subprocess.PIPE, stdin=subprocess.PIPE, text=True)
    try:
        address, oid_hex = proc.stdout.readline().split()
        arr, t = fetch_object(address, oid_hex)
        np.testing.assert_array_equal(arr, np.arange(100000))
        assert torch.equal(t, torch.arange(1000, dtype=torch.bfloat16))
    finally:
        proc.stdin.close()
        proc.wait(timeout=30)


def test_cuda_tensor_refused_without_a_device():
    """A CUDA tensor is staged through the host on the sender and rebuilt
    on the receiver's CUDA device; a receiver without one raises an error
    naming its node (this sandbox: no card, so the args are hand-made)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    buf = pickle.PickleBuffer(np.zeros(4, np.uint16))
    with pytest.raises(trpc.DeviceUnavailableError, match="no CUDA device"):
        trpc._rebuild_tensor("bfloat16", (4,), "<u2", buf, "cuda", False, False)


# --------------------------------------------------------------- gcs service


def test_gcs_service_cross_process():
    """The head serves its GCS; another process coordinates through it
    (KV, pubsub, named-actor existence)."""
    gcs = GlobalControlStore()
    gcs.kv.put("world_size", 4, namespace="train")
    gcs.register_named_actor("coordinator", object())
    server = serve_gcs(gcs)
    try:
        out = _run(f"""
            from ray_tpu_torch.core.gcs_service import GcsClient

            c = GcsClient("{server.url}")
            assert c.ping()
            assert c.kv_get("world_size", namespace="train") == 4
            c.kv_put("rank0_ready", True, namespace="train")
            assert c.has_named_actor("coordinator")
            assert not c.has_named_actor("nobody")
            c.publish("events", {{"hello": "from-worker"}})
            print("WORKER-OK")
        """)
        assert "WORKER-OK" in out.stdout, out.stderr
        assert gcs.kv.get("rank0_ready", namespace="train") is True
        assert any(m[1] == {"hello": "from-worker"} for m in gcs.pubsub.poll("events"))
    finally:
        server.stop()


def test_gcs_client_poll_subscription():
    gcs = GlobalControlStore()
    server = serve_gcs(gcs)
    try:
        client = GcsClient(server.url)
        gcs.pubsub.publish("ch", "m1")
        gcs.pubsub.publish("ch", "m2")
        assert [m for _, m in client.poll("ch")] == ["m1", "m2"]
        client.close()
    finally:
        server.stop()


def test_resource_sync_and_staleness():
    gcs = GlobalControlStore()
    server = serve_gcs(gcs)
    try:
        c = GcsClient(server.url)
        c.report_resources("node-a", {"CPU": 8, "GPU": 4})
        c.report_resources("node-b", {"CPU": 8})
        view = c.cluster_view()
        assert view["total"] == {"CPU": 16.0, "GPU": 4.0}
        assert set(view["nodes"]) == {"node-a", "node-b"}
        server.syncer._views["node-b"] = (0.0, {"CPU": 8})  # aged out
        view = c.cluster_view()
        assert view["total"] == {"CPU": 8.0, "GPU": 4.0}
        assert set(view["nodes"]) == {"node-a"}
        c.close()
    finally:
        server.stop()


def test_function_export_cross_process():
    """The driver exports a function by REFERENCE; another process fetches
    and runs it. A closure (JAX exports it by value with cloudpickle) is
    refused with TypeError naming the rule."""
    gcs = GlobalControlStore()
    server = serve_gcs(gcs)
    try:
        import torch_cluster_udfs

        client = GcsClient(server.url)
        client.register_function("total", torch_cluster_udfs.total)
        factor = 7
        with pytest.raises(TypeError, match="module level"):
            client.register_function("scale", lambda x: x * factor)
        out = _run(f"""
            from ray_tpu_torch.core.gcs_service import GcsClient

            c = GcsClient("{server.url}")
            fn = c.fetch_function("total")
            assert fn([20, 22]) == 42.0, fn([20, 22])
            assert c.fetch_function("missing") is None
            print("FUNC-OK")
        """)
        assert "FUNC-OK" in out.stdout, out.stderr
        client.close()
    finally:
        server.stop()


def test_gcs_epoch_fence():
    """A write carrying an epoch older than the head's is fenced; a live
    client re-adopts and succeeds, a pinned one stays rejected."""
    from ray_tpu_torch.core.exceptions import StaleEpochError

    gcs = GlobalControlStore()
    server = serve_gcs(gcs)
    try:
        live, zombie = GcsClient(server.url), GcsClient(server.url)
        assert live.adopt_epoch() == 0
        zombie.pin_epoch(0)
        gcs.bump_epoch()
        assert live.kv_put("k", 1) and live.epoch == 1
        with pytest.raises(StaleEpochError):
            zombie.kv_put("k", 2)
        assert gcs.kv.get("k") == 1
        live.close()
        zombie.close()
    finally:
        server.stop()


# ------------------------------------------------------- across the packages


@pytest.mark.parametrize("token", [None, "sekrit"])
def test_port_client_on_jax_server_and_back(token):
    """The wire is JAX's: a port client calls a JAX RpcServer and a JAX
    client a port RpcServer, values and typed errors crossing both ways."""
    from ray_tpu.core import rpc as jrpc

    def fail():
        raise KeyError("gone")

    handlers = {"add": lambda a, b: a + b, "fail": fail, "arr": lambda: np.arange(5)}
    for server_mod, client_mod in ((jrpc, trpc), (trpc, jrpc)):
        server = server_mod.RpcServer(handlers, token=token)
        try:
            client = client_mod.RpcClient(server.url, token=token, retries=0)
            assert client.call("add", 2, 3) == 5
            np.testing.assert_array_equal(client.call("arr"), np.arange(5))
            with pytest.raises(KeyError, match="gone"):
                client.call("fail")
            client.close()
            if token:
                bad = client_mod.RpcClient(server.url, token="wrong", retries=0, timeout=5.0)
                with pytest.raises(client_mod.RpcAuthError):
                    bad.call("add", 1, 1)
                bad.close()
                none = client_mod.RpcClient(server.url, retries=0, timeout=5.0)
                with pytest.raises(client_mod.RpcError):
                    none.call("add", 1, 1)
                none.close()
        finally:
            server.stop()


def test_port_fetch_from_jax_transfer_server():
    """A port pull from a JAX ObjectTransferServer: 9 MiB of numpy, three
    4 MiB windows; a port push into it; and JAX's pull and push against a
    port server."""
    from ray_tpu.core.ids import JobID as JJobID, ObjectID as JObjectID
    from ray_tpu.core.object_store import ObjectStore as JStore
    from ray_tpu.core.object_transfer import ObjectTransferServer as JServer

    assert CHUNK_BYTES == 4 << 20
    store = JStore()
    server = JServer(store)
    try:
        big = np.random.default_rng(0).standard_normal((9 << 20) // 8)
        oid = JObjectID.for_put(JJobID.next())
        store.put(oid, big)
        calls = []
        client = RpcClient(server.address)
        real = client.call
        client.call = lambda method, *a, **kw: (calls.append(method), real(method, *a, **kw))[1]
        np.testing.assert_array_equal(fetch_object(server.address, oid.hex(), client=client), big)
        assert calls.count("pull_chunk") == 1 + 3  # the meta window + 3 of the buffer
        client.close()
        oid2 = JObjectID.for_put(JJobID.next())
        push_object(server.address, oid2.hex(), {"x": np.arange(3)})
        np.testing.assert_array_equal(store.get(oid2, timeout=5)["x"], np.arange(3))
    finally:
        server.stop()
    # and the reverse: JAX's pull and push against a port server
    from ray_tpu.core.object_transfer import fetch_object as jfetch, push_object as jpush

    tstore = ObjectStore()
    tserver = ObjectTransferServer(tstore)
    try:
        oid3 = ObjectID.for_put(JobID.next())
        tstore.put(oid3, big)
        np.testing.assert_array_equal(jfetch(tserver.address, oid3.hex()), big)
        oid4 = ObjectID.for_put(JobID.next())
        jpush(tserver.address, oid4.hex(), big)
        np.testing.assert_array_equal(tstore.get(oid4, timeout=5), big)
    finally:
        tserver.stop()


def test_port_gcs_client_on_jax_gcs():
    """A port GcsClient on a JAX serve_gcs: KV, pubsub poll, the epoch
    fence's kwarg, resource sync and staleness."""
    from ray_tpu.core.gcs import GlobalControlStore as JGcs
    from ray_tpu.core.gcs_service import serve_gcs as jserve

    gcs = JGcs()
    server = jserve(gcs)
    try:
        c = GcsClient(server.url)
        assert c.adopt_epoch() == 0
        assert c.kv_put("k", {"v": 1}, namespace="ns")
        assert gcs.kv.get("k", namespace="ns") == {"v": 1}
        assert c.kv_get("k", namespace="ns") == {"v": 1}
        assert c.kv_keys(namespace="ns") == ["k"]
        c.publish("ch", "m1")
        assert [m for _, m in c.poll("ch")] == ["m1"]
        c.report_resources("node-a", {"CPU": 2})
        c.report_resources("node-b", {"CPU": 3})
        assert c.cluster_view()["total"] == {"CPU": 5.0}
        server.syncer._views["node-b"] = (0.0, {"CPU": 3})
        assert set(c.cluster_view()["nodes"]) == {"node-a"}
        assert c.kv_delete("k", namespace="ns")
        c.close()
    finally:
        server.stop()
