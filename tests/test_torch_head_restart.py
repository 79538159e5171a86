"""The port's head fault tolerance (`ray_tpu_torch/core/gcs.py`'s WAL and
snapshots, `core/runtime.py`'s restore and reconciliation, `cli.py`'s
`--snapshot-path` / `--restore`, `core/chaos.py`'s `kill_head`): every
case of `tests/test_head_restart.py` run on the port's CLI and GcsClient,
and parity cases with the JAX package on the same inputs — a WAL written
by JAX's `GcsWal` read by both `_scan_wal`s, and one sequence of writes
snapshotted, continued and restored through both control stores.

The drills spawn `python -m ray_tpu_torch start` heads and agents (each
imports torch, ~3 s here); what an agent runs lives in the root module
`torch_cluster_udfs.py`. Every drill asserts that no child process is
left.
"""

import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

import ray_tpu_torch
import torch_cluster_udfs as udfs
import torch_process_udfs
from ray_tpu_torch.core.config import cfg
from ray_tpu_torch.core.exceptions import HeadUnavailableError, StaleEpochError
from ray_tpu_torch.core.gcs import GcsWal, GlobalControlStore
from ray_tpu_torch.core.gcs_service import GcsClient, serve_gcs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = {**os.environ,
        "PYTHONPATH": os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p),
        "RAY_TPU_NODE_HEARTBEAT_S": "0.2", "RAY_TPU_NODE_STALE_S": "2.5",
        "RAY_TPU_GCS_SNAPSHOT_INTERVAL_S": "0.5"}
_ENV.pop("RAY_TPU_CHAOS", None)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _head_cmd(port, snap):
    return [sys.executable, "-m", "ray_tpu_torch", "start", "--head", "--port", str(port),
            "--num-cpus", "1", "--num-gpus", "0", "--snapshot-path", snap]


def _agent_cmd(address, num_cpus, resources):
    return [sys.executable, "-m", "ray_tpu_torch", "start", "--address", address,
            "--num-cpus", str(num_cpus), "--num-gpus", "0", "--resources", resources]


def _spawn(cmd, log_path, env=None):
    with open(log_path, "w") as log:
        return subprocess.Popen(cmd, env=env or _ENV, stdout=log, stderr=subprocess.STDOUT,
                                text=True, cwd=REPO)


def _wait_line(path, needle, timeout=90, proc=None):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            break
        with open(path) as f:
            if needle in f.read():
                return
        time.sleep(0.2)
    with open(path) as f:
        raise AssertionError(f"never saw {needle!r} in:\n{f.read()}")


def _terminate(*procs):
    for proc in procs:
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=15)


def _wait_until(predicate, timeout=15.0):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, "condition never became true"
        time.sleep(0.05)


def _observe(address, resource, want):
    """JAX's observer, in this process: join the cluster with no
    resources of its own, wait until `resource` >= `want` is visible, run
    one task there and return its pid."""
    ray_tpu_torch.init(address=address, num_cpus=0, num_gpus=0)
    try:
        deadline = time.monotonic() + 60
        while ray_tpu_torch.cluster_resources().get(resource, 0) < want:
            assert time.monotonic() < deadline, (
                f"never saw {resource}>={want}: {ray_tpu_torch.cluster_resources()}")
            time.sleep(0.2)
        where = ray_tpu_torch.remote(num_cpus=0, resources={resource: 1})(udfs.pid)
        return ray_tpu_torch.get(where.remote(), timeout=60)
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture
def no_children_left():
    before = torch_process_udfs.live_children()
    yield
    assert torch_process_udfs.wait_no_children(before, timeout=30) == [], "a process outlived its drill"


# --------------------------------------------------------------------------
# durability: WAL + snapshot
# --------------------------------------------------------------------------


def test_wal_replay_beats_snapshot_only(tmp_path):
    """Every acknowledged mutation AFTER the last snapshot comes back from
    the journal; a snapshot-only restore loses them."""
    snap = str(tmp_path / "gcs.snap")
    wal = snap + ".wal"

    a = GlobalControlStore()
    a.attach_wal(wal)
    a.kv.put("pre", 1)
    a.snapshot(snap)
    a.kv.put("post", {"x": 2})
    a.kv.put("pre", "rewritten")
    a.kv.delete("pre")
    a.register_named_actor("late-actor", object())

    snap_only = GlobalControlStore()
    snap_only.restore(snap, wal_path=None)
    assert snap_only.kv.get("pre") == 1  # stale: the crash would lose data
    assert snap_only.kv.get("post") is None

    b = GlobalControlStore()
    b.restore(snap, wal_path=wal)
    assert b.kv.get("post") == {"x": 2}
    assert b.kv.get("pre") is None  # the delete replayed too
    # a named actor journals its NAME: restored as a placeholder
    assert "late-actor" in b.list_named_actors()
    assert b.get_named_actor("late-actor") is None
    assert b.last_restore["wal_records_applied"] >= 3
    a.detach_wal()


def test_wal_only_restart_without_snapshot(tmp_path):
    """A head that dies before its first snapshot still recovers every
    acknowledged write from the journal alone."""
    wal = str(tmp_path / "gcs.snap.wal")
    a = GlobalControlStore()
    a.attach_wal(wal)
    for i in range(20):
        a.kv.put(f"k{i}", i, namespace="drill")
    a.kv.delete("k3", namespace="drill")
    a.detach_wal()

    b = GlobalControlStore()
    assert b.replay_wal(wal, -1) == 21
    assert b.kv.get("k7", namespace="drill") == 7
    assert b.kv.get("k3", namespace="drill") is None


def test_torn_wal_tail_is_quarantined(tmp_path):
    """A torn tail (the head died mid-append) does not poison replay: the
    valid prefix is applied, the garbage moves aside, and the journal
    keeps accepting appends with continuous seqs."""
    wal = str(tmp_path / "gcs.snap.wal")
    a = GlobalControlStore()
    a.attach_wal(wal)
    a.kv.put("good", 1)
    a.kv.put("also-good", 2)
    a.detach_wal()
    with open(wal, "ab") as f:
        f.write(b"\x00\x00\x00\x09torn-mid-append")

    b = GlobalControlStore()
    assert b.replay_wal(wal, -1) == 2
    assert b.kv.get("good") == 1 and b.kv.get("also-good") == 2
    assert b.last_restore["wal_quarantined_bytes"] > 0

    reopened = GcsWal(wal)
    assert reopened.quarantined_bytes > 0
    assert os.path.exists(wal + ".quarantine")
    assert reopened.last_seq == 2  # seq resumes after the valid prefix
    assert reopened.append("kv_put", ("next", 3, "default")) == 3
    reopened.close()


def test_snapshot_compacts_wal(tmp_path):
    """A snapshot is the WAL's compaction point: the records it covers are
    dropped, and snapshot + compacted journal still restore everything."""
    snap = str(tmp_path / "gcs.snap")
    wal = snap + ".wal"
    a = GlobalControlStore()
    a.attach_wal(wal)
    for i in range(50):
        a.kv.put(f"bulk{i}", "x" * 200)
    size_before = os.path.getsize(wal)
    a.snapshot(snap)
    assert os.path.getsize(wal) < size_before
    a.kv.put("after-compact", 1)
    a.detach_wal()

    b = GlobalControlStore()
    b.restore(snap, wal_path=wal)
    assert b.kv.get("bulk49") == "x" * 200
    assert b.kv.get("after-compact") == 1
    assert b.last_restore["wal_records_applied"] == 1  # only the later record


def test_unpicklable_keys_warn_once(tmp_path, caplog):
    """Process-local values (locks, sockets) are not durable; the snapshot
    and the journal each say so exactly ONCE per key."""
    snap = str(tmp_path / "gcs.snap")
    store = GlobalControlStore()
    store.attach_wal(snap + ".wal")
    with caplog.at_level(logging.WARNING, logger="ray_tpu_torch.core.gcs"):
        store.kv.put("lockref", threading.Lock())
        store.kv.put("lockref", threading.Lock())  # journal warning: once
        store.kv.put("plain", 1)
        store.snapshot(snap)
        store.snapshot(snap)  # snapshot warning: once
    snap_warns = [r for r in caplog.records if "skipping unpicklable" in r.message]
    wal_warns = [r for r in caplog.records if "cannot journal" in r.message]
    assert len(snap_warns) == 1, caplog.text
    assert len(wal_warns) == 1, caplog.text
    store.detach_wal()
    b = GlobalControlStore()
    b.restore(snap, wal_path=snap + ".wal")
    assert b.kv.get("plain") == 1


# --------------------------------------------------------------------------
# parity with the JAX package
# --------------------------------------------------------------------------


def test_scan_wal_matches_jax_on_a_torn_jax_wal(tmp_path):
    """A WAL written by JAX's GcsWal with plain values (the framing is
    byte for byte the same; the bodies load with the standard pickle), its
    tail torn, gives both `_scan_wal`s the same records, good length and
    size; the port's GcsWal reopens it and resumes JAX's seqs."""
    from ray_tpu.core import gcs as jgcs

    from ray_tpu_torch.core import gcs as pgcs

    path = str(tmp_path / "jax.wal")
    jwal = jgcs.GcsWal(path)
    jwal.append("kv_put", ("a", {"x": [1, 2.5, "s"]}, "default"))
    jwal.append("kv_put", ("b", (3, None), "drill"))
    jwal.append("kv_delete", ("a", "default"))
    jwal.append("actor_register", ("named", "default"))
    jwal.close()
    with open(path, "ab") as f:
        f.write(b"\x00\x00\x00\x20\x00\x00\x00\x00\x00\x00\x00\x05torn")

    want = jgcs._scan_wal(path)
    got = pgcs._scan_wal(path)
    assert got == want
    records, good, size = got
    assert [r[0] for r in records] == [1, 2, 3, 4] and good < size

    # a record the port appends reads back in JAX too (seq 5)
    wal = GcsWal(path)
    assert wal.last_seq == 4 and wal.quarantined_bytes == size - good
    wal.append("kv_put", ("c", [7], "default"))
    wal.close()
    assert jgcs._scan_wal(path) == pgcs._scan_wal(path)
    assert pgcs._scan_wal(path)[0][-1] == (5, "kv_put", ("c", [7], "default"))


def test_snapshot_restore_replay_matches_jax(tmp_path):
    """The same KV puts and deletes and named actors through both control
    stores, each with its WAL, snapshotted, then more writes, then restore
    + replay into fresh stores and an epoch bump: equal tables, equal
    `last_restore` counts, equal epochs."""
    from ray_tpu.core import gcs as jgcs

    def drive(mod, d):
        snap = os.path.join(d, "gcs.snap")
        a = mod.GlobalControlStore()
        a.attach_wal(snap + ".wal")
        for i in range(12):
            a.kv.put(f"k{i}", {"i": i, "sq": i * i}, namespace="drill")
        a.kv.delete("k4", namespace="drill")
        a.register_named_actor("before", object())
        a.bump_epoch()
        a.snapshot(snap)
        for i in range(10, 16):
            a.kv.put(f"k{i}", [i, str(i)], namespace="drill")
        a.kv.delete("k1", namespace="drill")
        a.kv.delete("missing", namespace="drill")  # journals nothing
        a.register_named_actor("after", object())
        a.unregister_named_actor("before")
        a.kv.put("k0", "overwritten", namespace="drill", overwrite=False)  # refused
        a.detach_wal()
        b = mod.GlobalControlStore()
        b.restore(snap, wal_path=snap + ".wal")
        epoch = b.bump_epoch()
        counts = {k: b.last_restore[k] for k in
                  ("snapshot_wal_seq", "wal_records_applied", "wal_quarantined_bytes")}
        return dict(b.kv._data), sorted(b._named_actors.items()), counts, epoch

    jd, pd = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    pd.mkdir()
    want = drive(jgcs, str(jd))
    got = drive(__import__("ray_tpu_torch.core.gcs", fromlist=["gcs"]), str(pd))
    assert got == want
    table, actors, counts, epoch = got
    assert epoch == 2 and counts["wal_records_applied"] == 9
    assert ("default", "after") in [k for k, _ in actors]


# --------------------------------------------------------------------------
# epoch fencing + typed degraded mode (real RPC)
# --------------------------------------------------------------------------


def test_epoch_fence_rejects_stale_writer():
    """A writer carrying an epoch from before the restart gets the typed,
    NON-retryable StaleEpochError; a live client re-adopts and proceeds."""
    store = GlobalControlStore()
    server = serve_gcs(store, port=0)
    try:
        zombie = GcsClient(server.url, retry_window_s=1.0)
        zombie.adopt_epoch()
        zombie.pin_epoch(zombie.epoch)
        store.bump_epoch()  # the head restarted underneath it
        with pytest.raises(StaleEpochError) as exc_info:
            zombie.kv_put("fenced", 1)
        assert not isinstance(exc_info.value, OSError)
        assert store.kv.get("fenced") is None

        fresh = GcsClient(server.url, retry_window_s=1.0)
        fresh.adopt_epoch()
        assert fresh.epoch == store.current_epoch()
        assert fresh.kv_put("fenced", 2)
        assert store.kv.get("fenced") == 2
        zombie.close()
        fresh.close()
    finally:
        server.stop()


def _rebind(store, port, attempts=50):
    """Serve `store` again on the SAME port (agents reconnect to the
    address they hold)."""
    for _ in range(attempts):
        try:
            return serve_gcs(store, port=port)
        except OSError:
            time.sleep(0.1)
    raise AssertionError(f"could not rebind port {port}")


def test_head_outage_is_typed_and_transitions_fire():
    """While the head is down every call fails with HeadUnavailableError
    (a ConnectionError), and the client fires exactly one unreachable and
    one reconnected transition across the outage."""
    port = _free_port()
    store = GlobalControlStore()
    server = serve_gcs(store, port=port)
    states = []
    client = GcsClient(f"127.0.0.1:{port}", retry_window_s=0.5)
    client.on_head_state(lambda state, outage_s: states.append(state))
    try:
        assert client.kv_put("before", 1)
        server.stop()
        for _ in range(2):  # repeated failures: still ONE transition
            with pytest.raises(HeadUnavailableError) as exc_info:
                client.kv_get("before")
            assert isinstance(exc_info.value, ConnectionError)
        assert client.outage_s() > 0.0

        server = _rebind(store, port)
        deadline = time.monotonic() + 10
        while True:
            try:
                assert client.kv_get("before") == 1
                break
            except HeadUnavailableError:
                assert time.monotonic() < deadline
        assert client.outage_s() == 0.0
        assert states == ["unreachable", "reconnected"]
    finally:
        client.close()
        server.stop()


def test_subscribe_poll_loop_survives_head_outage():
    """The long-poll subscription rides through a head restart: the thread
    stays alive, backs off, and resumes from the SAME cursor, so nothing
    published meanwhile is dropped."""
    port = _free_port()
    store = GlobalControlStore()
    server = serve_gcs(store, port=port)
    got = []
    stop = threading.Event()
    sub = GcsClient(f"127.0.0.1:{port}", retry_window_s=0.3)
    thread = threading.Thread(target=sub.subscribe_poll_loop, args=("drill", got.append),
                              kwargs={"period_s": 0.05, "stop_event": stop}, daemon=True)
    thread.start()
    try:
        store.pubsub.publish("drill", "m1")
        _wait_until(lambda: "m1" in got)
        server.stop()
        time.sleep(1.0)  # several failed polls' worth of outage
        assert thread.is_alive(), "poll loop died during the outage"
        store.pubsub.publish("drill", "m2")  # published while cut off
        server = _rebind(store, port)
        store.pubsub.publish("drill", "m3")
        _wait_until(lambda: "m3" in got)
        assert got == ["m1", "m2", "m3"]
        assert thread.is_alive()
    finally:
        stop.set()
        thread.join(timeout=5)
        sub.close()
        server.stop()


def test_router_grace_window_keeps_cached_replicas(monkeypatch):
    """During a head outage the controller computes EMPTY membership
    (blindness, not replica death): inside the grace window the router
    keeps serving on cached handles and counts the degraded dispatch;
    past it the empty set is believed."""
    from ray_tpu_torch.serve import router as router_mod
    from ray_tpu_torch.util.metrics import registry

    class _FakeActorId:
        def __init__(self, h):
            self._h = h

        def hex(self):
            return self._h

    class _FakeReplica:
        def __init__(self, h):
            self._actor_id = _FakeActorId(h)

    def degraded():
        c = registry().get("raytpu_serve_degraded_dispatch_total")
        return 0.0 if c is None else sum(v for _, v in c.collect())

    rset = router_mod.ReplicaSet("drill-deploy")
    r1 = _FakeReplica("aa" * 16)
    rset.set_replicas([r1])
    before = degraded()

    monkeypatch.setattr(router_mod, "_head_outage_s", lambda: 5.0)
    rset.set_replicas([])
    assert rset.pick() is r1
    assert degraded() == before + 1

    monkeypatch.setattr(router_mod, "_head_outage_s",
                        lambda: float(cfg.head_outage_grace_s) + 1.0)
    rset.set_replicas([])
    assert rset.replicas() == []


# --------------------------------------------------------------------------
# the head's restore, in this process and across processes
# --------------------------------------------------------------------------


def test_restore_requires_a_snapshot_or_wal(tmp_path, capsys):
    """`--restore` with nothing at the snapshot path is refused with JAX's
    message before anything starts."""
    from ray_tpu_torch.cli import main

    path = str(tmp_path / "none.snap")
    try:
        assert main(["start", "--head", "--snapshot-path", path, "--restore"]) == 2
    finally:
        cfg.reset()
    assert f"--restore: no snapshot or WAL at {path!r}" in capsys.readouterr().err


def test_reconcile_purges_a_restored_node_that_never_returns(tmp_path):
    """A head restored from its snapshot bumps the epoch, waits its grace
    window, then purges a restored node that never re-announced: its node
    entry, the named actor it hosted (the name is released) and the
    placement group it owned (FAILED), while its own entry stays."""
    from ray_tpu_torch.core.cluster import ACTOR_NS, NODE_NS
    from ray_tpu_torch.core.gcs_service import PG_NS

    snap = str(tmp_path / "gcs.snap")
    ghost = "ab" * 12
    cfg.set(gcs_snapshot_path=snap, gcs_snapshot_interval_s=30.0, head_reconcile_grace_s=0.5)
    try:
        rt = ray_tpu_torch.init(num_cpus=1, head=True, detect_accelerators=False)
        rt.gcs.kv.put(ghost, {"node_id": ghost, "address": "127.0.0.1:1"}, namespace=NODE_NS)
        rt.gcs.kv.put("drill/ghost", {"node_hex": ghost, "actor_hex": "00" * 16},
                      namespace=ACTOR_NS)
        rt.gcs.register_named_actor("ghost", object(), namespace="drill")
        rt.gcs.kv.put("ff" * 16, {"owner": ghost, "state": "RESERVED"}, namespace=PG_NS)
        epoch0 = rt.gcs.current_epoch()
        ray_tpu_torch.shutdown()  # the final snapshot

        rt = ray_tpu_torch.init(num_cpus=1, head=True, detect_accelerators=False)
        assert rt.gcs.current_epoch() == epoch0 + 1
        assert ghost in rt._restored_nodes
        _wait_until(lambda: rt._reconcile_state.get("phase") == "done", timeout=20)
        assert rt._reconcile_state["nodes_purged"] == 1
        assert rt._reconcile_state["actors_purged"] == 1
        assert rt._reconcile_state["pgs_failed"] == 1
        assert rt.gcs.kv.get(ghost, namespace=NODE_NS) is None
        assert rt.gcs.kv.get("drill/ghost", namespace=ACTOR_NS) is None
        assert "ghost" not in rt.gcs.list_named_actors("drill")
        pg = rt.gcs.kv.get("ff" * 16, namespace=PG_NS)
        assert pg["state"] == "FAILED" and "head outage" in pg["failure_reason"]
        me = rt.cluster.node_id.hex()
        assert rt.gcs.kv.get(me, namespace=NODE_NS) is not None
        from ray_tpu_torch.util import state

        summary = state.head_summary()
        assert summary["epoch"] == epoch0 + 1 and summary["wal"]["last_seq"] > 0
        assert summary["reconcile"]["nodes_purged"] == 1
    finally:
        ray_tpu_torch.shutdown()
        cfg.reset()


def test_head_restart_restores_surviving_agent(tmp_path, no_children_left):
    """SIGKILL the head; the agent keeps running; `--restore` on the same
    port brings the head back with the agent's node re-registered, the
    same agent process serving work."""
    snap = str(tmp_path / "gcs.snap")
    port = _free_port()
    address = f"127.0.0.1:{port}"
    head_log = str(tmp_path / "head.log")
    agent_log = str(tmp_path / "agent.log")
    head = _spawn(_head_cmd(port, snap), head_log)
    agent = None
    try:
        _wait_line(head_log, "head up", proc=head)
        agent = _spawn(_agent_cmd(address, 2, '{"pet": 3}'), agent_log)
        _wait_line(agent_log, "joined", proc=agent)
        assert _observe(address, "pet", 3) == agent.pid

        time.sleep(1.5)  # a snapshot interval or three: the node table persists
        head.send_signal(signal.SIGKILL)
        head.wait(timeout=30)
        time.sleep(1.0)
        assert agent.poll() is None, "the agent must survive the head's death"

        head2_log = str(tmp_path / "head2.log")  # a log of its own: wait for ITS line
        head = _spawn(_head_cmd(port, snap) + ["--restore"], head2_log)
        _wait_line(head2_log, "head up", proc=head)
        assert _observe(address, "pet", 3) == agent.pid
        client = GcsClient(address, retry_window_s=10.0)
        assert client.head_info()["epoch"] == 1
        client.close()
    finally:
        _terminate(head, agent)


@pytest.mark.slow
def test_head_restart_reconciles_lost_state(tmp_path, no_children_left):
    """The restore brings back a node that died DURING the outage and the
    actor and placement-group records it owned; after the grace window the
    head purges the node, releases its actor record and fails its group,
    WITHOUT touching the survivor, whose process never restarts."""
    snap = str(tmp_path / "gcs.snap")
    port = _free_port()
    address = f"127.0.0.1:{port}"
    env = {**_ENV, "RAY_TPU_HEAD_RECONCILE_GRACE_S": "3"}
    head_log = str(tmp_path / "head.log")
    head = _spawn(_head_cmd(port, snap), head_log, env=env)
    survivor = doomed = None
    try:
        _wait_line(head_log, "head up", proc=head)
        survivor_log = str(tmp_path / "survivor.log")
        doomed_log = str(tmp_path / "doomed.log")
        survivor = _spawn(_agent_cmd(address, 1, '{"pet": 1}'), survivor_log, env=env)
        doomed = _spawn(_agent_cmd(address, 1, '{"gone": 1}'), doomed_log, env=env)
        _wait_line(survivor_log, "joined", proc=survivor)
        _wait_line(doomed_log, "joined", proc=doomed)

        client = GcsClient(address, retry_window_s=5.0)
        nodes = {h: client.kv_get(h, namespace="_nodes")
                 for h in client.kv_keys("*", namespace="_nodes")}
        doomed_hex = next(h for h, info in nodes.items()
                          if info and info.get("resources", {}).get("gone"))
        survivor_hex = next(h for h, info in nodes.items()
                            if info and info.get("resources", {}).get("pet"))
        client.kv_put("drill/ghost", {"node_hex": doomed_hex, "actor_hex": "00" * 16},
                      namespace="_cluster_actors")
        client.kv_put("ff" * 16, {"owner": doomed_hex, "state": "READY"}, namespace="_pgs")
        client.close()
        time.sleep(1.5)  # a snapshot / WAL interval persists it all

        # the node and the head die together (a rack's loss)
        doomed.send_signal(signal.SIGKILL)
        head.send_signal(signal.SIGKILL)
        doomed.wait(timeout=30)
        head.wait(timeout=30)

        head2_log = str(tmp_path / "head2.log")
        head = _spawn(_head_cmd(port, snap) + ["--restore"], head2_log, env=env)
        _wait_line(head2_log, "head up", proc=head)
        client = GcsClient(address, retry_window_s=10.0)
        _wait_until(lambda: client.kv_get(doomed_hex, namespace="_nodes") is None, timeout=30)
        _wait_until(lambda: client.kv_get("drill/ghost", namespace="_cluster_actors") is None,
                    timeout=30)
        _wait_until(lambda: (client.kv_get("ff" * 16, namespace="_pgs") or {}).get("state")
                    == "FAILED", timeout=30)
        info = client.kv_get(survivor_hex, namespace="_nodes")
        assert info and info["pid"] == survivor.pid
        assert survivor.poll() is None
        client.close()
    finally:
        _terminate(head, survivor, doomed)


@pytest.mark.slow
def test_kill_head_chaos_drill(tmp_path, no_children_left):
    """Chaos SIGKILLs the head from its own snapshot loop while a writer
    keeps committing KV state and an agent keeps heartbeating. After
    `--restore` on the same port: every ACKNOWLEDGED write is readable,
    the writer saw no error (its retry window spans the outage), a writer
    from before the restart is fenced by epoch, and the agent
    re-registers without a restart."""
    snap = str(tmp_path / "gcs.snap")
    port = _free_port()
    address = f"127.0.0.1:{port}"
    head_log = str(tmp_path / "head.log")
    agent_log = str(tmp_path / "agent.log")
    chaos_env = {**_ENV, "RAY_TPU_CHAOS": "kill_head=1,delay_s=4.0,max_injections=1"}
    head = _spawn(_head_cmd(port, snap), head_log, env=chaos_env)
    agent = None
    acked, errors = [], []
    stop_writer = threading.Event()

    def writer():
        c = GcsClient(address, retry_window_s=60.0)
        c.adopt_epoch()
        i = 0
        while not stop_writer.is_set():
            try:
                if c.kv_put(f"w{i}", {"i": i}, namespace="drill"):
                    acked.append(i)
            except Exception as exc:  # noqa: BLE001 - the drill's verdict
                errors.append(exc)
            i += 1
            time.sleep(0.05)
        c.close()

    writer_thread = threading.Thread(target=writer, daemon=True)
    try:
        _wait_line(head_log, "head up", proc=head)
        agent = _spawn(_agent_cmd(address, 1, '{"pet": 1}'), agent_log)
        _wait_line(agent_log, "joined", proc=agent)
        zombie = GcsClient(address, retry_window_s=30.0)
        pre_epoch = zombie.adopt_epoch()
        zombie.pin_epoch(pre_epoch)
        writer_thread.start()

        head.wait(timeout=60)
        assert head.returncode == 137, f"the head should die by chaos (137), got {head.returncode}"
        t_dead = time.monotonic()
        acked_at_death = len(acked)
        assert agent.poll() is None, "the agent must survive the head's death"

        head2_log = str(tmp_path / "head2.log")
        head = _spawn(_head_cmd(port, snap) + ["--restore"], head2_log)
        _wait_line(head2_log, "head up", proc=head)
        probe = GcsClient(address, retry_window_s=30.0)
        _wait_until(lambda: probe.kv_get("w0", namespace="drill") is not None, timeout=30)
        recovery_s = time.monotonic() - t_dead
        _wait_until(lambda: len(acked) > acked_at_death + 5, timeout=30)
        stop_writer.set()
        writer_thread.join(timeout=10)

        assert not errors, f"the writer surfaced errors during the drill: {errors}"
        missing = [i for i in acked if probe.kv_get(f"w{i}", namespace="drill") is None]
        assert not missing, f"acknowledged writes lost: {missing[:10]}"
        assert probe.head_info()["epoch"] > pre_epoch
        with pytest.raises(StaleEpochError):
            zombie.kv_put("zombie-write", 1, namespace="drill")
        assert _observe(address, "pet", 1) == agent.pid
        assert recovery_s < 30, f"recovery took {recovery_s:.1f}s"
        probe.close()
        zombie.close()
    finally:
        stop_writer.set()
        _terminate(head, agent)
