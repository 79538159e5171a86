"""ray_tpu_torch's tenancy plane against ray_tpu's on the CPU.

`serve/tenancy.py`, `serve/context.py`, `core/config.py` and
`core/exceptions.py` are host-only copies in the port; the same sequence
of operations must give the same results in both packages: the fair
queue's pop order, token-bucket refill times (on one fake monotonic
clock), quota checks under the same flags, TTFT windows, the ambient
request context, and the typed errors' pickling.
"""

import pickle
import time

import numpy as np
import pytest

from ray_tpu.core import config as jconfig
from ray_tpu.core import exceptions as jexc
from ray_tpu.serve import context as jcontext
from ray_tpu.serve import tenancy as jtenancy
from ray_tpu_torch.core import config as tconfig
from ray_tpu_torch.core import exceptions as texc
from ray_tpu_torch.serve import context as tcontext
from ray_tpu_torch.serve import tenancy as ttenancy

BOTH = [jtenancy, ttenancy]


@pytest.fixture(autouse=True)
def _clean():
    for m in BOTH:
        m.reset()
    yield
    for m in BOTH:
        m.reset()
    jconfig.cfg.reset()
    tconfig.cfg.reset()


@pytest.fixture
def fake_clock(monkeypatch):
    """One monotonic clock for both packages' buckets, moved by hand."""
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    return now


# ---------------------------------------------------------------- fair queue


def _fair_sequence(m, seed):
    """A seeded mix of pushes (3 tenants, 2 tiers, weights), pops,
    requeues of popped items, pop_if_head of the head and of a non-head,
    removes and peeks; every observation in order, then the drain."""
    rng = np.random.default_rng(seed)
    m.set_tenant("heavy", weight=3.0)
    m.set_tenant("light", weight=0.5)
    fq = m.FairQueue()
    items = {}
    popped = []
    seen = []
    for step in range(120):
        op = rng.integers(0, 7)
        if op <= 2:
            tenant = ("heavy", "light", "plain")[rng.integers(0, 3)]
            prio = int(rng.integers(0, 2))
            item = (tenant, prio, step)
            items[item] = item
            cost = float(rng.choice([1.0, 2.0]))
            fq.push(item, tenant, prio, cost=cost)
        elif op == 3:
            got = fq.pop()
            seen.append(("pop", got))
            if got is not None:
                popped.append(got)
        elif op == 4 and popped:
            item = popped.pop(int(rng.integers(0, len(popped))))
            fq.requeue(item, item[0], item[1])
            seen.append(("requeue", item))
        elif op == 5:
            head = fq.peek()
            seen.append(("peek", head))
            if head is not None and rng.integers(0, 2):
                seen.append(("pop_if_head", fq.pop_if_head(head)))
            elif items:
                other = list(items)[int(rng.integers(0, len(items)))]
                seen.append(("pop_if_head_other", other, fq.pop_if_head(other)))
        elif op == 6 and items:
            victim = list(items)[int(rng.integers(0, len(items)))]
            seen.append(("remove", victim, fq.remove(victim)))
        seen.append(("len", len(fq)))
    seen.append(("depths", fq.depths()))
    seen.append(("drain", fq.drain()))
    return seen


@pytest.mark.parametrize("seed", range(6))
def test_fair_queue_sequence_matches_jax(seed):
    """The same seeded push / pop / requeue / pop_if_head / remove
    sequence on JAX's FairQueue and the port's: the same pops, peeks,
    lengths, depths and drain order."""
    assert _fair_sequence(jtenancy, seed) == _fair_sequence(ttenancy, seed)


def _tier_and_share_case(m):
    fq = m.FairQueue()
    for i in range(40):
        fq.push(("heavy", i), "heavy", weight=4.0)
    for i in range(40):
        fq.push(("light", i), "light", weight=1.0)
    fq.push(("paid", 0), "paid", priority=1)
    first = [fq.pop()[0] for _ in range(26)]
    return first, first[1:].count("heavy")


def test_fair_queue_tiers_and_weight_share_match_jax():
    """Strict tiers first, then a weight-4 tenant drains ~4x a weight-1
    tenant's rate (JAX's own expectation: 18-22 of 25)."""
    got = [_tier_and_share_case(m) for m in BOTH]
    assert got[0] == got[1]
    first, heavy = got[1]
    assert first[0] == "paid" and 18 <= heavy <= 22


# -------------------------------------------------------------- token bucket


def test_token_bucket_retry_after_matches_jax(fake_clock):
    """Both buckets on one fake clock: the same admissions and refill
    times (JAX's expectation: a third acquire at burst 2 waits 0.5-1 s)."""
    buckets = [m._TokenBucket(rate=1.0, burst=2.0) for m in BOTH]
    seen = [[] for _ in BOTH]
    for dt in (0.0, 0.0, 0.0, 0.25, 0.5, 0.3, 0.0, 2.5, 0.0, 0.0, 0.0):
        fake_clock[0] += dt
        for obs, bucket in zip(seen, buckets):
            obs.append(bucket.acquire())
    assert seen[0] == seen[1]
    assert seen[1][:2] == [None, None] and 0.5 < seen[1][2] <= 1.01


def test_quota_check_registry_and_defaults_match_jax(fake_clock):
    """Declared quotas, the config default (0 = unlimited, then a fleet
    rate set through cfg.set in each package), re-declaration rebuilding
    the bucket: the same answers in both packages."""
    seen = []
    for m, cfg in ((jtenancy, jconfig.cfg), (ttenancy, tconfig.cfg)):
        m.set_tenant("metered", quota_rps=1.0, quota_burst=1.0)
        obs = [m.quota_check("metered"), m.quota_check("metered")]
        obs += [m.quota_check("anyone") for _ in range(5)]
        cfg.set(serve_tenant_quota_rps=2.0)
        obs += [m.quota_check("fleet") for _ in range(6)]
        fake_clock[0] += 0.75
        obs += [m.quota_check("metered"), m.quota_check("fleet")]
        m.set_tenant("metered", quota_rps=0.0)
        obs.append(m.quota_check("metered"))
        obs += [m.weight_of("metered"), m.weight_of("fleet"), m.priority_of("fleet")]
        seen.append(obs)
        fake_clock[0] -= 0.75
    assert seen[0] == seen[1]
    assert seen[1][0] is None and seen[1][1] == pytest.approx(1.0)


def test_tenant_spec_reads_fall_back_to_flags_like_jax(monkeypatch):
    """weight, priority and TTFT objective: declared values, and the flag
    defaults read from the same RAY_TPU_<NAME> environment variables."""
    monkeypatch.setenv("RAY_TPU_SERVE_TENANT_DEFAULT_WEIGHT", "2.5")
    monkeypatch.setenv("RAY_TPU_SERVE_SLO_TTFT_P99_S", "0.4")
    seen = []
    for m in BOTH:
        m.set_tenant("gold", weight=7.0, priority=3, ttft_slo_s=0.05)
        m.set_tenant("gold", priority=4)  # unspecified fields keep their value
        spec = m.spec("gold")
        seen.append([m.weight_of("gold"), m.weight_of("other"), m.priority_of("gold"),
                     m.priority_of("other"), m.ttft_objective("gold"),
                     m.ttft_objective("other"), spec.weight, spec.priority])
    assert seen[0] == seen[1] == [[7.0, 2.5, 4, 0, 0.05, 0.4, 7.0, 4]][0]


@pytest.mark.parametrize("raw,want", [("0", False), ("off", False), ("1", True), ("yes", True)])
def test_lane_preemption_flag_env_override_matches_jax(monkeypatch, raw, want):
    monkeypatch.setenv("RAY_TPU_SERVE_LANE_PREEMPTION", raw)
    assert jconfig.cfg.serve_lane_preemption is tconfig.cfg.serve_lane_preemption is want
    tconfig.cfg.set(serve_lane_preemption=not want)  # set() wins over the environment
    assert tconfig.cfg.serve_lane_preemption is (not want)


def test_config_rejects_unknown_and_mistyped_flags():
    with pytest.raises(AttributeError, match="no such flag"):
        tconfig.cfg.serve_tenant_header  # a JAX flag this slice does not read
    with pytest.raises(ValueError, match="unknown config flag"):
        tconfig.cfg.set(nope=1)
    with pytest.raises(ValueError, match="expects float"):
        tconfig.cfg.set(serve_tenant_quota_rps="fast")
    # every flag the port defines is JAX's, with JAX's default and type
    for name, flag in tconfig._REGISTRY.items():
        jflag = jconfig._REGISTRY[name]
        assert (flag.default, flag.type, flag.env_var) == (jflag.default, jflag.type, jflag.env_var)


# ------------------------------------------------------------- typed errors


def test_backpressure_error_pickles_retry_after_like_jax():
    for exc in (jexc, texc):
        err = exc.BackPressureError("over quota", retry_after_s=2.5)
        clone = pickle.loads(pickle.dumps(err))
        assert isinstance(clone, exc.BackPressureError) and isinstance(clone, exc.RayTpuError)
        assert clone.retry_after_s == 2.5 and "over quota" in str(clone)
        bare = pickle.loads(pickle.dumps(exc.BackPressureError()))
        assert bare.retry_after_s is None
        assert issubclass(exc.RequestTimeoutError, TimeoutError)


# ---------------------------------------------------------------- windows


def test_ttft_windows_match_jax():
    """observe / drain of the TTFT, breakdown and queue-wait windows."""
    seen = []
    for m in BOTH:
        m.observe_ttft("gold", 0.5)
        m.observe_ttft("gold", 0.7)
        m.observe_ttft("casual", 0.2)
        m.observe_ttft_breakdown("gold", {"ttft_s": 0.5, "queue_wait_s": 0.1,
                                          "preempt_wait_s": 0.0, "prefill_compute_s": 0.4})
        m.observe_ttft_breakdown("casual", {"ttft_s": 0.2})
        obs = [m.drain_ttft_window(), m.drain_ttft_breakdown(), m.drain_queue_wait_window()]
        obs += [m.drain_ttft_window(), m.drain_ttft_breakdown(), m.drain_queue_wait_window()]
        seen.append(obs)
    assert seen[0] == seen[1]
    assert seen[1][0] == {"gold": [0.5, 0.7], "casual": [0.2]}
    assert seen[1][2] == {"gold": [0.1], "casual": [0.0]}
    assert seen[1][3:] == [{}, {}, {}]


def test_shed_and_request_counts_are_plain_values():
    ttenancy.count_request("a")
    ttenancy.count_request("a")
    ttenancy.count_shed("a", 1.5)
    ttenancy.count_shed("b")
    assert ttenancy.request_counts() == {"a": 2}
    assert ttenancy.shed_counts() == {"a": 1, "b": 1}
    ttenancy.reset()
    assert ttenancy.request_counts() == {} == ttenancy.shed_counts()


# ----------------------------------------------------------------- context


def test_request_context_round_trips_like_jax():
    """Set, read and reset the ambient deadline, tenant/priority and id."""
    seen = []
    for c in (jcontext, tcontext):
        obs = [c.get_request_deadline(), c.remaining_s(), c.get_request_tenant(),
               c.get_request_priority(), c.get_request_id()]
        tokens = (c._set_request_deadline(time.time() + 100.0),
                  c._set_request_tenant("acme", 2), c._set_request_id("req-1"))
        obs += [c.remaining_s() > 99.0, c.get_request_tenant(), c.get_request_priority(),
                c.get_request_id()]
        c._reset_request_deadline(tokens[0])
        c._reset_request_tenant(tokens[1])
        c._reset_request_id(tokens[2])
        obs += [c.get_request_deadline(), c.get_request_tenant(), c.get_request_id()]
        expired = c._set_request_deadline(time.time() - 5.0)
        obs.append(c.remaining_s())
        c._reset_request_deadline(expired)
        seen.append(obs)
    assert seen[0] == seen[1]
    assert seen[1] == [None, None, None, None, None, True, "acme", 2, "req-1", None, None, None, 0.0]
