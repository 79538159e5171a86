"""The traffic generators: one seed gives one schedule; the clips hold;
seeds differ in order and ids but not in the work they send; an open-loop
request is timed from its due time; a sender that falls behind says how
late it ran."""

import threading
import time
import types

import numpy as np

from benchmark.harness import readers
from benchmark.harness import traffic as t
from benchmark.harness.serve import Record, Serving

CHAT = {"kind": "open_loop", "rate_per_s": 5.0,
        "prompt": {"dist": "lognormal", "median": 1024, "sigma": 0.8, "min": 64, "max": 3072},
        "output": {"dist": "lognormal", "median": 192, "sigma": 0.7, "min": 16, "max": 1024}}
AGENT = {"kind": "open_loop", "rate_per_s": 6.0,
         "prefixes": {"count": 8, "tokens": 2048, "zipf_s": 1.1},
         "user_turn": {"dist": "uniform", "min": 64, "max": 512},
         "output": {"dist": "uniform", "min": 64, "max": 256}}
BACKLOG = {"kind": "backlog", "depth_slots": 2, "block": 64,
           "prompt": {"dist": "uniform", "min": 512, "max": 2048},
           "output": {"dist": "uniform", "min": 256, "max": 512}}
TRAIN = {"kind": "train_batches", "batch": 4, "seq": 64, "eot_id": 99,
         "doc": {"dist": "lognormal", "median": 30, "sigma": 1.0, "min": 4, "max": 200}}
BIG = 2**31 + 12345  # the driver's seeds pass 32 signed bits


def _key(reqs):
    return [(r.due, r.prompt, r.max_tokens, r.prefix_id) for r in reqs]


def test_same_seed_same_schedule_and_another_seed_another_order():
    a, b = t.open_loop(CHAT, BIG, 30, 32768), t.open_loop(CHAT, BIG, 30, 32768)
    assert _key(a) == _key(b)
    c = t.open_loop(CHAT, BIG + 1, 30, 32768)
    assert _key(a) != _key(c)
    # the same work in another order: the same lengths and gaps
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in c)
    assert sorted(r.max_tokens for r in a) == sorted(r.max_tokens for r in c)
    gaps = lambda rs: sorted(np.round(np.diff([r.due for r in rs] + [30.0]), 9))  # noqa: E731
    assert gaps(a) == gaps(c)


def test_open_loop_clips_and_window():
    reqs = t.open_loop(CHAT, 7, 40, 32768)
    assert len(reqs) == 200
    assert all(64 <= len(r.prompt) <= 3072 and 16 <= r.max_tokens <= 1024 for r in reqs)
    assert all(0 <= r.due < 40 for r in reqs) and reqs[0].due == 0.0
    assert all(0 <= i < 32768 for r in reqs for i in r.prompt)
    assert abs(np.median([len(r.prompt) for r in reqs]) - 1024) < 40


def test_shared_prefixes_are_page_aligned_and_zipf():
    reqs = t.open_loop(AGENT, 3, 40, 32768)
    assert all(r.prompt[:2048] == reqs[0].prompt[:2048] for r in reqs
               if r.prefix_id == reqs[0].prefix_id)
    counts = np.bincount([r.prefix_id for r in reqs], minlength=8)
    assert list(counts) == sorted(counts, reverse=True) and counts[0] > 2 * counts[7] > 0
    assert all(2048 + 64 <= len(r.prompt) <= 2048 + 512 for r in reqs)
    assert t.max_request_tokens(AGENT) == 2048 + 512 + 256


def test_backlog_stream():
    a, b = t.Backlog(BACKLOG, BIG, 32768), t.Backlog(BACKLOG, BIG, 32768)
    ra, rb = [a.next() for _ in range(100)], [b.next() for _ in range(100)]
    assert _key(ra) == _key(rb) and [r.index for r in ra] == list(range(100))
    assert all(512 <= len(r.prompt) <= 2048 and 256 <= r.max_tokens <= 512 for r in ra)
    c = [t.Backlog(BACKLOG, 5, 32768).next() for _ in range(1)]
    assert c[0].prompt != ra[0].prompt


def test_packed_batches():
    a, b = t.PackedBatches(TRAIN, BIG, 100), t.PackedBatches(TRAIN, BIG, 100)
    x, y = a.next(), b.next()
    assert x.shape == (4, 65) and (x == y).all()
    assert (x == 99).any() and x.min() >= 0 and x.max() < 100
    # documents run on across batches; no row repeats
    rows = np.concatenate([a.next() for _ in range(20)])
    assert len({r.tobytes() for r in rows}) == len(rows)
    lengths = t.quantiles(TRAIN["doc"], 1000)
    assert lengths.min() >= 4 and lengths.max() <= 200 and abs(np.median(lengths) - 30) <= 1


class _SlowEngine:
    """submit() takes 50 ms, as an engine under a lock might; streams end at once."""

    def submit(self, prompt, max_tokens, temperature):
        time.sleep(0.05)
        return _Stream(max_tokens)


class _Stream:
    cached_tokens = 0

    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield i


def _serving(engine):
    s = Serving.__new__(Serving)
    s.engine, s.records, s.late_s, s._threads, s._streams = engine, [], [], [], {}
    s._lock = threading.Lock()
    return s


def test_a_sender_that_falls_behind_reports_how_late_it_ran():
    s = _serving(_SlowEngine())
    schedule = [t.Request(i, [1, 2], 3, due=0.0) for i in range(5)]  # all due at once
    t0 = time.perf_counter()
    s.open_loop(schedule, t0).join(timeout=10)
    s.wait_all(time.perf_counter() + 5)
    assert len(s.late_s) == 5 and s.late_s[0] < 0.04 and s.late_s[-1] >= 0.19
    assert all(r.ok for r in s.records)


def test_an_open_loop_request_is_timed_from_its_due_time():
    rec = Record(0, [1], 4, due=10.0, sent=10.5, first=11.0, last=12.5,
                 times=[11.0, 11.5, 12.0, 12.5], tokens=[1, 2, 3, 4], done=True)
    run = types.SimpleNamespace(t0=9.0, t1=20.0)
    assert readers.ttft_s(run, rec) == 1.0  # from the due time, not the send
    assert readers.tpot_ms(rec) == 500.0
    failed = Record(1, [1], 4, due=10.0, sent=10.0, error="boom", done=True)
    assert readers.ttft_s(run, failed) == float("inf")
