"""ray_tpu_torch's Serve deployment path against ray_tpu's on the CPU.

Both packages' runtimes run side by side in this process
(`init(num_cpus=4, detect_accelerators=False)`), each with its own serve
controller, and every test drives both the same way: deployments through
`serve.run` / handles / `status` / `delete`, the two-replica choice,
recovery after a replica is killed, the HTTP proxy, autoscaling up, the
router's request-log marks; then `build_llm_app("gpt2-tiny")` with the
paged engine and the dense default on the same weights (JAX's init,
carried over with `params_from_numpy`, f32, the port on `device="cpu"`),
whose greedy tokens and usage must be equal (exactly: greedy argmax over
f32 logits), and `serve_openai` in both packages, whose response bodies
must be equal once ids and timestamps are stripped.

Waits are bounded by timeouts and decided by events, never by
wall-clock thresholds; the module fixture shuts serve and both runtimes
down, and the port's shutdown joins its threads.
"""

import json
import threading
import time
import urllib.error
import urllib.request
import uuid

import jax
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import models as jmodels
from ray_tpu import serve as jserve
from ray_tpu.serve import reqlog as jreqlog
from ray_tpu.serve.llm import build_llm_app as jbuild_llm_app
from ray_tpu.serve.llm import serve_openai as jserve_openai
from ray_tpu_torch import models as tmodels
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.core import runtime as truntime
from ray_tpu_torch.serve import reqlog as treqlog
from ray_tpu_torch.serve.llm import build_llm_app as tbuild_llm_app
from ray_tpu_torch.serve.llm import serve_openai as tserve_openai

TIMEOUT = 60
SIDES = {
    "jax": dict(rt=ray_tpu, serve=jserve, reqlog=jreqlog),
    "torch": dict(rt=ray_tpu_torch, serve=tserve, reqlog=treqlog),
}


class Echo:
    def __init__(self, tag):
        self.tag = tag
        self.me = uuid.uuid4().hex  # unlike id(), never reused by a later instance

    def __call__(self, payload):
        return {"tag": self.tag, "payload": payload}

    def who(self, _=None):
        return self.me

    def hold(self, gate):
        gate.wait(TIMEOUT)
        return self.me

    def gen(self, payload):
        for i in range(int(payload["n"])):
            yield {"i": i}


@pytest.fixture(scope="module")
def sides():
    for side in SIDES.values():
        side["rt"].init(num_cpus=4, detect_accelerators=False)
    yield SIDES
    for side in SIDES.values():
        side["serve"].shutdown()
        side["rt"].shutdown()
    assert not truntime.is_initialized()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith(("ray_tpu_torch", "serve-", "openai-http"))
            and t.is_alive()]
    # the JAX package leaves its own serve threads behind; the port's
    # names are the ray_tpu_torch-* ones (the serve-* names are shared)
    assert not [n for n in left if n.startswith("ray_tpu_torch")], left


def _each(sides, fn):
    """{side: fn(side dict)} for both packages."""
    return {name: fn(side) for name, side in sides.items()}


def _wait_until(pred, what, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _status(side, name):
    st = side["serve"].status()[name]
    return {k: st[k] for k in ("target_replicas", "live_replicas", "draining_replicas", "ongoing")}


def _deploy_echo(side, name, **options):
    dep = side["serve"].deployment(Echo, name=name)
    if options:
        dep = dep.options(**options)
    return side["serve"].run(dep.bind(name))


# -------------------------------------------------------------- deployments


def test_deploy_call_get_handle_status_delete(sides):
    def program(side):
        rt, serve = side["rt"], side["serve"]
        h = _deploy_echo(side, "echo")
        out = [rt.get(h.remote(i), timeout=TIMEOUT) for i in range(3)]
        again = rt.get(serve.get_handle("echo").remote("x"), timeout=TIMEOUT)
        status = _status(side, "echo")
        serve.delete("echo")
        try:
            serve.get_handle("echo")
            gone = None
        except KeyError:
            gone = "KeyError"
        return out, again, status, gone, "echo" in serve.status()

    out = _each(sides, program)
    assert out["jax"] == out["torch"]
    assert out["torch"][2] == {"target_replicas": 1, "live_replicas": 1,
                               "draining_replicas": 0, "ongoing": 0}


def test_two_replicas_less_loaded_choice(sides):
    """With one replica busy, the power-of-two choice sends the next calls
    to the other one: both replicas serve."""
    def program(side):
        rt, serve = side["rt"], side["serve"]
        h = _deploy_echo(side, "pair", num_replicas=2)
        _wait_until(lambda: len(h._set.replicas()) == 2, "two replicas")
        gate = threading.Event()
        busy = h.hold.remote(gate)
        _wait_until(lambda: h._set.total_ongoing() == 1, "the held call")
        others = {rt.get(h.who.remote(), timeout=TIMEOUT) for _ in range(3)}
        gate.set()
        held = rt.get(busy, timeout=TIMEOUT)
        status = _status(side, "pair")
        serve.delete("pair")
        return len(others), held in others, status["live_replicas"]

    out = _each(sides, program)
    assert out["jax"] == out["torch"] == (1, False, 2)


def test_replica_recovery_after_kill(sides):
    def program(side):
        rt, serve = side["rt"], side["serve"]
        h = _deploy_echo(side, "phoenix", health_check_period_s=0.05)
        first = rt.get(h.who.remote(), timeout=TIMEOUT)
        (replica,) = h._set.replicas()
        rt.kill(replica)
        _wait_until(lambda: h._set.replicas() and h._set.replicas()[0] is not replica,
                    "a new replica")
        second = rt.get(h.who.remote(), timeout=TIMEOUT)
        status = _status(side, "phoenix")
        serve.delete("phoenix")
        return first != second, status["live_replicas"]

    out = _each(sides, program)
    assert out["jax"] == out["torch"] == (True, 1)


def test_replica_constructor_failure(sides):
    """A replica whose constructor raises (as LLMServer does on the card
    path without a card): run returns, calls fail with the death, which
    names the constructor's error."""
    class Broken:
        def __init__(self):
            raise RuntimeError("no CUDA device is available")

        def __call__(self, x):
            return x

    def program(side):
        rt, serve = side["rt"], side["serve"]
        h = serve.run(serve.deployment(Broken, name="broken").bind())
        try:
            rt.get(h.remote(1), timeout=TIMEOUT)
            err = None
        except Exception as exc:  # noqa: BLE001 - compared by type
            err = (type(exc).__name__, "no CUDA device" in str(exc))
        st = serve.status()["broken"]
        serve.delete("broken")
        return err, st["target_replicas"]

    out = _each(sides, program)
    assert out["jax"] == out["torch"] == (("ActorDiedError", True), 1)


def test_port_status_names_the_last_replica_death(sides):
    class Broken:
        def __init__(self):
            raise RuntimeError("no CUDA device is available")

    serve = sides["torch"]["serve"]
    serve.run(serve.deployment(Broken, name="broken2").options(health_check_period_s=0.05).bind())
    _wait_until(lambda: serve.status()["broken2"]["last_replica_death"], "a pruned replica")
    death = serve.status()["broken2"]["last_replica_death"]
    serve.delete("broken2")
    assert "__init__ raised: no CUDA device is available" in death


def test_http_proxy(sides):
    def program(side):
        serve = side["serve"]
        _deploy_echo(side, "web")
        port = serve.start_http()

        def post(path, payload):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
                    return r.status, r.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, e.read().decode()

        code, body = post("/web", {"a": 1})
        plain = (code, {k: v for k, v in json.loads(body).items() if k != "request_id"})
        code, body = post("/web/gen?stream=1", {"n": 3})
        streamed = (code, [json.loads(line) for line in body.splitlines() if line])
        code, body = post("/nowhere", {})
        missing = (code, json.loads(body)["error"].startswith("not found"))
        serve.delete("web")
        return plain, streamed, missing

    out = _each(sides, program)
    assert out["jax"] == out["torch"]
    assert out["torch"][0] == (200, {"result": {"tag": "web", "payload": {"a": 1}}})
    assert out["torch"][1] == (200, [{"result": {"i": i}} for i in range(3)])
    assert out["torch"][2] == (404, True)


def test_autoscaling_up(sides):
    def program(side):
        rt, serve = side["rt"], side["serve"]
        auto = serve.AutoscalingConfig(min_replicas=1, max_replicas=3,
                                       target_ongoing_requests=1, interval_s=0.05)
        h = _deploy_echo(side, "grow", autoscaling=auto)
        gate = threading.Event()
        held = [h.hold.remote(gate) for _ in range(3)]
        _wait_until(lambda: serve.status()["grow"]["target_replicas"] == 3, "scale-up")
        _wait_until(lambda: serve.status()["grow"]["live_replicas"] == 3, "three replicas")
        gate.set()
        rt.get(held, timeout=TIMEOUT)
        status = _status(side, "grow")
        serve.delete("grow")
        return status["target_replicas"], status["live_replicas"]

    out = _each(sides, program)
    assert out["jax"] == out["torch"] == (3, 3)


def test_router_reqlog_route_marks(sides):
    def program(side):
        rt, serve, reqlog = side["rt"], side["serve"], side["reqlog"]
        h = _deploy_echo(side, "marks")
        rt.get(h.options(request_id="rid-marks").remote(1), timeout=TIMEOUT)
        marks = reqlog.log().timeline("rid-marks")
        serve.delete("marks")
        return [(m["phase"], sorted((m.get("attrs") or {}).keys())) for m in marks]

    out = _each(sides, program)
    assert out["jax"] == out["torch"]
    assert [p for p, _ in out["torch"]] == ["route.received", "route.dispatched"]
    # the derived views of one fixed timeline
    marks = [
        {"seq": 1, "rid": "r", "phase": "route.received", "ts": 5.0, "mono": 1.0,
         "node": "n1", "tenant": "acme", "attrs": {"deployment": "llm"}},
        {"seq": 2, "rid": "r", "phase": "engine.first_token", "ts": 5.25, "mono": 1.25,
         "node": "n1", "attrs": {"ttft_s": 0.25, "queue_wait_s": 0.05,
                                 "prefill_compute_s": 0.2, "preempt_wait_s": 0.0}},
        {"seq": 3, "rid": "r", "phase": "route.timeout", "ts": 6.0, "mono": 2.0, "node": "n1"},
    ]
    for fn in ("render_waterfall", "summarize_marks", "decompose"):
        assert getattr(treqlog, fn)(marks) == getattr(jreqlog, fn)(marks), fn


def test_http_tenant_resolution_matches_jax(sides):
    from ray_tpu.serve import tenancy as jtenancy
    from ray_tpu_torch.serve import tenancy as ttenancy

    cases = [{}, {"x-tenant": "t1"}, {"x-tenant": "t1", "x-priority": "3"},
             {"Authorization": "Bearer key-1"}, {"Authorization": "Bearer nope"},
             {"x-priority": "bad"}]
    out = {}
    for name, ten in (("jax", jtenancy), ("torch", ttenancy)):
        ten.set_tenant("acme", priority=2, api_key="key-1")
        try:
            out[name] = [ten.resolve_http_tenant(h) for h in cases]
        finally:
            ten.reset()
    assert out["jax"] == out["torch"]
    assert out["torch"][3] == ("acme", 2)


# ---------------------------------------------------------------- LLM apps


@pytest.fixture(scope="module")
def llm(sides):
    """gpt2-tiny through `serve_openai` in both packages (the JAX side's
    weights are its init at PRNGKey(0)); the port's deployment is then
    redeployed under the same name with those weights carried over, and a
    dense `build_llm_app` deployment added on each side."""
    jconfig = jmodels.get_config("gpt2-tiny")
    jparams = jmodels.init_params(jconfig, jax.random.PRNGKey(0))
    tparams = tmodels.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tmodels.get_config("gpt2-tiny"), device="cpu")
    jfront = jserve_openai(model="gpt2-tiny", paged=True, max_slots=4)
    tfront = tserve_openai(model="gpt2-tiny", paged=True, max_slots=4, device="cpu")
    tserve.run(tbuild_llm_app("gpt2-tiny", params=tparams, paged=True, max_slots=4,
                              device="cpu"), name="openai-gpt2-tiny")
    jserve.run(jbuild_llm_app("gpt2-tiny", params=jparams, max_slots=4, name="llm-dense"))
    tserve.run(tbuild_llm_app("gpt2-tiny", params=tparams, max_slots=4, name="llm-dense",
                              device="cpu"))
    yield {"jax": f"http://127.0.0.1:{jfront.port}", "torch": f"http://127.0.0.1:{tfront.port}"}
    jfront.stop()
    tfront.stop()
    for side in sides.values():
        side["serve"].delete("openai-gpt2-tiny")
        side["serve"].delete("llm-dense")


PROMPTS = [[5, 9, 200, 17], list(range(40, 75)), [255] * 11]


@pytest.mark.parametrize("name", ["openai-gpt2-tiny", "llm-dense"])
def test_llm_generate_and_stream_match_jax(sides, llm, name):
    def program(side):
        rt, serve = side["rt"], side["serve"]
        h = serve.get_handle(name)
        outs, streams = [], []
        for p in PROMPTS:
            payload = {"prompt_tokens": p, "max_tokens": 8, "temperature": 0.0}
            r = rt.get(h.generate.remote(payload), timeout=TIMEOUT)
            outs.append((r["tokens"], r["usage"]))
            items = [rt.get(ref, timeout=TIMEOUT)
                     for ref in h.options(stream=True).stream_generate.remote(payload)]
            streams.append(([it["token"] for it in items if "token" in it], items[-1]["usage"],
                            items[-1]["done"]))
        return outs, streams

    out = _each(sides, program)
    assert out["jax"] == out["torch"]
    for (tokens, usage), (s_tokens, s_usage, done) in zip(*out["torch"]):
        assert len(tokens) == 8 and tokens == s_tokens and usage == s_usage and done


def _post(url, payload, raw=None):
    req = urllib.request.Request(url, data=raw if raw is not None else json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def _volatile(key, value):
    """Fields that differ between any two responses: completion ids,
    timestamps, request ids."""
    if key in ("created", "request_id"):
        return True
    return key == "id" and isinstance(value, str) and value.startswith(("cmpl-", "chatcmpl-"))


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if not _volatile(k, v)}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _body(status_type_body):
    code, ctype, body = status_type_body
    if ctype and ctype.startswith("text/event-stream"):
        frames = [line[len("data: "):] for line in body.split("\n") if line.startswith("data: ")]
        return code, [f if f == "[DONE]" else _strip(json.loads(f)) for f in frames]
    return code, _strip(json.loads(body))


OPENAI_CASES = {
    "completions_text": ("/v1/completions", {"model": "gpt2-tiny", "prompt": "hello gpu",
                                             "max_tokens": 8, "temperature": 0.0}),
    "completions_tokens": ("/v1/completions", {"model": "gpt2-tiny", "prompt": [1, 2, 3, 4],
                                               "max_tokens": 4, "temperature": 0.0}),
    "chat": ("/v1/chat/completions", {"model": "gpt2-tiny", "max_tokens": 6, "temperature": 0.0,
                                      "messages": [{"role": "system", "content": "be brief"},
                                                   {"role": "user", "content": "hi"}]}),
    "chat_sse": ("/v1/chat/completions", {"model": "gpt2-tiny", "max_tokens": 5,
                                          "temperature": 0.0, "stream": True,
                                          "messages": [{"role": "user", "content": "stream!"}]}),
    "completions_sse": ("/v1/completions", {"model": "gpt2-tiny", "prompt": "hello gpu",
                                            "max_tokens": 8, "temperature": 0.0,
                                            "stream": True}),
    "no_such_model": ("/v1/completions", {"model": "no-such-model", "prompt": "x"}),
    "bad_prompt": ("/v1/completions", {"model": "gpt2-tiny", "prompt": {"x": 1}}),
    "no_messages": ("/v1/chat/completions", {"model": "gpt2-tiny", "messages": []}),
}


@pytest.mark.parametrize("case", sorted(OPENAI_CASES))
def test_openai_bodies_match_jax(llm, case):
    path, payload = OPENAI_CASES[case]
    out = {side: _body(_post(url + path, payload)) for side, url in llm.items()}
    assert out["jax"] == out["torch"]
    code, body = out["torch"]
    if case.startswith("no_such") or case.startswith(("bad", "no_messages")):
        assert code in (400, 404) and body["error"]["type"] == "invalid_request_error"
    elif case.endswith("sse"):
        assert code == 200 and body[-1] == "[DONE]"
        assert body[-2]["choices"][0]["finish_reason"] == "length"
    else:
        assert code == 200 and body["usage"]["completion_tokens"] == payload["max_tokens"]


def test_openai_models_and_malformed_json(llm):
    out = {}
    for side, url in llm.items():
        with urllib.request.urlopen(url + "/v1/models", timeout=TIMEOUT) as r:
            models = _strip(json.loads(r.read()))
        out[side] = (models, _body(_post(url + "/v1/completions", None, raw=b"{not json")))
    assert out["jax"] == out["torch"]
    models, (code, err) = out["torch"]
    assert models["data"][0]["id"] == "gpt2-tiny" and code == 400
    assert set(err["error"]) == {"message", "type", "param", "code"}


@pytest.mark.parametrize("stream", [False, True])
def test_openai_multibyte_stop_sequence(llm, stream):
    """The stop-sequence cases of tests/test_openai_api.py, on both
    frontends: a 2-character stop cut out of the greedy text truncates it
    before the first occurrence, finish_reason "stop", plain and SSE."""
    req = {"model": "gpt2-tiny", "prompt": "hello tpu", "max_tokens": 24, "temperature": 0.0}
    out = {}
    for side, url in llm.items():
        _, base = _body(_post(url + "/v1/completions", req))
        text = base["choices"][0]["text"]
        stop = text[1:3]
        code, body = _body(_post(url + "/v1/completions", {**req, "stop": stop, "stream": stream}))
        if stream:
            got = "".join(c["choices"][0].get("text", "") for c in body[:-1])
            finish = body[-2]["choices"][0]["finish_reason"]
        else:
            got, finish = body["choices"][0]["text"], body["choices"][0]["finish_reason"]
        out[side] = (text, stop, got, finish)
    assert out["jax"] == out["torch"]
    text, stop, got, finish = out["torch"]
    assert len(text) >= 4 and got == text[: text.find(stop)] and finish == "stop"


def test_llm_app_builders_reject_tensor_parallel():
    """Tensor parallelism needs the paged engine: both packages'
    `build_llm_app` refuse tensor_parallel > 1 with the dense one, with
    JAX's ValueError (the paged form serves: tests/test_torch_tp_serve.py)."""
    for build, kw in ((jbuild_llm_app, {}), (tbuild_llm_app, {"device": "cpu"})):
        with pytest.raises(ValueError, match="tensor_parallel requires paged=True"):
            build("gpt2-tiny", paged=False, tensor_parallel=2, **kw)

