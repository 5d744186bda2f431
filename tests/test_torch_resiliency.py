"""The port's resiliency (``tasksrunner_torch/resiliency/``) against the
JAX package's in one process: durations, retry schedules (seeded jitter
included), trip expressions, the breaker's states over one fake clock,
``TargetPolicy.execute`` on the same scripted failures, the documents of
the sample and of the JAX tests read field by field, the same errors,
scope resolution, and the port's runtime making exactly a policy's
attempts on an invoke to a dead peer."""

import asyncio
import dataclasses
import json
import itertools
import random
import socket
from pathlib import Path

import pytest

from tasksrunner.errors import CircuitOpenError as JaxCircuitOpenError
from tasksrunner.errors import ComponentError as JaxComponentError
from tasksrunner.observability.metrics import metrics as jax_metrics
from tasksrunner.resiliency import policy as jax_policy
from tasksrunner.resiliency import spec as jax_spec
from tasksrunner_torch.errors import CircuitOpenError, ComponentError
from tasksrunner_torch.metrics import metrics
from tasksrunner_torch.resiliency import policy, spec

REPO = Path(__file__).resolve().parent.parent
SAMPLE = REPO / "samples" / "tasks_tracker" / "components" / "resiliency.yaml"
BOTH = [(jax_policy, jax_spec, JaxComponentError, JaxCircuitOpenError, jax_metrics),
        (policy, spec, ComponentError, CircuitOpenError, metrics)]


def _doc():
    from tests.test_resiliency_policies import RESILIENCY_YAML
    return RESILIENCY_YAML


@pytest.mark.parametrize("raw", ["500ms", "5s", "1m30s", "2h", "1.5s", "0.25", 3, 2.5,
                                 " 10ms ", "", "5 parsecs", "1x"])
def test_durations_match_jax(raw):
    try:
        want = jax_policy.parse_duration(raw)
    except JaxComponentError as exc:
        with pytest.raises(ComponentError, match=str(exc).replace("(", r"\(").replace(")", r"\)")):
            policy.parse_duration(raw)
    else:
        assert policy.parse_duration(raw) == want


@pytest.mark.parametrize("kw", [
    {"policy": "constant", "duration": 0.5, "max_retries": 4},
    {"policy": "exponential", "duration": 0.1, "max_interval": 1.0, "max_retries": 7},
    {"policy": "exponential", "duration": 0.2, "max_interval": 3.0, "max_retries": -1},
    {"policy": "constant", "duration": 0.2, "max_retries": -1, "jitter": 1.0},
    {"policy": "exponential", "duration": 0.05, "max_interval": 2.0, "max_retries": 9,
     "jitter": 0.4},
])
@pytest.mark.parametrize("seed", [0, 7])
def test_retry_delays_match_jax_for_seeded_rngs(kw, seed):
    # maxRetries -1 has no end: both are taken to the same bound
    want = list(itertools.islice(jax_policy.RetrySpec(**kw).delays(random.Random(seed)), 40))
    got = list(itertools.islice(policy.RetrySpec(**kw).delays(random.Random(seed)), 40))
    assert got == want and len(got) == (40 if kw["max_retries"] < 0 else kw["max_retries"])


@pytest.mark.parametrize("expr", ["consecutiveFailures >= 5", "consecutiveFailures > 2",
                                  " consecutiveFailures>=1 ", "requests > 3", "x"])
def test_trip_expressions_match_jax(expr):
    try:
        want = jax_policy.parse_trip(expr)
    except JaxComponentError as exc:
        with pytest.raises(ComponentError) as got:
            policy.parse_trip(expr)
        assert str(got.value) == str(exc)
    else:
        assert policy.parse_trip(expr) == want


class _Clock:
    def __init__(self) -> None:
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now


def _breaker_trace(mod, circuit_open, registry, monkeypatch) -> list:
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    breaker = mod.CircuitBreaker(mod.CircuitBreakerSpec("cb", trip_threshold=3, timeout=5.0,
                                                        max_requests=2), target="t")
    trace = []
    # (advance the clock by, action)
    script = [(0, "fail"), (0, "fail"), (0, "call"), (0, "fail"), (1, "call"), (4.5, "call"),
              (0, "call"), (0, "call"), (0, "release"), (0, "call"), (0, "fail"), (2, "call"),
              (3.5, "call"), (0, "ok"), (0, "call"), (0, "fail"), (0, "fail"), (0, "ok")]
    for dt, action in script:
        clock.now += dt
        if action == "call":
            try:
                breaker.before_call()
                outcome = "through"
            except circuit_open as exc:
                outcome = str(exc)
        else:
            {"fail": breaker.record_failure, "ok": breaker.record_success,
             "release": breaker.release_probe}[action]()
            outcome = None
        trace.append((action, outcome, breaker.state, breaker.consecutive_failures,
                      registry.get("resiliency_breaker_state", policy="cb", target="t")))
    return trace


def test_breaker_state_sequence_matches_jax_over_one_fake_clock(monkeypatch):
    want = _breaker_trace(jax_policy, JaxCircuitOpenError, jax_metrics, monkeypatch)
    got = _breaker_trace(policy, CircuitOpenError, metrics, monkeypatch)
    assert got == want
    assert {s for _, _, s, _, _ in got} == {"closed", "open", "half-open"}


class _Hinted(OSError):
    def __init__(self, retry_after: float) -> None:
        super().__init__("shed")
        self.retry_after = retry_after


# name -> (TargetPolicy kwargs built from a module, the script of each
# attempt: an exception to raise, "slow" to outlast the timeout, or a result)
SCENARIOS = {
    "retry-until-success": (lambda m: dict(retry=m.RetrySpec(duration=0.01, max_retries=3)),
                            [OSError("a"), OSError("b"), "ok"]),
    "retries-exhausted": (lambda m: dict(retry=m.RetrySpec(
        policy="exponential", duration=0.01, max_interval=0.025, max_retries=3)),
        [OSError(str(i)) for i in range(4)]),
    "not-retriable": (lambda m: dict(retry=m.RetrySpec(duration=0.01, max_retries=3)),
                      [ValueError("no")]),
    "retry-after-clamped": (lambda m: dict(retry=m.RetrySpec(
        duration=0.01, max_interval=0.05, max_retries=3)),
        [_Hinted(5.0), _Hinted(0.02), _Hinted(0.0), "ok"]),
    "per-attempt-timeout": (lambda m: dict(timeout=0.02, retry=m.RetrySpec(
        duration=0.01, max_retries=1)), ["slow", "slow"]),
    "total-timeout-before-a-sleep": (lambda m: dict(
        timeout=0.15, timeout_policy="total",
        retry=m.RetrySpec(duration=0.1, max_retries=-1)), [OSError("x")] * 5),
    "breaker-opens-and-fails-fast": (lambda m: dict(
        retry=m.RetrySpec(duration=0.0, max_retries=5),
        breaker=m.CircuitBreaker(m.CircuitBreakerSpec("b", trip_threshold=2, timeout=60),
                                 target="target")), [OSError("1"), OSError("2"), "never"]),
}


async def _run_scenario(mod, name, monkeypatch) -> tuple:
    build, script = SCENARIOS[name]
    sleeps = []
    real_sleep = asyncio.sleep
    # the policy's clock moves only by its own backoff sleeps: a total
    # budget is spent the same way however loaded the machine is
    clock = _Clock()

    async def recording_sleep(delay):
        sleeps.append(round(delay, 9))
        clock.now += delay
        await real_sleep(0)

    monkeypatch.setattr(mod, "time", clock)
    monkeypatch.setattr(mod.asyncio, "sleep", recording_sleep)
    attempts = []

    async def fn():
        step = script[len(attempts)]
        attempts.append(step)
        if step == "slow":
            await real_sleep(0.5)
        if isinstance(step, BaseException):
            raise step
        return step

    target_policy = mod.TargetPolicy(target="target", **build(mod))
    try:
        outcome = ("returned", await target_policy.execute(fn))
    except BaseException as exc:  # noqa: BLE001 - compared across packages
        outcome = ("raised", type(exc).__name__, str(exc))
    finally:
        monkeypatch.undo()
    return len(attempts), sleeps, outcome


@pytest.mark.parametrize("name", sorted(SCENARIOS))
async def test_execute_matches_jax_on_the_same_scripted_failures(name, monkeypatch):
    retried = metrics.get("resiliency_retry_total", target="target")
    want = await _run_scenario(jax_policy, name, monkeypatch)
    got = await _run_scenario(policy, name, monkeypatch)
    assert got == want
    assert metrics.get("resiliency_retry_total", target="target") - retried == len(got[1])
    if name == "retry-after-clamped":  # 5 s → maxInterval; 0.02 s > the base delay
        assert got[1] == [0.05, 0.02, 0.01]
    if name == "total-timeout-before-a-sleep":
        assert got[0] == 2 and "total budget" in got[2][2]


def _fields(specs) -> list:
    return [dataclasses.asdict(s) for s in specs]


def test_load_resiliency_reads_the_sample_and_the_jax_tests_documents(tmp_path):
    import yaml

    for i, doc in enumerate([_doc(), {**_doc(), "scopes": ["other-app"]}]):
        (tmp_path / f"r{i}.yaml").write_text(yaml.safe_dump(doc))
    (tmp_path / "comp.yaml").write_text(yaml.safe_dump({"componentType": "state.in-memory"}))
    (tmp_path / "two.yml").write_text(yaml.safe_dump_all([
        {"componentType": "state.in-memory"},
        {"kind": "Resiliency", "metadata": {"name": "inline"}, "spec": {"policies": {
            "retries": {"r": {"duration": "1ms", "jitter": 0.5}}},
            "targets": {"components": {"comp": {"retry": "r"}}}}}]))
    for directory in (tmp_path, SAMPLE.parent.parent / "components"):
        want = jax_spec.load_resiliency(directory)
        got = spec.load_resiliency(directory)
        assert _fields(got) == _fields(want) and got
    assert spec.load_resiliency(tmp_path / "missing") == []


BAD_DOCS = [
    {"kind": "Component"},
    {"kind": "Resiliency", "spec": {"policies": {"retries": {"r": "5s"}}}},
    {"kind": "Resiliency", "spec": {"policies": {"retries": {"r": {"jitter": 2}}}}},
    {"kind": "Resiliency", "spec": {"policies": {"circuitBreakers": {"c": []}}}},
    {"kind": "Resiliency", "spec": {"policies": {"circuitBreakers": {"c": {"trip": "x > 1"}}}}},
    {"kind": "Resiliency", "spec": {"policies": {"timeouts": {"t": "soon"}}}},
    {"kind": "Resiliency", "spec": {"targets": {"apps": {"a": "fast"}}}},
    {"kind": "Resiliency", "spec": {"targets": {"apps": {"a": {"timeoutPolicy": "each"}}}}},
    {"kind": "Resiliency", "spec": {"targets": {"components": {"c": []}}}},
    {"kind": "Resiliency", "scopes": "one-app"},
    {"kind": "Resiliency", "spec": {"targets": {"apps": {"a": {"timeout": "t"}}}}},
    {"kind": "Resiliency", "spec": {"policies": {"retries": {"fast": {"duration": "1ms"}}},
                                    "targets": {"apps": {"api": {"retry": "fsat"}}}}},
    {"kind": "Resiliency", "spec": {"targets": {"components": {"c": {
        "inbound": {"circuitBreaker": "cb"}}}}}},
]


@pytest.mark.parametrize("i", range(len(BAD_DOCS)))
def test_bad_documents_give_the_same_component_errors(i):
    with pytest.raises(JaxComponentError) as want:
        jax_spec.parse_resiliency(BAD_DOCS[i], source="r.yaml")
    with pytest.raises(ComponentError) as got:
        spec.parse_resiliency(BAD_DOCS[i], source="r.yaml")
    assert str(got.value) == str(want.value)


def _resolved(mod_policy, mod_spec, app_id):
    specs = [mod_spec.parse_resiliency(_doc()),
             mod_spec.parse_resiliency({**_doc(), "metadata": {"name": "scoped"},
                                        "scopes": ["other-app"]}),
             mod_spec.parse_resiliency(mod_spec_doc_inbound())]
    pols = mod_policy.ResiliencyPolicies(specs, app_id=app_id)
    out = {}
    for kind, name, direction in (("apps", "backend", None), ("apps", "unknown", None),
                                  ("components", "statestore", "outbound"),
                                  ("components", "statestore", "inbound"),
                                  ("components", "taskspubsub", "inbound")):
        p = (pols.for_app(name) if kind == "apps"
             else pols.for_component(name, direction))
        out[(kind, name, direction)] = None if p is None else (
            p.target, p.timeout, p.retry and dataclasses.asdict(p.retry),
            p.breaker and dataclasses.asdict(p.breaker.spec), p.timeout_policy)
    return out, pols


def mod_spec_doc_inbound():
    return {"kind": "Resiliency", "metadata": {"name": "inbound"}, "spec": {
        "policies": {"retries": {"r": {"duration": "5ms", "maxRetries": 2}},
                     "timeouts": {"t": "1s"}},
        "targets": {"components": {"taskspubsub": {"inbound": {
            "retry": "r", "timeout": "t", "timeoutPolicy": "total"}}}}}}


@pytest.mark.parametrize("app_id", [None, "other-app", "some-api"])
def test_scope_resolution_matches_jax(app_id):
    want, _ = _resolved(jax_policy, jax_spec, app_id)
    got, pols = _resolved(policy, spec, app_id)
    assert got == want
    # one breaker per (policy, target), shared by every resolution
    assert pols.for_app("backend").breaker is pols.for_app("backend").breaker


def _dead_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("max_retries", [0, 2, 4])
async def test_an_invoke_to_a_dead_peer_makes_exactly_the_policys_attempts(max_retries):
    from tasksrunner_torch.component.registry import ComponentRegistry
    from tasksrunner_torch.errors import InvocationError
    from tasksrunner_torch.invoke.resolver import AppAddress
    from tasksrunner_torch.runtime import INVOKE_ATTEMPTS, Runtime

    doc = {"kind": "Resiliency", "metadata": {"name": "r"}, "spec": {
        "policies": {"retries": {"r": {"duration": "1ms", "maxRetries": max_retries}}},
        "targets": {"apps": {"dead-peer": {"retry": "r"}}}}}
    port = _dead_port()

    class Resolver:
        calls = 0

        def resolve(self, app_id):
            Resolver.calls += 1
            return AppAddress(app_id=app_id, host="127.0.0.1", sidecar_port=port)

    for policies, expected in ((policy.ResiliencyPolicies([spec.parse_resiliency(doc)]),
                                max_retries + 1), (None, INVOKE_ATTEMPTS)):
        Resolver.calls = 0
        runtime = Runtime("caller", ComponentRegistry([]), resolver=Resolver(),
                          resiliency=policies)
        counters = ("resiliency_retry_total", "resiliency_retry_exhausted_total")
        before = [metrics.get(c, target="dead-peer") for c in counters]
        with pytest.raises(InvocationError, match="cannot reach sidecar of 'dead-peer'"):
            await runtime.invoke("dead-peer", "score", body=b"{}")
        assert Resolver.calls == expected
        after = [metrics.get(c, target="dead-peer") for c in counters]
        # the builtin attempts (no policy) count as no resiliency retry
        assert after == ([before[0] + max_retries, before[1] + 1]
                         if policies is not None else before)


def test_a_resources_directory_applies_resiliency_and_refuses_chaos(tmp_path):
    from tasksrunner_torch import service
    from tasksrunner_torch.component.loader import load_components
    from tasksrunner_torch.hosting import AppHost

    comps = tmp_path / "components"
    comps.mkdir()
    (comps / "resiliency.yaml").write_text(SAMPLE.read_text())
    (comps / "store.yaml").write_text("componentType: state.in-memory\n")
    host = AppHost(service.make_app(device="cpu"), components_path=str(comps))
    assert [s.name for s in host.specs] == ["store"]
    assert [s.name for s in host.resiliency_specs] == ["tasks-tracker-resiliency"]
    (comps / "chaos.yaml").write_text((SAMPLE.parent / "chaos.yaml").read_text())
    with pytest.raises(ComponentError, match="kind: Chaos documents are not ported yet"):
        load_components(comps)


@pytest.mark.parametrize("exc_name", ["CircuitOpenError", "SecretNotFound", "SecretError"])
def test_the_new_errors_answer_as_the_jax_sidecar_answers_them(exc_name):
    import tasksrunner.errors as jax_errors
    import tasksrunner_torch.errors as errors
    from tasksrunner.sidecar import _json_error
    from tasksrunner_torch.sidecar import json_error

    message = "circuit 'cb' open for target 't'"
    want = _json_error(getattr(jax_errors, exc_name)(message))
    got = json_error(getattr(errors, exc_name)(message))
    assert (got.status, json.loads(got.payload())) == (want.status, json.loads(want.body))


async def test_a_deferral_carries_retry_after_into_the_policys_next_delay(monkeypatch):
    """A sidecar's 503 + Retry-After reaches the app's client as an
    ``InvocationError`` with ``retry_after``, as the JAX client's error
    carries it, and a policy's next delay honours it (clamped)."""
    from tasksrunner_torch.app import Response, start_server
    from tasksrunner_torch.client import AppClient
    from tasksrunner_torch.errors import InvocationError

    answers = [Response(503, {"error": "warming"}, headers={"Retry-After": "0.04"}),
               Response(429, {"error": "shed"}, headers={"Retry-After": "9"}),
               Response(200, {"messageId": "m"})]

    async def handle(method, target, headers, body):
        return answers.pop(0)

    server = await start_server(handle, "127.0.0.1", 0)
    client = AppClient.http(server.sockets[0].getsockname()[1])
    sleeps = []

    async def recording_sleep(delay):
        sleeps.append(delay)

    monkeypatch.setattr(policy.asyncio, "sleep", recording_sleep)
    try:
        target = policy.TargetPolicy(target="bus", retry=policy.RetrySpec(
            duration=0.01, max_interval=0.5, max_retries=3))
        await target.execute(lambda: client.publish_event("bus", "topic", {"a": 1}),
                             retriable=(InvocationError,))
    finally:
        server.close()
        await server.wait_closed()
    assert sleeps == [0.04, 0.5] and answers == []
