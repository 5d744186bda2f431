"""The port's bindings on the CPU, without JAX: every case of
``tests/test_bindings.py`` run against ``tasksrunner_torch.bindings``, then
the bindings behind the port's runtime and sidecar (an app's
``@app.binding`` route fed from a queue under an inbound resiliency
policy, the cron binding's default route, ``POST /v1.0/bindings/{name}``
and the client's ``invoke_binding`` on its transports, the ``invoke``
grant)."""

import asyncio
import json

import pytest

from tasksrunner_torch.app import App
from tasksrunner_torch.bindings import (
    EmailOutboxBinding, LocalBlobStoreBinding, LocalQueueBinding, SqliteQueue,
)
from tasksrunner_torch.bindings.base import BindingEvent
from tasksrunner_torch.bindings.localqueue import open_queue_for_inspection
from tasksrunner_torch.client import AppClient, http_request
from tasksrunner_torch.component.registry import ComponentRegistry, registered_types
from tasksrunner_torch.component.spec import parse_component
from tasksrunner_torch.errors import BindingError, InvocationError
from tasksrunner_torch.metrics import metrics
from tasksrunner_torch.resiliency import ResiliencyPolicies
from tasksrunner_torch.resiliency.spec import parse_resiliency
from tasksrunner_torch.runtime import InProcAppChannel, Runtime
from tasksrunner_torch.security import AppGrants
from tasksrunner_torch.sidecar import Sidecar


def bounded(aw, seconds: float = 20):
    return asyncio.wait_for(aw, seconds)


async def wait_until(cond, timeout=3.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        if asyncio.get_running_loop().time() > deadline:
            raise AssertionError("condition not met in time")
        await asyncio.sleep(0.01)


def spec(name: str, type_: str, **metadata):
    return parse_component({"componentType": type_, "metadata": [
        {"name": k, "value": str(v)} for k, v in metadata.items()]}, default_name=name)


# -- every case of tests/test_bindings.py -------------------------------------

async def test_queue_input_binding_ack_consumes(tmp_path):
    binding = LocalQueueBinding("externaltasksmanager", str(tmp_path / "q.db"),
                                route="/externaltasksprocessor/process", poll_interval=0.01)
    assert binding.route == "/externaltasksprocessor/process"
    got = []

    async def sink(event):
        got.append(event)
        return True

    await binding.start(sink)
    binding.queue.send({"taskName": "external"})
    await wait_until(lambda: len(got) == 1)
    assert got[0].data == {"taskName": "external"}
    assert got[0].metadata["attempt"] == "1"
    assert binding.queue.backlog() == 0
    await binding.stop()


async def test_queue_nack_redelivers_then_dead_letters(tmp_path):
    binding = LocalQueueBinding("q", str(tmp_path / "q.db"), poll_interval=0.01,
                                max_attempts=2, retry_delay=0.01)
    attempts = []

    async def sink(event):
        attempts.append(int(event.metadata["attempt"]))
        return False

    await binding.start(sink)
    binding.queue.send({"n": 1})
    await wait_until(lambda: len(attempts) >= 2)
    await asyncio.sleep(0.05)
    assert attempts == [1, 2]
    assert binding.queue.backlog() == 0  # dead-lettered, not pending
    assert [d["attempts"] for d in binding.queue.dead_letter_detail()] == [2]
    await binding.stop()


async def test_queue_output_binding_enqueues(tmp_path):
    binding = LocalQueueBinding("q", str(tmp_path / "q.db"), poll_interval=0.01)
    resp = await binding.invoke("create", {"external": True})
    assert resp.metadata["messageId"]
    assert binding.queue.backlog() == 1
    with pytest.raises(BindingError):
        await binding.invoke("get", None)
    await binding.stop()


async def test_queue_cross_process_producer(tmp_path):
    path = tmp_path / "q.db"
    binding = LocalQueueBinding("q", str(path), poll_interval=0.01)
    got = []

    async def sink(event):
        got.append(event.data)
        return True

    await binding.start(sink)
    producer = SqliteQueue(path)
    producer.send({"from": "outside"})
    await wait_until(lambda: got == [{"from": "outside"}])
    producer.close()
    await binding.stop()


async def test_blob_binding_crud(tmp_path):
    blob = LocalBlobStoreBinding("externaltasksblobstore", tmp_path)
    task = {"taskId": "abc", "taskName": "archived"}
    resp = await blob.invoke("create", task, {"blobName": "abc.json"})
    assert resp.metadata["blobName"] == "abc.json"
    got = await blob.invoke("get", None, {"blobName": "abc.json"})
    assert json.loads(got.data) == task
    assert (await blob.invoke("list", None)).data == ["abc.json"]
    await blob.invoke("create", b"\x00raw", {"blobName": "sub/raw.bin"})
    assert (await blob.invoke("list", None)).data == ["abc.json", "sub/raw.bin"]
    assert (await blob.invoke("get", None, {"blobName": "sub/raw.bin"})).data == b"\x00raw"
    assert (await blob.invoke("delete", None, {"blobName": "abc.json"})).metadata == \
        {"deleted": "true"}
    assert (await blob.invoke("delete", None, {"blobName": "abc.json"})).metadata == \
        {"deleted": "false"}
    await blob.invoke("delete", None, {"blobName": "sub/raw.bin"})
    assert (await blob.invoke("list", None)).data == []
    with pytest.raises(BindingError):
        await blob.invoke("get", None, {"blobName": "abc.json"})
    with pytest.raises(BindingError, match="requires blobName"):
        await blob.invoke("get", None, {})
    made = await blob.invoke("create", "text", {})  # a name is made up for a create
    assert (await blob.invoke("get", None, made.metadata)).data == b"text"


async def test_blob_binding_rejects_escape(tmp_path):
    blob = LocalBlobStoreBinding("b", tmp_path)
    with pytest.raises(BindingError, match="escapes"):
        await blob.invoke("create", "x", {"blobName": "../../etc/passwd"})


async def test_email_outbox(tmp_path):
    mail = EmailOutboxBinding("sendgrid", tmp_path / "outbox",
                              default_from="noreply@tasksrunner.local")
    await mail.invoke("create", "<b>task assigned</b>", {
        "emailTo": "a@x.com", "emailToName": "A", "subject": "tasks assigned"})
    sent = [json.loads(p.read_text()) for p in (tmp_path / "outbox").glob("*.json")]
    assert len(sent) == 1
    assert (sent[0]["to"], sent[0]["from"], sent[0]["subject"], sent[0]["body"]) == \
        ("a@x.com", "noreply@tasksrunner.local", "tasks assigned", "<b>task assigned</b>")
    with pytest.raises(BindingError, match="emailTo"):
        await mail.invoke("create", "x", {})
    with pytest.raises(BindingError, match="only create"):
        await mail.invoke("delete", "x", {"emailTo": "a@x.com"})


def test_binding_drivers_registered():
    types = registered_types()
    for t in ("bindings.cron", "bindings.azure.storagequeues", "bindings.localqueue",
              "bindings.azure.blobstorage", "bindings.localblob", "bindings.twilio.sendgrid",
              "bindings.smtp"):
        assert t in types


async def test_queue_dead_letter_detail_and_requeue(tmp_path):
    binding = LocalQueueBinding("extq", str(tmp_path / "queues" / "extq.db"),
                                poll_interval=0.01, max_attempts=2, retry_delay=0.02)
    ok = False
    seen = []

    async def sink(event: BindingEvent) -> bool:
        seen.append(event.data)
        return ok

    await binding.start(sink)
    await binding.invoke("create", {"n": 9})
    await wait_until(lambda: binding.queue.dead_letter_detail(), 5)
    queue_spec = parse_component({
        "componentType": "bindings.azure.storagequeues",
        "metadata": [{"name": "queuePath", "value": str(tmp_path / "queues")},
                     {"name": "queueName", "value": "extq"}]}, default_name="extq")
    queue = open_queue_for_inspection(queue_spec, tmp_path)
    detail = queue.dead_letter_detail()
    assert detail and detail[0]["data"] == {"n": 9}
    assert queue.requeue_dead_letters(["bogus"]) == 0
    ok = True
    count = len(seen)
    assert queue.requeue_dead_letters() == 1
    queue.close()
    await wait_until(lambda: len(seen) > count, 5)
    assert binding.queue.dead_letter_detail() == []
    assert binding.queue.purge_dead_letters() == 0
    await binding.stop()


# -- behind the runtime and the sidecar -----------------------------------------

class _FlakyChannel(InProcAppChannel):
    """The app's channel, whose first ``drops`` requests to ``path`` fail
    in transport (a retriable error, as a reset connection is)."""

    def __init__(self, app, path: str, drops: int) -> None:
        super().__init__(app)
        self.path, self.drops = path, drops

    async def request(self, method, path, **kwargs):
        if path == self.path and self.drops:
            self.drops -= 1
            raise ConnectionResetError("dropped")
        return await super().request(method, path, **kwargs)


async def test_an_app_binding_route_gets_queue_events_under_an_inbound_policy(tmp_path):
    """The sample's storage-queue component behind a runtime: the
    component's inbound policy retries a delivery whose transport fails
    before it counts, so the app sees the first attempt; a handler's
    error status nacks, and the queue delivers again (attempt 2)."""
    calls = []
    app = App("processor")

    @app.binding("externaltasksmanager", route="/externaltasksprocessor/process")
    async def process(req):
        calls.append((req.data, req.headers.get("attempt"), req.headers.get("content-type")))
        return 200 if req.data["taskId"] == "e1" or len(calls) > 2 else 500

    queue = spec("externaltasksmanager", "bindings.azure.storagequeues",
                 queueName="external-tasks-queue", queuePath=tmp_path / "queues",
                 route="/externaltasksprocessor/process", pollIntervalSeconds=0.01,
                 retryDelaySeconds=0.01)
    policies = ResiliencyPolicies([parse_resiliency({"kind": "Resiliency", "spec": {
        "policies": {"retries": {"quick": {"policy": "constant", "duration": "10ms",
                                           "maxRetries": 3}}},
        "targets": {"components": {"externaltasksmanager": {"inbound": {"retry": "quick"}}}}}})],
        app_id="processor")
    runtime = Runtime("processor", ComponentRegistry([queue], app_id="processor"),
                      app_channel=_FlakyChannel(app, "/externaltasksprocessor/process", 2),
                      resiliency=policies)
    before = {s: metrics.get("binding_delivery", binding="externaltasksmanager", status=s)
              for s in ("200", "500")}
    await bounded(runtime.start())
    try:
        producer = SqliteQueue(tmp_path / "queues" / "external-tasks-queue.db")
        producer.send({"taskId": "e1", "taskName": "from outside"})
        await bounded(wait_until(lambda: len(calls) == 1 and producer.backlog() == 0))
        producer.send({"taskId": "e2"})
        await bounded(wait_until(lambda: len(calls) == 3 and producer.backlog() == 0))
        assert calls == [({"taskId": "e1", "taskName": "from outside"}, "1", "application/json"),
                         ({"taskId": "e2"}, "1", "application/json"),
                         ({"taskId": "e2"}, "2", "application/json")]
        assert producer.dead_letter_detail() == []
        producer.close()
        assert {s: metrics.get("binding_delivery", binding="externaltasksmanager", status=s)
                - before[s] for s in before} == {"200": 2, "500": 1}
        assert {"name": "externaltasksmanager", "type": "bindings.azure.storagequeues"} in \
            runtime.metadata()["components"]
    finally:
        await bounded(runtime.stop())
    assert [(r.method, r.path) for r in app.router.table if r.kind == "binding"] == \
        [("POST", "/externaltasksprocessor/process")]


async def test_a_cron_binding_posts_to_the_route_named_after_it(tmp_path):
    app = App("scheduler")
    fired = []

    @app.binding("ScheduledTasksManager")
    async def tick(req):
        fired.append((req.body, req.headers.get("schedule")))
        return 200

    cron = spec("ScheduledTasksManager", "bindings.cron", schedule="@every 20ms")
    runtime = Runtime("scheduler", ComponentRegistry([cron], app_id="scheduler"),
                      app_channel=InProcAppChannel(app))
    await bounded(runtime.start())
    try:
        await bounded(wait_until(lambda: len(fired) >= 2))
    finally:
        await bounded(runtime.stop())
    assert fired[0] == (b"", "@every 20ms")
    assert [r.path for r in app.router.table if r.kind == "binding"] == \
        ["/ScheduledTasksManager"]


async def test_the_bindings_route_and_the_clients_invoke_binding(tmp_path):
    """``POST /v1.0/bindings/{name}`` on the port's sidecar, the client's
    HTTP and in-process transports, the ``invoke`` grant (403 without it)."""
    specs = [spec("q", "bindings.localqueue", queuePath=tmp_path / "queues"),
             spec("blobs", "bindings.azure.blobstorage", blobPath=tmp_path / "blobs",
                  container="c"),
             spec("mail", "bindings.twilio.sendgrid", outboxPath=tmp_path / "outbox",
                  emailFrom="noreply@x"),
             spec("tick", "bindings.cron", schedule="5 0 * * *")]
    grants = AppGrants.parse({"blobs": ["invoke"], "mail": ["invoke"], "tick": ["invoke"]})
    runtime = Runtime("caller", ComponentRegistry(specs, app_id="caller"), grants=grants)
    sidecar = Sidecar(runtime, port=0)
    await bounded(sidecar.start())

    async def post(name, body):
        raw = body if isinstance(body, bytes) else json.dumps(body).encode()
        status, _, payload = await bounded(http_request(
            "127.0.0.1", sidecar.port, "POST", f"/v1.0/bindings/{name}", body=raw))
        return status, json.loads(payload)

    try:
        status, body = await post("blobs", {"operation": "create", "data": {"a": 1},
                                            "metadata": {"blobName": "t1.json"}})
        assert (status, body) == (200, {"data": None, "metadata": {"blobName": "t1.json"}})
        status, body = await post("blobs", {"operation": "get",
                                            "metadata": {"blobName": "t1.json"}})
        assert status == 200 and json.loads(body["data"]) == {"a": 1}
        assert (await post("blobs", {"operation": "list"})) == \
            (200, {"data": ["t1.json"], "metadata": {}})
        assert (await post("blobs", {"operation": "get", "metadata": {"blobName": "nope"}}))[0] \
            == 500
        assert (await post("mail", {"data": "hi", "metadata": {"emailTo": "a@x"}}))[0] == 200
        assert (await post("q", {"data": 1}))[0] == 403  # no grant
        assert (await post("tick", {"data": 1})) == \
            (500, {"error": "component 'tick' is not an output binding"})
        assert (await post("ghost", {}))[0] == 403
        assert (await post("blobs", b"{nope"))[0] == 400
        assert (await post("blobs", [1]))[0] == 400

        http = AppClient.http(sidecar.port)
        resp = await bounded(http.invoke_binding("blobs", "get", metadata={"blobName": "t1.json"}))
        assert json.loads(resp.data) == {"a": 1} and resp.metadata == {"blobName": "t1.json"}
        with pytest.raises(InvocationError) as denied:
            await bounded(http.invoke_binding("q", "create", {"x": 1}))
        assert denied.value.status == 403
        direct = AppClient.runtime(runtime)
        resp = await bounded(direct.invoke_binding("mail", "create", "body",
                                                   {"emailTo": "b@x", "subject": "s"}))
        assert resp.metadata["mailId"]
        mails = [json.loads(p.read_text())
                 for p in runtime.registry.get("mail").outbox.glob("*.json")]
        assert sorted(m["to"] for m in mails) == ["a@x", "b@x"]
        assert metrics.get("binding_invoke", binding="mail", operation="create") >= 2
    finally:
        await bounded(sidecar.stop())
