"""The slice as a whole, on the CPU: the port's scorer behind the port's
sidecar against the JAX scorer behind the JAX sidecar, each an app host
over sqlite store and broker files from the same component files, driven
over HTTP through its sidecar only.

* The same scripted state, publish, metadata and invoke calls give the
  same statuses and bodies (etags included).
* The same 16 saved-task events are stored under the same keys, and the
  same 8 ``/score`` calls answer the same statuses, with confidences
  within ``CONFIDENCE_TOL`` (the tolerance of
  ``tests/test_torch_runtime_parity.py``), from the same params.
"""

import asyncio
import json
import sqlite3

import numpy as np
import pytest

from tasksrunner.ml.platform import pin_cpu_platform

if not pin_cpu_platform():
    pytest.skip("jax cpu platform unavailable", allow_module_level=True)

import jax  # noqa: E402

from tasksrunner_torch import model, service  # noqa: E402
from tasksrunner_torch.client import http_request  # noqa: E402
from tasksrunner_torch.hosting import AppHost  # noqa: E402

CONFIDENCE_TOL = 2e-2
TOKEN = {"tr-api-token": "parity-token"}
PUBLISH = "/v1.0/publish/taskspubsub/tasksavedtopic"
TASKS = [{"taskId": f"t-{i}", "taskName": f"{verb} the {thing} {i}",
          "taskCreatedBy": f"user{i % 3}@example.com", "taskAssignedTo": f"ops{i % 4}"}
         for i, (verb, thing) in enumerate(
             (v, t) for v in ("fix", "ship", "review", "water")
             for t in ("deploy", "docs", "plants", "outage"))]
SCORED = TASKS[:8]
# (method, path, body, headers): the state, publish, metadata and invoke script
SCRIPT = [
    ("GET", "/v1.0/state/kv/x", None, {}),
    ("POST", "/v1.0/state/kv", [{"key": "x", "value": {"v": 1, "s": "é"}}], TOKEN),
    ("GET", "/v1.0/state/kv/x", None, TOKEN),
    ("POST", "/v1.0/state/kv", [{"key": "x", "value": 2, "etag": "9"}], TOKEN),
    ("POST", "/v1.0/state/kv", [{"key": "x", "value": 3, "etag": "1"}], TOKEN),
    ("GET", "/v1.0/state/kv/missing", None, TOKEN),
    ("POST", "/v1.0/state/kv/transaction", {"operations": [
        {"operation": "upsert", "request": {"key": "y", "value": [1, None]}},
        {"operation": "upsert", "request": {"key": "z", "value": "zz"}}]}, TOKEN),
    ("POST", "/v1.0/state/kv/transaction", {"operations": [
        {"operation": "delete", "request": {"key": "z", "etag": "1"}}]}, TOKEN),
    ("POST", "/v1.0/state/kv/bulk", {"keys": ["x", "y", "z", "w"]}, TOKEN),
    ("DELETE", "/v1.0/state/kv/y", None, {**TOKEN, "if-match": "99"}),
    ("DELETE", "/v1.0/state/kv/y", None, TOKEN),
    ("GET", "/v1.0/state/kv/y", None, TOKEN),
    ("POST", "/v1.0/state/kv", b"{not json", TOKEN),
    ("POST", "/v1.0/state/kv", {"key": "x"}, TOKEN),
    ("GET", "/v1.0/state/nope/x", None, TOKEN),
    ("POST", "/v1.0/publish/kv/topic", {"a": 1}, TOKEN),
    ("POST", "/v1.0/publish/nope/topic", {"a": 1}, TOKEN),
    ("POST", "/v1.0/publish/taskspubsub/othertopic", {"a": 1}, TOKEN),
    ("GET", "/v1.0/healthz", None, {}),
    ("GET", "/v1.0/invoke/priority-scorer/method/scores/absent", None, TOKEN),
    ("POST", "/v1.0/invoke/ghost/method/x", {}, TOKEN),
]


def bounded(aw, seconds: float = 60):
    return asyncio.wait_for(aw, seconds)


def _write_components(root) -> None:
    root.mkdir()
    for name, type_, key, file in (("scores", "state.azure.cosmosdb", "databasePath", "scores.db"),
                                   ("kv", "state.sqlite", "databasePath", "kv.db"),
                                   ("taskspubsub", "pubsub.redis", "brokerPath", "broker.db")):
        (root / f"{name}.yaml").write_text(
            f"apiVersion: dapr.io/v1alpha1\nkind: Component\nmetadata:\n  name: {name}\n"
            f"spec:\n  type: {type_}\n  version: v1\n  metadata:\n  - name: {key}\n"
            f"    value: {root.parent / file}\n")


async def _call(port, method, path, body=None, headers=None):
    if body is not None and not isinstance(body, bytes):
        body = json.dumps(body).encode()
    status, reply_headers, payload = await bounded(http_request(
        "127.0.0.1", port, method, path, headers=headers, body=body or b""))
    return status, reply_headers, json.loads(payload) if payload else None


async def _drive(host, tmp) -> dict:
    """The script, the events and the /score calls through the sidecar."""
    port = host.sidecar_port
    out: dict = {"script": []}
    for method, path, body, headers in SCRIPT:
        status, reply_headers, payload = await _call(port, method, path, body, headers)
        if isinstance(payload, dict) and "messageId" in payload:
            assert len(payload["messageId"]) == 32
            payload = "a message id"
        out["script"].append((method, path, status, reply_headers.get("etag"), payload))
    meta = (await _call(port, "GET", "/v1.0/metadata", headers=TOKEN))[2]
    out["metadata"] = {k: meta[k] for k in ("id", "components", "subscriptions")}
    out["published"] = [(await _call(port, "POST", PUBLISH, task, TOKEN))[0] for task in TASKS]
    replies = await asyncio.gather(*(_call(port, "POST", "/v1.0/invoke/priority-scorer/method/score",
                                           task, TOKEN) for task in SCORED))
    out["score"] = [(status, body) for status, _, body in replies]

    async def stored():
        found = {}
        while len(found) < len(TASKS):
            for task in TASKS:
                if task["taskId"] not in found:
                    status, _, body = await _call(
                        port, "GET", f"/v1.0/state/scores/{task['taskId']}", headers=TOKEN)
                    if status == 200:
                        found[task["taskId"]] = body
            await asyncio.sleep(0.05)
        return found
    out["stored"] = await bounded(stored(), 60)
    return out


def _store_keys(path) -> list:
    with sqlite3.connect(path) as conn:
        return [r[0] for r in conn.execute("SELECT key FROM state ORDER BY key")]


async def _jax_side(tmp) -> dict:
    from tasksrunner.hosting import AppHost as JaxAppHost
    from tasksrunner.ml.service import make_app as jax_make_app

    _write_components(tmp / "components")
    host = JaxAppHost(jax_make_app(), components_path=str(tmp / "components"),
                      registry_file=str(tmp / "apps.json"))
    await bounded(host.start(), 120)  # the JAX host warms the model up in start
    try:
        return await _drive(host, tmp)
    finally:
        await bounded(host.stop())


async def _port_side(tmp) -> dict:
    _write_components(tmp / "components")
    app = service.make_app(device="cpu")
    host = AppHost(app, components_path=str(tmp / "components"),
                   registry_file=str(tmp / "apps.json"))
    await bounded(host.start())
    try:
        await bounded(app.wait_ready())
        return await _drive(host, tmp)
    finally:
        await bounded(host.stop())


def test_the_port_behind_its_sidecar_answers_as_the_jax_scorer_behind_its_own(
        tmp_path, monkeypatch):
    monkeypatch.setenv("TASKSRUNNER_ML_BUCKETS", "1")  # one jit compile on the JAX side
    monkeypatch.setenv("TASKSRUNNER_MESH", "0")
    monkeypatch.setenv("TASKSRUNNER_API_TOKEN", TOKEN["tr-api-token"])
    from tasksrunner.ml import model as jax_model

    jcfg = jax_model.ModelConfig(n_classes=len(service.PRIORITY_LABELS))
    tree = jax.tree.map(np.asarray, jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(service, "init_params",
                        lambda cfg, seed, device: model.params_from_jax(tree, device))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = asyncio.run(_jax_side(tmp_path / "jax"))
    got = asyncio.run(_port_side(tmp_path / "port"))

    assert got["script"] == want["script"]
    assert got["metadata"] == want["metadata"]
    assert got["published"] == want["published"] == [200] * len(TASKS)
    assert [s for s, _ in got["score"]] == [s for s, _ in want["score"]] == [200] * len(SCORED)
    for (_, g), (_, w) in zip(got["score"], want["score"]):
        assert g["taskId"] == w["taskId"]
        assert abs(g["confidence"] - w["confidence"]) <= CONFIDENCE_TOL
    assert sorted(got["stored"]) == sorted(want["stored"]) == sorted(t["taskId"] for t in TASKS)
    for task_id, value in got["stored"].items():
        assert abs(value["confidence"] - want["stored"][task_id]["confidence"]) <= CONFIDENCE_TOL
    keys = _store_keys(tmp_path / "port" / "scores.db")
    assert keys == _store_keys(tmp_path / "jax" / "scores.db")
    assert keys == sorted(f"priority-scorer||{t['taskId']}" for t in TASKS)
