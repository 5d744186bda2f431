"""The port's secret stores (``tasksrunner_torch/secrets/``) against the
JAX package's in one process: the three stores on the same environment
and files, ``secretKeyRef`` / ``secretRef`` / ``secretStoreComponent``
resolved by the registry as the JAX registry resolves them, a ref that
resolves nowhere refused, and the sidecar's secret routes with the
``read`` grant and without it."""

import asyncio
import json

import pytest

from tasksrunner.component.loader import load_components as jax_load_components
from tasksrunner.component.registry import ComponentRegistry as JaxRegistry
from tasksrunner.errors import SecretError as JaxSecretError
from tasksrunner.secrets import local as jax_local
from tasksrunner_torch.client import http_request
from tasksrunner_torch.component.loader import load_components
from tasksrunner_torch.component.registry import ComponentRegistry
from tasksrunner_torch.errors import SecretError, SecretNotFound
from tasksrunner_torch.runtime import Runtime
from tasksrunner_torch.secrets import local
from tasksrunner_torch.security import AppGrants
from tasksrunner_torch.sidecar import Sidecar

SECRETS = {"db-path": "/data/scores.db", "nested": {"inner": {"key": "v"}, "n": 3,
                                                     "none": None}, "flag": True}


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 - compared across packages
        return ("raised", type(exc).__name__, str(exc))


def _store_trace(store, keys) -> list:
    return [_outcome(store.keys), _outcome(store.bulk)] + [
        _outcome(lambda k=k: store.get(k)) for k in keys]


@pytest.mark.parametrize("kind", ["env", "env-prefixed", "json", "yaml", "yaml-sep",
                                  "static", "missing-file", "bad-json", "not-a-mapping"])
def test_the_stores_match_jax_on_the_same_env_and_files(kind, tmp_path, monkeypatch):
    monkeypatch.setenv("TR_API_KEY", "k1")
    monkeypatch.setenv("TR_OTHER_ONE", "k2")
    monkeypatch.setenv("PLAIN_NAME", "p")
    keys = ["api-key", "other-one", "PLAIN_NAME", "missing", "db-path", "nested:inner:key",
            "nested/inner/key", "nested:n", "nested:none", "flag"]
    files = {"json": ("s.json", json.dumps(SECRETS)),
             "yaml": ("s.yaml", "db-path: /data/scores.db\nnested:\n  inner:\n    key: v\n"
                                "  n: 3\n  none:\nflag: true\n"),
             "yaml-sep": ("s.yml", "nested:\n  inner:\n    key: v\n"),
             "missing-file": ("absent.json", None), "bad-json": ("b.json", "{nope"),
             "not-a-mapping": ("l.json", "[1, 2]")}

    def build(mod):
        if kind == "env":
            return mod.EnvSecretStore("env")
        if kind == "env-prefixed":
            return mod.EnvSecretStore("env", prefix="TR_")
        if kind == "static":
            return mod.StaticSecretStore("static", {"api-key": "s", "flag": "true"})
        name, text = files[kind]
        if text is not None:
            (tmp_path / name).write_text(text)
        sep = "/" if kind == "yaml-sep" else ":"
        return mod.FileSecretStore("file", tmp_path / name, nested_separator=sep)

    want = _outcome(lambda: _store_trace(build(jax_local), keys))
    got = _outcome(lambda: _store_trace(build(local), keys))
    if kind == "bad-json":  # the JSON decoder's text after the file's name
        assert got[1].split(":")[0] == want[1].split(":")[0] and got[0] == want[0]
    else:
        assert got == want


def _write_components(root, secrets_file):
    root.mkdir()
    (root / "vault.yaml").write_text(
        "componentType: secretstores.local.file\nmetadata:\n"
        f"- name: secretsFile\n  value: {secrets_file}\n")
    (root / "local-ref.yaml").write_text(
        "kind: Component\nmetadata:\n  name: local-ref\nspec:\n  type: state.in-memory\n"
        "  metadata:\n  - name: databasePath\n    secretKeyRef:\n      name: db-path\n"
        "      key: db-path\n  - name: nestedKey\n    secretKeyRef:\n"
        "      name: nested:inner:key\n  - name: plain\n    value: x\n"
        "auth:\n  secretStore: vault\n")
    (root / "cloud-ref.yaml").write_text(
        "componentType: state.in-memory\nsecretStoreComponent: vault\nsecrets:\n"
        "- name: inline\n  value: from-the-file\nmetadata:\n"
        "- name: a\n  secretRef: inline\n- name: b\n  secretRef: db-path\n")
    (root / "env-ref.yaml").write_text(
        "kind: Component\nmetadata:\n  name: env-ref\nspec:\n  type: state.in-memory\n"
        "  metadata:\n  - name: key\n    secretKeyRef:\n      name: scorer-api-key\n")
    (root / "kv.yaml").write_text(
        "componentType: secretstores.azure.keyvault\nmetadata: []\nscopes:\n- priority-scorer\n")


@pytest.mark.parametrize("app_id", [None, "priority-scorer", "some-api"])
def test_refs_resolve_as_the_jax_registry_resolves_them(app_id, tmp_path, monkeypatch):
    monkeypatch.setenv("SCORER_API_KEY", "sk")
    secrets_file = tmp_path / "secrets.json"
    secrets_file.write_text(json.dumps(SECRETS))
    _write_components(tmp_path / "components", secrets_file)
    jax_reg = JaxRegistry(jax_load_components(tmp_path / "components"), app_id=app_id)
    reg = ComponentRegistry(load_components(tmp_path / "components"), app_id=app_id)
    assert reg.names() == jax_reg.names()
    for name in reg.names("state"):
        assert reg.resolver.resolve_metadata(reg.spec(name)) == \
            jax_reg.resolver.resolve_metadata(jax_reg.spec(name))
    assert reg.resolver.resolve_metadata(reg.spec("local-ref")) == {
        "databasePath": "/data/scores.db", "nestedKey": "v", "plain": "x"}
    assert reg.resolver.resolve_metadata(reg.spec("cloud-ref")) == {
        "a": "from-the-file", "b": "/data/scores.db"}
    assert reg.get("env-ref") is not None
    assert sorted(reg.names("secretstores")) == sorted(jax_reg.names("secretstores"))


@pytest.mark.parametrize("case", ["missing-key", "missing-store", "unset-env"])
def test_a_ref_that_does_not_resolve_raises(case, tmp_path, monkeypatch):
    monkeypatch.delenv("SCORER_API_KEY", raising=False)
    secrets_file = tmp_path / "secrets.json"
    secrets_file.write_text(json.dumps({"other": "x"} if case == "missing-key" else SECRETS))
    _write_components(tmp_path / "components", secrets_file)
    if case == "missing-store":
        (tmp_path / "components" / "vault.yaml").unlink()
    name = "env-ref" if case == "unset-env" else "local-ref"
    with pytest.raises(JaxSecretError) as want:
        JaxRegistry(jax_load_components(tmp_path / "components")).get(name)
    with pytest.raises(SecretError) as got:
        ComponentRegistry(load_components(tmp_path / "components")).get(name)
    assert str(got.value) == str(want.value)


async def test_the_sidecar_secret_routes_answer_with_the_grant_and_refuse_without(tmp_path):
    secrets_file = tmp_path / "secrets.json"
    secrets_file.write_text(json.dumps(SECRETS))
    _write_components(tmp_path / "components", secrets_file)
    specs = load_components(tmp_path / "components")

    async def serve(app_id, grants):
        runtime = Runtime(app_id, ComponentRegistry(specs, app_id=app_id), grants=grants)
        sidecar = Sidecar(runtime, port=0, peer_tokens=set())
        await sidecar.start()
        return sidecar

    async def get(sidecar, path):
        status, _, body = await asyncio.wait_for(
            http_request("127.0.0.1", sidecar.port, "GET", path), 20)
        return status, json.loads(body)

    granted = await serve("priority-scorer",
                          AppGrants.parse({"vault": ["read"], "local-ref": ["read"]}))
    refused = await serve("some-api", AppGrants.parse({"vault": ["write"]}))
    try:
        assert await get(granted, "/v1.0/secrets/vault/db-path") == (
            200, {"db-path": "/data/scores.db"})
        status, bulk = await get(granted, "/v1.0/secrets/vault/bulk")
        assert status == 200 and bulk["nested:inner:key"] == "v" and len(bulk) == 5
        status, body = await get(granted, "/v1.0/secrets/vault/absent")
        assert status == SecretNotFound.http_status == 404 and "absent" in body["error"]
        status, body = await get(refused, "/v1.0/secrets/vault/db-path")
        assert status == 403 and "no 'read' grant on component 'vault'" in body["error"]
        assert (await get(refused, "/v1.0/secrets/vault/bulk"))[0] == 403
        # a state store asked for as a secret store is a 400, as in JAX
        status, body = await get(granted, "/v1.0/secrets/local-ref/x")
        assert status == 400 and "not a secretstores component" in body["error"]
    finally:
        await granted.stop()
        await refused.stop()
