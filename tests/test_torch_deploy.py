"""The port's environment manifests (``tasksrunner_torch/deploy/``)
against the JAX package's in one process: the repo's manifests read
field by field, the validator's problems (the JAX list plus only what
the port cannot run, with no module of the JAX package imported), the
desired state and its diff, a what-if / apply / down cycle in which each
package reads the other's run file and components, the API-token refusal
and the ``base_dir`` anchoring; then one process test, bounded by its own
time limit: ``deploy apply``, ``run --device cpu`` on the applied run
file, one event stored in the file a secret names, SIGTERM, ``down``."""

import asyncio
import dataclasses
import json
import os
import signal
import sqlite3
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import yaml

from tasksrunner.component.loader import load_component_file as jax_load_component_file
from tasksrunner.deploy import manifest as jax_manifest
from tasksrunner.deploy import plan as jax_plan
from tasksrunner.errors import ComponentError as JaxComponentError
from tasksrunner.orchestrator.config import load_run_config as jax_load_run_config
from tasksrunner_torch import cloudevents
from tasksrunner_torch.component import blockyaml
from tasksrunner_torch.component.loader import load_component_file
from tasksrunner_torch.deploy import manifest, plan
from tasksrunner_torch.errors import ComponentError
from tasksrunner_torch.orchestrator.config import load_run_config

REPO = Path(__file__).resolve().parent.parent
MANIFESTS = [REPO / "samples" / "tasks_tracker" / "environment.yaml",
             REPO / "samples" / "tasks_tracker" / "environment.prod.yaml"]
APP, PUBSUB, TOPIC = "priority-scorer", "taskspubsub", "tasksavedtopic"
#: longer than PyYAML's line width, with spaces: written folded over lines
LONG_VALUE = " ".join(f"word{i}" for i in range(24))
LIMIT_S = 90


@pytest.mark.parametrize("path", MANIFESTS, ids=lambda p: p.name)
def test_the_repo_manifests_read_field_by_field(path):
    assert dataclasses.asdict(manifest.load_manifest(path)) == \
        dataclasses.asdict(jax_manifest.load_manifest(path))


def test_validating_the_repo_manifests_imports_nothing_of_the_jax_package():
    """Nor torch: ``deploy`` runs nothing on the card, and a verb that
    imports no torch starts in a fraction of the time."""
    # the deploy verb's own imports: the command line and the package, no torch
    code = ("import json, sys\nimport tasksrunner_torch.cli\n"
            "from tasksrunner_torch.deploy import load_manifest, validate_manifest\n"
            f"paths = {[str(p) for p in MANIFESTS]!r}\n"
            "out = [validate_manifest(load_manifest(p)) for p in paths]\n"
            "print(json.dumps({'problems': out, 'loaded': sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('tasksrunner', 'jax', 'yaml', 'aiohttp', 'torch'))}))\n")
    result = json.loads(subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                                       capture_output=True, text=True, timeout=120).stdout)
    assert result["loaded"] == []
    for path, got in zip(MANIFESTS, result["problems"]):
        m = jax_manifest.load_manifest(path)
        want = jax_manifest.validate_manifest(m, check_imports=False)
        port_only = [p for p in got if p not in want]
        assert [p for p in got if p in want] == want
        # what the port adds: the JAX sample apps and mesh_tls (A22); the
        # bindings.* components have their drivers
        apps = [f"app {a.app_id!r}: module {a.module.partition(':')[0]!r} is not a "
                "tasksrunner_torch app" for a in m.apps]
        bindings = [c.name for c in m.components
                    if yaml.safe_load((path.parent / c.file).read_text())["componentType"]
                    .startswith("bindings.")]
        assert bindings  # the sample manifests carry the queue, blob, mail and cron bindings
        assert not [p for p in got if "no driver" in p]
        assert len(port_only) == len(apps) + m.mesh_tls
        assert all(any(p.startswith(w) for p in port_only) for w in apps)
        assert m.mesh_tls == ("mesh_tls is not ported yet (ROADMAP A22)" in port_only)


def _write_env(root: Path, *, value: str = LONG_VALUE, require_token: bool = False,
               extra: str = "") -> Path:
    """A manifest of the port's scorer: a file secret store naming the
    state store's database, the broker, the app with its secrets."""
    root.mkdir(parents=True, exist_ok=True)
    comps = root / "components"
    comps.mkdir(exist_ok=True)
    (root / "secrets.json").write_text(json.dumps({"scores": {"path": str(root / "scores.db")}}))
    (comps / "vault.yaml").write_text(
        "componentType: secretstores.local.file\nmetadata:\n- name: secretsFile\n"
        f"  value: {root / 'secrets.json'}\n- name: nestedSeparator\n  value: '.'\n")
    (comps / "scores.yaml").write_text(
        "componentType: state.sqlite\nsecretStoreComponent: vault\nmetadata:\n"
        "- name: databasePath\n  secretRef: scores.path\nscopes:\n- priority-scorer\n")
    (comps / "broker.yaml").write_text(
        "componentType: pubsub.sqlite\nmetadata:\n- name: brokerPath\n"
        "  value: .tasksrunner/broker.db\n- name: gcIntervalSeconds\n  value: \"0\"\n")
    path = root / "env.yaml"
    path.write_text(
        "environment:\n  name: scorer-env\n  per_app_tokens: true\n"
        f"  require_api_token: {'true' if require_token else 'false'}\n"
        "components:\n  - name: vault\n    file: components/vault.yaml\n"
        "  - name: scores\n    file: components/scores.yaml\n"
        f"  - name: {PUBSUB}\n    file: components/broker.yaml\n"
        f"apps:\n  - app_id: {APP}\n    module: tasksrunner_torch.service:make_app\n"
        "    ingress: none\n"
        f"    env:\n      TASKSRUNNER_ML_BUCKETS: \"1\"\n      NOTE: {value}\n"
        "    secrets:\n      api-key: { env: SCORER_TEST_KEY }\n"
        "      fallback: { env: SCORER_TEST_UNSET, default: dummy }\n"
        "      literal: plain-value\n"
        "    grants:\n      scores: [read, write]\n      vault: [read]\n"
        f"      {PUBSUB}:\n        - subscribe: [{TOPIC}]\n"
        "    scale:\n      min_replicas: 1\n      max_replicas: 2\n      cooldown_seconds: 3\n"
        "      rules:\n        - type: pubsub-backlog\n          metadata:\n"
        f"            component: {PUBSUB}\n            topic: {TOPIC}\n"
        "            messageCount: \"16\"\n" + extra)
    return path


def test_desired_state_and_its_diff_match_jax(tmp_path):
    path = _write_env(tmp_path / "env")
    want = jax_manifest.desired_state(jax_manifest.load_manifest(path))
    got = manifest.desired_state(manifest.load_manifest(path))
    assert got == want
    assert manifest.validate_manifest(manifest.load_manifest(path)) == \
        jax_manifest.validate_manifest(jax_manifest.load_manifest(path)) == []
    changed = json.loads(json.dumps(got))
    changed["apps"][APP]["max_replicas"] = 3
    changed["components"]["extra"] = {"type": "state.in-memory"}
    del changed["components"]["vault"]
    for a, b in ((got, changed), (changed, got), ({}, got), (got, got)):
        assert plan.diff_states(a, b) == jax_plan.diff_states(a, b)


def _normalized(text: str, root: Path) -> object:
    return yaml.safe_load(text.replace(str(root), "ROOT"))


def test_apply_cycle_each_package_reads_the_others_files(tmp_path, monkeypatch):
    monkeypatch.setenv("SCORER_TEST_KEY", "sk-" + "x" * 90 + " with spaces " * 4)
    monkeypatch.delenv("SCORER_TEST_UNSET", raising=False)
    roots = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    paths = {k: _write_env(r) for k, r in roots.items()}
    port_m = manifest.load_manifest(paths["port"])
    jax_m = jax_manifest.load_manifest(paths["jax"])

    # the first what-if lists the whole environment in both
    assert plan.what_if(port_m)["changes"] == jax_plan.what_if(jax_m)["changes"] == [
        {"op": "create", "path": "", "value": "(entire environment)"}]
    got, want = plan.apply_manifest(port_m), jax_plan.apply_manifest(jax_m)
    assert (got["changes"], got["first_deploy"]) == (want["changes"], want["first_deploy"])
    run_texts = {"port": Path(got["run_config"]).read_text(),
                 "jax": Path(want["run_config"]).read_text()}
    # PyYAML folds the long value over lines; the port writes it on one
    assert LONG_VALUE in run_texts["port"] and LONG_VALUE not in run_texts["jax"]
    # the same run file, written twice
    assert _normalized(run_texts["port"], roots["port"]) == \
        _normalized(run_texts["jax"], roots["jax"])
    assert blockyaml.load_all(run_texts["jax"]) == [yaml.safe_load(run_texts["jax"])]
    assert blockyaml.load_all(run_texts["port"]) == [yaml.safe_load(run_texts["port"])]
    env = yaml.safe_load(run_texts["port"])["apps"][0]["env"]
    assert env["NOTE"] == LONG_VALUE and env["API_KEY"] == os.environ["SCORER_TEST_KEY"]
    assert env["FALLBACK"] == "dummy" and env["LITERAL"] == "plain-value"
    # each package reads either run file to the same config
    for who, root in roots.items():
        run_path = root / ".tasksrunner" / "scorer-env-run.yaml"
        port_cfg, jax_cfg = load_run_config(run_path), jax_load_run_config(run_path)
        assert [dataclasses.asdict(a)["env"] for a in port_cfg.apps] == \
            [a.env for a in jax_cfg.apps]
        assert (port_cfg.base_dir, port_cfg.registry_path, port_cfg.resources_path,
                port_cfg.per_app_tokens) == (jax_cfg.base_dir, jax_cfg.registry_path,
                                             jax_cfg.resources_path, jax_cfg.per_app_tokens)
        assert port_cfg.apps[0].grants == jax_cfg.apps[0].grants
        # and either package's component files
        for comp in sorted((root / ".tasksrunner" / "scorer-env-components").iterdir()):
            (mine,), (theirs,) = load_component_file(comp), jax_load_component_file(comp)
            assert (mine.name, mine.type, mine.scopes, mine.secret_store) == \
                (theirs.name, theirs.type, theirs.scopes, theirs.secret_store)
            assert {k: v if isinstance(v, str) else (v.key, v.store)
                    for k, v in mine.metadata.items()} == \
                {k: v if isinstance(v, str) else (v.key, v.store)
                 for k, v in theirs.metadata.items()}
    for name in ("vault", "scores", PUBSUB):
        rel = Path(".tasksrunner/scorer-env-components") / f"{name}.yaml"
        assert _normalized((roots["port"] / rel).read_text(), roots["port"]) == \
            _normalized((roots["jax"] / rel).read_text(), roots["jax"])

    # each package sees the other's deployed environment as unchanged
    for who, root in roots.items():
        assert plan.what_if(manifest.load_manifest(paths[who]))["changes"] == []
        assert jax_plan.what_if(jax_manifest.load_manifest(paths[who]))["changes"] == []
    # a change shows in both
    for path in paths.values():
        path.write_text(path.read_text().replace("max_replicas: 2", "max_replicas: 3"))
    assert plan.what_if(manifest.load_manifest(paths["jax"]))["changes"] == \
        jax_plan.what_if(jax_manifest.load_manifest(paths["port"]))["changes"] == [
            {"op": "modify", "path": f"apps.{APP}.max_replicas", "from": 2, "to": 3}]

    assert plan.destroy(manifest.load_manifest(paths["port"])) is True
    assert jax_plan.destroy(jax_manifest.load_manifest(paths["jax"])) is True
    for root in roots.values():
        assert not (root / ".tasksrunner" / "deployed.json").exists()
        assert not (root / ".tasksrunner" / "scorer-env-run.yaml").exists()
    assert plan.destroy(manifest.load_manifest(paths["port"])) is False
    assert plan.what_if(manifest.load_manifest(paths["port"]))["first_deploy"] is True


def test_apply_refuses_without_the_api_token_as_jax_does(tmp_path, monkeypatch):
    monkeypatch.delenv("TASKSRUNNER_API_TOKEN", raising=False)
    monkeypatch.setenv("SCORER_TEST_KEY", "k")
    path = _write_env(tmp_path, require_token=True)
    with pytest.raises(JaxComponentError) as want:
        jax_plan.apply_manifest(jax_manifest.load_manifest(path))
    with pytest.raises(ComponentError) as got:
        plan.apply_manifest(manifest.load_manifest(path))
    assert str(got.value) == str(want.value)
    assert not (tmp_path / ".tasksrunner" / "scorer-env-run.yaml").exists()
    monkeypatch.setenv("TASKSRUNNER_API_TOKEN", "t")
    run_path = Path(plan.apply_manifest(manifest.load_manifest(path))["run_config"])
    assert yaml.safe_load(run_path.read_text())["require_api_token"] is True
    # an unset secret without a default is refused too, as in JAX
    monkeypatch.delenv("SCORER_TEST_KEY")
    with pytest.raises(JaxComponentError) as want:
        jax_plan.apply_manifest(jax_manifest.load_manifest(path))
    with pytest.raises(ComponentError) as got:
        plan.apply_manifest(manifest.load_manifest(path))
    assert str(got.value) == str(want.value)


def test_paths_are_anchored_at_the_manifest_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("SCORER_TEST_KEY", "k")
    path = _write_env(tmp_path / "deep" / "env")
    monkeypatch.chdir(tmp_path)
    run_path = Path(plan.apply_manifest(manifest.load_manifest(
        Path("deep/env/env.yaml")))["run_config"])
    root = (tmp_path / "deep" / "env").resolve()
    doc = yaml.safe_load(run_path.read_text())
    assert doc["base_dir"] == str(root) and doc["per_app_tokens"] is True
    assert doc["registry_file"] == str(root / ".tasksrunner" / "apps.json")
    assert doc["resources_path"] == str(root / ".tasksrunner" / "scorer-env-components")
    config = load_run_config(run_path)
    assert config.base_dir == root and config.registry_path == root / ".tasksrunner/apps.json"
    assert run_path.parent == root / ".tasksrunner" and path.parent.resolve() == root


def test_a_mesh_tls_manifest_is_refused(tmp_path, monkeypatch):
    monkeypatch.setenv("SCORER_TEST_KEY", "k")
    path = _write_env(tmp_path)
    path.write_text(path.read_text().replace("  per_app_tokens: true\n",
                                             "  per_app_tokens: true\n  mesh_tls: true\n"))
    with pytest.raises(ComponentError, match=r"mesh_tls is not ported yet \(ROADMAP A22\)"):
        plan.apply_manifest(manifest.load_manifest(path))


def _stored(path: Path) -> dict:
    if not path.exists():
        return {}
    with sqlite3.connect(path) as conn:
        try:
            rows = conn.execute("SELECT key, value FROM state").fetchall()
        except sqlite3.OperationalError:  # the file is made before its table
            return {}
    return {k.split("||", 1)[1]: json.loads(v) for k, v in rows}


def _until(predicate, seconds: float, what: str):
    deadline = time.monotonic() + seconds
    while not (value := predicate()):
        assert time.monotonic() < deadline, what
        time.sleep(0.05)
    return value


def test_deploy_apply_then_run_stores_an_event_then_down(tmp_path):
    from tasksrunner_torch.pubsub.sqlite import SqliteBroker

    started = time.monotonic()
    remaining = lambda: LIMIT_S - (time.monotonic() - started)  # noqa: E731
    path = _write_env(tmp_path)
    env = {**os.environ, "PYTHONPATH": str(REPO), "SCORER_TEST_KEY": "k",
           "TASKSRUNNER_API_TOKEN": "deploy-token"}

    def deploy(action: str) -> str:
        out = subprocess.run([sys.executable, "-m", "tasksrunner_torch", "deploy", action,
                              str(path)], cwd=tmp_path, env=env, capture_output=True,
                             text=True, timeout=max(remaining(), 1))
        assert out.returncode == 0, out.stdout + out.stderr
        return out.stdout

    assert "manifest 'scorer-env' is valid (1 apps, 3 components)" in deploy("validate")
    applied = deploy("apply")
    run_file = tmp_path / ".tasksrunner" / "scorer-env-run.yaml"
    assert f"start with: python -m tasksrunner_torch run {run_file}" in applied
    assert deploy("what-if").startswith("no changes")

    async def publish() -> None:
        broker = SqliteBroker(PUBSUB, tmp_path / ".tasksrunner" / "broker.db")
        try:
            await broker.ensure_group(TOPIC, APP)
            data = {"taskId": "t-1", "taskName": "rotate the keys of the billing service"}
            await broker.publish(TOPIC, cloudevents.wrap(data, source="test", topic=TOPIC,
                                                         pubsub_name=PUBSUB),
                                 metadata={"content-type": cloudevents.CONTENT_TYPE})
        finally:
            await broker.aclose()

    asyncio.run(publish())
    proc = subprocess.Popen([sys.executable, "-m", "tasksrunner_torch", "run", str(run_file),
                             "--device", "cpu"], cwd=tmp_path, env=env,
                            stdout=subprocess.PIPE, stderr=open(tmp_path / "run.log", "w"),
                            text=True)
    lines: list[str] = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    try:
        # stored in the database file the secret store names
        stored = _until(lambda: _stored(tmp_path / "scores.db"), remaining(),
                        "the event was not stored")
        assert list(stored) == ["t-1"] and 0 < stored["t-1"]["confidence"] <= 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=max(remaining(), 1)) == 0, (
            tmp_path / "run.log").read_text()[-3000:]
        reader.join(timeout=10)
        assert any(f"[{APP}·0] ready " in line for line in lines), lines[-10:]
        assert json.loads((tmp_path / ".tasksrunner" / "apps.json").read_text()) == {}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
    assert "environment 'scorer-env' state removed" in deploy("down")
    assert not run_file.exists() and not (tmp_path / ".tasksrunner" / "deployed.json").exists()
    assert deploy("what-if").splitlines() == ["+ scorer-env"]
    assert remaining() > 0
