"""what-if, apply and down against the recorded state: the port of
``tasksrunner/deploy/plan.py``, writing YAML with
:func:`~tasksrunner_torch.component.blockyaml.dump` instead of PyYAML.

``apply`` records the manifest's canonical form in
``.tasksrunner/deployed.json`` beside the manifest, writes one
local-dialect file per component into ``.tasksrunner/{name}-components/``
and the run file ``.tasksrunner/{name}-run.yaml`` that ``python -m
tasksrunner_torch run`` reads, with every app's secrets resolved into its
env. Both packages read what either writes.
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Any

from tasksrunner_torch.client import TOKEN_ENV
from tasksrunner_torch.component import blockyaml
from tasksrunner_torch.component.loader import dump_components
from tasksrunner_torch.deploy.manifest import (
    EnvironmentManifest, desired_state, resolve_components, validate_manifest,
)
from tasksrunner_torch.errors import ComponentError

DEPLOYED_STATE = "deployed.json"


def _state_path(manifest: EnvironmentManifest) -> pathlib.Path:
    return manifest.base_dir / ".tasksrunner" / DEPLOYED_STATE


def _load_recorded(manifest: EnvironmentManifest) -> dict | None:
    path = _state_path(manifest)
    if not path.is_file():
        return None
    try:
        return json.loads(path.read_text())
    except ValueError:
        return None


def diff_states(recorded: Any, desired: Any, *, path: str = "") -> list[dict]:
    """A structural diff: ``{op: create|delete|modify, path, ...}`` each."""
    changes: list[dict] = []
    if isinstance(recorded, dict) and isinstance(desired, dict):
        for key in sorted(set(recorded) | set(desired)):
            sub = f"{path}.{key}" if path else str(key)
            if key not in recorded:
                changes.append({"op": "create", "path": sub, "value": desired[key]})
            elif key not in desired:
                changes.append({"op": "delete", "path": sub, "value": recorded[key]})
            else:
                changes.extend(diff_states(recorded[key], desired[key], path=sub))
        return changes
    if recorded != desired:
        changes.append({"op": "modify", "path": path, "from": recorded, "to": desired})
    return changes


def what_if(manifest: EnvironmentManifest) -> dict:
    """Validate and diff the manifest against the recorded state; touch
    nothing."""
    problems = validate_manifest(manifest)
    desired = desired_state(manifest) if not problems else {}
    recorded = _load_recorded(manifest)
    changes = ([{"op": "create", "path": "", "value": "(entire environment)"}]
               if recorded is None and not problems
               else diff_states(recorded or {}, desired))
    return {"valid": not problems, "problems": problems,
            "first_deploy": recorded is None, "changes": changes}


def _resolve_secret(name: str, spec: object, *, app_id: str) -> str:
    """A literal string, or ``{env: VAR}`` read now (``default`` when
    VAR is unset)."""
    if isinstance(spec, str):
        return spec
    if isinstance(spec, dict) and "env" in spec:
        var = str(spec["env"])
        if var in os.environ:
            return os.environ[var]
        if "default" in spec:
            return str(spec["default"])
        raise ComponentError(f"app {app_id!r}: secret {name!r} references unset env var {var!r}")
    raise ComponentError(f"app {app_id!r}: secret {name!r} must be a string or {{env: VAR}}")


def apply_manifest(manifest: EnvironmentManifest) -> dict:
    """Validate, write the components and the run file, record the
    state; returns ``{run_config, state, changes, first_deploy}``."""
    preview = what_if(manifest)
    if not preview["valid"]:
        raise ComponentError("manifest is invalid:\n  - " + "\n  - ".join(preview["problems"]))
    if manifest.require_api_token and not os.environ.get(TOKEN_ENV):
        raise ComponentError(
            f"manifest requires an API token but {TOKEN_ENV} is not set in the deploying "
            "environment (the secure-baseline posture: no unauthenticated "
            "sidecar/control-plane access)")

    out_dir = manifest.base_dir / ".tasksrunner"
    out_dir.mkdir(parents=True, exist_ok=True)

    apps_block = []
    for app in manifest.apps:
        env = dict(app.env)
        for secret_name, spec in app.secrets.items():
            env[secret_name.replace("-", "_").upper()] = _resolve_secret(
                secret_name, spec, app_id=app.app_id)
        entry: dict[str, Any] = {
            "app_id": app.app_id, "module": app.module, "app_port": app.app_port,
            "sidecar_port": app.sidecar_port,
            # external ingress binds off-host
            "host": "0.0.0.0" if app.ingress == "external" else "127.0.0.1",
            "env": env}
        if app.max_replicas > 1 or app.scale_rules:
            entry["scale"] = {"min_replicas": app.min_replicas,
                              "max_replicas": app.max_replicas,
                              "cooldown_seconds": app.cooldown_seconds,
                              "rules": app.scale_rules}
        if app.health is not None:
            entry["health"] = app.health
        if app.grants is not None:
            entry["grants"] = app.grants
        apps_block.append(entry)

    resources_dir = out_dir / f"{manifest.name}-components"
    resources_dir.mkdir(parents=True, exist_ok=True)
    for old in resources_dir.glob("*.yaml"):
        old.unlink()
    for spec in resolve_components(manifest):
        (resources_dir / f"{spec.name}.yaml").write_text(dump_components([spec]))

    # the registry and relative component paths resolve against the
    # manifest's directory, not the run file's (.tasksrunner/)
    registry = pathlib.Path(manifest.registry_file)
    if not registry.is_absolute():
        registry = manifest.base_dir / registry
    run_config: dict[str, Any] = {"resources_path": str(resources_dir),
                                  "registry_file": str(registry),
                                  "base_dir": str(manifest.base_dir), "apps": apps_block}
    if manifest.require_api_token:
        run_config["require_api_token"] = True
    if manifest.per_app_tokens:
        run_config["per_app_tokens"] = True
    run_path = out_dir / f"{manifest.name}-run.yaml"
    run_path.write_text(blockyaml.dump(run_config))

    state_path = _state_path(manifest)
    state_path.write_text(json.dumps(desired_state(manifest), indent=2))
    return {"run_config": str(run_path), "state": str(state_path),
            "changes": preview["changes"], "first_deploy": preview["first_deploy"]}


def destroy(manifest: EnvironmentManifest) -> bool:
    """Remove the recorded state and the run file; True if state existed."""
    state = _state_path(manifest)
    existed = state.is_file()
    if existed:
        state.unlink()
    run_path = manifest.base_dir / ".tasksrunner" / f"{manifest.name}-run.yaml"
    if run_path.is_file():
        run_path.unlink()
    return existed
