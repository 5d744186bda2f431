"""Multi-app run configuration: the port of
``tasksrunner/orchestrator/config.py``, read with the port's own YAML
reader (:mod:`~tasksrunner_torch.component.blockyaml`) instead of PyYAML.

A run file names the apps the orchestrator supervises, each a
``pkg.module:factory`` that makes a port :class:`~tasksrunner_torch.app.App`,
with its ports, environment, liveness probe, grants and KEDA-style scale
block::

    resources_path: ./components
    registry_file: .tasksrunner/apps.json
    apps:
      - app_id: priority-scorer
        module: tasksrunner_torch.service:make_app
        scale:
          min_replicas: 1
          max_replicas: 3
          rules:
            - type: pubsub-backlog      # +1 replica per messageCount
              metadata:
                component: taskspubsub
                topic: tasksavedtopic
                messageCount: "16"

The fields, their defaults and the errors are the JAX package's, so one
file reads the same in both. What the port has no counterpart for is
refused when the file is read, never ignored: ``mesh_tls: true``
(ROADMAP A22).
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass, field

from tasksrunner_torch.component import blockyaml
from tasksrunner_torch.errors import ComponentError

#: every scale-rule type of the JAX autoscaler; an unknown type is
#: refused when the file is read
RULE_TYPES = ("pubsub-backlog", "queue-backlog", "http-concurrency",
              "cpu", "memory", "target-p99", "loop-lag")


def not_ported(what: str, item: str) -> ComponentError:
    return ComponentError(f"{what} is not ported yet (ROADMAP {item})")


@dataclass
class ScaleRule:
    type: str  # one of RULE_TYPES
    metadata: dict[str, str] = field(default_factory=dict)


@dataclass
class ScaleSpec:
    min_replicas: int = 1
    max_replicas: int = 1
    rules: list[ScaleRule] = field(default_factory=list)
    #: seconds of low load before scaling in (KEDA's cooldown)
    cooldown_seconds: float = 5.0


@dataclass
class HealthSpec:
    """Liveness probing: the orchestrator GETs the app's ``/healthz``
    and kills the replica after ``failure_threshold`` failures in a row,
    so its supervisor restarts it."""

    enabled: bool = True
    interval_seconds: float = 5.0
    failure_threshold: int = 3
    #: grace after the ready line before the first probe
    initial_delay_seconds: float = 2.0
    timeout_seconds: float = 2.0


@dataclass
class AppSpec:
    app_id: str
    module: str  # "pkg.mod:factory"
    app_port: int = 0
    sidecar_port: int = 0
    #: the app server's bind address ("0.0.0.0": external ingress)
    host: str = "127.0.0.1"
    env: dict[str, str] = field(default_factory=dict)
    scale: ScaleSpec = field(default_factory=ScaleSpec)
    health: HealthSpec = field(default_factory=HealthSpec)
    #: the app's component grants (security.AppGrants as JSON); None = unrestricted
    grants: dict | None = None


@dataclass
class RunConfig:
    apps: list[AppSpec]
    resources_path: str | None = None
    registry_file: str = ".tasksrunner/apps.json"
    base_dir: pathlib.Path = field(default_factory=pathlib.Path.cwd)

    @property
    def registry_path(self) -> pathlib.Path:
        """``registry_file`` resolved against ``base_dir``: the one way
        to find the registry (and the lease and admin files beside it)."""
        p = pathlib.Path(self.registry_file)
        return p if p.is_absolute() else self.base_dir / p
    #: the admin API's localhost port (0: any free one), advertised in
    #: ``<registry dir>/orchestrator.json``
    admin_port: int = 0
    #: refuse to start unless TASKSRUNNER_API_TOKEN is set
    require_api_token: bool = False
    #: one generated token per app instead of one shared token
    per_app_tokens: bool = False
    #: refused by the port (ROADMAP A22)
    mesh_tls: bool = False
    #: app_id → token, filled at start when per_app_tokens is on
    app_tokens: dict[str, str] = field(default_factory=dict)
    #: the digest map file written with app_tokens
    tokens_file: str | None = None
    #: filled by the JAX orchestrator for mesh_tls; always empty here
    mesh_certs: dict[str, dict[str, str]] = field(default_factory=dict)
    #: re-adopt the live replicas a previous orchestrator left registered
    adopt: bool = True
    #: wait for the control-plane lease instead of exiting when it is held
    standby: bool = False


def parse_health(health_raw: object) -> HealthSpec:
    """A ``health:`` block: a mapping, a boolean, or empty (defaults)."""
    if health_raw is None or health_raw is True:
        health_raw = {}
    if health_raw is False:
        return HealthSpec(enabled=False)
    if not isinstance(health_raw, dict):
        raise ComponentError("health must be a mapping or boolean")
    try:
        return HealthSpec(
            enabled=bool(health_raw.get("enabled", True)),
            interval_seconds=float(health_raw.get("interval_seconds", 5.0)),
            failure_threshold=int(health_raw.get("failure_threshold", 3)),
            initial_delay_seconds=float(health_raw.get("initial_delay_seconds", 2.0)),
            timeout_seconds=float(health_raw.get("timeout_seconds", 2.0)),
        )
    except (TypeError, ValueError) as exc:
        raise ComponentError(f"bad health block value: {exc}") from exc


def _read(path: pathlib.Path) -> dict:
    try:
        text = path.read_text()
    except OSError as exc:
        raise ComponentError(f"cannot read run config {path}: {exc}") from exc
    try:
        docs = blockyaml.load_all(text, str(path))
    except ComponentError as exc:
        raise ComponentError(f"cannot parse run config {path}: {exc}") from exc
    if len(docs) > 1:
        raise ComponentError(f"cannot parse run config {path}: more than one document")
    return (docs[0] if docs else None) or {}


def load_run_config(path: str | pathlib.Path) -> RunConfig:
    path = pathlib.Path(path)
    doc = _read(path)

    apps = []
    for raw in doc.get("apps") or []:
        if "app_id" not in raw or "module" not in raw:
            raise ComponentError("each app needs app_id and module")
        scale_raw = raw.get("scale") or {}
        rules = [
            ScaleRule(type=r.get("type", ""), metadata={
                str(k): str(v) for k, v in (r.get("metadata") or {}).items()})
            for r in scale_raw.get("rules") or []
        ]
        for rule in rules:
            if rule.type not in RULE_TYPES:
                raise ComponentError(
                    f"app {raw['app_id']}: unknown scale rule type "
                    f"{rule.type!r} (known: {', '.join(RULE_TYPES)})")
        health = parse_health(raw.get("health", {}))
        grants = raw.get("grants")
        if grants is not None:
            from tasksrunner_torch.security import AppGrants
            grants = AppGrants.parse(grants, app_id=str(raw["app_id"])).to_json()
        apps.append(AppSpec(
            app_id=str(raw["app_id"]),
            module=str(raw["module"]),
            app_port=int(raw.get("app_port", 0)),
            sidecar_port=int(raw.get("sidecar_port", 0)),
            host=str(raw.get("host", "127.0.0.1")),
            env={str(k): str(v) for k, v in (raw.get("env") or {}).items()},
            scale=ScaleSpec(
                min_replicas=int(scale_raw.get("min_replicas", 1)),
                max_replicas=int(scale_raw.get("max_replicas", 1)),
                rules=rules,
                cooldown_seconds=float(scale_raw.get("cooldown_seconds", 5.0)),
            ),
            health=health,
            grants=grants,
        ))
    if not apps:
        raise ComponentError(f"run config {path} declares no apps")
    if bool(doc.get("mesh_tls", False)):
        raise not_ported(f"run config {path}: mesh_tls", "A22")

    # relative paths resolve against base_dir when the file names one
    # (itself relative to the file), else against the file's directory
    base = path.resolve().parent
    if doc.get("base_dir"):
        declared = pathlib.Path(doc["base_dir"])
        base = declared if declared.is_absolute() else (base / declared).resolve()
    resources = doc.get("resources_path")
    if resources is not None and not pathlib.Path(resources).is_absolute():
        resources = str(base / resources)
    return RunConfig(
        apps=apps,
        resources_path=resources,
        registry_file=str(doc.get("registry_file", ".tasksrunner/apps.json")),
        base_dir=base,
        admin_port=int(doc.get("admin_port", 0)),
        require_api_token=bool(doc.get("require_api_token", False)),
        per_app_tokens=bool(doc.get("per_app_tokens", False)),
        mesh_tls=False,
        adopt=bool(doc.get("adopt", True)),
        standby=bool(doc.get("standby", False)),
    )
