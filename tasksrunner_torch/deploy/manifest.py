"""The environment manifest: the port of ``tasksrunner/deploy/manifest.py``,
read with :mod:`~tasksrunner_torch.component.blockyaml` instead of PyYAML.

One file declares the environment, its components (cloud-dialect files,
each named by the manifest) and its apps with their ingress, ports,
env, secrets, grants, liveness probe and scale block::

    environment:
      name: scorer-env
      registry_file: .tasksrunner/apps.json
      per_app_tokens: true
      require_api_token: true
    components:
      - name: scores
        file: components/scores.yaml
    apps:
      - app_id: priority-scorer
        module: tasksrunner_torch.service:make_app
        secrets:                      # name -> value | {env: VAR, default: ...}
          api-key: {env: SCORER_API_KEY}
        scale: {min_replicas: 1, max_replicas: 2, rules: [...]}

:func:`validate_manifest` returns the JAX package's problems, plus what
the port cannot run: an app module that is not a port app (its imports
are read with :mod:`ast`, its module never run, so that validating a
manifest of the JAX samples loads nothing of the JAX package), a
component type without a port driver and ``mesh_tls: true`` (ROADMAP
A22). A Resiliency document is no component: :func:`resolve_components`
wants exactly one component a file, as in the JAX package, so a deployed
caller's policies live in its own resources directory.
"""

from __future__ import annotations

import ast
import pathlib
import sys
from dataclasses import asdict, dataclass, field

from tasksrunner_torch.component import blockyaml
from tasksrunner_torch.component.loader import load_component_file
from tasksrunner_torch.component.registry import registered_types
from tasksrunner_torch.component.spec import ComponentSpec
from tasksrunner_torch.errors import ComponentError

INGRESS_MODES = ("external", "internal", "none")
#: top-level packages a port app must not import
_NOT_PORT = ("tasksrunner", "jax", "jaxlib")


@dataclass
class ComponentRef:
    name: str
    file: str


@dataclass
class AppManifest:
    app_id: str
    module: str
    app_port: int = 0
    sidecar_port: int = 0
    ingress: str = "internal"
    env: dict[str, str] = field(default_factory=dict)
    #: secret name -> a literal value or {"env": VAR[, "default": value]}
    secrets: dict[str, object] = field(default_factory=dict)
    min_replicas: int = 1
    max_replicas: int = 1
    scale_rules: list[dict] = field(default_factory=list)
    cooldown_seconds: float = 5.0
    #: the liveness probe block of the run file; None = its defaults
    health: object = None
    #: the app's component grants; None = unrestricted
    grants: dict | None = None


@dataclass
class EnvironmentManifest:
    name: str
    apps: list[AppManifest]
    components: list[ComponentRef] = field(default_factory=list)
    registry_file: str = ".tasksrunner/apps.json"
    #: ``apply`` refuses to write a run file unless TASKSRUNNER_API_TOKEN
    #: is set, and the run file carries the demand on
    require_api_token: bool = False
    #: one token per app at run time, carried into the run file
    per_app_tokens: bool = False
    #: mutual TLS on the sidecar mesh: not ported (ROADMAP A22)
    mesh_tls: bool = False
    source_path: pathlib.Path | None = None

    @property
    def base_dir(self) -> pathlib.Path:
        return self.source_path.parent if self.source_path else pathlib.Path.cwd()


def load_manifest(path: str | pathlib.Path) -> EnvironmentManifest:
    path = pathlib.Path(path)
    try:
        docs = blockyaml.load_all(path.read_text(), str(path))
    except OSError as exc:
        raise ComponentError(f"cannot read manifest {path}: {exc}") from exc
    except ComponentError as exc:
        raise ComponentError(f"cannot parse manifest {path}: {exc}") from exc
    if len(docs) > 1:
        raise ComponentError(f"cannot parse manifest {path}: more than one document")
    doc = (docs[0] if docs else None) or {}

    env = doc.get("environment") or {}
    apps = []
    for raw in doc.get("apps") or []:
        if "app_id" not in raw or "module" not in raw:
            raise ComponentError(f"{path}: each app needs app_id and module")
        scale = raw.get("scale") or {}
        apps.append(AppManifest(
            app_id=str(raw["app_id"]),
            module=str(raw["module"]),
            app_port=int(raw.get("app_port", 0)),
            sidecar_port=int(raw.get("sidecar_port", 0)),
            ingress=str(raw.get("ingress", "internal")),
            env={str(k): str(v) for k, v in (raw.get("env") or {}).items()},
            secrets=dict(raw.get("secrets") or {}),
            min_replicas=int(scale.get("min_replicas", 1)),
            max_replicas=int(scale.get("max_replicas", 1)),
            scale_rules=list(scale.get("rules") or []),
            cooldown_seconds=float(scale.get("cooldown_seconds", 5.0)),
            health=raw.get("health"),
            grants=raw.get("grants")))

    components = [ComponentRef(name=str(c["name"]), file=str(c["file"]))
                  for c in doc.get("components") or []
                  if isinstance(c, dict) and "name" in c and "file" in c]

    return EnvironmentManifest(
        name=str(env.get("name", path.stem)),
        apps=apps,
        components=components,
        registry_file=str(env.get("registry_file", ".tasksrunner/apps.json")),
        require_api_token=bool(env.get("require_api_token", False)),
        per_app_tokens=bool(env.get("per_app_tokens", False)),
        mesh_tls=bool(env.get("mesh_tls", False)),
        source_path=path.resolve())


def resolve_components(manifest: EnvironmentManifest) -> list[ComponentSpec]:
    """Every component file the manifest names, loaded under the
    manifest's name for it."""
    specs: list[ComponentSpec] = []
    for ref in manifest.components:
        file_path = pathlib.Path(ref.file)
        if not file_path.is_absolute():
            file_path = manifest.base_dir / file_path
        loaded = load_component_file(file_path, name=ref.name)
        if len(loaded) != 1:
            raise ComponentError(f"component file {file_path} must hold exactly one document")
        specs.append(loaded[0])
    return specs


def _module_file(name: str) -> pathlib.Path | None:
    """The source file of module ``name`` on ``sys.path``, found without
    importing it or its packages (whose ``__init__`` may import anything)."""
    parts = name.split(".")
    for entry in sys.path:
        base = pathlib.Path(entry or ".").joinpath(*parts)
        for candidate in (base.with_name(base.name + ".py"), base / "__init__.py"):
            if candidate.is_file():
                return candidate
    return None


def _imported(path: pathlib.Path, module: str) -> list[str]:
    """The modules that ``path`` (module ``module``) imports, relative
    imports resolved against its package."""
    tree = ast.parse(path.read_text(), str(path))
    package = module if path.name == "__init__.py" else module.rpartition(".")[0]
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package.split(".")
                base = base[:len(base) - node.level + 1]
                prefix = ".".join(base)
                names.append(f"{prefix}.{node.module}" if node.module else prefix)
            elif node.module:
                names.append(node.module)
    return names


def port_app_problem(module_name: str) -> str | None:
    """Why ``module_name`` cannot be a port app, or None: it is found on
    ``sys.path`` (never imported), and neither it nor a module of its own
    top-level package that it imports, read with :mod:`ast`, imports the
    JAX package or JAX."""
    top = module_name.split(".")[0]
    seen: set[str] = set()
    todo = [module_name]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        path = _module_file(name)
        if path is None:
            if name == module_name:
                return f"module {module_name!r} not importable: No module named {name!r}"
            continue
        try:
            imported = _imported(path, name)
        except (OSError, SyntaxError, ValueError) as exc:
            return f"module {module_name!r} not importable: {exc}"
        for dep in imported:
            if dep.split(".")[0] in _NOT_PORT:
                return (f"module {module_name!r} is not a tasksrunner_torch app "
                        f"({name} imports {dep}); run it with the JAX package's host")
            if dep.split(".")[0] == top and top != "tasksrunner_torch":
                todo.append(dep)
    return None


def validate_manifest(manifest: EnvironmentManifest) -> list[str]:
    """The manifest's problems (empty: valid)."""
    from tasksrunner_torch.orchestrator.config import parse_health
    from tasksrunner_torch.security import AppGrants

    problems: list[str] = []
    if not manifest.apps:
        problems.append("manifest declares no apps")

    seen_ids: set[str] = set()
    seen_ports: dict[int, str] = {}
    for app in manifest.apps:
        where = f"app {app.app_id!r}"
        if app.app_id in seen_ids:
            problems.append(f"duplicate app_id {app.app_id!r}")
        seen_ids.add(app.app_id)
        if app.ingress not in INGRESS_MODES:
            problems.append(f"{where}: ingress must be one of {INGRESS_MODES}")
        if app.min_replicas < 1:
            problems.append(f"{where}: min_replicas must be >= 1 "
                            "(scale-to-zero starves cron/input bindings)")
        if app.max_replicas < app.min_replicas:
            problems.append(f"{where}: max_replicas < min_replicas")
        if app.health is not None:
            try:
                parse_health(app.health)
            except ComponentError as exc:
                problems.append(f"{where}: {exc}")
        for port in (app.app_port, app.sidecar_port):
            if port:
                if port in seen_ports:
                    problems.append(f"{where}: port {port} already used by {seen_ports[port]}")
                seen_ports[port] = app.app_id
        problem = port_app_problem(app.module.partition(":")[0])
        if problem:
            problems.append(f"{where}: {problem}")

    try:
        specs = resolve_components(manifest)
    except ComponentError as exc:
        problems.append(str(exc))
        specs = []

    known = set(registered_types())
    comp_names = set()
    for spec in specs:
        comp_names.add(spec.name)
        if spec.type not in known:
            problems.append(f"component {spec.name!r}: no driver for type {spec.type!r}")
        for scope in spec.scopes:
            if scope not in seen_ids:
                problems.append(f"component {spec.name!r}: scope {scope!r} matches no app")

    for app in manifest.apps:
        for rule in app.scale_rules:
            comp = (rule.get("metadata") or {}).get("component")
            if comp and comp not in comp_names:
                problems.append(f"app {app.app_id!r}: scale rule references unknown "
                                f"component {comp!r}")
        if app.grants is not None:
            try:
                parsed = AppGrants.parse(app.grants, app_id=app.app_id)
            except ComponentError as exc:
                problems.append(str(exc))
            else:
                for comp in parsed.components:
                    if comp not in comp_names:
                        problems.append(f"app {app.app_id!r}: grant references unknown "
                                        f"component {comp!r}")
    if manifest.mesh_tls:
        problems.append("mesh_tls is not ported yet (ROADMAP A22)")
    return problems


def desired_state(manifest: EnvironmentManifest) -> dict:
    """The manifest in canonical JSON form: what what-if diffs."""
    specs = resolve_components(manifest)
    return {
        "environment": manifest.name,
        "components": {
            s.name: {
                "type": s.type,
                "version": s.version,
                "metadata": {k: (v if isinstance(v, str) else
                                 {"secretRef": v.key, "store": v.store})
                             for k, v in s.metadata.items()},
                "scopes": sorted(s.scopes),
            }
            for s in specs
        },
        "apps": {a.app_id: {k: v for k, v in asdict(a).items() if k != "app_id"}
                 for a in manifest.apps},
    }
