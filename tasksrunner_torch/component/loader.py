"""Component files from a resources directory: the port of
``tasksrunner/component/loader.py``, reading YAML with
:mod:`~tasksrunner_torch.component.blockyaml` instead of PyYAML and
writing it with :func:`~tasksrunner_torch.component.blockyaml.dump_all`.

Resiliency and Chaos documents share the resources directory. A
``kind: Resiliency`` document is skipped here, as in the JAX package:
:func:`tasksrunner_torch.resiliency.load_resiliency` reads it. The port
has no chaos yet (ROADMAP A23), so a ``kind: Chaos`` document is refused
with a :class:`~tasksrunner_torch.errors.ComponentError` rather than
skipped: a policy that a user wrote is never ignored without a word.
"""

from __future__ import annotations

import pathlib
from typing import Any, Iterable, Mapping

from tasksrunner_torch.component import blockyaml
from tasksrunner_torch.component.spec import ComponentSpec, parse_component
from tasksrunner_torch.errors import ComponentError

_YAML_SUFFIXES = {".yaml", ".yml"}


def is_resiliency_doc(doc: Any) -> bool:
    return isinstance(doc, Mapping) and doc.get("kind") == "Resiliency"


def is_chaos_doc(doc: Any) -> bool:
    return isinstance(doc, Mapping) and doc.get("kind") == "Chaos"


def load_component_file(path: str | pathlib.Path, *, name: str | None = None) -> list[ComponentSpec]:
    """Every component in one file (``---`` may separate several)."""
    path = pathlib.Path(path)
    try:
        text = path.read_text()
    except OSError as exc:
        raise ComponentError(f"cannot read component file {path}: {exc}") from exc
    specs = []
    for doc in blockyaml.load_all(text, str(path)):
        if doc is None:
            continue
        if is_resiliency_doc(doc):
            continue  # tasksrunner_torch.resiliency reads it
        if is_chaos_doc(doc):
            raise ComponentError(
                f"{path}: kind: Chaos documents are not ported yet (ROADMAP A23); "
                "remove the file from the resources directory to run without it")
        specs.append(parse_component(doc, default_name=name or path.stem, source=str(path)))
    return specs


def load_components(resources_path: str | pathlib.Path, *,
                    app_id: str | None = None) -> list[ComponentSpec]:
    """Every component file under ``resources_path``; with ``app_id``,
    only the components in its scope. Two components of one name are an
    error: the name is what apps refer to."""
    root = pathlib.Path(resources_path)
    if not root.is_dir():
        raise ComponentError(f"resources path {root} is not a directory")
    specs: list[ComponentSpec] = []
    for path in sorted(root.iterdir()):
        if path.suffix.lower() in _YAML_SUFFIXES and path.is_file():
            specs.extend(load_component_file(path))
    seen: dict[str, ComponentSpec] = {}
    for spec in specs:
        if spec.name in seen:
            raise ComponentError(
                f"duplicate component name {spec.name!r} "
                f"({seen[spec.name].source} and {spec.source})")
        seen[spec.name] = spec
    if app_id is not None:
        specs = [s for s in specs if s.in_scope(app_id)]
    return specs


def dump_components(specs: Iterable[ComponentSpec]) -> str:
    """The specs as local-dialect YAML, a secret ref as a
    ``secretKeyRef`` to its key (what ``deploy apply`` writes)."""
    docs = []
    for s in specs:
        meta_items: list[dict] = []
        for key, value in s.metadata.items():
            if isinstance(value, str):
                meta_items.append({"name": key, "value": value})
            else:
                meta_items.append({"name": key,
                                   "secretKeyRef": {"name": value.key, "key": value.key}})
        doc: dict = {"apiVersion": "tasksrunner/v1", "kind": "Component",
                     "metadata": {"name": s.name},
                     "spec": {"type": s.type, "version": s.version, "metadata": meta_items}}
        if s.scopes:
            doc["scopes"] = list(s.scopes)
        if s.secret_store:
            doc["auth"] = {"secretStore": s.secret_store}
        docs.append(doc)
    return blockyaml.dump_all(docs)
