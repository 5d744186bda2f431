"""Component files from a resources directory: the port of
``tasksrunner/component/loader.py``, reading YAML with
:mod:`~tasksrunner_torch.component.blockyaml` instead of PyYAML.

Resiliency and Chaos documents share the resources directory in the JAX
package, which loads them elsewhere. The port has neither yet, so a
``kind: Resiliency`` or ``kind: Chaos`` document is refused with a
:class:`~tasksrunner_torch.errors.ComponentError` rather than skipped:
a policy that a user wrote must never be ignored without a word.
"""

from __future__ import annotations

import pathlib
from typing import Any, Mapping

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
        if is_resiliency_doc(doc) or is_chaos_doc(doc):
            raise ComponentError(
                f"{path}: kind: {doc['kind']} documents are not ported yet; "
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
