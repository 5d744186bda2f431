"""Component documents, their loader and the driver registry: the port
of ``tasksrunner/component/``."""

from tasksrunner_torch.component.loader import load_component_file, load_components
from tasksrunner_torch.component.registry import ComponentRegistry, driver
from tasksrunner_torch.component.spec import ComponentSpec, parse_component

__all__ = ["ComponentRegistry", "ComponentSpec", "driver", "load_component_file",
           "load_components", "parse_component"]
