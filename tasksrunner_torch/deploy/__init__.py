"""Environment manifests, the port of ``tasksrunner/deploy/``:
``python -m tasksrunner_torch deploy validate|what-if|apply|down MANIFEST``."""

from tasksrunner_torch.deploy.manifest import (
    AppManifest, EnvironmentManifest, load_manifest, validate_manifest,
)
from tasksrunner_torch.deploy.plan import apply_manifest, destroy, what_if

__all__ = ["AppManifest", "EnvironmentManifest", "apply_manifest", "destroy", "load_manifest",
           "validate_manifest", "what_if"]
