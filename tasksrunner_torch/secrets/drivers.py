"""The secret-store drivers: the port of ``tasksrunner/secrets/drivers.py``.
``secretstores.azure.keyvault`` is an alias of the environment store, so
the reference's Key Vault component file loads unchanged."""

from __future__ import annotations

from tasksrunner_torch.component.registry import driver
from tasksrunner_torch.component.spec import ComponentSpec
from tasksrunner_torch.secrets.local import EnvSecretStore, FileSecretStore, StaticSecretStore


@driver("secretstores.local.env", "secretstores.azure.keyvault")
def _env_secret_store(spec: ComponentSpec, metadata: dict[str, str]) -> EnvSecretStore:
    return EnvSecretStore(spec.name, prefix=metadata.get("prefix", ""))


@driver("secretstores.local.file")
def _file_secret_store(spec: ComponentSpec, metadata: dict[str, str]) -> FileSecretStore:
    return FileSecretStore(spec.name, metadata["secretsFile"],
                           nested_separator=metadata.get("nestedSeparator", ":"))


@driver("secretstores.local.static")
def _static_secret_store(spec: ComponentSpec, metadata: dict[str, str]) -> StaticSecretStore:
    return StaticSecretStore(spec.name, metadata)
