"""The secret-store building block: the port of ``tasksrunner/secrets/``."""

from tasksrunner_torch.secrets.base import SecretStore
from tasksrunner_torch.secrets.local import EnvSecretStore, FileSecretStore, StaticSecretStore
from tasksrunner_torch.secrets.resolver import SecretResolver

__all__ = ["EnvSecretStore", "FileSecretStore", "SecretResolver", "SecretStore",
           "StaticSecretStore"]
