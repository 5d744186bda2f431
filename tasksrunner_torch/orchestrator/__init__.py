"""The orchestrator of the port's apps: the port of
``tasksrunner/orchestrator/`` (run files, supervision and liveness,
autoscaling, the placement loop, the control-plane lease and the admin
API), run by ``python -m tasksrunner_torch run``."""

from tasksrunner_torch.orchestrator.autoscale import AutoscaleController, read_backlog
from tasksrunner_torch.orchestrator.config import AppSpec, RunConfig, ScaleRule, load_run_config
from tasksrunner_torch.orchestrator.run import Orchestrator

__all__ = ["AppSpec", "RunConfig", "ScaleRule", "load_run_config", "AutoscaleController",
           "read_backlog", "Orchestrator"]
