"""The orchestrator of the port's apps: the port of
``tasksrunner/orchestrator/`` (run files, supervision and liveness,
autoscaling, the control-plane lease and the admin API), run by
``python -m tasksrunner_torch run``. The placement loop is not ported
(ROADMAP A20)."""

from tasksrunner_torch.orchestrator.autoscale import AutoscaleController, read_backlog
from tasksrunner_torch.orchestrator.config import AppSpec, RunConfig, ScaleRule, load_run_config
from tasksrunner_torch.orchestrator.run import Orchestrator

__all__ = ["AppSpec", "RunConfig", "ScaleRule", "load_run_config", "AutoscaleController",
           "read_backlog", "Orchestrator"]
