"""Every metric name the runtime records, with its help text: the port
of ``tasksrunner/observability/names.py``'s ``COUNTERS``, ``GAUGES``,
``HISTOGRAMS`` and ``ALL``, the same names and texts.

A name typed wrong, or used as a counter in one place and a gauge in
another, forks a series that dashboards and the autoscaler then read
differently. So every literal name passed to ``inc``, ``set_gauge``,
``observe`` or ``observe_many`` in the port is declared here
(``tests/test_torch_telemetry.py`` checks the source, as the JAX
package's metric-name lint checks its own), and
:func:`~tasksrunner_torch.metrics.render_prometheus` takes the ``# HELP``
texts from :data:`ALL`. Latency histograms name their unit
(``*_seconds``); the exposition derives ``_bucket``, ``_sum`` and
``_count`` from them.
"""

from __future__ import annotations

#: monotonically increasing event counts
COUNTERS: dict[str, str] = {
    "state_save": "state items written via the runtime",
    "state_get": "state point reads via the runtime",
    "state_delete": "state deletes via the runtime",
    "state_bulk_get": "keys fetched via bulk state reads",
    "state_query": "state query executions",
    "state_transact": "state transactions",
    "publish": "messages published",
    "pubsub_delivery": "pub/sub deliveries to app routes, by status",
    "binding_invoke": "output-binding invocations",
    "binding_delivery": "input-binding deliveries to app routes, by status",
    "invoke": "service invocations issued, by target app",
    "invoke_transport": "invocation attempts per transport lane (mesh/http)",
    "mesh_frames_total": "mesh frames moved, by direction (in/out)",
    "admission_shed_total": "requests shed with 429 by admission control",
    "chaos_injected_total": "faults injected by the chaos engine",
    "resiliency_retry_total": "resiliency-policy retry attempts",
    "resiliency_retry_exhausted_total": "retry budgets exhausted",
    "actor_turns_total": "actor turns executed, by type and status",
    "actor_reminder_fired_total": "durable reminders fired, by actor type",
    "actor_fenced_total": "zombie-owner commits rejected by epoch fencing",
    "actor_failover_total": "ownership acquisitions from a dead or expired owner",
    "repl_records_total": "replication records shipped to followers, per member",
    "ml_batches_total": "micro-batches executed by the inference plane, per bucket",
    "ml_shed_total": "inference submits shed because the batch queue was full",
    "repl_fenced_total": "shard-leader sessions fenced by an epoch bump",
    "repl_failover_total": "shard leadership takeovers (epoch > 1 acquisitions)",
    "placement_flips_total": "routing-epoch flips committed by fenced handoffs, per store",
    "placement_keys_moved_total": "keys streamed between shards by live migration/split, per store",
    "placement_stale_routes_total": "state requests 409-redirected for a stale routing epoch, per store",
    "workflow_started_total": "workflow instances started, by workflow",
    "workflow_completed_total": "workflow instances reaching a terminal status, by workflow and status",
    "workflow_activity_total": "workflow activity executions, by activity and status",
    "workflow_compensation_total": "saga compensations fired, by workflow",
    "workflow_replays_total": "orchestrator replays executed, by workflow",
}

#: point-in-time levels (the saturation probes live here)
GAUGES: dict[str, str] = {
    "uptime_seconds": "seconds since this registry was created",
    "admission_state": "admission controller state (0 admitting / 1 shedding)",
    "admission_saturation": "saturation score (>= 1.0 trips shedding)",
    "autoscale_desired_replicas": "replica count the autoscaler last computed",
    "resiliency_breaker_state": "circuit breaker state (0 closed/2 open)",
    "event_loop_lag_seconds": "asyncio timer drift sampled per process",
    "mesh_pool_connections": "live pooled mesh connections, per process",
    "state_write_queue_depth": "pending writes in the state group-commit queue",
    "broker_publish_queue_depth": "pending publishes in the broker write queue",
    "broker_dlq_depth": "dead-lettered messages per topic/group",
    "span_buffer_depth": "spans buffered in the recorder awaiting flush",
    "actor_owned": "actor activations this replica currently owns, per type",
    "repl_epoch": "current shard leadership epoch, per store and shard",
    "repl_follower_lag_records": "records a follower trails the leader by",
    "placement_epoch": "current routing-table epoch, per store",
    "shard_heat": "EWMA write rate (ops/s), per store and shard",
    "placement_pause_seconds": "write-pause length of the last fenced flip, per store",
    "ml_queue_depth": "inference requests waiting for micro-batch assembly",
    "ml_tokens_in_flight": "tokens queued or executing in the inference plane",
}

#: latency distributions (seconds); exposed as _bucket/_sum/_count
HISTOGRAMS: dict[str, str] = {
    "sidecar_request_latency_seconds": "sidecar HTTP API handling, per route",
    "invoke_latency_seconds": "service invocation client, per target app",
    "mesh_dial_latency_seconds": "mesh connection dial + codec negotiation",
    "mesh_frame_bytes": "mesh frame size on the wire, by direction (in/out)",
    "state_op_latency_seconds": "runtime state operations, per store and op",
    "state_queue_wait_seconds": "group-commit queue wait (enqueue to batch start)",
    "state_commit_seconds": "group-commit batch execution (begin to resolve)",
    "publish_latency_seconds": "pub/sub publish, per pubsub and topic",
    "delivery_latency_seconds": "pub/sub delivery to the app, per route",
    "binding_latency_seconds": "output-binding invocation, per binding and op",
    "binding_delivery_latency_seconds": "input-binding delivery, per binding",
    "actor_turn_latency_seconds": "actor turn execution, per actor type",
    "ml_batch_size": "assembled micro-batch size (before bucket padding)",
    "ml_queue_wait_seconds": "inference queue wait (submit to batch start), per bucket",
    "ml_infer_latency_seconds": "micro-batch device execution, per padding bucket",
    "workflow_activity_latency_seconds": "workflow activity execution, per activity",
    "workflow_history_events": "history length at workflow commit, per workflow",
}

ALL: dict[str, str] = {**COUNTERS, **GAUGES, **HISTOGRAMS}
