"""The errors of the port: the part of ``tasksrunner/errors.py`` the
scorer, its runtime, its sidecar, its bindings, its actors and its
workflows raise.

Every error below :class:`TasksRunnerError` carries the HTTP status the
sidecar answers it with (:attr:`TasksRunnerError.http_status`), as in the
JAX package; anything else is a 500.
"""

from __future__ import annotations


class TasksRunnerError(Exception):
    """Base class of the port's runtime errors."""

    #: the status the sidecar maps this error to
    http_status = 500


class ValidationError(TasksRunnerError):
    """A request's input is malformed."""

    http_status = 400


class ComponentError(TasksRunnerError):
    """A component file or definition is malformed, or uses a part the
    port does not have."""

    http_status = 400


class ComponentNotFound(TasksRunnerError):
    """No component of that name is registered or in scope."""

    http_status = 400


class PermissionDenied(TasksRunnerError):
    """The app's grants do not allow this operation on this component."""

    http_status = 403


class DriverNotFound(ComponentError):
    """No driver is registered for a component's ``type``."""


class SecretError(TasksRunnerError):
    """A secret store or a secret reference failed."""

    http_status = 500


class SecretNotFound(SecretError):
    """The store holds no secret of that name."""

    http_status = 404


class StateError(TasksRunnerError):
    http_status = 500


class EtagMismatch(StateError):
    """Optimistic-concurrency conflict on a state write."""

    http_status = 409


class CrossShardAtomicityError(StateError):
    """A cross-shard transaction committed on one or more shards before a
    later shard's commit failed: the committed shards cannot be rolled
    back (two-phase commit without a coordinator log). The message names
    the split; the repair is to re-read the keys. A failure while
    staging, or on the first commit, raises the original error instead."""

    http_status = 500


class ReplicationError(StateError):
    """A replica set's operation failed (:mod:`tasksrunner_torch.state.replication`)."""

    http_status = 500


class NotLeaderError(ReplicationError):
    """No member holds the shard's lease, or leadership moved during the
    call. Nothing was attempted; the caller finds the leader again and
    retries (the replica set's facade does so once)."""

    http_status = 409


class ReplicaFencedError(ReplicationError):
    """A leader's commit refused by epoch fencing: a follower promoted at
    a higher epoch, so the old leader's record cannot reach its quorum
    and the write was never acknowledged."""

    http_status = 409


class ReplicationQuorumError(ReplicationError):
    """A write did not reach its ``ackQuorum`` within the ack timeout. It
    is committed on the leader, its durability on the followers unknown:
    the caller treats it as not acknowledged (a retry is safe)."""

    http_status = 503


class ReplicationGapError(ReplicationError):
    """A follower's answer to records that do not extend its log (a
    ``seq`` past ``hwm + 1``, or a fenced ex-leader's ``diverged``
    suffix): the leader catches it up from ``hwm``, or by a snapshot.
    Never reaches a caller of the state API."""

    def __init__(self, message: str, *, hwm: int, diverged: bool = False) -> None:
        super().__init__(message)
        self.hwm = hwm
        self.diverged = diverged


class StaleReadError(ReplicationError):
    """A read addressed to a follower that lags past ``maxLagRecords``
    (the facade's own follower reads go to the leader instead)."""

    http_status = 503


class PlacementEpochError(StateError):
    """A state request named a routing epoch that is not the store's
    placement epoch (:mod:`tasksrunner_torch.state.placement`). Nothing
    was attempted; the sidecar's 409 carries :attr:`current_epoch` in the
    ``x-tasksrunner-placement-epoch`` header, so the caller refreshes its
    map and retries."""

    http_status = 409

    def __init__(self, message: str, *, current_epoch: int) -> None:
        super().__init__(message)
        self.current_epoch = int(current_epoch)


class QueryError(StateError):
    """A malformed state query (:mod:`tasksrunner_torch.state.query`), or
    a store without query support."""

    http_status = 400


class BindingError(TasksRunnerError):
    """A binding component or one of its operations failed."""

    http_status = 500


class SaturatedError(Exception):
    """The inference queue is full and this request was shed (429).

    :attr:`retry_after` holds the seconds the caller is asked to stay
    away, sent back as the ``Retry-After`` header."""

    http_status = 429
    #: seconds the server asks the caller to stay away, or None
    retry_after: float | None = None


class InvocationError(TasksRunnerError):
    """A call through the app's runtime client failed: the runtime was
    unreachable, or it answered a state, publish or invoke call with an
    error status (:attr:`status`; None when nothing answered).
    :attr:`retry_after` holds the seconds of a 429's or 503's
    ``Retry-After``, which a resiliency policy's next delay honours."""

    #: seconds the server asked the caller to stay away, or None
    retry_after: float | None = None

    def __init__(self, message: str, *, status: int | None = None) -> None:
        super().__init__(message)
        self.status = status


class CircuitOpenError(TasksRunnerError):
    """A resiliency circuit breaker is open: the call was refused without
    being tried. A 503, so that callers tell "the target is being
    protected" from a target's own 5xx."""

    http_status = 503


class AppNotFound(InvocationError):
    """Name resolution found no app of the target id."""

    http_status = 404


class ActorError(TasksRunnerError):
    """A virtual-actor operation failed (:mod:`tasksrunner_torch.actors`)."""

    http_status = 500


class ActorNotRegistered(ActorError):
    """The app hosts no handler for the requested actor type."""

    http_status = 404


class ActorFencedError(ActorError):
    """A turn's commit was refused by epoch fencing: a newer owner bumped
    the actor record's epoch (and so its etag), so this owner's commit,
    that of a zombie that lost its lease or crashed, did not land. The
    turn was not acknowledged; the caller retries against the new owner."""

    http_status = 409


class WorkflowError(TasksRunnerError):
    """A durable-workflow operation failed (:mod:`tasksrunner_torch.workflows`)."""

    http_status = 500


class WorkflowNotFound(WorkflowError):
    """No workflow instance, or no registered workflow of that name."""

    http_status = 404


class WorkflowNondeterminismError(WorkflowError):
    """Replay diverged from the recorded history: the orchestrator
    scheduled other work than the history records at a sequence number,
    or awaited something that is not a workflow task. The instance fails
    rather than run side effects again."""

    http_status = 500


class ActivityError(WorkflowError):
    """An activity used up its retry policy. Awaiting its task in the
    orchestrator raises this, so a saga can branch into compensation."""

    http_status = 500
