"""Bindings: the port of ``tasksrunner/bindings/`` (the contract in
``base``; the sqlite queue, input and output, in ``localqueue``; the
cron schedule in ``cron``; the blob store in ``blobstore``; the mail
outbox in ``email``)."""

from tasksrunner_torch.bindings.base import (
    BindingEvent, BindingResponse, InputBinding, OutputBinding,
)
from tasksrunner_torch.bindings.blobstore import LocalBlobStoreBinding
from tasksrunner_torch.bindings.cron import CronBinding, CronSchedule
from tasksrunner_torch.bindings.email import EmailOutboxBinding
from tasksrunner_torch.bindings.localqueue import LocalQueueBinding, SqliteQueue

__all__ = [
    "BindingEvent",
    "BindingResponse",
    "CronBinding",
    "CronSchedule",
    "EmailOutboxBinding",
    "InputBinding",
    "LocalBlobStoreBinding",
    "LocalQueueBinding",
    "OutputBinding",
    "SqliteQueue",
]
