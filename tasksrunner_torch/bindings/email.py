"""Mail as an output binding, written to an outbox directory: the port
of ``tasksrunner/bindings/email.py``.

It stands in for ``bindings.twilio.sendgrid`` (and ``bindings.smtp``):
the reference's processor sends task notifications with
``invoke_binding("sendgrid", "create", body, {emailTo, emailToName,
subject})``. Each ``create`` writes one JSON document to the outbox
(``{id}.json``: from, to, toName, subject, body, sentAt), where a test or
a person reads what was "sent". The component's ``apiKey`` (a secret ref
in the reference's file) is resolved by the registry and not used.
"""

from __future__ import annotations

import asyncio
import json
import os
import pathlib
import time
import uuid
from typing import Any

from tasksrunner_torch.bindings.base import BindingResponse, OutputBinding
from tasksrunner_torch.component.registry import driver
from tasksrunner_torch.component.spec import ComponentSpec
from tasksrunner_torch.errors import BindingError


def _write_mail(path: str, payload: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(payload)


class EmailOutboxBinding(OutputBinding):
    def __init__(self, name: str, outbox: str | pathlib.Path, *,
                 default_from: str = "") -> None:
        super().__init__(name)
        self.outbox = pathlib.Path(outbox)
        self.outbox.mkdir(parents=True, exist_ok=True)
        self.default_from = default_from

    async def invoke(self, operation: str, data: Any,
                     metadata: dict[str, str] | None = None) -> BindingResponse:
        if operation != "create":
            raise BindingError(f"email binding supports only create, not {operation!r}")
        metadata = metadata or {}
        to = metadata.get("emailTo")
        if not to:
            raise BindingError("email create requires emailTo metadata")
        mail_id = str(uuid.uuid4())
        doc = {
            "id": mail_id,
            "from": metadata.get("emailFrom", self.default_from),
            "to": to,
            "toName": metadata.get("emailToName", ""),
            "subject": metadata.get("subject", ""),
            "body": data if isinstance(data, str) else json.dumps(data),
            "sentAt": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        }
        # os.path on the per-send path, as in blobstore; the write off the loop
        await asyncio.get_running_loop().run_in_executor(
            None, _write_mail, os.path.join(str(self.outbox), f"{mail_id}.json"),
            json.dumps(doc, indent=2))
        return BindingResponse(metadata={"mailId": mail_id})


@driver("bindings.smtp", "bindings.twilio.sendgrid")
def _email_binding(spec: ComponentSpec, metadata: dict[str, str]) -> EmailOutboxBinding:
    """``outboxPath`` (``.tasksrunner/outbox``), ``emailFrom``."""
    return EmailOutboxBinding(spec.name, metadata.get("outboxPath", ".tasksrunner/outbox"),
                              default_from=metadata.get("emailFrom", ""))
