"""CloudEvents 1.0 envelope helpers: the port of
``tasksrunner/cloudevents.py``.

Publishing wraps a payload in an envelope; the subscriber's side unwraps
it (``Request.data``), and a raw payload passes through untouched when
the content type is not ``application/cloudevents+json``.
"""

from __future__ import annotations

import json
import time
from typing import Any

from tasksrunner_torch.ids import hex16

CONTENT_TYPE = "application/cloudevents+json"


def wrap(data: Any, *, source: str, topic: str, pubsub_name: str) -> dict:
    return {
        "specversion": "1.0",
        "id": hex16(),
        "source": source,
        "type": "com.tasksrunner.event.sent",
        "time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "datacontenttype": "application/json",
        "topic": topic,
        "pubsubname": pubsub_name,
        "data": data,
    }


def is_cloudevent(doc: Any) -> bool:
    return isinstance(doc, dict) and "specversion" in doc and "data" in doc


def unwrap(body: bytes, content_type: str | None) -> Any:
    """The inner data if ``body`` is a CloudEvent, else the JSON-decoded
    body (or the raw bytes when it is not JSON).

    A content type, when present, decides: a payload delivered as
    ``application/json`` is never unwrapped, even if it looks like an
    envelope. Only without one is the shape sniffed.
    """
    try:
        doc = json.loads(body)
    except (ValueError, UnicodeDecodeError):
        return body
    if content_type is not None:
        if content_type.startswith(CONTENT_TYPE):
            return doc.get("data") if isinstance(doc, dict) else doc
        return doc
    if is_cloudevent(doc):
        return doc.get("data")
    return doc
