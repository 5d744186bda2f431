"""The errors of the port: the counterparts of
``tasksrunner.errors.SaturatedError`` (the serving plane sheds load) and
``InvocationError`` (a runtime call failed)."""

from __future__ import annotations


class SaturatedError(Exception):
    """The inference queue is full and this request was shed (429).

    :attr:`retry_after` holds the seconds the caller is asked to stay
    away, sent back as the ``Retry-After`` header."""

    http_status = 429
    #: seconds the server asks the caller to stay away, or None
    retry_after: float | None = None


class InvocationError(Exception):
    """A call through the app's runtime client failed: the runtime was
    unreachable, or it answered a state, publish or invoke call with an
    error status (:attr:`status`; None when nothing answered)."""

    def __init__(self, message: str, *, status: int | None = None) -> None:
        super().__init__(message)
        self.status = status
