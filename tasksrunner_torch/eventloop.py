"""The optional uvloop loop policy of the long-running commands: the port
of ``tasksrunner/eventloop.py``.

uvloop is no dependency: with ``TASKSRUNNER_UVLOOP=1`` and no uvloop
installed, :func:`maybe_enable_uvloop` logs a warning and the command
runs on asyncio's own loop, as the JAX flag is documented to do.
``host``, ``serve``, ``sidecar`` and ``run`` call it before their loop
starts.
"""

from __future__ import annotations

import asyncio
import logging

from tasksrunner_torch.envflag import env_flag

logger = logging.getLogger(__name__)


def maybe_enable_uvloop() -> bool:
    """Install uvloop's loop policy when ``TASKSRUNNER_UVLOOP`` is on and
    uvloop imports; True when installed. Call it before ``asyncio.run``."""
    if not env_flag("TASKSRUNNER_UVLOOP", default=False):
        return False
    try:
        import uvloop
    except ImportError:
        logger.warning("TASKSRUNNER_UVLOOP is set but uvloop is not installed; "
                       "continuing on the default asyncio event loop")
        return False
    asyncio.set_event_loop_policy(uvloop.EventLoopPolicy())
    logger.info("uvloop event-loop policy installed")
    return True


def uvloop_available() -> bool:
    """True when uvloop can be imported."""
    try:
        import uvloop  # noqa: F401
    except ImportError:
        return False
    return True
