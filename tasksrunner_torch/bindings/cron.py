"""The cron input binding and its schedule engine: the port of
``tasksrunner/bindings/cron.py``.

It stands in for the reference's ``bindings.cron`` component (schedule
``5 0 * * *``): on each fire the runtime POSTs an empty event to the app
route named after the component. Fields: minute, hour, day of month,
month, day of week. ``*``, lists, ranges, steps (``*/15``, ``1-30/5``,
``N/step`` from N to the end), month and day names, 7 as Sunday, and
the standard rule that a schedule restricting both day fields fires on
either. A six-field expression is accepted only with a seconds field of
``0``; ``@every 5s`` (``ms``, ``s``, ``m``, ``h``) fires at a fixed
interval. The calendar is the local clock's.
"""

from __future__ import annotations

import asyncio
import datetime as dt
import logging

from tasksrunner_torch.bindings.base import BindingEvent, EventSink, InputBinding
from tasksrunner_torch.component.registry import driver
from tasksrunner_torch.component.spec import ComponentSpec
from tasksrunner_torch.errors import BindingError

logger = logging.getLogger(__name__)

_MONTHS = {m: i + 1 for i, m in enumerate(
    "jan feb mar apr may jun jul aug sep oct nov dec".split())}
_DOWS = {d: i for i, d in enumerate("sun mon tue wed thu fri sat".split())}

_BOUNDS = {  # field -> (min, max)
    "minute": (0, 59),
    "hour": (0, 23),
    "dom": (1, 31),
    "month": (1, 12),
    "dow": (0, 6),
}


def _parse_field(expr: str, field: str) -> tuple[set[int], bool]:
    """(the values the field allows, whether it was ``*``)."""
    lo, hi = _BOUNDS[field]
    names = _MONTHS if field == "month" else _DOWS if field == "dow" else {}

    def atom(tok: str) -> int:
        tok = tok.strip().lower()
        if tok in names:
            return names[tok]
        try:
            v = int(tok)
        except ValueError:
            raise BindingError(f"bad cron {field} value {tok!r}") from None
        if field == "dow" and v == 7:  # both 0 and 7 mean Sunday
            v = 0
        if not (lo <= v <= hi):
            raise BindingError(f"cron {field} value {v} out of range {lo}-{hi}")
        return v

    allowed: set[int] = set()
    wildcard = expr.strip() == "*"
    for part in expr.split(","):
        part = part.strip()
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            try:
                step = int(step_s)
            except ValueError:
                raise BindingError(f"bad cron step {step_s!r}") from None
            if step <= 0:
                raise BindingError(f"cron step must be positive, got {step}")
        if part in ("*", ""):
            start, end = lo, hi
        elif "-" in part and not part.lstrip("-").isdigit():
            a, b = part.split("-", 1)
            start, end = atom(a), atom(b)
            if end < start:
                raise BindingError(f"inverted cron range {part!r} in {field}")
        else:
            start = end = atom(part)
            if "/" in expr and step > 1 and part != "*":
                end = hi  # "N/step" starts at N
        allowed.update(range(start, end + 1, step))
    return allowed, wildcard


def _parse_duration(spec: str) -> float:
    units = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0}
    for suffix in ("ms", "s", "m", "h"):
        if spec.endswith(suffix):
            try:
                return float(spec[: -len(suffix)]) * units[suffix]
            except ValueError:
                break
    raise BindingError(f"bad @every duration {spec!r} (want e.g. 500ms, 5s, 2m, 1h)")


class CronSchedule:
    """A parsed cron expression that finds its next fire time."""

    def __init__(self, expr: str) -> None:
        self.expr = expr.strip()
        self.interval: float | None = None
        if self.expr.startswith("@every"):
            _, _, spec = self.expr.partition(" ")
            self.interval = _parse_duration(spec.strip())
            return
        fields = self.expr.split()
        if len(fields) == 6:
            # minute granularity: a seconds field other than "0" would
            # change the schedule without a word
            if fields[0] != "0":
                raise BindingError(
                    f"sub-minute cron schedules are not supported "
                    f"(seconds field {fields[0]!r} in {self.expr!r}); "
                    "use '@every Ns' for sub-minute cadence")
            fields = fields[1:]
        if len(fields) != 5:
            raise BindingError(
                f"cron expression needs 5 fields (minute hour dom month dow), got {self.expr!r}")
        self.minutes, _ = _parse_field(fields[0], "minute")
        self.hours, _ = _parse_field(fields[1], "hour")
        self.doms, self.dom_wild = _parse_field(fields[2], "dom")
        self.months, _ = _parse_field(fields[3], "month")
        self.dows, self.dow_wild = _parse_field(fields[4], "dow")

    def matches(self, t: dt.datetime) -> bool:
        if self.interval is not None:
            raise BindingError("@every schedules have no calendar match")
        if t.minute not in self.minutes or t.hour not in self.hours:
            return False
        if t.month not in self.months:
            return False
        dom_ok = t.day in self.doms
        dow_ok = ((t.weekday() + 1) % 7) in self.dows  # Python's Monday 0 → cron's Sunday 0
        if not self.dom_wild and not self.dow_wild:
            return dom_ok or dow_ok  # both restricted: either fires
        return dom_ok and dow_ok

    def next_after(self, t: dt.datetime) -> dt.datetime:
        """The first fire time after ``t``, to the minute."""
        if self.interval is not None:
            return t + dt.timedelta(seconds=self.interval)
        candidate = t.replace(second=0, microsecond=0) + dt.timedelta(minutes=1)
        # four years cover any 5-field expression that ever fires
        limit = candidate + dt.timedelta(days=1462)
        while candidate <= limit:
            if self.matches(candidate):
                return candidate
            candidate += dt.timedelta(minutes=1)
        raise BindingError(f"cron expression {self.expr!r} never fires")


class CronBinding(InputBinding):
    def __init__(self, name: str, schedule: str) -> None:
        super().__init__(name)
        self.schedule = CronSchedule(schedule)
        self._task: asyncio.Task | None = None

    async def start(self, sink: EventSink) -> None:
        async def loop() -> None:
            while True:
                now = dt.datetime.now()
                if self.schedule.interval is not None:
                    delay = self.schedule.interval
                else:
                    delay = (self.schedule.next_after(now) - now).total_seconds()
                await asyncio.sleep(max(delay, 0.0))
                try:
                    await sink(BindingEvent(binding=self.name, data=None,
                                            metadata={"schedule": self.schedule.expr}))
                except Exception:  # noqa: BLE001 - the next fire still comes
                    logger.exception("cron %s delivery failed", self.name)

        self._task = asyncio.create_task(loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None


@driver("bindings.cron")
def _cron_binding(spec: ComponentSpec, metadata: dict[str, str]) -> CronBinding:
    try:
        schedule = metadata["schedule"]
    except KeyError:
        raise BindingError(f"cron component {spec.name!r} needs schedule metadata") from None
    return CronBinding(spec.name, schedule)
