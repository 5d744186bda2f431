"""App-id name resolution for service invocation: the port of
``tasksrunner/invoke/resolver.py``.

The registry is a JSON file that every local sidecar shares: each
registers its replica at start and removes it at stop, and a peer
re-reads the file when it changes or misses an app. Entries have the JAX
registry's fields, so sidecars of either package share one file. A
registry without a file is a table in memory.
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile
import time
from dataclasses import asdict, dataclass

from tasksrunner_torch.errors import AppNotFound


@dataclass
class AppAddress:
    app_id: str
    host: str
    sidecar_port: int
    app_port: int | None = None
    pid: int | None = None
    registered_at: float = 0.0
    #: the JAX sidecar's framed peer port; the port's sidecars speak HTTP only
    mesh_port: int | None = None


def _pid_started_at(pid: int) -> float | None:
    """When the process holding ``pid`` started (unix time, from /proc),
    or None where that cannot be read."""
    try:
        stat = pathlib.Path(f"/proc/{pid}/stat").read_bytes()
        # the fields after comm's closing ')': starttime is field 22
        ticks = int(stat[stat.rindex(b")") + 2:].split()[19])
        for line in pathlib.Path("/proc/stat").read_text().splitlines():
            if line.startswith("btime "):
                return int(line.split()[1]) + ticks / os.sysconf("SC_CLK_TCK")
        return None
    except (OSError, ValueError, IndexError):
        return None


def _same_replica(a: dict, b: dict) -> bool:
    """One replica is one (pid, sidecar port): several runtimes may
    share a process."""
    return a.get("pid") == b.get("pid") and a.get("sidecar_port") == b.get("sidecar_port")


class NameResolver:
    """app id → its replicas' addresses, handed out round robin."""

    def __init__(self, *, registry_file: str | pathlib.Path | None = None) -> None:
        self.registry_file = pathlib.Path(registry_file) if registry_file else None
        #: the replicas registered without a file
        self._static: dict[str, list[AppAddress]] = {}
        self._cache: dict[str, list[AppAddress]] = {}
        self._rr: dict[str, int] = {}
        self._mtime = 0.0

    # -- registration (blocking: async callers use asyncio.to_thread) -----

    def register(self, addr: AppAddress) -> None:
        """Add ``addr`` to its app's replicas, replacing an earlier entry
        of the same replica."""
        addr.registered_at = time.time()
        if addr.pid is None:
            addr.pid = os.getpid()
        doc = asdict(addr)
        if self.registry_file is None:
            replicas = self._static.setdefault(addr.app_id, [])
            replicas[:] = [a for a in replicas if not _same_replica(asdict(a), doc)] + [addr]
            return

        def mutate(entries: dict) -> None:
            entries[addr.app_id] = [e for e in entries.get(addr.app_id) or []
                                    if not _same_replica(e, doc)] + [doc]

        self._mutate(mutate)

    def unregister(self, app_id: str, *, pid: int | None = None,
                   sidecar_port: int | None = None) -> None:
        """Remove one replica's entry (by pid, narrowed by sidecar port),
        or every entry of the app when ``pid`` is None."""
        def keep(e: dict) -> bool:
            if pid is None:
                return False
            if e.get("pid") != pid:
                return True
            return sidecar_port is not None and e.get("sidecar_port") != sidecar_port

        if self.registry_file is None:
            replicas = [a for a in self._static.get(app_id, ()) if keep(asdict(a))]
            if replicas:
                self._static[app_id] = replicas
            else:
                self._static.pop(app_id, None)
            return

        def mutate(entries: dict) -> None:
            replicas = [e for e in entries.get(app_id) or [] if keep(e)]
            if replicas:
                entries[app_id] = replicas
            else:
                entries.pop(app_id, None)

        self._mutate(mutate)

    @staticmethod
    def local_pid_dead(host: str | None, pid: int | None,
                       registered_at: float | None = None) -> bool:
        """True when an entry of this host names a pid that no longer
        exists, or one now held by a process born after the entry was
        registered (a recycled pid)."""
        if host not in ("127.0.0.1", "localhost") or not pid or pid == os.getpid():
            return False
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        except PermissionError:  # exists, owned by someone else
            return False
        if registered_at:
            started = _pid_started_at(pid)
            # 2 s of slack: /proc's boot time is whole seconds
            if started is not None and started > registered_at + 2.0:
                return True
        return False

    def prune_dead_local(self) -> list[tuple[str, int]]:
        """Remove this host's entries whose process is gone (what a
        killed replica leaves behind); returns the (app id, pid) pairs."""
        dead: list[tuple[str, int]] = []

        def live(app_id: str, entries: list[dict]) -> list[dict]:
            kept = []
            for e in entries:
                if self.local_pid_dead(e.get("host"), e.get("pid"), e.get("registered_at")):
                    dead.append((app_id, e.get("pid")))
                else:
                    kept.append(e)
            return kept

        if self.registry_file is None:
            for app_id, replicas in list(self._static.items()):
                kept = live(app_id, [asdict(a) for a in replicas])
                if kept:
                    self._static[app_id] = [AppAddress(**e) for e in kept]
                else:
                    self._static.pop(app_id)
            return dead

        def mutate(entries: dict) -> None:
            for app_id, replicas in list(entries.items()):
                kept = live(app_id, replicas)
                if kept:
                    entries[app_id] = kept
                else:
                    entries.pop(app_id)

        self._mutate(mutate)
        self._mtime = 0.0  # re-read on the next resolve
        return dead

    def _mutate(self, fn) -> None:
        """Read, change and write the file under a lock file (across
        processes); a lock older than 5 s is taken over once."""
        assert self.registry_file is not None
        self.registry_file.parent.mkdir(parents=True, exist_ok=True)
        lock = self.registry_file.with_suffix(".lock")
        deadline = time.time() + 5.0
        while True:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                break
            except FileExistsError:
                if time.time() > deadline:
                    lock.unlink(missing_ok=True)
                    deadline = time.time() + 5.0
                time.sleep(0.01)
        try:
            entries = self._read_file()
            fn(entries)
            tmp_fd, tmp_path = tempfile.mkstemp(dir=self.registry_file.parent)
            with os.fdopen(tmp_fd, "w") as f:
                json.dump(entries, f, indent=2)
            os.replace(tmp_path, self.registry_file)
        finally:
            os.close(fd)
            lock.unlink(missing_ok=True)

    def _read_file(self) -> dict[str, list[dict]]:
        if self.registry_file is None or not self.registry_file.is_file():
            return {}
        try:
            raw = json.loads(self.registry_file.read_text() or "{}")
        except ValueError:
            return {}
        # an older layout kept one entry per app rather than a list
        return {app_id: entry if isinstance(entry, list) else [entry]
                for app_id, entry in raw.items()}

    # -- resolution --------------------------------------------------------

    def _refresh(self) -> None:
        if self.registry_file is None:
            return
        try:
            mtime = self.registry_file.stat().st_mtime
        except OSError:
            return
        if mtime == self._mtime:
            return
        self._mtime = mtime
        self._cache = {app_id: [AppAddress(**e) for e in entries]
                       for app_id, entries in self._read_file().items()}

    def resolve_all(self, app_id: str) -> list[AppAddress]:
        """Every registered replica of the app (possibly none)."""
        if app_id in self._static:
            return list(self._static[app_id])
        self._refresh()
        if app_id not in self._cache:
            self._mtime = 0.0  # the peer may have registered this instant
            self._refresh()
        return list(self._cache.get(app_id, ()))

    def known_apps(self) -> list[str]:
        """Every app id with a registered replica."""
        self._refresh()
        return sorted({*self._static, *self._cache})

    def resolve(self, app_id: str) -> AppAddress:
        replicas = self.resolve_all(app_id)
        if not replicas:
            known = sorted({*self._static, *self._cache})
            raise AppNotFound(f"no app registered with id {app_id!r} (known: {known})")
        i = self._rr.get(app_id, 0)
        self._rr[app_id] = (i + 1) % (1 << 30)
        return replicas[i % len(replicas)]
