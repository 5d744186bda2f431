"""The orchestrator: process supervision, liveness probes, log
multiplexing and autoscaling of the port's apps, the port of
``tasksrunner/orchestrator/run.py``.

Each replica is a ``python -m tasksrunner_torch host <module>`` process
(the app and its sidecar in one process), on the card unless the
orchestrator is given a device (``--device cpu``). Replica 0 takes the
app's configured ports, the others free ones; each registers in the
registry file, so peers' invokes go round robin over the replicas, and
each competes on the shared broker file. The orchestrator

* reads each replica's ``ready app=… app_port=… sidecar_port=…`` line
  from its output, which it prints prefixed ``[app·index]`` and keeps
  the last 2000 lines of (``logs``);
* restarts a replica that exits, after a backoff (:data:`RESTART_BACKOFF`),
  and first removes the dead pid from the registry;
* kills a replica whose ``/healthz`` fails ``failure_threshold`` times in
  a row (probed over asyncio streams), so that it is restarted; it waits
  up to 60 s for the ready line before the first probe;
* scales each app with a scale block by its
  :class:`~tasksrunner_torch.orchestrator.autoscale.AutoscaleController`;
* with ``TASKSRUNNER_RESHARD`` on, sweeps each app's sharded stores by its
  :class:`~tasksrunner_torch.orchestrator.placement.PlacementController`;
* holds the control-plane lease (:class:`~tasksrunner_torch.state.lease.Lease`
  in ``<registry dir>/control-plane.db``, the JAX file and record), so
  one orchestrator runs per registry directory; a ``standby`` one waits
  for it and takes over when the holder dies, adopting the replicas the
  holder left running instead of respawning them;
* serves the admin API (:mod:`~tasksrunner_torch.orchestrator.admin`):
  status, logs, revisions, rolling restart, env and scale updates.

``mesh_tls`` is refused: not ported yet.
"""

from __future__ import annotations

import asyncio
import collections
import json
import logging
import os
import pathlib
import re
import secrets
import signal
import sys
import time
import uuid

import tasksrunner_torch
from tasksrunner_torch.client import TOKEN_ENV, http_request
from tasksrunner_torch.component.loader import load_components
from tasksrunner_torch.envflag import env_flag
from tasksrunner_torch.invoke.resolver import NameResolver
from tasksrunner_torch.orchestrator.autoscale import AutoscaleController
from tasksrunner_torch.orchestrator.config import AppSpec, RunConfig, not_ported
from tasksrunner_torch.orchestrator.placement import PlacementController
from tasksrunner_torch.security import GRANTS_ENV, TOKENS_FILE_ENV, hash_token

logger = logging.getLogger(__name__)

RESTART_BACKOFF = [0.2, 0.5, 1.0, 2.0, 5.0]
#: seconds a replica has to print its ready line before liveness probing
#: gives up on that incarnation
READY_TIMEOUT = 60.0
#: seconds a replica has to exit after SIGTERM before it is killed (the
#: JAX package waits 5; a replica on the card also tears down its CUDA
#: context, and its last log lines must not be cut off)
STOP_TIMEOUT = 15.0

#: printed by ``python -m tasksrunner_torch host`` once it serves
_READY_RE = re.compile(r"ready app=\S+ app_port=(\d+) sidecar_port=(\d+)")
#: the directory that holds the package, put on the replicas' PYTHONPATH
_PACKAGE_ROOT = str(pathlib.Path(tasksrunner_torch.__file__).resolve().parent.parent)


class _AdoptedProc:
    """The part of an asyncio subprocess a supervisor uses, around a
    replica a previous orchestrator spawned: this process cannot wait
    for it, so ``wait`` polls the registry's liveness predicate
    (:meth:`NameResolver.local_pid_dead`); a detected death reports -9."""

    def __init__(self, pid: int, registered_at: float | None) -> None:
        self.pid = pid
        self._registered_at = registered_at
        self._code: int | None = None

    @property
    def returncode(self) -> int | None:
        if self._code is None and NameResolver.local_pid_dead(
                "127.0.0.1", self.pid, self._registered_at):
            self._code = -9
        return self._code

    async def wait(self) -> int:
        while self.returncode is None:
            await asyncio.sleep(0.2)
        return self._code

    def terminate(self) -> None:
        try:
            os.kill(self.pid, signal.SIGTERM)
        except ProcessLookupError:
            self._code = -15

    def kill(self) -> None:
        try:
            os.kill(self.pid, signal.SIGKILL)
        except ProcessLookupError:
            self._code = -9


class Replica:
    def __init__(self, app: AppSpec, index: int, config: RunConfig, *,
                 device: str | None = None) -> None:
        self.app = app
        self.index = index
        self.config = config
        self.device = device
        self.proc: asyncio.subprocess.Process | _AdoptedProc | None = None
        self._pump: asyncio.Task | None = None
        self._prober: asyncio.Task | None = None
        self.restarts = 0
        #: restarts forced by failed liveness probes
        self.health_restarts = 0
        self.stopping = False
        #: set before an operator's restart: supervise() restarts at once,
        #: without backoff and without counting a crash
        self.manual_restart = False
        #: (app_port, sidecar_port) from the ready line
        self.ports: tuple[int, int] | None = None
        self.ready = asyncio.Event()
        self.started_at: float | None = None
        #: the newest output lines, served by the admin API's logs
        self.log_buffer: collections.deque[str] = collections.deque(maxlen=2000)

    @property
    def tag(self) -> str:
        return f"{self.app.app_id}·{self.index}"

    def _command(self) -> list[str]:
        cmd = [sys.executable, "-m", "tasksrunner_torch", "host", self.app.module,
               "--app-id", self.app.app_id, "--registry-file", self.config.registry_file]
        if self.config.resources_path:
            cmd += ["--components", self.config.resources_path]
        cmd += ["--host", self.app.host]
        if self.index == 0:
            cmd += ["--app-port", str(self.app.app_port),
                    "--sidecar-port", str(self.app.sidecar_port)]
        else:
            # scale-out replicas take free ports and register them
            cmd += ["--app-port", "0", "--sidecar-port", "0"]
        if self.device is not None:
            cmd += ["--device", self.device]
        return cmd

    def _env(self) -> dict[str, str]:
        env = dict(os.environ)
        env.update(self.app.env)
        env["TASKSRUNNER_APP_ID"] = self.app.app_id
        env["TASKSRUNNER_REPLICA"] = str(self.index)
        if self.app.grants is not None:
            env[GRANTS_ENV] = json.dumps(self.app.grants)
        if self.config.app_tokens:
            # the replica's own token only; the digest map verifies peers
            env[TOKEN_ENV] = self.config.app_tokens[self.app.app_id]
            env[TOKENS_FILE_ENV] = self.config.tokens_file or ""
        # the run file may live outside the package's tree
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (os.getcwd(), _PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
        return env

    async def start(self) -> None:
        # the previous incarnation's pump must not deliver its ready line
        # into this one's state
        await self._retire_pump()
        self.ports = None
        self.ready = asyncio.Event()
        self.proc = await asyncio.create_subprocess_exec(
            *self._command(), stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT,
            env=self._env(), cwd=self.config.base_dir, limit=1 << 20)
        self.started_at = time.time()
        self._pump = asyncio.create_task(self._pump_logs())
        if self.app.health.enabled:
            if self._prober is not None:
                self._prober.cancel()
            self._prober = asyncio.create_task(self._probe_liveness())
        logger.info("started replica %s (pid %d)", self.tag, self.proc.pid)

    def adopt(self, addr) -> None:
        """Supervise a running replica a previous orchestrator registered:
        no log pump (its output went to the previous parent), but ports,
        readiness, probing and restart on exit."""
        self.proc = _AdoptedProc(addr.pid, addr.registered_at)
        self.ports = (addr.app_port or 0, addr.sidecar_port)
        self.ready.set()
        self.started_at = addr.registered_at or time.time()
        self.log_buffer.append(f"(adopted running pid {addr.pid}; earlier output went to "
                               "the previous orchestrator)")
        if self.app.health.enabled:
            self._prober = asyncio.create_task(self._probe_liveness())

    async def _pump_logs(self) -> None:
        async for line in self.proc.stdout:
            text = line.decode("utf-8", "replace").rstrip()
            m = _READY_RE.search(text)
            if m:
                self.ports = (int(m.group(1)), int(m.group(2)))
                self.ready.set()
            self.log_buffer.append(text)
            print(f"[{self.tag}] {text}", flush=True)

    async def _retire_pump(self, drain: float = 0.0) -> None:
        """Stop the log pump, after up to ``drain`` seconds of reading
        what an exited process left in its pipe."""
        if self._pump is None:
            return
        if drain:
            try:
                await asyncio.wait_for(asyncio.shield(self._pump), drain)
            except Exception:  # noqa: BLE001 - a timeout or a read error: cancelled below
                pass
        self._pump.cancel()
        try:
            await self._pump
        except (asyncio.CancelledError, Exception):  # noqa: BLE001 - a read error ends it too
            pass
        self._pump = None

    async def _probe_liveness(self) -> None:
        """GET the app's ``/healthz``; after ``failure_threshold`` failures
        in a row, kill the process so that supervise() restarts it."""
        health = self.app.health
        try:
            await asyncio.wait_for(self.ready.wait(), timeout=READY_TIMEOUT)
        except asyncio.TimeoutError:
            logger.warning("replica %s never reported ready; liveness probing disabled "
                           "for this incarnation", self.tag)
            return
        host = "127.0.0.1" if self.app.host in ("", "0.0.0.0") else self.app.host
        port = self.ports[0]
        failures = 0
        await asyncio.sleep(health.initial_delay_seconds)
        while not self.stopping:
            try:
                status, _, _ = await asyncio.wait_for(
                    http_request(host, port, "GET", "/healthz"), health.timeout_seconds)
                healthy = status < 500
            except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError,
                    asyncio.LimitOverrunError, ValueError, IndexError):
                healthy = False
            if healthy:
                failures = 0
            else:
                failures += 1
                logger.warning("liveness probe failed for %s (%d/%d)", self.tag, failures,
                               health.failure_threshold)
                if failures >= health.failure_threshold:
                    logger.warning("replica %s unhealthy; killing it for a restart", self.tag)
                    self.health_restarts += 1
                    if self.proc is not None and self.proc.returncode is None:
                        self.proc.kill()
                    return  # supervise() restarts it with a new prober
            await asyncio.sleep(health.interval_seconds)

    async def stop(self) -> None:
        self.stopping = True
        if self._prober is not None:
            self._prober.cancel()
            try:
                await self._prober
            except asyncio.CancelledError:
                pass
            self._prober = None
        if self.proc is not None and self.proc.returncode is None:
            self.proc.terminate()
            try:
                await asyncio.wait_for(self.proc.wait(), timeout=STOP_TIMEOUT)
            except asyncio.TimeoutError:
                self.proc.kill()
                await self.proc.wait()
        # the lines a stopping host logs last are still in the pipe
        await self._retire_pump(drain=5.0)

    async def supervise(self) -> None:
        """Restart on exit, after a backoff that grows with the crashes."""
        while not self.stopping:
            dead_pid = self.proc.pid
            code = await self.proc.wait()
            # a killed replica never unregistered: take it out of the
            # rotation now (off the loop: the registry waits on a lock file)
            try:
                await asyncio.to_thread(
                    NameResolver(registry_file=self.config.registry_path).unregister,
                    self.app.app_id, pid=dead_pid)
            except OSError:  # the registry's directory is gone at teardown
                pass
            if self.stopping:
                return
            if self.manual_restart:
                self.manual_restart = False
                logger.info("replica %s restarting on request", self.tag)
                await self.start()
                continue
            backoff = RESTART_BACKOFF[min(self.restarts, len(RESTART_BACKOFF) - 1)]
            logger.warning("replica %s exited with %s; restarting in %.1fs", self.tag, code,
                           backoff)
            self.restarts += 1
            await asyncio.sleep(backoff)
            if not self.stopping:
                await self.start()


class Orchestrator:
    def __init__(self, config: RunConfig, *, device: str | None = None) -> None:
        if config.mesh_tls:
            raise not_ported("mesh_tls", "A22")
        self.config = config
        #: given to every replica as ``--device``; None: the card
        self.device = device
        self.replicas: dict[str, list[Replica]] = {}
        self._supervisors: list[asyncio.Task] = []
        self._scalers: list[AutoscaleController] = []
        #: per app, its placement sweep (TASKSRUNNER_RESHARD); /admin/placement reads it
        self.placement: dict[str, PlacementController] = {}
        self._components = (load_components(config.resources_path)
                            if config.resources_path else [])
        #: per app, its numbered config changes; the newest is active
        self.revisions: dict[str, list[dict]] = {}
        self._admin = None
        self._cp_store = None
        self._cp_lease = None
        # unique within a process too: a standby in the same process must
        # not read as the holder renewing
        self._cp_owner = f"orchestrator-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self._cp_epoch: int | None = None
        self._cp_renewer: asyncio.Task | None = None

    def _record_revision(self, app_id: str, reason: str, **details) -> dict:
        history = self.revisions.setdefault(app_id, [])
        for rev in history:
            rev["active"] = False
        entry = {"revision": len(history) + 1, "created": time.time(), "reason": reason,
                 "active": True, **details}
        history.append(entry)
        return entry

    async def start(self) -> None:
        # the control plane first: two orchestrators over one registry
        # would fight for its ports and entries
        await self._acquire_control_plane()
        # entries a killed topology left behind
        registry = self.config.registry_path
        try:
            if registry.is_file():
                pruned = await asyncio.to_thread(
                    NameResolver(registry_file=registry).prune_dead_local)
                if pruned:
                    logger.info("pruned %d stale registry entries from a previous run: %s",
                                len(pruned), ", ".join(f"{a} (pid {p})" for a, p in pruned))
        except OSError:
            pass
        if self.config.per_app_tokens and not self.config.app_tokens:
            self._issue_app_tokens()
        adopted: dict[str, list] = {}
        if self.config.adopt:
            adopted = await asyncio.to_thread(self._find_adoptable)
        for app in self.config.apps:
            self.replicas[app.app_id] = []
            survivors = adopted.get(app.app_id, [])
            for addr in survivors[:app.scale.max_replicas]:
                self._adopt_replica(app, addr)
            if survivors:
                self._record_revision(
                    app.app_id, f"adopted {len(self.replicas[app.app_id])} running "
                    "replica(s) from a previous orchestrator")
            else:
                self._record_revision(app.app_id, "initial deploy")
            while len(self.replicas[app.app_id]) < app.scale.min_replicas:
                await self._add_replica(app)
            # the replicas' stats and metadata routes want their token
            token = (self.config.app_tokens.get(app.app_id) if self.config.app_tokens
                     else os.environ.get(TOKEN_ENV))
            if app.scale.rules:
                scaler = AutoscaleController(
                    app, self._components, lambda n, a=app: self._set_replicas(a, n),
                    base_dir=self.config.base_dir,
                    replica_info=lambda a=app: self._replica_info(a.app_id), api_token=token)
                scaler.start()
                self._scalers.append(scaler)
            if env_flag("TASKSRUNNER_RESHARD", default=False):
                controller = PlacementController(
                    app.app_id, lambda a=app: self._replica_info(a.app_id), api_token=token)
                controller.start()
                self.placement[app.app_id] = controller
        from tasksrunner_torch.orchestrator.admin import AdminServer
        self._admin = AdminServer(self, port=self.config.admin_port)
        await self._admin.start()

    async def _acquire_control_plane(self) -> None:
        """Take (or, as a standby, wait for) the registry directory's
        control-plane lease."""
        from tasksrunner_torch.state.lease import Lease, lease_seconds_default
        from tasksrunner_torch.state.sqlite import SqliteStateStore

        registry_dir = self.config.registry_path.parent
        self._cp_store = await asyncio.to_thread(
            SqliteStateStore, "orchestrator.control-plane", registry_dir / "control-plane.db")
        self._cp_lease = Lease(self._cp_store, "control-plane")
        lease_s = lease_seconds_default()
        announced = False
        while True:
            epoch = await self._cp_lease.acquire(self._cp_owner)
            if epoch is not None:
                self._cp_epoch = epoch
                break
            holder = await self._cp_lease.peek() or {}
            if not self.config.standby:
                await asyncio.to_thread(self._cp_store.close)
                self._cp_store = self._cp_lease = None
                raise SystemExit(
                    f"another orchestrator (pid {holder.get('pid')}) holds the control plane "
                    f"for {registry_dir}: stop it, or start this one with --standby to take "
                    "over when it dies")
            if not announced:
                logger.info("standby: control plane held by pid %s; waiting for the lease "
                            "(epoch %s)", holder.get("pid"), holder.get("epoch"))
                announced = True
            await asyncio.sleep(max(lease_s / 3.0, 0.05))
        self._cp_renewer = asyncio.create_task(self._renew_control_plane())
        logger.info("control-plane lease acquired (owner %s, epoch %d)", self._cp_owner,
                    self._cp_epoch)

    async def _renew_control_plane(self) -> None:
        from tasksrunner_torch.state.lease import lease_seconds_default

        interval = max(lease_seconds_default() / 3.0, 0.05)
        while True:
            await asyncio.sleep(interval)
            try:
                renewed = await self._cp_lease.renew(self._cp_owner)
            except Exception:  # noqa: BLE001 - try again next beat
                logger.debug("control-plane renew failed", exc_info=True)
                continue
            if not renewed:
                holder = await self._cp_lease.peek() or {}
                logger.critical("control-plane lease lost to pid %s: this orchestrator is "
                                "fenced; stop it", holder.get("pid"))
                return

    def _find_adoptable(self) -> dict[str, list]:
        """The live local registry entries of the configured apps."""
        registry = self.config.registry_path
        if not registry.is_file():
            return {}
        resolver = NameResolver(registry_file=registry)
        out: dict[str, list] = {}
        for app in self.config.apps:
            live = [addr for addr in resolver.resolve_all(app.app_id)
                    if addr.pid is not None and not NameResolver.local_pid_dead(
                        addr.host, addr.pid, addr.registered_at)]
            if live:
                out[app.app_id] = sorted(live, key=lambda a: a.registered_at)
        return out

    def _new_replica(self, app: AppSpec) -> Replica:
        replica = Replica(app, len(self.replicas[app.app_id]), self.config, device=self.device)
        self.replicas[app.app_id].append(replica)
        return replica

    def _adopt_replica(self, app: AppSpec, addr) -> None:
        replica = self._new_replica(app)
        replica.adopt(addr)
        self._supervisors.append(asyncio.create_task(replica.supervise()))
        logger.info("adopted running replica %s (pid %d, app_port %s, sidecar_port %s)",
                    replica.tag, addr.pid, addr.app_port, addr.sidecar_port)

    def _issue_app_tokens(self) -> None:
        """One token per app; the app_id → sha256 digest map goes beside
        the registry (mode 0600). Each replica gets only its own token."""
        self.config.app_tokens = {app.app_id: secrets.token_hex(16)
                                  for app in self.config.apps}
        digests = {app_id: hash_token(token)
                   for app_id, token in self.config.app_tokens.items()}
        tokens_path = self.config.registry_path.parent / "tokens.json"
        tokens_path.parent.mkdir(parents=True, exist_ok=True)
        fd = os.open(tokens_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps(digests, indent=2))
        tokens_path.chmod(0o600)  # a file that existed before: tighten it too
        self.config.tokens_file = str(tokens_path)
        logger.info("issued per-app tokens for %d apps -> digest map %s",
                    len(self.config.app_tokens), tokens_path)

    async def _add_replica(self, app: AppSpec) -> None:
        replica = self._new_replica(app)
        await replica.start()
        self._supervisors.append(asyncio.create_task(replica.supervise()))

    async def _set_replicas(self, app: AppSpec, desired: int) -> None:
        current = self.replicas[app.app_id]
        while len(current) < desired:
            await self._add_replica(app)
        while len(current) > desired:
            victim = current.pop()  # never replica 0: desired >= min >= 1
            await victim.stop()

    def replica_count(self, app_id: str) -> int:
        return len(self.replicas.get(app_id, []))

    def _replica_info(self, app_id: str) -> list[dict]:
        """{pid, app_port, sidecar_port, host} of each replica: what the
        scale rules measure."""
        out = []
        for r in self.replicas.get(app_id, []):
            running = r.proc is not None and r.proc.returncode is None
            out.append({"pid": r.proc.pid if running else None,
                        "app_port": r.ports[0] if r.ports else None,
                        "sidecar_port": r.ports[1] if r.ports else None,
                        "host": r.app.host})
        return out

    # -- admin operations ------------------------------------------------

    def _app_spec(self, app_id: str) -> AppSpec:
        for app in self.config.apps:
            if app.app_id == app_id:
                return app
        raise KeyError(app_id)

    async def _rolling_restart(self, app_id: str) -> None:
        """Restart the replicas one at a time, each waited for until it
        is ready again, so that one keeps serving throughout."""
        loop = asyncio.get_running_loop()
        for replica in list(self.replicas[app_id]):
            # one that is down is mid-restart already: flagging it would
            # take its next crash for a requested restart
            if replica.stopping or replica.proc is None or replica.proc.returncode is not None:
                continue
            old_pid = replica.proc.pid
            replica.manual_restart = True
            replica.proc.terminate()
            deadline = loop.time() + 30
            killed = False
            while (replica.proc is None or replica.proc.pid == old_pid
                   or not replica.ready.is_set()):
                if loop.time() > deadline:
                    if (not killed and replica.proc is not None
                            and replica.proc.pid == old_pid and replica.proc.returncode is None):
                        logger.warning("replica %s ignored SIGTERM for 30s; killing",
                                       replica.tag)
                        replica.proc.kill()
                        killed = True
                        deadline = loop.time() + 10
                        continue
                    logger.warning("replica %s did not come back ready in time", replica.tag)
                    break
                if replica.stopping:
                    return
                await asyncio.sleep(0.1)

    async def restart_app(self, app_id: str) -> dict:
        entry = self._record_revision(app_id, "manual restart")
        await self._rolling_restart(app_id)
        return entry

    async def update_env(self, app_id: str, *, set_env: dict[str, str],
                         remove: list[str]) -> dict:
        """A new revision with the env changed; the replicas restart into it."""
        app = self._app_spec(app_id)
        for key in remove:
            app.env.pop(key, None)
        app.env.update({str(k): str(v) for k, v in set_env.items()})
        entry = self._record_revision(app_id, "env update", env_set=sorted(set_env),
                                      env_removed=sorted(remove))
        await self._rolling_restart(app_id)
        return entry

    async def update_scale(self, app_id: str, *, min_replicas: int | None,
                           max_replicas: int | None) -> dict:
        """New replica bounds: a revision, no restart; the count moves
        into the bounds at once and the autoscaler steers within them."""
        app = self._app_spec(app_id)
        new_min = app.scale.min_replicas if min_replicas is None else min_replicas
        new_max = app.scale.max_replicas if max_replicas is None else max_replicas
        if new_min < 1:
            raise ValueError("min_replicas must be >= 1 (scale-to-zero would starve "
                             "cron/input bindings)")
        if new_min > new_max:
            raise ValueError(f"min_replicas {new_min} exceeds max_replicas {new_max}; "
                             "pass both to raise the ceiling")
        app.scale.min_replicas = new_min
        app.scale.max_replicas = new_max
        entry = self._record_revision(app_id, "scale update", min_replicas=new_min,
                                      max_replicas=new_max)
        current = len(self.replicas[app_id])
        desired = min(max(current, new_min), new_max)
        if desired != current:
            await self._set_replicas(app, desired)
        return entry

    def status(self) -> dict:
        now = time.time()
        apps = []
        for app in self.config.apps:
            active = next((r for r in self.revisions.get(app.app_id, []) if r["active"]), None)
            apps.append({
                "app_id": app.app_id,
                "module": app.module,
                "revision": active["revision"] if active else None,
                "scale": {"min": app.scale.min_replicas, "max": app.scale.max_replicas},
                "env_keys": sorted(app.env),
                "replicas": [{
                    "index": r.index,
                    "pid": r.proc.pid if r.proc else None,
                    "running": bool(r.proc and r.proc.returncode is None),
                    "app_port": r.ports[0] if r.ports else None,
                    "sidecar_port": r.ports[1] if r.ports else None,
                    "restarts": r.restarts,
                    "health_restarts": r.health_restarts,
                    "uptime_seconds": (round(now - r.started_at, 1) if r.started_at
                                       else None),
                } for r in self.replicas.get(app.app_id, [])],
            })
        return {"apps": apps}

    def app_logs(self, app_id: str, *, tail: int = 100,
                 replica: int | None = None) -> list[dict]:
        group = self.replicas.get(app_id)
        if group is None:
            raise KeyError(app_id)
        return [{"replica": r.index, "line": line} for r in group
                if replica is None or r.index == replica
                for line in list(r.log_buffer)[-tail:]]

    async def wait(self) -> None:
        """Until SIGINT or SIGTERM."""
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()

    async def stop(self) -> None:
        if self._admin is not None:
            await self._admin.stop()
            self._admin = None
        for controller in [*self._scalers, *self.placement.values()]:
            await controller.stop()
        self._scalers.clear()
        self.placement.clear()
        # every replica at once: each waits for its process to exit
        await asyncio.gather(*(replica.stop() for group in self.replicas.values()
                               for replica in group))
        for task in self._supervisors:
            task.cancel()
        for task in self._supervisors:
            try:
                await task
            except asyncio.CancelledError:
                pass
        self._supervisors.clear()
        await self._release_control_plane()

    async def _release_control_plane(self) -> None:
        if self._cp_renewer is not None:
            self._cp_renewer.cancel()
            try:
                await self._cp_renewer
            except asyncio.CancelledError:
                pass
            self._cp_renewer = None
        if self._cp_lease is not None:
            try:
                await self._cp_lease.release(self._cp_owner)
            except Exception:  # noqa: BLE001 - the store may be gone
                logger.debug("control-plane release failed", exc_info=True)
            self._cp_lease = None
        if self._cp_store is not None:
            await asyncio.to_thread(self._cp_store.close)
            self._cp_store = None

    async def abandon(self) -> None:
        """Walk away from everything without stopping it, as a killed
        orchestrator would: the replicas keep running and registered, the
        lease record stays unreleased and ``orchestrator.json`` stays on
        disk; only this process's tasks, sockets and pipes go. A
        successor adopts the replicas once the lease is free."""
        if self._admin is not None:
            await self._admin.abandon()
            self._admin = None
        for controller in [*self._scalers, *self.placement.values()]:
            await controller.stop()
        self._scalers.clear()
        self.placement.clear()
        doomed: list[asyncio.Task] = list(self._supervisors)
        self._supervisors.clear()
        for task in doomed:
            task.cancel()  # blocked in proc.wait() on a process that runs on
        for group in self.replicas.values():
            for replica in group:
                replica.stopping = True  # a dead parent restarts nothing
                for task in (replica._pump, replica._prober):
                    if task is not None:
                        task.cancel()
                        doomed.append(task)
                replica._pump = replica._prober = None
                # a dead parent's pipe is closed: the replica's next line
                # fails to write instead of blocking on a full pipe
                transport = getattr(replica.proc, "_transport", None)
                pipe = transport.get_pipe_transport(1) if transport is not None else None
                if pipe is not None:
                    pipe.close()
        if self._cp_renewer is not None:
            self._cp_renewer.cancel()
            doomed.append(self._cp_renewer)
            self._cp_renewer = None
        for task in doomed:
            try:
                await task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001 - walking away
                pass
        self._cp_lease = None
        if self._cp_store is not None:
            # the handle only: the lease record stays as it is
            await asyncio.to_thread(self._cp_store.close)
            self._cp_store = None


async def run_from_config(config: RunConfig, *, device: str | None = None) -> None:
    """Start the orchestrator, serve until SIGINT or SIGTERM, then stop
    every replica; a start that fails part-way stops what it started."""
    if config.require_api_token and not os.environ.get(TOKEN_ENV):
        raise SystemExit(f"this run config requires an API token but {TOKEN_ENV} is not set; "
                         "refusing to start unauthenticated")
    orch = Orchestrator(config, device=device)
    try:
        await orch.start()
    except BaseException:
        await orch.stop()
        raise
    logger.info("orchestrator running apps: %s (ctrl-c to stop)",
                ", ".join(a.app_id for a in config.apps))
    try:
        await orch.wait()
    finally:
        await asyncio.shield(orch.stop())
