"""The port's command line: the port of these commands of
``tasksrunner/cli.py``.

* ``host MODULE:FACTORY --components DIR``: one app and its sidecar in
  one process (:class:`~tasksrunner_torch.hosting.AppHost`); on a clean
  stop it logs one line with the process's kernel launch counts
  (``kernel launches app=… pid=… {"flash_fwd": …, …}``);
* ``serve MODULE:FACTORY --port P --sidecar-port S``: the app server
  alone, its client talking to the sidecar on ``S``;
* ``sidecar --app-id ID --app-port P --port S --components DIR``: a
  sidecar for an app served on ``P``;
* ``run RUN_FILE [--standby] [--no-adopt]``: the orchestrator
  (:mod:`tasksrunner_torch.orchestrator`), each replica a ``host``
  process of a port app the run file names;
* ``restart``, ``logs``, ``scale``, ``update``, ``revisions APP_ID``: the
  running orchestrator's admin API, found through ``orchestrator.json``
  beside ``--registry-file``;
* ``shards``: each sharded store's routing epoch, shard ranking (with
  each shard's leader for replica sets), migration and rebalance plan
  from the orchestrator's ``/admin/placement``;
* ``repl DATABASE [--json]``: a replicated store's shard leases and its
  members' positions, read from its sqlite files;
* ``ps`` and ``stop APP_ID``: the registry file's replicas probed, or
  sent SIGTERM;
* ``deploy validate|what-if|apply|down MANIFEST``: an environment
  manifest (:mod:`tasksrunner_torch.deploy`) checked, diffed against the
  recorded state, applied (the run file that ``run`` reads, and its
  components) or taken down;
* ``secret STORE KEY --app-id ID``, ``invoke APP_ID METHOD``, ``publish
  PUBSUB TOPIC --app-id ID [--count N]``, ``state get|set|delete|query
  STORE [KEY] --app-id ID``: one-shot probes through a running app's
  sidecar, found in the registry file (``--count`` floods N copies at
  once);
* ``components DIR``: the component files read and each type's driver
  checked;
* ``metrics APP_ID [--json|--percentiles|--slow NAME]``: an app's
  counters from its sidecar's metadata, or its histograms' percentiles
  or slow exemplars merged over every replica;
* ``traces list|show|critical|query|map``: the span files (``--db``, a
  comma-separated list assembles one trace across replicas; ``query``
  runs SQL on a read-only connection; ``map --mermaid``);
* ``flightrec [--dump FILE]``: the flight recorder's dumps, or one dump;
* ``dlq list|show|requeue|purge COMPONENT [TOPIC]``: the dead letters of
  a broker's consumer group or of a queue binding;
* ``actors --app-id ID [--ids] [--json]``: the actor placement table from
  the app's sidecar, per type or per id;
* ``workflows [INSTANCE] --app-id ID [--history] [--start WORKFLOW]
  [--terminate [--reason R]] [--raise-event EVENT] [--input JSON]
  [--json]``: the workflow instances, one instance's status or history,
  or a start, a termination or an event through the app's sidecar.

``chaos``, ``lint`` and ``verify`` are refused: their modules (the chaos
engine, the static analysis and the model checker) are not ported yet
(ROADMAP A23, A27).
The printed lines and exit codes are the JAX verbs'.

``host`` and ``sidecar`` apply the ``kind: Resiliency`` documents of
``--components`` to the app's runtime. ``host``, ``serve``, ``sidecar``
and ``run`` log through :func:`~tasksrunner_torch.logconfig.configure_logging`
(every line tagged ``role=`` and ``trace=``; the role is the app's id,
``{id}-sidecar`` or ``orchestrator``) and install uvloop's loop policy
when ``TASKSRUNNER_UVLOOP`` asks for it (:mod:`~tasksrunner_torch.eventloop`).
``host`` records spans into ``.tasksrunner/traces.db`` unless
``TASKSRUNNER_TRACE_DB`` names another file, or is set empty to record
none.

``host``, ``serve`` and ``sidecar`` print the line the JAX commands print
once they serve (``ready app=… app_port=… sidecar_port=…``), so a script
can wait for it, and stop cleanly on SIGTERM or SIGINT. They and ``run``
run on the card: without one the command exits non-zero, unless
``--device cpu`` is given (``run`` passes it to every replica); there is
no fallback to the CPU. ``--device`` is passed to the app factory when
the factory takes a ``device`` argument, and refused when it does not.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import inspect
import json
import logging
import os
import pathlib
import signal
import sys
import time
from typing import Awaitable, Callable
from urllib.parse import quote, urlencode, urlsplit

from tasksrunner_torch.app import App
from tasksrunner_torch.client import TOKEN_ENV, TOKEN_HEADER, AppClient, http_request
from tasksrunner_torch.errors import TasksRunnerError

#: how the verbs name this command line in the hints they print
PROG = "python -m tasksrunner_torch"


def _load_factory(spec: str):
    """``pkg.module:factory`` imported (``make_app`` when no name is given)."""
    module_name, _, attr = spec.partition(":")
    try:
        module = importlib.import_module(module_name)
    except ImportError as exc:
        raise TasksRunnerError(
            f"cannot import app module {module_name!r} (from {spec!r}): {exc}. The form "
            "is pkg.module:factory, resolved on PYTHONPATH from the current directory"
        ) from exc
    try:
        return getattr(module, attr or "make_app")
    except AttributeError as exc:
        raise TasksRunnerError(f"module {module_name!r} has no attribute "
                               f"{attr or 'make_app'!r} (from {spec!r})") from exc


def make_app(spec: str, device: str | None = None) -> App:
    """The app that ``spec`` names (an App, or a factory of one),
    built on ``device`` when one is given."""
    target = _load_factory(spec)
    if isinstance(target, App):
        if device is not None:
            raise TasksRunnerError(f"{spec} is an App, not a factory; --device is refused")
        app = target
    elif device is None:
        app = target()
    elif "device" in inspect.signature(target).parameters:
        app = target(device=device)
    else:
        raise TasksRunnerError(f"{spec} takes no device argument; --device is refused")
    if not isinstance(app, App):
        raise TasksRunnerError(f"{spec} did not produce a tasksrunner_torch App")
    return app


async def start_app(app: App, *, port: int = 0, sidecar_port: int | None = None) -> int:
    """What ``serve`` runs: the app's client pointed at its sidecar
    (``TASKSRUNNER_HTTP_PORT``, else 3500, when ``sidecar_port`` is None)
    and the app served on 127.0.0.1; returns the bound port."""
    app.client = AppClient.http(sidecar_port)
    return await app.start("127.0.0.1", port)


def _run_loop(main: Awaitable[None]) -> None:
    """``asyncio.run(main)`` under uvloop's policy when asked for: every
    long-running command runs its loop through here."""
    from tasksrunner_torch.eventloop import maybe_enable_uvloop

    maybe_enable_uvloop()
    asyncio.run(main)


def _log_as(role: str, args) -> None:
    from tasksrunner_torch.logconfig import configure_logging

    configure_logging(role, level=getattr(logging, args.log_level.upper()))


def _serve(start: Callable[[], Awaitable[str]], stop: Callable[[], Awaitable[None]]) -> None:
    """Run ``start``, print the ready line it returns, and serve until
    SIGTERM or SIGINT; then ``stop``."""
    async def main() -> None:
        done = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, done.set)
        print(await start(), flush=True)
        try:
            await done.wait()
        finally:
            await stop()

    _run_loop(main())


def _cmd_host(args) -> None:
    from tasksrunner_torch import spans
    from tasksrunner_torch.hosting import AppHost

    app = make_app(args.module, args.device)
    if args.app_id:
        app.app_id = args.app_id
    _log_as(app.app_id, args)
    # hosted services record spans by default; TASKSRUNNER_TRACE_DB= (empty) turns it off
    spans.configure_spans(app.app_id,
                          os.environ.get(spans.ENV_VAR, ".tasksrunner/traces.db") or None)
    host = AppHost(app, components_path=args.components, app_port=args.app_port,
                   sidecar_port=args.sidecar_port, bind=args.host,
                   registry_file=args.registry_file, register=not args.no_register)

    async def start() -> str:
        await host.start()
        return (f"ready app={app.app_id} app_port={host.app_port} "
                f"sidecar_port={host.sidecar_port}")

    async def stop() -> None:
        from tasksrunner_torch import flash

        await host.stop()
        # what this process launched: read by whoever supervises it
        logging.getLogger(__name__).info("kernel launches app=%s pid=%d %s", app.app_id,
                                         os.getpid(), json.dumps(flash.launch_counts()))

    _serve(start, stop)


def _cmd_serve(args) -> None:
    app = make_app(args.module, args.device)
    _log_as(app.app_id, args)

    async def start() -> str:
        port = await start_app(app, port=args.port, sidecar_port=args.sidecar_port)
        return f"ready app={app.app_id} app_port={port}"

    _serve(start, app.stop)


def _cmd_sidecar(args) -> None:
    from tasksrunner_torch.component.loader import load_components
    from tasksrunner_torch.component.registry import ComponentRegistry
    from tasksrunner_torch.invoke.resolver import AppAddress, NameResolver
    from tasksrunner_torch.resiliency import ResiliencyPolicies, load_resiliency
    from tasksrunner_torch.runtime import HTTPAppChannel, Runtime
    from tasksrunner_torch.security import grants_from_env
    from tasksrunner_torch.sidecar import Sidecar

    _log_as(f"{args.app_id}-sidecar", args)
    specs = load_components(args.components) if args.components else []
    policies = load_resiliency(args.components) if args.components else []
    resolver = NameResolver(registry_file=args.registry_file)
    runtime = Runtime(args.app_id, ComponentRegistry(specs, app_id=args.app_id),
                      resolver=resolver, app_channel=HTTPAppChannel("127.0.0.1", args.app_port),
                      grants=grants_from_env(),
                      resiliency=(ResiliencyPolicies(policies, app_id=args.app_id)
                                  if policies else None))
    sidecar = Sidecar(runtime, port=args.port)

    async def start() -> str:
        await sidecar.start()
        await asyncio.to_thread(resolver.register, AppAddress(
            app_id=args.app_id, host="127.0.0.1", sidecar_port=sidecar.port,
            app_port=args.app_port))
        return f"ready app={args.app_id} sidecar_port={sidecar.port}"

    async def stop() -> None:
        await asyncio.to_thread(resolver.unregister, args.app_id, pid=os.getpid(),
                                sidecar_port=sidecar.port)
        await sidecar.stop()

    _serve(start, stop)


def _cmd_run(args) -> None:
    from tasksrunner_torch.orchestrator.config import load_run_config
    from tasksrunner_torch.orchestrator.run import run_from_config

    _log_as("orchestrator", args)
    config = load_run_config(args.config)
    if args.standby:
        config.standby = True
    if args.no_adopt:
        config.adopt = False
    _run_loop(run_from_config(config, device=args.device))


def _cmd_deploy(args) -> None:
    from tasksrunner_torch.deploy import (
        apply_manifest, destroy, load_manifest, validate_manifest, what_if,
    )

    manifest = load_manifest(args.manifest)
    if args.action == "validate":
        problems = validate_manifest(manifest)
        if problems:
            for p in problems:
                print(f"ERROR: {p}")
            raise SystemExit(1)
        print(f"manifest {manifest.name!r} is valid "
              f"({len(manifest.apps)} apps, {len(manifest.components)} components)")
    elif args.action == "what-if":
        preview = what_if(manifest)
        if not preview["valid"]:
            for p in preview["problems"]:
                print(f"ERROR: {p}")
            raise SystemExit(1)
        if not preview["changes"]:
            print("no changes — recorded state matches the manifest")
        for change in preview["changes"]:
            if change["op"] == "modify":
                print(f"~ {change['path']}: {change['from']!r} -> {change['to']!r}")
            else:
                sign = "+" if change["op"] == "create" else "-"
                print(f"{sign} {change['path'] or manifest.name}")
    elif args.action == "apply":
        result = apply_manifest(manifest)
        print(f"applied {len(result['changes'])} change(s)")
        print(f"run config: {result['run_config']}")
        print(f"state:      {result['state']}")
        print(f"start with: python -m tasksrunner_torch run {result['run_config']}")
    elif destroy(manifest):
        print(f"environment {manifest.name!r} state removed")
    else:
        print(f"environment {manifest.name!r} had no recorded state")


def _cmd_secret(args) -> None:
    """``GET /v1.0/secrets/{store}/{key}`` through the app's sidecar."""
    _sidecar_request(args, "GET", f"secrets/{args.store}/{args.key}")


def _admin_request(registry_file: str, method: str, path: str,
                   body: dict | None = None) -> dict:
    """One call to the running orchestrator's admin API, whose address is
    in ``orchestrator.json`` beside the registry file; an unreadable file
    (a torn write of a killed process) is removed."""
    from tasksrunner_torch.orchestrator.admin import info_path

    info_file = info_path(registry_file)
    if not info_file.is_file():
        raise SystemExit(f"no orchestrator control file at {info_file}: is "
                         "`python -m tasksrunner_torch run` running with this registry_file?")
    try:
        admin_url = json.loads(info_file.read_text())["admin_url"]
        url = admin_url + path
    except (ValueError, KeyError, TypeError):
        info_file.unlink(missing_ok=True)
        raise SystemExit(f"orchestrator control file {info_file} was unreadable (left by a "
                         "killed orchestrator?): removed it; if `run` is live, retry in a "
                         "moment, else restart it") from None
    headers = {"content-type": "application/json"}
    if os.environ.get(TOKEN_ENV):
        headers[TOKEN_HEADER] = os.environ[TOKEN_ENV]
    target = urlsplit(admin_url)
    # a rolling restart takes up to ~40 s a replica before the answer
    timeout = 300
    try:
        status, _, raw = asyncio.run(asyncio.wait_for(http_request(
            target.hostname, target.port, method, path, headers=headers,
            body=json.dumps(body).encode() if body is not None else b""), timeout))
    except TimeoutError:
        raise SystemExit(f"orchestrator did not answer within {timeout}s: the operation "
                         "may still be running; check `revisions`") from None
    except (OSError, asyncio.IncompleteReadError) as exc:
        raise SystemExit(f"cannot reach orchestrator at {url}: {exc} (a stale "
                         "orchestrator.json after a crash?)") from None
    if status >= 400:
        detail = raw.decode("utf-8", "replace")
        try:
            detail = json.loads(detail).get("error", detail)
        except (ValueError, AttributeError):
            pass
        raise SystemExit(f"orchestrator returned {status}: {detail}")
    return json.loads(raw or b"{}")


def _cmd_restart(args) -> None:
    out = _admin_request(args.registry_file, "POST", f"/admin/apps/{args.app_id}/restart")
    print(f"restarted {args.app_id} (revision {out.get('revision', {}).get('revision')})")


def _cmd_logs(args) -> None:
    query = f"?tail={args.tail}" + (f"&replica={args.replica}" if args.replica is not None
                                    else "")
    out = _admin_request(args.registry_file, "GET", f"/admin/apps/{args.app_id}/logs{query}")
    for entry in out.get("lines", []):
        print(f"[{args.app_id}·{entry['replica']}] {entry['line']}")


def _cmd_scale(args) -> None:
    body = {k: v for k, v in (("min_replicas", args.min_replicas),
                              ("max_replicas", args.max_replicas)) if v is not None}
    if not body:
        raise SystemExit("nothing to do: pass --min-replicas and/or --max-replicas")
    rev = _admin_request(args.registry_file, "POST", f"/admin/apps/{args.app_id}/scale",
                         body).get("revision", {})
    print(f"scaled {args.app_id}: min={rev.get('min_replicas')} "
          f"max={rev.get('max_replicas')} (revision {rev.get('revision')})")


def _cmd_update(args) -> None:
    set_env = {}
    for pair in args.set_env or []:
        if "=" not in pair:
            raise SystemExit(f"--set-env needs KEY=VALUE, got {pair!r}")
        key, _, value = pair.partition("=")
        set_env[key] = value
    remove = args.remove_env or []
    if not set_env and not remove:
        raise SystemExit("nothing to do: pass --set-env and/or --remove-env")
    rev = _admin_request(args.registry_file, "POST", f"/admin/apps/{args.app_id}/env",
                         {"set": set_env, "remove": remove}).get("revision", {})
    print(f"updated {args.app_id} env (revision {rev.get('revision')}): "
          f"set={sorted(set_env) or '-'} removed={remove or '-'}")


def _cmd_shards(args) -> None:
    """Each sharded store's epoch, shard ranking, migration in flight and
    rebalance plan, from the orchestrator's ``/admin/placement``."""
    doc = _admin_request(args.registry_file, "GET", "/admin/placement")
    if args.json:
        print(json.dumps(doc, indent=2))
        return
    apps = doc.get("apps") or {}
    if not apps:
        print("no running apps")
        return
    if not doc.get("reshard"):
        print("NOTE: TASKSRUNNER_RESHARD is off — this is a one-shot sweep, not a live "
              "control loop")
    shown = 0
    for app_id, snap in sorted(apps.items()):
        for store, entry in sorted((snap.get("stores") or {}).items()):
            shown += 1
            migration = entry.get("migration")
            status = (f", migrating ({migration.get('phase')})"
                      if isinstance(migration, dict) else "")
            print(f"{app_id}/{store}: epoch {entry.get('epoch')}, {entry.get('shards')} shards, "
                  f"{entry.get('replicas_reporting')} replica(s) reporting{status}")
            assignment = entry.get("assignment") or {}
            leaders = entry.get("leaders") or {}
            for row in entry.get("ranking") or []:
                shard = row.get("shard")
                host = assignment.get(str(shard)) or leaders.get(str(shard)) or "local"
                heat = "HOT" if row.get("hot") else "ok"
                print(f"  shard {shard}: rank {row.get('rank')}, {row.get('rate')} ops/s "
                      f"[{heat}] @ {host}")
            plan = entry.get("plan")
            if plan:
                print(f"  plan: {plan.get('action')} shard {plan.get('shard')} — "
                      f"{plan.get('reason')}")
    if not shown:
        print("no sharded stores reporting placement (stores with shards > 1 publish it via "
              "sidecar metadata)")


def _cmd_repl(args) -> None:
    """Each shard's lease (leader, epoch, pid, seconds left) from the
    store's meta file and each member's position from its ``repl_meta``,
    read from the files alone: with or without a running store."""
    import sqlite3

    from tasksrunner_torch.state.replication import MAX_REPLICAS, _member_path, _meta_path

    base = args.database
    meta = _meta_path(base)
    if meta == ":memory:" or not pathlib.Path(meta).is_file():
        raise SystemExit(f"no replication meta database next to {base} (expected {meta}) — is "
                         "the store configured with replicas > 1?")
    con = sqlite3.connect(meta)
    try:
        leases = con.execute(
            "SELECT key, value FROM state WHERE key LIKE 'repl-lease||%'").fetchall()
    finally:
        con.close()
    if not leases:
        raise SystemExit(f"{meta} holds no shard leases yet — no leader has started")
    now = time.time()
    shard_count = 1 + max(int(key.split("||")[2]) for key, _ in leases)
    out = []
    for key, raw in sorted(leases):
        _, name, shard = key.split("||")
        rec = json.loads(raw)
        members = []
        for m in range(MAX_REPLICAS):
            mpath = _member_path(base, int(shard), m, shard_count)
            if not pathlib.Path(mpath).is_file():
                continue
            mcon = sqlite3.connect(mpath)
            try:
                row = mcon.execute("SELECT hwm, epoch FROM repl_meta WHERE id = 1").fetchone()
            except sqlite3.OperationalError:  # a file from before replication
                row = None
            finally:
                mcon.close()
            if row is not None:
                members.append({"member": f"r{m}", "hwm": row[0], "epoch": row[1]})
        out.append({"store": name, "shard": int(shard), "leader": rec.get("owner"),
                    "epoch": rec.get("epoch"), "pid": rec.get("pid"),
                    "lease_seconds_left": round(rec.get("expires", 0.0) - now, 2),
                    "members": members})
    if args.json:
        print(json.dumps({"replication": out}, indent=2))
        return
    for entry in out:
        left = entry["lease_seconds_left"]
        state = "EXPIRED" if left <= 0 else f"{left:.1f}s left"
        print(f"{entry['store']} shard {entry['shard']}: leader {entry['leader']} (epoch "
              f"{entry['epoch']}, pid {entry['pid']}, lease {state})")
        for m in entry["members"]:
            print(f"  {m['member']}: hwm {m['hwm']} epoch {m['epoch']}")


def _cmd_revisions(args) -> None:
    revisions = _admin_request(args.registry_file, "GET",
                               f"/admin/apps/{args.app_id}/revisions").get("revisions", [])
    if not revisions:
        print(f"no revisions recorded for {args.app_id}")
        return
    print(f"{'REV':>4} {'CREATED':<20} {'ACTIVE':<7} REASON")
    for rev in revisions:
        created = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(rev["created"]))
        details = {k: v for k, v in rev.items()
                   if k not in ("revision", "created", "active", "reason")}
        print(f"{rev['revision']:>4} {created:<20} {'yes' if rev['active'] else 'no':<7} "
              f"{rev['reason']}{f'  {details}' if details else ''}")


async def _probe_replica(app_id: str, addr, index: int | None, headers: dict) -> dict:
    """One row of ``ps``: a dead local pid is stale, else the sidecar's
    ``/v1.0/healthz``, the app's ``/healthz`` and the sidecar's metadata."""
    from tasksrunner_torch.invoke.resolver import NameResolver

    row = {"app_id": app_id, "replica": index, "pid": addr.pid, "app_port": addr.app_port,
           "sidecar_port": addr.sidecar_port, "host": addr.host,
           "up_seconds": (round(time.time() - addr.registered_at)
                          if addr.registered_at else None),
           "health": "down", "components": None, "subscriptions": None, "actors": None}
    if NameResolver.local_pid_dead(addr.host, addr.pid, addr.registered_at):
        row["health"] = "stale"
        return row
    errors = (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError, ValueError)

    async def get(port: int, path: str, **kw):
        return await asyncio.wait_for(http_request(addr.host, port, "GET", path, **kw), 2.0)

    try:
        status, _, _ = await get(addr.sidecar_port, "/v1.0/healthz")
        row["health"] = "ok" if status < 500 else "unhealthy"
    except errors:
        return row
    if addr.app_port:
        try:
            if (await get(addr.app_port, "/healthz"))[0] >= 500:
                row["health"] = "unhealthy"
        except errors:
            row["health"] = "app-down"
    try:
        status, _, body = await get(addr.sidecar_port, "/v1.0/metadata", headers=headers)
        if status == 200:
            meta = json.loads(body)
            row["components"] = len(meta.get("components") or [])
            row["subscriptions"] = len(meta.get("subscriptions") or [])
            # the activations this replica owns; "-" with the gate off
            actors = meta.get("actors")
            if actors is not None:
                row["actors"] = sum((actors.get("owned") or {}).values())
        elif status == 401:
            row["components"] = row["subscriptions"] = "auth"
    except errors:
        pass
    return row


def _cmd_ps(args) -> None:
    """The registered replicas with their health; exits 2 when one is down."""
    from tasksrunner_torch.invoke.resolver import NameResolver

    registry_path = pathlib.Path(args.registry_file)
    if not registry_path.is_file():
        raise SystemExit(f"no registry file at {registry_path} (is anything running? "
                         "check the run file's registry_file)")
    resolver = NameResolver(registry_file=registry_path)
    entries = {app_id: resolver.resolve_all(app_id) for app_id in resolver.known_apps()}
    if not entries:
        print("no apps registered")
        return
    headers = {TOKEN_HEADER: os.environ[TOKEN_ENV]} if os.environ.get(TOKEN_ENV) else {}

    async def probe_all() -> list[dict]:
        return await asyncio.gather(*(
            _probe_replica(app_id, addr, i if len(addrs) > 1 else None, headers)
            for app_id, addrs in entries.items() for i, addr in enumerate(addrs)))

    rows = asyncio.run(probe_all())
    any_down = any(r["health"] in ("down", "app-down") for r in rows)
    if args.json:
        print(json.dumps(rows, indent=2))
    else:
        def tag(r: dict) -> str:
            return r["app_id"] if r["replica"] is None else f"{r['app_id']}·{r['replica']}"

        def up(seconds) -> str:
            if seconds is None:
                return "-"
            m, s = divmod(int(seconds), 60)
            h, m = divmod(m, 60)
            return f"{h}h{m:02d}m" if h else f"{m}m{s:02d}s"

        width = max(6, *(len(tag(r)) for r in rows))
        print(f"{'APP-ID':<{width}}  {'PID':>7}  {'APP':>5}  {'SIDECAR':>7}  "
              f"{'HEALTH':<9}  {'COMPS':>5}  {'SUBS':>4}  {'ACTORS':>6}  UP")
        for r in rows:
            print(f"{tag(r):<{width}}  {r['pid'] or '-':>7}  {r['app_port'] or '-':>5}  "
                  f"{r['sidecar_port'] or '-':>7}  {r['health']:<9}  "
                  f"{'-' if r['components'] is None else r['components']:>5}  "
                  f"{'-' if r['subscriptions'] is None else r['subscriptions']:>4}  "
                  f"{'-' if r['actors'] is None else r['actors']:>6}  "
                  f"{up(r['up_seconds'])}")
    if any_down:
        raise SystemExit(2)


def _cmd_stop(args) -> None:
    """SIGTERM every registered replica of the app."""
    from tasksrunner_torch.invoke.resolver import NameResolver

    resolver = NameResolver(registry_file=args.registry_file)
    replicas = resolver.resolve_all(args.app_id)
    if not replicas:
        known = ", ".join(resolver.known_apps()) or "(none registered)"
        raise SystemExit(f"app {args.app_id!r} is not registered; running apps: {known}")
    signalled, failures = 0, []
    for addr in replicas:
        if not addr.pid:
            failures.append(f"registry has no pid for {args.app_id!r}")
            continue
        try:
            os.kill(addr.pid, signal.SIGTERM)
        except ProcessLookupError:
            failures.append(f"{args.app_id}: pid {addr.pid} is already gone "
                            "(stale registration)")
        else:
            signalled += 1
            print(f"sent SIGTERM to {args.app_id} (pid {addr.pid})")
    for msg in failures:
        print(f"warning: {msg}", file=sys.stderr)
    if not signalled:
        raise SystemExit("; ".join(failures))


# -- probes through a running app's sidecar ---------------------------------

def _resolve_sidecars(args) -> tuple[list, dict]:
    """Every registered replica of ``--app-id``, in the registry's order
    (the first is the one a fresh resolver picks), and the headers every
    probe sends (the token when one is set)."""
    from tasksrunner_torch.errors import AppNotFound
    from tasksrunner_torch.invoke.resolver import NameResolver

    resolver = NameResolver(registry_file=args.registry_file)
    try:
        addrs = resolver.resolve_all(args.app_id)
    except AppNotFound:
        addrs = []
    if not addrs:
        known = ", ".join(resolver.known_apps()) or "(none registered)"
        raise SystemExit(f"app {args.app_id!r} is not registered; running apps: {known}")
    headers = {"Content-Type": "application/json"}
    if os.environ.get(TOKEN_ENV):
        headers[TOKEN_HEADER] = os.environ[TOKEN_ENV]
    return addrs, headers


async def _sidecar_fetch(addr, method: str, target: str, headers: dict, body: bytes = b"",
                         timeout: float = 30) -> tuple[int, bytes]:
    """One request to a replica's sidecar: its status and body."""
    status, _, raw = await asyncio.wait_for(http_request(
        addr.host, addr.sidecar_port, method, target, headers=headers, body=body), timeout)
    return status, raw


def _sidecar_request(args, method: str, path: str, body=None, *, query: str = "") -> int:
    """One ``/v1.0/{path}`` request to ``--app-id``'s sidecar: the reply
    printed (JSON indented), HTTP ≥ 400 an error naming the status."""
    addrs, headers = _resolve_sidecars(args)
    target = f"/v1.0/{path}" + (f"?{query}" if query else "")
    status, raw = asyncio.run(_sidecar_fetch(
        addrs[0], method, target, headers, b"" if body is None else json.dumps(body).encode()))
    text = raw.decode("utf-8", "replace")
    try:
        parsed = json.loads(text) if text else None
    except ValueError:
        parsed = None
    if parsed is not None:
        print(json.dumps(parsed, indent=2))
    elif text:
        print(text)
    if status >= 400:
        raise SystemExit(f"HTTP {status}")
    return status


def _parse_data(raw: str | None):
    """``--data``: JSON inline, or ``@file``."""
    if raw is None:
        return None
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    try:
        return json.loads(raw)
    except ValueError as exc:
        raise SystemExit(f"--data is not valid JSON: {exc}")


def _cmd_invoke(args) -> None:
    path, _, query = args.method.partition("?")
    _sidecar_request(args, args.verb.upper(), f"invoke/{args.app_id}/method/{path}",
                     _parse_data(args.data), query=query)


def _cmd_publish(args) -> None:
    """One publish, or ``--count`` copies at most 32 at a time, each a
    dict payload given its ``floodSeq``; exits 2 when any failed."""
    if args.count <= 1:
        _sidecar_request(args, "POST", f"publish/{args.pubsub}/{args.topic}",
                         _parse_data(args.data))
        return
    addrs, headers = _resolve_sidecars(args)
    payload = _parse_data(args.data)
    target = f"/v1.0/publish/{args.pubsub}/{args.topic}"

    async def flood() -> int:
        sem = asyncio.Semaphore(32)
        failures = 0

        async def one(i: int) -> None:
            nonlocal failures
            if isinstance(payload, dict):
                body = {**payload}
                body.setdefault("floodSeq", i)
            else:
                body = {"floodSeq": i} if payload is None else payload
            async with sem:
                try:
                    status, _ = await _sidecar_fetch(addrs[0], "POST", target, headers,
                                                     json.dumps(body).encode())
                    failures += status >= 400
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 - a failed publish, never a crashed flood
                    failures += 1

        await asyncio.gather(*(one(i) for i in range(args.count)))
        return failures

    start = time.perf_counter()
    failures = asyncio.run(flood())
    elapsed = time.perf_counter() - start
    print(f"published {args.count - failures}/{args.count} to {args.pubsub}/{args.topic} "
          f"in {elapsed:.2f}s ({(args.count - failures) / max(elapsed, 1e-9):.0f}/s)"
          + (f", {failures} FAILED" if failures else ""))
    if failures:
        raise SystemExit(2)


def _cmd_state(args) -> None:
    store = args.store
    if args.action == "get":
        if not args.key:
            raise SystemExit("state get needs a KEY")
        _sidecar_request(args, "GET", f"state/{store}/{args.key}")
    elif args.action == "set":
        if not args.key or args.data is None:
            raise SystemExit("state set needs a KEY and --data")
        _sidecar_request(args, "POST", f"state/{store}",
                         [{"key": args.key, "value": _parse_data(args.data)}])
    elif args.action == "delete":
        if not args.key:
            raise SystemExit("state delete needs a KEY")
        _sidecar_request(args, "DELETE", f"state/{store}/{args.key}")
    else:
        _sidecar_request(args, "POST", f"state/{store}/query", _parse_data(args.data) or {})


def _cmd_components(args) -> None:
    """Each component of the directory (in ``--app-id``'s scope) with its
    type, whether the port has its driver, and its scopes; exits 1 when a
    driver is missing."""
    from tasksrunner_torch.component.loader import load_components
    from tasksrunner_torch.component.registry import registered_types

    specs = load_components(args.path, app_id=args.app_id)
    known = set(registered_types())
    width = max((len(s.name) for s in specs), default=4)
    problems = 0
    for spec in specs:
        ok = spec.type in known
        problems += not ok
        scope = ",".join(spec.scopes) if spec.scopes else "(all apps)"
        print(f"{spec.name:<{width}}  {spec.type:<32} {'ok' if ok else 'NO DRIVER':<10} "
              f"scopes={scope}")
    if problems:
        raise SystemExit(f"{problems} component(s) have no registered driver")


# -- metrics ------------------------------------------------------------------

def _fetch_metadata(addr, headers: dict, app_id: str) -> dict:
    """One replica's ``/v1.0/metadata``; an error names the status or
    the failed connection."""
    try:
        status, raw = asyncio.run(_sidecar_fetch(addr, "GET", "/v1.0/metadata", headers,
                                                 timeout=10))
    except (OSError, asyncio.IncompleteReadError) as exc:  # a timeout is an OSError
        raise SystemExit(f"cannot reach sidecar of {app_id!r}: {exc}")
    if status >= 400:
        hint = (" (set TASKSRUNNER_API_TOKEN — the sidecar requires it)"
                if status == 401 else "")
        raise SystemExit(f"sidecar of {app_id!r} returned HTTP {status}{hint}")
    return json.loads(raw)


def _fetch_all_replica_metadata(args) -> list[dict]:
    """``/v1.0/metadata`` of every registered replica of the app: the
    merged views cover the whole app; a replica that does not answer is
    left out."""
    addrs, headers = _resolve_sidecars(args)
    payloads = []
    for addr in addrs:
        try:
            payloads.append(_fetch_metadata(addr, headers, args.app_id))
        except SystemExit:
            continue
    if not payloads:
        raise SystemExit(f"no reachable replica of {args.app_id!r}")
    return payloads


def _series_name(row: dict) -> str:
    labels = ",".join(f"{k}={v}" for k, v in sorted(row["labels"].items()))
    return row["name"] + ("{" + labels + "}" if labels else "")


def _metrics_percentiles(args) -> None:
    from tasksrunner_torch.metrics import merge_histogram_snapshots, summarize_histograms

    payloads = _fetch_all_replica_metadata(args)
    rows = summarize_histograms(merge_histogram_snapshots(
        p.get("histograms") or {} for p in payloads))
    if args.json:
        print(json.dumps({"replicas": len(payloads), "percentiles": rows}, indent=2))
        return
    if not rows:
        print(f"no latency histograms recorded for {args.app_id} "
              "(is TASKSRUNNER_HISTOGRAMS=0 set?)")
        return
    print(f"# merged across {len(payloads)} replica(s); values in ms")
    width = max(len(_series_name(r)) for r in rows)
    print(f"{'series':<{width}}  {'count':>7}  {'p50':>8}  {'p95':>8}  {'p99':>8}")
    for r in rows:
        print(f"{_series_name(r):<{width}}  {r['count']:>7}  {r['p50'] * 1000:>8.2f}  "
              f"{r['p95'] * 1000:>8.2f}  {r['p99'] * 1000:>8.2f}")


def _metrics_slow(args) -> None:
    from tasksrunner_torch.metrics import merge_histogram_snapshots

    payloads = _fetch_all_replica_metadata(args)
    merged = merge_histogram_snapshots(p.get("histograms") or {} for p in payloads)
    hits = [{"name": name, "labels": series["labels"], "trace_id": trace_id,
             "seconds": value, "time": when}
            for name, hist in sorted(merged.items()) if args.slow in name
            for series in hist["series"]
            for trace_id, value, when in series.get("exemplars", ())]
    hits.sort(key=lambda h: h["seconds"], reverse=True)
    if args.json:
        print(json.dumps({"replicas": len(payloads), "slow": hits}, indent=2))
        return
    if not hits:
        print(f"no slow-call exemplars matching {args.slow!r} "
              "(observations must exceed TASKSRUNNER_SLOW_THRESHOLD_SECONDS, "
              "default 0.25, inside a trace)")
        return
    print(f"# slowest observations matching {args.slow!r} across {len(payloads)} replica(s)")
    for h in hits:
        print(f"{h['seconds'] * 1000:9.1f} ms  {_series_name(h)}  trace {h['trace_id']}")
    print(f"# drill down: {PROG} traces show {hits[0]['trace_id']}")
    print(f"# blame chain: {PROG} traces critical {hits[0]['trace_id']}")


def _cmd_metrics(args) -> None:
    """An app's counters from one replica's sidecar metadata; with
    ``--percentiles`` or ``--slow``, every replica's histograms merged."""
    args.app_id = args.app_id or args.app_id_pos
    if not args.app_id:
        raise SystemExit(f"metrics: an app id is required ({PROG} metrics <app-id>)")
    if args.percentiles:
        _metrics_percentiles(args)
        return
    if args.slow:
        _metrics_slow(args)
        return
    addrs, headers = _resolve_sidecars(args)
    meta = _fetch_metadata(addrs[0], headers, args.app_id)
    metrics = meta.get("metrics") or {}
    if args.json:
        print(json.dumps(metrics, indent=2))
        return
    if not metrics:
        print(f"no metrics recorded for {args.app_id}")
        return
    width = max(len(k) for k in metrics)
    for key in sorted(metrics):
        value = metrics[key]
        shown = int(value) if float(value).is_integer() else round(value, 3)
        print(f"{key:<{width}}  {shown}")


# -- traces and the flight recorder ---------------------------------------------

def _span_split(span: dict) -> str:
    """A span's queue-wait / service split, where its lane recorded one."""
    attrs = span.get("attrs")
    if isinstance(attrs, str):
        try:
            attrs = json.loads(attrs)
        except ValueError:
            return ""
    if not isinstance(attrs, dict) or "queue_wait" not in attrs:
        return ""
    try:
        return (f"  [wait {float(attrs['queue_wait']) * 1000:.1f}ms"
                f" / svc {float(attrs.get('service', 0.0)) * 1000:.1f}ms]")
    except (TypeError, ValueError):
        return ""


def _mermaid_map(edges: list[dict]) -> None:
    ids: dict[str, str] = {}

    def node(name: str) -> str:
        # sanitised ids can collide ("ps/saved", "ps-saved"): one a name
        if name not in ids:
            base = "n" + "".join(c if c.isalnum() else "_" for c in name)
            ids[name] = f"{base}_{len(ids)}" if base in set(ids.values()) else base
        return ids[name]

    def label(text) -> str:
        return str(text).replace('"', "#quot;")

    print("graph LR")
    for e in edges:
        style = "-.->" if e["kind"] == "producer" else "-->"
        print(f'  {node(e["from"])}["{label(e["from"])}"] '
              f'{style}|"{e["calls"]} calls, avg {e["avg_ms"]} ms"| '
              f'{node(e["to"])}["{label(e["to"])}"]')


def _cmd_traces(args) -> None:
    """The span files: the newest traces, one trace's tree or critical
    path (assembled over every ``--db``), read-only SQL, the service map.
    Exits 2 when no file exists."""
    import datetime as dt
    import sqlite3

    from tasksrunner_torch.spans import (
        _connect_ro, assemble_trace, critical_path, list_traces, service_map,
    )

    dbs = [p.strip() for p in (args.db or "").split(",") if p.strip()]
    existing = [p for p in dbs if pathlib.Path(p).is_file()]
    if not existing:
        print(f"no trace database at {args.db or '(unset)'} "
              "(services record to .tasksrunner/traces.db by default)", file=sys.stderr)
        raise SystemExit(2)
    db = existing[0]
    if args.action == "list":
        rows = list_traces(db, limit=args.limit)
        if not rows:
            print("no traces recorded")
            return
        for r in rows:
            ts = dt.datetime.fromtimestamp(r["started"]).strftime("%H:%M:%S")
            print(f"{r['trace_id'][:16]}  {ts}  {r['spans']:>3} spans  "
                  f"{(r['wall'] or 0) * 1000:7.1f} ms  {r['root']}")
    elif args.action == "show":
        if not args.trace_id:
            raise SystemExit("show needs a trace id (prefix ok)")
        spans = assemble_trace(existing, args.trace_id)
        if not spans:
            raise SystemExit(f"no spans for trace {args.trace_id!r}")
        t0 = spans[0]["start"]
        by_id = {s["span_id"]: s for s in spans}

        def depth(s, seen=()):
            parent = s.get("parent_id")
            if not parent or parent not in by_id or parent in seen:
                return 0
            return 1 + depth(by_id[parent], (*seen, s["span_id"]))

        for s in spans:
            print(f"{(s['start'] - t0) * 1000:8.1f}ms {s['duration'] * 1000:7.1f}ms  "
                  f"{'  ' * depth(s)}[{s['role']}] {s['kind']:<8} {s['name']} "
                  f"({s['status']}){_span_split(s)}")
    elif args.action == "critical":
        if not args.trace_id:
            raise SystemExit("critical needs a trace id (prefix ok)")
        spans = assemble_trace(existing, args.trace_id)
        if not spans:
            raise SystemExit(f"no spans for trace {args.trace_id!r}")
        hops = critical_path(spans)
        if not hops:
            raise SystemExit(f"no rooted path in trace {args.trace_id!r}")
        # the chain's wall time: an async tail may outlast the root span
        total = max(h["start"] + h["duration"] for h in hops) - hops[0]["start"]
        print(f"critical path: {len(hops)} hops over {len(spans)} spans, "
              f"root {hops[0]['name']!r}, wall {total * 1000:.1f} ms")
        t0 = hops[0]["start"]
        for hop in hops:
            split = ""
            if "queue_wait" in hop:
                split = (f"  (wait {hop['queue_wait'] * 1000:.1f}ms"
                         f" / svc {hop.get('service', 0.0) * 1000:.1f}ms)")
            print(f"{(hop['start'] - t0) * 1000:8.1f}ms self {hop['self_time'] * 1000:7.1f}ms  "
                  f"[{hop['role']}] {hop['kind']:<8} {hop['name']}{split}")
        accounted = sum(h["self_time"] for h in hops)
        pct = (accounted / total * 100.0) if total > 0 else 100.0
        print(f"blame accounted: {accounted * 1000:.1f} ms of {total * 1000:.1f} ms "
              f"({pct:.0f}%)")
    elif args.action == "query":
        if not args.trace_id:
            raise SystemExit(f"query needs SQL, e.g. {PROG} traces query "
                             "\"SELECT role, COUNT(*) FROM spans GROUP BY role\"")
        conn = _connect_ro(db)  # read-only: no query can change the spans
        try:
            cur = conn.execute(args.trace_id)
            cols = [d[0] for d in cur.description or []]
            rows = cur.fetchall()
        except sqlite3.Error as exc:
            raise SystemExit(f"query failed: {exc}")
        finally:
            conn.close()
        if cols:
            print("\t".join(cols))
        for row in rows:
            print("\t".join(f"{v:.3f}" if isinstance(v, float) else str(v) for v in row))
    else:  # map
        edges = service_map(db)
        if not edges:
            print("no client/producer spans recorded")
        elif args.mermaid:
            _mermaid_map(edges)
        else:
            for e in edges:
                print(f"{e['from']:<36} --{e['kind']}--> {e['to']:<42} "
                      f"{e['calls']:>5} calls  avg {e['avg_ms']} ms")


def _cmd_flightrec(args) -> None:
    """The flight recorder's dumps in ``--dir``, newest first, or one
    dump (``--dump``) with its last ``--limit`` entries."""
    import datetime as dt

    from tasksrunner_torch import flightrec

    if args.dump:
        try:
            payload = flightrec.read_dump(args.dump)
        except (OSError, ValueError) as exc:
            raise SystemExit(f"cannot read dump {args.dump!r}: {exc}")
        ts = dt.datetime.fromtimestamp(payload.get("ts") or 0)
        print(f"{payload.get('role')} pid {payload.get('pid')} — {payload.get('reason')} "
              f"at {ts:%H:%M:%S}  detail={payload.get('detail')}")
        gauges = payload.get("gauges") or {}
        if gauges:
            print("gauges at dump: " + "  ".join(f"{k}={v:.3f}"
                                                 for k, v in sorted(gauges.items())))
        for e in (payload.get("entries") or [])[-args.limit:]:
            ets = dt.datetime.fromtimestamp(e.get("ts") or 0)
            trace = (e.get("trace") or "")[:16] or "-"
            print(f"{ets:%H:%M:%S}.{ets.microsecond // 1000:03d}  "
                  f"{(e.get('dur') or 0) * 1000:7.1f}ms  ({e.get('status')}) {e.get('name')}"
                  f"  trace {trace}" + (f"  gauges {e['gauges']}" if e.get("gauges") else ""))
        return
    rows = flightrec.list_dumps(args.dir)
    if not rows:
        print(f"no flight-recorder dumps in {args.dir} (dumps appear on shed entry, "
              "slow exemplars, and unclean shutdown)")
        return
    for r in rows:
        ts = dt.datetime.fromtimestamp(r.get("ts") or 0)
        print(f"{ts:%H:%M:%S}  {r['reason']:<18} {r['role']} pid {r['pid']}  "
              f"{r['entries']:>4} entries  {r['path']}")
    print(f"# inspect one: {PROG} flightrec --dump {rows[0]['path']}")


# -- dead letters ----------------------------------------------------------------

def _print_dlq(action: str, get_entries, ops: dict, where: str, ids) -> None:
    if action == "list":
        entries = get_entries()
        if not entries:
            print(f"no dead letters on {where}")
            return
        print(f"{'ID':<36} {'ATTEMPTS':>8}  DATA")
        for e in entries:
            preview = json.dumps(e["data"])
            if len(preview) > 60:
                preview = preview[:57] + "..."
            print(f"{e['id']:<36} {e['attempts']:>8}  {preview}")
    elif action == "show":
        print(json.dumps(get_entries(), indent=2, default=str))
    else:  # requeue | purge
        n = ops[action](ids or None)
        print(f"{'requeued' if action == 'requeue' else 'purged'} {n} message(s) on {where}")


def _cmd_dlq(args) -> None:
    """The dead letters of a broker's consumer group (TOPIC, and
    ``--group`` or ``--app-id``) or of a queue binding, read from their
    files: listed, shown, requeued or purged."""
    from tasksrunner_torch.component.loader import load_components
    from tasksrunner_torch.errors import ComponentError

    specs = load_components(args.resources)
    spec = next((s for s in specs if s.name == args.component), None)
    if spec is None:
        known = ", ".join(sorted(s.name for s in specs)) or "(none)"
        raise SystemExit(f"no component {args.component!r} in {args.resources}; found: {known}")
    if spec.type.startswith("bindings."):
        from tasksrunner_torch.bindings.localqueue import open_queue_for_inspection

        try:
            queue = open_queue_for_inspection(spec, args.base_dir)
        except ComponentError as exc:
            raise SystemExit(str(exc))
        try:
            _print_dlq(args.action, queue.dead_letter_detail,
                       {"requeue": queue.requeue_dead_letters,
                        "purge": queue.purge_dead_letters}, args.component, args.id)
        finally:
            queue.close()
        return
    if not args.topic:
        raise SystemExit("pub/sub dlq needs a TOPIC")
    group = args.group or args.app_id
    if not group:
        raise SystemExit("pass --group (the consumer group; by convention the subscriber's "
                         "app-id)")
    from tasksrunner_torch.pubsub.sqlite import open_for_inspection

    try:
        broker = open_for_inspection(spec, args.base_dir)
    except ComponentError as exc:
        raise SystemExit(str(exc))
    try:
        _print_dlq(args.action, lambda: broker.dead_letter_detail(args.topic, group),
                   {"requeue": lambda ids: broker.requeue_dead_letters(args.topic, group,
                                                                       msg_ids=ids),
                    "purge": lambda ids: broker.purge_dead_letters(args.topic, group,
                                                                   msg_ids=ids)},
                   f"{args.topic}/{group}", args.id)
    finally:
        broker.close_sync()


def _cmd_actors(args) -> None:
    """The cluster's actor placement table from ``--app-id``'s sidecar
    (every replica renders the same one from the shared store): per type
    (id count, owners, epoch and lease-age ranges, dead owners), per id
    with ``--ids``, or the document with ``--json``."""
    addrs, headers = _resolve_sidecars(args)
    status, raw = asyncio.run(_sidecar_fetch(addrs[0], "GET", "/v1.0/actors", headers,
                                             timeout=10))
    if status == 404:
        raise SystemExit("actor API not found — is TASKSRUNNER_ACTORS=1 set on the app?")
    if status >= 400:
        raise SystemExit(f"HTTP {status}: {raw.decode('utf-8', 'replace')}")
    doc = json.loads(raw)
    if args.json:
        print(json.dumps(doc, indent=2))
        return
    placement = doc.get("placement") or []
    if not placement:
        types = ", ".join((doc.get("replica") or {}).get("types") or []) or "(none)"
        print(f"no actors placed yet (hosted types: {types})")
        return
    if args.ids:
        width = max(5, max(len(f"{r['type']}/{r['id']}") for r in placement))
        print(f"{'ACTOR':<{width}}  {'OWNER':<28}  {'EPOCH':>5}  {'LEASE-AGE':>9}  ALIVE")
        for r in placement:
            print(f"{r['type'] + '/' + r['id']:<{width}}  {r.get('owner') or '-':<28}  "
                  f"{r.get('epoch') or 0:>5}  {r.get('lease_age', 0):>8.1f}s  "
                  f"{'yes' if r.get('alive') else 'NO'}")
        return
    by_type: dict[str, list[dict]] = {}
    for r in placement:
        by_type.setdefault(r["type"], []).append(r)
    width = max(4, max(len(t) for t in by_type))
    print(f"{'TYPE':<{width}}  {'IDS':>4}  {'OWNERS':>6}  {'EPOCH':>8}  {'LEASE-AGE':>12}  DEAD")
    for atype, rows in sorted(by_type.items()):
        owners = {r.get("owner") for r in rows if r.get("owner")}
        epochs = [int(r.get("epoch") or 0) for r in rows]
        ages = [float(r.get("lease_age") or 0.0) for r in rows]
        dead = sum(1 for r in rows if not r.get("alive"))
        print(f"{atype:<{width}}  {len(rows):>4}  {len(owners):>6}  "
              f"{min(epochs)}-{max(epochs):<4}  {min(ages):>5.1f}-{max(ages):<5.1f}  "
              f"{dead or '-'}")


def _cmd_workflows(args) -> None:
    """The workflow plane through ``--app-id``'s sidecar: the instances,
    one instance (``--history``: its events), or a start, a termination
    or an external event."""
    if (args.terminate or args.raise_event or args.history) and not args.instance:
        raise SystemExit("this operation needs an instance id")
    addrs, headers = _resolve_sidecars(args)
    input_doc = json.loads(args.input) if args.input else None
    base = "/v1.0/workflows/engine"
    if args.start:
        target = f"{base}/{quote(args.start)}/start" + (
            f"?{urlencode({'instanceID': args.instance})}" if args.instance else "")
        method, body = "POST", input_doc
    elif args.terminate:
        target, method, body = f"{base}/{args.instance}/terminate", "POST", {
            "reason": args.reason}
    elif args.raise_event:
        target = f"{base}/{args.instance}/raiseEvent/{quote(args.raise_event)}"
        method, body = "POST", input_doc
    elif args.instance:
        target = f"{base}/{args.instance}" + ("/history" if args.history else "")
        method, body = "GET", None
    else:
        target, method, body = "/v1.0/workflows", "GET", None
    status, raw = asyncio.run(_sidecar_fetch(
        addrs[0], method, target, headers, b"" if body is None else json.dumps(body).encode(),
        timeout=15))
    if status == 404 and not args.instance and not args.start:
        raise SystemExit("workflow API not found — is TASKSRUNNER_WORKFLOWS=1 set on the app?")
    if status >= 400:
        raise SystemExit(f"HTTP {status}: {raw.decode('utf-8', 'replace')}")
    if not raw:
        print("ok")
        return
    doc = json.loads(raw)
    if (args.json or args.history or args.start or not isinstance(doc, dict)
            or "instances" not in doc):
        print(json.dumps(doc, indent=2))
        return
    rows = doc["instances"]
    if not rows:
        print("no workflow instances")
        return
    width = max(8, max(len(r["instance"]) for r in rows))
    wfw = max(8, max(len(r.get("workflow") or "") for r in rows))
    print(f"{'INSTANCE':<{width}}  {'WORKFLOW':<{wfw}}  {'STATUS':<10}  {'EVENTS':>6}  PARENT")
    for r in rows:
        print(f"{r['instance']:<{width}}  {r.get('workflow') or '-':<{wfw}}  "
              f"{r.get('status') or '-':<10}  {r.get('events') or 0:>6}  "
              f"{r.get('parent') or '-'}")


#: the verbs whose modules are not ported yet, with their ROADMAP items
NOT_PORTED = {"chaos": "A23", "lint": "A27", "verify": "A27"}


def _cmd_not_ported(args) -> None:
    raise SystemExit(f"ERROR: {args.command} is not ported yet "
                     f"(ROADMAP {NOT_PORTED[args.command]})")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=PROG,
        description="The PyTorch port's app host, app server, sidecar and orchestrator.")
    parser.add_argument("--log-level", default="info",
                        choices=["debug", "info", "warning", "error"])
    sub = parser.add_subparsers(dest="command", required=True)

    def device_option(p: argparse.ArgumentParser) -> None:
        p.add_argument("--device", default=None,
                       help="the device to run on: the card (cuda:0) unless 'cpu' is given")

    p = sub.add_parser("host", help="run one app and its sidecar in one process")
    p.add_argument("module", help="pkg.module:factory producing a tasksrunner_torch App")
    p.add_argument("--app-id", default=None, help="override the App's app-id")
    p.add_argument("--app-port", type=int, default=0)
    p.add_argument("--sidecar-port", type=int, default=0)
    p.add_argument("--host", default="127.0.0.1",
                   help="app server bind address (0.0.0.0 = external ingress)")
    p.add_argument("--components", default=None)
    p.add_argument("--registry-file", default=".tasksrunner/apps.json")
    p.add_argument("--no-register", action="store_true")
    device_option(p)
    p.set_defaults(fn=_cmd_host)

    p = sub.add_parser("serve", help="run an app server only (no sidecar)")
    p.add_argument("module")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--sidecar-port", type=int, default=None,
                   help="port of the sidecar this app's client talks to")
    device_option(p)
    p.set_defaults(fn=_cmd_serve)

    p = sub.add_parser("sidecar", help="run a sidecar for an app process")
    p.add_argument("--app-id", required=True)
    p.add_argument("--app-port", type=int, required=True)
    p.add_argument("--port", type=int, default=3500)
    p.add_argument("--components", default=None)
    p.add_argument("--registry-file", default=".tasksrunner/apps.json")
    device_option(p)
    p.set_defaults(fn=_cmd_sidecar)

    p = sub.add_parser("run", help="run a run file's apps under the orchestrator")
    p.add_argument("config", help="the run file (YAML) naming tasksrunner_torch apps")
    p.add_argument("--standby", action="store_true",
                   help="wait for the control-plane lease and take over when the current "
                        "orchestrator dies")
    p.add_argument("--no-adopt", action="store_true",
                   help="respawn replicas instead of adopting the live ones a previous "
                        "orchestrator left running")
    device_option(p)
    p.set_defaults(fn=_cmd_run)

    registry = dict(default=".tasksrunner/apps.json",
                    help="the registry file of the running apps (the run file's registry_file)")
    for name, fn, text in (("restart", _cmd_restart, "rolling-restart an app's replicas"),
                           ("revisions", _cmd_revisions, "an app's config-change history")):
        p = sub.add_parser(name, help=text)
        p.add_argument("app_id")
        p.add_argument("--registry-file", **registry)
        p.set_defaults(fn=fn)

    p = sub.add_parser("shards", help="elastic-placement status of sharded stores (routing "
                                      "epoch, heat ranking, migrations, rebalance plan) from "
                                      "the orchestrator admin plane")
    p.add_argument("--registry-file", **registry)
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.set_defaults(fn=_cmd_shards)

    p = sub.add_parser("repl", help="replication status of a replicated store (leases, "
                                    "per-member positions) straight from its sqlite files")
    p.add_argument("database", help="base sqlite path of the store (e.g. data/tasks.db)")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.set_defaults(fn=_cmd_repl)

    p = sub.add_parser("logs", help="the newest output of an app's replicas")
    p.add_argument("app_id")
    p.add_argument("--tail", type=int, default=100)
    p.add_argument("--replica", type=int, default=None)
    p.add_argument("--registry-file", **registry)
    p.set_defaults(fn=_cmd_logs)

    p = sub.add_parser("scale", help="change an app's replica bounds")
    p.add_argument("app_id")
    p.add_argument("--min-replicas", type=int, default=None)
    p.add_argument("--max-replicas", type=int, default=None)
    p.add_argument("--registry-file", **registry)
    p.set_defaults(fn=_cmd_scale)

    p = sub.add_parser("update", help="apply an env change as a new revision")
    p.add_argument("app_id")
    p.add_argument("--set-env", action="append", metavar="KEY=VALUE")
    p.add_argument("--remove-env", action="append", metavar="KEY")
    p.add_argument("--registry-file", **registry)
    p.set_defaults(fn=_cmd_update)

    p = sub.add_parser("ps", help="the registered replicas and their health")
    p.add_argument("--registry-file", **registry)
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.set_defaults(fn=_cmd_ps)

    p = sub.add_parser("stop", help="SIGTERM every registered replica of an app")
    p.add_argument("app_id")
    p.add_argument("--registry-file", **registry)
    p.set_defaults(fn=_cmd_stop)

    p = sub.add_parser("deploy", help="validate / what-if / apply / down an environment "
                                      "manifest")
    p.add_argument("action", choices=["validate", "what-if", "apply", "down"])
    p.add_argument("manifest")
    p.set_defaults(fn=_cmd_deploy)

    p = sub.add_parser("secret", help="read a secret via a running app's sidecar")
    p.add_argument("store")
    p.add_argument("key")
    p.add_argument("--app-id", required=True)
    p.add_argument("--registry-file", **registry)
    p.set_defaults(fn=_cmd_secret)

    p = sub.add_parser("traces", help="inspect recorded traces (transaction search, span "
                                      "tree, critical path, service map)")
    p.add_argument("action", choices=["list", "show", "critical", "map", "query"])
    p.add_argument("trace_id", nargs="?", default=None,
                   help="trace id for `show`/`critical`; SQL for `query`")
    p.add_argument("--db", default=".tasksrunner/traces.db",
                   help="span DB path; comma-separate several to assemble one trace across "
                        "replicas")
    p.add_argument("--limit", type=int, default=20)
    p.add_argument("--mermaid", action="store_true",
                   help="emit the service map as a mermaid graph")
    p.set_defaults(fn=_cmd_traces)

    p = sub.add_parser("flightrec", help="inspect black-box flight-recorder dumps")
    p.add_argument("--dir", default=".tasksrunner/flightrec",
                   help="dump directory (TASKSRUNNER_FLIGHTREC_DIR)")
    p.add_argument("--dump", default=None, help="render one dump file instead of listing")
    p.add_argument("--limit", type=int, default=40,
                   help="ring entries shown from the end of a dump")
    p.set_defaults(fn=_cmd_flightrec)

    p = sub.add_parser("components", help="validate a components directory")
    p.add_argument("path")
    p.add_argument("--app-id", default=None, help="show only components in this app's scope")
    p.set_defaults(fn=_cmd_components)

    p = sub.add_parser("invoke", help="call a method on a running app via its sidecar")
    p.add_argument("app_id")
    p.add_argument("method", help='route, e.g. "api/tasks?createdBy=a@x.com"')
    p.add_argument("--verb", default="GET",
                   choices=["GET", "POST", "PUT", "DELETE", "PATCH",
                            "get", "post", "put", "delete", "patch"])
    p.add_argument("--data", default=None, help="JSON body or @file")
    p.add_argument("--registry-file", **registry)
    p.set_defaults(fn=_cmd_invoke)

    p = sub.add_parser("publish", help="publish an event through a running app's sidecar")
    p.add_argument("pubsub", help="pub/sub component name")
    p.add_argument("topic")
    p.add_argument("--app-id", required=True,
                   help="whose sidecar to publish through (decides scope)")
    p.add_argument("--data", default=None, help="JSON payload or @file")
    p.add_argument("--count", type=int, default=1,
                   help="flood N copies concurrently (a scale-out load test)")
    p.add_argument("--registry-file", **registry)
    p.set_defaults(fn=_cmd_publish)

    p = sub.add_parser("state", help="raw state-store probes via a running app's sidecar")
    p.add_argument("action", choices=["get", "set", "delete", "query"])
    p.add_argument("store", help="state component name, e.g. statestore")
    p.add_argument("key", nargs="?", default=None)
    p.add_argument("--app-id", required=True)
    p.add_argument("--data", default=None,
                   help="JSON value (set) or query document (query)")
    p.add_argument("--registry-file", **registry)
    p.set_defaults(fn=_cmd_state)

    p = sub.add_parser("metrics", help="an app's request/publish/delivery counters")
    p.add_argument("app_id_pos", nargs="?", default=None, metavar="app_id")
    p.add_argument("--app-id", dest="app_id", default=None)
    p.add_argument("--json", action="store_true")
    p.add_argument("--percentiles", action="store_true",
                   help="p50/p95/p99 latency per histogram series, merged across every "
                        "replica of the app")
    p.add_argument("--slow", default=None, metavar="NAME",
                   help="trace exemplars behind the latency tail: slow observations of "
                        "histograms matching NAME")
    p.add_argument("--registry-file", **registry)
    p.set_defaults(fn=_cmd_metrics)

    p = sub.add_parser("dlq", help="inspect / requeue / purge a pubsub consumer group's or a "
                                   "queue binding's dead letters")
    p.add_argument("action", choices=["list", "show", "requeue", "purge"])
    p.add_argument("component", help="pubsub or queue-binding component name")
    p.add_argument("topic", nargs="?", default=None, help="topic (pub/sub components only)")
    p.add_argument("--group", default=None, help="consumer group (defaults to --app-id)")
    p.add_argument("--app-id", default=None)
    p.add_argument("--id", action="append",
                   help="requeue or purge only these message ids (repeatable)")
    p.add_argument("--resources", default="components",
                   help="components directory holding the component's YAML")
    p.add_argument("--base-dir", default=".",
                   help="directory a relative brokerPath or queuePath resolves against (the "
                        "run file's directory)")
    p.set_defaults(fn=_cmd_dlq)

    p = sub.add_parser("actors", help="the virtual-actor placement table (type → ids → owner "
                                      "→ lease/epoch)")
    p.add_argument("--app-id", required=True,
                   help="any actor-hosting app; every replica serves the same table")
    p.add_argument("--ids", action="store_true",
                   help="one row per actor id instead of the per-type aggregate")
    p.add_argument("--json", action="store_true")
    p.add_argument("--registry-file", **registry)
    p.set_defaults(fn=_cmd_actors)

    p = sub.add_parser("workflows", help="durable workflow instances (list / status / start / "
                                         "terminate / raise)")
    p.add_argument("instance", nargs="?", default=None,
                   help="instance id: show its status (default lists all)")
    p.add_argument("--app-id", required=True, help="any workflow-hosting app replica")
    p.add_argument("--history", action="store_true",
                   help="dump the instance's full event history")
    p.add_argument("--start", default=None, metavar="WORKFLOW",
                   help="start WORKFLOW (optionally with a fixed instance id and --input)")
    p.add_argument("--terminate", action="store_true",
                   help="terminate the instance (--reason records why)")
    p.add_argument("--reason", default="terminated")
    p.add_argument("--raise-event", default=None, metavar="EVENT",
                   help="deliver external event EVENT (payload via --input)")
    p.add_argument("--input", default=None, help="JSON payload for --start / --raise-event")
    p.add_argument("--json", action="store_true")
    p.add_argument("--registry-file", **registry)
    p.set_defaults(fn=_cmd_workflows)

    for name, item in NOT_PORTED.items():
        p = sub.add_parser(name, help=f"not ported yet (ROADMAP {item})")
        p.add_argument("rest", nargs=argparse.REMAINDER)
        p.set_defaults(fn=_cmd_not_ported)
    return parser


#: the long-running commands: each configures its own role-tagged logging
_SERVERS = ("host", "serve", "sidecar", "run")


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if args.command not in _SERVERS:
        logging.basicConfig(level=getattr(logging, args.log_level.upper()),
                            format="%(asctime)s %(name)s %(levelname)s %(message)s",
                            stream=sys.stderr)
    if "device" in vars(args):  # the commands that run apps, not their clients
        from tasksrunner_torch.device import resolve_device  # torch: not for the clients

        try:
            # the card unless the CPU is asked for; raises without one
            resolve_device(args.device)
        except RuntimeError as exc:
            raise SystemExit(f"ERROR: {exc}") from exc
    try:
        args.fn(args)
    except TasksRunnerError as exc:
        raise SystemExit(f"ERROR: {exc}") from exc
    except BrokenPipeError:
        # the reader of stdout went away (``... traces list | head``)
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        raise SystemExit(0) from None
