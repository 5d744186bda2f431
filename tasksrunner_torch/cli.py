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
* ``ps`` and ``stop APP_ID``: the registry file's replicas probed, or
  sent SIGTERM;
* ``deploy validate|what-if|apply|down MANIFEST``: an environment
  manifest (:mod:`tasksrunner_torch.deploy`) checked, diffed against the
  recorded state, applied (the run file that ``run`` reads, and its
  components) or taken down;
* ``secret STORE KEY --app-id ID``: one secret read through a running
  app's sidecar.

``host`` and ``sidecar`` apply the ``kind: Resiliency`` documents of
``--components`` to the app's runtime.

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
import urllib.error
import urllib.request
from typing import Awaitable, Callable

from tasksrunner_torch.app import App
from tasksrunner_torch.client import AppClient
from tasksrunner_torch.errors import TasksRunnerError


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

    asyncio.run(main())


def _cmd_host(args) -> None:
    from tasksrunner_torch.hosting import AppHost

    app = make_app(args.module, args.device)
    if args.app_id:
        app.app_id = args.app_id
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

    config = load_run_config(args.config)
    if args.standby:
        config.standby = True
    if args.no_adopt:
        config.adopt = False
    asyncio.run(run_from_config(config, device=args.device))


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
    """``GET /v1.0/secrets/{store}/{key}`` through the app's sidecar,
    found in the registry file; the reply printed, HTTP ≥ 400 an error."""
    from tasksrunner_torch.client import TOKEN_ENV, TOKEN_HEADER, http_request
    from tasksrunner_torch.errors import AppNotFound
    from tasksrunner_torch.invoke.resolver import NameResolver

    resolver = NameResolver(registry_file=args.registry_file)
    try:
        addr = resolver.resolve(args.app_id)
    except AppNotFound:
        known = ", ".join(resolver.known_apps()) or "(none registered)"
        raise SystemExit(f"app {args.app_id!r} is not registered; running apps: {known}")
    headers = {TOKEN_HEADER: os.environ[TOKEN_ENV]} if os.environ.get(TOKEN_ENV) else {}
    status, _, body = asyncio.run(asyncio.wait_for(http_request(
        addr.host, addr.sidecar_port, "GET", f"/v1.0/secrets/{args.store}/{args.key}",
        headers=headers), 30))
    text = body.decode("utf-8", "replace")
    if text:
        try:
            print(json.dumps(json.loads(text), indent=2))
        except ValueError:
            print(text)
    if status >= 400:
        raise SystemExit(f"HTTP {status}")


def _admin_request(registry_file: str, method: str, path: str,
                   body: dict | None = None) -> dict:
    """One call to the running orchestrator's admin API, whose address is
    in ``orchestrator.json`` beside the registry file; an unreadable file
    (a torn write of a killed process) is removed."""
    from tasksrunner_torch.client import TOKEN_ENV, TOKEN_HEADER
    from tasksrunner_torch.orchestrator.admin import info_path

    info_file = info_path(registry_file)
    if not info_file.is_file():
        raise SystemExit(f"no orchestrator control file at {info_file}: is "
                         "`python -m tasksrunner_torch run` running with this registry_file?")
    try:
        url = json.loads(info_file.read_text())["admin_url"] + path
    except (ValueError, KeyError, TypeError):
        info_file.unlink(missing_ok=True)
        raise SystemExit(f"orchestrator control file {info_file} was unreadable (left by a "
                         "killed orchestrator?): removed it; if `run` is live, retry in a "
                         "moment, else restart it") from None
    headers = {"content-type": "application/json"}
    if os.environ.get(TOKEN_ENV):
        headers[TOKEN_HEADER] = os.environ[TOKEN_ENV]
    req = urllib.request.Request(url, method=method, headers=headers,
                                 data=json.dumps(body).encode() if body is not None else None)
    # a rolling restart takes up to ~40 s a replica before the answer
    timeout = 300
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as exc:
        detail = exc.read().decode("utf-8", "replace")
        try:
            detail = json.loads(detail).get("error", detail)
        except (ValueError, AttributeError):
            pass
        raise SystemExit(f"orchestrator returned {exc.code}: {detail}") from None
    except OSError as exc:  # a connect-phase timeout comes as URLError(TimeoutError)
        if isinstance(exc, TimeoutError) or isinstance(getattr(exc, "reason", None),
                                                       TimeoutError):
            raise SystemExit(f"orchestrator did not answer within {timeout}s: the operation "
                             "may still be running; check `revisions`") from None
        raise SystemExit(f"cannot reach orchestrator at {url}: {exc} (a stale "
                         "orchestrator.json after a crash?)") from None


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
    from tasksrunner_torch.client import http_request
    from tasksrunner_torch.invoke.resolver import NameResolver

    row = {"app_id": app_id, "replica": index, "pid": addr.pid, "app_port": addr.app_port,
           "sidecar_port": addr.sidecar_port, "host": addr.host,
           "up_seconds": (round(time.time() - addr.registered_at)
                          if addr.registered_at else None),
           "health": "down", "components": None, "subscriptions": None}
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
        elif status == 401:
            row["components"] = row["subscriptions"] = "auth"
    except errors:
        pass
    return row


def _cmd_ps(args) -> None:
    """The registered replicas with their health; exits 2 when one is down."""
    from tasksrunner_torch.client import TOKEN_ENV, TOKEN_HEADER
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
              f"{'HEALTH':<9}  {'COMPS':>5}  {'SUBS':>4}  UP")
        for r in rows:
            print(f"{tag(r):<{width}}  {r['pid'] or '-':>7}  {r['app_port'] or '-':>5}  "
                  f"{r['sidecar_port'] or '-':>7}  {r['health']:<9}  "
                  f"{'-' if r['components'] is None else r['components']:>5}  "
                  f"{'-' if r['subscriptions'] is None else r['subscriptions']:>4}  "
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m tasksrunner_torch",
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
    return parser


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
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
