"""The port's command line: ``python -m tasksrunner_torch host|serve|sidecar``,
the port of those commands of ``tasksrunner/cli.py``.

* ``host MODULE:FACTORY --components DIR``: one app and its sidecar in
  one process (:class:`~tasksrunner_torch.hosting.AppHost`);
* ``serve MODULE:FACTORY --port P --sidecar-port S``: the app server
  alone, its client talking to the sidecar on ``S``;
* ``sidecar --app-id ID --app-port P --port S --components DIR``: a
  sidecar for an app served on ``P``.

Each prints the line the JAX command prints once it serves
(``ready app=… app_port=… sidecar_port=…``), so a script can wait for
it, and stops cleanly on SIGTERM or SIGINT. Each runs on the card:
without one the command exits non-zero, unless ``--device cpu`` is
given; there is no fallback to the CPU. ``--device`` is passed to the
app factory when the factory takes a ``device`` argument, and refused
when it does not.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import inspect
import logging
import os
import signal
import sys
from typing import Awaitable, Callable

from tasksrunner_torch.app import App
from tasksrunner_torch.client import AppClient
from tasksrunner_torch.device import resolve_device
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

    _serve(start, host.stop)


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
    from tasksrunner_torch.runtime import HTTPAppChannel, Runtime
    from tasksrunner_torch.security import grants_from_env
    from tasksrunner_torch.sidecar import Sidecar

    specs = load_components(args.components) if args.components else []
    resolver = NameResolver(registry_file=args.registry_file)
    runtime = Runtime(args.app_id, ComponentRegistry(specs, app_id=args.app_id),
                      resolver=resolver, app_channel=HTTPAppChannel("127.0.0.1", args.app_port),
                      grants=grants_from_env())
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m tasksrunner_torch",
        description="The PyTorch port's app host, app server and sidecar.")
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
    return parser


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper()),
                        format="%(asctime)s %(name)s %(levelname)s %(message)s",
                        stream=sys.stderr)
    try:
        # the card unless the CPU is asked for; raises without one
        resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"ERROR: {exc}") from exc
    try:
        args.fn(args)
    except TasksRunnerError as exc:
        raise SystemExit(f"ERROR: {exc}") from exc
