"""The port stands alone: tasksrunner_torch, chip_smoke.py and the port's
kernel sweep (scripts/sweep_torch_flash.py) import neither JAX nor
anything of the JAX package ``tasksrunner``, nor ``aiohttp`` or ``yaml``,
which the card's machine does not have."""

import ast
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "tasksrunner", "aiohttp", "yaml")


def _port_sources():
    return sorted((REPO / "tasksrunner_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "scripts" / "sweep_torch_flash.py"]


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_the_port_loads_no_jax_and_no_tasksrunner():
    modules = sorted(
        "tasksrunner_torch." + ".".join(p.relative_to(REPO / "tasksrunner_torch")
                                        .with_suffix("").parts)
        for p in (REPO / "tasksrunner_torch").rglob("*.py")
        if p.name not in ("__init__.py", "__main__.py"))
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}: importlib.import_module(name)\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    loaded = out.split()
    # every module, the request path's observability, the sidecar, the
    # orchestrator, resiliency, secrets, deploy, bindings, the query
    # dialect, the operating plane's helpers, sharded state and replica
    # sets among them
    for name in ("tasksrunner_torch.service", "tasksrunner_torch.probes",
                 "tasksrunner_torch.admission", "tasksrunner_torch.spans",
                 "tasksrunner_torch.tracing", "tasksrunner_torch.sidecar",
                 "tasksrunner_torch.runtime", "tasksrunner_torch.cli",
                 "tasksrunner_torch.state.sqlite", "tasksrunner_torch.pubsub.sqlite",
                 "tasksrunner_torch.component.blockyaml",
                 "tasksrunner_torch.orchestrator.config", "tasksrunner_torch.orchestrator.run",
                 "tasksrunner_torch.orchestrator.autoscale",
                 "tasksrunner_torch.orchestrator.admin", "tasksrunner_torch.state.lease",
                 "tasksrunner_torch.resiliency.policy", "tasksrunner_torch.resiliency.spec",
                 "tasksrunner_torch.secrets.base", "tasksrunner_torch.secrets.local",
                 "tasksrunner_torch.secrets.resolver", "tasksrunner_torch.secrets.drivers",
                 "tasksrunner_torch.deploy.manifest", "tasksrunner_torch.deploy.plan",
                 "tasksrunner_torch.bindings.base", "tasksrunner_torch.bindings.localqueue",
                 "tasksrunner_torch.bindings.cron", "tasksrunner_torch.bindings.blobstore",
                 "tasksrunner_torch.bindings.email", "tasksrunner_torch.state.query",
                 "tasksrunner_torch.ids", "tasksrunner_torch.names",
                 "tasksrunner_torch.flightrec", "tasksrunner_torch.logconfig",
                 "tasksrunner_torch.eventloop", "tasksrunner_torch.state.sharding",
                 "tasksrunner_torch.state.placement",
                 "tasksrunner_torch.orchestrator.placement",
                 "tasksrunner_torch.state.replication"):
        assert name in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_no_source_of_the_port_imports_jax_or_tasksrunner():
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not [n for n in names if _forbidden(n)], (path, node.lineno)


def test_a_replicated_store_and_the_repl_verb_load_no_jax(tmp_path):
    """A 2-shard × 3-member store built from component metadata takes writes, hands a
    shard's leadership over, splits and closes; then the ``repl`` verb reads
    its files: in a process where neither JAX nor the JAX package is ever
    loaded."""
    code = (
        "import asyncio, sys\n"
        "from tasksrunner_torch import cli\n"
        "from tasksrunner_torch.component.registry import ComponentRegistry\n"
        "from tasksrunner_torch.component.spec import parse_component\n"
        "meta = {'databasePath': sys.argv[1], 'shards': '2', 'replicas': '3'}\n"
        "spec = parse_component({'componentType': 'state.sqlite', 'metadata': [\n"
        "    {'name': k, 'value': v} for k, v in meta.items()]}, default_name='s')\n"
        "async def main():\n"
        "    store = ComponentRegistry([spec]).get('s')\n"
        "    await asyncio.gather(*(store.set(f'k{i}', i) for i in range(40)))\n"
        "    await store.migrate_shard(0, member='r1')\n"
        "    await store.split_shard()\n"
        "    assert [(await store.get(f'k{i}')).value for i in range(40)] == list(range(40))\n"
        "    await store.aclose()\n"
        "asyncio.run(main())\n"
        "cli.main(['repl', sys.argv[1]])\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "s.db")], cwd=REPO,
                         check=True, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "TASKSRUNNER_REPL_LEASE_SECONDS": "0.5"}).stdout
    assert "s shard 0: leader r1 (epoch 2" in out and "  r2: hwm " in out
    loaded = out.split()
    assert "tasksrunner_torch.state.replication" in loaded
    assert [m for m in loaded if _forbidden(m)] == []
