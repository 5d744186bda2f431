"""The port's dp × sp × tp sharded train step and multichip dryrun
(tasksrunner_torch/mesh.py, model.py, graft_entry.py) against the JAX
single-device step, and the serving split over several devices.

One module-scoped spawn of 8 gloo CPU workers runs every sharded case,
each on a subgroup of the first dp·sp·tp workers (tests/test_ml_extension.py's
factorization matrix, the dryrun's default factorizations of 8 and 4, the
dp×tp step of :62-90, a ring whose rotations are dropped). The workers take
the JAX ``init_params`` trees as numpy arrays and import no JAX: this
module imports JAX only inside the functions that run in the parent."""

import datetime
import json
import multiprocessing
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tasksrunner_torch import graft_entry, model, ring, service
from tasksrunner_torch.mesh import Mesh

RANKS = 8
JOIN_S = 240  # the whole group, start to finish, on a loaded machine
DRYRUN = dict(vocab=512, seq_len=16, d_model=64, n_heads=4, d_ff=128, n_layers=2)
TINY = dict(vocab=256, seq_len=8, d_model=32, n_heads=2, d_ff=64, n_layers=2)
CONFIGS = {"dryrun": (DRYRUN, 0), "tiny": (TINY, 1)}  # (config, PRNGKey of the params)

# name: (config, dp, sp, tp)
STEPS = {
    "tp-only": ("dryrun", 1, 1, 2),  # test_ml_extension.py:319-335
    "dp-only": ("dryrun", 2, 1, 1),
    "dp-tp": ("dryrun", 2, 1, 2),
    "wide-dp": ("dryrun", 4, 1, 2),
    "sp-heavy": ("dryrun", 1, 4, 2),
    "default-8": ("dryrun", *graft_entry.default_factorization(8)),  # 2 × 2 × 2
    "default-4": ("dryrun", *graft_entry.default_factorization(4)),  # 1 × 2 × 2
    "tiny-dp-tp": ("tiny", 4, 1, 2),  # test_ml_extension.py:62-90
}
DROPPED = ("dryrun", 2, 2, 2)  # the ring with its rotations dropped


def _config(name: str) -> model.ModelConfig:
    return model.ModelConfig(**CONFIGS[name][0])


def _inputs(name: str, dp: int) -> tuple[np.ndarray, np.ndarray]:
    """The dryrun's inputs (batch max(2·dp, 4)); for the tiny config,
    test_ml_extension.py:73-74's hashed texts and labels."""
    cfg = _config(name)
    if name == "dryrun":
        return graft_entry.dryrun_inputs(cfg, max(2 * dp, 4))
    tokens = model.hash_tokens([f"alpha beta {i}" for i in range(16)], cfg, "cpu")
    return tokens.numpy(), np.arange(16, dtype=np.int32) % cfg.n_classes


def _dropped_rotation(k_blk, v_blk, mesh):
    """ring._rotate that hands back this rank's own block: K and V never
    reach the other sp ranks."""
    return k_blk, v_blk


def _run_case(mesh, name, cfg_name, trees, tmp):
    cfg = _config(cfg_name)
    tokens, labels = (torch.from_numpy(x) for x in _inputs(cfg_name, mesh.dp))
    params = model.params_from_jax(trees[cfg_name], "cpu")
    result = graft_entry.sharded_step_rank(mesh, cfg, params, tokens, labels)
    if dist.get_rank(mesh.group) == 0:
        torch.save({"loss": result["loss"], "params": result["params"],
                    "launches": result["launches"]}, f"{tmp}/{name}.pt")


def _round_trip(mesh, trees, tmp):
    """shard_params then gather_params over tp; the shards' shapes against
    param_specs; a leaf changed on one rank caught by the dryrun's check."""
    params = model.params_from_jax(trees["dryrun"], "cpu")
    shards = model.shard_params(params, mesh)
    whole = model.gather_params(shards, mesh)
    specs = model._leaves(model.param_specs(_config("dryrun")))
    shapes_ok = all(
        s.shape == tuple(n // mesh.tp if axis == "tp" else n for n, axis in zip(p.shape, spec))
        for s, p, spec in zip(model._leaves(shards), model._leaves(params), specs))
    copies = all(s.is_contiguous() and s.untyped_storage().data_ptr()
                 != p.untyped_storage().data_ptr()
                 for s, p in zip(model._leaves(shards), model._leaves(params)))
    exact = all(torch.equal(a, b) for a, b in zip(model._leaves(whole),
                                                   model._leaves(params)))
    if mesh.coords == (0, 1, 0):
        whole["head"] += 1e-6
    try:
        graft_entry._check_same_on_every_rank(whole, mesh)
        caught = False
    except AssertionError:
        caught = True
    rank = dist.get_rank(mesh.group)
    with open(f"{tmp}/round_trip.rank{rank}.json", "w") as f:
        json.dump({"coords": mesh.coords, "shapes_ok": shapes_ok, "copies": copies,
                   "exact": exact, "caught": caught}, f)


def _worker(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=RANKS, timeout=datetime.timedelta(seconds=60))
    try:
        trees = {name: torch.load(f"{tmp}/{name}.params.pt", weights_only=True)
                 for name in CONFIGS}
        for name, (cfg_name, dp, sp, tp) in [*STEPS.items(), ("dropped", DROPPED)]:
            mesh = Mesh.over(list(range(dp * sp * tp)), dp=dp, sp=sp, tp=tp)
            if mesh is None:
                continue
            real = ring._rotate
            if name == "dropped":
                ring._rotate = _dropped_rotation
            try:
                _run_case(mesh, name, cfg_name, trees, tmp)
            except Exception:
                with open(f"{tmp}/{name}.rank{rank}.error", "w") as f:
                    f.write(traceback.format_exc())
            finally:
                ring._rotate = real
        _round_trip(Mesh.over(list(range(RANKS)), dp=2, sp=2, tp=2), trees, tmp)
    finally:
        dist.destroy_process_group()


def _jax_trees() -> dict:
    """The JAX init_params tree of each config, as numpy arrays."""
    import jax
    from tasksrunner.ml.model import ModelConfig as JaxConfig, init_params

    return {name: jax.tree.map(np.asarray, init_params(JaxConfig(**cfg),
                                                       jax.random.PRNGKey(key)))
            for name, (cfg, key) in CONFIGS.items()}


def _jax_step(cfg_name: str, tree: dict, tokens: np.ndarray, labels: np.ndarray):
    """The JAX single-device step (flash core, Pallas interpret mode on
    the CPU): (loss, updated tree as the port's params)."""
    import jax
    import jax.numpy as jnp
    from tasksrunner.ml.model import ModelConfig as JaxConfig, make_train_step

    params = jax.tree.map(jnp.asarray, tree)
    new, loss = make_train_step(JaxConfig(**CONFIGS[cfg_name][0]))(
        params, jnp.asarray(tokens), jnp.asarray(labels))
    return float(loss), model.params_from_jax(jax.tree.map(np.asarray, new), "cpu")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every case's result from the 8 workers, and the JAX single-device
    step of each config and batch, computed while the workers run."""
    tmp = tmp_path_factory.mktemp("sharding")
    trees = _jax_trees()
    for name, tree in trees.items():
        torch.save(model.params_from_jax(tree, "cpu"), tmp / f"{name}.params.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, str(tmp))) for r in range(RANKS)]
    for p in procs:
        p.start()
    try:
        references = {}
        for cfg_name, dp, _, _ in [*STEPS.values(), DROPPED]:
            tokens, labels = _inputs(cfg_name, dp)
            key = (cfg_name, tokens.shape[0])
            if key not in references:
                references[key] = _jax_step(cfg_name, trees[cfg_name], tokens, labels)
        deadline = datetime.datetime.now() + datetime.timedelta(seconds=JOIN_S)
        for p in procs:
            p.join(timeout=max(0.0, (deadline - datetime.datetime.now()).total_seconds()))
    finally:
        hung = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert not hung, f"workers still running after {JOIN_S} s: pids {hung}"
    assert [p.exitcode for p in procs] == [0] * RANKS
    return tmp, trees, references


def _case(run, name):
    tmp, _, _ = run
    errors = sorted(tmp.glob(f"{name}.rank*.error"))
    assert not errors, errors[0].read_text()
    return torch.load(tmp / f"{name}.pt", weights_only=True)


def _reference(run, cfg_name, dp):
    _, _, references = run
    return references[(cfg_name, _inputs(cfg_name, dp)[0].shape[0])]


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_step_matches_the_jax_single_device_step(run, name):
    """The dryrun's check (loss 1e-2, every leaf finite and within 2e-2),
    against the JAX step from the same params and tokens."""
    cfg_name, dp, _, _ = STEPS[name]
    got = _case(run, name)
    want_loss, want_params = _reference(run, cfg_name, dp)
    graft_entry.verify_step(got["loss"], got["params"], want_loss, want_params)


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_updates_match_the_jax_updates(run, name):
    """At lr 1e-3 the leaf check cannot see a gradient off by a factor:
    each leaf's update against JAX's, within 5e-2 of its largest
    (graft_entry.verify_step given the starting tree)."""
    cfg_name, dp, _, _ = STEPS[name]
    _, trees, _ = run
    got = _case(run, name)
    want_loss, want_params = _reference(run, cfg_name, dp)
    graft_entry.verify_step(got["loss"], got["params"], want_loss, want_params,
                            model.params_from_jax(trees[cfg_name], "cpu"))


def test_sharded_step_launches_no_kernel_on_the_cpu(run):
    """On CPU tensors every core runs its plain version: the counts the
    body reads around the step stay 0."""
    for name in STEPS:
        assert set(_case(run, name)["launches"].values()) == {0}


def test_a_ring_with_dropped_rotations_diverges(run):
    """The counterpart of test_ml_extension.py:106-126: a ring whose K/V
    blocks never travel fails the dryrun's check."""
    cfg_name, dp, _, _ = DROPPED
    got = _case(run, "dropped")
    want_loss, want_params = _reference(run, cfg_name, dp)
    with pytest.raises(AssertionError, match="diverge"):
        graft_entry.verify_step(got["loss"], got["params"], want_loss, want_params)


def test_shard_and_gather_round_trip_the_tree_exactly(run):
    tmp, _, _ = run
    ranks = [json.loads((tmp / f"round_trip.rank{r}.json").read_text())
             for r in range(RANKS)]
    assert all(r["shapes_ok"] and r["copies"] and r["exact"] for r in ranks), ranks


def test_a_leaf_that_differs_between_ranks_is_caught(run):
    """The body's check that every rank holds the same updated tree: the
    rank at (0, 1, 0), whose head moved by 1e-6, fails it; the others hold
    rank 0's tree."""
    tmp, _, _ = run
    ranks = [json.loads((tmp / f"round_trip.rank{r}.json").read_text())
             for r in range(RANKS)]
    assert [r["caught"] for r in ranks] == [r["coords"] == [0, 1, 0] for r in ranks]
    assert sum(r["caught"] for r in ranks) == 1


def test_param_specs_match_the_jax_specs():
    from tasksrunner.ml.model import ModelConfig as JaxConfig, param_specs

    cfg = model.ModelConfig(**DRYRUN)
    want = param_specs(JaxConfig(**DRYRUN))
    got = model.param_specs(cfg)
    assert [tuple(s) for s in model._leaves(want)] == model._leaves(got)


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    """The end-to-end dryrun: spawns its 4 ranks over gloo, runs the
    port's single-device step and holds every rank to it."""
    reports = graft_entry.dryrun_multichip(4, devices=["cpu"] * 4)
    assert sorted(tuple(r["coords"]) for r in reports) == [
        (0, i, j) for i in range(2) for j in range(2)]
    assert len({r["loss"] for r in reports}) == 1
    assert all(r["max_abs_err_leaves"] <= graft_entry.LEAF_TOL for r in reports)
    assert "dryrun_multichip ok" in capsys.readouterr().out


@pytest.mark.parametrize("call,error,match", [
    (lambda: graft_entry._dryrun_factored(8, dp=2, sp=1, tp=2, devices=["cpu"] * 8),
     ValueError, "devices"),  # test_ml_extension.py:338-344: 4 != 8
    (lambda: graft_entry._dryrun_factored(8, dp=1, sp=1, tp=8, devices=["cpu"] * 8),
     ValueError, "divide"),  # 8 does not divide n_heads=4
    (lambda: graft_entry._dryrun_factored(3, dp=1, sp=3, tp=1, devices=["cpu"] * 3),
     ValueError, "divide"),  # 3 does not divide seq_len=16
    (lambda: graft_entry.dryrun_multichip(1024), RuntimeError, "need"),  # :102-103
    (lambda: graft_entry.dryrun_multichip(4, devices=["cpu"] * 2), RuntimeError, "need"),
], ids=["devices", "divide-heads", "divide-seq", "need-cards", "need-devices"])
def test_the_dryrun_refuses_before_spawning(call, error, match):
    with pytest.raises(error, match=match):
        call()


def test_the_model_refuses_a_mesh_that_does_not_divide():
    cfg = model.ModelConfig(**DRYRUN)
    for bad in (Mesh(sp=3), Mesh(sp=32)):
        with pytest.raises(ValueError, match="divide"):
            model.make_train_step(cfg, bad)
    with pytest.raises(ValueError, match="only sp"):
        Mesh(dp=2)
    assert Mesh(sp=2).shape == {"dp": 1, "sp": 2, "tp": 1}


@pytest.mark.parametrize("bucket", [8, 3], ids=["split", "first-device"])
def test_serving_on_two_devices_equals_one_device(bucket):
    """service.batch_probs over two CPU "devices": a bucket that divides
    is split in row order, one that does not runs on the first device;
    either way the probabilities are one device's."""
    cfg = model.ModelConfig(n_classes=len(service.PRIORITY_LABELS))
    params = model.init_params(cfg, 0, "cpu")
    devices = model.serving_mesh(["cpu", "cpu"])
    assert devices == (torch.device("cpu"),) * 2 and model.serving_mesh(["cpu"]) is None
    tokens = np.random.default_rng(3).integers(1, cfg.vocab, (bucket, cfg.seq_len),
                                               dtype=np.int32)
    parts = service.place_tokens(tokens, list(devices))
    assert [i for i, _ in parts] == ([0, 1] if bucket % 2 == 0 else [0])
    two = service.batch_probs(model.replicate_params(params, devices), list(devices),
                              tokens, cfg=cfg)
    one = service.batch_probs([params], ["cpu"], tokens, cfg=cfg)
    assert two.shape == (bucket, cfg.n_classes)
    np.testing.assert_allclose(two, one, rtol=0, atol=1e-6)
