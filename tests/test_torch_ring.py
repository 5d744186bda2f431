"""The port's sequence-parallel path (tasksrunner_torch/flash.py's ring
block update, ring.py, mesh.py and the model's ``mesh`` argument) against
the JAX package on the CPU: the same numpy inputs go through both; the
JAX ring runs its Pallas block update in interpret mode inside
``shard_map`` over the virtual CPU devices."""

import functools
import signal

import numpy as np
import pytest
import torch

from tasksrunner.ml.platform import pin_cpu_platform

if not pin_cpu_platform():
    pytest.skip("jax cpu platform unavailable", allow_module_level=True)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P  # noqa: E402

from tasksrunner.ml import flash as jax_flash, model as jax_model, ring as jax_ring  # noqa: E402
from tasksrunner_torch import flash, model, ring  # noqa: E402
from tasksrunner_torch.mesh import Mesh  # noqa: E402

# __graft_entry__.py's dryrun config
DRYRUN = dict(vocab=512, seq_len=16, d_model=64, n_heads=4, d_ff=128, n_layers=2)


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test fails after 120 s instead of holding the suite."""
    def expire(signum, frame):
        raise TimeoutError("the test ran past its 120 s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def _jax_mesh(sp):
    return JaxMesh(np.array(jax.devices()[:sp]).reshape(1, sp, 1), ("dp", "sp", "tp"))


def _block_inputs(start: bool, seed=9):
    """test_ml_extension.py:277-296's shapes and state (q [2, 16, 2, 32],
    k/v [2, 24, 2, 32]), or the ring's first-step state (-inf, 0, 0)."""
    rng = np.random.default_rng(seed)
    b, sq, sk, h, d = 2, 16, 24, 2, 32
    q = rng.standard_normal((b, sq, h, d), np.float32)
    k, v = (rng.standard_normal((b, sk, h, d), np.float32) for _ in range(2))
    if start:
        m = np.full((b, h, sq), -np.inf, np.float32)
        num = np.zeros((b, h, sq, d), np.float32)
        den = np.zeros((b, h, sq), np.float32)
    else:
        m = rng.standard_normal((b, h, sq), np.float32)
        num = rng.standard_normal((b, h, sq, d), np.float32)
        den = np.log1p(np.exp(rng.standard_normal((b, h, sq)))).astype(np.float32)
    return (q, k, v, m, num, den), 1.0 / d ** 0.5


@pytest.mark.parametrize("start", [False, True], ids=["later-step", "first-step"])
def test_ring_block_update_matches_jax(start):
    inputs, scale = _block_inputs(start)
    got = flash.ring_block_update(*map(torch.from_numpy, inputs), scale=scale)
    pallas = jax.jit(functools.partial(jax_flash.ring_block_update, scale=scale))(*inputs)
    einsum = jax_ring._block_update(*inputs, scale=scale)
    for g, p, e in zip(got, pallas, einsum):
        assert g.dtype == torch.float32 and np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("start", [False, True], ids=["later-step", "first-step"])
def test_ring_block_update_gradients_match_jax_vjp(start):
    """RingBlockUpdate's backward (the plain update differentiated) against
    jax.vjp of ring._block_update. On the first step m, num and den are
    constants of the ring and get no gradient."""
    inputs, scale = _block_inputs(start, seed=10)
    rng = np.random.default_rng(11)
    cots = [rng.standard_normal(x.shape, np.float32) for x in (inputs[3], inputs[4], inputs[5])]
    _, vjp = jax.vjp(lambda *a: jax_ring._block_update(*a, scale=scale), *inputs)
    want = vjp(tuple(cots))
    leaves = [torch.from_numpy(x).requires_grad_(not start or i < 3)
              for i, x in enumerate(inputs)]
    outs = ring.RingBlockUpdate.apply(*leaves, scale)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    for i, (leaf, w) in enumerate(zip(leaves, want)):
        if start and i >= 3:
            assert leaf.grad is None
            continue
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_ring_attention_matches_jax_ring_and_dense():
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 16, 4, 16), np.float32) for _ in range(3))
    mesh = _jax_mesh(4)
    want = jax.jit(lambda q, k, v: jax_ring.ring_attention(q, k, v, mesh=mesh))(q, k, v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ring.ring_attention(tq, tk, tv, mesh=Mesh(sp=4))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 4, 16)
    # another summation order in f32; the same bf16 rounding points
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    dense = model._einsum_attention(tq, tk, tv)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-2)  # test_ml_extension.py:155


def _dryrun_inputs(batch=4, seed=3):
    jcfg = jax_model.ModelConfig(**DRYRUN)
    tree = jax.tree.map(np.asarray, jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, jcfg.vocab, (batch, jcfg.seq_len), dtype=np.int32)
    labels = rng.integers(0, jcfg.n_classes, (batch,), dtype=np.int32)
    return jcfg, model.ModelConfig(**DRYRUN), tree, tokens, labels


@pytest.mark.parametrize("flash_on", ["1", "0"], ids=["flash", "einsum"])
@pytest.mark.parametrize("sp", [2, 4])
def test_logits_with_mesh_match_jax(sp, flash_on, monkeypatch):
    monkeypatch.setenv("TASKSRUNNER_FLASH", flash_on)
    jcfg, tcfg, tree, tokens, _ = _dryrun_inputs()
    mesh = _jax_mesh(sp)
    want = jax.jit(lambda p, t: jax_model.forward(p, t, cfg=jcfg, mesh=mesh))(tree, tokens)
    got = model.forward(model.params_from_jax(tree, "cpu"), torch.from_numpy(tokens),
                        cfg=tcfg, mesh=Mesh(sp=sp))
    assert got.shape == (4, tcfg.n_classes) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2, rtol=2e-2)


def test_sequence_parallel_train_step_matches_jax():
    """One step of make_train_step(cfg, mesh) at sp 4, held to the
    dryrun's limits (__graft_entry__.py:136-155): loss 1e-2, leaves 2e-2."""
    jcfg, tcfg, tree, tokens, labels = _dryrun_inputs()
    mesh = _jax_mesh(4)
    lr = 0.1
    with mesh:
        params = jax_model.shard_params(jax.tree.map(jnp.asarray, tree), mesh, jcfg)
        want_params, want_loss = jax_model.make_train_step(jcfg, mesh, learning_rate=lr)(
            params, jax.device_put(tokens, NamedSharding(mesh, P("dp", "sp"))),
            jax.device_put(labels, NamedSharding(mesh, P("dp"))))
        want_params = jax.tree.map(np.asarray, want_params)
    params = model.params_from_jax(tree, "cpu")
    got_params, got_loss = model.make_train_step(tcfg, Mesh(sp=4), learning_rate=lr)(
        params, torch.from_numpy(tokens), torch.from_numpy(labels))
    assert abs(float(got_loss) - float(want_loss)) <= 1e-2
    got = [got_params[key].numpy() for key in ("embed", "head", "pos")]
    want = [want_params[key] for key in ("embed", "head", "pos")]
    for g_layer, w_layer in zip(got_params["layers"], want_params["layers"]):
        got += [g_layer[key].numpy() for key in sorted(g_layer)]
        want += [w_layer[key] for key in sorted(g_layer)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=2e-2, rtol=0)
    moved = max(np.abs(g - t).max() for g, t in zip(
        got, [tree[key] for key in ("embed", "head", "pos")]
        + [layer[key] for layer in tree["layers"] for key in sorted(layer)]))
    assert moved > 1e-3


def test_a_mesh_that_does_not_fit_is_refused():
    cfg = model.ModelConfig(**DRYRUN)
    with pytest.raises(ValueError, match="divide"):
        model.make_train_step(cfg, Mesh(sp=3))
    with pytest.raises(ValueError, match="at least 1"):
        Mesh(sp=0)
    assert Mesh(sp=4).axis_names == ("dp", "sp", "tp")
    assert Mesh(sp=4).shape == {"dp": 1, "sp": 4, "tp": 1}


@pytest.mark.parametrize("bad", ["d_head", "heads", "state_dtype", "q_dtype"])
def test_ring_block_update_refuses_what_the_kernel_does_not_take(bad):
    inputs, scale = _block_inputs(start=False)
    q, k, v, m, num, den = map(torch.from_numpy, inputs)
    if bad == "d_head":
        q, k, v, num = q[..., :24], k[..., :24], v[..., :24], num[..., :24]
    elif bad == "heads":
        k, v = k[:, :, :1], v[:, :, :1]
    elif bad == "state_dtype":
        m = m.double()
    else:
        q = q.half()
    with pytest.raises((ValueError, TypeError)):
        flash.ring_block_update(q, k, v, m, num, den, scale=scale)
