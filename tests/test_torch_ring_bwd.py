"""The ring's backward on the port's kernels (``flash.ring_block_grad``,
its plain twin, ``ring.RingAttention``) and the one-process ring's
in-place read of the visiting block, against the JAX package on the CPU:
the same numpy inputs go through both; the JAX ring runs its Pallas block
update in interpret mode inside ``shard_map`` over the virtual CPU
devices, as tests/test_torch_ring.py runs it."""

import signal

import numpy as np
import pytest
import torch

from tasksrunner.ml.platform import pin_cpu_platform

if not pin_cpu_platform():
    pytest.skip("jax cpu platform unavailable", allow_module_level=True)

import jax  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from tasksrunner.ml import ring as jax_ring  # noqa: E402
from tasksrunner_torch import flash, ring  # noqa: E402
from tasksrunner_torch.mesh import Mesh  # noqa: E402

SHAPE = (2, 16, 4, 16)  # b, s, h, d


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


def _tensors(seed, shape, n):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32)) for _ in range(n)]


@pytest.mark.parametrize("shape", [(1, 8, 4, 16), (4, 16, 4, 16)],
                         ids=lambda s: "b{}s{}h{}d{}".format(*s))
def test_ring_block_grad_reference_for_one_block_equals_flash_bwd_reference(shape):
    """With sp 1 the visiting block is the rank's own: one ring step's
    share with LSE and Δ given is the flash backward with the same LSE/Δ."""
    q, k, v, dout = _tensors(31, shape, 4)
    scale = shape[-1] ** -0.5
    out, lse = flash.flash_fwd_reference(q, k, v, scale)
    delta = flash._delta(out, dout)
    want = flash.flash_bwd_reference(q, k, v, out, lse, dout, scale, delta=delta)
    got = [torch.zeros(shape) for _ in range(3)]
    flash.ring_block_grad_reference(q, k, v, dout, lse, delta, *got, scale=scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-5)


def test_ring_block_grad_adds_into_its_accumulators():
    q, k, v, dout, dq0, dk0, dv0 = _tensors(32, SHAPE, 7)
    scale = SHAPE[-1] ** -0.5
    _, lse = flash.flash_fwd_reference(q, k, v, scale)
    delta = torch.from_numpy(np.random.default_rng(33).standard_normal(
        (SHAPE[0], SHAPE[2], SHAPE[1]), np.float32))
    fresh = [torch.zeros(SHAPE) for _ in range(3)]
    flash.ring_block_grad(q, k, v, dout, lse, delta, *fresh, scale=scale)
    added = [x.clone() for x in (dq0, dk0, dv0)]
    flash.ring_block_grad(q, k, v, dout, lse, delta, *added, scale=scale)
    for a, f, x0 in zip(added, fresh, (dq0, dk0, dv0)):
        np.testing.assert_allclose(a.numpy(), (x0 + f).numpy(), atol=1e-6, rtol=1e-6)
    assert flash.ring_bwd_launches == 0  # the plain version on the CPU counts nothing


def _jax_ring_vjp(sp, q, k, v, cot):
    mesh = JaxMesh(np.array(jax.devices()[:sp]).reshape(1, sp, 1), ("dp", "sp", "tp"))
    fn = jax.jit(lambda q, k, v: jax_ring.ring_attention(q, k, v, mesh=mesh))
    _, vjp = jax.vjp(fn, q, k, v)
    return vjp(cot)


def _torch_ring_grads(sp, inputs, cot, *, per_step=False):
    leaves = [torch.from_numpy(x).requires_grad_() for x in inputs]
    if per_step:
        b, s, h, d = leaves[0].shape
        folded = [x.reshape(b * sp, s // sp, h, d) for x in leaves]
        out = ring._ring_per_step(*folded, mesh=Mesh(sp=sp),
                                  scale=d ** -0.5).reshape(b, s, h, d)
    else:
        out = ring.ring_attention(*leaves, mesh=Mesh(sp=sp))
    return torch.autograd.grad(out, leaves, torch.from_numpy(cot))


def _per_step_kernel_update(q, k, v, m, num, den, *, scale):
    return ring.RingBlockUpdate.apply(q, k, v, m, num, den, scale)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_gradients_match_jax_vjp_and_the_per_step_ring(sp, monkeypatch):
    """RingAttention's backward (one ring_block_grad per step) against
    jax.vjp of the JAX ring (Pallas forward, einsum VJP per step) and
    against the per-step ring with RingBlockUpdate, within 1e-2 (the
    attention gradients' tolerance, test_ml_extension.py)."""
    monkeypatch.setenv("TASKSRUNNER_FLASH", "1")
    rng = np.random.default_rng(40 + sp)
    inputs = [rng.standard_normal(SHAPE, np.float32) for _ in range(3)]
    cot = rng.standard_normal(SHAPE, np.float32)
    want = _jax_ring_vjp(sp, *inputs, cot)
    got = _torch_ring_grads(sp, inputs, cot)
    monkeypatch.setattr(ring, "_block_update", _per_step_kernel_update)
    per_step = _torch_ring_grads(sp, inputs, cot, per_step=True)
    for g, w, p in zip(got, want, per_step):
        assert g.dtype == torch.float32 and g.shape == SHAPE
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-2, rtol=1e-2)
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("sp", [2, 4])
def test_the_flash_ring_matches_the_plain_ring(sp, monkeypatch):
    """TASKSRUNNER_FLASH=0 runs the plain update step by step under
    autograd; the flash ring's output and gradients agree with it."""
    rng = np.random.default_rng(50 + sp)
    inputs = [rng.standard_normal(SHAPE, np.float32) for _ in range(3)]
    cot = rng.standard_normal(SHAPE, np.float32)
    results = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("TASKSRUNNER_FLASH", flag)
        leaves = [torch.from_numpy(x).requires_grad_() for x in inputs]
        out = ring.ring_attention(*leaves, mesh=Mesh(sp=sp))
        results[flag] = (out.detach(), *torch.autograd.grad(out, leaves,
                                                            torch.from_numpy(cot)))
    for f, p in zip(results["1"], results["0"]):
        np.testing.assert_allclose(f.numpy(), p.numpy(), atol=1e-2, rtol=1e-2)


def _rolled(x, shift, sp):
    return torch.roll(x.reshape(-1, sp, *x.shape[1:]), shift, dims=1).reshape(x.shape)


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_the_shifted_read_equals_rolled_inputs(shift):
    """Row bi·sp + r reads K/V of row bi·sp + (r − shift) mod sp: the same
    numbers, bit for bit, as the block update and the backward step on
    K/V rolled by ``shift`` along the fold, with dK/dV rolled back."""
    sp, b = 4, 2
    shape = (b * sp, 4, 4, 16)
    q, k, v, dout = _tensors(60 + shift, shape, 4)
    scale = 0.25
    m, num, den = ring._initial_state(q)
    m, num, den = flash.ring_block_update(q, k, v, m, num, den, scale=scale)
    got = flash.ring_block_update(q, k, v, m, num, den, scale=scale, shift=shift, sp=sp)
    want = flash.ring_block_update_reference(q, _rolled(k, shift, sp), _rolled(v, shift, sp),
                                             m, num, den, scale=scale)
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    lse = got[0] + torch.log(got[2])
    delta = torch.from_numpy(np.random.default_rng(70).standard_normal(
        (b * sp, 4, 4), np.float32))
    shifted = [torch.zeros(shape) for _ in range(3)]
    flash.ring_block_grad(q, k, v, dout, lse, delta, *shifted, scale=scale,
                          shift=shift, sp=sp)
    rolled = [torch.zeros(shape) for _ in range(3)]
    flash.ring_block_grad(q, _rolled(k, shift, sp), _rolled(v, shift, sp), dout, lse, delta,
                          *rolled, scale=scale)
    assert torch.equal(shifted[0], rolled[0])
    assert torch.equal(shifted[1], _rolled(rolled[1], -shift, sp))
    assert torch.equal(shifted[2], _rolled(rolled[2], -shift, sp))


@pytest.mark.parametrize("flag, rotations", [("1", 0), ("0", 3)], ids=["flash", "plain"])
def test_only_the_plain_one_process_ring_rotates(flag, rotations, monkeypatch):
    """The flash ring reads the visiting block in place in both passes;
    the plain ring rolls K and V sp − 1 times per forward."""
    monkeypatch.setenv("TASKSRUNNER_FLASH", flag)
    calls = []
    real = ring._rotate

    def counted(k, v, mesh):
        calls.append(None)
        return real(k, v, mesh)

    monkeypatch.setattr(ring, "_rotate", counted)
    leaves = [x.requires_grad_() for x in _tensors(80, SHAPE, 3)]
    out = ring.ring_attention(*leaves, mesh=Mesh(sp=4))
    out.sum().backward()
    assert len(calls) == rotations


@pytest.mark.parametrize("bad", ["shift", "sp", "accumulator", "lse"])
def test_ring_block_grad_refuses_what_the_kernel_does_not_take(bad):
    q, k, v, dout = _tensors(90, SHAPE, 4)
    lse = torch.zeros(SHAPE[0], SHAPE[2], SHAPE[1])
    delta = torch.zeros_like(lse)
    acc = [torch.zeros(SHAPE) for _ in range(3)]
    kwargs = {"scale": 0.25}
    if bad == "shift":
        kwargs.update(shift=2, sp=2)
    elif bad == "sp":
        kwargs.update(shift=0, sp=3)
    elif bad == "accumulator":
        acc[1] = acc[1].double()
    else:
        lse = lse[..., :-1]
    with pytest.raises(ValueError):
        flash.ring_block_grad(q, k, v, dout, lse, delta, *acc, **kwargs)
