"""The port's flash-attention backward (tasksrunner_torch/flash.py)
against the JAX package's Pallas backward kernels, which run in
interpret mode on the CPU as tests/test_ml_extension.py runs them.
Inputs come from a numpy seed and the same arrays go to both sides."""

import numpy as np
import pytest
import torch

from tasksrunner.ml.platform import pin_cpu_platform

if not pin_cpu_platform():
    pytest.skip("jax cpu platform unavailable", allow_module_level=True)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tasksrunner.ml import flash as jax_flash  # noqa: E402
from tasksrunner_torch import flash  # noqa: E402

SHAPES = [(2, 64, 4, 32), (1, 8, 2, 16)]  # [b, s, h, d]


def _arrays(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _internal(x, dtype):
    return jnp.transpose(jnp.asarray(x, dtype), (0, 2, 1, 3))


def _public(x):
    return np.array(jnp.transpose(x, (0, 2, 1, 3)).astype(jnp.float32))


@pytest.mark.parametrize("variant", ["precompute", "fused"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "b{}s{}h{}d{}".format(*s))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_pallas_backward(dtype, shape, variant, monkeypatch):
    monkeypatch.setenv("TASKSRUNNER_FLASH_BWD_DELTA", variant)
    q, k, v, dout = _arrays(shape, seed=13)
    scale = 1.0 / shape[-1] ** 0.5
    jdt = getattr(jnp, dtype)
    qi, ki, vi = (_internal(x, jdt) for x in (q, k, v))
    # jitted, so the interpret-mode kernels compile once; the flag is read
    # while tracing
    out, lse = jax.jit(jax_flash._flash_fwd, static_argnums=3)(qi, ki, vi, scale)
    grads = jax.jit(jax_flash._flash_bwd_call, static_argnums=6)(
        qi, ki, vi, out, lse, _internal(dout, jdt), scale)
    want = [_public(x) for x in grads]

    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    t_out = torch.from_numpy(_public(out)).to(tdt)
    t_lse = torch.from_numpy(np.array(lse)[:, :, 0, :])
    t_dout = torch.from_numpy(dout).to(tdt)
    # the precompute variant takes Δ as an input, made as flash.py:229-230
    # makes it; the fused one computes it from O
    delta = (torch.einsum("bshd,bshd->bhs", t_dout.float(), t_out.float())
             if variant == "precompute" else None)
    got = flash.flash_bwd_reference(tq, tk, tv, t_out, t_lse, t_dout, scale,
                                    delta=delta)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt and g.shape == tq.shape
        g = g.float().numpy()
        # both sides round to bf16 at the same places, so what is left is f32
        # summation order, which can move a p or dS across a bf16 rounding
        # boundary (one bf16 step, 2^-8 relative, of one term); a bf16 output
        # adds one bf16 step of the result (2^-7 relative)
        err = np.abs(g - w)
        bound = 2e-3 * np.abs(w).max() + (2 ** -7 * np.abs(w) if dtype == "bfloat16" else 0)
        assert np.mean(err <= 1e-4 + 1e-4 * np.abs(w)) >= 0.95, name
        assert (err <= bound + 1e-4).all(), (name, err.max())


def test_flash_gradients_match_jax_grad():
    """FlashAttention's dq, dk, dv on the CPU against jax.grad of the
    Pallas flash_attention, with test_ml_extension.py's sin-sum loss and
    its 1e-2 tolerance."""
    q, k, v = _arrays((2, 64, 4, 32), seed=7, n=3)
    want = jax.jit(jax.grad(lambda *x: jnp.sum(jnp.sin(jax_flash.flash_attention(*x))),
                            argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = (flash.launches, flash.bwd_launches, flash.bwd_fused_launches)
    got = torch.autograd.grad(flash.flash_attention(tq, tk, tv).sin().sum(), (tq, tk, tv))
    assert (flash.launches, flash.bwd_launches, flash.bwd_fused_launches) == before
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-2, rtol=1e-2)


def test_flash_bwd_rejects_a_bad_lse():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        flash.flash_bwd(q, q, q, q, torch.zeros(1, 8, 2), q, 0.25)
