"""Flash attention: the port of ``tasksrunner/ml/flash.py``'s forward
kernel (``_fwd_kernel``, launched by ``_flash_fwd``), its two backward
kernels (``_bwd_kernel_delta`` and ``_bwd_kernel``, launched by
``_flash_bwd_call``) and the ring block update (``_ring_block_kernel``,
launched by ``ring_block_update``), and the ring's backward step
(:func:`ring_block_grad`, in place of the VJP of
``tasksrunner/ml/ring.py``'s block update).

On CUDA tensors :func:`flash_fwd`, :func:`flash_bwd`,
:func:`ring_block_update` and :func:`ring_block_grad` launch the
hand-written kernels in ``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu`` (the
last two entries) and ``csrc/flash_ring.cu`` (bf16 wgmma products with f32
accumulation, fed by TMA; their designs and bounds are in the sources).
On CPU tensors they run :func:`flash_fwd_reference`,
:func:`flash_bwd_reference`, :func:`ring_block_update_reference` and
:func:`ring_block_grad_reference`, the plain PyTorch versions that repeat
the kernels' arithmetic step by step; the tests hold them against the
JAX package and ``chip_smoke.py`` holds the CUDA kernels against them on
the card. There is no fallback from a kernel to its plain version.
:class:`FlashAttention` ties the first two into one differentiable op, as
``jax.custom_vjp`` does in the reference; ``ring.RingAttention`` ties the
last two into the ring's.

The public layout is the model's ``[batch, seq, heads, d_head]``; the
kernels read it through its strides, so nothing is transposed.
"""

from __future__ import annotations

import ctypes

import torch

from tasksrunner_torch import _kernels
from tasksrunner_torch.envflag import env_flag, env_str

#: d_head values the kernel is built for
HEAD_DIMS = (16, 32, 64, 128)
_MAX_GRID_YZ = 65535

#: launches of the CUDA kernels since the counts were last set to 0: the
#: forward, the default backward (Δ precomputed), the fused-Δ backward, the
#: ring block update and the ring's backward step; the plain versions on
#: the CPU do not count
launches = 0
bwd_launches = 0
bwd_fused_launches = 0
ring_launches = 0
ring_bwd_launches = 0

_entries: dict = {}


def launch_counts() -> dict[str, int]:
    """Each kernel's launches since the counts were last set to 0."""
    return {"flash_fwd": launches, "flash_bwd_delta": bwd_launches,
            "flash_bwd_fused": bwd_fused_launches, "flash_ring": ring_launches,
            "flash_ring_bwd": ring_bwd_launches}


def reset_launch_counts() -> None:
    global launches, bwd_launches, bwd_fused_launches, ring_launches, ring_bwd_launches
    launches = bwd_launches = bwd_fused_launches = ring_launches = ring_bwd_launches = 0


def use_flash() -> bool:
    """Attention core toggle: the kernels (default) or the plain einsum
    cores (``TASKSRUNNER_FLASH=0``), for the dense core and the ring's
    block update alike."""
    return env_flag("TASKSRUNNER_FLASH")


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's arithmetic in plain PyTorch, in f32 on the
    inputs' device: S = bf16(q)·bf16(k)ᵀ accumulated in f32 times
    ``scale``; m = rowmax S; the unnormalised p = exp(S − m), rounded to
    bf16 for the PV product; O = PV / Σp in the inputs' dtype; LSE =
    m + log Σp in f32, shaped [b, h, s]."""
    qf, kf, vf = (_bf16_f32(x) for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    den = p.sum(dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", _bf16_f32(p), vf)
    out = ctx / den.transpose(1, 2)[..., None]
    return out.to(q.dtype), m + torch.log(den)


def _bf16_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Δ = Σ_d f32(dO)·f32(O) per row, [b, h, s] f32 (flash.py:229-230),
    for the plain version; on the card the backward's pre-pass or its
    main kernel computes it."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                        scale: float, *, delta: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The TPU backward's arithmetic in plain PyTorch, in f32 on the
    inputs' device, rounding to bf16 where its ``_dot`` rounds: with dO
    cast to q's dtype, P = exp(bf16(q)·bf16(k)ᵀ·scale − LSE); dV =
    bf16(P)ᵀ·bf16(dO); dP = bf16(dO)·bf16(v)ᵀ; Δ = Σ f32(dO)∘f32(O)
    unless ``delta`` [b, h, s] is given; dS = P∘(dP − Δ)·scale; dQ =
    bf16(dS)·bf16(k) and dK = bf16(dS)ᵀ·bf16(q), in the inputs' dtype."""
    dout = dout.to(q.dtype)
    if delta is None:
        delta = _delta(out, dout)
    grads = _bwd_terms(q, k, v, dout, lse, delta, scale)
    return tuple(g.to(q.dtype) for g in grads)


def _bwd_terms(q, k, v, dout, lse, delta, scale):
    """dq, dk, dv in f32 from P = exp(bf16(q)·bf16(k)ᵀ·scale − LSE) and Δ,
    rounding to bf16 where the TPU backward's ``_dot`` rounds."""
    qf, kf, vf, gf = (_bf16_f32(x) for x in (q, k, v, dout))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16_f32(p), gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", _bf16_f32(ds), kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", _bf16_f32(ds), qf)
    return dq, dk, dv


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash attention takes q, k, v of one shape [batch, seq, "
                         f"heads, d_head]; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("flash attention takes bf16 or f32 inputs of one dtype; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"d_head {d} is not one of {HEAD_DIMS}")
    if s < 1 or b < 1 or h < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}")


def _check_cuda_layout(*tensors: torch.Tensor) -> None:
    """The kernel reads eight elements at a time through the b, s, h
    strides: the d axis must be dense, the other strides multiples of 8
    and the data 16-byte aligned."""
    for x in tensors:
        if x.stride(3) != 1 or any(x.stride(i) % 8 for i in range(3)) \
                or x.data_ptr() % 16:
            raise ValueError(
                "the flash kernels need a dense d axis, b/s/h strides that are "
                f"multiples of 8 and 16-byte aligned data; got strides "
                f"{x.stride()} (call .contiguous() first)")
    b, _, h, _ = tensors[0].shape
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"batch and heads must be at most {_MAX_GRID_YZ}")


_ARGTYPES = {
    # tr_flash_fwd(q, k, v, o, lse, staged, b, s, h, d, is_bf16, strides, scale,
    #              stream)
    "flash_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p],
    # tr_flash_bwd(q, k, v, o, dout, lse, delta, dq_accum, dq, dk, dv, staged,
    #              b, s, h, d, is_bf16, fused, strides, scale, stream)
    "flash_bwd": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p],
    # tr_flash_ring(q, k, v, m, num, den, m_out, num_out, den_out, staged,
    #               b, sq, sk, h, d, is_bf16, shift, sp, strides, scale, stream)
    "flash_ring": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p],
    # tr_flash_ring_bwd(q, k, v, dout, lse, delta, dq_accum, dk_accum, dv_accum,
    #                   b, s, h, d, strides, scale, shift, sp, stream)
    "flash_ring_bwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p],
}

#: the source of each C entry that does not live in ``csrc/<entry>.cu``
_SOURCES = {"flash_ring_bwd": "flash_bwd"}


def _kernel(name: str = "flash_fwd"):
    """The bound C entry ``tr_<name>`` of ``csrc/<name>.cu`` (or of the
    source ``_SOURCES`` names), built and loaded at first use."""
    key = (name, _kernels.defines())
    fn = _entries.get(key)
    if fn is None:
        fn = getattr(_kernels.library(_SOURCES.get(name, name)), f"tr_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _entries[key] = fn
    return fn


def _call(name: str, device: torch.device, *args) -> int:
    """The C entry ``tr_<name>`` called with ``args`` and the current
    stream of ``device``, with ``device`` made the current one: the entry
    launches on the current device and reads its SM count there, and on a
    host with several cards that need not be the tensors' card."""
    with torch.cuda.device(device):
        return _kernel(name)(*args, torch.cuda.current_stream(device).cuda_stream)


def _strides(*tensors: torch.Tensor):
    return (ctypes.c_int64 * (3 * len(tensors)))(
        *(x.stride(i) for x in tensors for i in range(3)))


def _launch_error(name: str, err: int) -> RuntimeError:
    what = "a TMA tensor map could not be encoded" if err == -2 else f"CUDA error {err}"
    return RuntimeError(f"{name} kernel launch failed: {what}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One call of the C entry, which enqueues the main kernel and, for
    f32 IO, first a pre-pass that writes bf16 copies of q, k, v; this
    allocates the outputs and that scratch."""
    global launches
    _check_cuda_layout(q, k, v)
    if scale < 0:  # the kernel takes scale > 0: q·(−k)ᵀ·|scale| is the same, exactly
        k, scale = -k, -scale
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    staged = (torch.empty((3, b, s, h, d), dtype=torch.bfloat16, device=q.device)
              if q.dtype == torch.float32 else None)
    err = _call("flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), lse.data_ptr(),
                None if staged is None else staged.data_ptr(),
                b, s, h, d, int(q.dtype == torch.bfloat16),
                _strides(q, k, v, out), float(scale))
    if err:
        raise _launch_error("flash_fwd", err)
    launches += 1
    return out, lse


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention forward over q/k/v [b, s, h, d] (bf16 or f32): the
    context [b, s, h, d] in the inputs' dtype and the row log-sum-exp
    [b, h, s] in f32 (the TPU kernel's [b, h, 1, s] without the unit
    axis; the training slice's backward reads it)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu tensors, not {q.device}")
    return _launch(q, k, v, scale)


def _bwd_delta_precompute() -> bool:
    """Δ placement for the backward, as flash.py:214-220 reads it:
    precomputed by a pre-pass before the main kernel (the default,
    kernel B2) unless ``TASKSRUNNER_FLASH_BWD_DELTA=fused`` (kernel B3,
    Δ in the main kernel; with f32 IO the pre-pass computes it for both,
    from the f32 values)."""
    return env_str("TASKSRUNNER_FLASH_BWD_DELTA", "precompute") != "fused"


def _launch_bwd(q, k, v, out, lse, dout, scale):
    """One call of the C entry, which enqueues the pre-pass (Δ, and bf16
    copies of f32 inputs), the main kernel and the cast of dQ; this
    allocates their outputs and scratch: the f32 ``dq_accum`` that the
    main kernel reduce-adds dQ into (dQ itself for f32 IO), Δ [b, h, s]
    unless the fused variant computes it in the kernel, and the bf16
    copies of q, k, v, dO for f32 IO."""
    global bwd_launches, bwd_fused_launches
    _check_cuda_layout(q, k, v, out, dout)
    b, s, h, d = q.shape
    precompute = _bwd_delta_precompute()
    f32 = q.dtype == torch.float32
    dq, dk, dv = (torch.empty_like(q, memory_format=torch.contiguous_format)
                  for _ in range(3))
    dq_accum = dq if f32 else torch.empty(q.shape, dtype=torch.float32, device=q.device)
    delta = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
             if precompute or f32 else None)
    staged = (torch.empty((4, b, s, h, d), dtype=torch.bfloat16, device=q.device)
              if f32 else None)
    err = _call(
        "flash_bwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), None if delta is None else delta.data_ptr(), dq_accum.data_ptr(),
        None if f32 else dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if staged is None else staged.data_ptr(),
        b, s, h, d, int(not f32), int(not precompute),
        _strides(q, k, v, out, dout, dk, dv), float(scale))
    if err:
        raise _launch_error("flash_bwd", err)
    if precompute:
        bwd_launches += 1
    else:
        bwd_fused_launches += 1
    return dq, dk, dv


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
              scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention backward: dq, dk, dv [b, s, h, d] in the inputs' dtype
    from q, k, v, the forward's context ``out`` and LSE [b, h, s] f32,
    and the context's gradient ``dout`` (cast to q's dtype first). On
    the card dQ is summed over key tiles by f32 reduce-adds in the order
    the blocks finish, so it can differ in its last bits from run to
    run; dK and dV do not."""
    _check(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("flash_bwd takes out and dout of q's shape, out in q's dtype")
    b, s, h, _ = q.shape
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_bwd takes a contiguous f32 lse of shape {(b, h, s)}")
    if any(x.device != q.device for x in (out, lse, dout)):
        raise ValueError("flash_bwd takes every input on one device")
    dout = dout.to(q.dtype)
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, out, lse, dout, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd runs on cuda or cpu tensors, not {q.device}")
    return _launch_bwd(q, k, v, out, lse, dout, scale)


class FlashAttention(torch.autograd.Function):
    """Differentiable attention over the kernels: the forward is
    :func:`flash_fwd` and keeps q, k, v, the context and LSE; the
    backward is :func:`flash_bwd`, with gradients in the inputs' dtype
    (flash.py:263-292's custom VJP). On CPU tensors both run their
    plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(), ctx.scale)
        return dq, dk, dv, None


def ring_block_update_reference(q: torch.Tensor, k_blk: torch.Tensor,
                                v_blk: torch.Tensor, m: torch.Tensor,
                                num: torch.Tensor, den: torch.Tensor, *,
                                scale: float
                                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One visiting K/V block folded into the running softmax state, as
    ``tasksrunner/ml/ring.py::_block_update`` does it, in f32 on the
    inputs' device: S = bf16(q)·bf16(k)ᵀ accumulated in f32 times
    ``scale``; m′ = max(m, rowmax S); c = exp(m − m′); P = exp(S − m′)
    in f32; num′ = num·c + bf16(P)·bf16(v); den′ = den·c + ΣP. q is
    [b, sq, h, d], k and v [b, sk, h, d]; m and den [b, h, sq] and num
    [b, h, sq, d], all f32. Differentiable by plain autograd: the plain
    ring's backward runs through it."""
    logits = torch.einsum("bqhd,bkhd->bhqk", _bf16_f32(q), _bf16_f32(k_blk)) * scale
    m_new = torch.maximum(m, logits.amax(dim=-1))
    correction = torch.exp(m - m_new)
    probs = torch.exp(logits - m_new[..., None])
    num = num * correction[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", _bf16_f32(probs), _bf16_f32(v_blk))
    den = den * correction + probs.sum(dim=-1)
    return m_new, num, den


def _check_ring(q, k_blk, v_blk, m, num, den) -> None:
    if q.dim() != 4 or k_blk.dim() != 4 or v_blk.shape != k_blk.shape \
            or k_blk.shape[0] != q.shape[0] or k_blk.shape[2:] != q.shape[2:]:
        raise ValueError("the ring block update takes q [b, sq, h, d] and k, v "
                         f"[b, sk, h, d]; got {tuple(q.shape)}, {tuple(k_blk.shape)}, "
                         f"{tuple(v_blk.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k_blk.dtype != q.dtype \
            or v_blk.dtype != q.dtype:
        raise TypeError("the ring block update takes bf16 or f32 q, k, v of one "
                        f"dtype; got {q.dtype}, {k_blk.dtype}, {v_blk.dtype}")
    b, sq, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"d_head {d} is not one of {HEAD_DIMS}")
    if min(b, sq, h, k_blk.shape[1]) < 1:
        raise ValueError(f"empty ring block {tuple(q.shape)}, {tuple(k_blk.shape)}")
    for name, x, shape in (("m", m, (b, h, sq)), ("num", num, (b, h, sq, d)),
                           ("den", den, (b, h, sq))):
        if x.shape != shape or x.dtype != torch.float32:
            raise ValueError(f"the ring block update takes an f32 {name} of shape "
                             f"{shape}; got {tuple(x.shape)} {x.dtype}")
    if any(x.device != q.device for x in (k_blk, v_blk, m, num, den)):
        raise ValueError("the ring block update takes every input on one device")


def _check_fold(b: int, shift: int, sp: int) -> None:
    if sp < 1 or b % sp or not 0 <= shift < sp:
        raise ValueError(f"a ring step takes sp >= 1 dividing the batch {b} and "
                         f"0 <= shift < sp; got shift {shift}, sp {sp}")


def _visiting_rows(b: int, shift: int, sp: int, device) -> torch.Tensor:
    """Row bi·sp + (r − shift) mod sp for each row bi·sp + r of a folded
    batch of ``b`` rows: the block that visits rank r at ring step
    ``shift``, where the one-process ring folds its sp ranks into the
    batch."""
    rows = torch.arange(b, device=device)
    rank = rows % sp
    return rows - rank + (rank - shift) % sp


def _launch_ring(q, k_blk, v_blk, m, num, den, scale, shift, sp):
    """One call of the C entry, which enqueues, for f32 IO, a pre-pass that
    writes bf16 copies of q, k, v, then the main kernel; this allocates the
    outputs and that scratch."""
    global ring_launches
    _check_cuda_layout(q, k_blk, v_blk)
    if any(not x.is_contiguous() or x.data_ptr() % 16 for x in (m, num, den)):
        raise ValueError("the ring kernel reads m, num and den contiguous and 16-byte "
                         "aligned (call .contiguous() first)")
    if scale < 0:  # the kernel takes scale > 0: q·(−k)ᵀ·|scale| is the same, exactly
        k_blk, scale = -k_blk, -scale
    b, sq, h, d = q.shape
    sk = k_blk.shape[1]
    m_out, den_out = torch.empty_like(m), torch.empty_like(den)
    num_out = torch.empty_like(num)
    staged = (torch.empty((b, sq + 2 * sk, h, d), dtype=torch.bfloat16, device=q.device)
              if q.dtype == torch.float32 else None)
    err = _call(
        "flash_ring", q.device,
        q.data_ptr(), k_blk.data_ptr(), v_blk.data_ptr(), m.data_ptr(), num.data_ptr(),
        den.data_ptr(), m_out.data_ptr(), num_out.data_ptr(), den_out.data_ptr(),
        None if staged is None else staged.data_ptr(),
        b, sq, sk, h, d, int(q.dtype == torch.bfloat16), shift, sp,
        _strides(q, k_blk, v_blk), float(scale))
    if err:
        raise _launch_error("flash_ring", err)
    ring_launches += 1
    return m_out, num_out, den_out


def ring_block_update(q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
                      m: torch.Tensor, num: torch.Tensor, den: torch.Tensor, *,
                      scale: float, shift: int = 0, sp: int = 1
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ring step's state update (see
    :func:`ring_block_update_reference`) as one kernel: (m′, num′, den′)
    in new f32 buffers; the inputs are left as they are. With ``sp`` > 1
    the batch is the one-process ring's fold and row bi·sp + r takes the
    K/V of row bi·sp + (r − ``shift``) mod sp, read in place (on the CPU
    gathered first). Forward only."""
    _check_ring(q, k_blk, v_blk, m, num, den)
    _check_fold(q.shape[0], shift, sp)
    if q.device.type == "cpu":
        if shift:
            rows = _visiting_rows(q.shape[0], shift, sp, q.device)
            k_blk, v_blk = k_blk.index_select(0, rows), v_blk.index_select(0, rows)
        return ring_block_update_reference(q, k_blk, v_blk, m, num, den, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"ring_block_update runs on cuda or cpu tensors, not {q.device}")
    return _launch_ring(q, k_blk, v_blk, m, num, den, scale, shift, sp)


def ring_block_grad_reference(q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
                              dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                              dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor, *,
                              scale: float, shift: int = 0, sp: int = 1) -> None:
    """One ring step's share of the gradients, in plain PyTorch in f32 on
    the inputs' device, added in place into the f32 accumulators dq
    (rows of q) and dk, dv (rows of the visiting block): with the ring's
    final LSE and Δ = rowsum(dO∘O) [b, h, s], P = exp(bf16(q)·bf16(k)ᵀ·
    scale − LSE), dV += bf16(P)ᵀ·bf16(dO), dS = P∘(bf16(dO)·bf16(v)ᵀ −
    Δ)·scale, dQ += bf16(dS)·bf16(k), dK += bf16(dS)ᵀ·bf16(q), rounding
    where :func:`flash_bwd_reference` rounds. ``shift`` and ``sp`` pick the
    visiting rows as :func:`ring_block_update` does."""
    rows = _visiting_rows(q.shape[0], shift, sp, q.device)
    gq, gk, gv = _bwd_terms(q, k_blk.index_select(0, rows), v_blk.index_select(0, rows),
                            dout, lse, delta, scale)
    dq += gq
    dk.index_add_(0, rows, gk)
    dv.index_add_(0, rows, gv)


def _check_ring_grad(q, k_blk, v_blk, dout, lse, delta, dq, dk, dv) -> None:
    _check(q, k_blk, v_blk)
    b, s, h, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("the ring's backward step takes dout of q's shape and dtype")
    for name, x, shape in (("lse", lse, (b, h, s)), ("delta", delta, (b, h, s)),
                           ("dq", dq, q.shape), ("dk", dk, q.shape), ("dv", dv, q.shape)):
        if x.shape != shape or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"the ring's backward step takes a contiguous f32 {name} of "
                             f"shape {tuple(shape)}; got {tuple(x.shape)} {x.dtype}")
    if any(x.device != q.device for x in (dout, lse, delta, dq, dk, dv)):
        raise ValueError("the ring's backward step takes every input on one device")


def _launch_ring_bwd(q, k_blk, v_blk, dout, lse, delta, dq, dk, dv, scale, shift, sp):
    global ring_bwd_launches
    if q.dtype == torch.float32:  # the kernel reads bf16, as it rounds there
        q, k_blk, v_blk, dout = (x.to(torch.bfloat16) for x in (q, k_blk, v_blk, dout))
    _check_cuda_layout(q, k_blk, v_blk, dout)
    if any(x.data_ptr() % 16 for x in (lse, delta, dq, dk, dv)):
        raise ValueError("the ring's backward kernel needs 16-byte aligned f32 buffers")
    b, s, h, d = q.shape
    err = _call(
        "flash_ring_bwd", q.device,
        q.data_ptr(), k_blk.data_ptr(), v_blk.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, d,
        _strides(q, k_blk, v_blk, dout), float(scale), shift, sp)
    if err:
        raise _launch_error("flash_ring_bwd", err)
    ring_bwd_launches += 1


def ring_block_grad(q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
                    dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                    dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor, *,
                    scale: float, shift: int = 0, sp: int = 1) -> None:
    """One ring step's share of the gradients (see
    :func:`ring_block_grad_reference`) as one kernel, added into the f32
    accumulators dq, dk, dv [b, s, h, d]; q, k, v and dout [b, s, h, d]
    (bf16 or f32, one shape: the ring's blocks are equal). On the card dQ
    is added by f32 reduce-adds over the key tiles in the order the blocks
    finish, so for s > 128 its last bits can change from run to run."""
    _check_ring_grad(q, k_blk, v_blk, dout, lse, delta, dq, dk, dv)
    _check_fold(q.shape[0], shift, sp)
    if q.device.type == "cpu":
        ring_block_grad_reference(q, k_blk, v_blk, dout, lse, delta, dq, dk, dv,
                                  scale=scale, shift=shift, sp=sp)
    elif q.device.type == "cuda":
        _launch_ring_bwd(q, k_blk, v_blk, dout, lse, delta, dq, dk, dv, scale, shift, sp)
    else:
        raise ValueError(f"ring_block_grad runs on cuda or cpu tensors, not {q.device}")


def _resolve_scale(q: torch.Tensor, scale: float | None) -> float:
    return float(scale) if scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """Fused attention: q/k/v [batch, seq, heads, d_head] → context
    [batch, seq, heads, d_head] in the inputs' dtype; ``scale``
    defaults to 1/√d_head. Differentiable through
    :class:`FlashAttention`, which keeps nothing where no gradient can
    be asked for (``inference_mode``, ``no_grad``)."""
    return FlashAttention.apply(q, k, v, _resolve_scale(q, scale))
