"""The port's CUDA kernels on the card. These tests need a CUDA card and
skip without one (the kernels have no CPU mode); they import no JAX, so
they run on a machine that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py -q
"""

import pytest
import torch

from tasksrunner_torch import flash, graft_entry, model
from tasksrunner_torch.mesh import Mesh
from tasksrunner_torch.model import ModelConfig, forward, init_params

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(1, 8, 2, 16), (8, 32, 4, 32), (2, 100, 4, 64),
                                   (1, 130, 2, 128), (1, 129, 2, 64), (3, 200, 2, 32),
                                   (3, 50, 2, 16)],
                         ids=lambda s: "b{}s{}h{}d{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_kernel_matches_plain_version(card, shape, dtype):
    gen = torch.Generator(device=card).manual_seed(3)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype) for _ in range(3))
    scale = shape[-1] ** -0.5
    before = flash.launches
    out, lse = flash.flash_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert flash.launches == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    _assert_twin(out, lse, *flash.flash_fwd_reference(q, k, v, scale))


def _assert_twin(out, lse, want_o, want_lse):
    """The forward against its plain version: p is rounded to bf16 against
    the running max, not the final one (one bf16 rounding of p per term,
    and one bf16 step of a bf16 output); LSE is f32 sums in another order."""
    torch.testing.assert_close(out.float(), want_o.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)


def test_forward_kernel_repeats_bit_for_bit(card):
    """No atomics and no order-dependent sums: two calls on the same
    inputs give the same O and LSE, bit for bit."""
    shape = (2, 300, 4, 64)
    gen = torch.Generator(device=card).manual_seed(10)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(torch.bfloat16)
               for _ in range(3))
    first = flash.flash_fwd(q, k, v, 0.125)
    second = flash.flash_fwd(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_forward_kernel_reads_strided_views_of_one_fused_tensor(card, dtype):
    """q, k, v as views of one [b, s, 3, h, d] tensor: the TMA tensor maps
    follow their strides (s stride 3·h·d, offsets h·d apart), nothing is
    copied, and the result equals that on contiguous copies bit for bit."""
    b, s, h, d = 2, 200, 4, 64
    gen = torch.Generator(device=card).manual_seed(11)
    fused = torch.randn(b, s, 3, h, d, generator=gen, device=card).to(dtype)
    q, k, v = fused.unbind(dim=2)
    assert not q.is_contiguous() and q.stride(1) == 3 * h * d
    out, lse = flash.flash_fwd(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    want_o, want_lse = flash.flash_fwd_reference(q, k, v, d ** -0.5)
    _assert_twin(out, lse, want_o, want_lse)
    dense = flash.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), d ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(out, dense[0]) and torch.equal(lse, dense[1])


def test_forward_kernel_f32_io_returns_f32_within_the_twin_tolerance(card):
    """f32 inputs (the TASKSRUNNER_ACT_F32 path) give an f32 O and LSE that
    agree with the plain version within the same tolerance as bf16."""
    shape = (2, 300, 4, 64)
    gen = torch.Generator(device=card).manual_seed(12)
    q, k, v = (torch.randn(shape, generator=gen, device=card) for _ in range(3))
    out, lse = flash.flash_fwd(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert out.dtype == lse.dtype == torch.float32 and out.shape == shape
    _assert_twin(out, lse, *flash.flash_fwd_reference(q, k, v, 0.125))


def test_forward_kernel_takes_a_negative_scale(card):
    """The kernel takes scale > 0; the wrapper runs a negative scale as
    q·(−k)ᵀ·|scale|, which is exact."""
    shape = (1, 130, 2, 32)
    gen = torch.Generator(device=card).manual_seed(13)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(torch.bfloat16)
               for _ in range(3))
    out, lse = flash.flash_fwd(q, k, v, -0.2)
    torch.cuda.synchronize()
    _assert_twin(out, lse, *flash.flash_fwd_reference(q, k, v, -0.2))


def test_forward_launches_the_kernel_once_per_layer(card, monkeypatch):
    cfg = ModelConfig()
    params = init_params(cfg, 0, card)
    tokens = torch.randint(0, cfg.vocab, (8, cfg.seq_len), device=card)
    monkeypatch.setenv("TASKSRUNNER_FLASH", "1")
    before = flash.launches
    got = forward(params, tokens, cfg=cfg)
    assert flash.launches - before == cfg.n_layers
    monkeypatch.setenv("TASKSRUNNER_FLASH", "0")
    want = forward(params, tokens, cfg=cfg)
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("shape", [(1, 8, 2, 16), (8, 32, 4, 32), (2, 100, 4, 64),
                                   (1, 130, 2, 128), (2, 300, 4, 64), (1, 260, 2, 128)],
                         ids=lambda s: "b{}s{}h{}d{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("variant", ["precompute", "fused"])
def test_backward_kernel_matches_plain_version(card, shape, dtype, variant, monkeypatch):
    monkeypatch.setenv("TASKSRUNNER_FLASH_BWD_DELTA", variant)
    gen = torch.Generator(device=card).manual_seed(4)
    q, k, v, dout = (torch.randn(shape, generator=gen, device=card).to(dtype)
                     for _ in range(4))
    scale = shape[-1] ** -0.5
    out, lse = flash.flash_fwd(q, k, v, scale)
    before = (flash.bwd_launches, flash.bwd_fused_launches)
    got = flash.flash_bwd(q, k, v, out, lse, dout, scale)
    torch.cuda.synchronize()
    fused = variant == "fused"
    assert (flash.bwd_launches, flash.bwd_fused_launches) == (
        before[0] + (not fused), before[1] + fused)
    want = flash.flash_bwd_reference(q, k, v, out, lse, dout, scale)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == q.shape
        # the same rounding points; f32 sums in another order can move one P
        # or dS term across a bf16 boundary, and a bf16 output by one step
        torch.testing.assert_close(g.float(), w.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("variant", ["precompute", "fused"])
def test_backward_kernel_repeats_dk_dv_bit_for_bit(card, variant, monkeypatch):
    """dK and dV are summed in one order inside a block, so two calls on
    the same inputs agree bit for bit. dQ is summed over the key tiles by
    f32 reduce-adds in the order the blocks finish: two calls agree
    within one bf16 step of dQ."""
    monkeypatch.setenv("TASKSRUNNER_FLASH_BWD_DELTA", variant)
    shape = (2, 300, 4, 64)
    gen = torch.Generator(device=card).manual_seed(8)
    q, k, v, dout = (torch.randn(shape, generator=gen, device=card).to(torch.bfloat16)
                     for _ in range(4))
    scale = shape[-1] ** -0.5
    out, lse = flash.flash_fwd(q, k, v, scale)
    first = flash.flash_bwd(q, k, v, out, lse, dout, scale)
    second = flash.flash_bwd(q, k, v, out, lse, dout, scale)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    dq1, dq2 = first[0].float(), second[0].float()
    assert bool(((dq1 - dq2).abs() <= 2.0 ** -7 * dq1.abs() + 1e-6).all())


def test_train_step_launches_each_kernel_once_per_layer(card, monkeypatch):
    monkeypatch.setenv("TASKSRUNNER_FLASH", "1")
    monkeypatch.delenv("TASKSRUNNER_FLASH_BWD_DELTA", raising=False)
    cfg = ModelConfig()
    params = init_params(cfg, 0, card)
    tokens = torch.randint(0, cfg.vocab, (8, cfg.seq_len), device=card)
    labels = torch.randint(0, cfg.n_classes, (8,), device=card)
    step = model.make_train_step(cfg, learning_rate=0.01)
    for _ in range(2):
        before = (flash.launches, flash.bwd_launches, flash.bwd_fused_launches)
        params, loss = step(params, tokens, labels)
        assert torch.isfinite(loss)
        assert (flash.launches - before[0], flash.bwd_launches - before[1],
                flash.bwd_fused_launches - before[2]) == (cfg.n_layers, cfg.n_layers, 0)


def test_f32_activation_matmul_keeps_the_f32_accumulator(card, monkeypatch):
    """With TASKSRUNNER_ACT_F32 the product of bf16-rounded inputs is kept
    in f32, as tasksrunner/ml/model.py:100-102 keeps it. A bf16 product
    cast to f32 afterwards is off by a bf16 rounding (about 2^-9
    relative); the repaired product agrees with the CPU to 1e-5."""
    monkeypatch.setenv("TASKSRUNNER_ACT_F32", "1")
    gen = torch.Generator(device="cpu").manual_seed(6)
    a = torch.randn(8, 32, 128, generator=gen)
    b = torch.randn(128, 512, generator=gen) / 128 ** 0.5
    want = model._matmul(a, b)
    got = model._matmul(a.to(card), b.to(card)).cpu()
    assert got.dtype == want.dtype == torch.float32
    scale = want.abs().max()
    assert (got - want).abs().max() / scale <= 1e-5
    stored_bf16 = torch.matmul(a.to(card, torch.bfloat16), b.to(card, torch.bfloat16))
    assert (stored_bf16.float().cpu() - want).abs().max() / scale > 1e-4


def test_row_parallel_product_keeps_the_f32_accumulator_on_tensor_cores(card):
    """model._product_f32, the wo and w2 partials of the tp-sharded model,
    on the card (bf16 tensor-core products returned in f32) against the
    CPU's f32 product of the same bf16 inputs: the output to 1e-5 of its
    largest value (f32 sums in another order), and the gradients, both
    rounded to bf16, to one bf16 step of the largest (2^-7)."""
    gen = torch.Generator(device="cpu").manual_seed(7)
    a = torch.randn(2, 64, 512, generator=gen).to(torch.bfloat16)
    w = torch.randn(512, 256, generator=gen) / 512 ** 0.5
    grad = torch.randn(2, 64, 256, generator=gen).to(torch.bfloat16).float()

    def run(device):
        a_, w_ = a.to(device).requires_grad_(), w.to(device).requires_grad_()
        out = model._product_f32(a_, w_)
        out.backward(grad.to(device))
        return [x.cpu() for x in (out, a_.grad, w_.grad)]

    got, want = run(card), run("cpu")
    assert [x.dtype for x in got] == [x.dtype for x in want]
    assert got[0].dtype == torch.float32
    for g, w_, tol in zip(got, want, (1e-5, 2 ** -7, 2 ** -7)):
        assert (g.float() - w_.float()).abs().max() <= tol * w_.float().abs().max()


def _ring_state(gen, card, b, sq, h, d, start: bool):
    """The ring's state at its start (-inf, 0, 0), or after one plain
    step over another random block."""
    m = torch.full((b, h, sq), float("-inf"), device=card)
    num = torch.zeros(b, h, sq, d, device=card)
    den = torch.zeros(b, h, sq, device=card)
    if start:
        return m, num, den
    q, k, v = (torch.randn(b, sq, h, d, generator=gen, device=card) for _ in range(3))
    return flash.ring_block_update_reference(q, k, v, m, num, den, scale=d ** -0.5)


@pytest.mark.parametrize("shape", [(2, 16, 24, 2, 32), (16, 4, 4, 4, 16),
                                   (2, 100, 130, 4, 64), (1, 130, 100, 2, 128),
                                   (8, 128, 128, 4, 64), (2, 64, 300, 2, 32),
                                   (3, 200, 129, 2, 16), (2, 128, 128, 2, 128)],
                         ids=lambda s: "b{}sq{}sk{}h{}d{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("start", [True, False], ids=["first-step", "later-step"])
def test_ring_kernel_matches_plain_version(card, shape, dtype, start):
    b, sq, sk, h, d = shape
    gen = torch.Generator(device=card).manual_seed(5)
    q = torch.randn(b, sq, h, d, generator=gen, device=card).to(dtype)
    k, v = (torch.randn(b, sk, h, d, generator=gen, device=card).to(dtype)
            for _ in range(2))
    state = _ring_state(gen, card, b, sq, h, d, start)
    kept = [x.clone() for x in state]
    before = flash.ring_launches
    got = flash.ring_block_update(q, k, v, *state, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert flash.ring_launches == before + 1
    assert all(torch.equal(x, y) for x, y in zip(state, kept))  # not in place
    want = flash.ring_block_update_reference(q, k, v, *state, scale=d ** -0.5)
    # both round P to bf16 against the same final max: m' and den' differ by
    # f32 sums in another order (about d * 2^-24 absolute for m' near 0),
    # num' by at most one P term's bf16 rounding
    torch.testing.assert_close(got[0], want[0], atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(got[1], want[1], atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(got[2], want[2], atol=0, rtol=1e-4)


def test_ring_forward_launches_the_kernel_sp_times_per_layer(card, monkeypatch):
    monkeypatch.setenv("TASKSRUNNER_FLASH", "1")
    cfg = ModelConfig()
    params = init_params(cfg, 0, card)
    tokens = torch.randint(0, cfg.vocab, (8, cfg.seq_len), device=card)
    want = forward(params, tokens, cfg=cfg)
    for sp in (2, 4):
        before = (flash.launches, flash.ring_launches)
        got = forward(params, tokens, cfg=cfg, mesh=Mesh(sp=sp))
        assert (flash.launches - before[0], flash.ring_launches - before[1]) == (
            0, cfg.n_layers * sp)
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


def _ring_case(gen, card, shape, dtype):
    b, sq, sk, h, d = shape
    q = torch.randn(b, sq, h, d, generator=gen, device=card).to(dtype)
    k, v = (torch.randn(b, sk, h, d, generator=gen, device=card).to(dtype)
            for _ in range(2))
    return q, k, v


def test_ring_kernel_repeats_bit_for_bit(card):
    gen = torch.Generator(device=card).manual_seed(15)
    q, k, v = _ring_case(gen, card, (8, 128, 300, 4, 64), torch.bfloat16)
    state = _ring_state(gen, card, 8, 128, 4, 64, start=False)
    first = flash.ring_block_update(q, k, v, *state, scale=0.125)
    second = flash.ring_block_update(q, k, v, *state, scale=0.125)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _rolled(x, shift, sp):
    return torch.roll(x.reshape(-1, sp, *x.shape[1:]), shift, dims=1).reshape(x.shape)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_ring_kernel_shifted_read_equals_rolled_inputs(card, dtype):
    """The in-place read of the visiting block (row bi·sp + r reads K/V of
    row bi·sp + (r − shift) mod sp) gives what the kernel gives on K/V
    rolled along the fold, bit for bit."""
    gen = torch.Generator(device=card).manual_seed(16)
    sp = 4
    q, k, v = _ring_case(gen, card, (2 * sp, 64, 64, 4, 32), dtype)
    state = _ring_state(gen, card, 2 * sp, 64, 4, 32, start=False)
    for shift in range(sp):
        got = flash.ring_block_update(q, k, v, *state, scale=32 ** -0.5, shift=shift, sp=sp)
        want = flash.ring_block_update(q, _rolled(k, shift, sp), _rolled(v, shift, sp), *state,
                                       scale=32 ** -0.5)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _ring_grad_inputs(gen, card, shape, dtype, sp):
    """Inputs of one ring backward step: q, k, v, dO, the LSE and Δ of the
    one-process ring of ``sp`` ranks over them (independent K/V blocks,
    each carrying about 1/sp of a row's softmax mass), and accumulators
    holding earlier sums."""
    b, s, h, d = shape
    q, k, v, dout = (torch.randn(shape, generator=gen, device=card).to(dtype)
                     for _ in range(4))
    m = torch.full((b, h, s), float("-inf"), device=card)
    num, den = torch.zeros(b, h, s, d, device=card), torch.zeros(b, h, s, device=card)
    for shift in range(sp):
        m, num, den = flash.ring_block_update_reference(
            q, _rolled(k, shift, sp), _rolled(v, shift, sp), m, num, den, scale=d ** -0.5)
    out = (num / den[..., None]).transpose(1, 2)
    delta = (dout.float() * out).sum(-1).transpose(1, 2).contiguous()
    acc = [torch.randn(shape, generator=gen, device=card) for _ in range(3)]
    return (q, k, v, dout, m + torch.log(den), delta), acc


@pytest.mark.parametrize("shape", [(8, 16, 4, 32), (8, 128, 4, 64), (2, 300, 2, 64),
                                   (2, 130, 2, 128), (4, 8, 2, 16)],
                         ids=lambda s: "b{}s{}h{}d{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_ring_backward_kernel_matches_plain_version(card, shape, dtype):
    """Every step of a ring of sp 4 (2 where the batch is 2): what the
    kernel adds to the accumulators against what the plain version adds."""
    gen = torch.Generator(device=card).manual_seed(17)
    sp = 4 if shape[0] % 4 == 0 else 2
    inputs, acc = _ring_grad_inputs(gen, card, shape, dtype, sp)
    scale = shape[-1] ** -0.5
    for shift in range(sp):
        got, want = [x.clone() for x in acc], [x.clone() for x in acc]
        flash.ring_block_grad_reference(*inputs, *want, scale=scale, shift=shift, sp=sp)
        before = flash.ring_bwd_launches
        flash.ring_block_grad(*inputs, *got, scale=scale, shift=shift, sp=sp)
        torch.cuda.synchronize()
        assert flash.ring_bwd_launches == before + 1
        for g, w, a in zip(got, want, acc):
            # the B2 card tests' tolerance on the increments, its absolute
            # part in units of the largest one: the same rounding points;
            # f32 sums in another order can move one P or dS term across a
            # bf16 boundary (2^-8 of that term)
            inc = w - a
            torch.testing.assert_close(g - a, inc, rtol=1e-2,
                                       atol=1e-2 * min(1.0, inc.abs().max().item()))


def test_ring_backward_kernel_repeats_dk_dv_bit_for_bit(card):
    gen = torch.Generator(device=card).manual_seed(18)
    inputs, acc = _ring_grad_inputs(gen, card, (4, 300, 2, 64), torch.bfloat16, 2)
    runs = []
    for _ in range(2):
        out = [x.clone() for x in acc]
        flash.ring_block_grad(*inputs, *out, scale=0.125, shift=1, sp=2)
        runs.append(out)
    torch.cuda.synchronize()
    assert torch.equal(runs[0][1], runs[1][1]) and torch.equal(runs[0][2], runs[1][2])
    dq1, dq2 = runs[0][0], runs[1][0]  # reduce-adds over key tiles in block order
    assert bool(((dq1 - dq2).abs() <= 1e-5 * dq1.abs() + 1e-5).all())


def test_sp_train_step_launches_only_the_ring_kernels(card, monkeypatch):
    """A one-process sp 4 step runs B4 in the forward and the ring's
    backward kernel in the backward, n_layers × sp each, and neither the
    dense forward nor its backward."""
    monkeypatch.setenv("TASKSRUNNER_FLASH", "1")
    monkeypatch.delenv("TASKSRUNNER_FLASH_BWD_DELTA", raising=False)
    cfg = ModelConfig()
    params = init_params(cfg, 0, card)
    tokens = torch.randint(0, cfg.vocab, (8, cfg.seq_len), device=card)
    labels = torch.randint(0, cfg.n_classes, (8,), device=card)
    step = model.make_train_step(cfg, Mesh(sp=4), learning_rate=0.01)

    def counts():
        return (flash.launches, flash.bwd_launches, flash.bwd_fused_launches,
                flash.ring_launches, flash.ring_bwd_launches)

    before = counts()
    params, loss = step(params, tokens, labels)
    assert torch.isfinite(loss)
    n = cfg.n_layers * 4
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 0, n, n)


def test_sharded_dryrun_with_every_rank_on_the_card(card):
    """graft_entry.dryrun_multichip(4) with its four ranks on cuda:0 over
    gloo (1 × 2 × 2 at the dryrun config, collectives through the host):
    every rank holds the single-device step, and its step launches B4 and
    the ring's backward n_layers × sp times each and no dense kernel."""
    reports = graft_entry.dryrun_multichip(4, devices=[card] * 4)
    n = graft_entry.DRYRUN_CONFIG.n_layers * 2
    assert [r["launches"] for r in reports] == [
        {"flash_fwd": 0, "flash_bwd_delta": 0, "flash_bwd_fused": 0,
         "flash_ring": n, "flash_ring_bwd": n}] * 4


async def test_scorer_on_the_runtime_stores_a_saved_task(card):
    """make_app() (cuda:0) hosted in an InProcHost: one saved-task event,
    published while the model warms up, is scored on the card and stored,
    with the score ``POST /score`` gives the same task."""
    import asyncio

    from tasksrunner_torch import service
    from tasksrunner_torch.app import App
    from tasksrunner_torch.hosting import InProcHost
    from tasksrunner_torch.pubsub import InMemoryBroker
    from tasksrunner_torch.state import InMemoryStateStore

    store = InMemoryStateStore("scores")
    broker = InMemoryBroker("taskspubsub", max_attempts=1)
    host = InProcHost(state_stores={"scores": store}, brokers={"taskspubsub": broker})
    host.add_app(service.make_app())
    host.add_app(App("some-api"))
    task = {"taskId": "gpu-1", "taskName": "rotate the keys", "taskAssignedTo": "ops"}
    before = flash.launches
    await asyncio.wait_for(host.start(), 60)
    try:
        client = host.client("some-api")
        await asyncio.wait_for(client.publish_event("taskspubsub", "tasksavedtopic", task), 10)
        await asyncio.wait_for(host.wait_ready(), 600)

        async def stored():
            while "gpu-1" not in store.keys():
                await asyncio.sleep(0.01)
        await asyncio.wait_for(stored(), 30)
        got = (await asyncio.wait_for(client.invoke_method(
            "priority-scorer", "scores/gpu-1", http_method="GET"), 10)).json()
        want = (await asyncio.wait_for(client.invoke_method(
            "priority-scorer", "score", data=task), 10)).json()
    finally:
        await asyncio.wait_for(host.stop(), 30)
    assert broker.dead_letters == []
    assert got["priority"] == want["priority"]
    assert abs(got["confidence"] - want["confidence"]) <= 1e-3
    assert flash.launches > before


async def test_an_orchestrated_replica_runs_b1_on_the_card(card, tmp_path):
    """The orchestrator with no device given: its one scorer replica (a
    ``host`` process) answers ``/score`` through its sidecar on the card,
    and the kernel launch counts it logs when it stops are the forward's
    per layer for the warmed bucket and each batch its ``/ml/stats`` shows."""
    import asyncio
    import json

    from tasksrunner_torch.client import http_request
    from tasksrunner_torch.orchestrator.config import AppSpec, RunConfig
    from tasksrunner_torch.orchestrator.run import Orchestrator

    config = RunConfig(apps=[AppSpec(app_id="priority-scorer",
                                     module="tasksrunner_torch.service:make_app",
                                     env={"TASKSRUNNER_ML_BUCKETS": "1,8"})],
                       registry_file=str(tmp_path / "apps.json"), base_dir=tmp_path)
    orch = Orchestrator(config)
    await asyncio.wait_for(orch.start(), 30)
    try:
        [replica] = orch.replicas["priority-scorer"]
        await asyncio.wait_for(replica.ready.wait(), 120)
        body = json.dumps({"taskId": "t", "taskName": "rotate the keys"}).encode()
        path = "/v1.0/invoke/priority-scorer/method/score"
        while (reply := await http_request("127.0.0.1", replica.ports[1], "POST", path,
                                           body=body))[0] == 503:
            await asyncio.sleep(0.25)
        assert reply[0] == 200, reply
        stats = json.loads((await http_request("127.0.0.1", replica.ports[0], "GET",
                                               "/ml/stats"))[2])
    finally:
        await asyncio.wait_for(orch.stop(), 60)
    [line] = [x for x in replica.log_buffer if " kernel launches " in x]
    launched = json.loads(line.split(" pid=")[1].split(" ", 1)[1])
    n_layers = ModelConfig().n_layers
    assert launched["flash_fwd"] == n_layers * sum(
        1 + stats["batches"].get(str(b), 0) for b in stats["buckets"])
    assert launched["flash_bwd_delta"] == launched["flash_ring"] == 0


async def test_a_deployed_replica_runs_b1_on_the_card(card, tmp_path, monkeypatch):
    """``deploy apply`` of a manifest whose state store's database comes
    from a file secret store, then the orchestrator on the run file it
    wrote: the replica answers ``/score`` on the card and stores a
    published event in the file the secret names; its kernel launch
    counts are the forward's per layer for each batch it served."""
    import asyncio
    import json
    import sqlite3

    from tasksrunner_torch.client import http_request
    from tasksrunner_torch.deploy import apply_manifest, load_manifest
    from tasksrunner_torch.orchestrator.config import load_run_config
    from tasksrunner_torch.orchestrator.run import Orchestrator

    monkeypatch.setenv("TASKSRUNNER_API_TOKEN", "card-test")
    (tmp_path / "secrets.json").write_text(json.dumps({"db": str(tmp_path / "scores.db")}))
    (tmp_path / "vault.yaml").write_text(
        "componentType: secretstores.local.file\nmetadata:\n- name: secretsFile\n"
        f"  value: {tmp_path / 'secrets.json'}\n")
    (tmp_path / "scores.yaml").write_text(
        "componentType: state.sqlite\nsecretStoreComponent: vault\nmetadata:\n"
        "- name: databasePath\n  secretRef: db\n")
    (tmp_path / "env.yaml").write_text(
        "environment:\n  name: card\n  require_api_token: true\ncomponents:\n"
        "  - name: vault\n    file: vault.yaml\n  - name: scores\n    file: scores.yaml\n"
        "apps:\n  - app_id: priority-scorer\n    module: tasksrunner_torch.service:make_app\n"
        "    env:\n      TASKSRUNNER_ML_BUCKETS: \"1,8\"\n")
    config = load_run_config(apply_manifest(load_manifest(tmp_path / "env.yaml"))["run_config"])
    orch = Orchestrator(config)
    await asyncio.wait_for(orch.start(), 30)
    token = {"tr-api-token": "card-test"}
    try:
        [replica] = orch.replicas["priority-scorer"]
        await asyncio.wait_for(replica.ready.wait(), 120)
        body = json.dumps({"taskId": "t", "taskName": "rotate the keys"}).encode()
        path = "/v1.0/invoke/priority-scorer/method/score"
        while (reply := await http_request("127.0.0.1", replica.ports[1], "POST", path,
                                           headers=token, body=body))[0] == 503:
            await asyncio.sleep(0.25)
        assert reply[0] == 200, reply
        saved = json.dumps([{"key": "t", "value": json.loads(reply[2])}]).encode()
        status, _, _ = await http_request("127.0.0.1", replica.ports[1], "POST",
                                          "/v1.0/state/scores", headers=token, body=saved)
        assert status == 204
        stats = json.loads((await http_request("127.0.0.1", replica.ports[0], "GET",
                                               "/ml/stats"))[2])
    finally:
        await asyncio.wait_for(orch.stop(), 60)
    with sqlite3.connect(tmp_path / "scores.db") as conn:
        assert [k for (k,) in conn.execute("SELECT key FROM state")] == ["priority-scorer||t"]
    [line] = [x for x in replica.log_buffer if " kernel launches " in x]
    launched = json.loads(line.split(" pid=")[1].split(" ", 1)[1])
    assert launched["flash_fwd"] == ModelConfig().n_layers * sum(
        1 + stats["batches"].get(str(b), 0) for b in stats["buckets"])


async def test_the_scorer_behind_a_queue_binding_stores_plain_forward_scores(card, tmp_path,
                                                                           monkeypatch):
    """make_app() (cuda:0) in an AppHost whose components are a sqlite
    store and the sample's storage-queue binding routed to
    ``/on-task-saved``: 16 messages an outside producer sends are each
    scored on the card and stored once, each score within 2e-2 of the
    forward with the einsum core on the same params, with B1 launched once
    per layer for each warmed bucket and each batch."""
    import asyncio
    import json
    import os
    import sqlite3

    import numpy as np

    from tasksrunner_torch import service
    from tasksrunner_torch.bindings import SqliteQueue
    from tasksrunner_torch.hosting import AppHost

    monkeypatch.setenv("TASKSRUNNER_ML_BUCKETS", "1,8")
    comps = tmp_path / "components"
    comps.mkdir()
    (comps / "scores.yaml").write_text(
        "componentType: state.sqlite\nmetadata:\n- name: databasePath\n"
        f"  value: {tmp_path / 'scores.db'}\n")
    (comps / "queue.yaml").write_text(
        "componentType: bindings.azure.storagequeues\nmetadata:\n- name: queueName\n"
        f"  value: external-tasks-queue\n- name: queuePath\n  value: {tmp_path / 'q'}\n"
        "- name: route\n  value: /on-task-saved\n- name: maxRetries\n  value: \"1000\"\n"
        "- name: retryDelaySeconds\n  value: \"0.5\"\n")
    tasks = [{"taskId": f"gpu-q{i}", "taskName": f"rotate the keys {i}",
              "taskAssignedTo": f"ops{i % 3}"} for i in range(16)]
    app = service.make_app()
    host = AppHost(app, components_path=str(comps), registry_file=str(tmp_path / "apps.json"))
    flash.launches = 0
    await asyncio.wait_for(host.start(), 60)
    try:
        await asyncio.wait_for(app.wait_ready(), 600)
        queue = SqliteQueue(tmp_path / "q" / "external-tasks-queue.db")
        for task in tasks:
            queue.send(task)
        while queue.backlog():
            await asyncio.sleep(0.02)
        assert queue.dead_letter_detail() == []
        queue.close()
        stats = (await app.handle("GET", "/ml/stats")).body
    finally:
        await asyncio.wait_for(host.stop(), 60)
    launched = flash.launches
    with sqlite3.connect(tmp_path / "scores.db") as conn:
        stored = {k.split("||", 1)[1]: json.loads(v)
                  for k, v in conn.execute("SELECT key, value FROM state")}
    assert sorted(stored) == sorted(t["taskId"] for t in tasks)
    cfg = ModelConfig(n_classes=len(service.PRIORITY_LABELS))
    tokens = torch.as_tensor(np.stack([service.task_tokens(t, cfg) for t in tasks]),
                             device=card)
    os.environ["TASKSRUNNER_FLASH"] = "0"
    try:
        with torch.inference_mode():
            probs = torch.softmax(forward(init_params(cfg, 0, card), tokens, cfg=cfg), -1)
    finally:
        os.environ.pop("TASKSRUNNER_FLASH")
    for task, row in zip(tasks, probs.cpu().numpy()):
        got = stored[task["taskId"]]
        label = service.PRIORITY_LABELS.index(got["priority"])
        assert row[label] >= row.max() - 2e-2
        assert abs(float(row[label]) - got["confidence"]) <= 2e-2
    assert launched == cfg.n_layers * sum(1 + stats["batches"].get(str(b), 0)
                                          for b in stats["buckets"])


def _bf16_steps(got, want):
    """The largest |got − want| in bf16 steps, each element's step taken
    at its magnitude or at want's rms, whichever is larger: a sum that
    cancels to near 0 is as uncertain as f32 sums in another order make
    it, far more than a bf16 step of its own tiny value."""
    want = want.float()
    mag = torch.maximum(want.abs(), want.square().mean().sqrt())
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - want).abs() / step).max().item()


def _rounded_twice(x, w, parts: int = 8):
    """The product with its K split in ``parts``, each partial rounded to
    bf16 and summed in bf16: what a reduced-precision reduction does."""
    out = None
    for xs, ws in zip(x.chunk(parts, dim=1), w.chunk(parts, dim=0)):
        part = (xs.float() @ ws.float()).to(torch.bfloat16)
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("m, k, n", [(32, 128, 128), (256, 128, 512), (1024, 512, 128),
                                     (16384, 1024, 1024), (16384, 1024, 4096),
                                     (16384, 4096, 1024)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_bf16_activation_product_rounds_once(card, monkeypatch, m, k, n, reduced):
    """C1: with bf16 activations, model._matmul (a bf16 cuBLAS product,
    model.py:152-153) against the f32 product of the same bf16 inputs
    rounded once to bf16 (tasksrunner/ml/model.py:96-102:
    preferred_element_type=float32, then one cast), with cuBLAS's
    reduced-precision reduction allowed and not, at the served shapes
    (m = b·32, k 128 / 512) and the bench shapes (k 1024 / 4096): at most
    one bf16 step apart (the f32 sums run in another order), where the
    same product with its partial sums rounded to bf16 is more."""
    monkeypatch.delenv("TASKSRUNNER_ACT_F32", raising=False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", reduced)
    gen = torch.Generator(device="cpu").manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen).to(card, torch.bfloat16)
    w = (torch.randn(k, n, generator=gen) / k ** 0.5).to(card, torch.bfloat16)
    once = (x.float() @ w.float()).to(torch.bfloat16)
    got = model._matmul(x, w)
    assert got.dtype == torch.bfloat16
    assert _bf16_steps(got, once) <= 1.0
    # the measure sees a product whose partial sums were rounded to bf16
    assert _bf16_steps(_rounded_twice(x, w), once) > 1.0
