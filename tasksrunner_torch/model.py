"""Task-priority scorer: the port of ``tasksrunner/ml/model.py``'s
forward, loss and train step, on one device, with sequence-parallel
attention over a one-process :class:`~tasksrunner_torch.mesh.Mesh`, or
sharded dp × sp × tp over a mesh on a process group; and the serving
path's placement over several devices.

The arithmetic follows the JAX model step by step, so that the same
params and tokens give the same logits:

* every matmul takes bf16 inputs, accumulates in f32 and stores its
  result in the activation dtype (bf16 unless ``TASKSRUNNER_ACT_F32``);
  the f32 params are cast at each use;
* layernorm takes f32 moments with the population variance, eps 1e-6,
  and a scale with no bias;
* the feed-forward gelu is the tanh approximation (``jax.nn.gelu``'s
  default);
* the pad id 0 is neither masked in attention nor left out of the mean
  pool, as in the reference;
* the logits are f32, from a bf16 product with the head.

The attention core is the flash kernel (:mod:`tasksrunner_torch.flash`)
unless ``TASKSRUNNER_FLASH`` is off, which selects the plain einsum pair
kept as the reference core. Both are differentiable: the flash core
through its backward kernels, the einsum core through plain autograd,
which makes it the gradient reference on the card. Given a mesh whose
``sp`` axis is larger than 1, the core is ring attention
(:mod:`tasksrunner_torch.ring`) instead, as in model.py:137-139; with a
one-process mesh everything outside the core stays global, as under
GSPMD.

Over a mesh on a process group each rank holds its slices of the params
(:func:`shard_params`, the layout of :func:`param_specs`) and computes its
dp block of the batch on its sp block of the sequence with its tp share
of the heads and of the feed-forward width; the collectives, and the
convention for their gradients, are :mod:`tasksrunner_torch.mesh`'s.

Params are a plain dict with the JAX tree's keys and its ``[in, out]``
layouts, so :func:`params_from_jax` loads a JAX tree without transposes.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from tasksrunner_torch.device import resolve_device
from tasksrunner_torch.envflag import env_flag
from tasksrunner_torch.flash import flash_attention, use_flash
from tasksrunner_torch.mesh import Mesh, all_gather, all_reduce
from tasksrunner_torch.ring import ring_attention

_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "ln1", "ln2")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 8192       # hashed token ids
    seq_len: int = 32
    d_model: int = 128
    n_heads: int = 4
    d_ff: int = 512
    n_layers: int = 2
    n_classes: int = 5      # priority buckets

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device | None = None) -> dict[str, Any]:
    """Random f32 params from ``seed``, drawn on ``device``. The layouts
    are the JAX model's; the numbers are not (``torch.Generator`` and
    ``jax.random`` differ), so tests that compare the two packages load
    one set into both with :func:`params_from_jax`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape: int) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    def dense(fan_in: int, fan_out: int) -> torch.Tensor:
        return normal(fan_in, fan_out) / fan_in ** 0.5

    params: dict[str, Any] = {
        "embed": 0.02 * normal(cfg.vocab, cfg.d_model),
        "pos": 0.02 * normal(cfg.seq_len, cfg.d_model),
        "head": dense(cfg.d_model, cfg.n_classes),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "wq": dense(cfg.d_model, cfg.d_model),
            "wk": dense(cfg.d_model, cfg.d_model),
            "wv": dense(cfg.d_model, cfg.d_model),
            "wo": dense(cfg.d_model, cfg.d_model),
            "w1": dense(cfg.d_model, cfg.d_ff),
            "w2": dense(cfg.d_ff, cfg.d_model),
            "ln1": torch.ones(cfg.d_model, device=dev),
            "ln2": torch.ones(cfg.d_model, device=dev),
        })
    return params


def params_from_jax(tree: dict[str, Any],
                    device: str | torch.device | None = None) -> dict[str, Any]:
    """The JAX ``init_params`` tree, given as numpy arrays (a dict with
    a ``layers`` list of dicts), as the port's params on ``device``."""
    dev = resolve_device(device)

    def put(a: Any) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return {
        "embed": put(tree["embed"]),
        "pos": put(tree["pos"]),
        "head": put(tree["head"]),
        "layers": [{key: put(layer[key]) for key in _LAYER_KEYS}
                   for layer in tree["layers"]],
    }


def act_dtype() -> torch.dtype:
    """Residual-stream / activation dtype: bf16 unless
    ``TASKSRUNNER_ACT_F32`` is on."""
    return (torch.float32 if env_flag("TASKSRUNNER_ACT_F32", default=False)
            else torch.bfloat16)


def _bf16_f32(x: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16, held in f32: a product of two such tensors in
    f32 is exact per term and accumulates in f32, as the reference's
    ``preferred_element_type=float32`` products do."""
    return x.to(torch.bfloat16).float()


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 × bf16 with f32 accumulation, stored in the activation
    dtype (tasksrunner/ml/model.py:96-102). With bf16 activations on the
    card this is a bf16 cuBLAS product, which accumulates in f32 and
    rounds once to bf16 as the reference does. Otherwise it is the f32
    product of bf16-rounded inputs, which keeps the f32 accumulator: a
    bf16 product stored in f32 would be rounded to bf16 first. Each
    bf16 value is exact in TF32 too, so the TF32 setting does not change
    the result beyond summation order."""
    dtype = act_dtype()
    if a.is_cuda and dtype == torch.bfloat16:
        return torch.matmul(a.to(torch.bfloat16), b.to(torch.bfloat16))
    return (_bf16_f32(a) @ _bf16_f32(b)).to(dtype)


def _layernorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + 1e-6) * scale).to(act_dtype())


def _einsum_attention(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """The plain reference core: bf16 logits accumulated in f32, softmax
    in f32, bf16 probabilities times bf16 v accumulated in f32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", _bf16_f32(q), _bf16_f32(k))
    probs = torch.softmax(logits / q.shape[-1] ** 0.5, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", _bf16_f32(probs), _bf16_f32(v))


def _use_ring(mesh: Mesh | None) -> bool:
    return (mesh is not None and "sp" in mesh.axis_names
            and mesh.shape["sp"] > 1)


def _sharded(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.group is not None


def _check_mesh(mesh: Mesh | None, cfg: ModelConfig) -> None:
    """sp must divide the sequence, and over a process group tp must
    divide the heads and the feed-forward width (ValueError, "divide")."""
    if mesh is None:
        return
    mesh.block(cfg.seq_len)
    if _sharded(mesh):
        mesh.heads(cfg.n_heads)
        if cfg.d_ff % mesh.tp:
            raise ValueError(f"tp={mesh.tp} must divide d_ff={cfg.d_ff}")


def _core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mesh: Mesh | None) -> torch.Tensor:
    if _use_ring(mesh):
        return ring_attention(q, k, v, mesh=mesh)  # f32, as the JAX ring returns it
    if use_flash():
        return flash_attention(q, k, v)
    return _einsum_attention(q, k, v)


def _attention(x: torch.Tensor, layer: dict, cfg: ModelConfig,
               mesh: Mesh | None = None) -> torch.Tensor:
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.d_head

    def heads(w: torch.Tensor) -> torch.Tensor:
        return _matmul(x, w).reshape(b, s, h, dh)

    q, k, v = heads(layer["wq"]), heads(layer["wk"]), heads(layer["wv"])
    ctx = _core(q, k, v, mesh)
    return _matmul(ctx.reshape(b, s, h * dh), layer["wo"])


def _local_batch(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """This rank's dp block of the rows of ``x``; all of them without a
    process group."""
    if not _sharded(mesh):
        return x
    if x.shape[0] % mesh.dp:
        raise ValueError(f"dp={mesh.dp} must divide the batch of {x.shape[0]}")
    rows = x.shape[0] // mesh.dp
    return x[mesh.coord("dp") * rows:(mesh.coord("dp") + 1) * rows]


class _ProductF32(torch.autograd.Function):
    """bf16 a [m, k] @ bf16 b [k, n] accumulated and returned in f32 by the
    card's tensor cores (``torch.mm(out_dtype=)``, which has no autograd
    formula). Its gradients are the ones autograd gives the f32 product of
    bf16-rounded inputs: for a gradient held in bf16, as it is here, bf16
    products accumulated in f32 and rounded to bf16."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad = grad.to(torch.bfloat16)
        return (grad @ b.t() if ctx.needs_input_grad[0] else None,
                a.t() @ grad if ctx.needs_input_grad[1] else None)


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., k] @ b [k, n] of bf16-rounded inputs, accumulated and
    returned in f32. With bf16 activations on the card the gradient
    reaching it is bf16, and this is :class:`_ProductF32`; otherwise it
    is the product in f32."""
    if a.is_cuda and act_dtype() == torch.bfloat16:
        rows = _ProductF32.apply(a.reshape(-1, a.shape[-1]).to(torch.bfloat16),
                                 b.to(torch.bfloat16))
        return rows.reshape(*a.shape[:-1], b.shape[-1])
    return _bf16_f32(a) @ _bf16_f32(b)


def _row_parallel(a: torch.Tensor, w: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """a @ w for w split on its input dim over tp: each rank's product in
    f32, summed over tp in f32, then stored in the activation dtype, so it
    is rounded once, as the single-device product is."""
    return mesh.reduce(_product_f32(a, w), "tp").to(act_dtype())


def _sharded_attention(x: torch.Tensor, layer: dict, cfg: ModelConfig,
                       mesh: Mesh) -> torch.Tensor:
    """This rank's h/tp heads from the column slices of wq, wk and wv, and
    their share of the wo product summed over tp."""
    b, s, _ = x.shape
    h, dh = mesh.heads(cfg.n_heads), cfg.d_head
    x = mesh.enter(x, "tp")
    q, k, v = (_matmul(x, layer[key]).reshape(b, s, h, dh) for key in ("wq", "wk", "wv"))
    return _row_parallel(_core(q, k, v, mesh).reshape(b, s, h * dh), layer["wo"], mesh)


def _sharded_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                     mesh: Mesh) -> torch.Tensor:
    """The forward of one rank of a process-group mesh over this rank's
    shard of the params: its dp block of the logits, replicated over sp
    and tp (the layout of model.py:185-239)."""
    if params["embed"].shape[1] != cfg.d_model // mesh.tp:
        raise ValueError("over a process group the model takes this rank's shard of "
                         "the params (shard_params)")
    block = mesh.block(cfg.seq_len)
    cols = slice(mesh.coord("sp") * block, (mesh.coord("sp") + 1) * block)

    def local(w: torch.Tensor) -> torch.Tensor:  # replicated over sp, used on one block
        return mesh.enter(w, "sp")

    x = mesh.gather(local(params["embed"])[_local_batch(tokens, mesh)[:, cols].long()], "tp")
    x = (x + local(params["pos"])[cols]).to(act_dtype())
    for layer in params["layers"]:
        layer = {key: local(w) for key, w in layer.items()}
        x = x + _sharded_attention(_layernorm(x, layer["ln1"]), layer, cfg, mesh)
        y = mesh.enter(_layernorm(x, layer["ln2"]), "tp")
        x = x + _row_parallel(F.gelu(_matmul(y, layer["w1"]), approximate="tanh"),
                              layer["w2"], mesh)
    pooled = mesh.reduce(x.float().sum(dim=1), "sp") / cfg.seq_len
    return _bf16_f32(pooled) @ _bf16_f32(params["head"])


def forward(params: dict, tokens: torch.Tensor, *, cfg: ModelConfig,
            mesh: Mesh | None = None) -> torch.Tensor:
    """tokens [batch, seq] integer → class logits [batch, n_classes], f32.
    A one-process ``mesh`` only changes which attention core runs (the
    ring under an sp axis larger than 1). Over a mesh on a process group
    every rank passes the whole batch of tokens and its shard of the
    params, and gets the logits of its dp block of rows."""
    _check_mesh(mesh, cfg)
    if _sharded(mesh):
        return _sharded_forward(params, tokens, cfg, mesh)
    x = (params["embed"][tokens.long()] + params["pos"][None, :, :]).to(act_dtype())
    for layer in params["layers"]:
        x = x + _attention(_layernorm(x, layer["ln1"]), layer, cfg, mesh)
        y = _layernorm(x, layer["ln2"])
        y = _matmul(F.gelu(_matmul(y, layer["w1"]), approximate="tanh"), layer["w2"])
        x = x + y
    pooled = x.float().mean(dim=1)
    return _bf16_f32(pooled) @ _bf16_f32(params["head"])


def loss_fn(params: dict, tokens: torch.Tensor, labels: torch.Tensor, *,
            cfg: ModelConfig, mesh: Mesh | None = None) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` [batch] under the
    log-softmax of the f32 logits (tasksrunner/ml/model.py:176-180); over
    a process group, the mean over this rank's dp block."""
    logp = F.log_softmax(forward(params, tokens, cfg=cfg, mesh=mesh), dim=-1)
    return -logp.gather(1, _local_batch(labels, mesh).long()[:, None]).mean()


def _leaves(params: dict) -> list[torch.Tensor]:
    """Every tensor of ``params`` in a fixed order."""
    return [params["embed"], params["pos"], params["head"],
            *(layer[key] for layer in params["layers"] for key in _LAYER_KEYS)]


def _with_leaves(leaves: list[torch.Tensor]) -> dict[str, Any]:
    """The params dict of :func:`_leaves`' order."""
    n = len(_LAYER_KEYS)
    return {"embed": leaves[0], "pos": leaves[1], "head": leaves[2],
            "layers": [dict(zip(_LAYER_KEYS, leaves[i:i + n]))
                       for i in range(3, len(leaves), n)]}


def _mean_over_dp(tensors: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """Each tensor's mean over the dp ranks, by one f32 sum of them all
    flattened into one buffer."""
    if mesh.dp == 1:
        return tensors
    flat = all_reduce(torch.cat([t.reshape(-1).float() for t in tensors]),
                      mesh.dp_group) / mesh.dp
    return [piece.view_as(t).to(t.dtype)
            for piece, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def make_train_step(cfg: ModelConfig, mesh: Mesh | None = None, *,
                    learning_rate: float = 1e-3):
    """One SGD step, ``step(params, tokens, labels) -> (params, loss)``
    (tasksrunner/ml/model.py:211-239; with a one-process ``mesh`` the
    attention core is the ring and everything else is the single-device
    step, as GSPMD computes the same function). The gradient of
    every leaf comes from ``torch.autograd.grad`` of :func:`loss_fn`;
    the f32 masters are then updated in place under ``torch.no_grad()``,
    which is what ``donate_argnums=(0,)`` lets XLA do with the JAX
    step's params: the ``params`` returned are the ones passed in, and
    no second copy is held. The loss comes back as a detached 0-d f32
    tensor; reading it waits for the step.

    Over a mesh on a process group, ``params`` is this rank's shard and
    ``tokens``/``labels`` the whole batch; the gradients and the loss are
    averaged over dp, so the loss is the whole batch's mean, as the JAX
    step returns it, and every replicated leaf comes out equal on every
    rank."""
    _check_mesh(mesh, cfg)

    def step(params: dict, tokens: torch.Tensor,
             labels: torch.Tensor) -> tuple[dict, torch.Tensor]:
        leaves = _leaves(params)
        views = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            loss = loss_fn(_with_leaves(views), tokens, labels, cfg=cfg, mesh=mesh)
            grads = torch.autograd.grad(loss, views)
        if _sharded(mesh):
            *grads, loss = _mean_over_dp([*grads, loss.detach()], mesh)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(learning_rate * g)
        return params, loss.detach()

    return step


def hash_token_ids(text: str, cfg: ModelConfig) -> list[int]:
    """Deterministic hashed tokenizer for one text (no external
    vocab): words → buckets in [1, vocab); 0 is padding."""
    ids = [1 + (zlib.crc32(w.lower().encode()) % (cfg.vocab - 1))
           for w in text.split()][: cfg.seq_len]
    return ids + [0] * (cfg.seq_len - len(ids))


def hash_tokens(texts: list[str], cfg: ModelConfig,
                device: str | torch.device | None = None) -> torch.Tensor:
    """Batched :func:`hash_token_ids`, as an int32 tensor on ``device``."""
    return torch.tensor([hash_token_ids(t, cfg) for t in texts],
                        dtype=torch.int32, device=resolve_device(device))


# -- sharding over a process group ------------------------------------------

_LAYER_SPECS = {"wq": (None, "tp"), "wk": (None, "tp"), "wv": (None, "tp"),
                "wo": ("tp", None), "w1": (None, "tp"), "w2": ("tp", None),
                "ln1": (None,), "ln2": (None,)}


def param_specs(cfg: ModelConfig) -> dict[str, Any]:
    """The params tree with, for each leaf, one entry per dim: ``"tp"``
    where the dim is split over the tp ranks, None where it is whole
    (tasksrunner/ml/model.py:185-199). wq, wk, wv, w1 and embed are split
    on their output dim, wo and w2 on their input dim; ln, pos and head
    are replicated. Every leaf is replicated over dp and sp."""
    return {"embed": (None, "tp"), "pos": (None, None), "head": (None, None),
            "layers": [dict(_LAYER_SPECS) for _ in range(cfg.n_layers)]}


def _split_dims(params: dict) -> list[int | None]:
    """The tp-split dim of each leaf of ``params``, in :func:`_leaves`'
    order."""
    specs = _leaves(param_specs(ModelConfig(n_layers=len(params["layers"]))))
    return [spec.index("tp") if "tp" in spec else None for spec in specs]


def shard_params(params: dict, mesh: Mesh) -> dict[str, Any]:
    """This rank's slices of the whole tree ``params`` (model.py:202-208):
    new contiguous tensors on the params' device, not views of the tree."""
    i, n = mesh.coord("tp"), mesh.tp

    def piece(x: torch.Tensor, dim: int | None) -> torch.Tensor:
        if dim is None:
            return x.clone()
        if x.shape[dim] % n:
            raise ValueError(f"tp={n} must divide dim {dim} of a {tuple(x.shape)} leaf")
        width = x.shape[dim] // n
        return x.narrow(dim, i * width, width).clone(memory_format=torch.contiguous_format)

    return _with_leaves([piece(x, dim) for x, dim in zip(_leaves(params), _split_dims(params))])


def gather_params(params: dict, mesh: Mesh) -> dict[str, Any]:
    """The whole tree from every tp rank's shard ``params``, the inverse of
    :func:`shard_params`; collective over ``mesh.tp_group``."""
    def whole(x: torch.Tensor, dim: int | None) -> torch.Tensor:
        if dim is None or mesh.tp == 1:
            return x.clone()
        return all_gather(x, mesh.tp_group, dim)

    return _with_leaves([whole(x, dim) for x, dim in zip(_leaves(params), _split_dims(params))])


# -- serving placement ------------------------------------------------------

def serving_mesh(devices: list | None = None) -> tuple[torch.device, ...] | None:
    """The serving path's data mesh (model.py:260-270): the devices, every
    visible card by default, that a batch's rows are split over; None for
    one device or none, where the served path stays as it is."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(resolve_device(d) for d in devices)
    return devices if len(devices) > 1 else None


def replicate_params(params: dict, devices: list) -> list[dict[str, Any]]:
    """A copy of ``params`` on each of ``devices``, made once, so that no
    serving call moves weights (model.py:273-276)."""
    return [_with_leaves([p.to(dev) for p in _leaves(params)]) for dev in devices]
