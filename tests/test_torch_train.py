"""The port's loss and train step (tasksrunner_torch/model.py, train.py)
against the JAX model's on the same params, tokens and labels: the JAX
``init_params`` tree goes through numpy into ``params_from_jax``."""

import numpy as np
import pytest
import torch

from tasksrunner.ml.platform import pin_cpu_platform

if not pin_cpu_platform():
    pytest.skip("jax cpu platform unavailable", allow_module_level=True)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tasksrunner.ml import model as jax_model  # noqa: E402
from tasksrunner_torch import flash, model, train  # noqa: E402

# tests/test_ml_extension.py's TINY and the default config
CONFIGS = {
    "tiny": dict(vocab=256, seq_len=8, d_model=32, n_heads=2, d_ff=64,
                 n_layers=2, n_classes=5),
    "default": {},
}


def _inputs(config, batch=4, seed=5):
    jcfg = jax_model.ModelConfig(**CONFIGS[config])
    tree = jax.tree.map(np.asarray, jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab, (batch, jcfg.seq_len), dtype=np.int32)
    labels = rng.integers(0, jcfg.n_classes, (batch,), dtype=np.int32)
    return jcfg, model.ModelConfig(**CONFIGS[config]), tree, tokens, labels


def _flat(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _flat_torch(params):
    # jax.tree.leaves orders dict keys alphabetically
    out = [params[key].numpy() for key in ("embed", "head")]
    out += [layer[key].numpy() for layer in params["layers"] for key in sorted(layer)]
    return out + [params["pos"].numpy()]


@pytest.mark.parametrize("flash_on", ["1", "0"], ids=["flash", "einsum"])
def test_loss_matches_jax(flash_on, monkeypatch):
    monkeypatch.setenv("TASKSRUNNER_FLASH", flash_on)
    jcfg, tcfg, tree, tokens, labels = _inputs("tiny")
    want = float(jax.jit(lambda p, t, y: jax_model.loss_fn(p, t, y, cfg=jcfg))(
        tree, tokens, labels))
    got = model.loss_fn(model.params_from_jax(tree, "cpu"), torch.from_numpy(tokens),
                        torch.from_numpy(labels), cfg=tcfg)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-2, (float(got), want)


@pytest.mark.parametrize("config,flash_on", [("tiny", "1"), ("tiny", "0"),
                                             ("default", "1")],
                         ids=["tiny-flash", "tiny-einsum", "default-flash"])
def test_train_step_matches_jax(config, flash_on, monkeypatch):
    monkeypatch.setenv("TASKSRUNNER_FLASH", flash_on)
    jcfg, tcfg, tree, tokens, labels = _inputs(config)
    lr = 0.1  # large enough that a wrong gradient shows in the leaves
    want_params, want_loss = jax.jit(jax_model.make_train_step(jcfg, learning_rate=lr))(
        jax.tree.map(jnp.asarray, tree), tokens, labels)
    params = model.params_from_jax(tree, "cpu")
    before = (flash.launches, flash.bwd_launches, flash.bwd_fused_launches)
    got_params, got_loss = model.make_train_step(tcfg, learning_rate=lr)(
        params, torch.from_numpy(tokens), torch.from_numpy(labels))
    assert (flash.launches, flash.bwd_launches, flash.bwd_fused_launches) == before
    assert got_params is params  # updated in place, as the JAX step donates
    # the dryrun's limits (__graft_entry__.py:136-155): loss 1e-2, leaves 2e-2
    assert abs(float(got_loss) - float(want_loss)) <= 1e-2
    got, want = _flat_torch(got_params), _flat(want_params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=2e-2, rtol=0)
    # the step moved the params: a gradient of zero would pass the above
    moved = [np.abs(g - t).max() for g, t in zip(got, _flat(tree))]
    assert max(moved) > 1e-3


def test_loss_falls_over_ten_steps():
    """test_ml_extension.py:50-59 on the port, with its params: TINY, lr
    0.1, one batch of hashed task names stepped on ten times. (SGD at lr
    0.1 is unstable on this model; from the JAX test's params it falls in
    both packages.)"""
    _, cfg, tree, _, _ = _inputs("tiny")
    params = model.params_from_jax(tree, "cpu")
    tokens = model.hash_tokens([f"task number {i}" for i in range(8)], cfg, "cpu")
    labels = torch.tensor([i % cfg.n_classes for i in range(8)])
    _, first = model.make_train_step(cfg)(model.params_from_jax(tree, "cpu"), tokens, labels)
    step = model.make_train_step(cfg, learning_rate=0.1)
    for _ in range(10):
        params, loss = step(params, tokens, labels)
    assert float(loss) < float(first)


def test_train_runs_on_the_cpu_and_needs_the_card_otherwise(monkeypatch):
    cfg = model.ModelConfig(**CONFIGS["tiny"])
    losses = train.train(cfg, 3, 4, seed=1, device="cpu", learning_rate=0.1)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses == train.train(cfg, 3, 4, seed=1, device="cpu", learning_rate=0.1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train(cfg, 1, 4)
