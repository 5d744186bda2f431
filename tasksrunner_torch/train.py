"""A few SGD steps of the scorer: the counterpart of the loop in
``bench.py::run_tpu_step_bench`` (one batch of tokens and labels drawn
once from a seed, then stepped on repeatedly). It is not a bench: it
returns the losses and times nothing.

    from tasksrunner_torch.model import ModelConfig
    from tasksrunner_torch.train import train
    losses = train(ModelConfig(), steps=10, batch=8, seed=0, learning_rate=0.1)

Runs on ``cuda:0`` unless ``device="cpu"`` is given, and raises when
there is no card.
"""

from __future__ import annotations

import torch

from tasksrunner_torch.device import resolve_device
from tasksrunner_torch.model import ModelConfig, init_params, make_train_step


def train(cfg: ModelConfig, steps: int, batch: int, *, seed: int = 0,
          device: str | torch.device | None = None,
          learning_rate: float = 1e-3) -> list[float]:
    """``steps`` SGD steps from ``init_params(cfg, seed)`` on one batch
    of ``batch`` random token rows and labels made on the device by a
    ``torch.Generator`` seeded with ``seed``; returns each step's loss."""
    dev = resolve_device(device)
    params = init_params(cfg, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (batch, cfg.seq_len), generator=gen,
                           device=dev, dtype=torch.int32)
    labels = torch.randint(0, cfg.n_classes, (batch,), generator=gen, device=dev)
    step = make_train_step(cfg, learning_rate=learning_rate)
    losses = []
    for _ in range(steps):
        params, loss = step(params, tokens, labels)
        losses.append(loss)
    return [float(loss) for loss in losses]
