"""The priority scorer served over HTTP: the port of
``tasksrunner/ml/service.py``.

* ``POST /score``: a task JSON in, ``{"priority", "confidence"}`` out,
  with the request's ``taskId`` echoed so callers can match concurrent
  scores to their tasks. 400 for a body that is not a JSON object, 429
  + ``Retry-After`` when the batcher sheds, 503 + ``Retry-After`` while
  the model warms up.
* the ``tasksavedtopic`` subscription (``POST /on-task-saved``): every
  saved task is scored and the score saved under its ``taskId`` in the
  ``scores`` state store, as the Tasks Tracker's processor consumes the
  same topic. 503 + ``Retry-After`` during warm-up and 429 +
  ``Retry-After`` when the batcher sheds: the runtime then redelivers
  the event after that many seconds without using up an attempt. A
  non-task event is acked with 200; a delivery whose score could not be
  saved is answered 500, so the runtime redelivers it: an acked event is
  one whose score was saved.
* ``GET /scores/{task_id}``: the stored score, or 404.
* ``GET /ml/stats``: the batcher's counters, ``ready``, and
  ``jit_cache_size``, the number of distinct batch shapes the forward
  has run. PyTorch runs eagerly and compiles nothing per shape, but the
  number still shows the bucket discipline: it equals the ladder's
  length after warm-up and stays there under any burst.
* ``GET /metrics``: the batcher's registry, flat: the process-wide one,
  so the ``ml_*`` series sit beside the runtime's and a hosted replica's
  sidecar serves them too (its ``/metrics`` text, ``/v1.0/metadata``);
  the app's ``registry`` is that registry, whose
  ``snapshot_histograms()`` gives the queue wait and service time per
  bucket.

After warm-up the batcher's ``saturation()`` is registered as the
admission signal ``ml_tokens_in_flight`` (unregistered at shutdown), so
with ``TASKSRUNNER_ADMISSION`` on a flood is shed with 429 at the front
door (:mod:`tasksrunner_torch.admission`). The subscription and the
state store need a runtime: an :class:`~tasksrunner_torch.hosting.InProcHost`
in the same process, an :class:`~tasksrunner_torch.hosting.AppHost`
(``python -m tasksrunner_torch host``), or a ``python -m tasksrunner_torch
sidecar --app-port P`` beside the app served by ``serve``.

Requests go through :class:`~tasksrunner_torch.batching.MicroBatcher`:
batches are padded up the bucket ladder, and each runs ``forward`` and
the softmax on the device with one device-to-host copy of the
probabilities. Params go onto the device once, at warm-up, which runs
off the event loop and runs every bucket once, building and loading the
attention kernel on the way.

Served on several devices (``model.serving_mesh``), the params are
copied to each once, at warm-up, and a bucket whose rows divide evenly
over the devices is split over them (:func:`place_tokens`, service.py:81-90
of the JAX package); any other bucket runs on the first device. The
probabilities come back in row order, one device-to-host copy per
device. With one device, as on one card, nothing of this runs.
"""

from __future__ import annotations

import asyncio
from typing import Any

import numpy as np
import torch

from tasksrunner_torch import admission
from tasksrunner_torch.app import App, Request, Response
from tasksrunner_torch.batching import BatcherConfig, MicroBatcher
from tasksrunner_torch.device import resolve_device
from tasksrunner_torch.envflag import env_flag
from tasksrunner_torch.errors import SaturatedError
from tasksrunner_torch.model import (
    ModelConfig, forward, hash_token_ids, init_params, replicate_params, serving_mesh,
)

PRIORITY_LABELS = ["backlog", "low", "normal", "high", "urgent"]

#: seconds the not-ready path asks clients to stay away; warm-up is
#: seconds, so one beat is enough
WARMUP_RETRY_AFTER = 1


def place_tokens(tokens: np.ndarray, devices: list) -> list[tuple[int, torch.Tensor]]:
    """(device index, rows on that device) for each part of a bucket of
    ``tokens``: its rows split evenly over ``devices`` in order when their
    number divides the bucket, else the whole bucket on the first."""
    n = len(devices) if tokens.shape[0] % len(devices) == 0 else 1
    return [(i, torch.from_numpy(part).to(devices[i]))
            for i, part in enumerate(np.split(tokens, n))]


def task_tokens(task: dict, cfg: ModelConfig) -> np.ndarray:
    """The token ids the scorer reads for a task: its name, creator and
    assignee, hashed (``"empty"`` for a task with none of them)."""
    text = " ".join(str(task.get(k, "")) for k in ("taskName", "taskCreatedBy", "taskAssignedTo")
                    if task.get(k))
    return np.asarray(hash_token_ids(text or "empty", cfg), np.int32)


def batch_probs(replicas: list[dict], devices: list, tokens: np.ndarray, *,
                cfg: ModelConfig) -> np.ndarray:
    """The class probabilities of a bucket of ``tokens``, computed on the
    devices :func:`place_tokens` gives each part (``replicas[i]`` being the
    params on ``devices[i]``), in row order: every part's forward is
    queued before the first device-to-host copy, one copy per part."""
    with torch.inference_mode():
        probs = [torch.softmax(forward(replicas[i], part, cfg=cfg), dim=-1)
                 for i, part in place_tokens(tokens, devices)]
        return np.concatenate([p.cpu().numpy() for p in probs])


def make_app(*, pubsub: str = "taskspubsub", topic: str = "tasksavedtopic",
             state_store: str = "scores",
             device: str | torch.device | None = None) -> App:
    """The scorer as an :class:`App` with id ``priority-scorer``, its
    params drawn from seed 0, subscribed to ``topic`` on ``pubsub`` and
    saving scores in ``state_store``. It serves on ``device`` when one is
    given, else on every visible card
    (:func:`~tasksrunner_torch.model.serving_mesh`; on one card,
    ``cuda:0``)."""
    mesh = serving_mesh() if device is None else None
    devs = list(mesh) if mesh else [resolve_device(device)]
    cfg = ModelConfig(n_classes=len(PRIORITY_LABELS))
    app = App("priority-scorer")
    loaded: dict[str, Any] = {}
    shapes_run: set[tuple[int, ...]] = set()

    bcfg = BatcherConfig.from_env()
    if not env_flag("TASKSRUNNER_ML_BATCHING"):
        bcfg = bcfg.serial()

    def _probs(replicas: list[dict], tokens: np.ndarray) -> np.ndarray:
        # inference_mode is thread-local: batch_probs enters it in the
        # worker thread that runs the batch
        probs = batch_probs(replicas, devs, tokens, cfg=cfg)
        shapes_run.add(tokens.shape)
        return probs

    def _run_batch(rows: list[np.ndarray], bucket: int) -> list[dict]:
        tokens = np.zeros((bucket, cfg.seq_len), np.int32)
        for i, row in enumerate(rows):
            tokens[i] = row
        probs = _probs(loaded["params"], tokens)
        out = []
        for i in range(len(rows)):
            idx = int(probs[i].argmax())
            out.append({
                "priority": PRIORITY_LABELS[idx],
                "confidence": round(float(probs[i, idx]), 4),
            })
        return out

    batcher = MicroBatcher(
        _run_batch, config=bcfg,
        tokens_of=lambda row: int((row != 0).sum()) or 1)
    app.registry = batcher.registry

    @app.on_startup
    async def load_model() -> None:
        def build() -> list[dict]:
            params = replicate_params(init_params(cfg, 0, devs[0]), devs)
            # every bucket once, so no request meets a shape the forward
            # has not run (and the kernel is built before the first one)
            for bucket in bcfg.buckets:
                _probs(params, np.zeros((bucket, cfg.seq_len), np.int32))
            return params

        params = await asyncio.to_thread(build)
        batcher.start()
        admission.register_signal("ml_tokens_in_flight", batcher.saturation)
        loaded["params"] = params

    @app.on_shutdown
    async def unload_model() -> None:
        admission.unregister_signal("ml_tokens_in_flight")
        await batcher.stop()

    def _not_ready() -> Response:
        return Response(503, {"error": "model loading, retry shortly"},
                        headers={"Retry-After": str(WARMUP_RETRY_AFTER)})

    def _shed(exc: SaturatedError) -> Response:
        return Response(429, {"error": str(exc)},
                        headers={"Retry-After": str(int(exc.retry_after or 1))})

    @app.post("/score")
    async def score(req: Request) -> Any:
        if "params" not in loaded:
            return _not_ready()
        try:
            task = req.json()
        except ValueError:
            return 400, {"error": "body must be JSON"}
        if not isinstance(task, dict):
            return 400, {"error": "body must be a task object"}
        try:
            result = await batcher.submit(task_tokens(task, cfg))
        except SaturatedError as exc:
            return _shed(exc)
        if task.get("taskId") is not None:
            result = {**result, "taskId": str(task["taskId"])}
        return result

    @app.subscribe(pubsub, topic, "/on-task-saved")
    async def on_task_saved(req: Request) -> Any:
        if "params" not in loaded:
            return _not_ready()  # Retry-After: the runtime backs off
        task = req.data  # the CloudEvents envelope unwrapped
        if not isinstance(task, dict) or not task.get("taskId"):
            return 200  # not a task event; ack and move on
        try:
            result = await batcher.submit(task_tokens(task, cfg))
        except SaturatedError as exc:
            return _shed(exc)
        await app.client.save_state(state_store, str(task["taskId"]), result)
        return 200

    @app.get("/scores/{task_id}")
    async def get_score(req: Request) -> Any:
        task_id = req.path_params["task_id"]
        value = await app.client.get_state(state_store, task_id)
        if value is None:
            return 404, {"error": f"no score for {task_id}"}
        return value

    @app.get("/ml/stats")
    async def ml_stats(req: Request) -> dict:
        stats = batcher.stats()
        stats["ready"] = "params" in loaded
        stats["jit_cache_size"] = len(shapes_run)
        return stats

    @app.get("/metrics")
    async def metrics(req: Request) -> dict:
        return batcher.registry.snapshot()

    return app
