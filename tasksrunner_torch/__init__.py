"""tasksrunner_torch: the priority scorer of ``tasksrunner/ml`` on
PyTorch and CUDA, for one NVIDIA H100.

The JAX package ``tasksrunner`` stays the reference; this package
imports nothing of it and no JAX. Module names follow the JAX package so
each counterpart is easy to find:

* ``device``      – ``tasksrunner/ml/platform.py``: which device runs
* ``envflag``     – the ``TASKSRUNNER_*`` flags the scorer reads
* ``errors``      – ``SaturatedError``
* ``metrics``     – the part of ``MetricsRegistry`` the runtime calls,
  its merges and its Prometheus text; ``names``, every metric name
* ``ids``         – ``tasksrunner/ids.py``: cheap span, trace and message ids
* ``model``       – ``tasksrunner/ml/model.py``: config, params, forward,
  loss and the SGD step, on one device, with a sequence-parallel mesh or
  sharded dp × sp × tp over a process group; the serving placement
* ``train``       – a few SGD steps on one seeded batch (bench.py's loop)
* ``flash``       – ``tasksrunner/ml/flash.py``: forward, backward and the
  ring block update, with their CUDA kernels in ``csrc/flash_fwd.cu``,
  ``csrc/flash_bwd.cu`` and ``csrc/flash_ring.cu``, built by ``_kernels``
* ``ring``        – ``tasksrunner/ml/ring.py``: ring attention over the sp
  ranks of a mesh
* ``mesh``        – ``Mesh(dp, sp, tp, group)``, the stand-in for the JAX
  ``("dp", "sp", "tp")`` mesh, and the collectives of the sharded model
* ``batching``    – ``tasksrunner/ml/batching.py``: the micro-batcher,
  with its ``ml-request`` / ``ml-batch`` spans
* ``app``         – ``tasksrunner/app.py``'s routes, subscriptions and
  front door (admission), served over a standard-library HTTP server
* ``service``     – ``tasksrunner/ml/service.py``: the scorer served, its
  saved-task subscription and ``GET /scores/{id}``
* the runtime the scorer is hosted on, each part a standard-library copy
  (no aiohttp, no PyYAML): ``hosting`` (``InProcHost``, the in-process
  host, and ``AppHost``, an app beside its sidecar), ``client``
  (``AppClient``: in-process, beside a runtime, or over HTTP to a
  sidecar), ``runtime`` and ``sidecar`` (the Dapr-shaped HTTP API),
  ``component`` (component files and the driver registry), ``state``
  and ``pubsub`` (in-memory, and the durable sqlite store and broker;
  the state query dialect in ``state.query``), ``bindings`` (the sqlite
  queue, cron, blob and mail bindings),
  ``invoke`` (the app-id resolver), ``security`` (grants),
  ``admission``, ``tracing``, ``spans`` (the runtime's sqlite trace
  file), ``flightrec`` (the black-box ring), ``logconfig`` (role- and
  trace-tagged log lines), ``eventloop`` (the uvloop switch) and
  ``cloudevents``
* ``actors``      – ``tasksrunner/actors/``: virtual actors (placement,
  turns, epoch fencing, durable reminders, failover)
* ``workflows``   – ``tasksrunner/workflows/``: durable, replayed
  workflows on the actors (activities, sagas, timers, children)
* ``orchestrator`` – ``tasksrunner/orchestrator/``: run files, supervised
  and autoscaled replicas, the control-plane lease (``state.lease``) and
  the admin API
* ``cli``         – ``python -m tasksrunner_torch host|serve|sidecar|run``,
  the orchestrator's admin verbs and the operator's verbs
* ``graft_entry`` – ``__graft_entry__.py``'s ``entry`` and its
  self-verifying ``dryrun_multichip`` over spawned ranks

Entry points run on ``cuda:0`` unless the caller passes
``device="cpu"``, and raise when there is no card.
"""
