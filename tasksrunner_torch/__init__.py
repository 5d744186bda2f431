"""tasksrunner_torch: the priority scorer of ``tasksrunner/ml`` on
PyTorch and CUDA, for one NVIDIA H100.

The JAX package ``tasksrunner`` stays the reference; this package
imports nothing of it and no JAX. Module names follow the JAX package so
each counterpart is easy to find:

* ``device``      – ``tasksrunner/ml/platform.py``: which device runs
* ``envflag``     – the ``TASKSRUNNER_*`` flags the scorer reads
* ``errors``      – ``SaturatedError``
* ``metrics``     – the part of ``MetricsRegistry`` the batcher calls
* ``model``       – ``tasksrunner/ml/model.py``: config, params, forward,
  loss and the SGD step, on one device or with a sequence-parallel mesh
* ``train``       – a few SGD steps on one seeded batch (bench.py's loop)
* ``flash``       – ``tasksrunner/ml/flash.py``: forward, backward and the
  ring block update, with their CUDA kernels in ``csrc/flash_fwd.cu``,
  ``csrc/flash_bwd.cu`` and ``csrc/flash_ring.cu``, built by ``_kernels``
* ``ring``        – ``tasksrunner/ml/ring.py``: ring attention over the sp
  ranks of a mesh
* ``mesh``        – ``Mesh(sp, group)``, the stand-in for a JAX mesh with
  an ``sp`` axis
* ``batching``    – ``tasksrunner/ml/batching.py``: the micro-batcher
* ``app``         – a standard-library HTTP front end for one app
* ``service``     – ``tasksrunner/ml/service.py``: the scorer served
* ``graft_entry`` – ``__graft_entry__.py``'s ``entry``

Entry points run on ``cuda:0`` unless the caller passes
``device="cpu"``, and raise when there is no card.
"""
