"""The benchmark harness of ``riptide_tpu_torch`` on CUDA cards (see
``run.py``); it imports neither JAX nor the JAX package."""
