"""
The parts of the JAX package's survey layer that the pipeline reaches:
the metrics registry, incident records and the batcher's fault
injection. The scheduler, journal and liveness layers come later.
"""
