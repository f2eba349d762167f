"""
Limits of the card the port's kernels are sized for (an H100), kept
apart from the build so that host planning can read them without
loading anything of CUDA.
"""
__all__ = ["MAX_DYNAMIC_SMEM"]

# The largest dynamic shared memory an H100 block may opt into.
MAX_DYNAMIC_SMEM = 232448
