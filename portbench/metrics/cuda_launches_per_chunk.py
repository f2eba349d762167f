"""Dispatch: the stage kernels' CUDA launches a chunk, from the
program's ``ffa_kernel.KERNEL_LAUNCHES`` counters over the window."""


def read(rec):
    if not rec["chunks"]:
        return None
    return sum(rec["launches"].values()) / rec["chunks"]
