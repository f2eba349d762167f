"""Device meshes: named axes over ``torch.device`` objects.

The port's counterpart of the JAX package's ``parallel/mesh.py``. A
:class:`Mesh` holds an array of devices with one name per axis; the
sharded entry points (:mod:`.sharded`, :mod:`.seqffa`) place each
shard's work on the device at its mesh position. A device may appear
more than once: ``Mesh(["cpu"] * 8)`` is the tests' eight virtual
shards, ``Mesh([torch.device("cuda", 0)] * 4)`` four shards on one card.
"""
import numpy as np
import torch

__all__ = ["Mesh", "default_mesh", "mesh_2d"]


class Mesh:
    """An n-D array of devices with named axes.

    Attributes
    ----------
    devices : ndarray of torch.device (object), the mesh's shape
    axis_names : tuple of str, one per axis of ``devices``
    shape : dict {axis name: size}
    flat : list of torch.device, ``devices`` in row-major order
    """

    def __init__(self, devices, axis_names=("dm",)):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names) or arr.size == 0:
            raise ValueError(f"a {arr.ndim}-D device array of {arr.size} "
                             f"devices needs one name per axis, got "
                             f"{axis_names}")
        self.flat = [torch.device(d) for d in arr.ravel()]
        self.devices = np.empty(arr.shape, dtype=object)
        for i, d in enumerate(self.flat):
            self.devices.flat[i] = d
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))

    @property
    def size(self):
        return len(self.flat)

    def __repr__(self):
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.flat]})")


def _all_cards():
    """One ``cuda:<i>`` device per card present; raises without one (a
    mesh never falls back to the CPU)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device: a mesh spans the cards present; pass the "
            "devices (for example ['cpu'] * 8) to build one without a card")
    return [torch.device("cuda", i) for i in range(n)]


def default_mesh(devices=None, axis_name="dm"):
    """1-D mesh over every card (or the given devices), for sharding the
    DM-trial batch: one DM shard per device, no communication during
    the search itself."""
    if devices is None:
        devices = _all_cards()
    return Mesh(list(devices), (axis_name,))


def mesh_2d(devices=None, bins_shards=1, axis_names=("dm", "bins")):
    """2-D (dm, bins) mesh: DM data parallelism x phase-bin-trial
    parallelism. ``bins_shards`` must divide the device count."""
    if devices is None:
        devices = _all_cards()
    devices = list(devices)
    n = len(devices)
    if n % bins_shards:
        raise ValueError(f"bins_shards={bins_shards} does not divide {n} "
                         "devices")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(n // bins_shards, bins_shards), axis_names)
