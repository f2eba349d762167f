"""
Distributed execution: shard the DM-trial batch over a device mesh, and
run one DM shard per process (the port of the JAX package's
``parallel/``).

The reference parallelises its multi-DM search with one OS process per
DM trial (riptide/pipeline/worker_pool.py:36-44) and no communication
backend beyond fork + pickle. Here a :class:`~.mesh.Mesh` names the
devices: each ``dm`` shard's slice of the (D, N) batch is shipped to its
device, every shard runs the same stage kernels on its slice (K2 per
stage, :mod:`.sharded`), and only each shard's peak buffer comes back
to the host. A second, optional ``bins`` axis splits each stage's
bins-trial batch across devices.

For transforms too large for one device, sequence parallelism shards
the fold container's row axis instead (:mod:`.seqffa`).

Multi-process: :func:`init_distributed` joins a ``torch.distributed``
process group (gloo); :func:`run_search_multihost` searches one DM
shard per process and all-gathers the Peak lists as host arrays.
"""
from .mesh import Mesh, default_mesh, mesh_2d
from .sharded import (
    collect_search_sharded,
    prepare_stage_data_sharded,
    queue_search_sharded,
    run_periodogram_sharded,
    run_search_sharded,
    ship_stage_data_sharded,
)
from .seqffa import ffa2_seq, seq_mesh
from .distributed import init_distributed
from .multihost import gather_peaks, run_search_multihost

__all__ = [
    "default_mesh",
    "mesh_2d",
    "run_periodogram_sharded",
    "run_search_sharded",
    "queue_search_sharded",
    "collect_search_sharded",
    "prepare_stage_data_sharded",
    "ship_stage_data_sharded",
    "ffa2_seq",
    "seq_mesh",
    "init_distributed",
    "gather_peaks",
    "run_search_multihost",
]
