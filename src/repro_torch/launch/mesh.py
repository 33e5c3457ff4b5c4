"""Production meshes and the bring-up of a process group (port of
``repro.launch.mesh``).

`make_production_mesh` is a FUNCTION (not a module-level constant) so that
importing this module never touches device or process-group state.  torch
runs one process per rank: the caller brings the group up first
(``init_process_group``), then builds a mesh over it.

Mesh layout (the reference's shapes and names):
  single pod:  (16, 16)     -> ("data", "model")           256 ranks
  multi pod:   (2, 16, 16)  -> ("pod", "data", "model")    512 ranks
The "model" axis carries TP/EP (NVLink-bound, inside a node's group);
"data" (+"pod") carry batch/FSDP sharding whose gradient reductions cross
the network between groups.
"""

from __future__ import annotations

import math
from datetime import timedelta


def init_process_group(store_path: str, rank: int, world_size: int, *,
                       backend: str | None = None, timeout_s: float = 60.0):
    """Bring up the default process group on a ``FileStore`` at
    ``store_path`` (no network): ``gloo`` on the CPU, ``nccl`` where CUDA is
    available unless ``backend`` says otherwise.  Under NCCL the rank's
    card is ``cuda:rank % device_count``.  ``timeout_s`` bounds every
    collective, so a stuck one fails instead of hanging."""
    import torch
    import torch.distributed as dist
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if backend == "nccl":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s), **kw)


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """The production mesh over the process group that is up;
    ``device_type`` as ``distributed.sharding.make_mesh`` takes it (by
    default the group's backend decides)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ndev = math.prod(shape)
    have = _world_size()
    if have < ndev:
        raise RuntimeError(
            f"mesh {shape} needs {ndev} ranks, found {have}; start one "
            f"process per rank and call init_process_group first")
    from repro_torch.distributed.sharding import make_mesh
    return make_mesh(shape, axes, device_type=device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2):
    """Small mesh for sharding tests (n_data * n_model ranks, e.g. gloo
    ranks on the CPU)."""
    from repro_torch.distributed.sharding import make_mesh
    return make_mesh((n_data, n_model), ("data", "model"))


# NVIDIA H100 SXM (80 GB HBM3) constants for the roofline model
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor cores, per card
HBM_BW = 3.35e12                # bytes/s per card
NVLINK_BW = 450e9               # bytes/s each way per card (NVLink 4)
HBM_BYTES = 80e9                # device memory per card
CHIPS_PER_POD = 256
