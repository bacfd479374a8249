"""Multi-process runtime over ``torch.distributed`` (port of the JAX
package's parallel/multihost.py).

The layout is the JAX package's: dp (independent squares) spans processes,
whose combine is a gather of small results, and sp (the rows of one
square) stays inside a process, where its collectives are device copies
(``parallel``). Each process contributes its own devices as a local
(dp, sp) mesh (``process_mesh``); the global dp axis is process-major,
``process_count`` × the local dp, so an sp row never crosses a process.

Backends: NCCL where the process's devices are CUDA, gloo on the CPU. The
runtime never picks gloo for CUDA devices on its own: a caller that wants
gloo there (two processes on one card, which NCCL refuses) names it, and
``gather_to_hosts`` then gathers host copies, gloo's transport. A process
group is formed from ``tcp://coordinator``, its world size and its rank;
nothing is read from a cluster's environment.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from celestia_tpu_torch import device as device_mod
from celestia_tpu_torch import parallel

_LOCAL_DEVICES: list[torch.device] = []


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str | None = None, local_devices=None) -> None:
    """Join (or form) the process group at ``tcp://coordinator``
    ("host:port"). ``local_devices`` are the devices this process
    contributes (every CUDA device by default; None raises without one);
    ``backend`` None is NCCL for CUDA devices and gloo for the CPU."""
    if local_devices is None:
        device_mod.resolve(None)  # raises without a card
        local_devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in local_devices]
    if not devices:
        raise ValueError("a process contributes at least one device")
    kinds = {d.type for d in devices}
    if len(kinds) != 1:
        raise ValueError(f"a process's devices are of one kind, got {sorted(kinds)}")
    cuda = kinds == {"cuda"}
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if backend == "nccl":
        if not cuda:
            raise ValueError("NCCL runs on CUDA devices; name gloo for the CPU")
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL; pass backend='gloo' to run "
                               "over gloo")
        torch.cuda.set_device(devices[0])
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    _LOCAL_DEVICES[:] = devices


def shutdown() -> None:
    """Leave the process group."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL_DEVICES.clear()


def process_mesh(sp: int = 1) -> parallel.Mesh:
    """This process's (dp_local, sp) mesh over its own devices, dp_local =
    local devices // sp, placed in the global mesh by its
    ``process_index`` and ``process_count``. sp must divide the local device
    count: sp is the in-process axis."""
    if not dist.is_initialized():
        raise RuntimeError("call multihost.initialize first")
    local = len(_LOCAL_DEVICES)
    if local % sp != 0:
        raise ValueError(f"sp={sp} must divide the local device count {local} "
                         "(sp is the in-process axis)")
    return parallel.Mesh(parallel.device_array(_LOCAL_DEVICES, (local // sp, sp)),
                         process_index=dist.get_rank(), process_count=dist.get_world_size())


def distributed_extend_and_root(mesh: parallel.Mesh, k: int):
    """The batched extend of this process's slice of the dp axis on its
    mesh: ``parallel.sharded_extend_and_root`` (row work and the sp
    collectives inside the process; the dp combine is ``gather_to_hosts``)."""
    return parallel.sharded_extend_and_root(mesh, k)


def shard_batch_from_host(local_batch, mesh: parallel.Mesh) -> parallel.ShardedBatch:
    """Stage this process's slice of the global batch (the squares of its
    dp rows) onto its mesh."""
    return parallel.shard_batch(local_batch, mesh, site="multihost.batch")


def gather_to_hosts(local: torch.Tensor, mesh: parallel.Mesh | None = None) -> np.ndarray:
    """Every process's (B_local, ...) result, concatenated in rank order on
    every process: ``all_gather_into_tensor`` over the world group (the
    DAHs, which every node needs). Over NCCL the gather runs on the card;
    over gloo on host copies. ``mesh`` is taken as the JAX package's
    signature takes it; the world group already spans every process."""
    if not dist.is_initialized():
        raise RuntimeError("call multihost.initialize first")
    on_card = dist.get_backend() == "nccl"
    src = (local if on_card else local.cpu()).contiguous()
    out = torch.empty((dist.get_world_size() * src.shape[0], *src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src)
    return out.cpu().numpy()
