"""Multi-process execution over ``torch.distributed`` (counterpart of
``nsol_tpu/parallel/distributed.py``).

JAX runs one process over a mesh of devices; the PyTorch idiom is one
process per GPU, each holding its own z-slab of the volume, with the
collectives (NCCL on the card, gloo on the CPU) outside the kernels. Three
pieces, as in the reference:

1. :func:`initialize` — ``torch.distributed.init_process_group``, a no-op
   for one process with no address, so the same program runs unchanged on
   one GPU.
2. :func:`global_array_from_process_local` — this rank's block as a tensor
   on the mesh's device: no rank ever holds the whole volume.
3. :func:`process_local_slice` (which rows of the global volume this rank
   reads or generates) and :func:`process_local_data` (this rank's rows of
   a result, as numpy).

Launch recipe (every rank runs the same script)::

    # torchrun --nproc-per-node N script.py
    from nsol_tpu_torch.parallel import distributed as dist
    from nsol_tpu_torch.parallel import make_space_mesh, sharded_tv_admm_solve
    dist.initialize()            # env:// as torchrun sets it; or pass
                                 # coordinator_address="host:port",
                                 # num_processes, process_id
    mesh = make_space_mesh()     # one "space" rank per process
    rows = dist.process_local_slice(GLOBAL_SHAPE, mesh)
    b_local = read_my_rows(path, rows)          # process-local I/O
    x = sharded_tv_admm_solve(mesh, cov, b_local, b_local.copy(),
                              alpha, rho, process_local=True)
    x_local = dist.process_local_data(x)        # this rank's result rows

Each rank takes ``cuda:(LOCAL_RANK % device_count)``; one card holds one
rank (NCCL refuses two ranks on one GPU).
"""

import os

import numpy as np
import torch
import torch.distributed as tdist

__all__ = [
    "initialize", "is_multiprocess", "global_array_from_process_local",
    "process_local_slice", "process_local_data", "local_rank",
]


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, device="cuda"):
    """Join the process group; a no-op for one process with no address
    and when a group exists already.

    With ``coordinator_address`` (``"host:port"``) the group meets at
    ``tcp://host:port`` with ``num_processes`` ranks, this one
    ``process_id``; without it, at ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them).
    The backend is NCCL for ``device="cuda"`` (this rank's card is made
    current) and gloo for ``device="cpu"``.
    """
    if tdist.is_initialized():
        return
    if num_processes == 1 and coordinator_address is None:
        return
    dev = torch.device(device)
    if coordinator_address is not None:
        kwargs = dict(init_method="tcp://%s" % coordinator_address,
                      world_size=int(num_processes), rank=int(process_id))
    else:
        kwargs = dict(init_method="env://")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda'): torch sees no "
                               "CUDA device; pass device='cpu' for gloo")
        rank = process_id if process_id is not None \
            else int(os.environ.get("RANK", 0))
        torch.cuda.set_device(local_rank(rank) % torch.cuda.device_count())
    tdist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo", **kwargs)


def local_rank(rank=None):
    """This process's rank on its host: ``LOCAL_RANK`` where the launcher
    sets it, else the global rank (one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if rank is not None:
        return int(rank)
    return tdist.get_rank() if tdist.is_initialized() else 0


def is_multiprocess():
    return tdist.is_initialized() and tdist.get_world_size() > 1


def global_array_from_process_local(mesh, local_block, axis_name="space",
                                    leading_axis=0):
    """This rank's block (its rows along ``leading_axis`` of the volume
    sharded over ``axis_name``) as a contiguous tensor on the mesh's
    device, in its own dtype. On one rank the block is the whole volume —
    the same call, degenerate case."""
    _check_axis(mesh, axis_name)
    t = local_block if isinstance(local_block, torch.Tensor) \
        else torch.as_tensor(np.asarray(local_block))
    return t.to(mesh.device).contiguous()


def process_local_slice(global_shape, mesh, axis_name="space",
                        leading_axis=0):
    """Half-open row range ``(start, stop)`` along ``leading_axis`` of the
    global volume that THIS rank holds when the volume is sharded over
    ``axis_name``: rank ``k`` of ``n`` holds rows ``[k·Z/n, (k+1)·Z/n)``.
    ``ValueError`` unless the axis divides evenly."""
    _check_axis(mesh, axis_name)
    n_shards = mesh.shape[axis_name]
    n_rows = int(global_shape[leading_axis])
    if n_rows % n_shards:
        raise ValueError("leading axis %d not divisible by %d shards"
                         % (n_rows, n_shards))
    per = n_rows // n_shards
    return (mesh.rank * per, (mesh.rank + 1) * per)


def process_local_data(x, leading_axis=0):
    """This rank's rows of a sharded result (what the sharded solves
    return: the rank's block along ``leading_axis`` as it is), as a numpy
    array — the read-back half of the process-local I/O contract."""
    return x.detach().cpu().numpy()


def _check_axis(mesh, axis_name):
    if axis_name not in mesh.shape:
        raise ValueError("mesh has no axis %r (axes %s)"
                         % (axis_name, tuple(mesh.shape)))
