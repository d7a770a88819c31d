"""Multi-process runtime on ``torch.distributed`` (port of
lia_ral_tpu/parallel/distributed.py).

The reference scales across machines operationally: users shard NDX file
lists, run one binary per shard, and merge sufficient-statistics
checkpoint files (``loadAccs`` merge,
``LIA_SpkDet/TotalVariability/TotalVariability.cpp:82-90``).  The port
keeps that file-DAG contract and adds a multi-process runtime: a gloo
process group, process-local data loading, and a global mesh on which
the per-shard statistics are summed across processes in global
shard-index order (the merge the reference performs with ``addAccEM``
across pthread accumulators, lifted across processes):

    initialize_from_env()                     # no-op when single-process
    names = shard_file_list(all_names)        # process-local NDX shard
    mesh  = make_global_mesh()                # spans every process's devices
    stats = global_stats(mesh, stats_fn, *host_local_batch(mesh, x, w), gmm)

The backend is gloo: its collectives take host tensors, which the mesh's
collectives gather (kilobytes to megabytes of partial sums), and it runs
several ranks on one card, where NCCL refuses two ranks on one GPU.
"""

from __future__ import annotations

import datetime
import os

import torch

from .mesh import Mesh, visible_devices


def initialize_from_env(coordinator: str | None = None,
                        num_processes: int | None = None,
                        process_id: int | None = None) -> bool:
    """Join the gloo process group.

    Explicit arguments win; otherwise the environment variables
    ``LIA_COORDINATOR`` (``host:port``), ``LIA_NUM_PROCESSES`` and
    ``LIA_PROCESS_ID``; with neither, a single-process no-op that returns
    False.  ``coordinator="auto"`` takes torch's own ``env://`` variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)."""
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("LIA_COORDINATOR")
    if coordinator is None:
        return False
    timeout = datetime.timedelta(minutes=10)
    if coordinator == "auto":
        dist.init_process_group("gloo", init_method="env://",
                                timeout=timeout)
        return True
    num_processes = int(num_processes if num_processes is not None
                        else os.environ["LIA_NUM_PROCESSES"])
    process_id = int(process_id if process_id is not None
                     else os.environ["LIA_PROCESS_ID"])
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group("gloo", init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    return True


def _rank_and_size() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_file_list(names: list[str], process_index: int | None = None,
                    process_count: int | None = None) -> list[str]:
    """The process-local shard of an NDX/file list (round-robin,
    deterministic): the reference's operational sharding of file lists
    made first-class; every process reads only its shard."""
    rank, size = _rank_and_size()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    return [n for i, n in enumerate(names) if i % pc == pi]


def make_global_mesh(n_model: int = 1, devices: list | None = None) -> Mesh:
    """A ("data", "model") mesh over ALL processes' devices, rank-major.
    ``devices``: this process's (default: its visible cards); every
    process must bring as many."""
    import torch.distributed as dist

    local = [torch.device(d) for d in
             (devices if devices is not None else visible_devices("cuda"))]
    rank, size = _rank_and_size()
    if size == 1:
        per_rank = [local]
    else:
        per_rank = [None] * size
        dist.all_gather_object(per_rank, [str(d) for d in local])
        per_rank = [[torch.device(d) for d in devs] for devs in per_rank]
    if len({len(devs) for devs in per_rank}) != 1:
        raise ValueError("every process must bring as many devices: "
                         f"{[len(d) for d in per_rank]}")
    flat = [(r, d) for r, devs in enumerate(per_rank) for d in devs]
    n_data = len(flat) // n_model
    cells = [flat[i * n_model:(i + 1) * n_model] for i in range(n_data)]
    return Mesh([[d for _, d in row] for row in cells],
                ranks=[[r for r, _ in row] for row in cells], rank=rank)


class HostLocalBatch:
    """A process's frames as pieces of a global frame-sharded batch: the
    local (N_local, ·) rows split evenly over this process's "data"
    shards, each piece on its shard's device (no data moves between
    processes)."""

    def __init__(self, mesh: Mesh, arr: torch.Tensor):
        keys = [k for k in mesh.local_keys() if k[1] == 0]
        arr = torch.as_tensor(arr)
        per = arr.shape[0] // len(keys)
        if per * len(keys) != arr.shape[0]:
            raise ValueError(f"{arr.shape[0]} local rows do not split over "
                             f"{len(keys)} local data shards")
        self.pieces = {k[0]: arr[p * per:(p + 1) * per].to(mesh.device_of(k))
                       for p, k in enumerate(keys)}


def host_local_batch(mesh: Mesh, x, w):
    """(x, w) of each process's LOCAL frames as a global frame-sharded
    batch over the mesh's "data" axis: every process passes its own
    (N_local, D) frames and keeps them on its own devices."""
    return HostLocalBatch(mesh, x), HostLocalBatch(mesh, w)


def global_stats(mesh: Mesh, stats_fn, x, w, gmm):
    """All-process sufficient statistics: ``stats_fn(x, w, gmm)`` on each
    shard's frames, summed over the "data" axis across processes — the
    multi-process form of the reference's addAccEM merge
    (AccumulateStat.cpp:289).  ``x``, ``w``: the ``host_local_batch`` of
    this process, or whole tensors (split as ``sharded_em_stats`` does)."""
    from .sharding import sharded_em_stats

    if not isinstance(x, HostLocalBatch):
        return sharded_em_stats(mesh, x, w, gmm, local_fn=stats_fn)

    def body(sh):
        return sh.psum(stats_fn(x.pieces[sh.data].to(sh.device),
                                w.pieces[sh.data].to(sh.device),
                                gmm.to(sh.device)), "data")

    return mesh.replicated(mesh.run(body))
