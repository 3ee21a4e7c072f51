"""Process-group set-up and process-level helpers.

Port of `vk3dgaussiansplatting_tpu.parallel.multihost`.  JAX's
`jax.distributed.initialize` discovers a TPU pod by itself; nothing on a GPU
host tells a program of a cluster, so `initialize` takes the backend, the
rendezvous address, the rank and the world size from its caller, always.
`launch` starts one process per rank on this host (torch.multiprocessing,
spawn), the way tests and `chip_smoke.py` run the distributed frame.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

BACKENDS = ("nccl", "gloo")


def initialize(backend: str, init_method: str, rank: int, world: int) -> None:
    """`init_process_group` with every argument explicit.

    backend: "nccl" (each rank owns a GPU) or "gloo" (CPU tensors, or ranks
    sharing one GPU through host memory: parallel/mesh.py).  init_method:
    e.g. "tcp://localhost:<port>" or "file://<path>"."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be given explicitly as one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs a CUDA device")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is outside world {world}")
    tdist.init_process_group(backend=backend, init_method=init_method, rank=rank, world_size=world)


def is_multi_process() -> bool:
    return tdist.is_initialized() and tdist.get_world_size() > 1


def process_info() -> dict:
    """This process's place in the group (JAX's process_info)."""
    init = tdist.is_initialized()
    return {
        "process_index": tdist.get_rank() if init else 0,
        "process_count": tdist.get_world_size() if init else 1,
        "backend": tdist.get_backend() if init else None,
        "local_devices": torch.cuda.device_count() if torch.cuda.is_available() else 0,
    }


def assert_group_spans_processes(comm) -> None:
    """Every rank of the group answers once, in rank order (JAX's
    assert_mesh_spans_processes)."""
    ranks = comm.all_gather(torch.tensor([comm.rank], device=comm.device)).tolist()
    if ranks != list(range(comm.world)):
        raise ValueError(f"group ranks {ranks} != 0..{comm.world - 1}")


def _rank_main(rank, fn, backend, init_method, world, args):
    initialize(backend, init_method, rank, world)
    try:
        fn(rank, world, *args)
    finally:
        tdist.destroy_process_group()


def launch(fn, world: int, *, backend: str, init_method: str, args: tuple = ()) -> None:
    """Run `fn(rank, world, *args)` in `world` spawned processes, each in the
    process group (`initialize`); returns once all have ended.  A rank that
    raises ends the others and raises here (torch.multiprocessing's
    ProcessRaisedException); nothing catches it.  `fn` must be importable by
    the spawned processes (defined at a module's top level)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be given explicitly as one of {BACKENDS}, got {backend!r}")
    mp.start_processes(
        _rank_main,
        args=(fn, backend, init_method, world, args),
        nprocs=world,
        join=True,
        start_method="spawn",
    )
