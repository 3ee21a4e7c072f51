"""The communicator: the one place of the port that knows the process group.

Port of `vk3dgaussiansplatting_tpu.parallel.mesh`.  The JAX package lays a
1-D device mesh over every chip and lets `shard_map` place the collectives;
here one process per rank runs the frame (parallel/dist.py) and calls the
three collectives it needs through a `Communicator`:

  all_gather   tiled along dim 0 (`lax.all_gather(..., tiled=True)`)
  all_to_all   dim-0 chunk r goes to rank r (`lax.all_to_all`, one
               `all_to_all_single`)
  ring_shift   receive from rank - 1, send to rank + 1 (`lax.ppermute` with
               the perm i -> i + 1; one `batch_isend_irecv`)

Backends (chosen by the caller, parallel/multihost.py:initialize):
  * NCCL, where each rank owns its GPU: tensors stay on the device.
  * gloo, on the CPU, and for several ranks that share one GPU (NCCL refuses
    two ranks on one device): CUDA tensors are copied through host memory,
    explicitly, inside the collective call, so the frame's `exchange`
    sections time the copies with the transfer.

Nothing catches a failed collective or falls back to another backend.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist


class Communicator:
    """Collectives of the default process group for the tensors of `device`
    (the group must be initialised: parallel/multihost.py:initialize)."""

    def __init__(self, device):
        if not tdist.is_initialized():
            raise RuntimeError("no process group: call parallel.multihost.initialize() first")
        self.device = torch.device(device)
        self.rank = tdist.get_rank()
        self.world = tdist.get_world_size()
        self.backend = tdist.get_backend()
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"the nccl backend needs CUDA tensors, not {self.device}")
        if self.backend not in ("nccl", "gloo"):
            raise ValueError(f"unsupported backend {self.backend!r}")
        # gloo moves host tensors only: CUDA tensors go through host memory.
        self.host_staged = self.backend == "gloo" and self.device.type == "cuda"

    def _send_side(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.host_staged else t.contiguous()

    def _recv_side(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.host_staged else t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (all of one shape), concatenated along dim 0 in
        rank order."""
        src = self._send_side(t)
        parts = [torch.empty_like(src) for _ in range(self.world)]
        tdist.all_gather(parts, src)
        return self._recv_side(torch.cat(parts))

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """`t` [world * m, ...]: rows [r*m, (r+1)*m) go to rank r; returns the
        rows received, from rank 0 first."""
        if t.shape[0] % self.world:
            raise ValueError(f"{t.shape[0]} rows do not split over {self.world} ranks")
        src = self._send_side(t)
        out = torch.empty_like(src)
        tdist.all_to_all_single(out, src)
        return self._recv_side(out)

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """Send `t` to rank + 1 and return what rank - 1 sent (the identity
        at world 1, with no peer; the other two go through the backend at
        every world size)."""
        if self.world == 1:
            return t
        src = self._send_side(t)
        out = torch.empty_like(src)
        ops = [
            tdist.P2POp(tdist.isend, src, (self.rank + 1) % self.world),
            tdist.P2POp(tdist.irecv, out, (self.rank - 1) % self.world),
        ]
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
        return self._recv_side(out)
