"""Bitonic merge sort of (tile, depth, index) — the wrapper of csrc/bitonic.cu.

Replaces vk3dgaussiansplatting_tpu/ops/bitonic.py:sort_elements_bitonic (an
XLA function of the JAX package, not a Pallas kernel).  The network runs in
its XOR form (stage (k, j): slot i against i ^ j, ascending where
i & k == 0): one shared-memory pass sorting each block of `BLOCK`
elements, then for each k = 2·BLOCK .. E the global distances k/2 .. BLOCK
in passes of near-equal size, at most `GROUP` to a pass: fewer than
`WIDE_FROM` in registers (2^g slots of one stride a thread), more over
blocks of BLOCK slots strided through the list (runs of 2^(13-g)
consecutive slots, the distances' bits above them); then one shared-memory
pass for the distances below BLOCK.  The first pass runs its 91 stages
(every k <= BLOCK) in one loop over a table of them, in 128 registers, two
blocks an SM as a merge runs (0.905 ms at 2^24 on an H100, PERF.md).
`schedule` is the network's one
schedule: the wrapper walks it (`launches`, each pass's kernel, k, lowest
distance and group: the choice of a register or a wide pass is made there
alone) and launches the passes one by one on the current stream through
the C entry point `vk3d_bitonic_pass`, which maps one pass to its kernel
and holds no schedule of its own.  Each pass sits in a tracing section
(utils/timing.py), nested in the frame's `sort`: `bitonic_shared` for the
first block sort and each merge, `bitonic_global` for each fused global
pass; with `timer=None` they are no-ops.

The columns are int64 tensors holding uint32 values (ops/keygen.py), each
in [0, 2^32); the order is lexicographic on (tile, depth, index).  The
inputs are not written; the outputs are new tensors.  Only CUDA tensors are
taken: ops/bitonic.py runs the plain version for CPU tensors, so this
module never falls back.  `_build.LAUNCHES` counts each pass under its
kernel as "bitonic_<kind>" (`KINDS`: one "bitonic_first" a sort; the
"bitonic_register" and "bitonic_wide" global passes, 13 a sort at 2^24),
and the stages the global passes ran as "bitonic_global_stages" (66 a sort
at 2^24).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ...utils.timing import section
from . import _build

# Elements a block sorts in shared memory (csrc/bitonic.cu's kLogBlock):
# 2^13, 12 B each in 96 KB of dynamic shared memory, 256 threads holding 32
# elements each, two blocks an SM in the first pass and in a merge.
BLOCK = 1 << 13
# Global distances fused into one pass (csrc/bitonic.cu's kGroup, a wide
# pass's most: its runs of 2^(13-g) consecutive slots stay 16 or more).
# Nine take a sort at 2^24 to 25 kernels, 13 of them global (30 and 18 at
# five).
GROUP = 9
# The fewest distances a global pass runs wide; a pass of fewer runs in
# registers (at most five, csrc/bitonic.cu's kRegisterGroup), which the
# card runs faster (PERF.md).
WIDE_FROM = 6


def _halving(hi: int, lo: int) -> list[int]:
    out = []
    while hi >= lo:
        out.append(hi)
        hi //= 2
    return out


def schedule(e: int, block: int = BLOCK,
             group: int = GROUP) -> list[tuple[str, list[tuple[int, int]]]]:
    """The kernels csrc/bitonic.cu launches for `e` elements (a power of
    two), in order: each (kind, its stages (k, j) in order).  Kinds:
    "first" sorts each block of `block` elements from the columns (a lone
    shorter block padded with all-ones triples), "global" fuses distances
    >= block of one k, each k's split into the fewest passes of at most
    `group` and sizes that differ by at most one (11 as 5 + 6), "merge" runs
    the distances below block of one k.  A `block` or `group` other than the
    kernel's serves the numpy model of the passes."""
    if e <= 0:
        return []
    first, k = [], 2
    while k <= block:
        first += [(k, j) for j in _halving(k // 2, 1)]
        k *= 2
    passes = [("first", first)]
    k = 2 * block
    while k <= e:
        dist = _halving(k // 2, block)
        n = -(-len(dist) // group)
        cuts = [len(dist) * i // n for i in range(n + 1)]
        passes += [("global", [(k, j) for j in dist[a:b]]) for a, b in zip(cuts, cuts[1:])]
        passes.append(("merge", [(k, j) for j in _halving(block // 2, 1)]))
        k *= 2
    return passes


def planned_passes(e: int, block: int = BLOCK, group: int = GROUP) -> int:
    """Kernel launches of one sort of `e` elements."""
    return len(schedule(e, block, group))


# vk3d_bitonic_pass's kind codes (a global pass is "register" or "wide"),
# and the tracing section of each kind.
KINDS = {"first": 0, "register": 1, "merge": 2, "wide": 3}
SECTIONS = {"first": "bitonic_shared", "register": "bitonic_global", "wide": "bitonic_global",
            "merge": "bitonic_shared"}
# The launch counter's key of each kind (`_build.LAUNCHES`).
COUNTER_KEYS = {kind: f"bitonic_{kind}" for kind in KINDS}


class Launch(NamedTuple):
    """One pass as the C entry point takes it: its kind (`KINDS`), the k of
    its last stage, the log2 of its last (lowest) distance and its number of
    stages.  The kernel reads `lo_bit` and `group` only for a global pass
    (the distances 2^(lo_bit+group-1) .. 2^lo_bit of k); a first pass runs
    every k up to `k`, a merge the distances below BLOCK."""

    kind: str
    k: int
    lo_bit: int
    group: int


def kernel_kind(kind: str, group: int) -> str:
    """The kernel of a `schedule` pass of `group` stages: a global pass runs
    in registers under `WIDE_FROM` distances, else wide."""
    if kind != "global":
        return kind
    return "register" if group < WIDE_FROM else "wide"


@functools.cache
def launches(e: int) -> tuple[Launch, ...]:
    """`schedule(e)`, pass by pass, as the C entry point's arguments
    (cached: deriving them takes ~0.1 ms of host time a sort at 2^24)."""
    return tuple(Launch(kernel_kind(kind, len(stages)), stages[-1][0],
                        stages[-1][1].bit_length() - 1, len(stages))
                 for kind, stages in schedule(e))


def bitonic_sort(tile: torch.Tensor, depth: torch.Tensor, index: torch.Tensor, timer=None):
    """Sort three [E] int64 CUDA columns (E a power of two) by (tile, depth,
    index); returns the sorted (tile, depth, index), new tensors.  `timer`
    (utils.timing.CudaPassTimer or None) gets a section a pass."""
    e = tile.shape[0]
    for name, x in (("tile", tile), ("depth", depth), ("index", index)):
        if x.dim() != 1 or x.dtype != torch.int64 or x.shape[0] != e:
            raise ValueError(f"{name} must be [{e}] int64, got {tuple(x.shape)} {x.dtype}")
    if e & (e - 1):
        raise ValueError(f"bitonic sort requires a power-of-two length, got {e}")
    dev = _build.card_device(tile, depth, index)
    cols = [x.contiguous() for x in (tile, depth, index)]
    out = [torch.empty_like(x) for x in cols]
    if e == 0:
        return tuple(out)
    keys = torch.empty(e, dtype=torch.int64, device=dev) if e > BLOCK else None
    idx = torch.empty(e, dtype=torch.int32, device=dev) if e > BLOCK else None
    args = (*(x.data_ptr() for x in cols), e, None if keys is None else keys.data_ptr(),
            None if idx is None else idx.data_ptr(), *(x.data_ptr() for x in out))
    passes = launches(e)
    for p in passes:
        with section(timer, SECTIONS[p.kind]):
            _build.launch(COUNTER_KEYS[p.kind], "vk3d_bitonic_pass", KINDS[p.kind], *args, p.k,
                          p.lo_bit, p.group, device=dev)
    _build.LAUNCHES["bitonic_global_stages"] += sum(
        p.group for p in passes if SECTIONS[p.kind] == "bitonic_global")
    return tuple(out)
