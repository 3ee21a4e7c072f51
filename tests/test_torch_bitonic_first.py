"""The bitonic kernel's first pass alone on the card (csrc/bitonic.cu,
`bitonic_shared_kernel<true, *>`: each block of min(E, B) slots sorted
through every k <= B in one loop over its table of stages, two blocks an
SM).  One card test (`cuda` marker, skipped without a card): its output
against the plain version's sorted blocks, on blocks of every kind, the
lone block with its padding, and its input left as it was.  A file of its
own, without JAX: tests/test_torch_bitonic.py stays at nine tests
(ROADMAP.md, "Port tests").
"""

import pytest
import torch

from vk3dgaussiansplatting_tpu_torch.core.config import SENTINEL
from vk3dgaussiansplatting_tpu_torch.ops import bitonic as tbit
from vk3dgaussiansplatting_tpu_torch.ops import keygen as tkg
from vk3dgaussiansplatting_tpu_torch.ops.cuda import _build
from vk3dgaussiansplatting_tpu_torch.ops.cuda import bitonic_kernel as tbk

torch.set_num_threads(1)

NUM_TILES = 100


def _first_pass_input(e, r, gen):
    """[E] int64 (tile, depth, index) on the card, block by block (blocks of
    min(E, B) slots): block b of kind (b + r) % 5, random triples with ~30%
    SENTINEL, all SENTINEL, (tile, depth) repeating over 4 x 4 values with
    distinct indices, reversed, or already sorted."""
    n = min(e, tbk.BLOCK)
    nb = e // n
    dev = "cuda"
    kind = (torch.arange(nb, device=dev)[:, None] + r) % 5

    def rnd(hi):
        return torch.randint(0, hi, (nb, n), device=dev, generator=gen)

    sentinel = torch.full((nb, n), SENTINEL, dtype=torch.int64, device=dev)
    dead = torch.rand((nb, n), device=dev, generator=gen) < 0.3
    tile = torch.where(dead, sentinel, rnd(NUM_TILES))
    depth = torch.where(dead, sentinel, rnd(1 << 20))
    index = torch.where(dead, sentinel, rnd(1 << 32))
    tile, depth, index = (torch.where(kind == 1, sentinel, x) for x in (tile, depth, index))
    perm = torch.rand((nb, n), device=dev, generator=gen).argsort(dim=1)
    distinct = (torch.arange(nb, device=dev)[:, None] * n) | perm
    tile = torch.where(kind == 2, rnd(4), tile)
    depth = torch.where(kind == 2, rnd(4), depth)
    index = torch.where(kind == 2, distinct, index)
    p = torch.arange(n, device=dev).expand(nb, n)
    for k, q in ((3, n - 1 - p), (4, p)):  # reversed, sorted: (tile, depth) by q
        tile = torch.where(kind == k, q >> 10, tile)
        depth = torch.where(kind == k, q & 1023, depth)
    return [x.reshape(-1).contiguous() for x in (tile, depth, index)]


@pytest.mark.cuda
def test_first_pass_alone_on_cuda():
    """`vk3d_bitonic_pass` kind 0 alone (the first block sort, every k <= B):
    at E = 2^13, 2^14, 2^20 and 2^24 its scratch (E > B) or output (E = B)
    holds each block of B slots sorted, ascending in even blocks and
    descending in odd ones, equal to the plain version's sort of each block
    (the block index above the tile, so one plain sort sorts every block
    apart); at E = 1 .. 2^12 the lone block with its all-ones padding sorts
    into its E output slots and writes none past them.  Blocks of every
    kind of `_first_pass_input`; the input is left as it was."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the bitonic sort is a CUDA kernel with no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(21)
    marker = -7
    for e in [1 << x for x in range(13)] + [1 << 13, 1 << 14, 1 << 20, 1 << 24]:
        n = min(e, tbk.BLOCK)
        for r in range(5) if e <= 2 * tbk.BLOCK else (0,):
            cols = _first_pass_input(e, r, gen)
            before = [x.clone() for x in cols]
            blk = torch.arange(e, device="cuda") // n
            want = tbit.sort_elements_bitonic_plain(tkg.SortElements(
                (blk << 32) | cols[0], cols[1], cols[2], torch.tensor(e)))
            want = [x.reshape(-1, n) & 0xFFFFFFFF for x in want[:3]]
            for x in want:
                x[1::2] = x[1::2].flip(1)  # k = B descends in odd blocks
            first = tbk.launches(e)[0]
            assert first.kind == "first"
            if e > tbk.BLOCK:
                keys = torch.empty(e, dtype=torch.int64, device="cuda")
                idx = torch.empty(e, dtype=torch.int32, device="cuda")
                out = [None] * 3
            else:
                keys = idx = None
                out = [torch.full((tbk.BLOCK,), marker, dtype=torch.int64, device="cuda")
                       for _ in range(3)]
            ptr = [None if x is None else x.data_ptr() for x in (keys, idx, *out)]
            _build.launch("bitonic_first", "vk3d_bitonic_pass", tbk.KINDS["first"],
                          *(x.data_ptr() for x in cols), e, *ptr, first.k, first.lo_bit,
                          first.group, device=cols[0].device)
            torch.cuda.synchronize()
            if e > tbk.BLOCK:
                got = [(keys >> 32) & 0xFFFFFFFF, keys & 0xFFFFFFFF,
                       idx.to(torch.int64) & 0xFFFFFFFF]
            else:
                got = [x[:e] for x in out]
                assert all(bool((x[e:] == marker).all()) for x in out), f"E={e}: padding stored"
            for name, g, w in zip(("tile", "depth", "index"), got, want):
                assert torch.equal(g.reshape(-1, n), w), (
                    f"E={e} r={r}: {name} differs at {int((g.reshape(-1, n) != w).sum())}")
            assert all(torch.equal(a, b) for a, b in zip(before, cols)), f"E={e}: input written"
            del cols, before, want, keys, idx, out
