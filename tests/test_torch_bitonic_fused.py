"""The bitonic kernel's fused schedule (csrc/bitonic.cu): its index
arithmetic as tests/test_torch_bitonic.py restates it, checked on the CPU,
and the kernel itself on the card.

On the CPU: every global pass's register groups (`slot_groups`) and
strided blocks (`wide_slots`) cover each slot once and hold each of the
pass's pairs inside one thread's row or one block (at the block's top
bits), one direction a row or block; at the kernel's block a wide
block's runs are 2^(13-g) consecutive slots and its layouts those of a
merge's first half; the first pass's one loop walks the schedule's
stages in order (its packed table); every shared-pass layout
(`layout_slots`) is a permutation of the block that holds each of its
stages' pairs inside one row, the re-map's Gray-code walk finds its
swizzled words, and its warp accesses hit 32 distinct banks; partial
groups; E < B, E = B and E = 2B; lists all SENTINEL or half SENTINEL; the
wrapper's guards.  The numpy model of the
passes (`_run_schedule`, tests/test_torch_bitonic.py) equals the plain
version and the stable tier bit for bit.  On the card (`cuda` marker): the
kernel at E = 1 .. 2^12 and at every E = 2^13 .. 2^24 against the stable
torch.sort one-liner (two global passes for a k from 2^23 up), its
launches `planned_passes`, its global passes and stages the schedule's
(13 and 66 at 2^24).
"""

import numpy as np
import pytest
import torch

from test_torch_bitonic import (
    NUM_TILES, PER_THREAD_LOG, _assert_elements_equal, _random_elements, _run_schedule,
    _torch_elements, layout_for, layout_slots, slot_groups, swizzle, wide_slots,
)
from vk3dgaussiansplatting_tpu_torch.core.config import SENTINEL
from vk3dgaussiansplatting_tpu_torch.ops import bitonic as tbit
from vk3dgaussiansplatting_tpu_torch.ops import sort as tsort
from vk3dgaussiansplatting_tpu_torch.ops.cuda import bitonic_kernel as tbk
from vk3dgaussiansplatting_tpu_torch.ops.cuda._build import LAUNCHES

torch.set_num_threads(1)

B = tbk.BLOCK


def _model_matches(tile, depth, idx, block=B, group=tbk.GROUP, what="",
                   wide_from=tbk.WIDE_FROM):
    """The numpy model of the kernel's passes against the plain version and
    the stable tier, bit for bit."""
    el = _torch_elements(tile, depth, idx)
    want = tbit.sort_elements_bitonic_plain(el)
    _assert_elements_equal(want, tsort.sort_elements_xla(el, NUM_TILES), f"{what} plain vs stable")
    got = _run_schedule(tile, depth, idx, block, group, wide_from)
    for name, g in zip(("tile", "depth", "index"), got):
        np.testing.assert_array_equal(g, getattr(want, name).numpy(), f"{what} {name}")


def _layouts(stages, block):
    """The layouts a shared pass runs its stages in, in order, from the
    coalesced one (csrc/bitonic.cu, shared_stage), ending in it again."""
    return _layouts_of_bits([j.bit_length() - 1 for _k, j in stages], block)


def _layouts_of_bits(bits, block):
    """The layouts a pass whose stages run at these block-slot bits goes
    through, as `_layouts`."""
    top = block.bit_length() - 1 - PER_THREAD_LOG
    b, seq = top, [top]
    for x in bits:
        if not b <= x < b + PER_THREAD_LOG:
            b = layout_for(x, block)
            seq.append(b)
    return seq + [top] if b != top else seq


def _first_walk(block):
    """The first pass's stages (log2 k, block-slot bit) as csrc/bitonic.cu's
    one loop walks them: `kFirstStages` (first_stages: log2 k = 1 ..
    log2 block, the bit log2 k - 1 .. 0 for each, packed as lk << 4 | x),
    entry by entry, unpacked as the loop unpacks it."""
    packed = [lk << 4 | x for lk in range(1, block.bit_length())
              for x in range(lk - 1, -1, -1)]
    assert all(v < 256 for v in packed)  # one uint8 each
    return [(v >> 4, v & 15) for v in packed]


def _gray_words(block, b):
    """[threads, 32]: the shared-memory word of each thread's register u in
    layout b as relayout's for_each_word walks them: u in Gray-code order,
    each word the last one XOR swizzle(1 << (b + i)) for the bit i that
    changed, from swizzle(layout_base(t, b))."""
    t = torch.arange(block >> PER_THREAD_LOG, dtype=torch.int64)
    q = swizzle(((t >> b) << (b + PER_THREAD_LOG)) | (t & ((1 << b) - 1)))
    words = torch.empty(t.shape[0], 1 << PER_THREAD_LOG, dtype=torch.int64)
    for g in range(1 << PER_THREAD_LOG):
        if g:
            q = q ^ swizzle(1 << (b + (g & -g).bit_length() - 1))
        words[:, g ^ (g >> 1)] = q
    return words


def test_global_groups_cover_slots_and_hold_pairs():
    """A register pass's groups (`slot_groups`, up to five distances) and a
    wide pass's blocks (`wide_slots`, any group) partition the slots; both
    slots of every pair of every stage lie in one row: a thread's, or a
    block's at the block-slot bits log2(block) - g .. log2(block) - 1 from
    the largest distance down; each row has one direction.  At the
    kernel's block a wide block of g distances starts with 2^(13-g)
    consecutive, aligned list slots (16 or more up to GROUP: half a warp's
    load), and a wide pass of up to five distances runs in the loads'
    layout alone, one of six to nine re-maps to layout top - 5 and back."""
    bl = B.bit_length() - 1
    top = bl - PER_THREAD_LOG
    for block, group, e in ((B, tbk.GROUP, 1 << 22), (B, 5, 1 << 20), (1 << 14, 4, 1 << 20),
                            (64, 3, 1 << 12), (32, 1, 1 << 8)):
        lb = block.bit_length() - 1
        for kind, stages in tbk.schedule(e, block, group):
            if kind != "global":
                continue
            lo, g = stages[-1][1].bit_length() - 1, len(stages)
            rows = {"wide": (wide_slots(e, lo, g, block),
                             [1 << (lb - 1 - s) for s in range(g)])}
            if g <= PER_THREAD_LOG:
                rows["register"] = (slot_groups(e, lo, g), [1 << (g - 1 - s) for s in range(g)])
            for what, (slots, bits) in rows.items():
                assert slots.numel() == e
                assert bool((torch.bincount(slots.reshape(-1), minlength=e) == 1).all()), what
                for (k, j), bit in zip(stages, bits):
                    assert j >= block and k > j
                    partner = slots[:, torch.arange(slots.shape[1]) ^ bit]
                    assert torch.equal(slots ^ j, partner), (what, e, k, j)
                    up = (slots & k) != 0  # one direction a row
                    assert torch.equal(up, up[:, :1].expand_as(up)), (what, e, k, j)
            if (block, group) == (B, tbk.GROUP):
                run = 1 << (bl - g)
                assert run >= 16
                head = rows["wide"][0][:, :run]
                assert torch.equal(head - head[:, :1], torch.arange(run).expand_as(head))
                assert bool((head[:, 0] % run == 0).all())
                want = [top] if g <= PER_THREAD_LOG else [top, top - PER_THREAD_LOG, top]
                assert _layouts_of_bits(range(bl - 1, bl - 1 - g, -1), B) == want, g


@pytest.mark.parametrize("block", [1 << 12, B])
def test_shared_layouts_hold_pairs_without_bank_conflicts(block):
    top = block.bit_length() - 1 - PER_THREAD_LOG
    first, merge = tbk.schedule(2 * block, block)[0], tbk.schedule(2 * block, block)[-1]
    assert (first[0], merge[0]) == ("first", "merge")
    # A merge runs in layouts top, top - 5, 0 and stores from top again.
    assert _layouts(merge[1], block) == [top, top - 5, 0, top]
    # The first pass's table walks the schedule's stages in its order; at
    # B, 91 stages and 23 re-maps.
    walk = _first_walk(block)
    assert walk == [(k.bit_length() - 1, j.bit_length() - 1) for k, j in first[1]]
    seq = _layouts_of_bits([x for _lk, x in walk], block)
    if block == B:
        assert (len(walk), len(seq) - 1) == (91, 23)
    used = set(seq)
    assert used == {top, top - 5, 0}
    lane = torch.arange(32)
    for b in used:
        slots = layout_slots(block, b)
        assert torch.equal(torch.sort(slots.reshape(-1)).values, torch.arange(block))
        for x in range(b, min(b + PER_THREAD_LOG, block.bit_length() - 1)):
            partner = slots[:, torch.arange(32) ^ (1 << (x - b))]
            assert torch.equal(slots ^ (1 << x), partner), (b, x)
        words = swizzle(slots)
        assert torch.equal(_gray_words(block, b), words), f"the Gray walk in layout {b}"
        assert torch.equal(torch.sort(words.reshape(-1)).values, torch.arange(block))
        banks = (words % 32).reshape(-1, 32, 32).transpose(1, 2)  # [warp, register, lane]
        assert torch.equal(torch.sort(banks, dim=-1).values,
                           lane.expand_as(banks)), f"bank conflict in layout {b}"


def test_partial_groups():
    """Each k's global distances split into the fewest groups of at most
    `group`, their sizes differing by at most one (11 as 5 + 6 at nine);
    the model sorts random lists with ~30% SENTINEL slots and repeated
    (tile, depth) pairs through every group size 1 .. GROUP, split groups
    included: at block 32 up to five distances, every pass wide or in
    registers, then at block 2^group (runs of one slot) wide from six."""
    for block, group, want_sizes, want_groups in (
            (B, 9, [1, 2, 3, 4, 5, 6, 7, 8, 9, 5, 5, 5, 6], [1] * 9 + [2, 2]),
            (B, 8, [1, 2, 3, 4, 5, 6, 7, 8, 4, 5, 5, 5, 5, 6], [1] * 8 + [2, 2, 2]),
            (B, 5, [1, 2, 3, 4, 5, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 3, 4, 4],
             [1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3]),
            (1 << 14, 4, [1, 2, 3, 4, 2, 3, 3, 3, 3, 4, 4, 4, 3, 3, 3, 3, 3, 4],
             [1, 1, 1, 1, 2, 2, 2, 2, 3, 3])):
        passes = tbk.schedule(1 << 24, block, group)
        assert [len(st) for kind, st in passes if kind == "global"] == want_sizes
        groups, count = [], 0  # global passes of each k = 2B .. 2^24
        for kind, _st in passes[1:]:
            if kind == "global":
                count += 1
            else:
                groups.append(count)
                count = 0
        assert groups == want_groups
        assert tbk.planned_passes(1 << 24, block, group) == 1 + sum(want_groups) + len(groups)
    rng = np.random.default_rng(8)
    for group in range(1, tbk.GROUP + 1):
        if group <= PER_THREAD_LOG:
            cases = [(32, e, w) for e in (1 << 8, 1 << 11) for w in (1, tbk.WIDE_FROM)]
        else:
            cases = [(1 << group, 1 << (2 * group + 1), tbk.WIDE_FROM)]
        for block, e, wide_from in cases:
            _model_matches(*_random_elements(rng, e), block=block, group=group,
                           wide_from=wide_from, what=f"group {group} block {block} E={e} "
                           f"wide from {wide_from}")


def test_sizes_around_block():
    """E < B (one block padded with all-ones triples), E = B and E = 2B at
    the real block: one pass up to B, three at 2B."""
    assert [tbk.planned_passes(e) for e in (1, 2, B // 2, B, 2 * B)] == [1, 1, 1, 1, 3]
    assert [kind for kind, _ in tbk.schedule(2 * B)] == ["first", "global", "merge"]
    rng = np.random.default_rng(9)
    for e in (1, 2, 32, B // 2, B, 2 * B):
        _model_matches(*_random_elements(rng, e), what=f"E={e}")


@pytest.mark.parametrize("share", [1.0, 0.5])
def test_sentinel_lists(share):
    """All SENTINEL, or half (the padding's equal): the model at 2B equals
    the plain version and the stable tier."""
    rng = np.random.default_rng(10)
    tile, depth, idx = _random_elements(rng, 2 * B)
    dead = rng.permutation(2 * B) < share * 2 * B
    for col in (tile, depth, idx):
        col[dead] = SENTINEL
    _model_matches(tile, depth, idx, what=f"SENTINEL share {share}")


def test_wrapper_guards():
    cols = [torch.zeros(8, dtype=torch.int64) for _ in range(3)]
    for bad in (cols[1].int(), cols[1][:4], cols[1].reshape(2, 4)):
        with pytest.raises(ValueError, match=r"depth must be \[8\] int64"):
            tbk.bitonic_sort(cols[0], bad, cols[2])
    with pytest.raises(ValueError, match="unsupported device"):
        tbk.bitonic_sort(*cols)
    with pytest.raises(ValueError, match="power-of-two"):
        tbk.bitonic_sort(*(c[:6] for c in cols))


def _stable_torch_sort(el):
    """The stable torch.sort one-liner on the (tile, depth) key, SENTINEL
    tiles last: the (tile, depth, index) order, ids ascending in slot order
    within a pair in `_random_elements`' lists."""
    tile = torch.where(el.tile == SENTINEL, NUM_TILES, el.tile)
    key, perm = torch.sort((tile << 32) | el.depth, stable=True)
    return type(el)(torch.where(key >> 32 == NUM_TILES, SENTINEL, key >> 32), key & 0xFFFFFFFF,
                    el.index[perm], el.count)


@pytest.mark.cuda
def test_fused_kernel_on_cuda():
    """E = 1 .. 2^12 and every E = 2^13 .. 2^24: the kernel equals the
    stable torch.sort, the radix sort and the plain version bit for bit and
    leaves its input as it was; its kernels, global passes and global
    stages are the schedule's (13 and 66 at 2^24, two passes for each k
    from 2^23 up, wide passes of six to nine distances from 2^19 up)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the bitonic sort is a CUDA kernel with no CPU mode")
    rng = np.random.default_rng(11)
    for e in [1, 2, 1 << 7, 1 << 12] + [1 << x for x in range(13, 25)]:
        el = _torch_elements(*_random_elements(rng, e), device="cuda")
        before = [x.clone() for x in el[:3]]
        want = _stable_torch_sort(el)
        _assert_elements_equal(tsort.sort_elements_xla(el, NUM_TILES), want, f"E={e} radix")
        _assert_elements_equal(tbit.sort_elements_bitonic_plain(el), want, f"E={e} plain")
        counts = LAUNCHES.copy()
        got = tbk.bitonic_sort(*el[:3])
        torch.cuda.synchronize()
        glob = [st for kind, st in tbk.schedule(e) if kind == "global"]
        n = LAUNCHES - counts
        assert (n["bitonic_first"], sum(n[k] for k in tbk.COUNTER_KEYS.values()),
                n["bitonic_register"] + n["bitonic_wide"], n["bitonic_global_stages"]) == (
                    1, tbk.planned_passes(e), len(glob), sum(map(len, glob))), e
        if e == 1 << 24:
            assert (len(glob), sum(map(len, glob))) == (13, 66)
        _assert_elements_equal(type(el)(*got, el.count), want, f"E={e}")
        assert all(torch.equal(a, b) for a, b in zip(before, el[:3])), f"E={e}: input written"
        del el, before, want, got
