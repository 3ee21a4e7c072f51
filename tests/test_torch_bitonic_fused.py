"""The bitonic kernel's fused schedule (csrc/bitonic.cu): its index
arithmetic as tests/test_torch_bitonic.py restates it, checked on the CPU,
and the kernel itself on the card.

On the CPU: every global pass's register groups (`slot_groups`) cover each
slot once and hold each of the pass's pairs inside one thread's row; every
shared-pass layout (`layout_slots`) is a permutation of the block that holds
each of its stages' pairs inside one row, and its swizzled warp accesses
hit 32 distinct banks; partial groups; E < B, E = B and E = 2B; lists all
SENTINEL or half SENTINEL; the wrapper's guards.  The numpy model of the
passes (`_run_schedule`, tests/test_torch_bitonic.py) equals the plain
version and the stable tier bit for bit.  On the card (`cuda` marker): the
kernel at E = 1 .. 2^24 against both (partial groups at 2^19 and 2^20), its
launches `planned_passes`.
"""

import numpy as np
import pytest
import torch

from test_torch_bitonic import (
    NUM_TILES, PER_THREAD_LOG, _assert_elements_equal, _random_elements, _run_schedule,
    _torch_elements, layout_for, layout_slots, slot_groups, swizzle,
)
from vk3dgaussiansplatting_tpu_torch.core.config import SENTINEL
from vk3dgaussiansplatting_tpu_torch.ops import bitonic as tbit
from vk3dgaussiansplatting_tpu_torch.ops import sort as tsort
from vk3dgaussiansplatting_tpu_torch.ops.cuda import bitonic_kernel as tbk

torch.set_num_threads(1)

B = tbk.BLOCK


def _model_matches(tile, depth, idx, block=B, group=tbk.GROUP, what=""):
    """The numpy model of the kernel's passes against the plain version and
    the stable tier, bit for bit."""
    el = _torch_elements(tile, depth, idx)
    want = tbit.sort_elements_bitonic_plain(el)
    _assert_elements_equal(want, tsort.sort_elements_xla(el, NUM_TILES), f"{what} plain vs stable")
    got = _run_schedule(tile, depth, idx, block, group)
    for name, g in zip(("tile", "depth", "index"), got):
        np.testing.assert_array_equal(g, getattr(want, name).numpy(), f"{what} {name}")


def _layouts(stages, block):
    """The layouts a shared pass runs its stages in, in order, from the
    coalesced one (csrc/bitonic.cu, shared_stage), ending in it again."""
    top = block.bit_length() - 1 - PER_THREAD_LOG
    b, seq = top, [top]
    for _k, j in stages:
        x = j.bit_length() - 1
        if not b <= x < b + PER_THREAD_LOG:
            b = layout_for(x, block)
            seq.append(b)
    return seq + [top] if b != top else seq


def test_global_groups_cover_slots_and_hold_pairs():
    for block, group, e in ((B, 4, 1 << 20), (B, 5, 1 << 20), (1 << 14, 4, 1 << 20),
                            (64, 3, 1 << 12)):
        for kind, stages in tbk.schedule(e, block, group):
            if kind != "global":
                continue
            lo, g = stages[-1][1].bit_length() - 1, len(stages)
            slots = slot_groups(e, lo, g)
            assert tuple(slots.shape) == (e >> g, 1 << g)
            assert bool((torch.bincount(slots.reshape(-1), minlength=e) == 1).all())
            for k, j in stages:
                assert j >= block and k > j
                m = (j.bit_length() - 1) - lo
                partner = slots[:, torch.arange(1 << g) ^ (1 << m)]
                assert torch.equal(slots ^ j, partner), (e, k, j)
                bit = (slots & k) != 0  # one direction a thread
                assert torch.equal(bit, bit[:, :1].expand_as(bit))


@pytest.mark.parametrize("block", [1 << 12, B])
def test_shared_layouts_hold_pairs_without_bank_conflicts(block):
    top = block.bit_length() - 1 - PER_THREAD_LOG
    first, merge = tbk.schedule(2 * block, block)[0], tbk.schedule(2 * block, block)[-1]
    assert (first[0], merge[0]) == ("first", "merge")
    # A merge runs in layouts top, top - 5, 0 and stores from top again.
    assert _layouts(merge[1], block) == [top, top - 5, 0, top]
    used = set(_layouts(first[1], block))
    assert used == {top, top - 5, 0}
    lane = torch.arange(32)
    for b in used:
        slots = layout_slots(block, b)
        assert torch.equal(torch.sort(slots.reshape(-1)).values, torch.arange(block))
        for x in range(b, min(b + PER_THREAD_LOG, block.bit_length() - 1)):
            partner = slots[:, torch.arange(32) ^ (1 << (x - b))]
            assert torch.equal(slots ^ (1 << x), partner), (b, x)
        words = swizzle(slots)
        assert torch.equal(torch.sort(words.reshape(-1)).values, torch.arange(block))
        banks = (words % 32).reshape(-1, 32, 32).transpose(1, 2)  # [warp, register, lane]
        assert torch.equal(torch.sort(banks, dim=-1).values,
                           lane.expand_as(banks)), f"bank conflict in layout {b}"


def test_partial_groups():
    """Each k's global distances split into groups of `group` from the
    largest, the last group partial; the model sorts through every group
    size 1 .. GROUP."""
    for block, group, want_sizes, want_groups in (
            (B, 5, [1, 2, 3, 4, 5, 5, 1, 5, 2, 5, 3, 5, 4, 5, 5, 5, 5, 1],
             [1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3]),
            (1 << 14, 4, [1, 2, 3, 4, 4, 1, 4, 2, 4, 3, 4, 4, 4, 4, 1, 4, 4, 2],
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
        for e in (1 << 8, 1 << 11):
            _model_matches(*_random_elements(rng, e), block=32, group=group,
                           what=f"group {group} E={e}")


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


@pytest.mark.cuda
def test_fused_kernel_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the bitonic sort is a CUDA kernel with no CPU mode")
    rng = np.random.default_rng(11)
    sizes = sorted({1, 2, B // 2, B, 2 * B, 1 << (B.bit_length() - 1 + tbk.GROUP + 1), 1 << 20,
                    1 << 24})
    for e in sizes:
        el = _torch_elements(*_random_elements(rng, e), device="cuda")
        before = [x.clone() for x in el[:3]]
        want = tsort.sort_elements_xla(el, NUM_TILES)
        _assert_elements_equal(tbit.sort_elements_bitonic_plain(el), want, f"E={e} plain")
        launches, passes = tbk.LAUNCHES, tbk.PASSES
        got = tbk.bitonic_sort(*el[:3])
        torch.cuda.synchronize()
        assert tbk.LAUNCHES == launches + 1
        assert tbk.PASSES - passes == tbk.planned_passes(e), e
        _assert_elements_equal(type(el)(*got, el.count), want, f"E={e}")
        assert all(torch.equal(a, b) for a, b in zip(before, el[:3])), f"E={e}: input written"
