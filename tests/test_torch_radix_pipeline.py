"""The radix scatter's persistent, software-pipelined schedule
(csrc/radix.cu): a resident grid whose blocks take partitions by ticket,
in order, and stage each next partition's records while they rank, look
back and store the current one.

On the CPU: a numpy model of that schedule.  Blocks hold a current and a
prefetched ticket, and publish the prefetched partition's count before
they look back for the current one; tickets are taken in order;
publication, staging completion and look-back steps interleave at
random.  Every partition
finishes (no deadlock), every prefix is exact and the model's counting
pass gives each slot its stable place, also where the prefetched partition
lies past the live prefix and where blocks outnumber partitions; and the
model does detect a deadlock, where a block ranks its prefetched partition
before its current one.  On the card (`cuda` marker, skipped without
one): the kernel bit for bit with `sort_elements_radix_plain` and the
stable `torch.sort` on count 0 and 1, a list shorter than one partition,
exactly the resident grid's partitions and one slot more, garden's
13.06M-of-14.19M list, the permutation, no count (the distributed
`_sort3` form), and two lists sorted back to back on stale scratch.
"""

import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu_torch.core.config import SENTINEL
from vk3dgaussiansplatting_tpu_torch.ops import sort as tsort
from vk3dgaussiansplatting_tpu_torch.ops.cuda import radix_kernel as rk
from vk3dgaussiansplatting_tpu_torch.ops.cuda._build import LAUNCHES
from vk3dgaussiansplatting_tpu_torch.ops.keygen import SortElements

torch.set_num_threads(1)

AGGREGATE, INCLUSIVE = 1 << rk.STATUS_COUNT_BITS, 2 << rk.STATUS_COUNT_BITS
TILES_1080P = 8160


class Deadlock(Exception):
    pass


def run_schedule(digits, tile, blocks, rng, in_order=True):
    """csrc/radix.cu's scatter schedule over `digits` (the live prefix),
    `tile` slots a partition, `blocks` resident blocks, one step at a time
    in a random interleaving.  A block takes a ticket, issues its stage,
    waits for it to land (a random later step), counts the partition and
    publishes its AGGREGATE words (INCLUSIVE for partition 0), then loops:
    it takes the next ticket (a ticket past the prefix is dropped) and
    issues that partition's stage; waits for it to land, counts it and
    publishes its AGGREGATE words; looks back for its current partition, a
    step one word of one bin (a word without a flag is not a step), and
    publishes each bin's INCLUSIVE word as its walk ends; stores; then goes
    on with the next partition, or exits when it has none.
    `in_order=False` makes a block take a second ticket before it counts
    its first partition and work on the second first, counting each
    partition only when it works on it.  Returns each slot's destination,
    the partitions' exclusive prefixes and counts; raises Deadlock when
    nothing can move."""
    n, bins = digits.shape[0], int(digits.max(initial=0)) + 1
    parts = -(-n // tile)
    counts = np.stack([np.bincount(digits[q * tile:(q + 1) * tile], minlength=bins)
                       for q in range(parts)])
    base = np.cumsum(counts.sum(0)) - counts.sum(0)
    status = np.zeros((parts, bins), np.int64)
    excl = np.full((parts, bins), -1, np.int64)
    landed, in_flight = set(), []
    ticket = [0]
    live = []  # blocks: dicts of state, queue (held tickets in working order), walk

    def take(block):
        t = ticket[0]
        ticket[0] += 1
        if t < parts:
            block["queue"].append(t)

    def publish(q):
        status[q] = (INCLUSIVE if q == 0 else AGGREGATE) | counts[q]
        if q == 0:
            excl[0] = 0

    for _ in range(blocks):
        block = {"state": "start", "queue": []}
        take(block)
        if block["queue"]:
            in_flight.append(block["queue"][0])
            live.append(block)

    def look(block):
        cur = block["queue"][0]
        block.update(state="look" if cur else "store", pos=np.full(bins, cur - 1),
                     acc=np.zeros(bins, np.int64), done=np.zeros(bins, bool))

    def ready_bins(block):
        if block["state"] != "look":
            return []
        return [b for b in range(bins) if not block["done"][b]
                and status[block["pos"][b], b] >= AGGREGATE]

    def movable(block):
        state, queue = block["state"], block["queue"]
        if state == "count":
            return queue[0] in landed
        if state == "count next":
            return len(queue) < 2 or queue[1] in landed
        return state in ("start", "issue", "store") or bool(ready_bins(block))

    dest = np.full(n, -1, np.int64)
    for _step in range(50 * parts * (bins + 4) * (parts + blocks)):
        if not live and not in_flight:
            return dest, excl, counts
        moves = [b for b in live if movable(b)] + [None] * len(in_flight)
        if not moves:
            raise Deadlock(f"{int((dest >= 0).sum())} of {n} slots stored")
        block = moves[int(rng.integers(len(moves)))]
        if block is None:
            landed.add(in_flight.pop(int(rng.integers(len(in_flight)))))
            continue
        queue = block["queue"]
        cur = queue[0]
        if block["state"] == "start":
            if not in_order:
                take(block)
                if len(queue) > 1:
                    queue.reverse()
                    in_flight.append(queue[0])
            block["state"] = "count"
        elif block["state"] == "count":
            publish(cur)
            block["state"] = "issue"
        elif block["state"] == "issue":
            if not in_order:
                look(block)
                continue
            take(block)
            if len(queue) > 1:
                in_flight.append(queue[1])
            block["state"] = "count next"
        elif block["state"] == "count next":
            if len(queue) > 1:
                publish(queue[1])
            look(block)
        elif block["state"] == "look":
            ready = ready_bins(block)
            b = ready[int(rng.integers(len(ready)))]
            word = status[block["pos"][b], b]
            block["acc"][b] += word & (AGGREGATE - 1)
            if word >= INCLUSIVE:
                block["done"][b] = True
                excl[cur, b] = block["acc"][b]
                status[cur, b] = INCLUSIVE | (block["acc"][b] + counts[cur, b])
            else:
                block["pos"][b] -= 1
            if block["done"].all():
                block["state"] = "store"
        else:
            lo, hi = cur * tile, min((cur + 1) * tile, n)
            d = digits[lo:hi]
            local = np.empty(hi - lo, np.int64)
            local[np.argsort(d, kind="stable")] = np.arange(hi - lo)
            first = np.cumsum(counts[cur]) - counts[cur]  # each bin's first place in the partition
            dest[lo:hi] = base[d] + excl[cur][d] + local - first[d]
            queue.pop(0)
            if not queue:
                live.remove(block)
            elif in_order:
                block["state"] = "issue"
            else:
                in_flight.append(queue[0])
                block["state"] = "count"
    raise Deadlock("the step budget ran out")


@pytest.mark.parametrize("case", [
    # (slots, partition, blocks): several partitions a block, a ragged last
    # one; every block's last prefetched ticket past the live prefix, the
    # prefix a whole number of partitions; blocks outnumbering partitions
    # (some take a first ticket past the prefix and stage nothing); one block.
    (997, 64, 3), (21 * 16, 16, 7), (5 * 16 + 3, 16, 9), (300, 32, 1),
])
def test_pipelined_schedule_finishes_exact(case):
    """Every partition finishes under a random interleaving of tickets,
    stage landings, publications and look-back steps; each partition's
    prefix is the sum of its predecessors' counts, and the counting pass
    gives every slot its stable place."""
    n, tile, blocks = case
    for seed in range(6):
        rng = np.random.default_rng([n, tile, blocks, seed])
        digits = rng.integers(0, 5, n)
        dest, excl, counts = run_schedule(digits, tile, blocks, rng)
        assert np.array_equal(excl, np.cumsum(counts, 0) - counts)
        want = np.empty(n, np.int64)
        want[np.argsort(digits, kind="stable")] = np.arange(n)
        assert np.array_equal(dest, want), (case, seed)


def test_schedule_model_detects_out_of_order_deadlock():
    """The model is not blind to deadlock: one block that works on its
    second ticket, partition 1, before its first, partition 0, waits on
    partition 0's word forever, and the model says so."""
    digits = np.arange(64) % 3
    with pytest.raises(Deadlock):
        run_schedule(digits, 16, 1, np.random.default_rng(0), in_order=False)
    dest, _, _ = run_schedule(digits, 16, 1, np.random.default_rng(0))
    assert (dest >= 0).all()


def _list(rng, num_tiles, e, live, dead_share=0.0):
    """`live` slots of random (tile, depth), ids in slot order, then
    SENTINEL triples; with `dead_share`, that share of all slots made
    SENTINEL triples (a received list)."""
    cols = [np.full(e, SENTINEL, np.int64) for _ in range(3)]
    cols[0][:live] = rng.integers(0, num_tiles, live)
    cols[1][:live] = rng.integers(0, 1 << 32, live)
    cols[2][:live] = np.arange(live)
    dead = rng.random(e) < dead_share
    for c in cols:
        c[dead] = SENTINEL
    return cols


def _on_card(cols, count):
    t = [torch.from_numpy(c).cuda() for c in cols]
    return SortElements(*t, None if count is None else torch.tensor(count, device="cuda"))


def _check(el, got, num_tiles, with_perm, what):
    """`got` (the kernel's) against the plain version and the stable
    torch.sort, bit for bit."""
    tile = torch.where(el.tile == SENTINEL, num_tiles, el.tile)
    key, perm = torch.sort((tile << 32) | el.depth, stable=True)
    t = key >> 32
    stable = [torch.where(t == num_tiles, SENTINEL, t), key & 0xFFFFFFFF, el.index[perm]]
    plain = tsort.sort_elements_radix_plain(el, num_tiles, with_perm=with_perm)
    plain_cols = [*plain[0][:3], plain[1]] if with_perm else list(plain[:3])
    for name, ref in (("torch.sort", stable + [perm]), ("plain", plain_cols)):
        for col, a, b in zip(("tile", "depth", "index", "permutation"), got, ref):
            assert torch.equal(a, b), f"{what}: {col} differs from {name}"


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the radix sort is a CUDA kernel with no CPU mode")
    rk.check_kernel_config()


@pytest.mark.cuda
def test_pipelined_kernel_edge_lists():
    """Count 0 and 1, a list shorter than one partition, exactly the
    resident grid's partitions and one slot more, and a list with no count
    and sentinels between live slots (`_sort3`'s form), each with and
    without the permutation."""
    _needs_card()
    rng = np.random.default_rng(16)
    full = rk.resident_blocks() * rk.TILE
    cases = {  # what: (e, live, count)
        "count 0": (10_000, 0, 0),
        "count 1": (5000, 1, 1),
        "E = 1": (1, 1, 1),
        "shorter than one partition": (rk.TILE - 1, 3000, 3000),
        "the resident grid's partitions": (full, full, full),
        "one slot more": (full + 1, full + 1, full + 1),
        "no count": (3 * full + 7, 3 * full + 7, None),
    }
    for what, (e, live, count) in cases.items():
        cols = _list(rng, TILES_1080P, e, live, dead_share=0.3 if count is None else 0.0)
        el = _on_card(cols, count)
        before = [x.clone() for x in el[:3]]
        for with_perm in (False, True):
            passes = LAUNCHES["radix_kernels"]
            got = rk.radix_sort(*el[:3], el.count, TILES_1080P, with_perm=with_perm)
            torch.cuda.synchronize()
            assert LAUNCHES["radix_kernels"] - passes == rk.planned_kernels(TILES_1080P, count is not None)
            _check(el, got, TILES_1080P, with_perm, f"{what}, with_perm {with_perm}")
        assert all(torch.equal(a, b) for a, b in zip(before, el[:3])), f"{what}: input written"


@pytest.mark.cuda
def test_pipelined_kernel_garden_list():
    """Garden's list: 13,062,311 live of 14,190,624 slots at 1080p's tile
    count, with and without the permutation."""
    _needs_card()
    rng = np.random.default_rng(17)
    el = _on_card(_list(rng, TILES_1080P, 14_190_624, 13_062_311), 13_062_311)
    for with_perm in (False, True):
        got = rk.radix_sort(*el[:3], el.count, TILES_1080P, with_perm=with_perm)
        torch.cuda.synchronize()
        _check(el, got, TILES_1080P, with_perm, f"garden, with_perm {with_perm}")


@pytest.mark.cuda
def test_pipelined_kernel_back_to_back_stale_scratch():
    """Two different lists sorted alternately, five times each, on one
    stream without a synchronisation between: each sort's scratch is the
    caching allocator's block that held the other list's look-back flags
    and tickets."""
    _needs_card()
    rng = np.random.default_rng(18)
    e = 300 * rk.TILE + 11
    lists = [_on_card(_list(rng, TILES_1080P, e, live), live)
             for live in (e - 5000, 170 * rk.TILE + 3)]
    for with_perm in (False, True):
        outs = [rk.radix_sort(*lists[k % 2][:3], lists[k % 2].count, TILES_1080P,
                              with_perm=with_perm) for k in range(10)]
        torch.cuda.synchronize()
        for k, got in enumerate(outs):
            _check(lists[k % 2], got, TILES_1080P, with_perm, f"sort {k}, with_perm {with_perm}")
