"""bitonic_roofline_pct: the bitonic network's least time over its passes'
time a frame (the `bitonic_shared` and `bitonic_global` sections).

The least time is counted on the window's mean live elements L alone,
never on the schedule's passes or the padded slots past L, so a schedule
that fuses more stages or skips the sentinel tail cannot read over 100%.
It is the larger of (work.least_ms):

  * bytes: the live elements read once and written once, at
    work.ELEMENT_BYTES each (work.sort_least_ms's count);
  * compare-exchanges: any bitonic network that sorts L elements runs
    log2 L · (log2 L + 1) / 2 stages of L / 2 compare-exchanges
    (`compare_exchanges`), each at least OPS_PER_EXCHANGE 32-bit integer
    operations.

A compare-exchange of two 12-byte (tile, depth, index) elements needs a
comparison of their three words and selects to place them: counted as 4
operations (the port's kernel spends 3 on the compare and 6 on selects).
The peak: one 32-bit operation a lane a clock on the 128 float32 lanes of
each of the H100 SXM's 132 SMs at its 1.98 GHz boost clock, 33.5e12 a
second: work.PEAK_FP32_PER_S, which counts a lane's multiply-add as two
operations, so an integer operation counts as LANE_OPS of work.least_ms's.
Hopper's integer pipe has half as many lanes, so this rate is above what
the card can reach and the least time below it."""

from __future__ import annotations

import math

from splatbench.metrics import work

OPS_PER_EXCHANGE = 4
LANE_OPS = 2


def compare_exchanges(live: float) -> float:
    """L/2 · log2 L · (log2 L + 1)/2 compare-exchanges for L live elements."""
    if live < 2:
        return 0.0
    lg = math.log2(live)
    return live / 2 * lg * (lg + 1) / 2


def least_ms(live: float) -> float:
    """The network's least time a frame for `live` elements."""
    return work.least_ms(2 * work.ELEMENT_BYTES * live,
                         LANE_OPS * OPS_PER_EXCHANGE * compare_exchanges(live))


def read(r):
    ms = r.per_frame_ms("bitonic_shared", "bitonic_global")
    if not ms or r.live_mean is None:
        return None
    return 100.0 * least_ms(r.live_mean) / ms
