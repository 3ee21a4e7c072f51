"""Work counts: the least a frame, or a stage of it, must move and compute
at this frame's inputs, and the least time the card could take for it.

Every count is of work that any correct implementation must do, at the
pipeline's interfaces, never of what today's kernels happen to read or
write: a kernel that reads a row twice, or a fill of unused slots, is the
implementation's cost, not the work.  So a share of these bounds cannot
pass 100% whatever a later change fuses or removes.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit): HBM3
at 3.35 TB/s and 67 TFLOP/s of float32 outside the tensor cores.  The
least time is the larger of bytes over the first and operations over the
second.  A multiply-add counts as 2 operations, as in the peak rate.
"""

from __future__ import annotations

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

# The gaussian table, a row: the position (3 floats), read for every
# gaussian to cull it; the rest (scale 3, rotation 4, SH 48, opacity 1
# floats), read only for a gaussian in view.
POSITION_BYTES = 12
ROW_REST_BYTES = 4 * (3 + 4 + 48 + 1)
# keygen's outputs at the pipeline's interface: a sort element per live
# element, and a gaussian in view's frame data (colour and alpha 4 floats,
# covariance 3, inverse covariance 3, screen position 2).  An element's
# three keys each fit in 4 bytes (the tile id and the gaussian index are
# under 2^32, the depth is a float32's bits), so 12 bytes is its least
# size, whatever width the port's columns are stored in.
ELEMENT_BYTES = 3 * 4
FRAME_DATA_BYTES = 4 * (4 + 3 + 3 + 2)
# The images: the blend's float32 rgb, the frame's rgba8.
IMAGE_F32_BYTES = 12
IMAGE_U8_BYTES = 4

# A blend's float32 operations by kind, for each (pixel, element) pair up
# to the pixel's saturating element (P): dx, dy (2), f = a'dx^2 + c'dy^2 +
# b'dxdy (8) and the two eligibility tests (2); an eligible pair also steps
# T: alpha = a_g exp(f), 1 - alpha and the product (3), and adds colour:
# T alpha and three multiply-adds (7).  exp's own instructions are not
# counted, so the count stays a least one.
FLOPS_PER_PAIR = 12
FLOPS_PER_T_STEP = 3
FLOPS_PER_COLOUR = 7


def least_ms(nbytes: float, flops: float = 0.0) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_PER_S) * 1e3


def blend_flops(pairs: int, eligible: int) -> int:
    return FLOPS_PER_PAIR * pairs + (FLOPS_PER_T_STEP + FLOPS_PER_COLOUR) * eligible


def frame_least_ms(w: dict) -> float:
    """The whole frame: each position read once, the rest of each row in
    view read once, the rgba8 image written once, and the blend's
    operations over P."""
    nbytes = (POSITION_BYTES * w["gaussians"] + ROW_REST_BYTES * w["visible"]
              + IMAGE_U8_BYTES * w["pixels"])
    return least_ms(nbytes, blend_flops(w["pairs"], w["eligible"]))


def keygen_least_ms(w: dict, live: float) -> float:
    """keygen: the table rows it needs read once, the live sort elements
    and the frame data of the gaussians in view written once."""
    return least_ms(POSITION_BYTES * w["gaussians"] + ROW_REST_BYTES * w["visible"]
                    + ELEMENT_BYTES * live + FRAME_DATA_BYTES * w["visible"])


def sort_least_ms(live: float) -> float:
    """The sort: the live elements read once and written once."""
    return least_ms(2 * ELEMENT_BYTES * live)


def blend_least_ms(w: dict) -> float:
    """The blend: its operations over P, or its float32 image written once,
    whichever takes longer."""
    return least_ms(IMAGE_F32_BYTES * w["pixels"], blend_flops(w["pairs"], w["eligible"]))


# Ranks stepped between two recomputations of the tiles still active.
STEPS_A_SYNC = 32


def saturating_pairs(rows: torch.Tensor, index: torch.Tensor, ranges: torch.Tensor, *,
                     width: int, height: int, tile: int, cutoff: float, stop: float):
    """P and its eligible pairs, counted on a frame's own inputs: for each
    pixel inside the image, the (pixel, element) pairs of its tile's range
    up to and including the element at which its T falls below `stop`, or
    to the range's end.

    rows: [N, 9] float32 blend rows (x, y, a', b', c', r, g, b, alpha);
    index: [L] int64 gaussian of each sorted element; ranges: [tiles, 2]
    int64 (start, end).  Returns (P, eligible pairs among P) as ints."""
    dev = rows.device
    gw = -(-width // tile)
    ntiles = ranges.shape[0]
    npx = tile * tile
    tiles = torch.arange(ntiles, device=dev)
    pix = torch.arange(npx, device=dev)
    xi = (tiles % gw)[:, None] * tile + pix % tile
    yi = (tiles // gw)[:, None] * tile + pix // tile
    px, py = xi.float(), yi.float()
    start = ranges[:, 0]
    length = ranges[:, 1] - start
    trans = torch.ones((ntiles, npx), device=dev)
    done = (xi >= width) | (yi >= height)
    pairs = torch.zeros(ntiles, dtype=torch.int64, device=dev)
    eligible = torch.zeros(ntiles, dtype=torch.int64, device=dev)
    n = index.shape[0]
    act = torch.nonzero((length > 0) & ~done.all(dim=1)).squeeze(1)
    r = 0
    while act.numel():
        st, ln = start[act], length[act]
        pxa, pya, t, dn = px[act], py[act], trans[act], done[act]
        pa = torch.zeros(act.shape[0], dtype=torch.int64, device=dev)
        ea = torch.zeros_like(pa)
        for _ in range(STEPS_A_SYNC):
            todo = ~dn & (r < ln)[:, None]
            row = rows[index[torch.clamp(st + r, max=max(n - 1, 0))]]
            dx = row[:, 0:1] - pxa
            dy = pya - row[:, 1:2]
            f = (row[:, 2:3] * dx * dx + row[:, 4:5] * dy * dy) + row[:, 3:4] * dx * dy
            alpha = row[:, 8:9] * torch.exp(f)
            elig = (f <= 0.0) & (alpha >= cutoff) & todo
            pa += todo.sum(dim=1)
            ea += elig.sum(dim=1)
            t = torch.where(elig, t * (1.0 - alpha), t)
            dn = dn | (t < stop)
            r += 1
        pairs[act] += pa
        eligible[act] += ea
        trans[act], done[act] = t, dn
        act = act[(r < ln) & ~dn.all(dim=1)]
    return int(pairs.sum()), int(eligible.sum())
