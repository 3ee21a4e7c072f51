"""Port parity: K5 `compact_runs` and K6 `compact_segments` (their plain
versions, reached through the wrappers on CPU tensors) against the JAX
package's Pallas kernels in interpret mode, on the cases of
tests/test_compact.py.  K6 is compared on every lane, K5 on each tile's
live lanes [sbase + off, sbase + off + count) (other lanes hold 0 in the
port and whatever the output buffer held on the TPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu.ops.pallas import compact_kernel as jck
from vk3dgaussiansplatting_tpu_torch.ops.cuda import compact_kernel as tck
from vk3dgaussiansplatting_tpu_torch.ops.cuda._build import LAUNCHES

torch.set_num_threads(1)
CHUNK = 128


def _i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _segments_cases():
    rng = np.random.default_rng(5)
    e = 5000
    src = rng.integers(0, 2**32, e, dtype=np.uint64).astype(np.uint32)
    yield "unaligned", src, rng.integers(0, e - CHUNK, 2048 // CHUNK).astype(np.int32), 2048
    src = np.arange(4096, dtype=np.uint32)
    chunks = []
    for s, c in zip([17, 900, 2111, 3333], [300, 129, 256, 128]):
        chunks += [s + k * CHUNK for k in range(-(-c // CHUNK))]
    ep = -(-len(chunks) // 4) * 4 * CHUNK
    chunks += [0] * (ep // CHUNK - len(chunks))
    yield "tile_segments", src, np.asarray(chunks, np.int32), ep
    yield "clamp", np.arange(600, dtype=np.uint32), np.array([10_000, -50, 0, 3], np.int32), 512


@pytest.mark.parametrize("case", ["unaligned", "tile_segments", "clamp"])
def test_compact_segments_matches_jax(case):
    name, src, src0, ep = next(c for c in _segments_cases() if c[0] == case)
    want = np.asarray(jck.compact_segments(jnp.asarray(src), jnp.asarray(src0), ep))
    launches = LAUNCHES["compact_segments"]
    got = tck.compact_segments(_i64(src), _i64(src0), ep)
    assert LAUNCHES["compact_segments"] == launches  # CPU tensors: plain version
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _slab_layout(starts, counts, wmax):
    off = starts % CHUNK
    slabw = -(-(off + counts) // CHUNK) * CHUNK
    assert (slabw <= wmax).all()
    sbases = (np.cumsum(slabw) - slabw).astype(np.int32)
    return off, sbases, -(-int(slabw.sum()) // 512) * 512 + 512


def _runs_cases():
    rng = np.random.default_rng(11)
    e, wmax = 20_000, 512 + CHUNK
    src = rng.integers(0, 2**32, e, dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(0, 513, 37).astype(np.int32)
    counts[rng.random(37) < 0.3] = 0  # empty tiles interleaved
    starts = rng.integers(0, e - wmax, 37).astype(np.int32)
    yield "random", src, starts, counts, wmax
    src = np.arange(4096, dtype=np.uint32)
    yield "single", src, np.array([1001], np.int32), np.array([100], np.int32), 256
    # Runs that read past the end of src (zero padding) and overlap windows.
    yield "tail", src, np.array([3900, 3990, 4000], np.int32), np.array([96, 6, 96], np.int32), 256


@pytest.mark.parametrize("case", ["random", "single", "tail"])
def test_compact_runs_matches_jax(case):
    _name, src, starts, counts, wmax = next(c for c in _runs_cases() if c[0] == case)
    off, sbases, ep = _slab_layout(starts, counts, wmax)
    want = np.asarray(jck.compact_runs(jnp.asarray(src), jnp.asarray(starts),
                                       jnp.asarray(sbases), ep, wmax)).astype(np.int64)
    launches = LAUNCHES["compact_runs"]
    got = tck.compact_runs(_i64(src), _i64(starts), _i64(sbases), ep, wmax).numpy()
    assert LAUNCHES["compact_runs"] == launches
    assert got.shape == (ep,)
    for s, b, o, c in zip(starts, sbases, off, counts):
        np.testing.assert_array_equal(got[b + o : b + o + c], want[b + o : b + o + c])
        np.testing.assert_array_equal(got[b + o : b + o + c], src[s : s + c].astype(np.int64))


def test_compact_runs_all_empty():
    got = tck.compact_runs(torch.arange(4096), torch.zeros(5, dtype=torch.int64),
                           torch.zeros(5, dtype=torch.int64), 512, 256)
    assert got.shape == (512,)


def test_compact_wrappers_reject_bad_inputs():
    src = torch.arange(600)
    with pytest.raises(ValueError):
        tck.compact_segments(src.to(torch.int32), torch.zeros(4, dtype=torch.int64), 512)
    with pytest.raises(ValueError):
        tck.compact_segments(src, torch.zeros(3, dtype=torch.int64), 512)
    with pytest.raises(ValueError):
        tck.compact_segments(src, torch.zeros(4, dtype=torch.int64), 500)
    with pytest.raises(ValueError):
        tck.compact_runs(src, torch.zeros(2, dtype=torch.int64), torch.zeros(3, dtype=torch.int64),
                         512, 256)
    with pytest.raises(ValueError):
        tck.compact_runs(src, torch.zeros(2, dtype=torch.int64), torch.zeros(2, dtype=torch.int64),
                         512, 200)
