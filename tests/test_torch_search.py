"""Port parity: ops/search.py (one `torch.searchsorted`) against the JAX
package's constant-depth two-level searches, bit-exact, on random sorted
uint32 arrays with a SENTINEL tail, probes at and around SENTINEL, and a
tile with no elements."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu.ops import search as jsearch
from vk3dgaussiansplatting_tpu_torch.ops import search as tsearch

torch.set_num_threads(1)
SENTINEL = 0xFFFFFFFF


def _i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("n", [1, 1000, 5000])
def test_left_search_matches_jax(n):
    rng = np.random.default_rng(n)
    arr = np.sort(rng.integers(0, 3000, n)).astype(np.uint32)
    arr[-(n // 10 or 1):] = SENTINEL  # sentinel tail
    probes = np.concatenate([
        rng.integers(0, 3100, 300), [0, 2999, SENTINEL - 1, SENTINEL], arr[:5],
    ]).astype(np.uint32)
    want = jax.jit(jsearch.two_level_left_search)(jnp.asarray(arr), jnp.asarray(probes))
    got = tsearch.two_level_left_search(_i64(arr), _i64(probes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(arr, probes, side="left"))


def test_lex_search_matches_jax():
    """The capped path's crossing search: sorted (tile, depth) pairs, tile
    17 left empty, a SENTINEL tail, probes (t, min(thr, SENTINEL-1) + 1)."""
    rng = np.random.default_rng(4)
    n = 6000
    hi = rng.integers(0, 40, n).astype(np.uint32)
    hi[hi == 17] = 18
    lo = rng.integers(0, 2**32 - 1, n, dtype=np.uint64).astype(np.uint32)
    hi[-300:] = SENTINEL
    lo[-300:] = SENTINEL
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    ph = np.concatenate([np.arange(42), rng.integers(0, 42, 200), [SENTINEL]]).astype(np.uint32)
    thr = rng.integers(0, 2**32, ph.shape[0], dtype=np.uint64)
    thr[:5] = SENTINEL
    pl = (np.minimum(thr, SENTINEL - 1) + 1).astype(np.uint32)
    want = jax.jit(jsearch.two_level_lex_search)(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(ph), jnp.asarray(pl))
    got = tsearch.two_level_lex_search(_i64(hi), _i64(lo), _i64(ph), _i64(pl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    key = hi.astype(np.uint64) << np.uint64(32) | lo.astype(np.uint64)
    pkey = ph.astype(np.uint64) << np.uint64(32) | pl.astype(np.uint64)
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(key, pkey, side="left"))
    # The empty tile's probes land where tile 18 starts.
    assert got[17] == np.searchsorted(hi, 18, side="left")
