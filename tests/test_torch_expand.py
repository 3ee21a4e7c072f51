"""Port parity: the expansion K1 (ops/cuda/expand_kernel.py) against the JAX
Pallas `expand_rows` (interpret mode on the CPU).

On CPU tensors the port's wrapper runs its plain version; the same cases run
against the CUDA kernel on the card in chip_smoke.py.  Live slots and the
total must be bit-exact; the port's dead slots must be zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu.ops.pallas import expand_kernel as jexp
from vk3dgaussiansplatting_tpu_torch.ops.cuda import expand_kernel as texp

torch.set_num_threads(1)


def _run_case(counts_np, capacity, extra_cols=None, seed=0):
    rng = np.random.default_rng(seed)
    n = counts_np.shape[0]
    cols_np = [np.arange(n, dtype=np.int32)]
    if extra_cols is None:
        cols_np.append(rng.integers(-(2**31), 2**31, size=n).astype(np.int32))
    else:
        cols_np.extend(extra_cols)
    jcols, jtotal = jexp.expand_rows(
        [jnp.asarray(c) for c in cols_np], jnp.asarray(counts_np), capacity
    )
    want = np.stack([np.asarray(c) for c in jcols])
    got, total = texp.expand_rows(
        torch.from_numpy(np.stack(cols_np)), torch.cumsum(torch.from_numpy(counts_np), 0), capacity
    )
    got = got.numpy()
    assert int(total) == int(jtotal) == int(counts_np.sum())
    live = int(min(counts_np.sum(), capacity))
    assert got.shape == (len(cols_np), capacity)
    np.testing.assert_array_equal(got[:, :live], want[:, :live])
    assert not got[:, live:].any()


def _random_counts_with_culls():
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 9, size=700).astype(np.int32)
    counts[rng.random(700) < 0.4] = 0
    return counts, int(counts.sum()) + 300


def _long_culled_run():
    counts = np.ones(3000, np.int32)
    counts[100:2500] = 0
    return counts, 1024


CASES = {
    "random_counts_with_culls": _random_counts_with_culls,
    "long_culled_run": _long_culled_run,
    "overflow_truncation": lambda: (np.full(300, 11, np.int32), 1536),
    "unaligned_capacity": lambda: (np.array([5, 0, 3, 0, 0, 2] * 10, np.int32), 1000),
    "all_culled": lambda: (np.zeros(600, np.int32), 512),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_expand_matches_jax(case):
    counts, capacity = CASES[case]()
    _run_case(counts, capacity)


def test_u32_depth_bits_survive():
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 4, size=400).astype(np.int32)
    depth_u32 = rng.integers(0, 2**32, size=400, dtype=np.uint64).astype(np.uint32)
    _run_case(counts, int(counts.sum()) + 128, extra_cols=[depth_u32.view(np.int32)])


def test_seven_columns_int64_counts():
    rng = np.random.default_rng(9)
    counts = rng.integers(0, 5, size=500).astype(np.int32)
    extra = [rng.integers(-(2**31), 2**31, size=500).astype(np.int32) for _ in range(6)]
    _run_case(counts, int(counts.sum()) - 17, extra_cols=extra)
    got, total = texp.expand_rows(
        torch.from_numpy(np.stack([np.arange(500, dtype=np.int32)] + extra)),
        torch.from_numpy(np.cumsum(counts.astype(np.int64))),
        64,
    )
    assert int(total) == int(counts.sum()) and got.shape == (7, 64)


def test_rejects_bad_inputs():
    cols = torch.zeros((2, 4), dtype=torch.int32)
    cum = torch.arange(1, 5, dtype=torch.int64)
    with pytest.raises(ValueError):
        texp.expand_rows(cols.to(torch.int64), cum, 8)
    with pytest.raises(ValueError):
        texp.expand_rows(cols, torch.arange(1, 6, dtype=torch.int64), 8)
    with pytest.raises(ValueError):
        texp.expand_rows(torch.zeros((8, 4), dtype=torch.int32), cum, 8)
    with pytest.raises(ValueError):
        texp.expand_rows(cols, cum.to(torch.int32), 8)
