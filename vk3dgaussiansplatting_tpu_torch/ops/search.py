"""Searches over large sorted tensors — port of
`vk3dgaussiansplatting_tpu.ops.search`.

The JAX package replaces a flat `searchsorted` with a constant-depth
two-level search (chunk lasts, then one chunk row) because each dependent
gather round is slow on the TPU.  On the GPU and the CPU `torch.searchsorted`
is one kernel, so both functions here are one call with the same results:

  * `two_level_left_search(arr, probes)` = searchsorted-left, clipped to len;
  * `two_level_lex_search(hi, lo, ph, pl)` = searchsorted-left over the
    composite key (hi, lo), formed as one int64 per element.

Values are int64 tensors holding uint32 values (SENTINEL included).  The
JAX contract on probes carries over: a side="right" search is a left search
of `probe + 1`, and in the JAX package's uint32 that wraps at the maximum, so
callers clamp probes below SENTINEL before adding 1 (ops/capped.py does).
The port's int64 cannot wrap there, but keeping the clamp keeps the two
packages' probes, and so their results, equal.
"""

from __future__ import annotations

import torch

_U32_BIAS = 2**31


def two_level_left_search(arr: torch.Tensor, probes: torch.Tensor) -> torch.Tensor:
    """`searchsorted(arr, probes, side="left")` as int64 positions in
    [0, len(arr)].  arr: [N] sorted integers; probes: [P], same domain."""
    return torch.searchsorted(arr.contiguous(), probes.contiguous())


def _lex_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 of the uint32 pair (hi, lo): (hi - 2^31)·2^32
    + lo spans exactly [-2^63, 2^63), so no value overflows."""
    return (hi - _U32_BIAS) * 2**32 + lo


def two_level_lex_search(
    hi: torch.Tensor, lo: torch.Tensor, probe_hi: torch.Tensor, probe_lo: torch.Tensor
) -> torch.Tensor:
    """Per probe, #{i : (hi_i, lo_i) < (probe_hi, probe_lo)} lexicographically.

    hi/lo: [N] int64 uint32 values, lex-sorted (the sorted elements' tile
    and depth); probe_hi/probe_lo: [P] int64 uint32 values.  Returns [P]
    int64 positions."""
    return torch.searchsorted(_lex_key(hi, lo), _lex_key(probe_hi, probe_lo))
