"""Port parity: RenderConfig fields, defaults and derived sizes equal JAX's."""

import dataclasses

import pytest
import torch

from vk3dgaussiansplatting_tpu.core import config as jcfg
from vk3dgaussiansplatting_tpu_torch import convert
from vk3dgaussiansplatting_tpu_torch.core import config as tcfg

torch.set_num_threads(1)


def test_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.RenderConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.RenderConfig)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    for (name, jd), (_, td) in zip(jf, tf):
        if isinstance(jd, (jcfg.SortAlgorithm, jcfg.SphericalHarmonicsMode)):
            assert jd.value == td.value, name
        else:
            assert jd == td, name


def test_enums_and_constants_match():
    assert [(m.name, m.value) for m in jcfg.SortAlgorithm] == [
        (m.name, m.value) for m in tcfg.SortAlgorithm
    ]
    assert [(m.name, m.value) for m in jcfg.SphericalHarmonicsMode] == [
        (m.name, m.value) for m in tcfg.SphericalHarmonicsMode
    ]
    assert tcfg.SENTINEL == jcfg.SENTINEL and tcfg.MAX_UINT32 == jcfg.MAX_UINT32
    for x in (0, 1, 2, 3, 1000, 4_245_663, 2**24 + 1):
        assert tcfg.ceil_pow_two(x) == jcfg.ceil_pow_two(x)
        assert tcfg.min_num_bits(x) == jcfg.min_num_bits(x)


@pytest.mark.parametrize("width,height", [(1280, 720), (1920, 1080), (192, 96)])
@pytest.mark.parametrize("pow2", [True, False])
def test_derived_sizes_match(width, height, pow2):
    j = jcfg.RenderConfig(width=width, height=height, capacity_pow_two=pow2)
    t = tcfg.RenderConfig(width=width, height=height, capacity_pow_two=pow2)
    assert t.num_tiles == j.num_tiles
    assert (t.grid_width, t.grid_height) == (j.grid_width, j.grid_height)
    assert t.num_tile_bits == j.num_tile_bits
    assert t.num_sort_bits() == j.num_sort_bits()
    for n in (559_263, 5_834_784, 16):
        assert t.sort_capacity(n) == j.sort_capacity(n)


def test_config_from_jax_copies_every_field():
    j = jcfg.RenderConfig(
        width=320,
        height=200,
        sh_mode=jcfg.SphericalHarmonicsMode.SKIP_FIRST_BAND,
        sort_algorithm=jcfg.SortAlgorithm.XLA_SORT,
        capacity_pow_two=False,
        expansion_method="repeat",
        blend_depth_cap=512,
    )
    t = convert.config_from_jax(j)
    for f in dataclasses.fields(j):
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        if isinstance(jv, (jcfg.SortAlgorithm, jcfg.SphericalHarmonicsMode)):
            assert jv.value == tv.value
        else:
            assert jv == tv, f.name


def test_sizes_at_bench_scenes():
    """The two stand-in scenes' capacities (capacity_pow_two=False)."""
    t720 = tcfg.RenderConfig(1280, 720, capacity_pow_two=False)
    t1080 = tcfg.RenderConfig(1920, 1080, capacity_pow_two=False)
    assert t720.sort_capacity(559_263) == 4_245_663
    assert t1080.sort_capacity(5_834_784) == 14_190_624
    assert t1080.num_sort_bits() == 48
