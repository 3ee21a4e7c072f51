"""Hand-over from the JAX package's objects to the port's, without importing
JAX: both functions read attributes only, so tests can feed the two packages
the same scene and configuration."""

from __future__ import annotations

import dataclasses

import numpy as np

from .core.config import RenderConfig, SortAlgorithm, SphericalHarmonicsMode
from .models.gaussians import GaussianTable


def table_from_jax(t, device="cpu") -> GaussianTable:
    """Any object with array-like `position [N,3]`, `scale [N,3]`,
    `rot [N,4]`, `sh [N,16,3]` and `opacity [N]` (the JAX `GaussianTable`,
    or its `.to_numpy()`) -> a port GaussianTable on `device`."""
    return GaussianTable.from_numpy(
        *(np.asarray(getattr(t, f.name)) for f in dataclasses.fields(GaussianTable))
    ).to(device)


def config_from_jax(cfg) -> RenderConfig:
    """Copy every field of a JAX `RenderConfig` (enums by value)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(RenderConfig)}
    kw["sh_mode"] = SphericalHarmonicsMode(int(kw["sh_mode"]))
    kw["sort_algorithm"] = SortAlgorithm(kw["sort_algorithm"].value)
    return RenderConfig(**kw)
