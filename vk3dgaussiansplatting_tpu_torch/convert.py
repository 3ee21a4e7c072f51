"""Hand-over from the JAX package's objects to the port's, without importing
JAX: the functions read attributes only, so tests can feed the two packages
the same scene, configuration and mid-run capped state."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.config import RenderConfig, SortAlgorithm, SphericalHarmonicsMode
from .models.gaussians import GaussianTable
from .ops.capped import CapsState
from .parallel.dist import DistConfig


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


def caps_state_from_jax(state, device="cpu") -> CapsState:
    """A JAX `CapsState` (uint32 thresholds, int32 caps and floors, or
    their numpy arrays) -> the port's CapsState of int64 tensors."""
    return CapsState(*(
        torch.from_numpy(np.asarray(getattr(state, f)).astype(np.int64)).to(device)
        for f in CapsState._fields
    ))


def dist_config_from_jax(d) -> DistConfig:
    """A JAX `DistConfig` (any object with its five fields) -> the port's."""
    return DistConfig(*(int(getattr(d, f)) for f in DistConfig._fields))
