"""vk3dgaussiansplatting_tpu_torch — the PyTorch/CUDA port of
vk3dgaussiansplatting_tpu for one NVIDIA H100.

Same layout and names as the JAX package: the frame (keygen, sort, ranges,
blend; the capped and distributed variants) runs as PyTorch tensor code
around hand-written CUDA kernels (csrc/*.cu, built with nvcc at first
use), and the app path (`app.cli`, `app.engine.Engine`, `io.ply` with its
native loader) loads and renders a trained .ply.  The package imports
neither JAX nor the JAX package, and its CPU path needs no CUDA compiler.
"""

from .core.config import RenderConfig, SortAlgorithm, SphericalHarmonicsMode
from .models.gaussians import GaussianTable
from .pipeline import Renderer, render_frame
from .render.camera import Camera

__all__ = [
    "Camera",
    "GaussianTable",
    "RenderConfig",
    "Renderer",
    "SortAlgorithm",
    "SphericalHarmonicsMode",
    "render_frame",
]
