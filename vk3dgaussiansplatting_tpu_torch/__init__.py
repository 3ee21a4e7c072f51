"""vk3dgaussiansplatting_tpu_torch — the PyTorch/CUDA port of
vk3dgaussiansplatting_tpu for one NVIDIA H100.

Same layout and names as the JAX package; the main render path (keygen,
sort, ranges, blend) runs as PyTorch tensor code with two hand-written CUDA
kernels (csrc/expand.cu, csrc/blend.cu), built with nvcc at first use.  The
package imports neither JAX nor the JAX package, and its CPU path needs no
compiler.
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
