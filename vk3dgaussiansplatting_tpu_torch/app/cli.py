"""Command-line entry point — the reference's Main.cpp; port of
`vk3dgaussiansplatting_tpu.app.cli` with the same flags.

The reference hard-codes its startup scene (Main.cpp:21) and asset paths
(GardenScene.cpp:15); here scenes, resolution, sort, SH mode and frame
counts are flags.  The frames render on the GPU; without CUDA the CLI
raises unless `--cpu` asks for the CPU, where the kernels' plain versions
run.  `--camera` (not in the JAX CLI) poses the scene's camera after it
loads.

Usage:
  python -m vk3dgaussiansplatting_tpu_torch.app.cli --ply scene.ply --frames 3 \\
      --width 1920 --height 1080 --out out.png
  python -m vk3dgaussiansplatting_tpu_torch.app.cli --cpu --scene simple --out out.png
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

from ..core.config import RenderConfig, SortAlgorithm, SphericalHarmonicsMode
from ..utils import log

# Gaussian counts of the benchmark stand-ins (the JAX CLI's).
STAND_IN_GAUSSIANS = {"garden": 5_834_784, "train": 1_026_508, "bicycle": 1_500_000}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vk3dgs-torch", description="3D gaussian splatting renderer (PyTorch/CUDA port)"
    )
    p.add_argument(
        "--scene",
        default="simple",
        choices=["simple", "sort", "garden", "train", "bicycle", "procedural"],
        help="synthetic scene or benchmark stand-in",
    )
    p.add_argument("--ply", help="path to a .ply gaussian cloud (overrides --scene)")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--out", help="write the last frame's PNG here")
    p.add_argument(
        "--sort", default="auto", choices=["auto", "xla", "bitonic"],
        help="sort algorithm (reference: GPU_SORT_ALGORITHM); auto and xla are the stable "
             "LSD radix sort, bitonic the bitonic merge network (each a CUDA kernel on the "
             "card; bitonic needs a power-of-two capacity, as it is by default)",
    )
    p.add_argument(
        "--sh-mode", type=int, default=0, choices=[0, 1, 2],
        help="spherical harmonics mode (reference hotkeys 1/2/3)",
    )
    p.add_argument("--gaussians", type=int, default=1_000_000,
                   help="gaussian count for --scene procedural")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-pallas", action="store_true",
                   help="accepted for the JAX CLI's sake and has no effect: the device picks "
                        "each kernel (CUDA) or its plain version (--cpu)")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU with the kernels' plain versions")
    p.add_argument("--slack", type=int, default=None,
                   help="sort-capacity slack per tile (default: reference's 1024)")
    p.add_argument("--depth-cap", type=int, default=0,
                   help="saturation-truncation cap: the temporal capped blend "
                        "(ops/capped.py); 0 = off")
    p.add_argument("--camera", type=float, nargs=5, metavar=("X", "Y", "Z", "YAW", "PITCH"),
                   help="camera position and rotation (radians), set after the scene loads")
    return p


def make_scene(args, aspect):
    from ..scenes import synthetic
    from ..scenes.scene import Scene

    if args.ply:
        path = args.ply

        class PlyScene(Scene):
            def init(self):
                self.camera.set_position((0.0, 0.0, 2.0))
                self.camera.set_rotation(math.pi, 0.0)
                self.load_gaussians(path)

        return PlyScene(aspect)
    if args.scene == "simple":
        return synthetic.SimpleTestGaussiansScene(aspect)
    if args.scene == "sort":
        return synthetic.TestSortScene(aspect)
    if args.scene == "procedural":
        return synthetic.ProceduralBenchScene(args.gaussians, aspect, args.seed)
    return synthetic.ProceduralBenchScene(STAND_IN_GAUSSIANS[args.scene], aspect, args.seed)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the renderer runs on the GPU; pass --cpu to render "
                           "on the CPU with the kernels' plain versions")
    sort = {
        "auto": SortAlgorithm.AUTO,
        "xla": SortAlgorithm.XLA_SORT,
        "bitonic": SortAlgorithm.BITONIC,
    }[args.sort]
    kwargs = {}
    if args.slack is not None:
        kwargs["capacity_slack_per_tile"] = args.slack
    if args.depth_cap:
        kwargs["blend_depth_cap"] = args.depth_cap
    config = RenderConfig(
        width=args.width,
        height=args.height,
        sort_algorithm=sort,
        sh_mode=SphericalHarmonicsMode(args.sh_mode),
        **kwargs,
    )

    from .engine import Engine

    engine = Engine(config, device="cpu" if args.cpu else "cuda")
    engine.init(make_scene(args, config.aspect))
    if args.camera is not None:
        engine.scene_manager.update_to_next_scene()  # load now, then pose
        engine.scene_manager.current.camera.set_position(args.camera[:3])
        engine.scene_manager.current.camera.set_rotation(*args.camera[3:])

    frames = {}

    def on_frame(i, img):
        frames["last"] = img

    engine.run(args.frames, on_frame=on_frame)
    if args.out and "last" in frames:
        from ..io.image import write_png

        write_png(args.out, frames["last"])
        log.write(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
