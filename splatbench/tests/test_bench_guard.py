"""The run's guard against JAX and the JAX package, by top-level name."""

import importlib
import pkgutil
import subprocess
import sys

from splatbench import guard, spec


def test_guard_flags_jax_and_the_jax_package_by_top_level_name():
    mods = {"jax": object(), "jaxlib.xla_client": object(), "flax": object(),
            "vk3dgaussiansplatting_tpu": object(), "vk3dgaussiansplatting_tpu.ops.keygen": object(),
            "vk3dgaussiansplatting_tpu_torch": object(),
            "vk3dgaussiansplatting_tpu_torch.pipeline": object(), "jaxtyping": object(),
            "numpy": object(), "blocked": None}
    assert guard.forbidden_modules(mods) == [
        "flax", "jax", "jaxlib.xla_client", "vk3dgaussiansplatting_tpu",
        "vk3dgaussiansplatting_tpu.ops.keygen"]


def test_guard_skips_blocked_entries():
    assert guard.forbidden_modules({"jax": None}) == []


def test_the_harness_and_the_reference_load_no_jax():
    """Every module of splatbench imported in a fresh process, the port
    with it, loads nothing the guard forbids; the reference alone loads
    nothing of the port."""
    names = [m.name for m in pkgutil.walk_packages([str(spec.HERE)], "splatbench.")
             if ".tests" not in m.name]
    code = ("import importlib, sys\n"
            "import splatbench.reference, splatbench.judge, splatbench.scene\n"
            "assert not [m for m in sys.modules if m.startswith('vk3dgaussiansplatting_tpu')]\n"
            f"[importlib.import_module(n) for n in {names!r}]\n"
            "import vk3dgaussiansplatting_tpu_torch.pipeline\n"
            "from splatbench import guard\n"
            "print(guard.forbidden_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=spec.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert importlib.import_module("splatbench.guard") is guard
