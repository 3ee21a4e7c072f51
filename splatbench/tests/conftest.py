"""The benchmark's own tests: the reference, the work counts, the guard and
the harness, on the CPU at tiny sizes (`python3 -m pytest splatbench/tests`).
Tests that need a card carry the `cuda` marker and skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (a CUDA kernel has no CPU mode); skips without one"
    )
