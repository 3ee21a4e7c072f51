"""Device capability report — the reference's GpuProperties
(GpuProperties::isPhysicalDeviceSuitable, GpuProperties.cpp:193-280); port
of `vk3dgaussiansplatting_tpu.utils.device` on `torch.cuda`.

The reference gates on Vulkan 1.3, shaderInt64 and the subgroup size; the
port's gate is what its kernels are built for: an NVIDIA GPU of compute
capability 9.0 (csrc/ compiles for sm_90a only).
"""

from __future__ import annotations

import torch

from . import log

REQUIRED_CAPABILITY = (9, 0)


def device_report(index: int = 0) -> dict:
    """Platform, name, memory and compute capability of CUDA device
    `index` ({"platform": "cpu", "num_devices": 0} without CUDA)."""
    if not torch.cuda.is_available():
        return {"platform": "cpu", "num_devices": 0}
    props = torch.cuda.get_device_properties(index)
    free, total = torch.cuda.mem_get_info(index)
    return {
        "platform": "gpu",
        "device": f"cuda:{index}",
        "device_kind": props.name,
        "num_devices": torch.cuda.device_count(),
        "compute_capability": (props.major, props.minor),
        "multiprocessors": props.multi_processor_count,
        "memory_bytes_total": int(total),
        "memory_bytes_free": int(free),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def check_suitability(min_devices: int = 1) -> bool:
    """The isPhysicalDeviceSuitable gate: CUDA with at least `min_devices`
    devices, each of compute capability 9.0.  Warns and returns False
    otherwise (the CPU path, with the plain versions, needs no device)."""
    if not torch.cuda.is_available():
        log.warning("no CUDA device: only the CPU path (plain versions) can run")
        return False
    n = torch.cuda.device_count()
    if n < min_devices:
        log.warning(f"only {n} CUDA device(s), wanted >= {min_devices}")
        return False
    for i in range(n):
        cap = torch.cuda.get_device_capability(i)
        if cap != REQUIRED_CAPABILITY:
            log.warning(f"cuda:{i} has compute capability {cap}; the kernels are built for "
                        f"sm_90a ({REQUIRED_CAPABILITY})")
            return False
    return True
