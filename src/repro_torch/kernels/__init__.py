"""Hand-written CUDA kernels for Hopper (sm_90a). Each package holds
``csrc/<name>.cu`` (the kernel, with a plain C launch function), ``ops.py``
(the wrapper: checks, allocates, launches on the current stream, counts
launches; on a CPU tensor it runs the plain version) and ``ref.py`` (the
plain PyTorch version). ``_build`` compiles the sources with ``nvcc`` at
first CUDA use and loads them through ``ctypes``."""
from typing import Dict


def _ops_modules():
    from repro_torch.kernels.hash_join import ops as hash_join_ops
    from repro_torch.kernels.segment_kpi import ops as segment_kpi_ops
    return hash_join_ops, segment_kpi_ops


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset (CPU calls of the
    plain versions never count)."""
    out: Dict[str, int] = {}
    for mod in _ops_modules():
        out.update(mod.launches)
    return out


def reset_launch_counts() -> None:
    for mod in _ops_modules():
        for name in mod.launches:
            mod.launches[name] = 0
