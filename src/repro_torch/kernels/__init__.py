"""Hand-written CUDA kernels for Hopper (sm_90a): the ETL path's
``hash_join`` and ``segment_kpi`` families, and the LM serving path's
``flash_attention`` and ``gla_chunk`` (tensor-core designs for the
models' bf16 — one for flash, the SSD and RWKV6 ones for gla — and the
first CUDA-core design of each for the rest). Each
package holds ``csrc/`` (the kernels, each ``.cu`` with a plain C launch
function), ``ops.py`` (the wrapper: checks, picks the design, allocates,
launches on the current stream, counts launches; on a CPU tensor it runs
the plain version) and ``ref.py`` (the plain PyTorch version). ``_build`` compiles the sources with ``nvcc`` at
first CUDA use and loads them through ``ctypes``."""
from typing import Dict

from repro_torch.kernels._build import COUNT_LOCK


def _ops_modules():
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.gla_chunk import ops as gla_ops
    from repro_torch.kernels.hash_join import ops as hash_join_ops
    from repro_torch.kernels.segment_kpi import ops as segment_kpi_ops
    return hash_join_ops, segment_kpi_ops, flash_ops, gla_ops


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset (CPU calls of the
    plain versions never count)."""
    out: Dict[str, int] = {}
    with COUNT_LOCK:
        for mod in _ops_modules():
            out.update(mod.launches)
    return out


def reset_launch_counts() -> None:
    with COUNT_LOCK:
        for mod in _ops_modules():
            for name in mod.launches:
                mod.launches[name] = 0
