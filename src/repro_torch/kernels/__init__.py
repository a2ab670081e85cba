"""Hand-written CUDA kernels for Hopper (``sm_90a``): snapshot retrieval
(delta-apply, segment-sum) and LM serving (flash attention: a wgmma/TMA
kernel for bf16 prefill, a TF32 tensor-core kernel for f32 prefill, a
split-K kernel for decode calls and a wgmma/TMA kernel for MLA's absorbed
decode).

Each kernel directory has ``ops.py`` (the wrapper: dispatch by tensor
device, each launch counted in :mod:`repro_torch.obs`) and ``ref.py``
(the plain PyTorch version); the CUDA sources live in ``csrc/`` and are
built by ``_build.py`` with ``nvcc`` at first use.  CPU tensors run the
plain versions, CUDA tensors the kernels
(:mod:`repro_torch.kernels.policy`).
"""
from . import policy  # noqa: F401
from .. import obs
from .delta_apply import KERNELS as _DA_KERNELS
from .delta_apply import (FusedOut, delta_apply_chain,  # noqa: F401
                          delta_apply_chain_batched,
                          delta_apply_chain_prefix,
                          delta_apply_chain_prefix_batched, delta_apply_fused,
                          delta_apply_fused_batched, delta_apply_fused_pair)
from .flash_attention import KERNELS as _FA_KERNELS
from .flash_attention import attention  # noqa: F401
from .segment_sum import KERNELS as _SS_KERNELS
from .segment_sum import bucket_edges, segment_sum  # noqa: F401

_KERNELS = _DA_KERNELS + _FA_KERNELS + _SS_KERNELS


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name (the ``launch.<kernel>``
    counters of :mod:`repro_torch.obs`)."""
    counts = obs.counters()
    return {name: counts.get("launch." + name, 0) for name in _KERNELS}


def reset_launch_counts() -> None:
    obs.reset(*("launch." + name for name in _KERNELS))
