"""Hand-written CUDA kernels for Hopper (``sm_90a``): snapshot retrieval
(delta-apply, segment-sum) and LM serving (flash attention: a wgmma/TMA
kernel for bf16 prefill, a TF32 tensor-core kernel for f32 prefill and a
split-K kernel for decode calls).

Each kernel directory has ``ops.py`` (the wrapper: dispatch by tensor
device, launch counter) and ``ref.py`` (the plain PyTorch version); the
CUDA sources live in ``csrc/`` and are built by ``_build.py`` with
``nvcc`` at first use.  CPU tensors run the plain versions, CUDA tensors
the kernels (:mod:`repro_torch.kernels.policy`).
"""
from . import policy  # noqa: F401
from .delta_apply import (FusedOut, delta_apply_chain,  # noqa: F401
                          delta_apply_chain_batched,
                          delta_apply_chain_prefix,
                          delta_apply_chain_prefix_batched, delta_apply_fused,
                          delta_apply_fused_batched, delta_apply_fused_pair)
from .delta_apply import launches as _da_launches
from .flash_attention import attention  # noqa: F401
from .flash_attention import launches as _fa_launches
from .segment_sum import bucket_edges, segment_sum  # noqa: F401
from .segment_sum import launches as _ss_launches


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {**_da_launches, **_fa_launches, **_ss_launches}


def reset_launch_counts() -> None:
    for counts in (_da_launches, _fa_launches, _ss_launches):
        for name in counts:
            counts[name] = 0
