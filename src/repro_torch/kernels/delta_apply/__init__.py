from .ops import (FusedOut, delta_apply_chain,  # noqa: F401
                  delta_apply_chain_batched, delta_apply_chain_prefix,
                  delta_apply_chain_prefix_batched, delta_apply_fused,
                  delta_apply_fused_batched, delta_apply_fused_pair,
                  KERNELS)
from .ref import delta_apply_chain_ref, delta_apply_fused_ref  # noqa: F401
