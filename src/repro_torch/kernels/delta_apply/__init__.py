from .ops import (FusedOut, delta_apply_chain,  # noqa: F401
                  delta_apply_chain_batched, delta_apply_fused,
                  delta_apply_fused_batched, launches)
from .ref import delta_apply_chain_ref, delta_apply_fused_ref  # noqa: F401
