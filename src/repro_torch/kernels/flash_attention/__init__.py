from .ops import (MAX_HEAD_DIM, FlashAttention, attention,  # noqa: F401
                  attention_bwd, attention_stats, KERNELS)
from .ref import attention_ref, attention_ref_stats  # noqa: F401
