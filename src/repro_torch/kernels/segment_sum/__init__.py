from .ops import (KERNELS, bucket_edges, bucket_edges_tensor,  # noqa: F401
                  segment_sum, segment_sum_bucketed)
from .ref import segment_sum_bucketed_ref  # noqa: F401
