from .ops import (KERNELS, bucket_edges, segment_sum,  # noqa: F401
                  segment_sum_bucketed)
from .ref import segment_sum_bucketed_ref  # noqa: F401
