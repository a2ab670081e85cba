from .ops import (bucket_edges, launches, segment_sum,  # noqa: F401
                  segment_sum_bucketed)
from .ref import segment_sum_bucketed_ref  # noqa: F401
