"""Plain PyTorch version of the bucketed segment-sum kernel."""
from __future__ import annotations

import torch


def segment_sum_bucketed_ref(data: torch.Tensor, local_ids: torch.Tensor, *,
                             block_n: int) -> torch.Tensor:
    """``data [NB, ME, D]`` per-bucket edge features, ``local_ids [NB, ME]``
    destination offsets within the bucket (-1 = padding, sent to a dead
    row) -> ``[NB, block_n, D]`` per-destination sums.

    Walks the ``ME`` axis in order, all buckets at once: each output row
    receives its edges one at a time in input order, starting from 0.0 —
    the CUDA kernel's summation order, so the two agree bit for bit on any
    f32 data.  Against the JAX one-hot product they agree exactly on
    integer-valued data (the 0/1 degree feed) and to rounding otherwise."""
    NB, ME, D = data.shape
    out = torch.zeros(NB, block_n + 1, D, dtype=data.dtype, device=data.device)
    buckets = torch.arange(NB, device=data.device)
    rows = torch.where(local_ids < 0, block_n, local_ids).to(torch.int64)
    for e in range(ME):
        out[buckets, rows[:, e]] += data[:, e]
    return out[:, :block_n].contiguous()
