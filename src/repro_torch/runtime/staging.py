"""Double-buffered host→device staging for chunked chain application.

The device retrieval path lands a ``[B, K, W]`` stack of delta bit-planes.
Built monolithically, the timeline serializes: decode/pack all K planes on
the host, one big copy, then the kernel.  :class:`DeviceStager` chunks the
K axis and pipelines the stages instead — while the kernel applies chunk
*i*, the host builds (codec-decode → ``np_from_indices`` pack) and copies
chunk *i+1*.  CUDA launches and ``non_blocking`` copies from pinned memory
are asynchronous, so ``apply`` returns as soon as the work is enqueued and
the host immediately moves on to staging the next chunk; with ``depth=2``
(double buffering) exactly one chunk is ever in flight ahead of the compute
stream, bounding resident staging memory to two chunks.

Chunked application is exact: the delta chain is a left fold of bitwise
steps, so landing it ``chunk_k`` rows at a time produces bit-identical
masks.
"""
from __future__ import annotations

import os
from collections import deque
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .. import obs
from ..kernels.policy import resolve_device
from ..transfer import host_tensor


def stream_chunk_k(default: int = 8) -> int:
    """Chunk length along K for the streamed path (``REPRO_STREAM_CHUNK``
    env override; values < 1 disable streaming — monolithic apply)."""
    try:
        return int(os.environ.get("REPRO_STREAM_CHUNK", default))
    except ValueError:
        return default


class PinnedPut:
    """numpy array -> device tensor through a pinned host buffer and a
    ``non_blocking`` copy on the current stream.

    A pinned buffer is held until the CUDA event recorded after its copy has
    completed, so it is never reused or freed while the copy may still be
    reading it (the race that double buffering would otherwise open).  On
    the CPU it is the zero-copy identity."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self._inflight: deque = deque()     # (event, pinned buffer)

    def __call__(self, a: np.ndarray) -> torch.Tensor:
        t = host_tensor(a)
        if self.device.type == "cpu":
            return t
        while self._inflight and self._inflight[0][0].query():
            self._inflight.popleft()
        pinned = t.pin_memory()
        obs.count("h2d_bytes", t.nbytes)
        out = pinned.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._inflight.append((ev, pinned))
        return out

    def pending(self) -> int:
        """Pinned buffers whose copies are not yet known to be done."""
        return len(self._inflight)


class DeviceStager:
    """Pipelines ``build → put → apply`` over a chunk sequence.

    ``put_fn`` is injectable so tests can substitute an instrumented fake
    and assert on :attr:`events` — the recorded call order proves chunk
    *i+1* is staged before chunk *i*'s apply result is consumed.  By
    default it is a :class:`PinnedPut` to ``device`` (the card unless the
    caller asks for ``"cpu"``).
    """

    def __init__(self, depth: int = 2,
                 put_fn: Callable[[Any], Any] | None = None,
                 prefetcher=None, device="cuda") -> None:
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.depth = int(depth)
        self.put_fn = (put_fn if put_fn is not None
                       else PinnedPut(resolve_device(device)))
        self.prefetcher = prefetcher
        self.events: list[tuple[str, int]] = []   # ("build"|"put"|"apply", i)

    def _put(self, host_chunk: Sequence[Any], idx: int) -> tuple:
        dev = tuple(self.put_fn(h) for h in host_chunk)
        self.events.append(("put", idx))
        return dev

    def _build(self, build_chunk, idx: int):
        host = build_chunk(idx)
        self.events.append(("build", idx))
        return host

    def stream(self, num_chunks: int, build_chunk: Callable[[int], Sequence],
               apply_chunk: Callable[[Any, tuple], Any], carry: Any) -> Any:
        """Fold ``apply_chunk`` over ``num_chunks`` staged chunks.

        ``build_chunk(i)`` produces the host arrays for chunk *i* (run on a
        prefetch worker when one is attached, overlapping the numpy pack
        with device compute); ``apply_chunk(carry, device_arrays)`` advances
        the chain.  Up to ``depth`` chunks are staged ahead of the apply
        cursor.
        """
        if num_chunks <= 0:
            return carry

        # one build kept in flight on a prefetch worker: consuming chunk
        # i's host arrays immediately kicks off chunk i+1's build, so the
        # numpy pack overlaps the put + kernel dispatch for chunk i
        ahead: tuple[int, Any] | None = None

        def kick(i: int) -> None:
            nonlocal ahead
            ahead = ((i, self.prefetcher.submit_fn(
                self._build, build_chunk, i))
                if self.prefetcher is not None and i < num_chunks else None)

        def obtain(i: int):
            nonlocal ahead
            if ahead is not None and ahead[0] == i:
                host = ahead[1].result()
            else:
                host = self._build(build_chunk, i)
            kick(i + 1)
            return host

        kick(0)
        staged: deque[tuple[int, tuple]] = deque()
        next_i = 0
        while staged or next_i < num_chunks:
            while next_i < num_chunks and len(staged) < self.depth:
                staged.append((next_i, self._put(obtain(next_i), next_i)))
                next_i += 1
            i, dev = staged.popleft()
            carry = apply_chunk(carry, dev)
            self.events.append(("apply", i))
        return carry
