"""The port's ingest pipeline, epochs and manager lifecycle against the JAX
package's, on the CPU.

A seeded history from the JAX package's generator is carried into the port
through ``interop``.  Held equal between the packages and to ``replay``:

* after the same stream of ``GraphManager.update`` chunks (leaf rollovers
  included): event counts, epochs, leaves, skeleton statistics and
  snapshots with attributes;
* crash recovery at every named checkpoint of ``core/ingest.py``
  (``tests/faultlib.py``'s injector and power failure, which take the
  pipeline and the store as arguments): the same recovered, group-aligned
  prefix in both packages, answering like a replay of that prefix, and
  ingest resuming to the end;
* a threaded writer racing readers: every answer equal to a replay of the
  prefix its pinned epoch names;
* lifecycle: create/close loops leave no threads, ``close`` is idempotent,
  queries after close still answer.
"""
from __future__ import annotations

import contextlib
import tempfile
import threading
import time

import numpy as np
import pytest

from repro.core.manager import GraphManager as JGraphManager
from repro.data.generators import random_history as j_random_history
from repro.storage.kv import LogFileKV as JLogFileKV

from repro_torch.api import Q
from repro_torch.core import EventList, GraphManager, replay
from repro_torch.core.ingest import CRASH_POINTS, IngestPipeline
from repro_torch.core.query import AttrOptions
from repro_torch.interop import build_universe, event_arrays, universe_arrays
from repro_torch.storage.kv import LogFileKV

from faultlib import CrashInjector, InjectedCrash, power_fail

CPU = "cpu"
N_BUILD = 100
N_TOTAL = 600
L = 48


def carry(juni, jev):
    """A JAX-package history as the port's universe and events."""
    return (build_universe(universe_arrays(juni)),
            EventList(**event_arrays(jev)))


def _history(n, seed):
    juni, jev = j_random_history(n, seed)
    return carry(juni, jev), (juni, jev)


def _chunks(n0: int, n1: int, seed: int) -> list[tuple[int, int]]:
    """Deterministic odd-sized chunk boundaries over [n0, n1)."""
    rng = np.random.default_rng(seed)
    out, i = [], n0
    while i < n1:
        j = min(n1, i + int(rng.integers(3, 41)))
        out.append((i, j))
        i = j
    return out


def _opts(uni) -> AttrOptions:
    return AttrOptions(node_cols=tuple(range(uni.num_node_attrs)),
                       edge_cols=tuple(range(uni.num_edge_attrs)))


def _state_error(got, want, tag) -> str | None:
    if not (np.array_equal(got.node_mask, want.node_mask)
            and np.array_equal(got.edge_mask, want.edge_mask)):
        return f"{tag}: mask mismatch"
    if not (np.allclose(got.node_attrs, want.node_attrs, equal_nan=True)
            and np.allclose(got.edge_attrs, want.edge_attrs,
                            equal_nan=True)):
        return f"{tag}: attr mismatch"
    return None


def _check_prefix(gm, uni, ev, n: int, times, jgm=None) -> None:
    """The index answers like a replay of ``ev[:n]`` (and like the JAX
    package's manager ``jgm`` on the same stream)."""
    opts = _opts(uni)
    for t in times:
        got = gm.get_snapshot(int(t), opts)
        err = _state_error(got, replay(uni, ev[:n], int(t)), f"t={t}")
        assert err is None, err
        if jgm is not None:
            want = jgm.get_snapshot(int(t), jgm._parse_opts(
                "+node:all+edge:all"))
            assert _state_error(got, want, f"jax t={t}") is None


def _abandon(gm) -> None:
    """Drop a crashed manager without flushing its (dead) store."""
    with contextlib.suppress(Exception):
        if gm._ingest is not None:
            gm._ingest.close()
    with contextlib.suppress(Exception):
        if gm.prefetcher is not None:
            gm.prefetcher.close(wait=False)


def test_update_stream_matches_jax():
    """The same chunked update stream (several leaf rollovers) gives the
    same index and the same snapshots in both packages."""
    (uni, ev), (juni, jev) = _history(N_TOTAL, 31)
    gm = GraphManager(uni, ev[:N_BUILD], L=L, k=2, device=CPU)
    jgm = JGraphManager(juni, jev[:N_BUILD], L=L, k=2)
    for i, j in _chunks(N_BUILD, N_TOTAL, seed=5):
        gm.update(ev[i:j])
        jgm.update(jev[i:j])
    assert gm.dg._total_events == jgm.dg._total_events == N_TOTAL
    assert gm.ingest.rollovers == jgm.ingest.rollovers > 0
    assert gm.ingest.committed_events == jgm.ingest.committed_events
    assert gm.epochs.current_id == jgm.epochs.current_id
    assert len(gm.dg.leaf_nids) == len(jgm.dg.leaf_nids)
    assert gm.dg.skeleton_stats() == jgm.dg.skeleton_stats()
    assert (gm.store.stats.puts, gm.store.stats.bytes_written) == (
        jgm.store.stats.puts, jgm.store.stats.bytes_written)
    tmax = int(ev.time.max()) + 2
    times = sorted({int(t) for t in np.random.default_rng(7).integers(
        0, tmax, size=8)} | {tmax - 1})
    _check_prefix(gm, uni, ev, N_TOTAL, times, jgm)
    gm.close()
    jgm.close()


def _crash_run(make_manager, recover, ev, point, chunks):
    """Feed ``chunks`` to ``make_manager(store_dir)`` until ``point``
    fires, power-fail, ``recover(store_dir)``; returns ``(recovered
    manager, recovered event count, acked, fed)``."""
    tmp = tempfile.mkdtemp()
    gm = make_manager(tmp)
    pipe = gm.ingest
    inj = CrashInjector(point).arm(pipe)
    fed = N_BUILD
    with pytest.raises(InjectedCrash):
        for i, j in chunks:
            gm.update(ev[i:j])
            fed = j
    assert inj.fired
    acked = N_BUILD + pipe.committed_events
    store_dir = power_fail(gm.store)
    _abandon(gm)
    gm2 = recover(store_dir)
    return gm2, gm2.dg._total_events, acked, fed


@pytest.mark.parametrize("point", CRASH_POINTS)
def test_crash_recovery_at_every_checkpoint(point):
    (uni, ev), (juni, jev) = _history(N_TOTAL, 31)
    chunks = _chunks(N_BUILD, N_TOTAL, seed=5)
    gm2, n, acked, fed = _crash_run(
        lambda d: GraphManager(uni, ev[:N_BUILD], L=L, k=2,
                               store=LogFileKV(d), device=CPU),
        lambda d: GraphManager.open(uni, LogFileKV(d), device=CPU),
        ev, point, chunks)
    jgm2, jn, _, _ = _crash_run(
        lambda d: JGraphManager(juni, jev[:N_BUILD], L=L, k=2,
                                store=JLogFileKV(d)),
        lambda d: JGraphManager.open(juni, JLogFileKV(d)),
        jev, point, chunks)
    try:
        assert n == jn, (point, n, jn)
        # durability: every acked event survived; nothing invented
        assert n >= acked, (point, n, acked)
        assert n <= fed + (chunks[0][1] - chunks[0][0]) + 64
        # atomicity: the survivor prefix is group-aligned
        assert n in {N_BUILD} | {j for _, j in chunks}, (point, n)
        rng = np.random.default_rng(7)
        tmax = int(ev.time.max()) + 2
        times = sorted({int(t) for t in rng.integers(0, tmax, size=6)})
        _check_prefix(gm2, uni, ev, n, times, jgm2)
        # liveness: resume ingest from the recovered position to the end
        for i, j in chunks:
            if j > n:
                gm2.update(ev[max(i, n):j])
        assert gm2.dg._total_events == N_TOTAL
        _check_prefix(gm2, uni, ev, N_TOTAL, times)
    finally:
        gm2.close()
        jgm2.close()


def test_unsynced_wal_record_is_torn_away():
    """A crash after the WAL put but before the sync loses exactly that
    group: recovery lands on the previous commit boundary."""
    (uni, ev), _ = _history(300, 17)
    tmp = tempfile.mkdtemp()
    gm = GraphManager(uni, ev[:N_BUILD], L=1000, k=2, store=LogFileKV(tmp),
                      device=CPU)
    pipe = gm.ingest
    gm.update(ev[N_BUILD:150])                      # one durable group
    CrashInjector("commit:pre-sync").arm(pipe)
    with pytest.raises(InjectedCrash):
        gm.update(ev[150:200])                      # put, never synced
    store_dir = power_fail(gm.store)
    _abandon(gm)
    gm2 = GraphManager.open(uni, LogFileKV(store_dir), device=CPU)
    assert gm2.dg._total_events == 150
    _check_prefix(gm2, uni, ev, 150, [0, int(ev.time[149]) + 1])
    gm2.close()


def test_readers_see_consistent_epochs_during_ingest():
    """A threaded writer with rollovers; point readers' answers equal a
    replay of the prefix their pinned epoch names."""
    (uni, ev), _ = _history(900, 41)
    gm = GraphManager(uni, ev[:N_BUILD], L=L, k=2, device=CPU)
    pipe = IngestPipeline(gm, group_events=32, group_window_s=0.002,
                          threaded=True)
    gm._ingest = pipe
    svc = gm.query
    tmax = int(ev.time.max()) + 2
    errors: list[str] = []
    checks = [0, 0]
    stop = threading.Event()

    def reader(idx: int) -> None:
        rng = np.random.default_rng(100 + idx)
        while not stop.is_set():
            ts = sorted({int(t) for t in rng.integers(0, tmax, size=3)})
            r = svc.run(Q.at(ts).attrs("+node:all+edge:all").build())
            ne = r.stats["epoch_events"]
            for t, got in r.value.items():
                err = _state_error(got, replay(uni, ev[:ne], int(t)),
                                   f"t={t} ne={ne}")
                if err:
                    errors.append(err)
            checks[idx] += 1

    readers = [threading.Thread(target=reader, args=(i,)) for i in (0, 1)]
    for r in readers:
        r.start()
    try:
        rng = np.random.default_rng(0)
        i = N_BUILD
        while i < len(ev):
            j = min(len(ev), i + int(rng.integers(5, 40)))
            pipe.submit(ev[i:j])
            i = j
            time.sleep(0.001)
        pipe.drain(timeout=60)
    finally:
        stop.set()
        for r in readers:
            r.join(timeout=30)
    assert not errors, errors[:10]
    assert all(c > 0 for c in checks), checks
    assert pipe.rollovers > 0
    est = gm.epochs.stats()
    assert est["current_refs"] == 0 and est["retired_pending"] == 0, est
    gm.close()


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------


def _settled_thread_count(deadline_s: float = 5.0) -> int:
    last = threading.active_count()
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        time.sleep(0.05)
        cur = threading.active_count()
        if cur == last:
            return cur
        last = cur
    return last


def test_create_close_loop_stable_threads():
    (uni, ev), _ = _history(800, 3)
    base = _settled_thread_count()
    for i in range(3):
        gm = GraphManager(uni, ev[:600], L=48, k=2, diff_fn="intersection",
                          device=CPU)
        gm.get_snapshots([10, 40, 80, 120])     # spawns the prefetch pool
        gm._ingest = IngestPipeline(gm, group_events=64, threaded=True)
        gm._ingest.submit(ev[600:800])
        gm._ingest.drain(timeout=30.0)
        gm.close()
        assert gm.closed and gm._ingest is None and gm.prefetcher is None
        gm.close()                              # idempotent
        assert _settled_thread_count() == base, f"leak on cycle {i}"


def test_context_manager_and_queries_after_close():
    (uni, ev), _ = _history(400, 9)
    with GraphManager(uni, ev, L=64, k=2, device=CPU) as gm:
        gm.get_snapshots([10, 40])
    assert gm.closed
    base = _settled_thread_count()
    st = gm.get_snapshots([10, 40, 80], "+node:all+edge:all")
    assert len(st) == 3
    for t, s in st.items():
        assert _state_error(s, replay(uni, ev, t), t) is None
    assert _settled_thread_count() == base
