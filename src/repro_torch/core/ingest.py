"""Streaming ingest pipeline with group commit and red/green epochs (§6).

The paper's system "maintain[s] the current state for ongoing updates"
while serving historical snapshot queries.  This module is that write
path at production rate:

* **Group commit** — live events batch into commit groups; each group is
  appended to a write-ahead log in the KV store (``⟨0, -2, wal.<start>⟩``
  keys, columnar-packed) and made durable with **one** durability barrier
  (:meth:`KVStore.sync`) per group, not one per event.  A group is *acked*
  only after its WAL record is synced — a crash before the sync loses
  only unacked events.

* **Epoch publish per group** — visibility is a cheap
  :meth:`DeltaGraph.clone_for_commit` (same skeleton, extended ``recent``)
  published atomically through the manager's
  :class:`~repro_torch.core.epoch.EpochRegistry`; readers pinned to an older
  epoch keep their exact ``recent`` tail.

* **Red/green rollover** — once ``recent`` reaches ``L`` events the
  full-leaf prefix is folded on a **shadow fork** of the skeleton
  (:meth:`DeltaGraph.fork`), optionally on a background worker thread,
  while readers keep querying the red version.  The green→red switch is
  one atomic epoch publish; superseded cap-delta payloads and pool pins
  are reclaimed only after every reader of the red epoch drains
  (deferred reclamation), and fully folded WAL groups are truncated once
  the new skeleton is durable.

Crash windows (exercised exhaustively by ``tests/test_ingest_faults.py``
via the :data:`CRASH_POINTS` checkpoints): pre-sync loses only unacked
events; post-sync/pre-publish recovers them from the WAL; a crash
anywhere inside the swap recovers either the old skeleton + full WAL or
the new skeleton + truncated WAL — never a half-built one, because the
skeleton record and the WAL truncation are ordered behind the data sync.
"""
from __future__ import annotations

import queue
import sys
import threading
import time
from collections import deque

import numpy as np

from ..storage import codec
from ..storage import columnar as col
from .deltagraph import DeltaGraph
from .epoch import EpochData
from .events import EventList, GraphUniverse

__all__ = ["IngestPipeline", "CRASH_POINTS", "recover_index"]

# WAL keys live beside the skeleton in the payload key space:
# ⟨partition 0, delta_id -2, "wal.<zero-padded global start position>"⟩.
WAL_DELTA_ID = -2
_WAL_PREFIX = "wal."

#: Named checkpoints the fault-injection harness can crash at
#: (tests/faultlib.py installs a hook raising at one of these).
CRASH_POINTS = (
    "commit:pre-append",     # before the WAL record is written at all
    "commit:pre-sync",       # WAL appended but not yet durable
    "commit:post-sync",      # durable, not yet visible (pre-publish)
    "commit:pre-publish",    # pool updated, epoch not yet published
    "rollover:pre-fold",     # before the green fork starts folding
    "rollover:pre-save",     # folded, new skeleton not yet written
    "rollover:post-save",    # skeleton durable, WAL not yet truncated
    "rollover:pre-publish",  # mid-swap: everything durable, red still live
)


def wal_key(start: int) -> tuple:
    return (0, WAL_DELTA_ID, f"{_WAL_PREFIX}{start:020d}")


def encode_wal_group(ev: EventList, start: int) -> bytes:
    # raw codec, always: WAL records live only until the next rollover
    # truncates them, so compression buys nothing — but the encode sits on
    # the group-commit path where every CPU cycle is commit latency (the
    # v2 varint path is ~100x slower per group).  decode_blob sniffs the
    # format, so recovery reads either encoding.
    return codec.encode_blob({
        "time": ev.time, "etype": ev.etype, "slot": ev.slot,
        "attr_col": ev.attr_col, "value": ev.value,
        "old_value": ev.old_value,
        "meta": np.asarray([start], np.int64)}, codec="raw")


def decode_wal_group(blob: bytes) -> tuple[EventList, int]:
    a = col.unpack_arrays(blob)
    ev = EventList(a["time"], a["etype"], a["slot"], a["attr_col"],
                   a["value"], a["old_value"])
    return ev, int(a["meta"][0])


def _wal_keys(store) -> list[tuple]:
    return [k for k in store.keys()
            if k[0] == 0 and k[1] == WAL_DELTA_ID
            and str(k[2]).startswith(_WAL_PREFIX)]


def recover_index(universe: GraphUniverse, store) -> DeltaGraph:
    """Reopen the index after a crash: load the last durable skeleton,
    rebuild the append machinery, and replay the WAL tail past the folded
    prefix.  Returns a DeltaGraph ready for both queries and appends —
    its ``recent`` holds every group-committed event not yet folded."""
    dg = DeltaGraph.load_skeleton(universe, store)
    for info in dg.nodes.values():
        # pool pins do not survive a restart
        info.materialized_as = None
        info.mat_node_cols = info.mat_edge_cols = None
    dg.restore_append_state()
    folded = dg.leaf_pos[-1]
    groups = []
    for key in _wal_keys(store):
        ev, start = decode_wal_group(store.get(key))
        groups.append((start, ev))
    groups.sort(key=lambda g: g[0])
    parts, pos = [], folded
    for start, ev in groups:
        end = start + len(ev)
        if end <= pos:          # fully folded group the truncation missed
            continue
        if start < pos:         # group straddling the folded boundary
            ev = ev[pos - start:]
            start = pos
        if start != pos:
            raise RuntimeError(
                f"WAL gap: have events up to {pos}, next group at {start}")
        parts.append(ev)
        pos = end
    dg.recent = EventList.concat(parts) if parts else EventList.empty()
    dg._total_events = pos
    return dg


class IngestPipeline:
    """Production-rate write path for one :class:`GraphManager`.

    Synchronous mode (default — what ``GraphManager.update`` shims onto)
    commits each ``append()`` as one group and folds rollovers inline.
    Threaded mode (``threaded=True``) runs a writer thread that coalesces
    ``submit()``-ed events into commit groups (up to ``group_events``
    events or ``group_window_s`` seconds) and folds rollovers on a
    background worker while commits continue.
    """

    def __init__(self, gm, *, group_events: int = 256,
                 group_window_s: float = 0.005, wal: bool = True,
                 auto_rollover: bool = True, threaded: bool = False) -> None:
        self.gm = gm
        self.group_events = int(group_events)
        self.group_window_s = float(group_window_s)
        self.wal = bool(wal)
        self.auto_rollover = bool(auto_rollover)
        self.threaded = bool(threaded)
        # test hook: callable(checkpoint_name), may raise to simulate a
        # crash at that point (tests/faultlib.py)
        self.crash_hook = None

        # serializes commit + publish (writer thread vs rollover worker)
        self._state_lock = threading.Lock()
        self._rollover_lock = threading.Lock()   # one fold at a time
        self._cv = threading.Condition()
        self.submitted_events = 0
        self.committed_events = 0
        self.groups_committed = 0
        self.rollovers = 0
        self.wal_bytes = 0
        #: per-group freshness lag seconds (enqueue → epoch publish)
        self.freshness_lags: deque[float] = deque(maxlen=4096)
        self._error: BaseException | None = None
        self._baseline_done = False

        self._q: queue.Queue = queue.Queue()
        self._stop = False
        self._writer: threading.Thread | None = None
        self._roll_worker: threading.Thread | None = None
        self._roll_wanted = threading.Event()
        self._roll_inflight = False
        self._old_switch: float | None = None
        if self.threaded:
            # background writer/rebuild threads share the interpreter with
            # latency-sensitive readers; the default ~5 ms forced-switch
            # interval lets one CPU burst stall a whole query.  Tighten it
            # well below a typical sub-ms query while the pipeline is live
            # (restored in close()) so a contending reader interleaves at
            # fine grain instead of waiting out writer bursts.
            self._old_switch = sys.getswitchinterval()
            sys.setswitchinterval(0.0002)
            self._writer = threading.Thread(target=self._writer_loop,
                                            name="ingest-writer", daemon=True)
            self._writer.start()
            self._roll_worker = threading.Thread(target=self._roll_loop,
                                                 name="ingest-rebuild",
                                                 daemon=True)
            self._roll_worker.start()

    # ------------------------------------------------------------ helpers
    def _checkpoint(self, name: str) -> None:
        hook = self.crash_hook
        if hook is not None:
            hook(name)

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            raise RuntimeError("ingest pipeline failed") from self._error

    def _ensure_baseline(self) -> None:
        """First use with WAL enabled: persist the build-time skeleton and
        WAL the build-time ``recent`` tail so recovery has a floor even if
        no rollover ever happens."""
        if self._baseline_done or not self.wal:
            return
        self._baseline_done = True
        gm = self.gm
        if (0, -1, "skeleton") in gm.store:
            return
        dg = gm.epochs.current_data.dg
        dg.save_skeleton()
        if len(dg.recent):
            start = dg._total_events - len(dg.recent)
            gm.store.put(wal_key(start), encode_wal_group(dg.recent, start))
        gm.store.sync()

    def _publish_locked(self, data: EpochData, reclaims=()) -> None:
        """Atomic epoch swap + re-point of everything that dereferences
        ``gm.dg`` directly (legacy callers, the advisor).  Caller holds
        ``_state_lock``."""
        gm = self.gm
        gm.epochs.publish(data, reclaims)
        gm.dg = data.dg
        with gm._advisor_lock:
            if gm.advisor is not None:
                gm.advisor.dg = data.dg

    def _yield_gil(self) -> None:
        """Hand the GIL to concurrent readers between commit steps.  The
        whole commit burst is ~1-2 ms of CPU; without explicit yields a
        reader mid-query waits out the burst (the interpreter only forces
        a switch every ~5 ms), which shows up directly in query p99 on
        few-core boxes.  ``sleep(0)`` is not enough: the releaser usually
        re-acquires the GIL before the waiter wakes, so we block for a
        real (but tiny) interval.  Readers never take ``_state_lock``, so
        yielding while holding it is safe."""
        if self.threaded:
            time.sleep(0.0005)

    # ------------------------------------------------------------- commit
    def _commit_group(self, ev: EventList, t_enqueue: float | None) -> None:
        if not len(ev):
            return
        gm = self.gm
        with self._state_lock:
            self._ensure_baseline()
            data = gm.epochs.current_data
            start = data.n_events
            self._checkpoint("commit:pre-append")
            if self.wal:
                key = wal_key(start)
                blob = encode_wal_group(ev, start)
                self._yield_gil()
                gm.store.put(key, blob)
                self._checkpoint("commit:pre-sync")
                gm.store.sync()                      # the durability point
                self.wal_bytes += len(blob)
            self._checkpoint("commit:post-sync")
            self._yield_gil()
            gm.pool.update_current(ev)
            self._yield_gil()
            new_dg = data.dg.clone_for_commit(ev)
            self._checkpoint("commit:pre-publish")
            new_data = EpochData(new_dg, start + len(ev),
                                 max(data.max_time, int(ev.time.max())))
            self._publish_locked(new_data)
            # scoped invalidation: only cached results a time-overlapping
            # append can change (see SnapshotCache.invalidate_from)
            if gm.cache is not None:
                gm.cache.invalidate_from(int(ev.time.min()))
                gm.cache.invalidate_epochs_before(gm.epochs.current_id)
        with self._cv:
            self.committed_events += len(ev)
            self.groups_committed += 1
            self._cv.notify_all()
        if t_enqueue is not None:
            self.freshness_lags.append(time.perf_counter() - t_enqueue)
        if self.auto_rollover and len(new_dg.recent) >= new_dg.L:
            if self.threaded:
                self._roll_wanted.set()
            else:
                self._rollover()

    # ----------------------------------------------------------- rollover
    def _rollover(self) -> None:
        """Fold every full leaf of ``recent`` on a green fork of the
        skeleton, then swap it in with one epoch publish."""
        gm = self.gm
        with self._rollover_lock:
            base = gm.epochs.current_data.dg
            if len(base.recent) < base.L:
                return
            self._checkpoint("rollover:pre-fold")
            green = base.fork()
            sink: list = []
            green.reclaim_sink = sink
            if self.threaded:
                # The fold runs on the rebuild worker but shares the GIL
                # with latency-sensitive readers, so between fold steps it
                # sleeps long enough that readers own the core while the
                # backlog is small (see _yield_gil for why sleep(0) won't
                # do).  Politeness is graduated: the sleep shrinks linearly
                # as the unfolded backlog approaches ~2 leaves and vanishes
                # past it, so fold throughput self-tunes to the offered
                # write rate instead of oscillating between a fixed nap
                # and a full-speed panic fold.
                reg = gm.epochs
                backlog_cap = 2 * base.L

                def _nice_sleep() -> None:
                    frac = len(reg.current_data.dg.recent) / backlog_cap
                    if frac < 1.0:
                        time.sleep(0.004 * (1.0 - frac))

                green.nice = _nice_sleep
                # also yield between individual array encodes — a single
                # pack_arrays() over leaf-sized arrays is otherwise the
                # longest GIL hold of the whole fold.  Cleared in the
                # finally below (per-thread hook, crash tests raise here).
                codec.set_encode_nice(_nice_sleep)
            try:
                self._rollover_body(green, sink)
            finally:
                codec.set_encode_nice(None)
                green.nice = None

    def _rollover_body(self, green, sink: list) -> None:
        gm = self.gm
        forked_len = len(green.recent)
        green.append_events(EventList.empty())   # folds full chunks
        n_folded = forked_len - len(green.recent)
        green.reclaim_sink = None
        self.rollovers += 1
        with self._state_lock:
            latest = gm.epochs.current_data
            # splice commits that landed while the fold ran: red's
            # recent is (forked recent + appended groups), the fold
            # consumed the first n_folded of it
            green.recent = latest.dg.recent[n_folded:]
            green._total_events = latest.dg._total_events
            green._last_leaf_state = \
                green._last_leaf_state.resized(green.universe)
            self._checkpoint("rollover:pre-save")
            if self.wal:
                # green.nice is still set: save_skeleton yields between
                # its phases too (it is the last multi-ms CPU stretch
                # before the swap)
                self._yield_gil()
                green.save_skeleton()
                self._yield_gil()
                gm.store.sync()                  # skeleton durable
            green.nice = None        # published dg carries no hook
            self._checkpoint("rollover:post-save")
            folded_pos = green.leaf_pos[-1]
            if self.wal:
                # truncate fully folded groups — recovery now starts
                # from the just-saved skeleton.  Groups are contiguous,
                # so a group ends where the next one starts; the last
                # group's end is unknown from its key alone, so it is
                # conservatively kept (recovery skips folded records).
                wkeys = sorted(_wal_keys(gm.store))
                starts = [int(str(k[2])[len(_WAL_PREFIX):])
                          for k in wkeys]
                for i, k in enumerate(wkeys[:-1]):
                    if starts[i + 1] <= folded_pos:
                        gm.store.delete(k)
            reclaims = []
            if sink:
                store = gm.store
                dead_keys = list(sink)
                reclaims.append(lambda: [store.delete(k)
                                         for k in dead_keys])
            # pins on cap nodes the fold tore down: unpin now (new
            # plans must not route through them), release the pool
            # graphs only once pinned readers drain
            with gm._advisor_lock:
                adv = gm.advisor
                stale_pins = {}
                if adv is not None:
                    for nid in [n for n in adv.pinned
                                if n not in green.nodes]:
                        stale_pins[nid] = adv.pinned.pop(nid)
                if stale_pins:
                    pool = gm.pool
                    gids = list(stale_pins.values())
                    reclaims.append(lambda: [pool.release(g)
                                             for g in gids])
                    if gm.cache is not None:
                        gm.cache.invalidate_deps(list(stale_pins))
            self._checkpoint("rollover:pre-publish")
            self._publish_locked(
                EpochData(green, latest.n_events, latest.max_time),
                reclaims)
            gm.pool.mark_flushed()
            if gm.cache is not None:
                gm.cache.invalidate_epochs_before(gm.epochs.current_id)

    # -------------------------------------------------------- public API
    def append(self, ev: EventList) -> None:
        """Synchronous ingest of one event batch as one commit group (the
        ``GraphManager.update`` shim).  Returns after the group is durable
        and visible; rollovers fold inline (sync mode) or are scheduled
        (threaded mode)."""
        self._raise_if_failed()
        if self.threaded:
            self.submit(ev)
            self.drain()
            return
        t0 = time.perf_counter()
        with self._cv:
            self.submitted_events += len(ev)
        self._commit_group(ev, t0)

    def submit(self, ev: EventList) -> None:
        """Enqueue events for the writer thread (threaded mode); returns
        immediately.  In sync mode this is :meth:`append`."""
        self._raise_if_failed()
        if not self.threaded:
            self.append(ev)
            return
        with self._cv:
            self.submitted_events += len(ev)
        self._q.put((ev, time.perf_counter()))

    def drain(self, timeout: float | None = 30.0) -> None:
        """Block until every submitted event is committed and no rollover
        is in flight."""
        deadline = (time.monotonic() + timeout) if timeout else None
        with self._cv:
            while True:
                self._raise_if_failed()
                if (self.committed_events >= self.submitted_events
                        and not self._roll_inflight
                        and not self._roll_wanted.is_set()):
                    return
                remaining = ((deadline - time.monotonic())
                             if deadline else None)
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("ingest drain timed out")
                self._cv.wait(timeout=remaining)

    def close(self) -> None:
        """Stop worker threads (threaded mode).  Does not flush the store;
        the owning manager's ``close()`` does."""
        self._stop = True
        if self._writer is not None:
            self._q.put(None)
            self._writer.join(timeout=10)
            self._writer = None
        if self._roll_worker is not None:
            self._roll_wanted.set()
            self._roll_worker.join(timeout=10)
            self._roll_worker = None
        if self._old_switch is not None:
            sys.setswitchinterval(self._old_switch)
            self._old_switch = None

    def stats(self) -> dict:
        lags = list(self.freshness_lags)
        return {"submitted_events": self.submitted_events,
                "committed_events": self.committed_events,
                "groups_committed": self.groups_committed,
                "rollovers": self.rollovers,
                "wal_bytes": self.wal_bytes,
                "freshness_lag_mean_ms": (1e3 * float(np.mean(lags))
                                          if lags else None),
                "freshness_lag_p99_ms": (1e3 * float(np.quantile(lags, 0.99))
                                         if lags else None),
                "epochs": self.gm.epochs.stats()}

    # -------------------------------------------------------- worker loops
    def _writer_loop(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._stop:
                    return
                continue
            if item is None:
                return
            chunks = [item[0]]
            t_enq = item[1]
            n = len(item[0])
            deadline = time.perf_counter() + self.group_window_s
            while n < self.group_events:
                budget = deadline - time.perf_counter()
                if budget <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=budget)
                except queue.Empty:
                    break
                if nxt is None:
                    self._stop = True
                    break
                chunks.append(nxt[0])
                n += len(nxt[0])
            group = (chunks[0] if len(chunks) == 1
                     else EventList.concat(chunks))
            try:
                self._commit_group(group, t_enq)
            except BaseException as e:   # noqa: BLE001 - surfaced via drain
                self._error = e
                with self._cv:
                    self._cv.notify_all()
                return
            if self._stop and self._q.empty():
                return

    def _roll_loop(self) -> None:
        while True:
            self._roll_wanted.wait()
            if self._stop:
                return
            with self._cv:
                self._roll_inflight = True
            self._roll_wanted.clear()
            try:
                while True:
                    dg = self.gm.epochs.current_data.dg
                    if len(dg.recent) < dg.L:
                        break
                    self._rollover()
            except BaseException as e:   # noqa: BLE001
                self._error = e
            finally:
                with self._cv:
                    self._roll_inflight = False
                    self._cv.notify_all()
