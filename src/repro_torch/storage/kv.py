"""Persistent key-value backends (paper §4.2).

The paper stores every delta / eventlist component under the key
``⟨partition_id, delta_id, component⟩`` in Kyoto Cabinet, and notes that any
get/put store (HBase, Cassandra, ...) can be plugged in.  We keep exactly
that contract: keys are ``(partition_id: int, delta_id: int, component:
str)``, values are opaque bytes.  Four backends:

* :class:`MemKV` — dict-backed (the "cloud cache" stand-in; also used by
  unit tests).
* :class:`LogFileKV` — a single append-only log + JSON offset index per
  directory.  Append-only gives crash-safe writes (torn tails are dropped on
  recovery) — this is also what the fault-tolerant checkpointer builds on.
  Deletes and overwrites leave dead records; :meth:`LogFileKV.compact`
  rewrites the live set and atomically swaps the log (auto-triggered by a
  dead-bytes ratio), so the store no longer grows without bound.
* :class:`TieredKV` — a byte-budgeted hot in-memory blob cache over a cold
  backend (typically :class:`LogFileKV`).  Blobs stay compressed-at-rest in
  *both* tiers (the codec layer owns decompression), so the hot budget buys
  ``compression_ratio×`` more working set than caching decoded arrays
  would.  Admission is versioned: a get that races a concurrent overwrite
  can never install — or serve, once the put returned — a stale blob.
* :class:`PartitionedKV` — routes by ``partition_id`` to one backend per
  storage unit (the paper's one-Kyoto-instance-per-machine deployment).

All backends record byte-level read/write counters so benchmarks can report
fetched bytes (the planner's cost model is bytes fetched + decoded).

``store_from_env()`` builds the default store for the ``GraphManager``
façade (not yet ported) from ``REPRO_KV``
(``mem`` | ``logfile`` | ``tiered``), ``REPRO_KV_DIR`` and
``REPRO_KV_HOT_MB`` — CI runs a test subset with ``REPRO_KV=logfile`` so
the disk tier is exercised on every push.
"""
from __future__ import annotations

import atexit
import json
import os
import shutil
import struct
import tempfile
import threading
from collections import OrderedDict
from typing import Iterable

Key = tuple[int, int, str]


def _key_str(key: Key) -> str:
    p, d, c = key
    return f"{p}/{d}/{c}"


def mget_optional(store: "KVStore", keys: list) -> list:
    """Batched get where a missing key yields ``None`` (a component created
    before its column existed).  One protocol shared by the synchronous
    executor path and the async prefetcher — they must decode identically.
    Delegates to :meth:`KVStore.mget` so batching-aware backends (a remote
    shard server, the tiered cache) answer the whole list in one round
    trip instead of a get per key."""
    return store.mget(keys)


class KVStats:
    """Byte/op counters, lock-protected: the async prefetcher
    (``runtime/executor.py``) drives gets from a thread pool, and unlocked
    ``+=`` would drop increments under contention.

    ``hot_hits`` / ``hot_misses`` are populated by tiered backends only:
    every get is exactly one of the two, so
    ``gets == hot_hits + hot_misses`` is a checkable invariant under
    concurrency (``tests/test_executor_stress.py``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.gets = 0
        self.puts = 0
        self.bytes_read = 0
        self.bytes_written = 0
        self.hot_hits = 0
        self.hot_misses = 0

    def add_get(self, nbytes: int, hot: bool | None = None) -> None:
        with self._lock:
            self.gets += 1
            self.bytes_read += nbytes
            if hot is True:
                self.hot_hits += 1
            elif hot is False:
                self.hot_misses += 1

    def add_put(self, nbytes: int) -> None:
        with self._lock:
            self.puts += 1
            self.bytes_written += nbytes

    def reset(self) -> None:
        with self._lock:
            self.gets = self.puts = 0
            self.bytes_read = self.bytes_written = 0
            self.hot_hits = self.hot_misses = 0


class AggregateKVStats:
    """Read-only aggregating view over several backends' ``KVStats`` —
    ``PartitionedKV.stats``.  Summing on read (instead of double-counting
    at the router) means bytes fetched by code that talks to a backend
    directly are still reported, and there is no per-call router overhead."""

    def __init__(self, parts: list["KVStore"]) -> None:
        self._parts = parts

    def _sum(self, field: str) -> int:
        return sum(getattr(p.stats, field) for p in self._parts)

    @property
    def gets(self) -> int:
        return self._sum("gets")

    @property
    def puts(self) -> int:
        return self._sum("puts")

    @property
    def bytes_read(self) -> int:
        return self._sum("bytes_read")

    @property
    def bytes_written(self) -> int:
        return self._sum("bytes_written")

    @property
    def hot_hits(self) -> int:
        return self._sum("hot_hits")

    @property
    def hot_misses(self) -> int:
        return self._sum("hot_misses")

    def reset(self) -> None:
        for p in self._parts:
            p.stats.reset()


class KVStore:
    """get/put/contains/delete over (partition_id, delta_id, component)."""

    def __init__(self) -> None:
        self.stats = KVStats()

    def get(self, key: Key) -> bytes:
        raise NotImplementedError

    def put(self, key: Key, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: Key) -> None:
        raise NotImplementedError

    def __contains__(self, key: Key) -> bool:
        raise NotImplementedError

    def keys(self) -> Iterable[Key]:
        raise NotImplementedError

    def multi_get(self, keys: list[Key]) -> list[bytes]:
        """Batched fetch — single round-trip in a real remote store."""
        return [self.get(k) for k in keys]

    def mget(self, keys: list[Key]) -> list:
        """Batched fetch with ``None`` for missing keys (the
        :func:`mget_optional` protocol).  Backends that can answer a whole
        batch in one round trip (remote stores, the tiered cache) override
        this; the default is a per-key loop."""
        out = []
        for k in keys:
            try:
                out.append(self.get(k))
            except KeyError:
                out.append(None)
        return out

    def total_bytes(self) -> int:
        return sum(len(self.get(k)) for k in self.keys())

    def flush(self) -> None:
        pass

    def sync(self) -> None:
        """Durability barrier: on return, every preceding ``put`` survives a
        process or power crash.  Unlike :meth:`flush` this does *not* have
        to persist derived metadata (e.g. the log index) — backends may
        implement it as a bare data fsync and rely on recovery to rebuild
        the rest.  Default delegates to :meth:`flush`."""
        self.flush()

    def put_group(self, pairs: Iterable[tuple[Key, bytes]]) -> None:
        """Group commit (§6 ingest): write every pair, then pay **one**
        durability barrier for the whole group — the write pipeline's
        fsync-per-group surface (vs. fsync-per-event via put+sync)."""
        for k, v in pairs:
            self.put(k, v)
        self.sync()

    def close(self) -> None:
        pass


class MemKV(KVStore):
    def __init__(self) -> None:
        super().__init__()
        self._d: dict[Key, bytes] = {}

    def get(self, key: Key) -> bytes:
        v = self._d[key]
        self.stats.add_get(len(v))
        return v

    def put(self, key: Key, value: bytes) -> None:
        self._d[key] = bytes(value)
        self.stats.add_put(len(value))

    def delete(self, key: Key) -> None:
        self._d.pop(key, None)

    def __contains__(self, key: Key) -> bool:
        return key in self._d

    def keys(self):
        return list(self._d.keys())

    def total_bytes(self) -> int:
        return sum(len(v) for v in self._d.values())


_MAGIC = b"RKV1"
_TOMBSTONE = 0xFFFFFFFFFFFFFFFF   # vallen sentinel: a delete record


class LogFileKV(KVStore):
    """Append-only log file + offset index.

    Record layout: ``[magic][u32 keylen][key utf8][u64 vallen][value]``;
    a ``vallen`` of ``_TOMBSTONE`` (no value bytes) records a delete, so
    a full log scan reconstructs the exact live set — deletes are as
    durable as puts and can never resurrect.  The index (`index.json`)
    is written on flush; on open, the log is scanned from the last
    indexed offset so an unflushed-but-complete tail is recovered and a
    torn (partially written) tail record is truncated — the
    crash-consistency story for checkpointing.

    Overwrites and deletes strand dead records in the log;
    ``_dead_bytes`` tracks the stranded volume and :meth:`compact`
    reclaims it: live records are rewritten into ``kv.log.compact``
    (fsynced), the on-disk index is *invalidated* (a stale index must
    never pair with the new log's offsets), then ``os.replace`` swaps
    the log in — the commit point — and a fresh index is written last.
    A crash before the swap leaves a log whose full scan yields the old
    live set (the stray ``.compact`` file is discarded on reopen); a
    crash after it leaves the new log with no index, which recovery
    rebuilds from a full scan — every window is crash-safe
    (``tests/test_storage.py``).
    """

    def __init__(self, directory: str, *, auto_compact: bool = True,
                 compact_ratio: float = 0.5,
                 compact_min_bytes: int = 1 << 20) -> None:
        super().__init__()
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.log_path = os.path.join(directory, "kv.log")
        self.index_path = os.path.join(directory, "index.json")
        self.auto_compact = bool(auto_compact)
        self.compact_ratio = float(compact_ratio)
        self.compact_min_bytes = int(compact_min_bytes)
        self.compactions = 0
        self._index: dict[str, tuple[int, int]] = {}  # key -> (offset, length)
        # compact() runs under the same lock put/delete hold when they
        # auto-trigger it — reentrant by design
        self._lock = threading.RLock()
        stray = self.log_path + ".compact"   # compaction that died pre-commit
        if os.path.exists(stray):
            os.remove(stray)
        self._recover()
        # high-water mark of bytes known durable (fsynced); bytes past it
        # would be lost by a power crash — tests/faultlib.py truncates to
        # this point to model one
        self._synced_size = self._log_size
        self._fh = open(self.log_path, "ab")
        self._rfh = open(self.log_path, "rb")

    def _recover(self) -> None:
        indexed_end = 0
        if os.path.exists(self.index_path):
            with open(self.index_path) as f:
                payload = json.load(f)
            self._index = {k: tuple(v) for k, v in payload["index"].items()}
            indexed_end = payload["log_end"]
        if not os.path.exists(self.log_path):
            open(self.log_path, "wb").close()
            self._log_size = 0
            self._dead_bytes = 0
            return
        size = os.path.getsize(self.log_path)
        if size < indexed_end:  # corrupt index — rebuild from scratch
            self._index = {}
            indexed_end = 0
        with open(self.log_path, "rb") as f:
            f.seek(indexed_end)
            pos = indexed_end
            good_end = indexed_end
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                magic, klen = hdr[:4], struct.unpack("<I", hdr[4:8])[0]
                if magic != _MAGIC:
                    break
                kb = f.read(klen)
                vl = f.read(8)
                if len(kb) < klen or len(vl) < 8:
                    break
                vlen = struct.unpack("<Q", vl)[0]
                voff = pos + 8 + klen + 8
                if vlen == _TOMBSTONE:       # delete record: no value bytes
                    pos = voff
                    self._index.pop(kb.decode(), None)
                    good_end = pos
                    continue
                f.seek(vlen, os.SEEK_CUR)
                pos = voff + vlen
                if f.tell() != pos:
                    break
                self._index[kb.decode()] = (voff, vlen)
                good_end = pos
        if os.path.getsize(self.log_path) != good_end:
            with open(self.log_path, "r+b") as f:  # drop torn tail
                f.truncate(good_end)
        self._log_size = good_end
        self._dead_bytes = max(0, good_end - self._live_bytes())

    def _live_bytes(self) -> int:
        return sum(self._rec_len(k, ln) for k, (_, ln) in self._index.items())

    @staticmethod
    def _rec_len(key_str: str, vlen: int) -> int:
        return 8 + len(key_str.encode()) + 8 + vlen

    @property
    def dead_bytes(self) -> int:
        return self._dead_bytes

    def dead_ratio(self) -> float:
        with self._lock:
            return self._dead_bytes / max(self._log_size, 1)

    def put(self, key: Key, value: bytes) -> None:
        ks = _key_str(key)
        kb = ks.encode()
        with self._lock:
            self._fh.seek(0, os.SEEK_END)
            pos = self._fh.tell()
            self._fh.write(_MAGIC + struct.pack("<I", len(kb)) + kb
                           + struct.pack("<Q", len(value)) + value)
            old = self._index.get(ks)
            if old is not None:
                self._dead_bytes += self._rec_len(ks, old[1])
            self._index[ks] = (pos + 8 + len(kb) + 8, len(value))
            self._log_size = pos + 8 + len(kb) + 8 + len(value)
            self._maybe_compact()
        self.stats.add_put(len(value))

    def get(self, key: Key) -> bytes:
        # index lookup + file read under one lock: compact() swaps both
        # the offsets and the backing file atomically w.r.t. readers
        with self._lock:
            off, length = self._index[_key_str(key)]
            self._fh.flush()
            self._rfh.seek(off)
            v = self._rfh.read(length)
        self.stats.add_get(len(v))
        return v

    def delete(self, key: Key) -> None:
        ks = _key_str(key)
        kb = ks.encode()
        with self._lock:
            old = self._index.pop(ks, None)
            if old is None:
                return
            # tombstone record: a full log scan (index lost or rebuilt)
            # must not resurrect the deleted key
            self._fh.seek(0, os.SEEK_END)
            pos = self._fh.tell()
            self._fh.write(_MAGIC + struct.pack("<I", len(kb)) + kb
                           + struct.pack("<Q", _TOMBSTONE))
            self._log_size = pos + 8 + len(kb) + 8
            # both the dead record and the tombstone itself are reclaimable
            self._dead_bytes += (self._rec_len(ks, old[1])
                                 + 8 + len(kb) + 8)
            self._maybe_compact()

    def _maybe_compact(self) -> None:
        if (self.auto_compact
                and self._dead_bytes >= self.compact_min_bytes
                and self._dead_bytes >= self.compact_ratio
                * max(self._log_size, 1)):
            self.compact()

    def compact(self) -> dict:
        """Rewrite live records into a fresh log and atomically swap it in.
        Returns ``{"live_bytes", "reclaimed_bytes"}``.

        Runs synchronously under the store lock — readers stall for the
        duration.  Serving deployments with large stores should pass
        ``auto_compact=False`` and call this from a maintenance window
        instead of letting a routine ``put`` absorb the rewrite."""
        with self._lock:
            self._fh.flush()
            tmp_path = self.log_path + ".compact"
            new_index: dict[str, tuple[int, int]] = {}
            pos = 0
            with open(tmp_path, "wb") as out:
                for ks, (off, length) in sorted(self._index.items(),
                                                key=lambda kv: kv[1][0]):
                    self._rfh.seek(off)
                    val = self._rfh.read(length)
                    kb = ks.encode()
                    out.write(_MAGIC + struct.pack("<I", len(kb)) + kb
                              + struct.pack("<Q", length) + val)
                    new_index[ks] = (pos + 8 + len(kb) + 8, length)
                    pos += 8 + len(kb) + 8 + length
                out.flush()
                os.fsync(out.fileno())
            reclaimed = self._log_size - pos
            self._fh.close()
            self._rfh.close()
            committed = False
            try:
                # invalidate the on-disk index BEFORE the commit point: a
                # stale index paired with the new log would serve wrong
                # bytes at old offsets; with no index, recovery full-scans
                # the log (exact — deletes are tombstoned records)
                if os.path.exists(self.index_path):
                    os.remove(self.index_path)
                    self._fsync_dir()
                os.replace(tmp_path, self.log_path)   # commit point
                committed = True
                self._fsync_dir()
            finally:
                # a failed swap must not brick the live instance (an
                # ordinary put can auto-trigger compaction): adopt the new
                # state only past the commit point, and reopen handles on
                # whichever log file is current either way
                if committed:
                    self._index = new_index
                    self._log_size = pos
                    self._synced_size = pos
                    self._dead_bytes = 0
                self._fh = open(self.log_path, "ab")
                self._rfh = open(self.log_path, "rb")
            self.compactions += 1
            self._write_index_locked()
            return {"live_bytes": pos, "reclaimed_bytes": reclaimed}

    def __contains__(self, key: Key) -> bool:
        with self._lock:
            return _key_str(key) in self._index

    def keys(self):
        with self._lock:
            names = list(self._index)
        out = []
        for ks in names:
            p, d, c = ks.split("/", 2)
            out.append((int(p), int(d), c))
        return out

    def _fsync_dir(self) -> None:
        fd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _write_index_locked(self) -> None:
        tmp = self.index_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"index": {k: list(v) for k, v in self._index.items()},
                       "log_end": self._log_size}, f)
        os.replace(tmp, self.index_path)  # atomic

    def flush(self) -> None:
        with self._lock:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._synced_size = self._log_size
            self._write_index_locked()

    def sync(self) -> None:
        """Data-only durability barrier: fsync the log without rewriting
        ``index.json``.  Recovery scans the log tail past the indexed end
        (:meth:`_recover`), so synced-but-unindexed records are safe — this
        is what makes group commit ~free compared to :meth:`flush`, which
        rewrites the whole index every call.

        The fsync itself runs *outside* the store lock: concurrent readers
        must not stall behind the disk for the duration of a barrier (the
        ingest pipeline fsyncs once per commit group while query threads
        keep reading payloads).  An append racing the fsync only means
        *more* bytes became durable than this call promised."""
        with self._lock:
            self._fh.flush()
            size = self._log_size
            fd = self._fh.fileno()
        os.fsync(fd)
        with self._lock:
            if size > self._synced_size:
                self._synced_size = size

    def close(self) -> None:
        if self._fh.closed:   # idempotent — managers close owned stores
            return
        self.flush()
        self._fh.close()
        self._rfh.close()


class TieredKV(KVStore):
    """Hot in-memory blob cache over a cold backend, byte-budgeted.

    * **Write-through**: ``put`` lands in the cold store first, then
      (re)admits the new blob into the hot tier — the cold tier is always
      the full, durable store and ``keys()``/``total_bytes()`` delegate
      to it.
    * **Compressed-at-rest**: values are the codec-layer blobs; the hot
      tier caches them verbatim (decode happens in the prefetcher
      threads), so the budget holds ``compression_ratio×`` more payloads.
    * **Versioned admission**: each overwrite/delete bumps a per-key
      version; a get that read the cold tier concurrently with an
      overwrite only admits its blob if the version is unchanged,
      otherwise it retries — after a ``put`` returns, no later ``get``
      can observe the previous blob.  Writers additionally serialize on
      one lock so cold-tier write order always matches admission order
      (racing puts cannot strand the losing blob in the hot tier).
    * **Accounting**: ``stats`` sees every logical get (each tagged
      hot-hit or hot-miss); the cold backend's own ``stats`` counts the
      physical reads the hot tier absorbed.
    """

    def __init__(self, cold: KVStore, hot_bytes: int = 64 << 20,
                 max_item_frac: float = 0.25) -> None:
        super().__init__()
        self.cold = cold
        self.hot_bytes = int(hot_bytes)
        self.max_item_bytes = max(1, int(self.hot_bytes * max_item_frac))
        self._hot: OrderedDict[Key, bytes] = OrderedDict()
        self._hot_size = 0
        # per-key write versions guard admission; entries live only for
        # keys that exist (bounded by the live set) — a delete reclaims
        # its entry unless a cold read is in flight, in which case a
        # tombstone version stays so the reader cannot admit stale bytes
        self._ver: dict[Key, int] = {}
        self._inflight: dict[Key, int] = {}
        # whole-cache generation, bumped by invalidate_hot(): per-key
        # versions only move on local put/delete, so a read-only replica
        # (shardd: writes happen at the origin) needs this to fence cold
        # reads that straddle an epoch invalidation — bytes fetched
        # before the bump must not be admitted after it
        self._gen = 0
        self._lock = threading.Lock()
        # writes hold this across the cold put/delete *and* the version
        # bump + admission, so cold-tier order == admission order — two
        # racing puts can never leave the hot tier serving the loser
        # (cold backends serialize writers internally anyway)
        self._write_lock = threading.Lock()
        self.evictions = 0

    # -- hot-tier plumbing (lock held) --------------------------------------
    def _drop(self, key: Key) -> None:
        old = self._hot.pop(key, None)
        if old is not None:
            self._hot_size -= len(old)

    def _admit(self, key: Key, value: bytes) -> None:
        self._drop(key)
        if len(value) > self.max_item_bytes:
            return
        self._hot[key] = value
        self._hot_size += len(value)
        while self._hot_size > self.hot_bytes and self._hot:
            _, v = self._hot.popitem(last=False)
            self._hot_size -= len(v)
            self.evictions += 1

    def _dec_inflight(self, key: Key) -> None:
        n = self._inflight.get(key, 0) - 1
        if n <= 0:
            self._inflight.pop(key, None)
        else:
            self._inflight[key] = n

    # -- KVStore API --------------------------------------------------------
    def get(self, key: Key) -> bytes:
        with self._lock:
            v = self._hot.get(key)
            if v is not None:
                self._hot.move_to_end(key)
        if v is not None:
            self.stats.add_get(len(v), hot=True)
            return v
        while True:
            with self._lock:
                ver = self._ver.get(key, 0)
                gen = self._gen
                self._inflight[key] = self._inflight.get(key, 0) + 1
            try:
                v = self.cold.get(key)        # may raise KeyError
            except BaseException:
                with self._lock:
                    self._dec_inflight(key)
                raise
            with self._lock:
                self._dec_inflight(key)
                if self._ver.get(key, 0) == ver:
                    if self._gen == gen:
                        self._admit(key, v)
                    # an invalidation landed mid-read: the bytes are fine
                    # for *this* caller (its epoch pin predates the
                    # publish) but must not enter the hot tier, where a
                    # newer-epoch reader would trust them
                    break
                newer = self._hot.get(key)
                if newer is not None:         # the racing put admitted it
                    self._hot.move_to_end(key)
                    v = newer
                    break
            # overwritten mid-read and not admitted (e.g. oversized) — retry
        self.stats.add_get(len(v), hot=False)
        return v

    def mget(self, keys: list[Key]) -> list:
        """Batched :func:`mget_optional` semantics: hot hits answered from
        the cache, all misses fetched from the cold tier in **one**
        ``cold.mget`` round trip (the batching that makes a remote cold
        tier — e.g. a shard server's origin — affordable), each admitted
        under the same per-key version guard as :meth:`get`."""
        out: list = [None] * len(keys)
        hit = [False] * len(keys)
        with self._lock:
            for i, k in enumerate(keys):
                v = self._hot.get(k)
                if v is not None:
                    self._hot.move_to_end(k)
                    out[i] = v
                    hit[i] = True
        miss_idx = []
        for i in range(len(keys)):
            if hit[i]:
                self.stats.add_get(len(out[i]), hot=True)
            else:
                miss_idx.append(i)
        if not miss_idx:
            return out
        miss_keys = [keys[i] for i in miss_idx]
        with self._lock:
            vers = [self._ver.get(k, 0) for k in miss_keys]
            gen = self._gen
            for k in miss_keys:
                self._inflight[k] = self._inflight.get(k, 0) + 1
        try:
            blobs = self.cold.mget(miss_keys)
        except BaseException:
            with self._lock:
                for k in miss_keys:
                    self._dec_inflight(k)
            raise
        racy: list[Key] = []
        with self._lock:
            for j, (i, k, ver) in enumerate(zip(miss_idx, miss_keys, vers)):
                self._dec_inflight(k)
                v = blobs[j]
                if v is None:
                    continue                  # absent in cold: stays None
                if self._ver.get(k, 0) == ver:
                    if self._gen == gen:      # see get(): no admission
                        self._admit(k, v)     # across an invalidation
                    out[i] = v
                elif self._hot.get(k) is not None:
                    self._hot.move_to_end(k)
                    out[i] = self._hot[k]
                else:
                    racy.append((i, k))       # overwritten mid-read — retry
        for i, k in racy:
            try:
                out[i] = self.get(k)
            except KeyError:
                out[i] = None
        for j, i in enumerate(miss_idx):
            if out[i] is not None and (i, keys[i]) not in racy:
                if blobs[j] is not None:
                    self.stats.add_get(len(out[i]), hot=False)
        return out

    def invalidate_hot(self) -> int:
        """Drop every hot entry (epoch-publish invalidation in a shard
        process: the coordinator announced a new index version, so any
        cached blob may have been superseded at the origin).  Returns the
        number of entries dropped; subsequent gets read through to the
        cold tier.  Also bumps the cache generation so a cold read that
        started *before* this call cannot admit its (possibly
        pre-publish) bytes after it — per-key versions never move in a
        read-only replica, so they alone cannot fence this race."""
        with self._lock:
            n = len(self._hot)
            self._hot.clear()
            self._hot_size = 0
            self._gen += 1
        return n

    def put(self, key: Key, value: bytes) -> None:
        value = bytes(value)
        with self._write_lock:
            self.cold.put(key, value)
            with self._lock:
                self._ver[key] = self._ver.get(key, 0) + 1
                self._admit(key, value)
        self.stats.add_put(len(value))

    def delete(self, key: Key) -> None:
        with self._write_lock:
            self.cold.delete(key)
            self._finish_delete(key)

    def _finish_delete(self, key: Key) -> None:
        with self._lock:
            if self._inflight.get(key):
                # a cold read is mid-flight: leave a bumped tombstone
                # version so it cannot admit the bytes it read
                self._ver[key] = self._ver.get(key, 0) + 1
            else:
                # no reader can hold a pre-delete version — reclaim the
                # entry so dead keys don't accumulate version state
                self._ver.pop(key, None)
            self._drop(key)

    def __contains__(self, key: Key) -> bool:
        with self._lock:
            if key in self._hot:
                return True
        return key in self.cold

    def keys(self):
        return self.cold.keys()

    def total_bytes(self) -> int:
        return self.cold.total_bytes()

    def hot_bytes_used(self) -> int:
        with self._lock:
            return self._hot_size

    def resize_hot(self, hot_bytes: int,
                   max_item_frac: float = 0.25) -> None:
        """Shrink/grow the hot budget in place (benchmarks set it relative
        to the store size measured after a build)."""
        with self._lock:
            self.hot_bytes = int(hot_bytes)
            self.max_item_bytes = max(1, int(self.hot_bytes * max_item_frac))
            while self._hot_size > self.hot_bytes and self._hot:
                _, v = self._hot.popitem(last=False)
                self._hot_size -= len(v)
                self.evictions += 1

    def flush(self) -> None:
        self.cold.flush()

    def sync(self) -> None:
        self.cold.sync()

    def close(self) -> None:
        self.cold.close()


class PartitionedKV(KVStore):
    """Routes by partition_id across per-unit backends (paper: one storage
    instance per machine; all deltas have k partitions).

    ``stats`` aggregates the per-backend counters on read — the router
    keeps no counters of its own, so traffic that reaches a backend
    directly (a partition-local reader, a prefetch thread pinned to one
    storage unit) is never under-reported.

    ``partitioner`` selects the backend for a partition id: a registered
    name from :mod:`repro_torch.runtime.partition` (``"mod_hash"`` /
    ``"word_cyclic"``) or any ``(ids, P) -> backend indices`` callable, so
    the store's routing and the planner's shard assignment come from the
    same registry.  ``None`` (the default) keeps the legacy
    ``partition_id % len(parts)`` routing — stores written by earlier
    deployments stay readable."""

    def __init__(self, parts: list[KVStore], *,
                 partitioner=None) -> None:
        self.parts = parts
        self._agg = AggregateKVStats(parts)
        if isinstance(partitioner, str):
            from ..runtime.partition import get_partitioner
            partitioner = get_partitioner(partitioner)
        self._partitioner = partitioner
        # partition ids are small ints drawn from a fixed range; memoize
        # so routing stays a dict hit, not an ndarray round-trip per call
        self._route_memo: dict[int, int] = {}

    @property
    def stats(self) -> AggregateKVStats:
        return self._agg

    def _route(self, key: Key) -> KVStore:
        pid = key[0]
        if self._partitioner is None:
            return self.parts[pid % len(self.parts)]
        idx = self._route_memo.get(pid)
        if idx is None:
            import numpy as np
            idx = int(self._partitioner(np.asarray([pid], np.int64),
                                        len(self.parts))[0])
            self._route_memo[pid] = idx
        return self.parts[idx]

    def get(self, key: Key) -> bytes:
        return self._route(key).get(key)

    def mget(self, keys: list[Key]) -> list:
        """Route then batch: keys are grouped per backend so each storage
        unit answers one batched fetch (order preserved)."""
        groups: dict[int, list[int]] = {}
        for i, k in enumerate(keys):
            backend = self._route(k)
            groups.setdefault(id(backend), []).append(i)
        out: list = [None] * len(keys)
        for idxs in groups.values():
            backend = self._route(keys[idxs[0]])
            for i, v in zip(idxs, backend.mget([keys[i] for i in idxs])):
                out[i] = v
        return out

    def put(self, key: Key, value: bytes) -> None:
        self._route(key).put(key, value)

    def delete(self, key: Key) -> None:
        self._route(key).delete(key)

    def __contains__(self, key: Key) -> bool:
        return key in self._route(key)

    def keys(self):
        out = []
        for p in self.parts:
            out.extend(p.keys())
        return out

    def flush(self) -> None:
        for p in self.parts:
            p.flush()

    def sync(self) -> None:
        for p in self.parts:
            p.sync()

    def close(self) -> None:
        for p in self.parts:
            p.close()


# ---------------------------------------------------------------------------
# environment-driven store construction
# ---------------------------------------------------------------------------

_TMPDIRS: list[str] = []


def _cleanup_tmpdirs() -> None:  # pragma: no cover - process teardown
    for d in _TMPDIRS:
        shutil.rmtree(d, ignore_errors=True)


atexit.register(_cleanup_tmpdirs)


def make_store(spec: str | None, *, directory: str | None = None,
               hot_bytes: int = 64 << 20) -> KVStore:
    """``mem`` | ``logfile`` | ``tiered`` (hot cache over a logfile)."""
    spec = (spec or "mem").strip().lower()
    if spec == "mem":
        return MemKV()
    if directory is None:
        directory = tempfile.mkdtemp(prefix="repro-kv-")
        _TMPDIRS.append(directory)
    if spec == "logfile":
        return LogFileKV(directory)
    if spec == "tiered":
        return TieredKV(LogFileKV(directory), hot_bytes=hot_bytes)
    raise ValueError(f"unknown KV spec {spec!r} (mem | logfile | tiered)")


def store_from_env() -> KVStore | None:
    """Build the default store from ``REPRO_KV`` (None when unset/``mem``
    — the caller falls back to a plain :class:`MemKV`).  Each call makes
    an independent store; disk-backed ones live in fresh temp dirs under
    ``REPRO_KV_DIR`` (or the system tmp), removed at process exit."""
    spec = os.environ.get("REPRO_KV", "").strip().lower()
    if spec in ("", "mem"):
        return None
    base = os.environ.get("REPRO_KV_DIR") or None
    directory = tempfile.mkdtemp(prefix="repro-kv-", dir=base)
    _TMPDIRS.append(directory)
    hot = int(float(os.environ.get("REPRO_KV_HOT_MB", "64")) * 2**20)
    return make_store(spec, directory=directory, hot_bytes=hot)
