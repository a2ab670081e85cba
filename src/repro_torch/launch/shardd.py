"""Per-shard worker daemon: ``python -m repro_torch.launch.shardd``.

One shardd process is a **partition-restricted caching fetch server** —
the storage-server half of the paper's distributed DeltaGraph.  The
coordinator (``ShardedRetriever`` with the process transport) computes
plan IRs and delta-apply locally; what crosses the wire is the storage
protocol only: batched ``fetch`` RPCs (key lists → blobs, ``None`` for
holes) answered from a shard-local :class:`~repro_torch.storage.kv.TieredKV`
hot cache whose **cold tier is an RPC client back to the coordinator's
origin store** (:class:`RemoteKV`).  The origin stays authoritative, so a
SIGKILL'd shardd loses nothing but its cache, and a replica serving the
same partitions warms independently.

Cache freshness is epoch-driven, matching the ingest pipeline's
invariants: committed group writes *overwrite* the open leaf's eventlist
keys in place, so a cross-process cache goes stale the moment an epoch
publishes.  Two guards make that safe:

* ``announce`` RPC — the coordinator's :class:`EpochRegistry` publish
  hook fans the new epoch id out to every shardd, which drops its hot
  tier (``invalidations`` counter).
* ``min_epoch`` fetch gate — every fetch carries the coordinator's
  current epoch id; a shardd that has not yet heard the announcement
  (publish → announce is asynchronous) sees ``min_epoch > epoch``,
  invalidates immediately and adopts the newer id.  A query can therefore
  never read hot bytes older than the epoch it pinned.

Also served: ``health`` (the heartbeat RPC — liveness, pid, epoch),
``stats``, ``configure`` (point at an origin / reset between owners, so a
pooled fleet is reusable across tests), ``set_delay`` (fault injection
for degraded-replica benchmarks), ``flush_cache``, ``ping``.

The bottom half of this module is the coordinator-side process
management: :func:`spawn_shard_procs` / :class:`ShardProc` handles, an
:func:`origin_server` factory, and a process pool reused across
transports (spawning pays a full interpreter + torch import; a
``configure`` RPC is microseconds).
"""
from __future__ import annotations

import argparse
import atexit
import os
import subprocess
import sys
import threading
import time

from ..runtime.rpc import RpcClient, RpcServer
from ..storage.kv import KVStore, TieredKV

READY_PREFIX = "SHARDD_READY"

# h_fetch's unowned-partition rejection message prefix — the transport
# matches it (through RemoteCallError.remote_message) to tell a
# routing-config gap apart from a liveness failure, widen the server's
# owned set via ``set_owned`` and retry instead of blacklisting it
UNOWNED_MSG = "fetch for unowned partition(s)"


def _decode_keys(raw: list) -> list[tuple]:
    return [(int(p), int(d), str(c)) for p, d, c in raw]


def _encode_keys(keys: list) -> list:
    return [[int(p), int(d), str(c)] for p, d, c in keys]


class RemoteKV(KVStore):
    """KVStore client over the RPC layer: ``mget`` is one round trip.

    Used as a :class:`TieredKV` cold tier inside shardd (reads through to
    the coordinator's origin server) — so every hot-tier miss batch costs
    exactly one RPC, and the tiered cache's byte budget and versioned
    admission apply unchanged to remote blobs.
    """

    def __init__(self, host: str, port: int, *,
                 deadline_s: float | None = 30.0) -> None:
        super().__init__()
        self.client = RpcClient(host, int(port),
                                default_deadline_s=deadline_s)

    def mget(self, keys: list) -> list:
        if not keys:
            return []
        _, blobs = self.client.call("mget", {"k": _encode_keys(keys)})
        for b in blobs:
            if b is not None:
                self.stats.add_get(len(b))
        return blobs

    def get(self, key) -> bytes:
        (v,) = self.mget([key])
        if v is None:
            raise KeyError(key)
        return v

    def multi_get(self, keys: list) -> list[bytes]:
        out = self.mget(keys)
        for k, v in zip(keys, out):
            if v is None:
                raise KeyError(k)
        return out

    def __contains__(self, key) -> bool:
        try:
            self.get(key)
            return True
        except KeyError:
            return False

    def close(self) -> None:
        self.client.close()


class ShardServer:
    """The daemon's state machine; all handlers run on RPC threads."""

    def __init__(self, hot_mb: float = 64.0) -> None:
        self.hot_bytes = int(float(hot_mb) * 2**20)
        self.origin: RemoteKV | None = None
        self.cache: TieredKV | None = None
        self.owned: frozenset[int] | None = None
        self.epoch = -1
        self.t0 = time.monotonic()
        self._lock = threading.Lock()
        self._delay_s = 0.0
        self._delay_left = 0
        self.counters = {"fetches": 0, "keys": 0, "bytes_out": 0,
                         "invalidations": 0, "implied_invalidations": 0,
                         "configures": 0}

    # -- handlers -----------------------------------------------------------
    def h_configure(self, args: dict, blobs) -> dict:
        """(Re)point at an origin store and reset per-owner state — what
        makes a pooled shardd reusable across coordinators."""
        with self._lock:
            if self.origin is not None:
                self.origin.close()
            self.origin = RemoteKV(args.get("origin_host", "127.0.0.1"),
                                   int(args["origin_port"]))
            self.cache = TieredKV(self.origin,
                                  hot_bytes=int(args.get(
                                      "hot_bytes", self.hot_bytes)))
            owned = args.get("owned")
            self.owned = None if owned is None else frozenset(
                int(p) for p in owned)
            self.epoch = int(args.get("epoch", 0))
            self._delay_s = 0.0
            self._delay_left = 0
            self.counters["configures"] += 1
        return {"pid": os.getpid(), "epoch": self.epoch}

    def h_fetch(self, args: dict, blobs) -> tuple:
        with self._lock:
            cache, owned = self.cache, self.owned
            delay = 0.0
            if self._delay_left != 0 and self._delay_s > 0:
                delay = self._delay_s
                if self._delay_left > 0:
                    self._delay_left -= 1
        if cache is None:
            raise RuntimeError("shardd not configured (no origin)")
        if delay:
            time.sleep(delay)
        keys = _decode_keys(args.get("k", []))
        if owned is not None:
            bad = [k for k in keys if k[0] not in owned]
            if bad:
                # fatal by classification: a fetch for an unowned
                # partition is a routing-config gap, not a transient
                # fault — the transport reacts with set_owned + retry
                raise ValueError(
                    f"{UNOWNED_MSG} {sorted({k[0] for k in bad})}; "
                    f"this shard owns {sorted(owned)}")
        min_epoch = int(args.get("min_epoch", 0))
        with self._lock:
            if min_epoch > self.epoch:
                # the coordinator is ahead of our last announcement: any
                # hot byte may predate the publish — drop and adopt
                if self.cache is not None:
                    self.cache.invalidate_hot()
                self.epoch = min_epoch
                self.counters["implied_invalidations"] += 1
        out = cache.mget(keys)
        with self._lock:
            self.counters["fetches"] += 1
            self.counters["keys"] += len(keys)
            self.counters["bytes_out"] += sum(
                len(b) for b in out if b is not None)
        return None, out

    def h_set_owned(self, args: dict, blobs) -> dict:
        """Replace the owned partition set *without* touching the cache
        or origin — the coordinator's failover path when >1 server has
        died and routing must land a partition beyond the rendezvous
        ranks this server was originally configured with."""
        owned = args.get("owned")
        with self._lock:
            self.owned = None if owned is None else frozenset(
                int(p) for p in owned)
            out = None if self.owned is None else sorted(self.owned)
        return {"owned": out}

    def h_announce(self, args: dict, blobs) -> dict:
        epoch = int(args.get("epoch", 0))
        with self._lock:
            stale = epoch > self.epoch
            if stale:
                self.epoch = epoch
                if self.cache is not None:
                    self.cache.invalidate_hot()
                self.counters["invalidations"] += 1
        return {"epoch": self.epoch, "invalidated": stale}

    def h_health(self, args: dict, blobs) -> dict:
        return {"pid": os.getpid(), "epoch": self.epoch,
                "uptime_s": round(time.monotonic() - self.t0, 3),
                "configured": self.cache is not None}

    def h_stats(self, args: dict, blobs) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["epoch"] = self.epoch
            if self.cache is not None:
                out["hot_hits"] = self.cache.stats.hot_hits
                out["hot_misses"] = self.cache.stats.hot_misses
                out["hot_bytes_used"] = self.cache.hot_bytes_used()
        return out

    def h_set_delay(self, args: dict, blobs) -> dict:
        """Fault injection: stall the next ``count`` fetches (-1 = all) by
        ``ms`` — the degraded-replica model for hedging benchmarks."""
        with self._lock:
            self._delay_s = float(args.get("ms", 0)) / 1e3
            self._delay_left = int(args.get("count", -1))
        return {"ok": True}

    def h_flush_cache(self, args: dict, blobs) -> dict:
        n = self.cache.invalidate_hot() if self.cache is not None else 0
        return {"dropped": n}

    def h_ping(self, args: dict, blobs) -> dict:
        return {"pong": True, "pid": os.getpid()}

    def handlers(self) -> dict:
        return {"configure": self.h_configure, "fetch": self.h_fetch,
                "set_owned": self.h_set_owned,
                "announce": self.h_announce, "health": self.h_health,
                "stats": self.h_stats, "set_delay": self.h_set_delay,
                "flush_cache": self.h_flush_cache, "ping": self.h_ping}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="shardd")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--hot-mb", type=float, default=64.0)
    args = ap.parse_args(argv)

    shard = ShardServer(hot_mb=args.hot_mb)
    server = RpcServer(shard.handlers(), port=args.port).start()
    print(f"{READY_PREFIX} port={server.port} pid={os.getpid()}",
          flush=True)
    try:
        # lifetime = parent's: block until stdin EOF (parent exited or
        # closed the pipe), so an abandoned coordinator never leaks us
        sys.stdin.buffer.read()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


# ---------------------------------------------------------------------------
# coordinator-side process management
# ---------------------------------------------------------------------------

class ShardProc:
    """Handle on one spawned shardd: its OS process + an RPC client."""

    def __init__(self, proc: subprocess.Popen, port: int) -> None:
        self.proc = proc
        self.port = int(port)
        self.pid = proc.pid
        self.client = RpcClient("127.0.0.1", self.port)

    def alive(self) -> bool:
        if self.proc.poll() is not None:
            return False
        try:
            self.client.call("ping", deadline_s=2.0)
            return True
        except Exception:
            return False

    def kill(self) -> None:
        """SIGKILL — the chaos-test path; no cleanup runs in the child."""
        self.client.close()
        try:
            self.proc.kill()
        except OSError:
            pass
        self.proc.wait(timeout=10)

    def terminate(self) -> None:
        self.client.close()
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()     # EOF → clean exit
            except OSError:
                pass
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        # reap pipes so a long-lived coordinator doesn't leak fds
        for f in (self.proc.stdout, self.proc.stdin):
            try:
                if f is not None:
                    f.close()
            except OSError:
                pass


def spawn_shard_procs(n: int, *, hot_mb: float = 64.0,
                      ready_timeout_s: float = 60.0) -> list[ShardProc]:
    """Spawn ``n`` shardd processes and wait for their ready lines.

    Children are full interpreters (``sys.executable -m
    repro_torch.launch.shardd``) — real isolation, SIGKILL-able — with
    ``PYTHONPATH`` extended so the child resolves the same ``repro_torch``
    tree as the parent.
    """
    import repro_torch
    src_dir = os.path.dirname(os.path.dirname(
        os.path.abspath(repro_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = src_dir + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs = []
    for _ in range(n):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.shardd",
             "--hot-mb", str(hot_mb)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env))
    handles = []
    try:
        for proc in procs:
            deadline = time.monotonic() + ready_timeout_s
            line = ""
            while time.monotonic() < deadline:
                raw = proc.stdout.readline()
                if not raw:
                    raise RuntimeError(
                        f"shardd pid {proc.pid} exited before ready "
                        f"(rc={proc.poll()})")
                line = raw.decode(errors="replace").strip()
                if line.startswith(READY_PREFIX):
                    break
            if not line.startswith(READY_PREFIX):
                raise TimeoutError(f"shardd pid {proc.pid} never readied")
            fields = dict(f.split("=", 1) for f in line.split()[1:])
            handles.append(ShardProc(proc, int(fields["port"])))
    except BaseException:
        for h in handles:
            h.terminate()
        for proc in procs[len(handles):]:
            proc.kill()
            proc.wait(timeout=10)
        raise
    return handles


def origin_server(store: KVStore) -> RpcServer:
    """The coordinator-side authoritative endpoint shardd reads through
    to: one ``mget`` method over the manager's own store.  Runs on
    threads inside the coordinator process (the store API is
    thread-safe; the prefetcher already drives it concurrently)."""
    def h_mget(args: dict, blobs) -> tuple:
        keys = _decode_keys(args.get("k", []))
        return None, store.mget(keys)

    return RpcServer({"mget": h_mget,
                      "ping": lambda a, b: {"pong": True}}).start()


# -- pooled fleet (spawn once per process, reconfigure per owner) -----------
_POOL: list[ShardProc] = []
_POOL_LOCK = threading.Lock()


def _pooling_enabled() -> bool:
    return os.environ.get("REPRO_SHARDD_POOL", "1") != "0"


def acquire_shard_procs(n: int, *, hot_mb: float = 64.0) -> list[ShardProc]:
    out: list[ShardProc] = []
    if _pooling_enabled():
        with _POOL_LOCK:
            while _POOL and len(out) < n:
                out.append(_POOL.pop())
        # one alive() (an RPC ping) per handle: evaluating it twice can
        # double-count a handle whose state flips between calls — or
        # drop it entirely, leaking the Popen and its pipes
        live: list[ShardProc] = []
        for h in out:
            if h.alive():
                live.append(h)
            else:
                h.terminate()
        out = live
    if len(out) < n:
        out.extend(spawn_shard_procs(n - len(out), hot_mb=hot_mb))
    return out


def release_shard_procs(handles: list[ShardProc]) -> None:
    live = []
    for h in handles:
        if h.proc.poll() is None and _pooling_enabled():
            live.append(h)
        else:
            h.terminate()
    with _POOL_LOCK:
        _POOL.extend(live)


@atexit.register
def _drain_pool() -> None:  # pragma: no cover - process teardown
    with _POOL_LOCK:
        handles, _POOL[:] = list(_POOL), []
    for h in handles:
        try:
            h.terminate()
        except Exception:
            pass


if __name__ == "__main__":
    main()
