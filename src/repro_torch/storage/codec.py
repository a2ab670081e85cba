"""Pluggable payload codec: versioned, checksummed, compressed blobs.

Every payload the system persists — struct deltas, per-column attr
deltas, leaf eventlists, checkpoints, the skeleton — is an *array
bundle* (``dict[str, np.ndarray]``).  This module owns the wire format:

``raw``
    the original self-describing bundle (name, dtype, shape, raw bytes)
    — still written under ``REPRO_CODEC=raw`` and always readable.

``v2`` (default)
    a versioned header wrapping staged per-array encoders plus an
    optional whole-blob entropy stage::

        ┌──────────────────────────── header (20 B) ───────────────────────────┐
        │ magic "RBC2" │ u8 version │ u8 flags │ u16 rsvd │ u64 raw │ u32 csum │
        └──────────────────────────────────────────────────────────────────────┘
        body  = [zlib](  u32 n_arrays,
                         per array: name, dtype, shape, u8 method, params,
                                    encoded bytes )

    Integer columns choose the smallest of: zigzag **varint**, first-
    order **delta** varint (sorted slot/pos columns), second-order
    **delta-of-delta** varint (regularly spaced time columns), fixed-
    width **bitpack** (small-range op/etype codes), or raw.  Floats and
    exotic dtypes stay raw; the zlib stage applies only when it shrinks
    the body (``flags`` records it).  A crc32 checksum covers the stored
    body, so corrupt or truncated blobs raise a typed
    :class:`CodecError` instead of decoding into garbage arrays —
    crc32 because it is stdlib: every environment can *verify* the
    guarantee, never silently skip it.

Decoding sniffs the magic: blobs written before this layer existed (no
``RBC2`` prefix) fall back to the ``raw`` parser — old stores keep
decoding with zero migration (version-gated fallback, pinned by
``tests/test_codec.py``).

The default codec comes from ``REPRO_CODEC`` (``v2``/``raw``) and can
be overridden per call, via :func:`set_default_codec`, or the
:func:`using_codec` context manager.
"""
from __future__ import annotations

import contextlib
import os
import struct as _struct
import threading
import zlib
from collections import OrderedDict

import numpy as np

MAGIC = b"RBC2"
VERSION = 2
_HEADER = _struct.Struct("<4sBBHQI")          # magic, ver, flags, rsvd, raw, csum
_HEADER_LEN = _HEADER.size                     # 20 bytes

# header flags (bit 1 reserved for an alternate checksum algorithm —
# crc32 is the only one written: it is stdlib, so every environment can
# *verify*; an optional faster hash would silently skip verification
# wherever the module is missing, voiding the corruption guarantee)
F_ZLIB = 0x01

# per-array methods
M_RAW = 0          # verbatim array bytes
M_VARINT = 1       # zigzag varint of the values
M_DELTA = 2        # zigzag varint of first-order deltas
M_DOD = 3          # zigzag varint of second-order deltas
M_BITPACK = 4      # min-offset + fixed-width bitpack

_MIN_TRY = 8       # arrays smaller than this stay raw (overhead-bound)
_MIN_ZLIB = 64     # don't entropy-code trivial bodies
_PROBE_FROM = 1 << 16   # bodies above this probe a prefix before committing
ZLIB_LEVEL = int(os.environ.get("REPRO_CODEC_ZLIB_LEVEL", "6"))

KNOWN_CODECS = ("raw", "v2")


class CodecError(Exception):
    """A blob failed to decode: truncated header, unknown version,
    checksum mismatch, or a malformed stream.  Never returns garbage
    arrays — storage corruption surfaces as this typed error."""


# ---------------------------------------------------------------------------
# default-codec selection
# ---------------------------------------------------------------------------

_default_codec = os.environ.get("REPRO_CODEC", "v2").strip().lower() or "v2"


def get_default_codec() -> str:
    return _default_codec


def set_default_codec(name: str) -> None:
    if name not in KNOWN_CODECS:
        raise CodecError(f"unknown codec {name!r}; known: {KNOWN_CODECS}")
    global _default_codec
    _default_codec = name


@contextlib.contextmanager
def using_codec(name: str):
    """Scoped default-codec override (benchmarks compare raw vs v2)."""
    prev = _default_codec
    set_default_codec(name)
    try:
        yield
    finally:
        set_default_codec(prev)


# ---------------------------------------------------------------------------
# stage primitives (all vectorized)
# ---------------------------------------------------------------------------

def _zigzag(w: np.ndarray) -> np.ndarray:
    """int64 bit patterns -> uint64 with small magnitudes near zero."""
    w = np.ascontiguousarray(w, np.int64)
    return (np.left_shift(w, 1) ^ np.right_shift(w, 63)).view(np.uint64)


def _unzigzag(u: np.ndarray) -> np.ndarray:
    u = np.ascontiguousarray(u, np.uint64)
    half = (u >> np.uint64(1)).view(np.int64)
    sign = (u & np.uint64(1)).view(np.int64)
    return half ^ -sign


def varint_encode(u: np.ndarray) -> bytes:
    """LEB128 over uint64 values."""
    u = np.ascontiguousarray(u, np.uint64)
    n = u.size
    if n == 0:
        return b""
    umax = int(u.max())
    if umax < 0x80:
        # all single-byte (the common case: zigzagged deltas, small ids)
        return u.astype(np.uint8).tobytes()
    nb = np.ones(n, np.int64)
    # width passes only up to the widest value present, not all 10
    k = 1
    while k < 10 and umax >= (1 << (7 * k)):
        nb += (u >= (np.uint64(1) << np.uint64(7 * k))).astype(np.int64)
        k += 1
    out = np.zeros(int(nb.sum()), np.uint8)
    starts = np.concatenate([[0], np.cumsum(nb)[:-1]])
    for j in range(k):
        m = nb > j
        byte = ((u[m] >> np.uint64(7 * j)) & np.uint64(0x7F)).astype(np.uint8)
        cont = (nb[m] - 1 > j).astype(np.uint8) << 7
        out[starts[m] + j] = byte | cont
    return out.tobytes()


def varint_decode(data: bytes, n: int) -> np.ndarray:
    b = np.frombuffer(data, np.uint8)
    if n == 0:
        if b.size:
            raise CodecError("varint stream has trailing bytes")
        return np.zeros(0, np.uint64)
    term = np.flatnonzero(b < 0x80)
    if b.size == 0 or b[-1] >= 0x80 or term.size != n:
        raise CodecError(f"varint stream does not hold {n} terminated values")
    # gather per byte-position: most values are 1-2 bytes, so the active
    # set collapses after the first couple of rounds (no slow ufunc.at)
    starts = np.empty(n, np.int64)
    starts[0] = 0
    starts[1:] = term[:-1] + 1
    vals = np.zeros(n, np.uint64)
    idx = starts
    active = np.arange(n)
    cont = np.zeros(0, bool)
    for j in range(10):
        bj = b[idx]
        vals[active] |= (bj & 0x7F).astype(np.uint64) << np.uint64(7 * j)
        cont = bj >= 0x80
        if not cont.any():
            break
        idx = idx[cont] + 1
        active = active[cont]
    else:
        if cont.any():
            raise CodecError("varint value overflows 64 bits")
    return vals


def bitpack(vals: np.ndarray, width: int) -> bytes:
    """Fixed-width little-endian bitpack of uint64 values < 2**width."""
    vals = np.ascontiguousarray(vals, np.uint64)
    if width == 0 or vals.size == 0:
        return b""
    bits = ((vals[:, None] >> np.arange(width, dtype=np.uint64)[None, :])
            & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits.ravel(), bitorder="little").tobytes()


def bitunpack(data: bytes, n: int, width: int) -> np.ndarray:
    if width == 0 or n == 0:
        return np.zeros(n, np.uint64)
    if len(data) * 8 < n * width:
        raise CodecError("bitpacked stream too short")
    # value i lives at bit offset i*width: gather the 8-byte window that
    # covers it and shift/mask — no per-bit expansion (width <= 32 < 57,
    # so one little-endian u64 window always spans a value)
    padded = np.zeros(len(data) + 8, np.uint8)
    padded[: len(data)] = np.frombuffer(data, np.uint8)
    starts = np.arange(n, dtype=np.int64) * width
    idx = (starts >> 3)[:, None] + np.arange(8, dtype=np.int64)
    words = padded[idx].view("<u8").ravel()
    return (words >> (starts & 7).astype(np.uint64)) \
        & np.uint64((1 << width) - 1)


# ---------------------------------------------------------------------------
# per-array encode/decode
# ---------------------------------------------------------------------------

BF16 = "bfloat16"


def _dtype_token(a: np.ndarray, bf16: bool = False) -> bytes:
    # dtype.str is '<V2' for ml_dtypes types (bfloat16 &c.) — the *name*
    # round-trips through np.dtype() once ml_dtypes is imported.  ``bf16``:
    # a uint16 array holding bfloat16 bits (torch's bf16, with no numpy
    # dtype of its own) is written under that same name.
    if bf16:
        return BF16.encode()
    ds = a.dtype.str
    return (a.dtype.name if ds.startswith(("<V", "|V", ">V")) else ds).encode()


def _token_dtype(token: str) -> np.dtype:
    """The numpy dtype of a blob's dtype token; ``bfloat16`` without
    ``ml_dtypes`` loaded decodes as its bits, uint16."""
    try:
        return np.dtype(token)
    except TypeError:
        if token == BF16:
            return np.dtype(np.uint16)
        raise


def _int_bits(a: np.ndarray) -> np.ndarray:
    """Any integer/bool array -> its int64 bit patterns (bijective per
    dtype: decode casts back, wrapping to the original bits)."""
    return a.ravel().astype(np.int64)


def _encode_array(a: np.ndarray) -> tuple[int, bytes, bytes]:
    """-> (method, params, payload), smallest candidate wins."""
    raw = a.tobytes()
    if a.dtype.kind not in "iub" or a.size < _MIN_TRY:
        return M_RAW, b"", raw
    w = _int_bits(a)
    cands: list[tuple[int, int, bytes, bytes]] = [(len(raw), M_RAW, b"", raw)]
    zz = varint_encode(_zigzag(w))
    cands.append((len(zz), M_VARINT, b"", zz))
    d = np.empty_like(w)
    d[0] = w[0]
    d[1:] = w[1:] - w[:-1]          # modular — wrap-around still roundtrips
    dz = varint_encode(_zigzag(d))
    cands.append((len(dz), M_DELTA, b"", dz))
    dd = np.empty_like(d)
    dd[0] = d[0]
    dd[1:] = d[1:] - d[:-1]
    ddz = varint_encode(_zigzag(dd))
    cands.append((len(ddz), M_DOD, b"", ddz))
    mn, mx = int(w.min()), int(w.max())
    width = (mx - mn).bit_length()
    if width <= 32:
        bp = bitpack((w - np.int64(mn)).view(np.uint64), width)
        cands.append((len(bp), M_BITPACK, _struct.pack("<qB", mn, width), bp))
    cands.sort(key=lambda c: (c[0], c[1]))
    _, method, params, payload = cands[0]
    return method, params, payload


def _decode_array(method: int, params: bytes, payload: bytes,
                  dtype: np.dtype, shape: tuple[int, ...]) -> np.ndarray:
    n = 1
    for s in shape:
        n *= s
    if method == M_RAW:
        if len(payload) != n * dtype.itemsize:
            raise CodecError("raw array payload has wrong length")
        return np.frombuffer(payload, dtype=dtype).reshape(shape)
    if method == M_BITPACK:
        if len(params) != 9:
            raise CodecError("bitpack params malformed")
        mn, width = _struct.unpack("<qB", params)
        w = (bitunpack(payload, n, width).view(np.int64)
             + np.int64(mn))
    else:
        u = varint_decode(payload, n)
        w = _unzigzag(u)
        if method == M_DOD:
            w = np.cumsum(w)
        if method in (M_DELTA, M_DOD):
            w = np.cumsum(w)
        elif method != M_VARINT:
            raise CodecError(f"unknown array method {method}")
    return w.astype(dtype, copy=False).reshape(shape)


# ---------------------------------------------------------------------------
# raw (legacy) bundle format — byte-compatible with pre-codec blobs
# ---------------------------------------------------------------------------

def _pack_raw(arrays: dict[str, np.ndarray], bf16=()) -> bytes:
    out = [_struct.pack("<I", len(arrays))]
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        nb = name.encode()
        dt = _dtype_token(a, name in bf16)
        out.append(_struct.pack("<I", len(nb)) + nb)
        out.append(_struct.pack("<I", len(dt)) + dt)
        out.append(_struct.pack("<I", a.ndim) + _struct.pack(f"<{a.ndim}q", *a.shape))
        raw = a.tobytes()
        out.append(_struct.pack("<Q", len(raw)) + raw)
    return b"".join(out)


def _unpack_raw(data: bytes) -> dict[str, np.ndarray]:
    try:
        pos = 0
        (n,) = _struct.unpack_from("<I", data, pos); pos += 4
        out: dict[str, np.ndarray] = {}
        for _ in range(n):
            (ln,) = _struct.unpack_from("<I", data, pos); pos += 4
            name = data[pos:pos + ln].decode(); pos += ln
            (ld,) = _struct.unpack_from("<I", data, pos); pos += 4
            dt = data[pos:pos + ld].decode(); pos += ld
            (nd,) = _struct.unpack_from("<I", data, pos); pos += 4
            shape = _struct.unpack_from(f"<{nd}q", data, pos); pos += 8 * nd
            (nraw,) = _struct.unpack_from("<Q", data, pos); pos += 8
            if pos + nraw > len(data):
                raise CodecError("raw bundle truncated mid-array")
            a = np.frombuffer(data[pos:pos + nraw],
                              dtype=_token_dtype(dt)).reshape(shape)
            pos += nraw
            out[name] = a
        return out
    except CodecError:
        raise
    except Exception as e:
        raise CodecError(f"not a decodable raw array bundle: {e!r}") from e


# ---------------------------------------------------------------------------
# v2 blob
# ---------------------------------------------------------------------------

def _checksum(body: bytes) -> int:
    return zlib.crc32(body) & 0xFFFFFFFF


class _Reader:
    """Bounds-checked cursor — every overrun is a CodecError."""

    __slots__ = ("data", "pos")

    _structs: dict[str, _struct.Struct] = {}

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise CodecError("blob body truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        s = self._structs.get(fmt)
        if s is None:
            s = self._structs[fmt] = _struct.Struct(fmt)
        if self.pos + s.size > len(self.data):
            raise CodecError("blob body truncated")
        out = s.unpack_from(self.data, self.pos)
        self.pos += s.size
        return out


# Cooperative-yield hook for background encoders.  A thread that encodes
# large bundles while latency-sensitive readers share the interpreter
# (the ingest fold worker) installs a per-thread hook; _encode_v2 calls
# it between arrays so no single pack_arrays() is a multi-ms GIL hold.
# Thread-local on purpose: readers and foreground builds are unaffected.
_nice_tl = threading.local()


def set_encode_nice(hook) -> None:
    """Install (or clear, with ``None``) this thread's between-array
    encode yield hook."""
    _nice_tl.hook = hook


def _encode_nice() -> None:
    hook = getattr(_nice_tl, "hook", None)
    if hook is not None:
        hook()


def set_decode_nice(hook) -> None:
    """Install (or clear, with ``None``) this thread's between-array
    *decode* yield hook — the read-side mirror of :func:`set_encode_nice`.
    Prefetcher workers decode payloads while the apply thread drives
    device kernels on the same interpreter; yielding between arrays keeps
    any single ``decode_blob`` from becoming a multi-ms GIL hold in the
    double-buffered pipeline."""
    _nice_tl.decode_hook = hook


def _decode_nice() -> None:
    hook = getattr(_nice_tl, "decode_hook", None)
    if hook is not None:
        hook()


def _encode_v2(arrays: dict[str, np.ndarray], bf16=()) -> bytes:
    recs = [_struct.pack("<I", len(arrays))]
    raw_size = 0
    for name, a in arrays.items():
        _encode_nice()
        a = np.ascontiguousarray(a)
        raw_size += a.nbytes
        nb = name.encode()
        dt = _dtype_token(a, name in bf16)
        # bf16 bits stay raw: an integer method would decode as values
        method, params, payload = ((M_RAW, b"", a.tobytes()) if name in bf16
                                   else _encode_array(a))
        recs.append(_struct.pack("<B", len(nb)) + nb)
        recs.append(_struct.pack("<B", len(dt)) + dt)
        recs.append(_struct.pack("<B", a.ndim)
                    + _struct.pack(f"<{a.ndim}q", *a.shape))
        recs.append(_struct.pack("<BB", method, len(params)) + params)
        recs.append(_struct.pack("<Q", len(payload)) + payload)
    body = b"".join(recs)
    flags = 0
    level = _entropy_level(body)
    if level is not None:
        comp = zlib.compress(body, level)
        if len(comp) < len(body):
            body = comp
            flags |= F_ZLIB
    header = _HEADER.pack(MAGIC, VERSION, flags, 0, raw_size,
                          _checksum(body))
    return header + body


def _entropy_level(body: bytes) -> int | None:
    """Pick the zlib effort for a body (None = skip the stage).  Large
    bodies probe a prefix at the fastest level first: float-heavy
    payloads (checkpoint shards, raw parameter tensors) shrink barely or
    not at all, and paying level-``ZLIB_LEVEL`` over hundreds of MB for
    a few percent would tax the checkpoint path — incompressible bodies
    skip the stage, marginal ones take the cheapest pass, and only
    clearly compressible bodies get the full effort."""
    if len(body) < _MIN_ZLIB:
        return None
    if len(body) <= _PROBE_FROM:
        return ZLIB_LEVEL
    sample = body[: _PROBE_FROM]
    ratio = len(zlib.compress(sample, 1)) / len(sample)
    if ratio >= 0.90:      # <10% win: not worth ~10 MB/s deflate cost
        return None
    if ratio >= 0.80:
        return 1
    return ZLIB_LEVEL


def _decode_v2(blob: bytes) -> dict[str, np.ndarray]:
    if len(blob) < _HEADER_LEN:
        raise CodecError("truncated blob header")
    magic, version, flags, _rsvd, _raw_size, csum = _HEADER.unpack_from(blob)
    if magic != MAGIC:  # pragma: no cover - callers sniff first
        raise CodecError("bad magic")
    if version != VERSION:
        raise CodecError(f"unknown codec version {version}")
    body = blob[_HEADER_LEN:]
    if _checksum(body) != csum:
        raise CodecError("blob checksum mismatch (corrupt or truncated)")
    if flags & F_ZLIB:
        try:
            body = zlib.decompress(body)
        except zlib.error as e:
            raise CodecError(f"entropy stage failed: {e}") from e
    r = _Reader(body)
    (n,) = r.unpack("<I")
    out: dict[str, np.ndarray] = {}
    for _ in range(n):
        _decode_nice()
        (ln,) = r.unpack("<B")
        name = r.take(ln).decode()
        (ld,) = r.unpack("<B")
        try:
            dtype = _token_dtype(r.take(ld).decode())
        except TypeError as e:
            raise CodecError(f"unknown dtype in blob: {e}") from e
        (nd,) = r.unpack("<B")
        shape = r.unpack(f"<{nd}q") if nd else ()
        method, plen = r.unpack("<BB")
        params = r.take(plen)
        (enc_len,) = r.unpack("<Q")
        payload = r.take(enc_len)
        out[name] = _decode_array(method, params, payload, dtype,
                                  tuple(int(s) for s in shape))
    return out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def encode_blob(arrays: dict[str, np.ndarray], codec: str | None = None,
                bf16=()) -> bytes:
    """``arrays`` as a blob; the names in ``bf16`` are uint16 arrays of
    bfloat16 bits, written raw under the dtype name ``bfloat16`` (the JAX
    package's ``ml_dtypes`` arrays are written so, and read back as
    bfloat16; :func:`decode_blob` gives uint16 bits where ``ml_dtypes`` is
    not loaded)."""
    name = codec if codec is not None else _default_codec
    if name == "v2":
        return _encode_v2(arrays, bf16)
    if name == "raw":
        return _pack_raw(arrays, bf16)
    raise CodecError(f"unknown codec {name!r}; known: {KNOWN_CODECS}")


# ---------------------------------------------------------------------------
# decoded-payload cache (content-addressed)
# ---------------------------------------------------------------------------
# Hot payloads — the skeleton prefix every plan descends through — are
# decoded once, not once per retrieval.  The cache key is the *blob bytes
# themselves* (dict equality on hash match), so an overwritten payload can
# never serve its stale decode and no invalidation protocol exists at all.
# Cached bundles are marked read-only; every current consumer either reads
# or concatenates (copies) them, and a future mutating caller fails loudly
# instead of corrupting the cache.

_cache_max = int(float(os.environ.get("REPRO_CODEC_CACHE_MB", "64")) * 2**20)
_cache: "OrderedDict[bytes, dict[str, np.ndarray]]" = OrderedDict()
_cache_bytes = 0
_cache_lock = threading.Lock()
decode_cache_stats = {"hits": 0, "misses": 0}


def set_decode_cache_bytes(nbytes: int) -> None:
    """Resize (0 disables) and clear the decoded-payload cache."""
    global _cache_max, _cache_bytes
    with _cache_lock:
        _cache_max = int(nbytes)
        _cache.clear()
        _cache_bytes = 0
        decode_cache_stats["hits"] = decode_cache_stats["misses"] = 0


def _entry_bytes(blob: bytes, out: dict) -> int:
    return len(blob) + sum(int(a.nbytes) for a in out.values())


def _freeze(out: dict) -> dict:
    for a in out.values():
        a.flags.writeable = False
    return out


def decode_blob(blob: bytes) -> dict[str, np.ndarray]:
    """Decode any blob this system ever wrote.  Sniffs the v2 magic;
    anything else goes through the legacy raw parser (pre-codec blobs
    keep decoding).  Malformed input raises :class:`CodecError`.
    Returned arrays are read-only (they may be served from the decoded-
    payload cache); copy before mutating."""
    if _cache_max:
        with _cache_lock:
            hit = _cache.get(blob)
            if hit is not None:
                _cache.move_to_end(blob)
                decode_cache_stats["hits"] += 1
                return hit
            decode_cache_stats["misses"] += 1
    if len(blob) >= len(MAGIC) and blob[: len(MAGIC)] == MAGIC:
        out = _freeze(_decode_v2(blob))
    else:
        out = _freeze(_unpack_raw(blob))
    if _cache_max:
        nb = _entry_bytes(blob, out)
        if nb <= _cache_max // 8:
            global _cache_bytes
            with _cache_lock:
                if blob not in _cache:
                    _cache[blob] = out
                    _cache_bytes += nb
                    while _cache_bytes > _cache_max and _cache:
                        k, v = _cache.popitem(last=False)
                        _cache_bytes -= _entry_bytes(k, v)
    return out


def blob_info(blob: bytes) -> dict:
    """Cheap header-only inspection: codec, stored vs logical bytes."""
    if len(blob) >= len(MAGIC) and blob[: len(MAGIC)] == MAGIC:
        if len(blob) < _HEADER_LEN:
            raise CodecError("truncated blob header")
        _m, version, flags, _r, raw_size, _c = _HEADER.unpack_from(blob)
        return {"codec": "v2", "version": version,
                "stored_bytes": len(blob), "logical_bytes": int(raw_size),
                "zlib": bool(flags & F_ZLIB)}
    # legacy: skim the array headers, skip the payloads
    try:
        pos = 0
        (n,) = _struct.unpack_from("<I", blob, pos); pos += 4
        logical = 0
        for _ in range(n):
            (ln,) = _struct.unpack_from("<I", blob, pos); pos += 4 + ln
            (ld,) = _struct.unpack_from("<I", blob, pos); pos += 4 + ld
            (nd,) = _struct.unpack_from("<I", blob, pos); pos += 4 + 8 * nd
            (nraw,) = _struct.unpack_from("<Q", blob, pos); pos += 8 + nraw
            logical += nraw
        return {"codec": "raw", "version": 1, "stored_bytes": len(blob),
                "logical_bytes": logical, "zlib": False}
    except Exception as e:
        raise CodecError(f"unrecognized blob: {e!r}") from e
