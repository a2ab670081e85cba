"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and bind them with
``ctypes``.

Each ``csrc/<name>.cu`` exports plain C launch functions (pointers, sizes
and a ``cudaStream_t``; each returns the launch's ``cudaGetLastError()``),
so no PyTorch header is compiled and a build takes seconds.  Libraries go
to ``_build/`` beside this file (listed in ``.gitignore``), named by a hash
of the source and flags, and are built at first use:
:func:`build` starts one ``nvcc`` per missing source, all at once, and
waits for them together.  Nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("delta_apply", "flash_attention", "flash_decode", "flash_mla",
           "flash_mla_wgmma", "flash_prefill", "flash_prefill_f32",
           "segment_sum")
# -Xptxas -v: ptxas reports each kernel's registers, spills and shared
# memory; build() keeps that output in ``logs``.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
logs: dict[str, str] = {}       # nvcc's output of this process's builds


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every listed source that has no up-to-date library, one
    ``nvcc`` process each, all started together.  Returns the seconds each
    build took (0.0 for a library already built) and keeps each compiler's
    output in :data:`logs`; raises with that output on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    times = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            times[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return times


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The ctypes library for ``csrc/<name>.cu``, built if needed, with
    ``argtypes`` set from ``signatures`` (``ctypes.c_void_p`` for every
    pointer and the stream) and an ``int`` (``cudaError_t``) return."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, fn: str, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA launch {fn} failed: {msg} ({err})")


# the raw cudaStream_t of a device's current stream, without building a
# torch.cuda.Stream (the public call below does, at a few microseconds)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)


def launch(lib: ctypes.CDLL, fn: str, t: torch.Tensor, *args) -> None:
    """``lib.<fn>(*args, stream)`` on the CUDA device of ``t`` with that
    device's current stream; raises if the launch failed.  The device is
    switched only when it is not the current one."""
    index = t.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return launch(lib, fn, t, *args)
    check(lib, fn, getattr(lib, fn)(*args, _raw_stream(index)))
