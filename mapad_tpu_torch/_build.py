"""Build and load the port's native libraries.

Two kinds of shared library, both built at first use into the package's
own build directory (`mapad_tpu_torch/_build/`, ignored by git), named by
a hash of their source and flags so an edited source is rebuilt:

- host C++ (`csrc/host/*.cpp`): the exact searcher, the BAM postprocessor
  and SA-IS, compiled with g++ and the same flags as the JAX package's
  wrappers (`-O3 -march=native -funroll-loops -ffp-contract=off`);
- CUDA (`csrc/*.cu`): the hand-written Hopper kernels, compiled with nvcc
  for `sm_90a` with `--fmad=false` (no contraction, IEEE division, no
  flush-to-zero: the kernels must round every f32 operation exactly as
  the plain versions do).  Each library has a plain C interface and is
  loaded with ctypes; every entry point returns `cudaGetLastError()`.
  Each library links its own copy of the CUDA runtime, so a call first
  makes the caller's current torch device the library's own current device
  (`set_device`, csrc/common.cuh) where that thread has not set it there
  already: a thread that drives one card of several launches there.

Every library is written under a temporary name and moved into place with
`os.replace`, so concurrent builders (parallel test workers, several
processes) never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

HOST_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-ffp-contract=off"]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]
# one library per source (K1 is a device function of common.cuh, inline in
# pool_search.cu, bi_d.cu and search_batch.cu; unpack_prep.cu holds K4 and
# K6; pool_sharded.cu K9's device part)
CUDA_SOURCES = ("pool_search", "pool_compact", "extract_chains",
                "unpack_prep", "pack_result", "bi_d", "search_batch",
                "pool_sharded")
# the ports of the TPU's DMA probes (mapad_tpu_torch/tools/): on no mapping
# path, built at first use by `cuda_library` or with
# `build_cuda(PROBE_SOURCES)`
PROBE_SOURCES = ("probe_dma", "probe_copy")

_lock = threading.Lock()
_loaded: dict = {}


def _digest(paths, flags) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:12]


def _compile(cmd, out):
    """Start one compiler command writing to a temporary name (`_finish`
    moves it to `out`).  Returns the Popen so several run at once."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.Popen(
        cmd + ["-o", tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT
    )
    return proc, tmp


def _finish(proc, tmp, out, what):
    log = proc.communicate()[0].decode(errors="replace")
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"building {what} failed:\n{log}")
    os.replace(tmp, out)
    return log


def host_library(name: str, extra_flags=()) -> ctypes.CDLL:
    """Build (once) and load `csrc/host/<name>.cpp` as lib<name>."""
    src = os.path.join(CSRC, "host", f"{name}.cpp")
    flags = HOST_FLAGS + list(extra_flags)
    with _lock:
        key = ("host", name)
        if key in _loaded:
            return _loaded[key]
        out = os.path.join(BUILD_DIR, f"lib{name}-{_digest([src], flags)}.so")
        if not os.path.exists(out):
            proc, tmp = _compile(
                ["g++"] + flags + ["-shared", "-fPIC", src], out
            )
            _finish(proc, tmp, out, src)
        lib = _loaded[key] = ctypes.CDLL(out)
        return lib


def nvcc_path() -> str | None:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    p = os.path.join(cuda_home, "bin", "nvcc")
    return p if os.path.exists(p) else None


def _cuda_out(name):
    src = os.path.join(CSRC, f"{name}.cu")
    deps = [src, os.path.join(CSRC, "common.cuh")]
    return src, os.path.join(
        BUILD_DIR, f"lib{name}-{_digest(deps, NVCC_FLAGS)}.so"
    )


def build_cuda(names=CUDA_SOURCES, verbose: bool = False) -> dict:
    """Compile every missing CUDA library at once (one nvcc per source,
    all started together).  Returns {name: compiler output}."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (CUDA toolkit required)")
    logs = {}
    with _lock:
        jobs = []
        for name in names:
            src, out = _cuda_out(name)
            if os.path.exists(out):
                continue
            flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
            proc, tmp = _compile([nvcc] + flags + ["-I", CSRC, src], out)
            jobs.append((name, proc, tmp, out, src))
        for name, proc, tmp, out, src in jobs:
            logs[name] = _finish(proc, tmp, out, src)
    return logs


def cuda_library(name: str) -> ctypes.CDLL:
    """Load the CUDA library `name`, building it first if needed."""
    key = ("cuda", name)
    with _lock:
        if key in _loaded:
            return _loaded[key]
    build_cuda((name,))
    with _lock:
        if key not in _loaded:
            _loaded[key] = ctypes.CDLL(_cuda_out(name)[1])
        return _loaded[key]


_functions: dict = {}
_thread = threading.local()


def cuda_function(lib_name: str, fn_name: str, argtypes):
    """Entry point `fn_name` of the CUDA library `lib_name`, typed: every
    entry point returns the cudaError_t of its launches.  The returned
    callable launches on the calling thread's current torch device (a
    caller whose tensors lie on another card enters
    `torch.cuda.device(dev)` first).  Bound once: later calls return the
    same callable without a lock, and it calls the library's `set_device`
    only where the thread's current device is not the one it last set in
    that library's runtime."""
    fn = _functions.get((lib_name, fn_name))
    if fn is None:
        fn = _bind(lib_name, fn_name, argtypes)
    return fn


def _bind(lib_name, fn_name, argtypes):
    import torch

    lib = cuda_library(lib_name)
    with _lock:
        key = (lib_name, fn_name)
        if key in _functions:
            return _functions[key]
        fn = getattr(lib, fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        set_device = lib.set_device
        set_device.restype = ctypes.c_int
        set_device.argtypes = [ctypes.c_int]
        current_device = _current_device()

        def launch(*args):
            dev = current_device()
            seen = _thread.__dict__.setdefault("devices", {})
            if seen.get(lib_name) != dev:
                rc = set_device(dev)
                if rc:
                    return rc
                seen[lib_name] = dev
            return fn(*args)

        _functions[key] = launch
        return launch


def _current_device():
    """torch's current CUDA device index, read without its lazy-init check
    (a launch follows the card's first use)."""
    import torch

    return getattr(torch._C, "_cuda_getDevice", torch.cuda.current_device)


_raw_stream = None


def current_raw_stream() -> int:
    """The handle of the current device's current CUDA stream, as a library
    entry point takes it (without making a `torch.cuda.Stream`)."""
    global _raw_stream
    if _raw_stream is None:
        import torch

        get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        device = _current_device()
        _raw_stream = ((lambda: get(device())) if get is not None else
                       (lambda: torch.cuda.current_stream().cuda_stream))
    return _raw_stream()


def check(rc: int, what: str):
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed (cudaError {rc})")


def require(cond: bool, what: str):
    """Validate what a wrapper hands a kernel (kept under python -O)."""
    if not cond:
        raise ValueError(what)


class LaunchCounter:
    """Per-kernel launch counts: a wrapper adds one for each `__global__`
    launch of its kernel, where it makes them (and only there), so a run
    can show that the main path really went through the hand-written
    kernels."""

    def __init__(self):
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, name: str, n: int = 1):
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def reset(self):
        with self._lock:
            self.counts = {k: 0 for k in self.counts}

    def get(self, name: str) -> int:
        return self.counts.get(name, 0)


LAUNCHES = LaunchCounter()
