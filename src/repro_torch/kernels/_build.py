"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use, on the machine with the card, into its own shared library::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

then loaded with ``ctypes`` (every pointer and the stream as ``c_void_p``).
The library's name carries a hash of its source, of the shared headers
(``csrc/*.cuh``) and of the flags, so a stale library is never loaded;
``build_all`` starts one ``nvcc`` per source, all at once.  The output
directory, ``src/repro_torch/_build/``, is listed in ``.gitignore``.
Nothing here runs at import time.

``launches`` counts kernel launches by kernel name: each wrapper adds one
where it launches its kernel, and nowhere else, so a caller can show that
a run went through the kernels (``reset_launches`` sets every count to 0).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("gather_rows", "scatter_rows", "selective_scan",
           "flash_attention", "paged_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("gather_rows", "gather_rows_smem", "scatter_store_rows",
           "scatter_add_rows", "selective_scan", "flash_attention",
           "paged_decode")
launches: dict[str, int] = {k: 0 for k in KERNELS}

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}   # (library, function)
_lock = threading.Lock()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F32 = ctypes.c_float
# C signatures: (argtypes) -> int (cudaError_t of the launch)
_SIGNATURES = {
    "gather_rows": {
        # table, idx, out, B, N, V, D, stream
        "gather_rows_f32": (_P, _P, _P, _I64, _I64, _I64, _I64, _P),
        # table, idx, out, B, N, V, D, lanes_per_cta, stream
        "gather_rows_smem_f32": (_P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                                 _P),
        # V, D, int *clusters (no stream: a query, not a launch)
        "gather_rows_smem_clusters": (_I64, _I64, _P),
    },
    "scatter_rows": {
        # dst, idx, keep, vals, B, N, V, D, stream
        "scatter_store_rows_f32": (_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                   _P),
        # dst, idx, vals, B, N, V, D, stream
        "scatter_add_rows_f32": (_P, _P, _P, _I64, _I64, _I64, _I64, _P),
    },
    "selective_scan": {
        # u, dt, b, c, a, d_skip, y, h_final, B, L, D, N, stream
        "selective_scan_f32": (_P,) * 8 + (_I64,) * 4 + (_P,),
        "selective_scan_bf16": (_P,) * 8 + (_I64,) * 4 + (_P,),
    },
    "flash_attention": {
        # q, k, v, out, B, KVH, G, S, T, DH, scale, causal, window, softcap,
        # stream
        f"flash_attention_{t}": (_P,) * 4 + (_I64,) * 6 + (_F32, _I32, _I64,
                                                            _F32, _P)
        for t in ("f32", "bf16")
    },
    "paged_decode": {
        # q, k_pages, v_pages, page_table, lengths, out, B, KVH, G, P, page,
        # pages_per_seq, DH, scale, stream
        f"paged_decode_{t}": (_P,) * 6 + (_I64,) * 7 + (_F32, _P)
        for t in ("f32", "bf16")
    },
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (PATH or CUDA_HOME)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):    # what sources include
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every stale source, one ``nvcc`` per source in parallel.

    Returns ``{name: ptxas report}`` for the sources it compiled (empty
    when every library was already built).  Raises on a failed compile.
    """
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)     # atomic: a reader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _libs[name] = lib
        return lib


def check_operand(name: str, t, dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-d tensor of ``dtype``."""
    import torch
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def common_device(**tensors):
    """The one device all operands lie on: ``cpu`` (the plain versions
    run) or ``cuda`` (the kernels run); anything else raises."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def c_function(lib_name: str, fn: str):
    """C function ``fn`` of library ``lib_name``, looked up once: later
    calls read a dict, with no lock."""
    c_fn = _fns.get((lib_name, fn))
    if c_fn is None:
        c_fn = _fns[(lib_name, fn)] = getattr(library(lib_name), fn)
    return c_fn


def current_stream(index: int) -> int:
    """The handle of device ``index``'s current CUDA stream.  PyTorch's raw
    getter (the one its Triton launchers use) skips building the Stream
    object that makes ``torch.cuda.current_stream(...).cuda_stream`` cost
    microseconds of host time a launch; the public call stands in where a
    PyTorch lacks the getter."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(kernel: str, device, lib_name: str, fn: str, *args) -> None:
    """Call C function ``fn`` of library ``lib_name`` on ``device``'s
    current stream (no synchronisation) and count one launch of
    ``kernel``; raises if the launch reported a CUDA error.  The device
    is made current only when it is not already."""
    import torch
    c_fn = c_function(lib_name, fn)
    here = torch.cuda.current_device()
    if device.index is None or device.index == here:
        err = c_fn(*args, current_stream(here))
    else:
        with torch.cuda.device(device):
            err = c_fn(*args, current_stream(device.index))
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")
    launches[kernel] += 1
