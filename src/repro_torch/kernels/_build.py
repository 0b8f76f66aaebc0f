"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use, on the machine with the card, into its own shared library::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -split-compile=0 \\
         -o _build/<name>-<hash>.so csrc/<name>.cu

then loaded with ``ctypes`` (every pointer and the stream as ``c_void_p``).
A library's identity (``lib_identity``) is a hash of its source, of the
shared headers (``csrc/*.cuh``), of the flags, of nvcc's version and of
the card's compute capability, and its file name carries that hash, so a
stale library is never loaded; ``build_all`` starts one ``nvcc`` per
source, all at once.  The output directory, ``src/repro_torch/_build/``,
is listed in ``.gitignore``.  Nothing here runs at import time.

A disk tier (``library(name, tier=...)``, ``repro_torch.diskcache``)
takes the place of ``_build/``: the library is loaded from the tier's
verified entry, or built by nvcc and then stored there, so a corrupt or
torn file is quarantined and rebuilt instead of failing at
``ctypes.CDLL``.  ``nvcc_runs`` counts the nvcc processes started.

``launches`` counts kernel launches by kernel name: each wrapper adds one
where it launches its kernel, and nowhere else, so a caller can show that
a run went through the kernels (``reset_launches`` sets every count to 0).
Worker threads launch at once, so every count moves under one lock.
``observe_launches`` also lists each launch that one thread makes inside a
block, with its device (the census of ``repro_torch.analysis.census``):
a process-wide count cannot say which thread launched.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("gather_rows", "scatter_rows", "selective_scan",
           "flash_attention", "paged_decode", "rglru_scan")
# -split-compile=0: nvcc optimises a source's template instances on every
# core; on an H100 host (8 cores, nvcc 12.9) csrc/paged_decode.cu's 44
# instances built in 25.5 s, not 53.4, to the same registers and spills
# (probes/nvcc_time_probe.py)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0")

KERNELS = ("gather_rows", "gather_rows_smem", "scatter_store_rows",
           "scatter_store_rows_cov", "scatter_add_rows", "selective_scan",
           "flash_attention", "paged_decode", "gather_rows_b16",
           "gather_rows_smem_b16", "scatter_store_rows_b16",
           "scatter_store_rows_cov_b16", "scatter_add_rows_bf16",
           "scatter_add_rows_f16", "rglru_scan", "flash_attention_bwd",
           "selective_scan_bwd", "rglru_scan_bwd")
# the Spatter kernels' element types and their bytes: float32, and the two
# 16-bit types, which the gathers and stores serve with one instance on
# 2-byte words
SPATTER_DTYPES = {"float32": 4, "bfloat16": 2, "float16": 2}
DTYPES = tuple(getattr(torch, n) for n in SPATTER_DTYPES)
launches: dict[str, int] = {k: 0 for k in KERNELS}
nvcc_runs = 0                    # nvcc processes started by this process

_libs: dict[str, ctypes.CDLL] = {}
_loaded: dict[str, tuple[Path, str]] = {}   # library -> (file, its sha256)
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}   # (library, function)
_lock = threading.Lock()         # loads and builds of libraries
_count_lock = threading.Lock()   # launches and nvcc_runs
_toolchain: dict[str, str] = {}  # memo of nvcc_version / capability
_observers = threading.local()   # per thread: lists observe_launches fills

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F32 = ctypes.c_float
# C signatures: (argtypes) -> int (cudaError_t of the launch)
_SIGNATURES = {
    "gather_rows": {
        # table, idx, out, B, N, V, D, vecs, stream
        "gather_rows_f32": (_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P),
        # table, idx, out, B, N, V, D, lanes_per_cta, stream
        "gather_rows_smem_f32": (_P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                                 _P),
        # the same on 2-byte elements
        "gather_rows_b16": (_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P),
        "gather_rows_smem_b16": (_P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                                 _P),
        # V, D, elem_bytes, int *clusters (no stream: a query, not a launch)
        "gather_rows_smem_clusters": (_I64, _I64, _I64, _P),
    },
    "scatter_rows": {
        # dst, idx, keep, vals, B, N, V, D, vecs, stream
        "scatter_store_rows_f32": (_P,) * 4 + (_I64,) * 5 + (_P,),
        # dst, idx, keep, vals, cov, B, N, V, D, vecs, stream
        "scatter_store_rows_cov_f32": (_P,) * 5 + (_I64,) * 5 + (_P,),
        "scatter_store_rows_b16": (_P,) * 4 + (_I64,) * 5 + (_P,),
        "scatter_store_rows_cov_b16": (_P,) * 5 + (_I64,) * 5 + (_P,),
        # dst, idx, vals, B, N, V, D, ctas (0: the streaming route), stream
        **{f"scatter_add_rows_{t}": (_P,) * 3 + (_I64,) * 5 + (_P,)
           for t in ("f32", "bf16", "f16")},
    },
    "selective_scan": {
        # u, dt, b, c, a, d_skip, y, h_final, B, L, D, N, stream
        "selective_scan_f32": (_P,) * 8 + (_I64,) * 4 + (_P,),
        "selective_scan_bf16": (_P,) * 8 + (_I64,) * 4 + (_P,),
        # u, dt, b, c, a, d_skip, y, h_final, ckpt, B, L, D, N, stream
        **{f"selective_scan_ckpt_{t}": (_P,) * 9 + (_I64,) * 4 + (_P,)
           for t in ("f32", "bf16")},
        # u, dt, b, c, a, d_skip, dy, dh_final (null: none), ckpt, du, ddt,
        # db, dc, da, dd, part_bc, part_a, part_d, B, L, D, N, stream
        **{f"selective_scan_bwd_{t}": (_P,) * 18 + (_I64,) * 4 + (_P,)
           for t in ("f32", "bf16")},
        # N, bf16, int *out (no stream: a query, not a launch)
        "selective_scan_bwd_attrs": (_I64, _I64, _P),
    },
    "flash_attention": {
        # q, k, v, out, lse (null: not written), B, KVH, G, S, T, DH, scale,
        # causal, window, softcap, stream
        **{f"flash_attention_{t}": (_P,) * 5 + (_I64,) * 6 + (
            _F32, _I32, _I64, _F32, _P) for t in ("f32", "bf16")},
        # q, k, v, out, dout, lse, dq, dk, dv, delta, dq_acc (bf16's float32
        # dQ workspace; null for f32), B, KVH, G, S, T, DH, scale, causal,
        # window, softcap, stream
        **{f"flash_attention_bwd_{t}": (_P,) * 11 + (_I64,) * 6 + (
            _F32, _I32, _I64, _F32, _P) for t in ("f32", "bf16")},
        # DH, window, int *out (no stream: a query, not a launch)
        "flash_attention_bwd_attrs": (_I64, _I64, _P),
    },
    "rglru_scan": {
        # a, beta, gx, h0, hs, h_last, B, S, W, stream
        "rglru_scan_f32": (_P,) * 6 + (_I64,) * 3 + (_P,),
        # a, beta, gx, h0, hs, dhs, dh_last (null: none), da, dbeta, dgx,
        # dh0, B, S, W, stream
        "rglru_scan_bwd_f32": (_P,) * 11 + (_I64,) * 3 + (_P,),
    },
    "paged_decode": {
        # q, k_pages, v_pages, page_table, lengths, out, workspace,
        # counters, B, KVH, G, P, page, pages_per_seq, DH, splits, scale,
        # softcap, window, stream
        f"paged_decode_{t}": (_P,) * 8 + (_I64,) * 8 + (_F32, _F32, _I64, _P)
        for t in ("f32", "bf16")
    },
}


def spatter_instance(kernel: str, dtype) -> tuple[str, str]:
    """(launch-count name, C function) of Spatter kernel ``kernel`` (its
    float32 name, e.g. ``gather_rows``) on elements of ``dtype`` (a
    ``torch.dtype`` or its name): float32 keeps the name and calls
    ``<name>_f32``; the gathers and stores take the one 2-byte instance
    ``<name>_b16`` for bfloat16 and float16, the add one instance a type
    (``scatter_add_rows_bf16``, ``_f16``).  Any other dtype raises."""
    name = str(dtype).removeprefix("torch.")
    if name not in SPATTER_DTYPES:
        raise TypeError(f"{kernel}: dtype {name} not supported: one of "
                        f"{', '.join(SPATTER_DTYPES)}")
    if name == "float32":
        return kernel, f"{kernel}_f32"
    suffix = {"bfloat16": "bf16", "float16": "f16"}[name] \
        if kernel == "scatter_add_rows" else "b16"
    return f"{kernel}_{suffix}", f"{kernel}_{suffix}"


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


@contextlib.contextmanager
def observe_launches():
    """Yield a list that gets one ``(kernel, device)`` entry for each
    launch this thread makes inside the block (``device`` as ``cuda:N``);
    other threads' launches are not listed.  Blocks may nest."""
    stack = getattr(_observers, "stack", None)
    if stack is None:
        stack = _observers.stack = []
    seen: list[tuple[str, str]] = []
    stack.append(seen)
    try:
        yield seen
    finally:
        stack.pop()


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


def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (its release and build), asked
    once a process."""
    if "nvcc" not in _toolchain:
        out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                             text=True, timeout=120, check=True).stdout
        _toolchain["nvcc"] = out.strip().splitlines()[-1]
    return _toolchain["nvcc"]


def capability() -> str:
    """The current card's compute capability, as ``"9.0"``."""
    if "capability" not in _toolchain:
        major, minor = torch.cuda.get_device_capability()
        _toolchain["capability"] = f"{major}.{minor}"
    return _toolchain["capability"]


def lib_identity(name: str) -> str:
    """sha256 of everything a library's binary depends on: its source,
    the shared headers it includes, the flags, nvcc's version and the
    card's compute capability."""
    h = hashlib.sha256()
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):    # what sources include
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(f"\nnvcc {nvcc_version()}\nsm {capability()}".encode())
    return h.hexdigest()


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{lib_identity(name)[:16]}.so"


def _compile(jobs: dict[str, Path]) -> dict[str, str]:
    """Compile ``csrc/<name>.cu`` to each ``{name: output path}``, one
    ``nvcc`` per source, all at once; each output appears atomically.

    Returns ``{name: ptxas report}``; raises on a failed compile.
    """
    global nvcc_runs
    nvcc = nvcc_path()
    procs = {}
    for name, out in jobs.items():
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
        with _count_lock:
            nvcc_runs += 1
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


def build_all() -> dict[str, str]:
    """Compile every stale source into ``_build/``, one ``nvcc`` per
    source in parallel.

    Returns ``{name: ptxas report}`` for the sources it compiled (empty
    when every library was already built).  Raises on a failed compile.
    """
    todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return _compile(todo)


def _load(name: str, path: Path) -> ctypes.CDLL:
    """``ctypes.CDLL`` the library at ``path`` with its C signatures, and
    remember it and the sha256 of its bytes; caller holds ``_lock``."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _loaded[name] = (path, hashlib.sha256(path.read_bytes()).hexdigest())
    _libs[name] = lib
    return lib


def _from_tier(name: str, tier) -> Path:
    """The path of a verified copy of library ``name`` from ``tier``:
    its stored bytes, or else a fresh nvcc build that is then stored.
    Caller holds ``_lock``."""
    ident = lib_identity(name)
    payload = tier.load_library(name, ident)
    if payload is None:
        scratch = tier.scratch_dir()
        out = scratch / f"{name}-{ident[:16]}.{os.getpid()}.so"
        _compile({name: out})
        payload = out.read_bytes()
        out.unlink(missing_ok=True)
        tier.store_library(name, ident, payload)
    return tier.materialize(name, payload)


def library(name: str, tier=None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.

    Without ``tier`` it comes from ``_build/``.  With a disk tier
    (``repro_torch.diskcache.DiskTier``) it comes from the tier's
    verified entry, or is built by nvcc and stored there; a library this
    process loaded earlier is stored into the tier if the tier lacks it.
    """
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            if tier is not None and not tier.has_library(
                    name, lib_identity(name)):
                tier.store_library(name, lib_identity(name),
                                   _loaded[name][0].read_bytes())
            return lib
        if tier is not None:
            return _load(name, _from_tier(name, tier))
        path = _lib_path(name)
        if not path.exists():
            build_all()
        return _load(name, path)


def library_sha256(name: str) -> str | None:
    """sha256 of the bytes of library ``name`` as this process loaded
    them (None before it is loaded)."""
    with _lock:
        return _loaded[name][1] if name in _loaded else None


def check_operand(name: str, t, dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-d tensor of ``dtype`` (or
    of one of a tuple of dtypes)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    allowed = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in allowed:
        want = (dtype if len(allowed) == 1
                else "one of " + ", ".join(map(str, allowed)))
        raise TypeError(f"{name}: expected {want}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise where autograd would have to pass kernel ``kernel``, which has
    no backward: grad is on and an operand requires it.  (Its output would
    otherwise carry no gradient, silently.)"""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel}: no backward kernel yet (ROADMAP, the training "
            "queue); run it without grad, or train through another path")


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
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(kernel: str, device, lib_name: str, fn: str, *args) -> None:
    """Call C function ``fn`` of library ``lib_name`` on ``device``'s
    current stream (no synchronisation) and count one launch of
    ``kernel``; raises if the launch reported a CUDA error.  The device
    is made current only when it is not already."""
    c_fn = c_function(lib_name, fn)
    here = torch.cuda.current_device()
    if device.index is None or device.index == here:
        err = c_fn(*args, current_stream(here))
    else:
        with torch.cuda.device(device):
            err = c_fn(*args, current_stream(device.index))
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")
    with _count_lock:
        launches[kernel] += 1
    stack = getattr(_observers, "stack", None)
    if stack:
        where = f"cuda:{here if device.index is None else device.index}"
        for seen in stack:
            seen.append((kernel, where))
