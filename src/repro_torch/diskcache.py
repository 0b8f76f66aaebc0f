"""Crash-safe disk tier for the executor cache and the nvcc-built kernels.

The port of ``repro.core.diskcache``.  A restarted daemon should serve a
suite it has seen without building anything, and a damaged cache
directory must cost a rebuild, never the process.  The tier keeps two
kinds of entry, one file each:

* **library**: the bytes of one nvcc-built shared library
  (``kernels._build``), keyed by its name and identity (a hash of its
  source, headers, flags, nvcc's version and the compute capability).
  ``_build.library(name, tier=...)`` loads a verified entry, or builds
  the library with nvcc and stores it here.
* **exec**: one per ``ExecKey``: the bucket recipe ``plan._bucket_fn``
  needs (backend, kind, mode) and the sha256 of each library that recipe
  launches.  Restoring it loads those libraries through the tier and
  builds nothing, so it counts ``disk_hits``, not ``misses``; an entry
  whose library now has other bytes than it recorded is stale.

The contract is the reference's:

* **Atomic writes.**  An entry is written to a tmp file in the same
  directory and ``os.replace``d into place, so a SIGKILL mid-write never
  leaves a half-written entry under a valid name.
* **Per-entry checksum.**  The payload's sha256 rides in the header; an
  entry that fails verification (bit rot, a torn write, an injected
  fault) is quarantined (renamed aside, counted) and rebuilt, never
  loaded and never fatal.
* **Invalidation in the header.**  torch's version, CUDA's version, the
  platform, nvcc's version and the compute capability must match on
  load, and so must the full key; stale entries are quarantined like
  corrupt ones.
* **Size-budgeted LRU.**  ``store`` evicts the least recently used
  entries (mtime, refreshed on every load) past ``budget_bytes``.
* **Exact counters.**  ``loads`` counts exec entries restored (the
  cache's ``disk_hits``); ``store`` failures are counted, never raised.

Entry format (``<sha256(identity)[:40]>.spx``)::

    SPTC1\\n
    {json header: format, entry, key or name, identity, toolchain, sha256, nbytes}\\n
    <payload: the recipe as JSON, or the library's bytes>

A library is loaded with ``ctypes``, which needs a file: verified bytes
are written (atomically) under ``<root>/so/`` and loaded from there.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
from pathlib import Path
from typing import Callable

from .kernels import _build
from .plan import ExecKey, _bucket_fn, bucket_libraries

MAGIC = b"SPTC1\n"
SUFFIX = ".spx"
QUAR_SUFFIX = ".quar"
DEFAULT_BUDGET_BYTES = 1 << 30          # 1 GiB: libraries are MB-scale


def exec_key_str(key: ExecKey) -> str:
    """Canonical string form of an ``ExecKey``: its disk identity.  An
    unplaced key (placement ``""``) leaves the field out, so its string,
    and so its entry, is the one written before keys had placements."""
    return "|".join(f"{f.name}={getattr(key, f.name)}"
                    for f in dataclasses.fields(ExecKey)
                    if f.name != "placement" or key.placement)


def toolchain(device) -> dict:
    """What invalidates an entry on ``device``: torch's and CUDA's
    versions, the platform, and on a card nvcc's version and the compute
    capability."""
    import torch
    cuda = device.type == "cuda"
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "platform": device.type,
            "nvcc": _build.nvcc_version() if cuda else None,
            "capability": _build.capability() if cuda else None}


class RestoredBucket:
    """A bucket callable rebuilt from an exec entry, marked as such so the
    tier never stores it back."""
    restored = True
    __slots__ = ("_fn",)

    def __init__(self, fn: Callable):
        self._fn = fn

    def __call__(self, *args):
        return self._fn(*args)


class DiskTier:
    """One directory of exec and library entries for one device's
    toolchain.

    Thread safety: counters are guarded by an internal lock; file I/O
    runs outside it (``os.replace`` is the concurrency contract: two
    writers of one entry both write whole files, the last replace wins).

    ``mangle`` is the fault-injection seam: it may corrupt a payload
    AFTER its checksum is computed, so an injected disk fault is exactly
    what the checksum must catch.
    """

    def __init__(self, root: str, *, device=None,
                 budget_bytes: int = DEFAULT_BUDGET_BYTES,
                 mangle: Callable[[bytes], bytes] | None = None):
        from .engine import resolve_device
        self.device = resolve_device(device)
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.budget_bytes = int(budget_bytes)
        self.toolchain = toolchain(self.device)
        self._mangle = mangle
        self._lock = threading.Lock()
        self.loads = 0                  # exec entries restored
        self.load_misses = 0            # no entry on disk
        self.stores = 0                 # exec entries written
        self.store_failures = 0         # write failed / nothing to store
        self.quarantined = 0            # corrupt or stale entries set aside
        self.skipped = 0                # valid, but a library would not load
        self.evicted = 0
        self.library_loads = 0
        self.library_stores = 0
        self.library_quarantined = 0    # of ``quarantined``

    # -- paths ---------------------------------------------------------------
    def _path(self, identity: str) -> str:
        digest = hashlib.sha256(identity.encode()).hexdigest()
        return os.path.join(self.root, digest[:40] + SUFFIX)

    def path_for(self, key: ExecKey) -> str:
        return self._path("exec|" + exec_key_str(key))

    def library_path(self, name: str, identity: str) -> str:
        return self._path(f"library|{name}|{identity}")

    def scratch_dir(self) -> Path:
        """Where libraries are built and loaded from (not entries)."""
        path = Path(self.root) / "so"
        path.mkdir(exist_ok=True)
        return path

    def _count(self, attr: str) -> None:
        with self._lock:
            setattr(self, attr, getattr(self, attr) + 1)

    def _quarantine(self, path: str, library: bool = False) -> None:
        try:
            os.replace(path, path + QUAR_SUFFIX)
        except OSError:
            pass
        with self._lock:
            self.quarantined += 1
            self.library_quarantined += library

    # -- writing -------------------------------------------------------------
    def _write(self, path: str, header: dict, payload: bytes) -> bool:
        header = {**header, "format": 1, "toolchain": self.toolchain,
                  "sha256": hashlib.sha256(payload).hexdigest(),
                  "nbytes": len(payload)}
        if self._mangle is not None:     # injected corruption (post-checksum)
            payload = self._mangle(payload)
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                f.write(MAGIC)
                f.write(json.dumps(header, sort_keys=True).encode())
                f.write(b"\n")
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            self._count("store_failures")
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        self._evict_to_budget()
        return True

    def store(self, key: ExecKey, fn: Callable) -> bool:
        """Persist the recipe of ``key``'s bucket callable and the sha256
        of each library it launches (all loaded by its builder).

        Returns True on success; every failure counts ``store_failures``
        and returns False: persistence never takes down a process that
        holds the callable in memory.
        """
        if getattr(fn, "restored", False):
            return False                 # came FROM disk: already there
        libs = {}
        for name in bucket_libraries(key.backend, key.kind,
                                     self.device.type):
            sha = _build.library_sha256(name)
            if sha is None:
                self._count("store_failures")
                return False
            libs[name] = sha
        payload = json.dumps({"backend": key.backend, "kind": key.kind,
                              "mode": key.mode, "libs": libs},
                             sort_keys=True).encode()
        ok = self._write(self.path_for(key),
                         {"entry": "exec", "key": dataclasses.asdict(key),
                          "key_str": exec_key_str(key)}, payload)
        if ok:
            self._count("stores")
        return ok

    def store_library(self, name: str, identity: str, payload: bytes) -> bool:
        """Persist the bytes of library ``name`` built at ``identity``."""
        ok = self._write(self.library_path(name, identity),
                         {"entry": "library", "name": name,
                          "identity": identity}, payload)
        if ok:
            self._count("library_stores")
        return ok

    def has_library(self, name: str, identity: str) -> bool:
        return os.path.exists(self.library_path(name, identity))

    def materialize(self, name: str, payload: bytes) -> Path:
        """Write verified library bytes to a file ``ctypes`` can load."""
        sha = hashlib.sha256(payload).hexdigest()
        path = self.scratch_dir() / f"{name}-{sha[:16]}.so"
        tmp = path.with_name(
            f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        tmp.write_bytes(payload)
        os.replace(tmp, path)
        return path

    # -- reading -------------------------------------------------------------
    def _read(self, path: str, library: bool = False
              ) -> tuple[dict, bytes] | None:
        """(header, payload) of a verified entry at ``path``, or None: no
        entry (``load_misses``), or one quarantined for a bad magic,
        header, toolchain or checksum."""
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            self._count("load_misses")
            return None
        header = self._parse_header(raw)
        if header is None:
            self._quarantine(path, library)
            return None
        library = library or header.get("entry") == "library"
        payload = raw[header["_payload_off"]:]
        if (header.get("toolchain") != self.toolchain
                or header.get("nbytes") != len(payload)
                or header.get("sha256")
                != hashlib.sha256(payload).hexdigest()):
            self._quarantine(path, library)
            return None
        return header, payload

    @staticmethod
    def _parse_header(raw: bytes) -> dict | None:
        if not raw.startswith(MAGIC):
            return None
        nl = raw.find(b"\n", len(MAGIC))
        if nl < 0:
            return None
        try:
            header = json.loads(raw[len(MAGIC):nl])
        except ValueError:
            return None
        if not isinstance(header, dict) or header.get("format") != 1:
            return None
        header["_payload_off"] = nl + 1
        return header

    def load_library(self, name: str, identity: str) -> bytes | None:
        """The verified bytes of library ``name`` at ``identity``, or None
        (absent, or quarantined as corrupt or stale)."""
        path = self.library_path(name, identity)
        got = self._read(path, library=True)
        if got is None:
            return None
        header, payload = got
        if (header.get("entry") != "library" or header.get("name") != name
                or header.get("identity") != identity):
            self._quarantine(path, library=True)
            return None
        self._touch(path)
        self._count("library_loads")
        return payload

    def load(self, key: ExecKey) -> Callable | None:
        """Restore ``key``'s bucket callable, or None (absent, quarantined,
        or a library would not load).  Never raises."""
        path = self.path_for(key)
        got = self._read(path)
        if got is None:
            return None
        return self._restore(path, *got, expect=key)

    def load_all(self) -> list[tuple[ExecKey, Callable]]:
        """Restore every verifiable exec entry (the daemon's preload);
        library entries are loaded when an exec entry needs them."""
        out: list[tuple[ExecKey, Callable]] = []
        for name in sorted(self._entry_names()):
            path = os.path.join(self.root, name)
            got = self._read(path)
            if got is None or got[0].get("entry") == "library":
                continue
            try:
                key = ExecKey(**got[0]["key"])
            except (KeyError, TypeError):
                self._quarantine(path)
                continue
            fn = self._restore(path, *got, expect=key)
            if fn is not None:
                out.append((key, fn))
        return out

    def _restore(self, path: str, header: dict, payload: bytes, *,
                 expect: ExecKey) -> Callable | None:
        want_libs = bucket_libraries(expect.backend, expect.kind,
                                     self.device.type)
        try:
            recipe = json.loads(payload)
            stale = (header.get("entry") != "exec"
                     or header.get("key_str") != exec_key_str(expect)
                     or (recipe["backend"], recipe["kind"], recipe["mode"])
                     != (expect.backend, expect.kind, expect.mode)
                     or not isinstance(recipe["libs"], dict)
                     or sorted(recipe["libs"]) != sorted(want_libs))
        except (ValueError, KeyError, TypeError):
            stale = True
        if stale:
            self._quarantine(path)
            return None
        for name, sha in recipe["libs"].items():
            try:
                _build.library(name, tier=self)
            except Exception:
                self._count("skipped")   # no nvcc or no card: left on disk
                return None
            if _build.library_sha256(name) != sha:
                self._quarantine(path)   # recorded against other bytes
                return None
        self._touch(path)
        self._count("loads")
        return RestoredBucket(_bucket_fn(expect.backend, expect.kind,
                                         expect.mode))

    @staticmethod
    def _touch(path: str) -> None:
        try:
            os.utime(path)              # LRU recency for the byte budget
        except OSError:
            pass

    def _entry_names(self) -> list[str]:
        try:
            return [n for n in os.listdir(self.root) if n.endswith(SUFFIX)]
        except OSError:
            return []

    # -- eviction ------------------------------------------------------------
    def _evict_to_budget(self) -> None:
        entries = []
        for name in self._entry_names():
            path = os.path.join(self.root, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, path))
        total = sum(size for _, size, _ in entries)
        entries.sort()                  # oldest mtime first
        for _, size, path in entries:
            if total <= self.budget_bytes:
                break
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= size
            self._count("evicted")

    # -- telemetry -----------------------------------------------------------
    def stats(self) -> dict:
        entries = self._entry_names()
        nbytes = 0
        for name in entries:
            try:
                nbytes += os.stat(os.path.join(self.root, name)).st_size
            except OSError:
                pass
        with self._lock:
            return {
                "root": self.root,
                "entries": len(entries),
                "bytes": nbytes,
                "budget_bytes": self.budget_bytes,
                "loads": self.loads,
                "load_misses": self.load_misses,
                "stores": self.stores,
                "store_failures": self.store_failures,
                "quarantined": self.quarantined,
                "skipped": self.skipped,
                "evicted": self.evicted,
                "library_loads": self.library_loads,
                "library_stores": self.library_stores,
                "library_quarantined": self.library_quarantined,
            }
