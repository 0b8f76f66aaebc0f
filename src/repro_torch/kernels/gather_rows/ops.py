"""Wrappers of the Hopper row-gather kernels (``csrc/gather_rows.cu``).

Replace ``repro/kernels/gather_rows/kernel.py``: ``gather_rows_global``
launches the global-memory kernel (for ``gather_rows_dma``),
``gather_rows_smem`` the shared-memory kernel (for ``gather_rows_vmem``),
and ``gather_rows`` picks between them from the shapes, as the reference's
``ops.gather_rows_batched`` picks by table size.

Element types.  Tables of float32, bfloat16 or float16
(``_build.SPATTER_DTYPES``), indices int32.  A gather moves bits, so one
instance of each kernel on 2-byte words serves both 16-bit types
(``gather_rows_b16``, ``gather_rows_smem_b16``, each counted under its
own name); float32 takes the ``_f32`` instances.  Nothing converts a
16-bit table to float32 and back.

The switch point.  The reference stages a table in VMEM up to 4 MiB, a TPU
figure.  On the H100 the on-chip store is shared memory, at most 227 KB
(232,448 bytes) for one block, so a pattern's (V, D) table of
``elem_bytes`` elements may be staged only when ``V * D * elem_bytes <=
SMEM_TABLE_BYTES`` (at D = 1: 58,112 float32 rows, 116,224 16-bit ones),
and only where the pattern reads at least half as many rows as it stages
(``V <= 2 * N``): the legacy rule ``use_smem``.  Within it ``kernels.autotune`` takes the
smem kernel only where its cost model (fitted to the card) says it beats
the global kernel: on an H100 that is no bucket of demo or appdb, and
demo's UNIFORM:8:1 gather bucket (V = 32,769 rows of 4 bytes, 128 KiB,
for N = 32,768 lanes), which the legacy rule stages, takes the global
kernel.

Lanes per CTA (``smem_lanes_per_cta``, the legacy rule).  The kernel runs
in clusters of ``SMEM_CLUSTER`` = 8 CTAs, one pattern a cluster: the
cluster reads its table from L2 once (multicast to its 8 shared
memories), and each CTA gathers one run of lanes.  Three terms set the
run:

- fill: the batch's lanes spread over the CTAs the card holds at once
  (``smem_resident_ctas``: the clusters that the CUDA runtime's
  ``cudaOccupancyMaxActiveClusters`` says fit for that (V, D) and element
  size, times 8; 15 clusters, 120 CTAs on an H100 SXM for demo's float32
  table, a cluster's SMs being drawn from one GPC), so a
  large batch stages each table once per SM and streams its lanes in one
  wave;
- at least ``max(256, ceil(V / 8))`` lanes, so a cluster gathers at least
  V lanes for each staging it reads from L2;
- at most ``ceil(N / 8)``: one cluster covers a pattern.

The grid is ``B`` patterns times ``ceil(N / lanes)`` CTAs rounded up to a
whole cluster (``smem_grid``); a CTA past the last lane stages and exits.
Demo's bucket takes one cluster of 4,096 lanes a CTA; 2^24 lanes on the
same table take 15 clusters of 139,811 on an H100 SXM.

Launch parameters.  The regime, the global kernel's loads in flight a
thread (``vecs``) and the smem kernel's lanes a CTA are chosen by
``kernels.autotune`` for the geometry and the card, unless the caller
passes them (a bucket callable passes what it chose when it was built,
``plan.build_bucket``).  ``use_smem`` and ``smem_lanes_per_cta`` are the
legacy rules, which ``autotune.disabled()`` serves; the search takes the
smem regime only where ``use_smem`` allows it.

On CPU tensors the wrappers run the plain version (``ref``), in the
table's dtype, which ignores every launch parameter; on CUDA tensors they
launch the kernel of the table's dtype or raise.
"""
from __future__ import annotations

import functools

import torch

from .. import _build, autotune
from .ref import gather_rows_ref

SMEM_TABLE_BYTES = 232448        # 227 KB: the H100's shared memory per block
SMEM_CLUSTER = 8                 # CTAs a cluster (csrc: kCluster)


def use_smem(v: int, n: int, d: int, elem_bytes: int) -> bool:
    """Whether a (V, D) table of ``elem_bytes`` elements gathered at N
    lanes takes the smem regime."""
    return v * d * elem_bytes <= SMEM_TABLE_BYTES and v <= 2 * n


@functools.lru_cache(maxsize=256)
def smem_lanes_per_cta(bsz: int, n: int, v: int, resident: int) -> int:
    """Lanes one CTA of the smem kernel gathers, on a card that holds
    ``resident`` of its CTAs at once (see the module note)."""
    fill = -(-bsz * n // resident)
    least = max(256, -(-v // SMEM_CLUSTER))
    return max(1, min(max(fill, least), -(-n // SMEM_CLUSTER)))


def smem_grid(bsz: int, n: int, v: int, resident: int) -> int:
    """CTAs the smem kernel launches: whole clusters, one pattern each."""
    runs = -(-n // smem_lanes_per_cta(bsz, n, v, resident))
    return bsz * -(-runs // SMEM_CLUSTER) * SMEM_CLUSTER


@functools.lru_cache(maxsize=256)
def smem_resident_ctas(v: int, d: int, index: int, elem_bytes: int) -> int:
    """CTAs of the smem kernel that card ``index`` holds at once for a
    (V, D) table of ``elem_bytes`` elements (4 or 2: the instance and its
    shared memory differ): the clusters the CUDA runtime says fit, times
    ``SMEM_CLUSTER``.  Asked once per card, shape and element size (builds
    the kernel); 0 where no cluster fits (a smaller card, a MIG slice);
    raises on a CUDA error."""
    import ctypes
    clusters = ctypes.c_int(0)
    fn = _build.c_function("gather_rows", "gather_rows_smem_clusters")
    with torch.cuda.device(index):
        err = fn(v, d, elem_bytes, ctypes.addressof(clusters))
    if err != 0:
        raise RuntimeError(f"gather_rows_smem_clusters: CUDA error {err}")
    return max(clusters.value, 0) * SMEM_CLUSTER


def _checked(table: torch.Tensor, idx: torch.Tensor):
    _build.check_operand("table", table, _build.DTYPES, 3)
    _build.check_operand("idx", idx, torch.int32, 2)
    if table.shape[0] != idx.shape[0]:
        raise ValueError(f"batch mismatch: table {tuple(table.shape)} vs "
                         f"idx {tuple(idx.shape)}")
    return _build.common_device(table=table, idx=idx)


def tile_key(op: str, bsz: int, n: int, v: int, d: int, platform: str,
             dtype) -> autotune.TileKey:
    """The ``autotune`` key of a (B, V, D) gather at N lanes of a table of
    ``dtype`` (a ``torch.dtype`` or its name)."""
    return autotune.TileKey(op=op, batch=bsz, lanes=n, rows=v, width=d,
                            dtype=str(dtype).removeprefix("torch."),
                            platform=platform)


def gather_tiles(bsz: int, n: int, v: int, d: int, device, dtype
                 ) -> autotune.TileChoice:
    """The launch a (B, V, D) gather at N lanes of a ``dtype`` table takes
    on ``device``: the regime (``smem``) and its parameter
    (``lanes_per_cta`` or ``vecs``), as ``gather_rows`` chooses them (on
    the CPU, for ``autotune.CPU_FACTS``)."""
    cpu = device.type == "cpu"
    platform = "cpu" if cpu else autotune.cuda_platform(device.index)
    eb = _build.SPATTER_DTYPES[str(dtype).removeprefix("torch.")]
    if use_smem(v, n, d, eb):
        resident = (autotune.CPU_FACTS.resident_ctas if cpu
                    else smem_resident_ctas(v, d, device.index, eb))
        smem_platform = ("cpu" if cpu
                         else autotune.cuda_platform(device.index, resident))
        if resident > 0 and autotune.choose(tile_key(
                "gather", bsz, n, v, d, smem_platform, dtype)).smem:
            return autotune.choose(tile_key("gather_smem", bsz, n, v, d,
                                            smem_platform, dtype))
    return autotune.choose(tile_key("gather_global", bsz, n, v, d, platform,
                                    dtype))


def gather_rows_global(table: torch.Tensor, idx: torch.Tensor, *,
                       vecs: int | None = None) -> torch.Tensor:
    """Batched gather from global memory: (B, V, D), (B, N) -> (B, N, D).
    ``vecs``: loads in flight a thread (1, or 4 for D = 1 and 8 otherwise:
    the deep instance; 0: the kernel's own rule); None: ``autotune``'s."""
    dev = _checked(table, idx)
    if dev.type == "cpu":
        return gather_rows_ref(table, idx)
    bsz, v, d = table.shape
    n = idx.shape[1]
    out = torch.empty((bsz, n, d), dtype=table.dtype, device=dev)
    if out.numel():
        if vecs is None:
            vecs = autotune.choose(tile_key(
                "gather_global", bsz, n, v, d,
                autotune.cuda_platform(dev.index), table.dtype)).vecs
        name, fn = _build.spatter_instance("gather_rows", table.dtype)
        _build.launch(name, dev, "gather_rows", fn, table.data_ptr(),
                      idx.data_ptr(), out.data_ptr(), bsz, n, v, d, vecs)
    return out


def gather_rows_smem(table: torch.Tensor, idx: torch.Tensor, *,
                     lanes_per_cta: int | None = None) -> torch.Tensor:
    """Batched gather with each pattern's table staged in shared memory:
    (B, V, D), (B, N) -> (B, N, D).  Raises if a table exceeds 227 KB, and
    on a card where no cluster of its CTAs fits.  ``lanes_per_cta``: None
    for ``autotune``'s choice."""
    dev = _checked(table, idx)
    bsz, v, d = table.shape
    eb = table.element_size()
    if v * d * eb > SMEM_TABLE_BYTES:
        raise ValueError(f"table of {v * d * eb} bytes exceeds the "
                         f"{SMEM_TABLE_BYTES}-byte shared-memory limit")
    if dev.type == "cpu":
        return gather_rows_ref(table, idx)
    n = idx.shape[1]
    resident = smem_resident_ctas(v, d, dev.index, eb)
    if resident < 1:
        raise RuntimeError(f"no cluster of {SMEM_CLUSTER} CTAs of the "
                           f"shared-memory gather fits on {dev} for a "
                           f"({v}, {d}) table")
    out = torch.empty((bsz, n, d), dtype=table.dtype, device=dev)
    if out.numel():
        if lanes_per_cta is None:
            lanes_per_cta = autotune.choose(tile_key(
                "gather_smem", bsz, n, v, d,
                autotune.cuda_platform(dev.index, resident),
                table.dtype)).lanes_per_cta
        name, fn = _build.spatter_instance("gather_rows_smem", table.dtype)
        _build.launch(name, dev, "gather_rows", fn, table.data_ptr(),
                      idx.data_ptr(), out.data_ptr(), bsz, n, v, d,
                      lanes_per_cta)
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                choice: autotune.TileChoice | None = None) -> torch.Tensor:
    """Batched gather, (B, V, D), (B, N) -> (B, N, D): one kernel launch
    for the whole batch, in the regime ``choice`` names (its ``smem``, with
    its ``lanes_per_cta`` or ``vecs``).  Without one, the smem regime is
    weighed only where ``use_smem`` allows it and ``autotune`` takes it
    only where it is the cheaper; on a card where no cluster of the smem
    kernel fits (``smem_resident_ctas`` is 0), such buckets take
    ``gather_rows_global``, exact as well, and count as its launches
    (``gather_rows`` or ``gather_rows_b16``): a route chosen before
    launching.  On the CPU the regime
    follows ``use_smem`` (both run the plain version)."""
    if choice is not None:
        if choice.smem:
            return gather_rows_smem(table, idx,
                                    lanes_per_cta=choice.lanes_per_cta)
        return gather_rows_global(table, idx, vecs=choice.vecs)
    bsz, v, d = table.shape
    n = idx.shape[-1]
    eb = table.element_size()
    if use_smem(v, n, d, eb):
        dev = _checked(table, idx)
        if dev.type == "cpu":
            return gather_rows_smem(table, idx)
        resident = smem_resident_ctas(v, d, dev.index, eb)
        if resident > 0 and autotune.choose(tile_key(
                "gather", bsz, n, v, d,
                autotune.cuda_platform(dev.index, resident),
                table.dtype)).smem:
            return gather_rows_smem(table, idx)
    return gather_rows_global(table, idx)
