"""Wrapper of the Hopper paged-decode kernel (``csrc/paged_decode.cu``).

Replaces ``repro/kernels/paged_decode`` (``paged_decode_kernel``): one
launch attends every (batch row, KV head) over the pages its table row
names, up to its length, with an online softmax, gathering each K/V row
through the table as it reads it.  Any page size; repeated pages are fine.
The head size and the query heads per KV head are templates of the kernel,
built for the (dh, G) pairs of ``SHAPES``: G 1, 2, 4, 8 and 16 at dh 64 and
128, G 12 (starcoder2-15b's) and G 6 (internvl2-26b's) at dh 128 and G 8
at dh 112
(kimi-k2-1t-a32b's, 16 lanes a position over 128 padded columns), both
without the options, and G 16 at dh 256 (recurrentgemma-9b's), run as two
groups of 8 heads (``HEAD_GROUPS``); on CUDA tensors others raise
(``check_kernel_shape``).
The plain version takes any.

Two options, gemma2's: ``softcap`` > 0 caps each scaled score with
``tanh(x / cap) * cap``; ``window`` > 0 attends only to the last
``window`` positions of each row (those >= length - window).  With a
window the kernel reads only the pages the window covers: its CTAs split
``ref.window_pages`` table entries a row, starting at the window's first
page (``ref.window_start``), and mask that page's earlier positions.

The launch splits each row's pages over several CTAs (``splits``, chosen
by ``kernels.autotune`` unless the caller passes it; ``paged_splits`` is
the legacy rule, which ``autotune.disabled()`` serves) and merges their
partial softmax sums in the same launch: the last CTA of a (row, head) to
finish merges.  That takes a float32 workspace (the partials) and
a counter per (row, head, group of heads), which the wrapper keeps per
(device, stream),
grown when a call needs more and never freed.  The counters are zeroed
once, when they are allocated, and every launch leaves them zero, so no
call launches a memset; calls on one stream are ordered, and a call on
another stream gets that stream's own workspace and counters.  A call
reads no length and does not synchronise.

On CPU tensors the wrapper runs the plain version (``ref``); on CUDA
tensors it launches the kernel or raises.  q and the pages are all float32
or all bfloat16; the table and lengths are int32; everything is
contiguous.  Lengths lie in [0, pages_per_seq * page]: a row of length 0
gets the reference's answer, the mean of V over all pages_per_seq * page
positions of its pages (every score masked to -1e30, so uniform weights).
Table entries lie in [0, P): the plain version raises on an entry outside,
the kernel clamps it (it is not checked on the card, which would cost a
synchronisation).
"""
from __future__ import annotations

import itertools
import math

import torch

from .. import _build, autotune
from .ref import paged_decode_attention_ref, window_pages

# the (head size, query heads per KV head) pairs the kernel library holds,
# with the options (``OPTION_SHAPES``) and without them (``SHAPES``); (256,
# 16), recurrentgemma-9b's, has one instance a dtype, with the options,
# which serves launches without them too
OPTION_SHAPES = tuple(itertools.product((64, 128), (1, 2, 4, 8, 16))) + (
    (256, 16),)
SHAPES = OPTION_SHAPES + ((128, 12), (128, 6), (112, 8))
# pairs the kernel runs as several groups of query heads, each its own CTAs
# over the same pages (csrc/paged_decode.cu launch_dh256): the groups
HEAD_GROUPS = {(256, 16): 2}
CTAS_PER_SM = 3       # csrc/paged_decode.cu kCtasPerSm: CTAs an SM holds
MAX_SPLITS = 128      # csrc/paged_decode.cu kMaxSplits
_ENTRY = {torch.float32: "paged_decode_f32",
          torch.bfloat16: "paged_decode_bf16"}
# (device index, stream handle) -> (float32 workspace, int32 counters)
_WORKSPACES: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def check_kernel_shape(dh: int, g: int, options: bool = False) -> None:
    """Raise unless the kernel takes head size ``dh`` and ``g`` query heads
    per KV head, with the options (softcap or window) if ``options``."""
    pairs = OPTION_SHAPES if options else SHAPES
    if (dh, g) not in pairs:
        raise ValueError(
            f"head size {dh} with {g} query heads per KV head is not "
            f"supported{' with softcap or window' if options else ''}; the "
            f"kernel takes (dh, G) in {pairs}")


def paged_splits(bsz: int, kvh: int, pps: int, sms: int) -> int:
    """Splits of each row's pages: as many as keep ``CTAS_PER_SM`` CTAs on
    each of ``sms`` SMs in one wave, between 1 and ``pps`` (and at most
    ``MAX_SPLITS``); 1 once B x KVH alone fills the card."""
    return max(1, min(pps, MAX_SPLITS, CTAS_PER_SM * sms // (bsz * kvh)))


def _workspace(index: int, floats: int, rows: int) -> tuple[int, int]:
    """Pointers to the workspace (``floats`` float32) and counters
    (``rows`` int32 zeros) of device ``index``'s current stream, allocated
    (on that stream) the first time or when a call needs more."""
    key = (index, _build.current_stream(index))
    ws = _WORKSPACES.get(key)
    if ws is None or ws[0].numel() < floats or ws[1].numel() < rows:
        if ws is not None:
            floats, rows = max(floats, ws[0].numel()), max(rows,
                                                           ws[1].numel())
        dev = torch.device("cuda", index)
        ws = _WORKSPACES[key] = (
            torch.empty(floats, dtype=torch.float32, device=dev),
            torch.zeros(rows, dtype=torch.int32, device=dev))
    return ws[0].data_ptr(), ws[1].data_ptr()


def tile_key(bsz: int, kvh: int, g: int, dh: int, page: int, pps: int,
             dtype: torch.dtype, platform: str) -> autotune.TileKey:
    """The ``autotune`` key of a paged-decode launch (its fields as the
    ``TileKey`` note says, ``batch`` counting each group of heads
    (``HEAD_GROUPS``) as a head; ``pps``: the table entries the launch
    splits a row's, ``window_pages``)."""
    groups = HEAD_GROUPS.get((dh, g), 1)
    return autotune.TileKey(op="paged_decode", batch=bsz * kvh * groups,
                            lanes=pps,
                            rows=page, width=g * dh,
                            dtype=str(dtype).removeprefix("torch."),
                            platform=platform)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           scale: float | None = None,
                           splits: int | None = None, softcap: float = 0.0,
                           window: int = 0):
    """q (B, KVH, G, dh); k_pages/v_pages (KVH, P, page, dh); page_table
    (B, pages_per_seq) int32; lengths (B,) int32 -> (B, KVH, G, dh).

    ``scale=None`` means 1/sqrt(dh).  ``splits``: CTAs a row's pages are
    split over, in [1, min(n, MAX_SPLITS)], n the table entries a row's
    window can touch (``window_pages``: pages_per_seq without a window);
    None for ``autotune``'s choice.  ``softcap`` and ``window`` as the
    module says (0: off).
    """
    _build.check_operand("q", q, getattr(q, "dtype", None), 4)
    if q.dtype not in _ENTRY:
        raise TypeError(f"q: expected float32 or bfloat16, got {q.dtype}")
    bsz, kvh, g, dh = q.shape
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _build.check_operand(name, t, q.dtype, 4)
        if t.shape[0] != kvh or t.shape[3] != dh:
            raise ValueError(f"{name}: expected shape ({kvh}, P, page, {dh}), "
                             f"got {tuple(t.shape)}")
    if tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(f"v_pages: expected shape {tuple(k_pages.shape)}, "
                         f"got {tuple(v_pages.shape)}")
    _build.check_operand("page_table", page_table, torch.int32, 2)
    _build.check_operand("lengths", lengths, torch.int32, 1)
    if page_table.shape[0] != bsz or tuple(lengths.shape) != (bsz,):
        raise ValueError(f"page_table {tuple(page_table.shape)} and lengths "
                         f"{tuple(lengths.shape)} must have {bsz} rows")
    _, n_pages, page, _ = k_pages.shape
    pps = page_table.shape[1]
    if n_pages < 1 or page < 1 or pps < 1:
        raise ValueError(f"empty pool or table: pages {tuple(k_pages.shape)},"
                         f" table {tuple(page_table.shape)}")
    if window < 0 or softcap < 0:
        raise ValueError(f"window {window} and softcap {softcap} must be "
                         f">= 0")
    scale = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    dev = _build.common_device(q=q, k_pages=k_pages, v_pages=v_pages,
                               page_table=page_table, lengths=lengths)
    if dev.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                          lengths, scale=scale,
                                          softcap=softcap, window=window)
    check_kernel_shape(dh, g, options=softcap > 0 or window > 0)
    if pps * page >= 2 ** 31:
        raise ValueError(f"pages_per_seq * page = {pps * page}: the kernel "
                         f"takes fewer than 2^31 positions a row")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:            # the kernel reads 16 bytes at a time
            raise ValueError(f"{name}: data not 16-byte aligned")
    span = window_pages(window, page, pps)
    if splits is not None and not 1 <= splits <= min(span, MAX_SPLITS):
        raise ValueError(f"splits {splits} outside [1, "
                         f"{min(span, MAX_SPLITS)}]")
    out = torch.empty_like(q)
    if bsz * kvh:
        if splits is None:
            splits = autotune.choose(tile_key(
                bsz, kvh, g, dh, page, span, q.dtype,
                autotune.cuda_platform(dev.index))).splits
        ws = cnt = None
        if splits > 1:
            ws, cnt = _workspace(dev.index, bsz * kvh * splits * g * (dh + 2),
                                 bsz * kvh * HEAD_GROUPS.get((dh, g), 1))
        _build.launch("paged_decode", dev, "paged_decode", _ENTRY[q.dtype],
                      q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                      page_table.data_ptr(), lengths.data_ptr(),
                      out.data_ptr(), ws, cnt, bsz, kvh, g, n_pages, page,
                      pps, dh, splits, scale, float(softcap), int(window))
    return out
