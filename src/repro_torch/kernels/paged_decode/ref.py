"""Plain PyTorch versions of the paged-decode kernel: the function
(``paged_decode_attention_ref``) and, for the tests, the kernel's split
arithmetic (``paged_decode_split_ref``).

Both take the two options of gemma2's decode: ``softcap`` > 0 caps each
scaled score with ``tanh(x / cap) * cap``, and ``window`` > 0 keeps only
the keys at positions >= length - window (the last ``window`` positions,
as the JAX package's ring buffer of ``window`` slots holds them after the
write at position length - 1).  A row whose every key is masked (length
0) gets uniform weights over all its pages' positions, window or not."""
import math

import torch

LOG2E = math.log2(math.e)
MASKED = -1e30


def split_pages(pps: int, splits: int) -> list[tuple[int, int]]:
    """The table entries [lo, hi) of each split of a row, as the kernel cuts
    them: split s takes [s pps // S, (s + 1) pps // S)."""
    return [(s * pps // splits, (s + 1) * pps // splits)
            for s in range(splits)]


def window_pages(window: int, page: int, pps: int) -> int:
    """Table entries a row's window can touch: every entry without a
    window; with one, the pages that ``window`` consecutive positions can
    straddle, ceil((window - 1) / page) + 1, at most ``pps``.  The kernel
    splits only these entries over its CTAs."""
    if window <= 0:
        return pps
    return min(pps, -(-(window - 1) // page) + 1)


def window_start(length: int, window: int, page: int, pps: int) -> tuple:
    """(first table entry of the row's split range, first position it
    attends to) for a row of ``length`` (clamped) positions: (0, 0)
    without a window or for length 0; else the window's first position
    w = max(0, length - window) and the entry of its page, moved back so
    that the ``window_pages`` entries from it end within the table."""
    if window <= 0 or length <= 0:
        return 0, 0
    w_lo = max(0, length - window)
    return min(w_lo // page, pps - window_pages(window, page, pps)), w_lo


def _gather(pages, page_table):
    """(KVH, P, page, dh) pages through (B, pps) -> (B, KVH, pps * page, dh)
    in float32."""
    kvh, _, page, dh = pages.shape
    b, pps = page_table.shape
    x = pages.index_select(1, page_table.reshape(-1).to(torch.int64))
    return x.reshape(kvh, b, pps * page, dh).transpose(0, 1).to(torch.float32)


def _softcap(x, softcap: float):
    return torch.tanh(x / softcap) * softcap if softcap > 0 else x


def _valid(lengths, seq: int, window: int, device):
    """(B, seq): the positions a row attends to."""
    pos = torch.arange(seq, device=device)[None, :]
    ln = lengths.to(device, torch.int64)[:, None]
    valid = pos < ln
    if window > 0:
        valid &= pos >= ln - window
    return valid


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                               scale: float, softcap: float = 0.0,
                               window: int = 0):
    """Gather each row's pages through the table, then masked softmax
    attention in float32, as the JAX package's ``paged_decode_attention_ref``
    (which has neither option; its ``gqa_decode`` computes both in plain
    ``jnp``).

    q (B, KVH, G, dh); k_pages/v_pages (KVH, P, page, dh); page_table
    (B, pages_per_seq) int; lengths (B,) int -> (B, KVH, G, dh) in q's dtype.
    """
    seq = page_table.shape[1] * k_pages.shape[2]
    s = _softcap(torch.einsum("bhgd,bhsd->bhgs", q.to(torch.float32),
                              _gather(k_pages, page_table)) * scale, softcap)
    valid = _valid(lengths, seq, window, q.device)             # (B, seq)
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), MASKED, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, _gather(v_pages, page_table))
    return out.to(q.dtype)


def paged_decode_split_ref(q, k_pages, v_pages, page_table, lengths, *,
                           scale: float, splits: int, softcap: float = 0.0,
                           window: int = 0):
    """The kernel's arithmetic with ``splits`` splits a row, in float32:
    scores in the log2 domain (scale * log2(e) folded in, or with a
    softcap tanh(s scale / cap) cap log2(e)); each split's partial (m, l,
    acc) over its positions below the length and, with a window, at or
    past its first position (over all of them, with x = -1e30, for a row
    of length 0), an empty split giving (m, l, acc) = (-1e30, 0, 0); then
    the merge: M = max m, weights 2^(m - M), out = sum(w acc) / max(sum(w
    l), 1e-30), rounded once to q's dtype.  Split s of a row takes the
    table entries [e0 + s n // S, e0 + (s + 1) n // S), n =
    ``window_pages`` and e0 from ``window_start`` (0 and pps without a
    window or for a row of length 0).  Lengths are clamped to [0,
    pages_per_seq * page] as the kernel does."""
    page = k_pages.shape[2]
    pps = page_table.shape[1]
    cap = pps * page
    dev = q.device
    ln = lengths.to(dev, torch.int64).clamp(0, cap)
    zero = ln == 0
    s = torch.einsum("bhgd,bhsd->bhgs", q.to(torch.float32),
                     _gather(k_pages, page_table))
    x = (_softcap(s * scale, softcap) * LOG2E if softcap > 0
         else s * (scale * LOG2E))
    x = torch.where(zero[:, None, None, None],
                    torch.full((), MASKED, device=dev), x)
    valid = _valid(ln, cap, window, dev) | zero[:, None]      # (B, seq)
    x = torch.where(valid[:, None, None, :], x,
                    torch.full((), -math.inf, device=dev))
    v = _gather(v_pages, page_table)
    n = window_pages(window, page, pps)
    # (B, cap): the split each position falls in (-1: none of them)
    which = torch.full((ln.shape[0], cap), -1, dtype=torch.int64, device=dev)
    for b, length in enumerate(ln.tolist()):
        e0, _ = window_start(length, window, page, pps)
        span = pps if length == 0 else n
        for i, (lo, hi) in enumerate(split_pages(span, splits)):
            which[b, (e0 + lo) * page:(e0 + hi) * page] = i
    ms, ls, accs = [], [], []
    for i in range(splits):
        xs = torch.where((which == i)[:, None, None, :], x,
                         torch.full((), -math.inf, device=dev))
        m = xs.amax(-1).clamp_min(MASKED)            # an empty split: -1e30
        p = torch.exp2(xs - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgs,bhsd->bhgd", p, v))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.exp2(m - m.amax(0))
    out = (w[..., None] * acc).sum(0) / (w * l).sum(0).clamp_min(1e-30)[
        ..., None]
    return out.to(q.dtype)
