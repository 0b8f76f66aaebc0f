"""Plain PyTorch versions of the paged-decode kernel: the function
(``paged_decode_attention_ref``) and, for the tests, the kernel's split
arithmetic (``paged_decode_split_ref``)."""
import math

import torch

LOG2E = math.log2(math.e)
MASKED = -1e30


def split_pages(pps: int, splits: int) -> list[tuple[int, int]]:
    """The table entries [lo, hi) of each split of a row, as the kernel cuts
    them: split s takes [s pps // S, (s + 1) pps // S)."""
    return [(s * pps // splits, (s + 1) * pps // splits)
            for s in range(splits)]


def _gather(pages, page_table):
    """(KVH, P, page, dh) pages through (B, pps) -> (B, KVH, pps * page, dh)
    in float32."""
    kvh, _, page, dh = pages.shape
    b, pps = page_table.shape
    x = pages.index_select(1, page_table.reshape(-1).to(torch.int64))
    return x.reshape(kvh, b, pps * page, dh).transpose(0, 1).to(torch.float32)


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                               scale: float):
    """Gather each row's pages through the table, then masked softmax
    attention in float32, as the JAX package's ``paged_decode_attention_ref``.

    q (B, KVH, G, dh); k_pages/v_pages (KVH, P, page, dh); page_table
    (B, pages_per_seq) int; lengths (B,) int -> (B, KVH, G, dh) in q's dtype.
    """
    seq = page_table.shape[1] * k_pages.shape[2]
    s = torch.einsum("bhgd,bhsd->bhgs", q.to(torch.float32),
                     _gather(k_pages, page_table)) * scale
    pos = torch.arange(seq, device=q.device)
    valid = pos[None, :] < lengths.to(q.device)[:, None]       # (B, seq)
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), MASKED, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, _gather(v_pages, page_table))
    return out.to(q.dtype)


def paged_decode_split_ref(q, k_pages, v_pages, page_table, lengths, *,
                           scale: float, splits: int):
    """The kernel's arithmetic with ``splits`` splits a row, in float32:
    scores in the log2 domain (scale * log2(e) folded in); each split's
    partial (m, l, acc) over its positions below the length (over all of
    them, with x = -1e30, for a row of length 0), an empty split giving (m,
    l, acc) = (-1e30, 0, 0); then the merge: M = max m, weights 2^(m - M),
    out = sum(w acc) / max(sum(w l), 1e-30), rounded once to q's dtype.
    Lengths are clamped to [0, pages_per_seq * page] as the kernel does."""
    page = k_pages.shape[2]
    pps = page_table.shape[1]
    cap = pps * page
    dev = q.device
    ln = lengths.to(dev, torch.int64).clamp(0, cap)
    zero = ln == 0
    x = torch.einsum("bhgd,bhsd->bhgs", q.to(torch.float32),
                     _gather(k_pages, page_table)) * (scale * LOG2E)
    x = torch.where(zero[:, None, None, None],
                    torch.full((), MASKED, device=dev), x)
    pos = torch.arange(cap, device=dev)
    valid = (pos[None, :] < ln[:, None]) | zero[:, None]      # (B, seq)
    x = torch.where(valid[:, None, None, :], x,
                    torch.full((), -math.inf, device=dev))
    v = _gather(v_pages, page_table)
    ms, ls, accs = [], [], []
    for lo, hi in split_pages(pps, splits):
        xs = x[..., lo * page:hi * page]
        m = xs.amax(-1).clamp_min(MASKED)            # an empty split: -1e30
        p = torch.exp2(xs - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgs,bhsd->bhgd", p,
                                 v[:, :, lo * page:hi * page]))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.exp2(m - m.amax(0))
    out = (w[..., None] * acc).sum(0) / (w * l).sum(0).clamp_min(1e-30)[
        ..., None]
    return out.to(q.dtype)
