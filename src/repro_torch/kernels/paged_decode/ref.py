"""Plain PyTorch version of the paged-decode kernel."""
import torch


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                               scale: float):
    """Gather each row's pages through the table, then masked softmax
    attention in float32, as the JAX package's ``paged_decode_attention_ref``.

    q (B, KVH, G, dh); k_pages/v_pages (KVH, P, page, dh); page_table
    (B, pages_per_seq) int; lengths (B,) int -> (B, KVH, G, dh) in q's dtype.
    """
    b, kvh, _, dh = q.shape
    page = k_pages.shape[2]
    seq = page_table.shape[1] * page
    flat = page_table.reshape(-1).to(torch.int64)

    def gather(pages):                      # -> (B, KVH, seq, dh)
        x = pages.index_select(1, flat)     # (KVH, B * pps, page, dh)
        return x.reshape(kvh, b, seq, dh).transpose(0, 1).to(torch.float32)

    s = torch.einsum("bhgd,bhsd->bhgs", q.to(torch.float32),
                     gather(k_pages)) * scale
    pos = torch.arange(seq, device=q.device)
    valid = pos[None, :] < lengths.to(q.device)[:, None]       # (B, seq)
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, gather(v_pages))
    return out.to(q.dtype)
