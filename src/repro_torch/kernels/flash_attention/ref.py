"""Plain PyTorch versions of the flash-attention kernels, forward and
backward."""
import torch


def _masked_scores(q, k, *, scale, causal, window, softcap):
    """The float32 scores (B,KVH,G,S,T), capped and masked (-1e30), as the
    JAX package's ``flash_attention_ref`` forms them."""
    s_len, t_len = q.shape[3], k.shape[2]
    s = torch.einsum("bhgqd,bhtd->bhgqt", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(s_len, device=q.device)[:, None]
    k_pos = torch.arange(t_len, device=q.device)[None, :]
    mask = torch.ones((s_len, t_len), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    return torch.where(mask, s, torch.full((), -1e30, device=q.device)), mask


def flash_attention_ref(q, k, v, *, scale: float, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        return_lse: bool = False):
    """q (B,KVH,G,S,dh); k/v (B,KVH,T,dh) -> (B,KVH,G,S,dh) in q's dtype.

    The full float32 score tensor, masked (-1e30) and softmaxed, as the JAX
    package's ``flash_attention_ref``.  With ``return_lse`` also each query
    row's log-sum-exp of its masked scores (B,KVH,G,S), float32: what the
    kernel's forward saves for the backward.
    """
    s, _ = _masked_scores(q, k, scale=scale, causal=causal, window=window,
                          softcap=softcap)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqt,bhtd->bhgqd", p, v.to(torch.float32))
    out = out.to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def sees_no_key(s_len, t_len, window, device=None):
    """(S,) bool: the query rows that a window leaves no key (i >= T +
    window - 1; only where S > T).  The reference masks every score of
    such a row to -1e30, so softmax weighs all T keys alike."""
    i = torch.arange(s_len, device=device)
    return (i >= t_len + window - 1) if window > 0 else i < 0


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, scale: float,
                            causal: bool = True, window: int = 0,
                            softcap: float = 0.0):
    """The backward kernel's plain version: FlashAttention-2's equations
    written out in float32 from the forward's output ``o`` and row
    log-sum-exp ``lse`` (B,KVH,G,S), for upstream gradient ``do`` of ``o``.
    Returns (dq in q's dtype, dk and dv in k's); dk and dv sum over the G
    query heads that share a KV head.

    As the JAX package's backward (``jax.vjp`` of its reference) gives it:
    with a ``softcap`` c the chain rule passes the cap, dS_raw = dS (1 -
    (s / c)^2) for capped scores s; a row that the ``window`` leaves no key
    (``sees_no_key``) has P = 1/T over all T keys, constant scores, so it
    adds dO / T to every key's dV and nothing to dQ or dK."""
    f32 = torch.float32
    q32, k32, v32 = q.to(f32), k.to(f32), v.to(f32)
    do32 = do.to(f32)
    s, mask = _masked_scores(q, k, scale=scale, causal=causal,
                             window=window, softcap=softcap)
    p = torch.exp(s - lse.to(f32)[..., None]) * mask        # P
    dv = torch.einsum("bhgqt,bhgqd->bhtd", p, do32)         # P^T dO
    empty = sees_no_key(q.shape[3], k.shape[2], window, q.device)
    if bool(empty.any()):
        dv = dv + (do32[..., empty, :].sum((2, 3)) / k.shape[2])[:, :, None]
    dp = torch.einsum("bhgqd,bhtd->bhgqt", do32, v32)       # dO V^T
    d = (do32 * o.to(f32)).sum(-1, keepdim=True)            # rowsum(dO o O)
    ds = p * (dp - d)
    if softcap > 0:
        ds = ds * torch.where(mask, 1 - (s / softcap) ** 2, 0.0)  # tanh's
    dq = torch.einsum("bhgqt,bhtd->bhgqd", ds, k32) * scale
    dk = torch.einsum("bhgqt,bhgqd->bhtd", ds, q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
