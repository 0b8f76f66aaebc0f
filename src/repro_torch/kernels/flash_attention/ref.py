"""Plain PyTorch version of the flash-attention kernel."""
import torch


def flash_attention_ref(q, k, v, *, scale: float, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """q (B,KVH,G,S,dh); k/v (B,KVH,T,dh) -> (B,KVH,G,S,dh) in q's dtype.

    The full float32 score tensor, masked (-1e30) and softmaxed, as the JAX
    package's ``flash_attention_ref``.
    """
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
    s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqt,bhtd->bhgqd", p, v.to(torch.float32))
    return out.to(q.dtype)
