"""ViT attention with SAM's decomposed relative position bias, in plain torch.

Counterpart of ``rsprompter_tpu/ops/attention.py``:

    attn[b, n, (h, w), (kh, kw)] += q[b, n, h, w, :] . Rh[h, kh, :]
                                  + q[b, n, h, w, :] . Rw[w, kw, :]

with Rh / Rw gathered from learned (2S-1, d) tables, linearly resized when the
table length does not match the token grid. :func:`attention_rel_pos` is the
plain version of kernel C (``ops/fused_vit_attention.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rsprompter_tpu_torch.ops.resize import resize


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Gather per-(q, k) embeddings (q_size, k_size, d) from a (L, d) table."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = resize(rel_pos, (max_rel_dist, rel_pos.shape[1]), "linear")
    q_coords = torch.arange(q_size, dtype=torch.float32)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, dtype=torch.float32)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.to(torch.long).to(rel_pos.device)]


def rel_pos_factors(
    q: torch.Tensor,
    rel_pos_h: torch.Tensor,
    rel_pos_w: torch.Tensor,
    hw: Tuple[int, int],
    fp32: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (N, n, h*w, d) -> fh (N, n, h*w, h), fw (N, n, h*w, w) in q's dtype:
    fh[q, kr] = q . Rh[qr, kr] and fw[q, kc] = q . Rw[qc, kc]. ``fp32``
    computes them in fp32 and casts after, as JAX's flash route does
    (``flash_attention.py:255-260``)."""
    h, w = hw
    n_, nh, s, d = q.shape
    ct = torch.float32 if fp32 else q.dtype
    rh = get_rel_pos(h, h, rel_pos_h).to(ct)
    rw = get_rel_pos(w, w, rel_pos_w).to(ct)
    q_r = q.reshape(n_, nh, h, w, d).to(ct)
    fh = torch.einsum("bnhwc,hkc->bnhwk", q_r, rh).reshape(n_, nh, s, h)
    fw = torch.einsum("bnhwc,wkc->bnhwk", q_r, rw).reshape(n_, nh, s, w)
    return fh.to(q.dtype), fw.to(q.dtype)


def attention_rel_pos(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    hw: Tuple[int, int],
    rel_pos_h: Optional[torch.Tensor] = None,
    rel_pos_w: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q, k, v (B, n, h*w, d) -> (B, n, h*w, d): exact softmax attention,
    fp32 scores and softmax, output in q's dtype."""
    h, w = hw
    b, n, s, d = q.shape
    if s != h * w:
        raise ValueError(f"attention_rel_pos: {s} tokens for a {h}x{w} grid")
    scores = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * d ** -0.5
    if rel_pos_h is not None:
        fh, fw = rel_pos_factors(q, rel_pos_h, rel_pos_w, hw)
        bias = fh.float()[..., :, None] + fw.float()[..., None, :]
        scores = scores + bias.reshape(b, n, s, s)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bnqk,bnkd->bnqd", probs, v.float()).to(q.dtype)
