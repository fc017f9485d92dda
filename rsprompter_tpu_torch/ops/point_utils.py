"""Point sampling of mask logits for the query head's losses (plain torch).

Counterpart of ``rsprompter_tpu/ops/point_utils.py`` (reference
``mmdet/models/utils/point_sample.py``, ``grid_sample`` semantics with
``align_corners=False`` and zero padding: a point at ``(x, y)`` in [0, 1]
reads pixel coordinates ``(x W - 0.5, y H - 0.5)``, and a corner outside the
map reads 0). Three samplers, each a four-corner gather on the flattened
masks:

* :func:`sample_mask_points`, per-mask points, through ``grid_sample``;
* :func:`sample_mask_points_shared`, one point set for every mask, exact
  fp32 (the Hungarian match cost's);
* :func:`sample_mask_points_bf16`, per-mask points with JAX's numbers for
  the losses (PARITY deviation 10): each axis's two corner weights and the
  mask values rounded to bf16, the products summed in fp32, and the
  gradient with respect to the masks rounded to bf16, whatever the masks'
  dtype. JAX builds this sampler from one-hot products on the MXU; that
  layout is a TPU device and is not copied, its numbers are.

:func:`uncertain_point_coords` keeps the most uncertain (-|logit|) of the
oversampled candidates, ties broken lowest index first as ``lax.top_k``
does, and fills the rest with the uniform ``rand`` points. Every function
takes its uniforms from the caller. Every sampler takes leading batch
dimensions, so a head samples all its decoder layers in one call.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rsprompter_tpu_torch.ops.sampling import grid_sample_nhwc


def sample_mask_points(masks: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """masks (N, H, W), points (N, P, 2) in [0, 1], (x, y) -> (N, P) fp32."""
    return grid_sample_nhwc(masks[..., None], 2.0 * points - 1.0)[..., 0]


def _pixel_coords(points: torch.Tensor, h: int, w: int):
    """Corner (x0, y0) and the fractional parts (wx1, wy1) of each point."""
    x = points[..., 0].float() * w - 0.5
    y = points[..., 1].float() * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    return x0, y0, x - x0, y - y0


def _clip_index(i: torch.Tensor, size: int) -> torch.Tensor:
    return i.clamp(0, size - 1).long()


def _inside(i: torch.Tensor, size: int) -> torch.Tensor:
    return (i >= 0) & (i < size)


def sample_mask_points_shared(masks: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """masks (..., N, H, W), one point set per leading index (..., P, 2) ->
    (..., N, P) fp32. The masks may be an expanded view (the GT of every
    decoder layer). Sums as JAX's ``sample_mask_points_shared`` orders them."""
    h, w = masks.shape[-2:]
    flat = masks.flatten(-2)  # (..., N, H*W)
    x0, y0, wx1, wy1 = _pixel_coords(points, h, w)  # (..., P)

    def take(yi, xi):
        idx = _clip_index(yi, h) * w + _clip_index(xi, w)
        idx = idx.unsqueeze(-2).expand(*flat.shape[:-1], idx.shape[-1])
        vals = torch.gather(flat, -1, idx).float()
        inside = (_inside(yi, h) & _inside(xi, w)).unsqueeze(-2)
        return torch.where(inside, vals, 0.0)

    def wt(t):
        return t.unsqueeze(-2)

    return (
        take(y0, x0) * wt((1 - wy1) * (1 - wx1))
        + take(y0, x0 + 1) * wt((1 - wy1) * wx1)
        + take(y0 + 1, x0) * wt(wy1 * (1 - wx1))
        + take(y0 + 1, x0 + 1) * wt(wy1 * wx1)
    )


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _bf16_corners(points: torch.Tensor, h: int, w: int):
    """Flat indices of the four corners (y0 x0, y0 x1, y1 x0, y1 x1) and the
    bf16-rounded per-axis weights ((wy0, wy1), (wx0, wx1)), zero outside."""
    x0, y0, wx1, wy1 = _pixel_coords(points, h, w)

    def axis(i0, w1, size):
        return [(_clip_index(i, size), _bf16(torch.where(_inside(i, size), wgt, 0.0)))
                for i, wgt in ((i0, 1.0 - w1), (i0 + 1.0, w1))]

    (ya, wya), (yb, wyb) = axis(y0, wy1, h)
    (xa, wxa), (xb, wxb) = axis(x0, wx1, w)
    idx = torch.stack([ya * w + xa, ya * w + xb, yb * w + xa, yb * w + xb])
    return idx, (wya, wyb), (wxa, wxb)


class _SampleBf16(torch.autograd.Function):
    """JAX's ``sample_mask_points_matmul`` as a gather: the row sum
    ``wy0 m[y0, x] + wy1 m[y1, x]`` at the two columns, then
    ``rows[x0] wx0 + rows[x1] wx1``, each product rounded once in fp32 as the
    two one-hot products round it. Backward: ``g wx`` in fp32, times ``wy``,
    summed into each pixel in fp32, then rounded to bf16 (the cotangent of
    the bf16 cast of the masks)."""

    @staticmethod
    def forward(ctx, masks: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        h, w = masks.shape[-2:]
        flat = masks.flatten(-2)
        idx, (wya, wyb), (wxa, wxb) = _bf16_corners(points, h, w)
        m = [_bf16(torch.gather(flat, -1, i)) for i in idx]
        rows_a = wya * m[0] + wyb * m[2]
        rows_b = wya * m[1] + wyb * m[3]
        ctx.save_for_backward(idx, wya, wyb, wxa, wxb)
        ctx.shape, ctx.dtype = masks.shape, masks.dtype
        return rows_a * wxa + rows_b * wxb

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None
        idx, wya, wyb, wxa, wxb = ctx.saved_tensors
        ga, gb = g.float() * wxa, g.float() * wxb
        shape = ctx.shape
        grad = torch.zeros(*shape[:-2], shape[-2] * shape[-1], dtype=torch.float32,
                           device=g.device)
        for i, v in zip(idx, (wya * ga, wya * gb, wyb * ga, wyb * gb)):
            grad.scatter_add_(-1, i, v)
        return _bf16(grad).to(ctx.dtype).reshape(shape), None


def sample_mask_points_bf16(masks: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """masks (..., H, W), points (..., P, 2) in [0, 1] -> (..., P) fp32, with
    JAX's bf16 numbers (module docstring). The masks may be an expanded view
    and of any dtype (uint8 GT, fp32 or bf16 logits)."""
    return _SampleBf16.apply(masks, points)


def uncertain_point_coords(
    mask_logits: torch.Tensor,  # (N, H, W)
    cand: torch.Tensor,  # (N, int(num_points * oversample_ratio), 2) uniforms
    rand: torch.Tensor,  # (N, num_points - int(num_points * importance_ratio), 2)
    num_points: int,
    importance_sample_ratio: float,
) -> torch.Tensor:
    """(N, num_points, 2) coordinates in [0, 1]: the ``int(num_points *
    importance_sample_ratio)`` candidates of highest uncertainty -|logit|
    (sampled with :func:`sample_mask_points_bf16` without gradient; equal
    values lowest index first), then ``rand``."""
    k_imp = int(num_points * importance_sample_ratio)
    if rand.shape[-2] != num_points - k_imp:
        raise ValueError(f"rand holds {rand.shape[-2]} points, expected {num_points - k_imp}")
    with torch.no_grad():
        uncertainty = -sample_mask_points_bf16(mask_logits.detach(), cand).abs()
        idx = torch.sort(uncertainty, dim=-1, descending=True, stable=True).indices[..., :k_imp]
    imp = torch.gather(cand, -2, idx[..., None].expand(*idx.shape, 2))
    return torch.cat([imp, rand.to(imp.dtype)], dim=-2)


def point_draw_shapes(num_points: int, oversample_ratio: float,
                      importance_sample_ratio: float) -> Tuple[int, int]:
    """(candidates, uniform points) per mask, as JAX's sampler sizes them."""
    return (int(num_points * oversample_ratio),
            num_points - int(num_points * importance_sample_ratio))
