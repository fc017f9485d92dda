"""Shared SAM building blocks (torch, channels-last tensors).

Counterpart of ``rsprompter_tpu/models/sam/common.py``. Tensors keep the JAX
package's NHWC layout at every public function so the two are compared like
with like; convolutions run on an NCHW view of the same memory.

Compute dtype, as flax's ``dtype=``: ``Linear`` and the convolutions compute
in ``compute_dtype`` when it is set (``apis.build.set_compute_dtype``),
casting their input, weight and bias to it at each use -- so fp32 master
parameters train through bf16 products and autograd carries the gradient
back through the cast -- and otherwise in their weight's dtype.
Normalisation layers keep fp32 parameters and statistics and return their
input's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from rsprompter_tpu_torch.parallel.distributed import all_reduce_sum, world_size


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (flax ``Dense(dtype=)``)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Fp32Linear(Linear):
    """A linear layer that stays fp32 under ``set_compute_dtype``, as a flax
    ``Dense`` built without ``dtype=`` does (the query head's MLPs)."""


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on NHWC input and output, in ``compute_dtype``."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        y = self._conv_forward(
            x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), _cast(self.bias, dt)
        )
        return y.permute(0, 2, 3, 1)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm on NHWC input, statistics in fp32 (float64 for float64
    input), output in the input's dtype (eps 1e-5), as flax's
    ``BatchNorm(momentum=0.9)``.

    Eval mode normalises with the running statistics. Train mode normalises
    with the batch's mean and its BIASED variance, computed as flax does
    (E[x^2] - E[x]^2, clipped at 0), and moves the running statistics 10%
    of the way to them -- ``nn.BatchNorm2d`` would store the unbiased
    variance instead. Under a process group of more than one rank the sums
    of x and x^2 and the count are summed over the ranks (differentiably),
    so the statistics are the global batch's, as JAX's step over the
    ``data`` mesh computes them, and the running statistics stay equal on
    every rank."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # float64 stays
        if self.training:
            dims = tuple(range(x.ndim - 1))
            if world_size() > 1:
                n = xf.new_full((1,), xf.numel() // xf.shape[-1])
                sums = all_reduce_sum(torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims), n]))
                c = xf.shape[-1]
                mean, sq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
            else:
                mean, sq = xf.mean(dim=dims), (xf * xf).mean(dim=dims)
            var = (sq - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(x.dtype)


class SamLayerNorm(nn.Module):
    """Last-axis LayerNorm, fp32 statistics, output in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class LayerNorm(SamLayerNorm):
    """flax ``nn.LayerNorm`` defaults: eps 1e-6, fp32 statistics, output in
    the promotion of the input's and the parameters' dtypes (fp32 for bf16
    input, as the parameters stay fp32)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return super().forward(x.to(dt))


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` on NHWC input: ``min(32, C)`` groups over
    (H, W, C / groups), eps 1e-6, fp32 statistics, output dtype as
    :class:`LayerNorm`."""

    def __init__(self, dim: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.groups = min(groups, dim)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        b, h, w, c = x.shape
        xg = x.float().reshape(b, h * w, self.groups, c // self.groups)
        mu = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg - mu).square().mean(dim=(1, 3), keepdim=True)
        y = ((xg - mu) * torch.rsqrt(var + self.eps)).reshape(b, h, w, c)
        return (y * self.weight.float() + self.bias.float()).to(dt)


class MLPBlock(nn.Module):
    """lin1 -> exact GELU -> lin2 (HF ``SamMLPBlock``)."""

    def __init__(self, hidden_size: int, mlp_dim: int):
        super().__init__()
        self.lin1 = Linear(hidden_size, mlp_dim)
        self.lin2 = Linear(mlp_dim, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.gelu(self.lin1(x)))


class SamFeedForward(nn.Module):
    """proj_in -> relu -> [layers.i -> relu] * (num_layers - 2) -> proj_out."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, sigmoid_output: bool = False):
        super().__init__()
        self.proj_in = Linear(input_dim, hidden_dim)
        self.layers = nn.ModuleList(
            Linear(hidden_dim, hidden_dim) for _ in range(num_layers - 2)
        )
        self.proj_out = Linear(hidden_dim, output_dim)
        self.sigmoid_output = sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.proj_in(x))
        for layer in self.layers:
            x = F.relu(layer(x))
        x = self.proj_out(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class FastConvTranspose2x2(nn.ConvTranspose2d):
    """Kernel-2 stride-2 transposed convolution on NHWC tensors.

    The JAX module computes it as one matmul plus depth-to-space (a TPU
    layout choice); here it is the plain transposed convolution with the
    ``nn.ConvTranspose2d`` weight layout (in, out, 2, 2)."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, kernel_size=2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        y = F.conv_transpose2d(
            x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), _cast(self.bias, dt),
            stride=2,
        )
        return y.permute(0, 2, 3, 1)
