"""Dense and 3x3 stride-2 conv layers with flax's semantics.

- Initialisation as flax's defaults: kernels ``lecun_normal`` (a normal
  truncated at two standard deviations, scaled by fan-in), biases zero.
  A layer's kernel is zero until ``flax_init_`` draws it, as a flax
  module holds no parameters until ``init``: ``flax_init_`` draws every
  kernel of a module tree as flax's ``model.init(PRNGKey(seed), ...)``
  does, jax.random's bits from the key of the module's path
  (``utils/prng.py::param_key``), in flax's layout, then moved to
  torch's by ``weight_from_kernel``; the same values on every device.
- ``compute_dtype`` as flax's ``dtype``: parameters stay as stored (f32),
  each call casts its input, weight and bias to the compute dtype.
- Conv padding as flax's ``SAME``: at stride 2 a 3x3 kernel pads (0, 1) on
  even inputs, so the padding is explicit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dpcx_torch.utils import prng


def weight_from_kernel(kernel):
    """A flax kernel (numpy or torch) in torch's layout: Dense ``[in,
    out]`` -> ``[out, in]``, Conv HWIO -> OIHW."""
    if kernel.ndim == 2:
        return kernel.T
    if kernel.ndim == 4:
        if isinstance(kernel, torch.Tensor):
            return kernel.permute(3, 2, 0, 1)
        return kernel.transpose(3, 2, 0, 1)
    raise ValueError(f"unexpected kernel rank {kernel.ndim}")


def flax_init_(model: nn.Module, seed: int) -> nn.Module:
    """Every Dense and conv kernel of ``model`` as flax's init from
    ``PRNGKey(seed)`` draws it: the kernel is the first parameter of its
    module, so its key is ``param_key(seed, path, 1)``, the path being the
    module's names (the port's module names are flax's). Biases are
    zero from the start, as flax's. Drawn on the kernel's device, a
    chunk of counters at a time (``prng.DRAW_CHUNK`` on the card,
    ``prng.CPU_DRAW_CHUNK`` on the CPU)."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (Dense, Conv3x3s2)):
                w = mod.weight
                kernel = prng.lecun_normal(
                    prng.param_key(seed, name.split("."), 1),
                    mod.flax_shape, mod.fan_in, w.device)
                w.copy_(weight_from_kernel(kernel))
    return model


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(lo, hi) padding of flax/XLA ``SAME`` along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Dense(nn.Module):
    def __init__(self, features_in: int, features_out: int, compute_dtype,
                 device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.flax_shape = (features_in, features_out)
        self.fan_in = features_in
        self.weight = nn.Parameter(
            torch.zeros(features_out, features_in, device=device)
        )
        self.bias = nn.Parameter(torch.zeros(features_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.linear(x.to(cd), self.weight.to(cd), self.bias.to(cd))


class Conv3x3s2(nn.Module):
    """3x3 conv, stride 2, SAME padding, NCHW."""

    def __init__(self, channels_in: int, channels_out: int, compute_dtype,
                 device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.flax_shape = (3, 3, channels_in, channels_out)
        self.fan_in = channels_in * 9
        self.weight = nn.Parameter(
            torch.zeros(channels_out, channels_in, 3, 3, device=device)
        )
        self.bias = nn.Parameter(torch.zeros(channels_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        top, bottom = same_pads(x.shape[-2], 3, 2)
        left, right = same_pads(x.shape[-1], 3, 2)
        x = F.pad(x.to(cd), (left, right, top, bottom))
        return F.conv2d(x, self.weight.to(cd), self.bias.to(cd), stride=2)
