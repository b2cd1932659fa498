"""Super-resolution model family: EDSR, RCAN, WDSR, DFCAN.

Counterpart of ``biapy_tpu/models/sr_models.py``, channels-last in 2D and
3D, with Flax's parameter names (``Conv_<i>`` in creation order,
``_SRUpsampling_0``, ``_ChannelAttention_<i>``, ``_FCAB_<i>``,
``WeightNorm_<i>``). Every conv is a ``blocks.Conv`` (``ops/conv3d.py``: a
3x3x3 conv takes the conv3d kernel, a 1x1(x1) conv a ``torch.matmul``, a
2D conv a PyTorch convolution) or, in WDSR, a ``blocks.WeightNorm`` around
one. Upsampling is ``pixel_shuffle``, the JAX package's reshape and
transpose (no kernel of its own on either side). The models return the
output with no activation; the engine applies it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from biapy_tpu_torch.models.blocks import Conv, FlaxNamed, WeightNorm


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Depth-to-space of a channels-last 2D or 3D batch, as the JAX package
    orders it: the channels split as ``(r, r[, r], out_c)``, ``out_c``
    fastest, each ``r`` interleaved after its own axis (not
    ``torch.nn.PixelShuffle``'s ``(out_c, r, r)`` order)."""
    nd = x.dim() - 2
    b, spatial, c = x.shape[0], tuple(x.shape[1:-1]), x.shape[-1]
    r = int(scale)
    out_c = c // r ** nd
    x = x.reshape((b,) + spatial + (r,) * nd + (out_c,))
    perm = [0]
    for d in range(nd):
        perm += [1 + d, 1 + nd + d]
    perm += [1 + 2 * nd]
    return x.permute(perm).reshape((b,) + tuple(s * r for s in spatial) + (out_c,))


def _k3(nd: int):
    return (3,) * nd


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # Flax's nn.gelu default


class _SRUpsampling(FlaxNamed):
    """Conv and pixel shuffle; factor 4 is two x2 steps."""

    def __init__(self, ndim: int, num_filters: int, factor: int = 2,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.steps = 2 if factor == 4 else 1
        self.f = 2 if factor == 4 else int(factor)
        for _ in range(self.steps):
            self.child("Conv", Conv(num_filters, num_filters * self.f ** ndim, _k3(ndim),
                                    gen=gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.steps):
            x = pixel_shuffle(getattr(self, f"Conv_{i}")(x), self.f)
        return x


class EDSR(FlaxNamed):
    """Enhanced Deep SR: a stem conv, ``num_res_blocks`` (conv, ReLU, conv)
    residual blocks, a conv and the global skip, the upsampling and the
    output conv."""

    def __init__(self, ndim: int = 2, scale: int = 2, num_filters: int = 64,
                 num_res_blocks: int = 16, num_channels: int = 1,
                 out_channels: Optional[int] = None, gen: Optional[torch.Generator] = None):
        super().__init__()
        k, f = _k3(ndim), num_filters
        self.child("Conv", Conv(num_channels, f, k, gen=gen))
        self.blocks = [(self.child("Conv", Conv(f, f, k, gen=gen)),
                        self.child("Conv", Conv(f, f, k, gen=gen)))
                       for _ in range(num_res_blocks)]
        self.parts["tail"] = self.child("Conv", Conv(f, f, k, gen=gen))
        self.child("_SRUpsampling", _SRUpsampling(ndim, f, scale, gen=gen))
        self.parts["out"] = self.child("Conv", Conv(f, out_channels or num_channels, k, gen=gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h0 = h = self.Conv_0(x)
        for c1, c2 in self.blocks:
            h = h + c2(F.relu(c1(h)))
        h = self.parts["tail"](h) + h0
        return self.parts["out"](self._SRUpsampling_0(h))


class _ChannelAttention(FlaxNamed):
    """Squeeze channel attention: the spatial mean, a 1x1 conv to
    ``features // reduction`` channels, ReLU, a 1x1 conv back, sigmoid, and
    the input scaled by it."""

    def __init__(self, ndim: int, features: int, reduction: int = 16,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        one = (1,) * ndim
        self.child("Conv", Conv(features, features // reduction, one, gen=gen))
        self.child("Conv", Conv(features // reduction, features, one, gen=gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=tuple(range(1, x.dim() - 1)), keepdim=True)
        s = self.Conv_1(F.relu(self.Conv_0(s)))
        return x * torch.sigmoid(s)


class RCAN(FlaxNamed):
    """Residual Channel Attention Network: ``num_rg`` residual groups of
    ``num_rcab`` RCABs (conv, ReLU, conv, channel attention, skip) and a
    conv each, a conv and the global skip, then (``upscaling_layer`` and
    ``scale`` > 1) one conv to ``filters * scale^ndim`` channels and one
    ``pixel_shuffle(scale)``, and the output conv."""

    def __init__(self, ndim: int = 2, scale: int = 2, filters: int = 16, num_rg: int = 10,
                 num_rcab: int = 20, reduction: int = 16, num_channels: int = 1,
                 out_channels: Optional[int] = None, upscaling_layer: bool = True,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        k, f = _k3(ndim), filters
        self.scale = int(scale)
        self.child("Conv", Conv(num_channels, f, k, gen=gen))
        self.groups = []
        for _ in range(num_rg):
            rcabs = [(self.child("Conv", Conv(f, f, k, gen=gen)),
                      self.child("Conv", Conv(f, f, k, gen=gen)),
                      self.child("_ChannelAttention",
                                 _ChannelAttention(ndim, f, reduction, gen=gen)))
                     for _ in range(num_rcab)]
            self.groups.append((rcabs, self.child("Conv", Conv(f, f, k, gen=gen))))
        self.parts["tail"] = self.child("Conv", Conv(f, f, k, gen=gen))
        self.parts["up"] = (self.child("Conv", Conv(f, f * self.scale ** ndim, k, gen=gen))
                            if upscaling_layer and self.scale > 1 else None)
        self.parts["out"] = self.child("Conv", Conv(f, out_channels or num_channels, k, gen=gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h0 = h = self.Conv_0(x)
        for rcabs, g_end in self.groups:
            g_in = h
            for c1, c2, att in rcabs:
                h = h + att(c2(F.relu(c1(h))))
            h = g_end(h) + g_in
        h = self.parts["tail"](h) + h0
        if self.parts["up"] is not None:
            h = pixel_shuffle(self.parts["up"](h), self.scale)
        return self.parts["out"](h)


class WDSR(FlaxNamed):
    """Wide-activation SR: every conv weight-normalised (``WeightNorm``) with
    the reference's scale inits (1; 2 on each block's expanding conv;
    ``1 / sqrt(num_res_blocks)`` on its reducing conv), a body of
    ``num_res_blocks`` (expand, ReLU, reduce) residual blocks to
    ``scale^ndim * out`` channels, a 5x5 skip conv on the input, each
    pixel-shuffled, summed."""

    def __init__(self, ndim: int = 2, scale: int = 2, num_filters: int = 32,
                 num_res_blocks: int = 16, res_block_expansion: int = 6, num_channels: int = 1,
                 out_channels: Optional[int] = None, gen: Optional[torch.Generator] = None):
        super().__init__()
        k, f = _k3(ndim), num_filters
        self.scale = int(scale)
        num_outputs = self.scale ** ndim * (out_channels or num_channels)
        res_scale = 1.0 / math.sqrt(num_res_blocks)

        def wn(cin, features, ksize, g):
            i = self._flax_counts.get("Conv", 0)
            conv = self.child("Conv", Conv(cin, features, ksize, gen=gen))
            return self.child("WeightNorm", WeightNorm(conv, f"Conv_{i}", g))

        self.parts["head"] = wn(num_channels, f, k, 1.0)
        self.blocks = [(wn(f, f * res_block_expansion, k, 2.0),
                        wn(f * res_block_expansion, f, k, res_scale))
                       for _ in range(num_res_blocks)]
        self.parts["body_out"] = wn(f, num_outputs, k, 1.0)
        self.parts["skip"] = wn(num_channels, num_outputs, (5,) * ndim, 1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.parts["head"](x)
        for expand, reduce in self.blocks:
            h = h + reduce(F.relu(expand(h)))
        body = pixel_shuffle(self.parts["body_out"](h), self.scale)
        return body + pixel_shuffle(self.parts["skip"](x), self.scale)


class _FCAB(FlaxNamed):
    """Fourier channel attention block: conv, gelu, conv, gelu (``h``); the
    attention from the gamma-compressed (power 0.8) magnitude of ``h``'s
    spatial FFT, fftshifted, through a conv, ReLU, the spatial mean and the
    squeeze / excite 1x1 convs (``max(4, filters // 16)`` wide), sigmoid;
    ``x + h * s``.

    The FFT takes ``h`` as complex64 whatever its dtype, as the JAX module
    casts it, so the spectrum and its conv are float32; with a bf16 ``h``
    the product ``h * s`` and the block's output are float32, as JAX's type
    promotion makes them."""

    def __init__(self, ndim: int, filters: int = 64, gen: Optional[torch.Generator] = None):
        super().__init__()
        k, f, one = _k3(ndim), filters, (1,) * ndim
        sq = max(4, f // 16)
        self.child("Conv", Conv(f, f, k, gen=gen))
        self.child("Conv", Conv(f, f, k, gen=gen))
        self.child("Conv", Conv(f, f, k, gen=gen))
        self.child("Conv", Conv(f, sq, one, gen=gen))
        self.child("Conv", Conv(sq, f, one, gen=gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(1, x.dim() - 1))
        h = _gelu(self.Conv_1(_gelu(self.Conv_0(x))))
        spec = torch.fft.fftn(h.to(torch.complex64), dim=axes).abs()
        f = torch.fft.fftshift(torch.pow(spec + 1e-8, 0.8), dim=axes)
        f = F.relu(self.Conv_2(f))
        s = f.mean(dim=axes, keepdim=True)
        s = torch.sigmoid(self.Conv_4(F.relu(self.Conv_3(s))))
        return x + h * s


class DFCAN(FlaxNamed):
    """Deep Fourier Channel Attention Network: a 64-filter stem conv and
    gelu, ``n_resgroup`` groups of ``n_rcab`` FCABs each with a group skip,
    a conv to ``64 * scale^ndim`` channels, gelu, ``pixel_shuffle(scale)``
    and the output conv."""

    FILTERS = 64

    def __init__(self, ndim: int = 2, scale: int = 2, n_resgroup: int = 4, n_rcab: int = 4,
                 num_channels: int = 1, out_channels: Optional[int] = None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        k, f = _k3(ndim), self.FILTERS
        self.scale = int(scale)
        self.child("Conv", Conv(num_channels, f, k, gen=gen))
        self.groups = [[self.child("_FCAB", _FCAB(ndim, f, gen=gen)) for _ in range(n_rcab)]
                       for _ in range(n_resgroup)]
        self.child("Conv", Conv(f, f * self.scale ** ndim, k, gen=gen))
        self.child("Conv", Conv(f, out_channels or num_channels, k, gen=gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _gelu(self.Conv_0(x))
        for fcabs in self.groups:
            g = h
            for fcab in fcabs:
                g = fcab(g)
            h = h + g
        h = pixel_shuffle(_gelu(self.Conv_1(h)), self.scale)
        return self.Conv_2(h)
