"""Building blocks of the U-Net family and of the models beside it.

Counterpart of ``biapy_tpu/models/blocks.py`` (Conv, ConvTranspose, Dense,
get_activation, Norm, SqExBlock, ConvBlock, ResConvBlock, AttentionGate,
UpLayer, UpBlock, max_pool, DropPath), with the options the five U-Net
variants use (``unet``, ``resunet``, ``seunet``, ``resunet_se``,
``attention_unet``); ``StridedConv`` (EfficientNet's strided, depthwise and
bias-free 2D convs) and ``WeightNorm`` (Flax's ``nn.WeightNorm`` around a
``Conv``, WDSR) serve the super-resolution family and EfficientNet.
``nn.Module.train()`` / ``eval()`` select what Flax's ``train`` flag
selects: batch statistics and their running update in BatchNorm, and
dropout. Every op is differentiable (the kernels through their
``torch.autograd.Function``s).
Activations are contiguous channels-last ``(N, D, H, W, C)`` tensors, or
``(N, H, W, C)`` in 2D, and weights keep the Flax layouts (conv kernels
``k... + (Cin, Cout)``), so the z-folded ``(N*D, H, W, C)`` form the pool
and zd2s kernels take is a free ``view`` (in 2D the tensor itself, with
unit depth).

Children are named as Flax auto-names them (``Conv_0``, ``Norm_1``,
``ConvBlock_0``, ...; one counter per class, in creation order), and
parameters and statistics carry Flax's leaf names (``kernel``, ``bias``,
``scale``, ``mean``, ``var``). A module's ``state_dict`` key with ``.``
read as ``/`` is therefore the Flax path of the same leaf, which is all
the weight bridge (``models/flax_import.py``) needs.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from biapy_tpu_torch.ops.conv3d import conv_same
from biapy_tpu_torch.ops.kernels.shuffle import pool_max_folded, zd2s

IntOrTuple = Union[int, Sequence[int]]


def _expand(val: IntOrTuple, ndim: int) -> Tuple[int, ...]:
    if isinstance(val, int):
        return (val,) * ndim
    return tuple(val)


def aniso_kernel(k: int, ndim: int, isotropic: bool) -> Tuple[int, ...]:
    """(k,k) in 2D; (k,k,k) or (1,k,k) in 3D depending on level isotropy."""
    if ndim == 2:
        return (k, k)
    return (k, k, k) if isotropic else (1, k, k)


def xavier_uniform_(t: torch.Tensor, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's ``xavier_uniform`` on a ``k... + (in, out)`` kernel: fans are
    the last two axes times the receptive field."""
    receptive = math.prod(t.shape[:-2]) if t.dim() > 2 else 1
    fan_in, fan_out = t.shape[-2] * receptive, t.shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-limit, limit, generator=gen)
    return t


class FlaxNamed(nn.Module):
    """A container whose children get Flax's auto-names."""

    def __init__(self):
        super().__init__()
        self._flax_counts: Dict[str, int] = {}
        # role -> child, kept out of nn.Module's registry so each child has
        # exactly one (Flax) name in the state dict
        self.parts: Dict[str, Optional[nn.Module]] = {}

    def child(self, kind: str, module: nn.Module) -> nn.Module:
        i = self._flax_counts.get(kind, 0)
        self._flax_counts[kind] = i + 1
        self.add_module(f"{kind}_{i}", module)
        return module


class Conv(nn.Module):
    """Flax ``Conv`` counterpart, stride 1 and SAME padding (every conv of
    the U-Net family): ``kernel`` ``ks + (Cin, Cout)``, ``bias`` ``(Cout,)``;
    the conv itself is routed by ``ops/conv3d.py``."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int],
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        ks = tuple(kernel_size)
        self.kernel = nn.Parameter(xavier_uniform_(torch.empty(ks + (in_features, features)), gen))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_same(x, self.kernel.to(x.dtype)) + self.bias.to(x.dtype)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis of size ``n`` for a ``k``-wide window
    at stride ``s``: ``max((ceil(n / s) - 1) * s + k - n, 0)`` in all, the
    odd voxel after (at stride 2 on an even size: (0, 1) for k 3, (1, 2) for
    k 5, where ``padding=k // 2`` would pad (1, 1) and (2, 2))."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class StridedConv(nn.Module):
    """Flax ``Conv`` counterpart in 2D with SAME padding and the options
    the U-Net family's ``Conv`` leaves out: ``strides``, ``feature_group_count``
    (``groups``, depthwise at ``groups`` = Cin = Cout) and ``use_bias``.
    ``kernel`` ``ks + (Cin // groups, Cout)``. A 1x1 conv at stride 1 and
    one group is a ``torch.matmul``, as in ``ops/conv3d.py``; any other is
    a PyTorch convolution (cuDNN, float32 without TF32) after XLA's SAME
    padding (``same_pads``), as the JAX package leaves such a conv to XLA."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int],
                 strides: IntOrTuple = 1, groups: int = 1, use_bias: bool = True,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.ks = tuple(kernel_size)
        if len(self.ks) != 2:
            raise ValueError(f"StridedConv: want a 2D kernel, got {self.ks}")
        self.strides = _expand(strides, 2)
        self.groups = int(groups)
        self.kernel = nn.Parameter(xavier_uniform_(
            torch.empty(self.ks + (in_features // self.groups, features)), gen))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(x.dtype)
        if all(k == 1 for k in self.ks) and all(s == 1 for s in self.strides) \
                and self.groups == 1:
            y = torch.matmul(x, w.reshape(w.shape[-2], w.shape[-1]))
        else:
            pads = [same_pads(int(n), k, s)
                    for n, k, s in zip(x.shape[1:3], self.ks, self.strides)]
            flat = [p for lo_hi in reversed(pads) for p in lo_hi]
            xc = F.pad(x.movedim(-1, 1), flat)
            wc = w.permute(3, 2, 0, 1)  # (ky, kx, I, O) -> (O, I, ky, kx)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                y = F.conv2d(xc, wc, stride=self.strides, groups=self.groups)
            y = y.movedim(1, -1).contiguous()
        return y if self.bias is None else y + self.bias.to(y.dtype)


class WeightNorm(nn.Module):
    """Flax ``nn.WeightNorm`` around a ``Conv`` (default ``feature_axes=-1``,
    epsilon 1e-12): the conv runs with the kernel
    ``w * rsqrt(sum(w^2 over every axis but the last) + 1e-12) * scale``
    (Flax's ``_l2_normalize``, in float32, then cast to the input's dtype),
    one learnable scale a feature; the bias is not normalised.

    As in Flax, the conv stays its parent's child (``Conv_<i>``, with its
    ``kernel`` and ``bias``) and this module holds the scale alone, under
    Flax's leaf name ``"Conv_<i>/kernel/scale"``: one key with slashes in
    it, which ``flax_import`` and the checkpoint writer carry whole, since
    the port's dotted parameter name ``WeightNorm_<i>.Conv_<i>/kernel/scale``
    reads as the Flax path ``WeightNorm_<i>/Conv_<i>/kernel/scale``."""

    EPS = 1e-12

    def __init__(self, conv: Conv, conv_name: str, scale_init: float = 1.0):
        super().__init__()
        self.conv = [conv]  # a reference, kept out of the registry
        self.key = f"{conv_name}/kernel/scale"
        self.register_parameter(self.key, nn.Parameter(
            torch.full((conv.kernel.shape[-1],), float(scale_init))))

    def normalized_kernel(self) -> torch.Tensor:
        w = self.conv[0].kernel
        ss = (w * w).sum(dim=tuple(range(w.dim() - 1)), keepdim=True)
        return w * torch.rsqrt(ss + self.EPS) * self._parameters[self.key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv[0]
        return conv_same(x, self.normalized_kernel().to(x.dtype)) + conv.bias.to(x.dtype)


class Dense(nn.Module):
    """Flax ``Dense``: ``kernel`` ``(in, out)``, ``bias`` ``(out,)`` (none
    with ``use_bias=False``), computed in the input's dtype."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(xavier_uniform_(torch.empty(in_features, features), gen))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.kernel.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(y.dtype)


class ConvTranspose(nn.Module):
    """Flax ``ConvTranspose`` counterpart for kernel == stride (every
    upsampling site of the zoo), in the folded formulation of the JAX
    package (``models/blocks.py:220-238``): one matmul gives every
    (z, y, x) tap of every voxel, the y/x depth-to-space is a reshape and
    permute, the tiled bias is added, and the z depth-to-space is the
    ``zd2s`` kernel on the folded rows. Stride == kernel is the only form
    the U-Net family uses. A 2D scale ``(sy, sx)`` on ``(N, H, W, C)`` is
    the same with one z phase, so no ``zd2s`` (the JAX package's 2D
    matmul form, ``models/blocks.py:268-287``).

    ``lax.conv_transpose`` mirrors the kernel, so output phase (a, i, j)
    takes kernel tap (sz-1-a, sy-1-i, sx-1-j)."""

    def __init__(self, in_features: int, features: int, scale: Sequence[int],
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.ks = tuple(scale)
        if len(self.ks) not in (2, 3):
            raise ValueError(f"ConvTranspose: want a 2D or 3D scale, got {self.ks}")
        self.features = features
        self.kernel = nn.Parameter(xavier_uniform_(torch.empty(self.ks + (in_features, features)),
                                                   gen))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.kernel
        if len(self.ks) == 2:  # one z phase: (N, H, W, C) as (N, 1, H, W, C)
            x, kernel = x[:, None], kernel[None]
        sz, sy, sx = kernel.shape[:3]
        n, d, h, w, cin = x.shape
        co = self.features
        kf = kernel.to(x.dtype).flip(0, 1, 2)
        # columns ordered (i, j, a, co): after the y/x shuffle the channel
        # axis holds the z taps stacked, as zd2s takes them
        wmat = kf.permute(3, 1, 2, 0, 4).reshape(cin, sy * sx * sz * co)
        y = torch.matmul(x.reshape(n * d, h, w, cin), wmat)
        y = y + self.bias.to(y.dtype).repeat(sy * sx * sz)
        y = y.reshape(n * d, h, w, sy, sx, sz * co).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(n * d, h * sy, w * sx, sz * co)
        if sz > 1:
            y = zd2s(y.contiguous(), sz)
        if len(self.ks) == 2:
            return y.reshape(n, h * sy, w * sx, co)
        return y.reshape(n, d * sz, h * sy, w * sx, co)


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """BiaPy activation name -> function (same table as the JAX package)."""
    if not name or name.lower() in ("none", "linear"):
        return lambda x: x
    name = name.lower()
    table = {
        "relu": F.relu,
        "elu": F.elu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu default
        "silu": F.silu,
        "swish": F.silu,
        "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.01),
        "prelu": lambda x: F.leaky_relu(x, negative_slope=0.25),
        "tanh": torch.tanh,
        "sigmoid": torch.sigmoid,
        "softmax": lambda x: torch.softmax(x, dim=-1),
        "mish": lambda x: x * torch.tanh(F.softplus(x)),
        "relu6": lambda x: torch.clamp(F.relu(x), max=6.0),
        "hardswish": lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0,
    }
    if name not in table:
        raise ValueError(f"Unknown activation: {name}")
    return table[name]


_dropout_generator: Optional[torch.Generator] = None


@contextlib.contextmanager
def dropout_generator(gen: Optional[torch.Generator]) -> Iterator[None]:
    """Every ``Dropout`` forward inside the block draws from ``gen`` (a
    generator on the activations' device; None: the device's default)."""
    global _dropout_generator
    prev, _dropout_generator = _dropout_generator, gen
    try:
        yield
    finally:
        _dropout_generator = prev


class Dropout(nn.Module):
    """Flax ``Dropout``: in training each element is kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)``; the identity in eval."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, device=x.device, generator=_dropout_generator) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(nn.Module):
    """Stochastic depth (``biapy_tpu/models/blocks.py::DropPath``): in
    training each sample's branch is kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)``, its draw from the ``dropout_generator``;
    the identity in eval or at rate 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, device=x.device, generator=_dropout_generator) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class BatchNorm(nn.Module):
    """Flax ``BatchNorm``, eps 1e-5, momentum 0.9, in Flax's order of
    operations.

    Eval: the running statistics, every step in the activation's dtype.
    Training: batch statistics in float32 from E[x^2] - E[x]^2 (clipped at
    0), the normalisation in float32 with scale and bias as the activation's
    dtype holds them, the output in the activation's dtype; the running mean
    and the running BIASED variance move by ``0.9 * old + 0.1 * batch`` in
    their float32 buffers."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if not self.training:
            y = x - self.mean.to(dt)
            mul = torch.rsqrt(self.var.to(dt) + self.eps) * self.scale.to(dt)
            return y * mul + self.bias.to(dt)
        xf = x.float()
        dims = tuple(range(x.dim() - 1))
        mean = xf.mean(dim=dims)
        var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
        with torch.no_grad():
            self.mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
            self.var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        mul = torch.rsqrt(var + self.eps) * self.scale.to(dt).float()
        return ((xf - mean) * mul + self.bias.to(dt).float()).to(dt)


class GroupNorm(nn.Module):
    """Flax ``GroupNorm``: per-sample statistics over the spatial axes and
    each group's channels, computed in float32 (E[x^2] - E[x]^2, clipped at
    0), applied in float32, cast back to the activation's dtype."""

    def __init__(self, features: int, num_groups: int, eps: float = 1e-5):
        super().__init__()
        self.groups = num_groups
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        xf = x.float()
        g = xf.reshape(n, -1, self.groups, c // self.groups)
        axes = (1, 3)
        mu = g.mean(dim=axes, keepdim=True)
        var = torch.clamp((g * g).mean(dim=axes, keepdim=True) - mu * mu, min=0.0)
        shape = (n,) + (1,) * (x.dim() - 2) + (c,)
        mu = mu.expand(n, 1, self.groups, c // self.groups).reshape(shape)
        var = var.expand(n, 1, self.groups, c // self.groups).reshape(shape)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        return ((xf - mu) * mul + self.bias.float()).to(x.dtype)


class Norm(FlaxNamed):
    """Normalization by name: 'bn', 'sync_bn' (BatchNorm; one card, so the same),
    'in' (one group per channel), 'gn' (min(8, C) groups, lowered until they
    divide C) or 'none'."""

    def __init__(self, kind: str, features: int):
        super().__init__()
        self.kind = kind
        if kind in ("bn", "sync_bn"):
            self.child("BatchNorm", BatchNorm(features))
        elif kind == "gn":
            groups = min(8, features)
            while features % groups != 0:
                groups -= 1
            self.child("GroupNorm", GroupNorm(features, groups))
        elif kind == "in":
            self.child("GroupNorm", GroupNorm(features, features))
        elif kind != "none":
            raise ValueError(f"Unknown normalization: {kind}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "none":
            return x
        mod = self.BatchNorm_0 if self.kind in ("bn", "sync_bn") else self.GroupNorm_0
        return mod(x)


class SqExBlock(FlaxNamed):
    """Squeeze-and-excitation: the per-sample channel means (in 3D over y
    and x, then over z, as the JAX package's z-folded form takes them; in
    float32 one mean over the three axes differs only by rounding), two
    bias-free Dense layers (C -> max(1, C // r) -> C) with ReLU and
    sigmoid between and after, and the input scaled channel by channel."""

    def __init__(self, features: int, r: int = 16, gen: Optional[torch.Generator] = None):
        super().__init__()
        mid = max(1, features // r)
        self.child("Dense", Dense(features, mid, use_bias=False, gen=gen))
        self.child("Dense", Dense(mid, features, use_bias=False, gen=gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        if x.dim() == 5:
            s = x.mean(dim=(2, 3)).mean(dim=1)
        else:
            s = x.mean(dim=tuple(range(1, x.dim() - 1)))
        s = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(s))))
        return x * s.view((n,) + (1,) * (x.dim() - 2) + (c,))


class ConvBlock(FlaxNamed):
    """``nconvs`` stacked (conv, norm, act, dropout[, SE]) units, order
    ``conv_norm_act`` or ``norm_act_conv``; with ``se_block`` each unit ends
    in its own SqExBlock."""

    def __init__(self, in_features: int, features: int, k_size: IntOrTuple = 3,
                 act: Optional[str] = None, norm: str = "none", dropout: float = 0.0,
                 se_block: bool = False, nconvs: int = 1, order: str = "conv_norm_act",
                 ndim: int = 3, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.act = get_activation(act)
        self.order = order
        self.drop = Dropout(dropout) if dropout > 0 else None
        k = _expand(k_size, ndim)
        self.units = []
        c = in_features
        for _ in range(nconvs):
            conv = self.child("Conv", Conv(c, features, k, gen=gen))
            nrm = self.child("Norm", Norm(norm, c if order == "norm_act_conv" else features))
            se = self.child("SqExBlock", SqExBlock(features, gen=gen)) if se_block else None
            self.units.append((conv, nrm, se))
            c = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, nrm, se in self.units:
            if self.order == "norm_act_conv":
                x = conv(self.act(nrm(x)))
            else:
                x = self.act(nrm(conv(x)))
            if self.drop is not None:
                x = self.drop(x)
            if se is not None:
                x = se(x)
        return x


class ResConvBlock(FlaxNamed):
    """Residual block, in the JAX package's structure (``models/blocks.py
    ResConvBlock``): post-activation by default ([norm, act] prelude unless
    first, ``nconvs`` ConvBlocks whose last conv is bare), or full
    pre-activation with ``order='norm_act_conv'``; a 1x1x1 projection
    shortcut. ``extra_conv`` (``resunet_se``) puts one more ConvBlock first
    (after the prelude), whose output feeds the main path and is the
    shortcut itself; ``se_block`` recalibrates the sum once."""

    def __init__(self, in_features: int, features: int, k_size: IntOrTuple = 3,
                 act: Optional[str] = None, norm: str = "none", dropout: float = 0.0,
                 first_block: bool = False, se_block: bool = False, extra_conv: bool = False,
                 nconvs: int = 2, order: str = "conv_norm_act", ndim: int = 3,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.act = get_activation(act)
        k = _expand(k_size, ndim)
        kw = dict(act=act, norm=norm, dropout=dropout, ndim=ndim, gen=gen)
        self.parts["prelude"] = self.parts["extra"] = None
        self.main = []
        c = in_features
        if order == "norm_act_conv":
            if extra_conv:
                self.parts["extra"] = self.child("ConvBlock", ConvBlock(
                    c, features, k, order="norm_act_conv", **kw))
                c = features
            for _ in range(nconvs):
                self.main.append(self.child("ConvBlock", ConvBlock(
                    c, features, k, order="norm_act_conv", **kw)))
                c = features
        else:
            if not first_block:
                self.parts["prelude"] = self.child("Norm", Norm(norm, in_features))
            if extra_conv:
                self.parts["extra"] = self.child("ConvBlock", ConvBlock(c, features, k, **kw))
                c = features
            self.main.append(self.child("ConvBlock", ConvBlock(c, features, k, **kw)))
            for _ in range(max(0, nconvs - 2)):
                self.main.append(self.child("ConvBlock", ConvBlock(features, features, k, **kw)))
            if nconvs >= 2:
                self.main.append(self.child("ConvBlock", ConvBlock(
                    features, features, k, ndim=ndim, gen=gen)))
        self.parts["shortcut"] = None if extra_conv else self.child(
            "Conv", Conv(in_features, features, (1,) * ndim, gen=gen))
        self.parts["se"] = self.child("SqExBlock", SqExBlock(features, gen=gen)) \
            if se_block else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        prelude, extra = self.parts["prelude"], self.parts["extra"]
        h = x if prelude is None else self.act(prelude(x))
        if extra is not None:
            h = shortcut = extra(h)
        else:
            shortcut = self.parts["shortcut"](x)  # the raw block input
        for blk in self.main:
            h = blk(h)
        out = h + shortcut
        return out if self.parts["se"] is None else self.parts["se"](out)


class AttentionGate(FlaxNamed):
    """Attention U-Net gating of the skip connection: a 1x1x1 conv on the
    gate (then Norm) and one on the skip (no Norm, as the JAX package has
    it), ReLU of their sum, a 1x1x1 conv to one channel, Norm, sigmoid; the
    skip scaled by the result."""

    def __init__(self, skip_features: int, gate_features: int, features: int,
                 norm: str = "none", ndim: int = 3, gen: Optional[torch.Generator] = None):
        super().__init__()
        one = (1,) * ndim
        self.parts["w_g"] = self.child("Conv", Conv(gate_features, features, one, gen=gen))
        self.parts["norm_g"] = self.child("Norm", Norm(norm, features))
        self.parts["w_x"] = self.child("Conv", Conv(skip_features, features, one, gen=gen))
        self.parts["psi"] = self.child("Conv", Conv(features, 1, one, gen=gen))
        self.parts["norm_psi"] = self.child("Norm", Norm(norm, 1))

    def forward(self, x_skip: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        p = self.parts
        psi = F.relu(p["norm_g"](p["w_g"](g)) + p["w_x"](x_skip))
        return x_skip * torch.sigmoid(p["norm_psi"](p["psi"](psi)))


def upsample_linear(x: torch.Tensor, scale: Sequence[int]) -> torch.Tensor:
    """Tri/bilinear upsampling by integer factors with half-pixel centres,
    as ``jax.image.resize(method='linear')`` upsamples."""
    nd = x.dim() - 2
    mode = "trilinear" if nd == 3 else "bilinear"
    size = tuple(s * f for s, f in zip(x.shape[1:-1], scale))
    y = F.interpolate(x.movedim(-1, 1).float(), size=size, mode=mode, align_corners=False)
    return y.to(x.dtype).movedim(1, -1).contiguous()


class UpLayer(FlaxNamed):
    """Upsampling step: transposed conv, or linear upsampling and a 1-wide
    conv, then norm and activation."""

    def __init__(self, in_features: int, features: int, scale: Tuple[int, ...],
                 up_mode: str = "convtranspose", norm: str = "none",
                 act: Optional[str] = None, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.scale = tuple(scale)
        self.up_mode = up_mode
        if up_mode == "convtranspose":
            self.parts["up"] = self.child("ConvTranspose", ConvTranspose(
                in_features, features, self.scale, gen=gen))
        else:
            self.parts["up"] = self.child("Conv", Conv(
                in_features, features, (1,) * len(self.scale), gen=gen))
        self.parts["norm"] = self.child("Norm", Norm(norm, features))
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.up_mode != "convtranspose":
            x = upsample_linear(x, self.scale)
        return self.act(self.parts["norm"](self.parts["up"](x)))


class UpBlock(FlaxNamed):
    """Decoder stage: upsample, (with ``attention_gate``) gate the skip by
    the upsampled features, concat the skip, refine (ConvBlock, or
    ResConvBlock after a channel-preserving upsample when ``residual``;
    ``se_block`` and ``extra_conv`` go to the refining block)."""

    def __init__(self, in_features: int, skip_features: int, features: int,
                 scale: Tuple[int, ...], k_size: IntOrTuple = 3,
                 up_mode: str = "convtranspose", act: Optional[str] = None,
                 norm: str = "none", dropout: float = 0.0, attention_gate: bool = False,
                 se_block: bool = False, residual: bool = False, extra_conv: bool = False,
                 nconvs: int = 2, order: str = "conv_norm_act", ndim: int = 3,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.scale = tuple(scale)
        kw = dict(act=act, norm=norm, dropout=dropout, se_block=se_block, nconvs=nconvs,
                  order=order, ndim=ndim, gen=gen)
        if residual:
            self.parts["up"] = (self.child("ConvTranspose", ConvTranspose(
                in_features, in_features, self.scale, gen=gen))
                if up_mode == "convtranspose" else None)
            up_features = in_features
        else:
            self.parts["up"] = self.child("UpLayer", UpLayer(
                in_features, features, self.scale, up_mode, norm=norm, act=act, gen=gen))
            up_features = features
        self.parts["gate"] = self.child("AttentionGate", AttentionGate(
            skip_features, up_features, max(1, features // 2), norm=norm, ndim=ndim,
            gen=gen)) if attention_gate else None
        if residual:
            self.parts["refine"] = self.child("ResConvBlock", ResConvBlock(
                in_features + skip_features, features, k_size, extra_conv=extra_conv, **kw))
        else:
            self.parts["refine"] = self.child("ConvBlock", ConvBlock(
                features + skip_features, features, k_size, **kw))

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up_fn = self.parts["up"]
        up = upsample_linear(x, self.scale) if up_fn is None else up_fn(x)
        if self.parts["gate"] is not None:
            skip = self.parts["gate"](skip, up)
        return self.parts["refine"](torch.cat([up, skip], dim=-1))


def max_pool(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """Max pooling with stride == window on (N, D, H, W, C) or, in 2D, on
    (N, H, W, C). A divisible window runs the pool kernel on the folded
    (N*D, H, W, C) view (2D: the unit-depth view, window (1, wy, wx)); any
    other shape floors like XLA's VALID ``reduce_window``: in 3D through
    ``F.max_pool3d``, in 2D by cropping the rows and columns no window
    covers, then the same kernel (whose backward gives every tied slot the
    cotangent, where XLA's gives the first)."""
    w = tuple(int(v) for v in window)
    if x.dim() == 4 and len(w) == 2:
        h, wd = x.shape[1:3]
        hh, ww = h - h % w[0], wd - wd % w[1]
        if (hh, ww) != (h, wd):
            x = x[:, :hh, :ww]
        return pool_max_folded(x.contiguous(), (1,) + w)
    if x.dim() != 5 or len(w) != 3:
        raise ValueError(f"max_pool: window {w} does not fit a tensor of shape {tuple(x.shape)}")
    n, d, h, wd, c = x.shape
    if d % w[0] == 0 and h % w[1] == 0 and wd % w[2] == 0:
        y = pool_max_folded(x.contiguous().view(n * d, h, wd, c), w)
        return y.view(n, d // w[0], h // w[1], wd // w[2], c)
    y = F.max_pool3d(x.movedim(-1, 1), w, stride=w)
    return y.movedim(1, -1).contiguous()
