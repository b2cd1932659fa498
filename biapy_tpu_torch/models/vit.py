"""Vision Transformer backbone and classifier.

Counterpart of ``biapy_tpu/models/vit.py`` (PatchEmbed, TransformerBlock,
ViT) with Flax's parameter names and layouts: ``PatchEmbed_0/Conv_0``
(kernel ``(p,) * ndim + (C, E)``), ``pos_embed``, ``cls_token``,
``TransformerBlock_<i>`` (``LayerNorm_0``, ``MultiHeadDotProductAttention_0``
with ``query`` / ``key`` / ``value`` kernels ``(E, heads, head_dim)`` and
``out`` ``(heads, head_dim, E)``, ``LayerNorm_1``, ``Dense_0``,
``Dense_1``), the final ``LayerNorm_0`` and the head ``Dense_0``.

No Pallas kernel runs here on the JAX side (its patch embedding is a
strided XLA conv and its attention XLA einsums), so the port computes the
same functions with PyTorch matmuls: the patch embedding as a patchify
reshape and one matmul, attention as ``torch.matmul`` and softmax.
Mixed precision follows the modules' own casts as Flax does: weights cast
to the activation's dtype, LayerNorm's statistics and normalisation in
float32 with the output in the activation's dtype, the softmax in the
activation's dtype. gelu is Flax's default, the tanh approximation.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from biapy_tpu_torch.models.blocks import Conv, Dense, Dropout, FlaxNamed


class LayerNorm(nn.Module):
    """Flax ``LayerNorm`` over the last axis: statistics in float32 from
    E[x^2] - E[x]^2 (clipped at 0), the normalisation in float32 with scale
    and bias as the activation's dtype holds them, the output in the
    activation's dtype."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.to(dt).float()
        return ((xf - mean) * mul + self.bias.to(dt).float()).to(dt)


class _Projection(nn.Module):
    """One of Flax's attention ``DenseGeneral`` projections: ``kernel`` of
    ``kernel_shape`` (contracted over its ``n_in`` leading axes), ``bias`` of
    ``kernel_shape[n_in:]``; lecun-normal init as Flax's default."""

    def __init__(self, kernel_shape: Sequence[int], n_in: int,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        fan_in = math.prod(kernel_shape[:n_in])
        self.n_in = n_in
        self.kernel = nn.Parameter(torch.empty(tuple(kernel_shape)))
        with torch.no_grad():
            self.kernel.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
        self.bias = nn.Parameter(torch.zeros(tuple(kernel_shape[n_in:])))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.to(x.dtype)
        n_out = k.dim() - self.n_in
        lead = x.shape[:x.dim() - self.n_in]
        y = torch.matmul(x.reshape(*lead, -1),
                         k.reshape(math.prod(k.shape[:self.n_in]), -1))
        return y.reshape(*lead, *k.shape[k.dim() - n_out:]) + self.bias.to(x.dtype)


class MultiHeadDotProductAttention(nn.Module):
    """Flax ``MultiHeadDotProductAttention`` (self-attention, ``qkv_features``
    = ``out_features`` = the input width): q scaled by ``1 / sqrt(head_dim)``
    before the product, softmax over the keys, dropout on the weights in
    training (one mask broadcast over the batch and the heads, Flax's
    ``broadcast_dropout``)."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.heads, self.head_dim = num_heads, dim // num_heads
        for name in ("query", "key", "value"):
            setattr(self, name, _Projection((dim, num_heads, self.head_dim), 1, gen))
        self.out = _Projection((num_heads, self.head_dim, dim), 2, gen)
        self.drop = Dropout(dropout) if dropout > 0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        # (b, n, heads, head_dim) -> (b, heads, n, head_dim)
        q, k, v = (getattr(self, n)(x).transpose(1, 2) for n in ("query", "key", "value"))
        q = q / torch.as_tensor(math.sqrt(self.head_dim), dtype=dt)
        w = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
        if self.drop is not None and self.training:
            # one (q, k) mask for every sample and head
            w = w * self.drop(torch.ones(w.shape[-2:], dtype=dt, device=w.device))
        return self.out(torch.matmul(w, v).transpose(1, 2))


class PatchEmbed(FlaxNamed):
    """Non-overlapping patch embedding, Flax's strided ``Conv`` (kernel =
    stride = ``patch_size``, SAME padding: the input padded with zeros to a
    whole number of tokens, the odd voxel after), computed as a patchify
    reshape and one matmul; tokens flatten z-major, as ``reshape((B, -1,
    E))`` over the channels-last grid does."""

    def __init__(self, ndim: int, patch_size: int, in_channels: int, embed_dim: int,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.nd = int(patch_size), ndim
        # the conv's parameters under Flax's name; only its kernel and bias are used
        self.child("Conv", Conv(in_channels, embed_dim, (self.p,) * ndim, gen=gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p, nd = self.p, self.nd
        n, c = x.shape[0], x.shape[-1]
        grid = [-(-int(s) // p) for s in x.shape[1:-1]]
        pad = []
        for s, g in zip(reversed(x.shape[1:-1]), reversed(grid)):
            total = g * p - int(s)
            pad += [total // 2, total - total // 2]
        if any(pad):
            x = F.pad(x, [0, 0] + pad)
        shape = [n]
        for g in grid:
            shape += [g, p]
        x = x.reshape(*shape, c)
        perm = [0] + [1 + 2 * i for i in range(nd)] + [2 + 2 * i for i in range(nd)] + [2 * nd + 1]
        x = x.permute(perm).reshape(n, math.prod(grid), p ** nd * c)
        conv = self.Conv_0
        w = conv.kernel.to(x.dtype).reshape(p ** nd * c, -1)
        return torch.matmul(x, w) + conv.bias.to(x.dtype)


class TransformerBlock(FlaxNamed):
    """Pre-norm block: x + attention(LayerNorm(x)), then x + MLP(LayerNorm(x))
    with gelu (tanh) and dropout after each Dense when ``drop`` > 0."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, drop: float = 0.0,
                 norm_eps: float = 1e-6, gen: Optional[torch.Generator] = None):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.child("LayerNorm", LayerNorm(dim, norm_eps))
        self.child("MultiHeadDotProductAttention",
                   MultiHeadDotProductAttention(dim, num_heads, drop, gen=gen))
        self.child("LayerNorm", LayerNorm(dim, norm_eps))
        self.child("Dense", Dense(dim, hidden, gen=gen))
        self.child("Dense", Dense(hidden, dim, gen=gen))
        self.drops = nn.ModuleList([Dropout(drop), Dropout(drop)] if drop > 0 else [])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        if self.drops:
            h = self.drops[0](h)
        h = self.Dense_1(h)
        if self.drops:
            h = self.drops[1](h)
        return x + h


class ViT(FlaxNamed):
    """ViT encoder and, with ``n_classes`` > 0, classifier: the class token
    (plus ``pos_embed[:, :1]``) ahead of the patch tokens (plus
    ``pos_embed[:, 1:]``), ``depth`` blocks, then the class token's features
    (or with ``global_pool`` the mean of the patch tokens) through the final
    LayerNorm and the head. ``forward(x, features=True)`` returns every
    token's features (through the final LayerNorm when ``final_norm``), and
    with ``save_layers`` also the outputs of those blocks (1-based), as the
    JAX module does for UNETR and MAE. The grid is ``img_size`` on every
    axis, as the configuration check requires of a ViT's patch."""

    def __init__(self, ndim: int = 2, img_size: int = 224, patch_size: int = 16,
                 in_channels: int = 1, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, drop_rate: float = 0.0,
                 n_classes: int = 0, global_pool: bool = False, norm_eps: float = 1e-6,
                 final_norm: bool = True, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.global_pool, self.final_norm = global_pool, final_norm
        self.child("PatchEmbed", PatchEmbed(ndim, patch_size, in_channels, embed_dim, gen=gen))
        n = (-(-img_size // patch_size)) ** ndim
        self.pos_embed = nn.Parameter(torch.empty(1, n + 1, embed_dim))
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=gen)
            self.cls_token.normal_(0.0, 0.02, generator=gen)
        self.drop = Dropout(drop_rate) if drop_rate > 0 else None
        self.blocks = [self.child("TransformerBlock", TransformerBlock(
            embed_dim, num_heads, mlp_ratio, drop_rate, norm_eps, gen=gen)) for _ in range(depth)]
        if n_classes > 0 or final_norm:
            self.child("LayerNorm", LayerNorm(embed_dim, norm_eps))
        if n_classes > 0:
            self.child("Dense", Dense(embed_dim, n_classes, gen=gen))

    def forward(self, x: torch.Tensor, features: bool = False,
                save_layers: Optional[Sequence[int]] = None):
        dt = x.dtype
        tokens = self.PatchEmbed_0(x)
        pos = self.pos_embed.to(dt)
        cls = (self.cls_token.to(dt) + pos[:, :1]).expand(x.shape[0], 1, -1)
        h = torch.cat([cls, tokens + pos[:, 1:]], dim=1)
        if self.drop is not None:
            h = self.drop(h)
        saved: List[torch.Tensor] = []
        for i, blk in enumerate(self.blocks):
            h = blk(h)
            if save_layers and (i + 1) in save_layers:
                saved.append(h)
        if features:
            if self.final_norm:
                h = self.LayerNorm_0(h)
            return (h, saved) if save_layers else h
        if self.global_pool:
            feat = self.LayerNorm_0(h[:, 1:].mean(dim=1))
        else:
            feat = self.LayerNorm_0(h)[:, 0]
        return self.Dense_0(feat)
