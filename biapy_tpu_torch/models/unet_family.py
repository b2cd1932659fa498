"""The U-Net family as one configurable module.

Counterpart of ``biapy_tpu/models/unet_family.py::UNetFamily`` in 3D and
2D, for its five variants: ``unet``, ``resunet``, ``seunet`` (SqExBlock after every
conv), ``resunet_se`` (residual blocks with an extra conv and one
SqExBlock each) and ``attention_unet`` (AttentionGate on every skip).

Contract (as the JAX module's): input channels-last ``(B, z, y, x, C)``
(2D: ``(B, y, x, C)``, pooled and up-sampled by ``(yx_down, yx_down)``;
Z_DOWN and ISOTROPY do not apply), output the heads concatenated
channel-wise, or, where ``output_channel_info`` names a ``"class"`` head
(the instance and detection class heads, DATA.N_CLASSES > 2), a dict
``{"pred": the other heads, "class": the class heads}``; activations are
applied by the engine, not here. Separated decoders (one per head,
optionally with divided feature maps) and the super-resolution upsampling
before the stem (``pre``) or after each decoder (``post``) are the JAX
module's. Children carry Flax's auto-names (see blocks.py): a ``pre`` /
``post`` upsampling is a top-level ``ConvTranspose_<j>``, the
``UpBlock_<i>`` numbering runs on across separated decoders, and the 1x1
heads are the top-level ``Conv_<j>``, in head order. ``train()`` / ``eval()``
select the mode of BatchNorm and of the per-level dropout (``drop_values``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from biapy_tpu_torch.models.blocks import (
    Conv,
    ConvBlock,
    ConvTranspose,
    FlaxNamed,
    ResConvBlock,
    UpBlock,
    aniso_kernel,
    max_pool,
)

def get_decoder_feature_maps(feature_maps, num_decoders: int, divide: bool) -> List[int]:
    """Per-decoder feature maps when separated decoders are enabled
    (reference: blocks.py get_decoder_feature_maps)."""
    if num_decoders <= 1 or not divide:
        return list(feature_maps)
    return [max(1, f // num_decoders) for f in feature_maps]


class UNetFamily(FlaxNamed):
    """U-Net family: optional SR upsampling (``pre``), optional
    LARGER_IO stem, ``len(feature_maps) - 1`` encoder levels with
    max-pooling, a bottleneck, the decoder (one per head with
    ``separated_decoders``), optional SR upsampling (``post``), one 1x1x1
    head per output (concatenated)."""

    def __init__(self, variant: str = "unet", ndim: int = 3, in_channels: int = 1,
                 activation: str = "elu", feature_maps: Sequence[int] = (32, 64, 128, 256),
                 drop_values: Optional[Sequence[float]] = None, normalization: str = "none", k_size: int = 3,
                 upsample_layer: str = "convtranspose",
                 yx_down: Sequence[int] = (2, 2, 2, 2), z_down: Sequence[int] = (2, 2, 2, 2),
                 output_channels: Sequence[int] = (1,),
                 output_channel_info: Optional[Sequence[str]] = None,
                 separated_decoders: bool = False,
                 divide_decoder_feature_maps: bool = False,
                 upsampling_factor: Sequence[int] = (), upsampling_position: str = "pre",
                 isotropy: Sequence[bool] = (True,),
                 larger_io: bool = True, conv_layers: Sequence[int] = (2, 2, 2, 2, 2),
                 contrast: bool = False, conv_block_order: str = "conv_norm_act",
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        if contrast:
            raise NotImplementedError("the contrastive head is not ported yet "
                                      "(ROADMAP queue 1 item 9, other workflows)")
        fm = list(feature_maps)
        depth = len(fm) - 1
        iso = list(isotropy)
        if len(iso) == 1:
            iso = iso * len(fm)
        residual = variant in ("resunet", "resunet_se")
        se = variant in ("seunet", "resunet_se")
        extra_conv = variant == "resunet_se"
        drops = [0.0] * len(fm) if drop_values is None else [float(v) for v in drop_values]
        self.windows = [(z_down[i], yx_down[i], yx_down[i]) if ndim == 3
                        else (yx_down[i], yx_down[i]) for i in range(depth)]
        kw = dict(act=activation, norm=normalization, order=conv_block_order, ndim=ndim, gen=gen)

        def io_block(cin, feats):
            return self.child("ConvBlock", ConvBlock(
                cin, feats, aniso_kernel(k_size + 2, ndim, iso[0]), **kw))

        def enc_block(cin, feats, level, first, drop):
            k = aniso_kernel(k_size, ndim, iso[level])
            if residual:
                return self.child("ResConvBlock", ResConvBlock(
                    cin, feats, k, dropout=drop, first_block=first, se_block=se,
                    extra_conv=extra_conv, nconvs=conv_layers[level], **kw))
            return self.child("ConvBlock", ConvBlock(cin, feats, k, dropout=drop, se_block=se,
                                                     nconvs=conv_layers[level], **kw))

        up = tuple(upsampling_factor)
        self.parts["up_pre"] = self.child("ConvTranspose", ConvTranspose(
            in_channels, in_channels, up, gen=gen)) if up and upsampling_position == "pre" else None
        c = in_channels
        self.parts["stem"] = None
        if larger_io:
            self.parts["stem"] = io_block(c, fm[0])
            c = fm[0]
        self.encoder = []
        for i in range(depth):
            self.encoder.append(enc_block(c, fm[i], i, i == 0, drops[i]))
            c = fm[i]
        self.parts["bottleneck"] = enc_block(c, fm[-1], len(fm) - 1, False, drops[-1])
        n_dec = len(output_channels) if separated_decoders else 1
        dec_fm = get_decoder_feature_maps(fm, n_dec, divide_decoder_feature_maps)
        # per decoder: its stages, then its LARGER_IO out block (Flax's order)
        self.decoders = []
        for _ in range(n_dec):
            stages = []
            c = fm[-1]
            for i in range(depth - 1, -1, -1):
                stages.append(self.child("UpBlock", UpBlock(
                    c, fm[i], dec_fm[i], self.windows[i], aniso_kernel(k_size, ndim, iso[i]),
                    up_mode=upsample_layer, dropout=drops[i],
                    attention_gate=variant == "attention_unet", se_block=se, residual=residual,
                    extra_conv=extra_conv, nconvs=conv_layers[i], **kw)))
                c = dec_fm[i]
            self.decoders.append((stages, io_block(dec_fm[0], dec_fm[0]) if larger_io else None))
        self.up_post = [self.child("ConvTranspose", ConvTranspose(
            dec_fm[0], dec_fm[0], up, gen=gen)) for _ in range(n_dec)] \
            if up and upsampling_position == "post" else []
        self.heads = [self.child("Conv", Conv(dec_fm[0], oc, (1,) * ndim, gen=gen))
                      for oc in output_channels]
        info = list(output_channel_info or [""] * len(output_channels))
        self.class_head = ["class" in str(i) for i in info]

    def forward(self, x: torch.Tensor):
        if self.parts["up_pre"] is not None:
            x = self.parts["up_pre"](x)
        if self.parts["stem"] is not None:
            x = self.parts["stem"](x)
        skips = []
        for blk, win in zip(self.encoder, self.windows):
            x = blk(x)
            skips.append(x)
            x = max_pool(x, win)
        bottom = self.parts["bottleneck"](x)
        feats = []
        for j, (stages, out_block) in enumerate(self.decoders):
            h = bottom
            for stage, skip in zip(stages, reversed(skips)):
                h = stage(h, skip)
            if out_block is not None:
                h = out_block(h)
            if self.up_post:
                h = self.up_post[j](h)
            feats.append(h)
        outs = [head(feats[i] if len(feats) > 1 else feats[0])
                for i, head in enumerate(self.heads)]
        pred = torch.cat([o for o, c in zip(outs, self.class_head) if not c], dim=-1)
        if not any(self.class_head):
            return pred
        return {"pred": pred,
                "class": torch.cat([o for o, c in zip(outs, self.class_head) if c], dim=-1)}
