"""Model factory.

Counterpart of ``biapy_tpu/models/__init__.py::build_model`` for the U-Net
family in 3D and 2D (``unet``, ``resunet``, ``seunet``, ``resunet_se``,
``attention_unet``), with the separated decoders of IMAGE_TO_IMAGE,
INSTANCE_SEG and DETECTION and the super-resolution upsampling, for the
super-resolution family (``edsr``, ``rcan``, ``wdsr``, ``dfcan``; the
configuration check allows ``rcan`` and ``dfcan`` in 3D), for the
classifiers ``simple_cnn`` and ``vit`` in 3D and 2D and for
``efficientnet_b0``-``b7`` (2D). Other architectures, ``efficientnet_v2*``
among them, are not ported yet and raise ``NotImplementedError`` naming the
ROADMAP item.

Returns ``(module, model_build_kwargs)`` like the JAX factory.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

UNET_FAMILY = ("unet", "resunet", "resunet++", "seunet", "resunet_se", "attention_unet")
CLASSIFIERS = ("simple_cnn", "vit")
SR_FAMILY = ("edsr", "rcan", "wdsr", "dfcan")
EFFICIENTNETS = tuple(f"efficientnet_b{i}" for i in range(8))

# ViT presets selectable by MODEL.VIT_MODEL ("custom" takes the MODEL.VIT_*
# values); the JAX package's table but for the 2D-only sam3_vit
_VIT_PRESETS = {
    "vit_base_patch16": dict(patch_size=16, embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0),
    "vit_large_patch16": dict(patch_size=16, embed_dim=1024, depth=24, num_heads=16,
                              mlp_ratio=4.0),
    "vit_huge_patch14": dict(patch_size=14, embed_dim=1280, depth=32, num_heads=16,
                             mlp_ratio=4.0),
}


def _vit_kwargs(cfg, ndim: int) -> Dict:
    """The ViT's keyword arguments from MODEL.VIT_* and the preset (a copy of
    ``biapy_tpu/models/__init__.py::_vit_kwargs``)."""
    kw = dict(
        ndim=ndim,
        patch_size=int(cfg.MODEL.VIT_TOKEN_SIZE),
        embed_dim=int(cfg.MODEL.VIT_EMBED_DIM),
        depth=int(cfg.MODEL.VIT_NUM_LAYERS),
        num_heads=int(cfg.MODEL.VIT_NUM_HEADS),
        mlp_ratio=float(cfg.MODEL.VIT_MLP_RATIO),
        in_channels=int(cfg.DATA.PATCH_SIZE[-1]),
        img_size=int(cfg.DATA.PATCH_SIZE[0]),
        drop_rate=float(cfg.MODEL.DROPOUT_VALUES[0]) if cfg.MODEL.DROPOUT_VALUES else 0.0,
        norm_eps=float(cfg.MODEL.VIT_NORM_EPS),
    )
    kw.update(_VIT_PRESETS.get(str(cfg.MODEL.VIT_MODEL).lower(), {}))
    return kw


def build_model(cfg, output_channels: List[int], output_channel_info: List[str],
                head_activations: List[str],
                gen: Optional[torch.Generator] = None) -> Tuple[torch.nn.Module, Dict]:
    arch = str(cfg.MODEL.ARCHITECTURE).lower()
    if str(cfg.MODEL.SOURCE).lower() != "biapy":
        raise NotImplementedError(
            f"MODEL.SOURCE '{cfg.MODEL.SOURCE}' is not ported yet (ROADMAP queue 1 "
            "items 10-11, rest of the zoo / BMZ)")
    ndim = 3 if cfg.PROBLEM.NDIM == "3D" else 2
    if arch in CLASSIFIERS:
        if arch == "simple_cnn":
            from biapy_tpu_torch.models.simple_cnn import SimpleCNN

            kwargs = dict(ndim=ndim, n_classes=int(output_channels[0]))
            return (SimpleCNN(**kwargs, input_shape=tuple(cfg.DATA.PATCH_SIZE), gen=gen),
                    {"class": "SimpleCNN", **kwargs})
        from biapy_tpu_torch.models.vit import ViT

        kwargs = _vit_kwargs(cfg, ndim)
        kwargs["n_classes"] = int(output_channels[0]) if output_channels else int(
            cfg.DATA.N_CLASSES)
        return ViT(**kwargs, gen=gen), {"class": "ViT", **kwargs}
    if arch in SR_FAMILY:
        from biapy_tpu_torch.models import sr_models

        # the JAX factory's rule: the last axis' factor, x2 on every axis when
        # PROBLEM.SUPER_RESOLUTION.UPSCALING is empty (any workflow but SR)
        upscaling = tuple(cfg.PROBLEM.SUPER_RESOLUTION.UPSCALING) or (2,) * ndim
        kwargs = dict(ndim=ndim, scale=int(upscaling[-1]),
                      num_channels=int(cfg.DATA.PATCH_SIZE[-1]),
                      out_channels=(int(output_channels[0]) if output_channels
                                    else int(cfg.DATA.PATCH_SIZE[-1])))
        cls = {"edsr": sr_models.EDSR, "rcan": sr_models.RCAN,
               "wdsr": sr_models.WDSR, "dfcan": sr_models.DFCAN}[arch]
        if arch == "rcan":
            kwargs.update(filters=int(cfg.MODEL.RCAN_CONV_FILTERS),
                          num_rg=int(cfg.MODEL.RCAN_RG_BLOCK_NUM),
                          num_rcab=int(cfg.MODEL.RCAN_RCAB_BLOCK_NUM),
                          reduction=int(cfg.MODEL.RCAN_REDUCTION_RATIO),
                          upscaling_layer=bool(cfg.MODEL.RCAN_UPSCALING_LAYER))
        return cls(**kwargs, gen=gen), {"class": cls.__name__, **kwargs}
    if arch.startswith("efficientnet_v2"):
        # dispatched ahead of the b0-b7 family, as in the JAX factory
        raise NotImplementedError(
            f"architecture '{arch}' is not ported yet (ROADMAP queue 1 item 10, rest of the zoo)")
    if arch in EFFICIENTNETS:
        from biapy_tpu_torch.models.efficientnet import EfficientNet

        kwargs = dict(variant=arch, n_classes=int(output_channels[0]))
        return (EfficientNet(**kwargs, in_channels=int(cfg.DATA.PATCH_SIZE[-1]), gen=gen),
                {"class": "EfficientNet", **kwargs})
    if arch not in UNET_FAMILY or arch == "resunet++":
        raise NotImplementedError(
            f"architecture '{arch}' is not ported yet (ROADMAP queue 1 item 10, rest of the zoo); "
            "the port builds the U-Net family, the super-resolution family (edsr, rcan, wdsr, "
            "dfcan), simple_cnn, vit and efficientnet_b0-b7")
    separated_decoders = False
    divide = False
    for wf, node in (("IMAGE_TO_IMAGE", cfg.PROBLEM.IMAGE_TO_IMAGE),
                     ("INSTANCE_SEG", cfg.PROBLEM.INSTANCE_SEG),
                     ("DETECTION", cfg.PROBLEM.DETECTION)):
        if cfg.PROBLEM.TYPE == wf and node.SEPARATED_DECODERS_PER_HEAD:
            separated_decoders = True
            divide = bool(node.SEPARATED_DECODERS_DIVIDE_FEATURE_MAPS)
    upsampling_factor: Tuple[int, ...] = ()
    upsampling_position = "pre"
    if cfg.PROBLEM.TYPE == "SUPER_RESOLUTION":
        upsampling_factor = tuple(int(u) for u in cfg.PROBLEM.SUPER_RESOLUTION.UPSCALING)
        upsampling_position = str(cfg.MODEL.UNET_SR_UPSAMPLE_POSITION)
    iso = cfg.MODEL.ISOTROPY
    if isinstance(iso, bool):
        iso = (iso,)
    kwargs = dict(
        variant=arch,
        ndim=ndim,
        in_channels=int(cfg.DATA.PATCH_SIZE[-1]),
        activation=str(cfg.MODEL.ACTIVATION).lower(),
        feature_maps=tuple(cfg.MODEL.FEATURE_MAPS),
        drop_values=tuple(cfg.MODEL.DROPOUT_VALUES),
        normalization=cfg.MODEL.NORMALIZATION,
        k_size=int(cfg.MODEL.KERNEL_SIZE),
        upsample_layer=cfg.MODEL.UPSAMPLE_LAYER,
        yx_down=tuple(cfg.MODEL.YX_DOWN),
        z_down=tuple(cfg.MODEL.Z_DOWN),
        output_channels=tuple(output_channels),
        output_channel_info=tuple(output_channel_info),
        separated_decoders=separated_decoders,
        divide_decoder_feature_maps=divide,
        upsampling_factor=upsampling_factor,
        upsampling_position=upsampling_position,
        isotropy=tuple(iso),
        larger_io=bool(cfg.MODEL.LARGER_IO),
        conv_layers=tuple(cfg.MODEL.CONV_LAYERS),
        contrast=bool(cfg.LOSS.CONTRAST.ENABLE),
        conv_block_order=cfg.MODEL.CONV_BLOCK_ORDER,
    )
    from biapy_tpu_torch.models.unet_family import UNetFamily

    return UNetFamily(**kwargs, gen=gen), {"class": "UNetFamily", **kwargs}
