"""Model factory.

Counterpart of ``biapy_tpu/models/__init__.py::build_model`` for the U-Net
family (``unet`` and ``resunet`` in 3D), with the separated decoders of
IMAGE_TO_IMAGE, INSTANCE_SEG and DETECTION and the super-resolution
upsampling. Other architectures are not ported yet and raise
``NotImplementedError`` naming the ROADMAP item.

Returns ``(module, model_build_kwargs)`` like the JAX factory.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

UNET_FAMILY = ("unet", "resunet", "resunet++", "seunet", "resunet_se", "attention_unet")


def build_model(cfg, output_channels: List[int], output_channel_info: List[str],
                head_activations: List[str],
                gen: Optional[torch.Generator] = None) -> Tuple[torch.nn.Module, Dict]:
    arch = str(cfg.MODEL.ARCHITECTURE).lower()
    if str(cfg.MODEL.SOURCE).lower() != "biapy":
        raise NotImplementedError(
            f"MODEL.SOURCE '{cfg.MODEL.SOURCE}' is not ported yet (ROADMAP queue 1 "
            "items 10-11, rest of the zoo / BMZ)")
    if arch not in UNET_FAMILY or arch == "resunet++":
        raise NotImplementedError(
            f"architecture '{arch}' is not ported yet (ROADMAP queue 1 item 10, rest of the zoo); "
            "the port builds the U-Net family")
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
        ndim=3 if cfg.PROBLEM.NDIM == "3D" else 2,
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
