"""Configuration validation.

Reference analog: biapy/engine/check_configuration.py (check_configuration:23,
~3400 LoC of cross-field checks). This re-implementation enforces the same
contract class by class: workflow/type/dimension consistency, patch-size
shape, model-vs-workflow compatibility, loss lists, channel specs.
It grows with each workflow vertical; every check mirrors a reference rule.
"""

from __future__ import annotations

import os

from typing import List

VALID_WORKFLOWS = [
    "SEMANTIC_SEG", "INSTANCE_SEG", "DETECTION", "DENOISING",
    "SUPER_RESOLUTION", "SELF_SUPERVISED", "CLASSIFICATION", "IMAGE_TO_IMAGE",
]

UNET_LIKE = ["unet", "resunet", "resunet++", "seunet", "resunet_se", "attention_unet",
             "unext_v1", "unext_v2", "stunet"]
ALL_MODELS = UNET_LIKE + ["multiresunet", "hrnet", "hrnet18", "hrnet32", "hrnet48", "hrnet64",
                          "unetr", "vit", "mae", "edsr", "rcan", "wdsr", "dfcan", "nafnet",
                          "simple_cnn", "efficientnet_b0", "efficientnet_b1", "efficientnet_b2",
                          "efficientnet_b3", "efficientnet_b4", "efficientnet_b5",
                          "efficientnet_b6", "efficientnet_b7"]

INSTANCE_CHANNEL_CODES = ["F", "B", "M", "P", "C", "H", "V", "Z", "Gh", "Gv", "Gz",
                          "Db", "Dc", "Dn", "D", "R", "T", "A", "E", "We"]


def check_configuration(cfg, job_identifier: str = "job",
                        check_data_paths: bool = False) -> None:
    """Validate ``cfg``. ``check_data_paths=True`` additionally verifies that
    every configured data directory / checkpoint file exists (the reference's
    ``check_data_paths`` parameter, check_configuration.py:23); the API layer
    passes True, direct template validation passes False."""
    errors: List[str] = []

    def req(cond: bool, msg: str):
        if not cond:
            errors.append(msg)

    # -- problem ------------------------------------------------------------
    req(cfg.PROBLEM.TYPE in VALID_WORKFLOWS,
        f"PROBLEM.TYPE must be one of {VALID_WORKFLOWS}, got {cfg.PROBLEM.TYPE}")
    req(cfg.PROBLEM.NDIM in ("2D", "3D"), f"PROBLEM.NDIM must be '2D' or '3D', got {cfg.PROBLEM.NDIM}")
    is_3d = cfg.PROBLEM.NDIM == "3D"
    req(bool(cfg.TRAIN.ENABLE) or bool(cfg.TEST.ENABLE),
        "At least one of TRAIN.ENABLE or TEST.ENABLE must be True "
        "(reference check_configuration.py:54)")

    # -- patch size ----------------------------------------------------------
    ps = cfg.DATA.PATCH_SIZE
    want = 4 if is_3d else 3
    req(len(ps) == want,
        f"DATA.PATCH_SIZE must have {want} values ((z,)y,x,c) for {cfg.PROBLEM.NDIM}, got {tuple(ps)}")
    req(all(int(p) > 0 for p in ps), f"DATA.PATCH_SIZE entries must be positive, got {tuple(ps)}")

    # -- spatial partitioning (TPU-native extension) --------------------------
    sp = int(cfg.SYSTEM.SPATIAL_PARTITIONS)
    req(sp >= 1, f"SYSTEM.SPATIAL_PARTITIONS must be >= 1, got {sp}")
    if sp > 1:
        req(cfg.PROBLEM.TYPE != "CLASSIFICATION",
            "SYSTEM.SPATIAL_PARTITIONS only applies to image-target workflows "
            "(classification labels have no spatial axis to shard)")
        req(not (cfg.PROBLEM.TYPE == "DENOISING"
                 and str(cfg.MODEL.ARCHITECTURE).lower() == "nafnet"
                 and bool(cfg.PROBLEM.DENOISING.LOAD_GT_DATA)),
            "SYSTEM.SPATIAL_PARTITIONS is not supported with the GAN "
            "(NAFNet + PatchGAN) training path")
        y_patch = int(ps[1] if is_3d else ps[0])
        req(y_patch % sp == 0,
            f"SYSTEM.SPATIAL_PARTITIONS={sp} must divide the patch's Y size "
            f"({y_patch}); the Y axis is the one sharded over the 'space' mesh "
            "axis (an SR target's upscaled Y is then divisible too)")

    # -- model --------------------------------------------------------------
    arch = str(cfg.MODEL.ARCHITECTURE).lower()
    src = str(cfg.MODEL.SOURCE).lower()
    req(src in ("biapy", "bmz", "torchvision"),
        f"MODEL.SOURCE must be one of ['biapy','bmz','torchvision'], got {cfg.MODEL.SOURCE}")
    if src == "torchvision":
        # supported subset: the torchvision families with a first-party Flax
        # equivalent, loading a LOCAL state dict (the reference downloads
        # DEFAULT weights and supports any torchvision name,
        # build_torchvision_model models/__init__.py:1609 — impossible
        # without the package or egress)
        tv_supported = tuple(f"efficientnet_b{i}" for i in range(8)) + (
            "efficientnet_v2_s", "efficientnet_v2_m", "efficientnet_v2_l",
            "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
            "resnext50_32x4d", "resnext101_32x8d", "resnext101_64x4d",
            "wide_resnet50_2", "wide_resnet101_2",
            "mobilenet_v3_large", "mobilenet_v3_small", "mobilenet_v2",
            "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
            "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
            "mnasnet0_5", "mnasnet0_75", "mnasnet1_0", "mnasnet1_3",
            "googlenet",
            "regnet_y_400mf", "regnet_y_800mf", "regnet_y_1_6gf",
            "regnet_y_3_2gf", "regnet_y_8gf", "regnet_y_16gf",
            "regnet_y_32gf", "regnet_y_128gf",
            "regnet_x_400mf", "regnet_x_800mf",
            "regnet_x_1_6gf", "regnet_x_3_2gf", "regnet_x_8gf",
            "regnet_x_16gf", "regnet_x_32gf",
            "convnext_tiny", "convnext_small", "convnext_base",
            "convnext_large", "squeezenet1_0", "squeezenet1_1",
            "vgg11", "vgg13", "vgg16", "vgg19",
            "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn",
            "densenet121", "densenet161", "densenet169", "densenet201",
            "alexnet", "vit_b_16", "vit_b_32", "vit_l_16", "vit_l_32",
            "vit_h_14",
            "swin_t", "swin_s", "swin_b",
            "swin_v2_t", "swin_v2_s", "swin_v2_b",
            "inception_v3",
            "deeplabv3_resnet50", "deeplabv3_resnet101",
            "deeplabv3_mobilenet_v3_large",
            "fcn_resnet50", "fcn_resnet101", "lraspp_mobilenet_v3_large")
        tv_name = str(cfg.MODEL.TORCHVISION_MODEL_NAME).lower()
        tv_rejected_detection = ("fasterrcnn", "maskrcnn", "retinanet",
                                 "keypointrcnn", "ssd", "fcos")
        req(not any(tv_name.startswith(p) for p in tv_rejected_detection),
            f"MODEL.SOURCE='torchvision': '{tv_name}' is a torchvision "
            "DETECTION family; this framework's detection workflow is "
            "point-heatmap based (PROBLEM.TYPE='DETECTION' with a biapy "
            "architecture), not box/mask R-CNN — use MODEL.SOURCE='biapy'")
        req("quantized" not in tv_name and not tv_name.startswith("q"),
            f"MODEL.SOURCE='torchvision': quantized torchvision models "
            f"('{tv_name}') have no TPU analog — bf16 inference via "
            "TEST.REDUCE_MEMORY is the equivalent memory/speed option")
        req(not tv_name.startswith("maxvit"),
            "MODEL.SOURCE='torchvision': maxvit_t (hybrid MBConv +"
            " block/grid attention) is not reimplemented — use the "
            "first-party ViT (MODEL.ARCHITECTURE='vit') or UNETR for "
            "attention-based models, or convnext_tiny for a modern conv "
            "classifier")
        req(tv_name in tv_supported,
            f"MODEL.SOURCE='torchvision': TORCHVISION_MODEL_NAME '{tv_name}' "
            "is not supported in this TPU environment (no torchvision "
            "package). Supported names map onto first-party Flax "
            f"equivalents: {list(tv_supported)}. For other families use "
            "MODEL.SOURCE='biapy' or import a BMZ package via "
            "MODEL.SOURCE='bmz'.")
        if tv_name.startswith(("deeplabv3", "fcn_", "lraspp")):
            req(cfg.PROBLEM.TYPE == "SEMANTIC_SEG",
                f"MODEL.SOURCE='torchvision' with '{tv_name}' is a "
                "semantic-segmentation model (reference: "
                "build_torchvision_model segmentation branch)")
        else:
            req(cfg.PROBLEM.TYPE == "CLASSIFICATION",
                "MODEL.SOURCE='torchvision' with an efficientnet/resnet/"
                "mobilenet is a classification model (reference: "
                "build_torchvision_model classification branch)")
        req(cfg.PROBLEM.NDIM == "2D",
            "torchvision models are 2D (reference: build_torchvision_model)")
        if tv_name.startswith("swin_v2"):
            req(tuple(cfg.DATA.PATCH_SIZE)[:2] == (256, 256),
                "torchvision Swin V2 is a 256-input model here (traced for "
                "the 64/32/16/8 window-8 grids): set DATA.PATCH_SIZE to "
                "(256, 256, C)")
        elif tv_name.startswith(("vit_", "swin")):
            req(tuple(cfg.DATA.PATCH_SIZE)[:2] == (224, 224),
                "torchvision ViT/Swin are 224-input models here (ViT pos "
                "embeddings are sized for 196+1 tokens; Swin is traced for "
                "the 56/28/14/7 window grids): set DATA.PATCH_SIZE to "
                "(224, 224, C) or use the first-party "
                "MODEL.ARCHITECTURE='vit' for free-size ViTs")
        tw = str(cfg.MODEL.TORCHVISION_WEIGHTS)
        req(bool(tw) and os.path.exists(tw),
            "MODEL.SOURCE='torchvision' loads pretrained weights and this "
            "environment has no network egress: download the torchvision "
            f"{tv_name} state dict elsewhere and set "
            f"MODEL.TORCHVISION_WEIGHTS to the local file (got '{tw}')")
    if src == "bmz":
        req(str(cfg.MODEL.BMZ.SOURCE_MODEL_ID) != "",
            "MODEL.BMZ.SOURCE_MODEL_ID must point at a BMZ package (zip/dir) when MODEL.SOURCE='bmz'")
    if cfg.MODEL.SOURCE == "biapy":
        req(arch in ALL_MODELS, f"MODEL.ARCHITECTURE '{cfg.MODEL.ARCHITECTURE}' not recognised")
        if arch in UNET_LIKE and arch != "stunet":
            # all-zero dropout lists broadcast to the feature-map depth
            # (reference: check_configuration.py:2628)
            req(len(cfg.MODEL.FEATURE_MAPS) == len(cfg.MODEL.DROPOUT_VALUES)
                or all(float(x) == 0 for x in cfg.MODEL.DROPOUT_VALUES),
                "MODEL.FEATURE_MAPS and MODEL.DROPOUT_VALUES must have the same length "
                "(unless dropout is all zeros)")
            req(len(cfg.MODEL.FEATURE_MAPS) <= len(cfg.MODEL.Z_DOWN) + 1,
                "MODEL.Z_DOWN needs one value per downsampling level")
        # per-workflow architecture whitelists (reference
        # check_configuration.py:2860-3008)
        _UNETS = ("unet", "resunet", "resunet++", "seunet", "resunet_se",
                  "attention_unet", "multiresunet", "unetr", "unext_v1",
                  "unext_v2", "stunet")
        _SR_FAMILY = ("edsr", "rcan", "dfcan", "wdsr")
        if cfg.PROBLEM.TYPE == "CLASSIFICATION":
            req(arch in ("simple_cnn", "vit") or "efficientnet" in arch,
                f"Classification supports simple_cnn/ViT/efficientnet, got {arch}")
        elif cfg.PROBLEM.TYPE == "SUPER_RESOLUTION":
            req(arch in _SR_FAMILY + ("unet", "resunet", "seunet",
                                      "attention_unet", "multiresunet", "resunet_se",
                                      "resunet++", "unext_v1", "unext_v2"),
                f"Model {arch} is not a super-resolution model")
            req(str(cfg.MODEL.UNET_SR_UPSAMPLE_POSITION) in ("pre", "post"),
                "MODEL.UNET_SR_UPSAMPLE_POSITION not in ['pre', 'post']")
        elif cfg.PROBLEM.TYPE in ("INSTANCE_SEG", "DETECTION"):
            req(arch in _UNETS or "hrnet" in arch,
                f"Architectures available for {cfg.PROBLEM.TYPE} are the U-Net "
                f"family / unetr / hrnet / stunet, got '{arch}' "
                "(reference check_configuration.py:2860)")
        elif cfg.PROBLEM.TYPE == "SEMANTIC_SEG":
            req(arch in _UNETS + _SR_FAMILY or "hrnet" in arch,
                f"Architectures available for SEMANTIC_SEG are the U-Net family "
                f"/ unetr / hrnet / stunet / SR family, got '{arch}'")
        elif cfg.PROBLEM.TYPE == "DENOISING":
            req(arch in _UNETS + ("nafnet",) or "hrnet" in arch,
                f"Architectures available for DENOISING are the U-Net family / "
                f"unetr / hrnet / stunet / nafnet, got '{arch}'")
        elif cfg.PROBLEM.TYPE == "IMAGE_TO_IMAGE":
            req(arch in _UNETS + _SR_FAMILY or "hrnet" in arch,
                f"Architectures available for IMAGE_TO_IMAGE are the U-Net "
                f"family / unetr / hrnet / stunet / SR family, got '{arch}'")
        elif cfg.PROBLEM.TYPE == "SELF_SUPERVISED":
            req(arch in _UNETS + _SR_FAMILY + ("vit", "mae") or "hrnet" in arch,
                f"SELF_SUPERVISED models available are the U-Net family / unetr "
                f"/ vit / mae / hrnet / stunet / SR family, got '{arch}'")
        # NOTE: the reference also enforces len(MODEL.FEATURE_MAPS) > 2
        # (check_configuration.py:2611); intentionally relaxed here — the
        # Flax U-Nets support 2 levels and tiny test configs rely on it
        # (docs/VALIDATION_AUDIT.md).
        if arch in ("vit", "unetr", "mae"):
            dv = list(cfg.MODEL.DROPOUT_VALUES)
            req(len(dv) == 1 or all(float(x) == 0 for x in dv),
                "MODEL.DROPOUT_VALUES must be a list with a single value for "
                "vit/mae/unetr (reference check_configuration.py:2622)")

    # -- train ---------------------------------------------------------------
    if cfg.TRAIN.ENABLE:
        req(isinstance(cfg.TRAIN.OPTIMIZER, list), "'TRAIN.OPTIMIZER' must be a list")
        for o in cfg.TRAIN.OPTIMIZER:
            req(str(o).upper() in ("SGD", "ADAM", "ADAMW"),
                f"TRAIN.OPTIMIZER values must be in ['SGD','ADAM','ADAMW'], got {o}")
        req(len(cfg.TRAIN.OPTIMIZER) == len(cfg.TRAIN.LR),
            "'TRAIN.OPTIMIZER' and 'TRAIN.LR' must have the same length")
        if len(cfg.TRAIN.OPTIMIZER) > 1:
            # multi-optimizer setups: GAN denoising (generator +
            # discriminator, reference check_configuration.py:3199-3210) or
            # any multi-head model — one optimizer per loss head (reference
            # prepare_optimizer over param_groups, engine/__init__.py:21)
            is_gan = ((cfg.PROBLEM.TYPE == "DENOISING"
                       and bool(cfg.PROBLEM.DENOISING.LOAD_GT_DATA))
                      or str(cfg.LOSS.TYPE).upper() == "CYCLEGAN")
            has_class_head = (int(cfg.DATA.N_CLASSES) > 1
                              and cfg.PROBLEM.TYPE in ("INSTANCE_SEG", "DETECTION"))
            is_multi_i2i = cfg.PROBLEM.TYPE == "IMAGE_TO_IMAGE"
            req(is_gan or has_class_head or is_multi_i2i,
                "Multiple optimizers were provided but the workflow has a "
                "single loss head (GAN setups and multi-head models take "
                "several)")
            req(len(cfg.TRAIN.OPTIMIZER) == 2 or not (is_gan or has_class_head),
                "This workflow has exactly two loss heads; provide two "
                "optimizers/LRs")
        req(cfg.TRAIN.EPOCHS > 0, "TRAIN.EPOCHS must be > 0")
        req(cfg.TRAIN.BATCH_SIZE > 0, "TRAIN.BATCH_SIZE must be > 0")
        sch = cfg.TRAIN.LR_SCHEDULER.NAME
        req(sch in ("", "reduceonplateau", "warmupcosine", "onecycle", "warmupreduceonplateau"),
            f"Unknown TRAIN.LR_SCHEDULER.NAME: {sch}")
        # OPT_BETAS: one (beta1, beta2) pair shared or one per optimizer
        # (reference check_configuration.py:3216-3256)
        betas = cfg.TRAIN.OPT_BETAS
        req(isinstance(betas, (list, tuple)), "'TRAIN.OPT_BETAS' must be a list")
        if isinstance(betas, (list, tuple)) and betas and \
                isinstance(betas[0], (list, tuple)):
            req(len(betas) in (1, len(cfg.TRAIN.OPTIMIZER)),
                "'TRAIN.OPT_BETAS' must have length 1 or match 'TRAIN.OPTIMIZER' length")
            for pair in betas:
                req(isinstance(pair, (list, tuple)) and len(pair) == 2,
                    "Each entry in 'TRAIN.OPT_BETAS' must be a tuple/list of length 2")
        elif isinstance(betas, (list, tuple)) and betas:
            req(len(betas) == 2,
                "'TRAIN.OPT_BETAS' must be a (beta1, beta2) pair or a list of pairs")
        gcn = cfg.TRAIN.GRADIENT_CLIP_NORM
        req(isinstance(gcn, (int, float)), "'TRAIN.GRADIENT_CLIP_NORM' must be a number")
        if isinstance(gcn, (int, float)):
            req(float(gcn) >= 0,
                "'TRAIN.GRADIENT_CLIP_NORM' must be non-negative (0 to disable)")
        min_lr = cfg.TRAIN.LR_SCHEDULER.MIN_LR
        if isinstance(min_lr, (list, tuple)) and len(min_lr) > 0:
            req(len(min_lr) in (1, len(cfg.TRAIN.OPTIMIZER)),
                "'TRAIN.LR_SCHEDULER.MIN_LR' must have length 1 or match "
                "'TRAIN.OPTIMIZER' length")
        if sch in ("reduceonplateau", "warmupcosine"):
            # (reference check_configuration.py:3257-3269)
            req(isinstance(min_lr, (list, tuple))
                and not all(float(x) == -1.0 for x in min_lr),
                "'TRAIN.LR_SCHEDULER.MIN_LR' needs to be set when "
                "'TRAIN.LR_SCHEDULER.NAME' is between "
                "['reduceonplateau', 'warmupcosine']")
        if sch == "warmupcosine":
            req(int(cfg.TRAIN.LR_SCHEDULER.WARMUP_COSINE_DECAY_EPOCHS) != -1,
                "'TRAIN.LR_SCHEDULER.WARMUP_COSINE_DECAY_EPOCHS' needs to be "
                "set when 'TRAIN.LR_SCHEDULER.NAME' is 'warmupcosine'")
        if sch in ("reduceonplateau", "warmupreduceonplateau"):
            req(int(cfg.TRAIN.LR_SCHEDULER.REDUCEONPLATEAU_PATIENCE) > 0,
                "'TRAIN.LR_SCHEDULER.REDUCEONPLATEAU_PATIENCE' needs to be set "
                "when the scheduler is 'reduceonplateau'")
            if int(cfg.TRAIN.PATIENCE) != -1:
                req(int(cfg.TRAIN.LR_SCHEDULER.REDUCEONPLATEAU_PATIENCE)
                    < int(cfg.TRAIN.PATIENCE),
                    "'TRAIN.LR_SCHEDULER.REDUCEONPLATEAU_PATIENCE' needs to be "
                    "less than 'TRAIN.PATIENCE' — otherwise early stopping fires "
                    "before the LR ever drops")

    # -- normalization ----------------------------------------------------------
    req(cfg.DATA.NORMALIZATION.TYPE in ("div", "scale_range", "zero_mean_unit_variance", "none"),
        f"Unknown DATA.NORMALIZATION.TYPE: {cfg.DATA.NORMALIZATION.TYPE}")
    if cfg.PROBLEM.TYPE == "SUPER_RESOLUTION":
        req(cfg.DATA.NORMALIZATION.TYPE in ("div", "scale_range"),
            "DATA.NORMALIZATION.TYPE in the SR workflow needs to be 'div' or "
            "'scale_range' (reference check_configuration.py:1154)")
    pclip = cfg.DATA.NORMALIZATION.PERC_CLIP
    if pclip.ENABLE:
        # either a percentile or an absolute value must define each bound
        # (reference check_configuration.py:2560-2580)
        req(float(pclip.LOWER_PERC) != -1.0
            or any(float(v) != -1.0 for v in pclip.LOWER_VALUE),
            "DATA.NORMALIZATION.PERC_CLIP.LOWER_PERC or LOWER_VALUE must be set "
            "when PERC_CLIP.ENABLE is True")
        req(float(pclip.UPPER_PERC) != -1.0
            or any(float(v) != -1.0 for v in pclip.UPPER_VALUE),
            "DATA.NORMALIZATION.PERC_CLIP.UPPER_PERC or UPPER_VALUE must be set "
            "when PERC_CLIP.ENABLE is True")
        if float(pclip.LOWER_PERC) != -1.0:
            req(0.0 <= float(pclip.LOWER_PERC) <= 100.0,
                "DATA.NORMALIZATION.PERC_CLIP.LOWER_PERC not in [0, 100] range")
        if float(pclip.UPPER_PERC) != -1.0:
            req(0.0 <= float(pclip.UPPER_PERC) <= 100.0,
                "DATA.NORMALIZATION.PERC_CLIP.UPPER_PERC not in [0, 100] range")

    # -- overlap/padding lengths ----------------------------------------------
    nd = 3 if is_3d else 2
    for split in ("TRAIN", "VAL", "TEST"):
        node = cfg.DATA[split]
        for k in ("OVERLAP", "PADDING"):
            v = node[k]
            req(len(v) == nd, f"DATA.{split}.{k} must have {nd} values for {cfg.PROBLEM.NDIM}, got {tuple(v)}")
        for o in node.OVERLAP:
            req(0 <= o < 1, f"DATA.{split}.OVERLAP values must be in [0,1)")
        res = [float(r) for r in node.RESOLUTION]
        if res and res != [-1.0]:
            # TEST.RESOLUTION additionally accepts a (z,y,x) triple for 2D
            # problems analysed as 3D stacks (reference
            # check_configuration.py:2490-2502)
            ok_lens = (nd, 3) if split == "TEST" else (nd,)
            req(len(res) in ok_lens,
                f"DATA.{split}.RESOLUTION must have {nd} values for "
                f"{cfg.PROBLEM.NDIM}, got {tuple(res)}")
        for ax_key in ("INPUT_IMG_AXES_ORDER", "INPUT_MASK_AXES_ORDER"):
            if ax_key in node:
                ax = str(node[ax_key])
                req(len(ax) >= 3,
                    f"DATA.{split}.{ax_key} needs to be at least of length 3, "
                    f"e.g. 'ZYX' (got '{ax}')")

    # -- more model/train cross-checks ---------------------------------------
    if cfg.MODEL.SOURCE == "biapy":
        if arch in ("vit", "mae", "unetr"):
            preset = str(cfg.MODEL.UNETR_VIT_MODEL if arch == "unetr" else cfg.MODEL.VIT_MODEL).lower()
            _vit_models = ("custom", "vit_base_patch16", "vit_large_patch16",
                           "vit_huge_patch14", "sam3_vit")
            req(preset in _vit_models,
                f"MODEL.{'UNETR_VIT_MODEL' if arch == 'unetr' else 'VIT_MODEL'} "
                f"needs to be in {list(_vit_models)}, got '{preset}'")
            if preset == "custom":
                req(int(cfg.MODEL.VIT_EMBED_DIM) % int(cfg.MODEL.VIT_NUM_HEADS) == 0,
                    "MODEL.VIT_EMBED_DIM must be divisible by MODEL.VIT_NUM_HEADS")
                if arch == "unetr":
                    # UNETR's decoder doubles resolution per level (reference
                    # check_configuration.py:3037)
                    tok = int(cfg.MODEL.VIT_TOKEN_SIZE)
                    req(tok >= 2 and (tok & (tok - 1)) == 0,
                        "UNETR's token size needs to be a power of two greater "
                        f"than one, got MODEL.VIT_TOKEN_SIZE={tok}")
            if preset == "sam3_vit":
                req(not is_3d, "sam3_vit backbones are 2D only (pretrained weights are 2D)")
                tok = 16 if arch == "unetr" else 14
                req(int(ps[0]) % tok == 0,
                    f"DATA.PATCH_SIZE must be a multiple of {tok} with the sam3_vit backbone "
                    f"(reference: check_configuration.py:3050), got {ps[0]}")
                if str(cfg.MODEL.VIT_PRETRAINED_WEIGHTS) != "":
                    req(int(ps[-1]) in (1, 3),
                        "SAM3's pretrained weights can only be loaded with 1 or "
                        "3 input channels (reference check_configuration.py:3068)"
                        f" — DATA.PATCH_SIZE has {ps[-1]}")
            elif str(cfg.MODEL.VIT_PRETRAINED_WEIGHTS) != "":
                req(False,
                    "MODEL.VIT_PRETRAINED_WEIGHTS can only be used when the ViT "
                    "backbone is 'sam3_vit' (the only one with pretrained "
                    f"weights available); got backbone '{preset}'")
        elif str(cfg.MODEL.VIT_PRETRAINED_WEIGHTS) != "":
            req(False,
                "MODEL.VIT_PRETRAINED_WEIGHTS can only be used with the 'vit' "
                f"and 'unetr' architectures, but MODEL.ARCHITECTURE is '{arch}'")
        if arch in ("edsr", "wdsr", "nafnet"):
            # reference 3D availability list (check_configuration.py:2531):
            # rcan and dfcan ARE 3D-capable; edsr/wdsr/nafnet are not
            req(not is_3d, f"{arch} is a 2D architecture (reference parity)")
        if arch == "nafnet":
            d_arch = str(cfg.MODEL.NAFNET.ARCHITECTURE_D).lower()
            req(d_arch in ("", "patchgan"),
                f"MODEL.NAFNET.ARCHITECTURE_D must be '' or 'patchgan' "
                f"(the reference builds only PatchGAN discriminators), got '{d_arch}'")
            if float(cfg.LOSS.CYCLEGAN.ALPHA_PERCEPTUAL) > 0.0:
                # the reference downloads torchvision vgg16 (metrics.py:2593);
                # no egress here, so a local state-dict path is required
                import os as _os

                w = str(cfg.LOSS.CYCLEGAN.PERCEPTUAL_WEIGHTS)
                req(bool(w) and _os.path.exists(w),
                    "LOSS.CYCLEGAN.ALPHA_PERCEPTUAL > 0 needs pretrained VGG16 "
                    "features and this environment has no network egress: "
                    "download the torchvision vgg16 state dict elsewhere and "
                    "set LOSS.CYCLEGAN.PERCEPTUAL_WEIGHTS to the local file "
                    f"(got '{w}')")
        if "hrnet" in arch:
            # reference check_configuration.py:2660 accepts W18/W32/W48/W64
            # plus 'custom' (NUM_STAGES/NUM_MODULES/... spec)
            v = arch.replace("hrnet", "") or str(cfg.MODEL.HRNET.VARIANT).lstrip("wW")
            req(str(v) in ("18", "32", "48", "64", "custom") or v == "",
                f"HRNet variant must be one of 18/32/48/64/custom, got '{v}'")
        if arch == "stunet":
            req(str(cfg.MODEL.STUNET.VARIANT).lower() in ("small", "base", "large", "huge"),
                f"MODEL.STUNET.VARIANT must be small/base/large/huge, got {cfg.MODEL.STUNET.VARIANT}")
        norm = str(cfg.MODEL.NORMALIZATION).lower()
        req(norm in ("", "none", "bn", "sync_bn", "in", "gn", "ln"),
            f"MODEL.NORMALIZATION must be one of none/bn/sync_bn/in/gn/ln, got {norm}")
        req(str(cfg.MODEL.UPSAMPLE_LAYER).lower() in ("upsampling", "convtranspose"),
            f"MODEL.UPSAMPLE_LAYER needs to be 'upsampling' or 'convtranspose', "
            f"got {cfg.MODEL.UPSAMPLE_LAYER}")
        cbo = str(cfg.MODEL.CONV_BLOCK_ORDER)
        req(cbo in ("conv_norm_act", "norm_act_conv"),
            "MODEL.CONV_BLOCK_ORDER not in ['conv_norm_act', 'norm_act_conv']")
        if cbo == "norm_act_conv":
            req(arch in ("unet", "resunet", "resunet++", "seunet", "resunet_se",
                         "attention_unet"),
                "MODEL.CONV_BLOCK_ORDER 'norm_act_conv' (pre-activation) is only "
                "supported by the plain U-Net family "
                "(reference check_configuration.py:2601)")
        for d in cfg.MODEL.DROPOUT_VALUES:
            req(0.0 <= float(d) <= 1.0, "MODEL.DROPOUT_VALUES not in [0, 1] range")
        for v in list(cfg.MODEL.Z_DOWN) + list(cfg.MODEL.YX_DOWN):
            # 0 is our "use the default" broadcast sentinel
            req(int(v) in (0, 1, 2),
                "MODEL.Z_DOWN / MODEL.YX_DOWN values need to be 1 or 2")
        if arch in UNET_LIKE and arch != "stunet" and list(cfg.MODEL.CONV_LAYERS):
            cl = [int(c) for c in cfg.MODEL.CONV_LAYERS]
            req(all(c >= 1 for c in cl),
                "MODEL.CONV_LAYERS values must be greater than or equal to 1")
            # a uniform list broadcasts to the feature-map depth (reference
            # check_configuration.py:2734-2740)
            req(len(cl) == len(cfg.MODEL.FEATURE_MAPS) or len(set(cl)) == 1,
                "MODEL.FEATURE_MAPS and MODEL.CONV_LAYERS lengths must be equal")
        if arch == "mae":
            req(cfg.PROBLEM.TYPE == "SELF_SUPERVISED",
                "'mae' can only be used in the SELF_SUPERVISED workflow "
                "(reference check_configuration.py:2879)")
        if "efficientnet" in arch:
            req(not is_3d, "EfficientNet architectures are only available for 2D images")
        if arch in ("vit", "mae", "unetr") and len(ps) == want:
            sp = [int(v) for v in ps[:-1]]
            req(len(set(sp)) == 1,
                f"'{arch}' needs the same size in every spatial dimension of "
                f"DATA.PATCH_SIZE (e.g. (80,80,80,1)), got {tuple(ps)}")
        # one decoder per head: supported archs + incompatibilities
        # (reference check_configuration.py:2765-2828)
        _SEP_DEC_ARCHS = ("unet", "resunet", "resunet++", "seunet", "resunet_se",
                          "attention_unet", "unext_v1", "unext_v2")
        for wf_name, node in (("INSTANCE_SEG", cfg.PROBLEM.INSTANCE_SEG),
                              ("DETECTION", cfg.PROBLEM.DETECTION),
                              ("IMAGE_TO_IMAGE", cfg.PROBLEM.IMAGE_TO_IMAGE)):
            if not (node.SEPARATED_DECODERS_PER_HEAD
                    and cfg.PROBLEM.TYPE == wf_name):
                continue
            req(arch in _SEP_DEC_ARCHS,
                f"PROBLEM.{wf_name}.SEPARATED_DECODERS_PER_HEAD is only "
                f"supported by {list(_SEP_DEC_ARCHS)}; '{arch}' does not "
                "support it")
            req(not cfg.LOSS.CONTRAST.ENABLE,
                "LOSS.CONTRAST.ENABLE can not be True when "
                f"PROBLEM.{wf_name}.SEPARATED_DECODERS_PER_HEAD is True")
            if wf_name == "DETECTION":
                req(int(cfg.DATA.N_CLASSES) > 2,
                    "PROBLEM.DETECTION.SEPARATED_DECODERS_PER_HEAD can only be "
                    "True when DATA.N_CLASSES is greater than 2 (the class "
                    "head is the second decoder)")
        if cfg.PROBLEM.TYPE in ("SEMANTIC_SEG", "DETECTION") \
                and not cfg.MODEL.LOAD_CHECKPOINT:
            req(int(cfg.DATA.N_CLASSES) >= 2,
                "DATA.N_CLASSES needs to be greater or equal 2 (binary case)")
        if int(cfg.DATA.N_CLASSES) > 2:
            req(cfg.PROBLEM.TYPE in ("SEMANTIC_SEG", "INSTANCE_SEG", "DETECTION",
                                     "CLASSIFICATION", "IMAGE_TO_IMAGE"),
                "DATA.N_CLASSES can only be greater than 2 in SEMANTIC_SEG/"
                "INSTANCE_SEG/DETECTION/CLASSIFICATION/IMAGE_TO_IMAGE")
            if cfg.PROBLEM.TYPE in ("SEMANTIC_SEG", "INSTANCE_SEG", "DETECTION"):
                req(arch in ("unet", "resunet", "resunet++", "seunet", "resunet_se",
                             "attention_unet", "multiresunet", "unetr", "unext_v1",
                             "unext_v2", "hrnet", "stunet") or "hrnet" in arch,
                    f"DATA.N_CLASSES > 2 is not supported by '{arch}' "
                    "(reference check_configuration.py:2593)")
        # patch size must survive every downsampling level (reference:
        # check_configuration.py:3091-3155 — the model would otherwise fail
        # with an opaque shape error)
        if arch in ("unet", "resunet", "resunet++", "seunet", "resunet_se",
                    "attention_unet", "multiresunet", "unext_v1", "unext_v2") \
                and len(ps) == want:
            n_down = 4 if arch == "multiresunet" else len(cfg.MODEL.FEATURE_MAPS) - 1
            cur_z = int(ps[0]) if is_3d else 1
            cur_yx = [int(v) for v in (ps[1:-1] if is_3d else ps[:-1])]
            zd = list(cfg.MODEL.Z_DOWN) or [2] * n_down
            yd = list(cfg.MODEL.YX_DOWN) or [2] * n_down
            if all(int(v) == 0 for v in zd):  # all-zero lists default to 2s
                zd = [2] * n_down
            if all(int(v) == 0 for v in yd):
                yd = [2] * n_down
            for i in range(min(n_down, len(yd))):
                yxf = max(1, int(yd[i]))
                zf = max(1, int(zd[i])) if is_3d and i < len(zd) else 1
                bad = any(d % yxf != 0 or d <= 2 for d in cur_yx) or \
                    (is_3d and (cur_z % zf != 0 or cur_z <= 2))
                req(not bad,
                    f"DATA.PATCH_SIZE is not divisible by the downsampling factor at "
                    f"level {i} of {arch} — reduce MODEL.FEATURE_MAPS depth, enlarge "
                    "the patch, or relax MODEL.Z_DOWN for the z axis")
                if bad:
                    break
                cur_yx = [d // yxf for d in cur_yx]
                cur_z = cur_z // zf
        if "hrnet" in arch:
            req(str(cfg.MODEL.HRNET.BLOCK_TYPE) in
                ("BASIC", "BOTTLENECK", "CONVNEXT_V1", "CONVNEXT_V2"),
                "MODEL.HRNET.BLOCK_TYPE must be BASIC/BOTTLENECK/CONVNEXT_V1/CONVNEXT_V2")
            req(str(cfg.MODEL.HRNET.HEAD_TYPE) in ("OCR", "ASPP", "PSP", "FCN"),
                "MODEL.HRNET.HEAD_TYPE must be OCR/ASPP/PSP/FCN")
            req(not (is_3d and str(cfg.MODEL.HRNET.HEAD_TYPE) == "OCR"),
                "'OCR' head is not available for 3D HRNet models — choose "
                "ASPP, PSP or FCN (reference check_configuration.py:3162)")
        req(str(cfg.MODEL.OUT_CHECKPOINT_FORMAT) in ("pth", "safetensors"),
            "MODEL.OUT_CHECKPOINT_FORMAT not in ['pth', 'safetensors']")

    # testing without training needs a model to load
    # (reference check_configuration.py:3187)
    if cfg.MODEL.SOURCE == "biapy" and not cfg.MODEL.LOAD_CHECKPOINT \
            and not cfg.TRAIN.ENABLE and cfg.TEST.ENABLE:
        req(False,
            "Seems that you want to test a model without training first. In "
            "this case 'MODEL.LOAD_CHECKPOINT' needs to be True to load a "
            "pre-trained model.")

    # checkpoint/freeze option vocab (reference check_configuration.py:1449-1460)
    for item in cfg.MODEL.ITEMS_TO_LOAD_FROM_CHECKPOINT:
        req(str(item) in ("weights", "norm", "model_arch", "optimizer", "epoch"),
            f"MODEL.ITEMS_TO_LOAD_FROM_CHECKPOINT entries must be in "
            f"['weights','norm','model_arch','optimizer','epoch'], got '{item}'")
    for i, pattern in enumerate(cfg.MODEL.FREEZE_LAYERS_MATCHING or []):
        import re as _re

        try:
            _re.compile(str(pattern))
        except _re.error as e:
            req(False, f"MODEL.FREEZE_LAYERS_MATCHING[{i}] is not a valid regex "
                f"('{pattern}'): {e}")
    if cfg.DATA.TRAIN.PROBABILITY_MAP:
        req(cfg.PROBLEM.TYPE in ("SEMANTIC_SEG", "INSTANCE_SEG", "DETECTION"),
            "DATA.TRAIN.PROBABILITY_MAP only applies to SEMANTIC_SEG/INSTANCE_SEG/"
            "DETECTION (reference check_configuration.py:1445)")
    if cfg.TEST.POST_PROCESSING.VORONOI_ON_MASK:
        req(0.0 <= float(cfg.TEST.POST_PROCESSING.VORONOI_TH) <= 1.0,
            "TEST.POST_PROCESSING.VORONOI_TH must be in [0,1]")

    if cfg.TRAIN.ENABLE:
        req(all(float(lr) > 0 for lr in cfg.TRAIN.LR), "TRAIN.LR values must be > 0")
        sch = cfg.TRAIN.LR_SCHEDULER.NAME
        if sch == "warmupcosine":
            req(int(cfg.TRAIN.LR_SCHEDULER.WARMUP_COSINE_DECAY_EPOCHS) < int(cfg.TRAIN.EPOCHS),
                "LR_SCHEDULER.WARMUP_COSINE_DECAY_EPOCHS must be < TRAIN.EPOCHS")
        mp = cfg.TRAIN.MIXED_PRECISION
        req(isinstance(mp, bool) or str(mp).lower() in ("auto", "true", "false", "0", "1"),
            f"TRAIN.MIXED_PRECISION must be bool or 'auto', got {mp!r}")
        vs = float(cfg.DATA.VAL.SPLIT_TRAIN)
        if cfg.DATA.VAL.FROM_TRAIN and not cfg.DATA.VAL.CROSS_VAL:
            req(0.0 < vs < 1.0,
                f"DATA.VAL.SPLIT_TRAIN must be in (0,1) when DATA.VAL.FROM_TRAIN "
                f"is True, got {vs}")
        if cfg.DATA.VAL.CROSS_VAL:
            req(cfg.DATA.VAL.FROM_TRAIN,
                "DATA.VAL.CROSS_VAL can only be used when DATA.VAL.FROM_TRAIN is True")
            req(1 <= int(cfg.DATA.VAL.CROSS_VAL_FOLD) <= int(cfg.DATA.VAL.CROSS_VAL_NFOLD),
                "DATA.VAL.CROSS_VAL_FOLD must be in [1, CROSS_VAL_NFOLD]")
    if cfg.DATA.TEST.USE_VAL_AS_TEST:
        req(cfg.DATA.VAL.CROSS_VAL,
            "DATA.TEST.USE_VAL_AS_TEST can only be used when DATA.VAL.CROSS_VAL "
            "is selected")

    # -- augmentor ------------------------------------------------------------
    if cfg.AUGMENTOR.ENABLE:
        aug = cfg.AUGMENTOR
        for k in aug.keys():
            if k.endswith("_PROB"):
                v = float(aug[k])
                req(0.0 <= v <= 1.0, f"AUGMENTOR.{k} must be in [0,1], got {v}")
        # per-op parameter ranges (reference check_configuration.py:3280-3380)
        for k, lo, hi in (("RANDOM_ROT_RANGE", -360, 360), ("SHEAR_RANGE", -360, 360),
                          ("DROP_RANGE", 0, 1), ("COUT_SIZE", 0, 1),
                          ("CBLUR_SIZE", 0, 1), ("CBLUR_DOWN_RANGE", 1, 8),
                          ("CMIX_SIZE", 0, 1), ("CNOISE_SCALE", 0, 1),
                          ("CNOISE_SIZE", 0, 1), ("ZOOM_RANGE", 0.1, 10)):
            req(all(lo <= float(v) <= hi for v in aug[k]),
                f"AUGMENTOR.{k} values not in [{lo}, {hi}] range")
        req(str(aug.E_MODE) in ("constant", "nearest", "reflect", "wrap"),
            "AUGMENTOR.E_MODE not in ['constant', 'nearest', 'reflect', 'wrap']")
        req(str(aug.AFFINE_MODE) in ("constant", "reflect", "wrap", "symmetric"),
            "AUGMENTOR.AFFINE_MODE needs to be in "
            "['constant', 'reflect', 'wrap', 'symmetric']")
        req(0.0 <= float(aug.GRID_RATIO) <= 1.0, "AUGMENTOR.GRID_RATIO not in [0, 1] range")
        req(all(0.0 <= float(v) <= 1.0 for v in aug.GRID_D_RANGE),
            "AUGMENTOR.GRID_D_RANGE values not in [0, 1] range")
        req(float(aug.GRID_D_RANGE[0]) < float(aug.GRID_D_RANGE[1]),
            "AUGMENTOR.GRID_D_RANGE must be an increasing (low, high) pair")
        req(0.0 <= float(aug.GRID_ROTATE) <= 1.0, "AUGMENTOR.GRID_ROTATE not in [0, 1] range")
        if cfg.DATA.NORMALIZATION.TYPE == "zero_mean_unit_variance":
            # both ops assume non-negative intensities (reference
            # check_configuration.py:3383-3397)
            req(not aug.GAMMA_CONTRAST,
                "AUGMENTOR.GAMMA_CONTRAST misbehaves on negative values, which "
                "'zero_mean_unit_variance' normalization produces — use 'div' "
                "or 'scale_range'")
            req(not aug.POISSON_NOISE,
                "AUGMENTOR.POISSON_NOISE misbehaves on negative values, which "
                "'zero_mean_unit_variance' normalization produces — use 'div' "
                "or 'scale_range'")

    # -- preprocess -------------------------------------------------------------
    prep = cfg.DATA.PREPROCESS
    if prep.TRAIN or prep.VAL or prep.TEST:
        if prep.RESIZE.ENABLE:
            req(cfg.PROBLEM.TYPE != "DETECTION",
                "Resizing preprocessing is not available for the DETECTION "
                "workflow (point GT coordinates would no longer match)")
            osz = list(prep.RESIZE.OUTPUT_SHAPE)
            req(len(osz) == nd,
                f"DATA.PREPROCESS.RESIZE.OUTPUT_SHAPE must have {nd} values for "
                f"{cfg.PROBLEM.NDIM}, got {tuple(osz)}")
            if len(osz) == nd and len(ps) == want:
                req(all(int(s) >= int(p) for s, p in zip(osz, ps[:-1])),
                    f"DATA.PREPROCESS.RESIZE.OUTPUT_SHAPE {tuple(osz)} can not "
                    f"be smaller than DATA.PATCH_SIZE {tuple(ps)}")
        if prep.MEDIAN_BLUR.ENABLE:
            req(len(list(prep.MEDIAN_BLUR.KERNEL_SIZE)) == nd + 1,
                f"DATA.PREPROCESS.MEDIAN_BLUR.KERNEL_SIZE must have {nd + 1} "
                "values (spatial dims + channels)")
        if prep.CANNY.ENABLE:
            req(not is_3d, "Canny edge detection preprocessing is 2D-only")
        if prep.MATCH_HISTOGRAM.ENABLE:
            import os as _os

            req(_os.path.exists(str(prep.MATCH_HISTOGRAM.REFERENCE_PATH)),
                "DATA.PREPROCESS.MATCH_HISTOGRAM.REFERENCE_PATH does not exist: "
                f"{prep.MATCH_HISTOGRAM.REFERENCE_PATH}")

    # -- test -----------------------------------------------------------------
    # TRAIN/TEST.METRICS name validation (reference:
    # check_configuration.py:1248-1292)
    if cfg.PROBLEM.TYPE == "DENOISING":
        # (reference check_configuration.py:1293-1305 — mae/mse only)
        for m in list(cfg.TRAIN.METRICS) + list(cfg.TEST.METRICS):
            req(str(m).lower() in ("mae", "mse"),
                f"TRAIN/TEST.METRICS options are ['mae', 'mse'] in "
                f"DENOISING, got '{m}'")
    elif cfg.PROBLEM.TYPE in ("SUPER_RESOLUTION", "IMAGE_TO_IMAGE",
                              "SELF_SUPERVISED"):
        for m in list(cfg.TRAIN.METRICS):
            req(str(m).lower() in ("psnr", "mae", "mse", "ssim"),
                f"TRAIN.METRICS options are psnr/mae/mse/ssim for "
                f"{cfg.PROBLEM.TYPE}, got '{m}'")
        for m in list(cfg.TEST.METRICS):
            ml = str(m).lower()
            req(ml in ("psnr", "mae", "mse", "ssim", "fid", "is", "lpips"),
                f"TEST.METRICS options are psnr/mae/mse/ssim/fid/is/lpips "
                f"for {cfg.PROBLEM.TYPE}, got '{m}'")
            if ml in ("fid", "is", "lpips"):
                # reference: 2D only (check_configuration.py:1289-1291);
                # weights must come from a local file (no egress)
                import os as _os

                req(cfg.PROBLEM.NDIM == "2D",
                    "IS, FID and LPIPS metrics can only be measured when "
                    "PROBLEM.NDIM == '2D'")
                key = "LPIPS" if ml == "lpips" else "INCEPTION"
                w = str(cfg.TEST.METRIC_WEIGHTS[key])
                req(bool(w) and _os.path.exists(w),
                    f"TEST.METRICS '{m}' needs a pretrained "
                    f"{'LPIPS (squeeze)' if ml == 'lpips' else 'Inception-v3'} "
                    "net and this environment has no network egress: "
                    "download the torch state dict elsewhere and set "
                    f"TEST.METRIC_WEIGHTS.{key} to the local file "
                    f"(got '{w}')")
    elif cfg.PROBLEM.TYPE in ("SEMANTIC_SEG", "INSTANCE_SEG", "DETECTION"):
        for m in list(cfg.TRAIN.METRICS) + list(cfg.TEST.METRICS):
            req(str(m).lower() == "iou",
                f"TRAIN/TEST.METRICS must be 'iou' for {cfg.PROBLEM.TYPE}, got '{m}'")
    elif cfg.PROBLEM.TYPE == "CLASSIFICATION":
        for m in list(cfg.TRAIN.METRICS):
            req(str(m).lower() in ("accuracy", "top-5-accuracy"),
                "TRAIN.METRICS options are ['accuracy', 'top-5-accuracy'] "
                f"in CLASSIFICATION, got '{m}'")
        for m in list(cfg.TEST.METRICS):
            req(str(m).lower() == "accuracy",
                f"TEST.METRICS option is 'accuracy' in CLASSIFICATION, got '{m}'")
        if "top-5-accuracy" in [str(m).lower() for m in cfg.TRAIN.METRICS]:
            req(int(cfg.DATA.N_CLASSES) >= 5,
                "'top-5-accuracy' can only be used when DATA.N_CLASSES >= 5")

    if cfg.TEST.ENABLE:
        if bool(getattr(cfg.TEST, "OUTPUT_QUANT_UINT8", False)):
            # The uint8 drain clips every output channel to [0,1] and
            # quantizes (ops/stitch.py) — only valid when ALL channels are
            # probabilities. Regression workflows and signed/unbounded
            # instance channels (distances, flows, offsets, radii, EmbedSeg
            # embeddings) would be silently destroyed.
            req(cfg.PROBLEM.TYPE in ("SEMANTIC_SEG", "DETECTION", "INSTANCE_SEG"),
                "TEST.OUTPUT_QUANT_UINT8 quantizes outputs as [0,1] "
                "probabilities; it is only valid for SEMANTIC_SEG, DETECTION "
                "and probability-channel INSTANCE_SEG workflows, not "
                f"{cfg.PROBLEM.TYPE} (regression outputs would be clipped)")
            if cfg.PROBLEM.TYPE == "INSTANCE_SEG":
                _prob_codes = {"F", "B", "M", "P", "C", "A", "T", "We"}
                bad = [c for c in cfg.PROBLEM.INSTANCE_SEG.DATA_CHANNELS
                       if c not in _prob_codes]
                req(not bad,
                    "TEST.OUTPUT_QUANT_UINT8 requires every instance channel "
                    "to be a [0,1] probability map; channels "
                    f"{bad} are signed/unbounded (distances, flows, offsets "
                    "or embeddings) and would be destroyed by the clip")
        if cfg.DATA.TEST.ROI_MASK.ENABLE:
            req(str(cfg.DATA.TEST.ROI_MASK.PATH) != "",
                "DATA.TEST.ROI_MASK.PATH needs to be set when ROI_MASK.ENABLE is True")
        if cfg.TEST.BY_CHUNKS.ENABLE:
            req(is_3d, "TEST.BY_CHUNKS requires PROBLEM.NDIM == '3D' (reference parity)")
            req(cfg.PROBLEM.TYPE in ("SEMANTIC_SEG", "INSTANCE_SEG", "DETECTION"),
                "TEST.BY_CHUNKS can only be activated in SEMANTIC_SEG, "
                "INSTANCE_SEG and DETECTION workflows")
            z0, z1 = int(cfg.TEST.BY_CHUNKS.Z_START), int(cfg.TEST.BY_CHUNKS.Z_END)
            req(z0 >= -1, "TEST.BY_CHUNKS.Z_START must be -1 (disabled) or a "
                "non-negative integer")
            req(z1 >= -1 and z1 != 0, "TEST.BY_CHUNKS.Z_END must be -1 (disabled) "
                "or a positive integer")
            if z0 != -1 and z1 != -1:
                req(z0 < z1, "TEST.BY_CHUNKS.Z_START must be less than Z_END")
            for ph in cfg.TEST.BY_CHUNKS.PHASES:
                req(str(ph) in ("prediction", "instance_creation", "instance_merging"),
                    f"Unknown TEST.BY_CHUNKS.PHASES entry: {ph} "
                    "(valid: prediction/instance_creation/instance_merging)")
            req(str(cfg.TEST.BY_CHUNKS.WORKFLOW_PROCESS.TYPE)
                in ("chunk_by_chunk", "entire_pred"),
                "TEST.BY_CHUNKS.WORKFLOW_PROCESS.TYPE must be 'chunk_by_chunk' "
                "or 'entire_pred' (reference check_configuration.py:2312)")
        # DATA.PREPROCESS.ZOOM is by-chunks-only (reference
        # check_configuration.py:2150-2156)
        if cfg.DATA.PREPROCESS.ZOOM.ENABLE:
            req(cfg.TEST.BY_CHUNKS.ENABLE,
                "DATA.PREPROCESS.ZOOM.ENABLE requires TEST.BY_CHUNKS.ENABLE")
            req(len(cfg.DATA.PREPROCESS.ZOOM.ZOOM_FACTOR)
                == len(str(cfg.DATA.TEST.INPUT_IMG_AXES_ORDER)),
                "DATA.PREPROCESS.ZOOM.ZOOM_FACTOR must have one entry per axis "
                "of DATA.TEST.INPUT_IMG_AXES_ORDER")
        if cfg.TEST.MATCHING_STATS:
            for t in cfg.TEST.MATCHING_STATS_THS:
                req(0.0 < float(t) < 1.0, f"TEST.MATCHING_STATS_THS values must be in (0,1), got {t}")
        req(str(cfg.TEST.AUGMENTATION_MODE).lower() in ("", "mean", "min", "max"),
            f"TEST.AUGMENTATION_MODE must be mean/min/max, got {cfg.TEST.AUGMENTATION_MODE}")
        req(str(cfg.TEST.AUGMENTATION_GROUP).lower() in ("", "auto", "full", "flips", "none"),
            f"TEST.AUGMENTATION_GROUP must be auto/full/flips/none, got "
            f"{cfg.TEST.AUGMENTATION_GROUP}")
        req(not (cfg.TEST.ANALIZE_2D_IMGS_AS_3D_STACK and is_3d),
            "TEST.ANALIZE_2D_IMGS_AS_3D_STACK makes no sense for a 3D problem "
            "(reference check_configuration.py:1403)")
        pp = cfg.TEST.POST_PROCESSING
        if pp.VORONOI_ON_MASK:
            req(cfg.PROBLEM.TYPE == "INSTANCE_SEG",
                "TEST.POST_PROCESSING.VORONOI_ON_MASK only applies to INSTANCE_SEG")
        if pp.DET_WATERSHED:
            req(cfg.PROBLEM.TYPE == "DETECTION",
                "TEST.POST_PROCESSING.DET_WATERSHED only applies to DETECTION "
                "(reference check_configuration.py:997)")
            fdil = list(pp.DET_WATERSHED_FIRST_DILATION)
            req(len(fdil) in (0, nd),
                f"DET_WATERSHED_FIRST_DILATION needs {nd} values for {cfg.PROBLEM.NDIM}")
            req(all(int(y) != -1 for y in fdil),
                "Please set TEST.POST_PROCESSING.DET_WATERSHED_FIRST_DILATION "
                "when using TEST.POST_PROCESSING.DET_WATERSHED")
            # the donut detector measures circularity/sphericity per instance,
            # so the measurement+filter pass must be on (reference
            # check_configuration.py:1847-1864)
            mp = pp.MEASURE_PROPERTIES
            req(bool(mp.ENABLE) and bool(mp.REMOVE_BY_PROPERTIES.ENABLE),
                "TEST.POST_PROCESSING.MEASURE_PROPERTIES.ENABLE and "
                "MEASURE_PROPERTIES.REMOVE_BY_PROPERTIES.ENABLE need to be set "
                "when TEST.POST_PROCESSING.DET_WATERSHED is enabled")
            for lprop in list(mp.REMOVE_BY_PROPERTIES.PROPS):
                ok = (isinstance(lprop, (list, tuple)) and len(lprop) == 1
                      and str(lprop[0]) in ("circularity", "sphericity"))
                req(ok,
                    "With TEST.POST_PROCESSING.DET_WATERSHED enabled, "
                    "REMOVE_BY_PROPERTIES.PROPS must be single-property "
                    "conditions on 'circularity' or 'sphericity'")
            dc = [int(c) for c in pp.DET_WATERSHED_DONUTS_CLASSES]
            if dc and dc != [-1]:
                req(len(dc) <= int(cfg.DATA.N_CLASSES) and max(dc) <= int(cfg.DATA.N_CLASSES),
                    "DET_WATERSHED_DONUTS_CLASSES entries must be class ids <= DATA.N_CLASSES")
                req(dc == list(range(min(dc), min(dc) + len(dc))),
                    "DET_WATERSHED_DONUTS_CLASSES must be consecutive, e.g. [1,2,3,4]")
                req(len(list(pp.DET_WATERSHED_DONUTS_PATCH)) == nd,
                    f"DET_WATERSHED_DONUTS_PATCH needs {nd} values")
        if int(pp.REPARE_LARGE_BLOBS_SIZE) != -1:
            req(cfg.PROBLEM.TYPE == "INSTANCE_SEG",
                "TEST.POST_PROCESSING.REPARE_LARGE_BLOBS_SIZE only applies to INSTANCE_SEG")
            req(set(cfg.PROBLEM.INSTANCE_SEG.DATA_CHANNELS) == {"F", "P"},
                "REPARE_LARGE_BLOBS_SIZE only makes sense with DATA_CHANNELS ['F','P'] "
                "(reference check_configuration.py:989)")
        if pp.MEDIAN_FILTER:
            req(len(pp.MEDIAN_FILTER_AXIS) > 0 and len(pp.MEDIAN_FILTER_SIZE) > 0,
                "MEDIAN_FILTER needs MEDIAN_FILTER_AXIS and MEDIAN_FILTER_SIZE configured")
            req(len(pp.MEDIAN_FILTER_AXIS) == len(pp.MEDIAN_FILTER_SIZE),
                "MEDIAN_FILTER_AXIS and MEDIAN_FILTER_SIZE must have the same length")
            req(cfg.PROBLEM.TYPE in ("SEMANTIC_SEG", "INSTANCE_SEG", "DETECTION"),
                "MEDIAN_FILTER only applies to SEMANTIC_SEG/INSTANCE_SEG/DETECTION")
            for f in pp.MEDIAN_FILTER_AXIS:
                req(str(f) in ("xy", "yx", "zy", "yz", "zx", "xz", "z"),
                    f"MEDIAN_FILTER_AXIS options are xy/yx/zy/yz/zx/xz/z, got '{f}'")
                req("z" not in str(f) or is_3d or cfg.TEST.ANALIZE_2D_IMGS_AS_3D_STACK,
                    "z-axis median filtering in 2D needs TEST.ANALIZE_2D_IMGS_AS_3D_STACK")
        if pp.MEASURE_PROPERTIES.ENABLE and list(pp.MEASURE_PROPERTIES.EXTRA_PROPS):
            # regionprops attribute vocabulary (reference
            # check_configuration.py:1055-1070)
            _VALID_REGIONPROPS = {
                "area", "area_bbox", "area_convex", "area_filled",
                "axis_major_length", "axis_minor_length", "bbox", "centroid",
                "centroid_local", "centroid_weighted", "centroid_weighted_local",
                "coords_scaled", "coords", "eccentricity",
                "equivalent_diameter_area", "euler_number", "extent",
                "feret_diameter_max", "image", "image_convex", "image_filled",
                "image_intensity", "inertia_tensor", "inertia_tensor_eigvals",
                "intensity_max", "intensity_mean", "intensity_min",
                "intensity_std", "label", "moments", "moments_central",
                "moments_hu", "moments_normalized", "moments_weighted",
                "moments_weighted_central", "moments_weighted_hu",
                "moments_weighted_normalized", "num_pixels", "orientation",
                "perimeter", "perimeter_crofton", "slice", "solidity",
            }
            bad = set(map(str, pp.MEASURE_PROPERTIES.EXTRA_PROPS)) - _VALID_REGIONPROPS
            req(not bad,
                f"Invalid MEASURE_PROPERTIES.EXTRA_PROPS found: {sorted(bad)}")
        if pp.MEASURE_PROPERTIES.ENABLE and pp.MEASURE_PROPERTIES.REMOVE_BY_PROPERTIES.ENABLE:
            rp = pp.MEASURE_PROPERTIES.REMOVE_BY_PROPERTIES
            req(cfg.PROBLEM.TYPE in ("INSTANCE_SEG", "DETECTION"),
                "REMOVE_BY_PROPERTIES only applies to INSTANCE_SEG/DETECTION "
                "(reference check_configuration.py:1073)")
            req(len(rp.PROPS) > 0,
                "REMOVE_BY_PROPERTIES.PROPS cannot be empty when enabled")
            req(len(rp.PROPS) == len(rp.VALUES) == len(rp.SIGNS),
                "REMOVE_BY_PROPERTIES PROPS/VALUES/SIGNS must have equal lengths")
            _RM_PROPS = ("circularity", "npixels", "area", "diameter", "elongation",
                         "sphericity", "perimeter", "size", "volume")
            for props, values, signs in zip(rp.PROPS, rp.VALUES, rp.SIGNS):
                if not isinstance(props, (list, tuple)):
                    req(False, "REMOVE_BY_PROPERTIES entries must be lists of "
                        "lists, e.g. PROPS: [['circularity'], ['area','diameter']]")
                    continue
                req(len(props) == len(values) == len(signs),
                    "REMOVE_BY_PROPERTIES sublists must have equal lengths")
                req(len(set(props)) == len(props),
                    "REMOVE_BY_PROPERTIES: repeated properties are not allowed")
                for p, v, s in zip(props, values, signs):
                    req(str(p) in _RM_PROPS,
                        f"Unknown REMOVE_BY_PROPERTIES property '{p}' (valid: {_RM_PROPS})")
                    req(str(s) in ("gt", "ge", "lt", "le"),
                        f"REMOVE_BY_PROPERTIES signs must be gt/ge/lt/le, got '{s}'")
                    if str(p) in ("circularity", "elongation"):
                        req(not is_3d, f"'{p}' is 2D-only (3D analog: sphericity)")
                        if str(p) == "circularity":
                            req(0.0 <= float(v) <= 1.0,
                                "circularity values must be in [0,1]")
                    if str(p) == "sphericity":
                        req(is_3d, "'sphericity' is 3D-only (2D analog: circularity)")

    # -- sample filtering -------------------------------------------------------
    # (reference: FILTER_SAMPLES structure/vocabulary rules,
    # check_configuration.py:836-980)
    _FILTER_PROPS = ("foreground", "mean", "min", "max", "target_mean",
                     "target_min", "target_max", "diff", "diff_by_min_max_ratio",
                     "diff_by_target_min_max_ratio")
    _TARGET_PROPS = ("foreground", "target_mean", "target_min", "target_max",
                     "diff", "diff_by_min_max_ratio", "diff_by_target_min_max_ratio")
    for split in ("TRAIN", "VAL", "TEST"):
        fs = cfg.DATA[split].FILTER_SAMPLES
        if not fs.ENABLE:
            continue
        req(len(fs.PROPS) > 0,
            f"DATA.{split}.FILTER_SAMPLES.PROPS cannot be empty when filtering is enabled")
        req(len(fs.PROPS) == len(fs.VALUES) == len(fs.SIGNS),
            f"DATA.{split}.FILTER_SAMPLES PROPS/VALUES/SIGNS must have the same length")
        for i, (props, values, signs) in enumerate(zip(fs.PROPS, fs.VALUES, fs.SIGNS)):
            req(isinstance(props, (list, tuple)) and isinstance(values, (list, tuple))
                and isinstance(signs, (list, tuple)),
                f"DATA.{split}.FILTER_SAMPLES entries must be lists of lists, "
                "e.g. PROPS: [['mean'], ['min','max']]")
            if not isinstance(props, (list, tuple)):
                continue
            req(len(props) == len(values) == len(signs),
                f"DATA.{split}.FILTER_SAMPLES condition {i}: PROPS/VALUES/SIGNS "
                "sublists must have the same length")
            req(len(set(props)) == len(props),
                f"DATA.{split}.FILTER_SAMPLES condition {i}: repeated properties "
                "are not allowed")
            for p, v, s in zip(props, values, signs):
                req(str(p) in _FILTER_PROPS,
                    f"Unknown FILTER_SAMPLES property '{p}' (valid: {_FILTER_PROPS})")
                req(str(s) in ("gt", "ge", "lt", "le"),
                    f"FILTER_SAMPLES signs must be gt/ge/lt/le, got '{s}'")
                if str(p) == "foreground":
                    req(cfg.PROBLEM.TYPE in ("SEMANTIC_SEG", "INSTANCE_SEG", "DETECTION"),
                        "'foreground' filtering needs a workflow with masks "
                        "(SEMANTIC_SEG/INSTANCE_SEG/DETECTION)")
                    req(0.0 <= float(v) <= 1.0,
                        "'foreground' filter values must be in [0,1]")
                if str(p).startswith("diff"):
                    req(cfg.PROBLEM.TYPE != "SUPER_RESOLUTION",
                        "diff-based FILTER_SAMPLES conditions are not possible in "
                        "super-resolution (raw and target differ in size; "
                        "reference check_configuration.py:956)")
                if str(p) in _TARGET_PROPS:
                    req(cfg.PROBLEM.TYPE not in ("DENOISING", "SELF_SUPERVISED"),
                        f"FILTER_SAMPLES property '{p}' needs target data, which "
                        f"{cfg.PROBLEM.TYPE} does not have")
                    if split == "TEST":
                        req(bool(cfg.DATA.TEST.LOAD_GT) or bool(cfg.DATA.TEST.USE_VAL_AS_TEST),
                            f"FILTER_SAMPLES property '{p}' on TEST needs "
                            "DATA.TEST.LOAD_GT or USE_VAL_AS_TEST")

    # -- loss ------------------------------------------------------------------
    # (reference: the per-workflow LOSS.TYPE whitelists,
    # check_configuration.py:1330-1366, and LOSS.CLASS_REBALANCE/IGNORE_INDEX
    # rules :1369-1381)
    ltype = str(cfg.LOSS.TYPE).upper()
    if cfg.PROBLEM.TYPE == "SEMANTIC_SEG":
        req(ltype in ("", "CE", "DICE", "W_CE_DICE"),
            f"LOSS.TYPE for SEMANTIC_SEG must be CE/DICE/W_CE_DICE, got {ltype}")
        if int(cfg.DATA.N_CLASSES) > 2:
            req(ltype in ("", "CE", "W_CE_DICE"),
                "DATA.N_CLASSES > 2 needs LOSS.TYPE CE or W_CE_DICE")
    elif cfg.PROBLEM.TYPE in ("SUPER_RESOLUTION", "SELF_SUPERVISED", "IMAGE_TO_IMAGE"):
        req(ltype in ("", "MAE", "MSE", "SSIM", "W_MAE_SSIM", "W_MSE_SSIM"),
            f"LOSS.TYPE for {cfg.PROBLEM.TYPE} must be MAE/MSE/SSIM/W_MAE_SSIM/"
            f"W_MSE_SSIM, got {ltype}")
        if ltype in ("W_MAE_SSIM", "W_MSE_SSIM"):
            req(len(cfg.LOSS.WEIGHTS) == 2 and abs(sum(cfg.LOSS.WEIGHTS) - 1.0) < 1e-6,
                "LOSS.WEIGHTS must be two floats summing to 1 for weighted SSIM losses")
    elif cfg.PROBLEM.TYPE == "DENOISING":
        req(ltype in ("", "MSE", "CYCLEGAN"),
            f"LOSS.TYPE for DENOISING must be MSE or CYCLEGAN, got {ltype}")
    elif cfg.PROBLEM.TYPE == "CLASSIFICATION":
        req(ltype in ("", "CE"), f"LOSS.TYPE for CLASSIFICATION must be CE, got {ltype}")
    if int(cfg.LOSS.IGNORE_INDEX) != -1:
        req(0 <= int(cfg.LOSS.IGNORE_INDEX) <= 255,
            "LOSS.IGNORE_INDEX must be in [0,255] when set")
    req(str(cfg.LOSS.CLASS_REBALANCE) in ("none", "manual"),
        f"LOSS.CLASS_REBALANCE must be 'none' or 'manual', got {cfg.LOSS.CLASS_REBALANCE}")
    if str(cfg.LOSS.CLASS_REBALANCE) == "manual":
        req(len(cfg.LOSS.CLASS_WEIGHTS) == int(cfg.DATA.N_CLASSES),
            "LOSS.CLASS_WEIGHTS must have one weight per class with manual rebalance")
    elif cfg.LOSS.CLASS_WEIGHTS and int(cfg.DATA.N_CLASSES) > 2:
        req(len(cfg.LOSS.CLASS_WEIGHTS) == int(cfg.DATA.N_CLASSES),
            "LOSS.CLASS_WEIGHTS length must equal DATA.N_CLASSES")
    if cfg.LOSS.CONTRAST.ENABLE:
        req(int(cfg.LOSS.CONTRAST.MEMORY_SIZE) > 0, "LOSS.CONTRAST.MEMORY_SIZE must be > 0")
        req(int(cfg.LOSS.CONTRAST.PROJ_DIM) > 0, "LOSS.CONTRAST.PROJ_DIM must be > 0")
        req(int(cfg.LOSS.CONTRAST.PIXEL_UPD_FREQ) > 0, "LOSS.CONTRAST.PIXEL_UPD_FREQ must be > 0")
        req(cfg.PROBLEM.TYPE in ("SEMANTIC_SEG", "INSTANCE_SEG", "DETECTION"),
            "LOSS.CONTRAST only applies to SEMANTIC_SEG/INSTANCE_SEG/DETECTION")
        req(arch != "stunet", "LOSS.CONTRAST cannot be combined with stunet "
            "(reference check_configuration.py:1399)")

    # -- per-workflow -------------------------------------------------------
    if cfg.PROBLEM.TYPE == "INSTANCE_SEG":
        itype = str(cfg.PROBLEM.INSTANCE_SEG.TYPE)
        req(itype in ("regular", "synapses"),
            f"PROBLEM.INSTANCE_SEG.TYPE must be 'regular' or 'synapses', got {itype}")
        chans = cfg.PROBLEM.INSTANCE_SEG.DATA_CHANNELS
        req(isinstance(chans, (list, tuple)) and len(chans) > 0,
            "PROBLEM.INSTANCE_SEG.DATA_CHANNELS must be a non-empty list")
        if itype == "regular":
            for c in chans:
                req(c in INSTANCE_CHANNEL_CODES or str(c).startswith("E"),
                    f"Unknown instance channel code '{c}' (valid: {INSTANCE_CHANNEL_CODES})")
            # channel dependency rules (reference check_configuration.py:1530-1569)
            cset = set(chans)
            if "M" in cset:
                req(is_3d, "'M' (CartoCell legacy) channel is 3D-only")
                req(cset == {"F", "C", "M"},
                    "'M' can only be combined with exactly 'F' and 'C' (CartoCell)")
            req("A" not in cset or is_3d, "'A' (affinities) channel is 3D-only here")
            req("Z" not in cset or is_3d, "'Z' offset channel is 3D-only")
            req(not (("H" in cset) ^ ("V" in cset)),
                "'H' and 'V' HoVer offsets must be used together")
            if "Z" in cset:
                req({"H", "V"} <= cset, "'Z' needs 'H' and 'V' offsets alongside")
            if cset and cset <= {"H", "V", "Z"}:
                req(False, "HoVer offsets alone cannot define the foreground — add "
                    "one of F/B/C/Db/Dc/Dn/D")
            # extra-opts key vocabulary per channel (reference
            # check_configuration.py:1600-1699)
            _ALLOWED_OPTS = {
                "F": {"erosion", "dilation"}, "B": {"erosion", "dilation"},
                "P": {"erosion", "dilation", "type"},
                "C": {"mode"},
                # regular type: only norm/act ('mask_values' is no longer
                # accepted — foreground masking is derived automatically;
                # reference check_configuration.py:498-501); synapses type
                # additionally takes 'dilation' (validated in synapses branch)
                "Z": {"norm", "act"},
                "V": {"norm", "act"},
                "H": {"norm", "act"},
                "Gv": {"gradient_type"}, "Gh": {"gradient_type"}, "Gz": {"gradient_type"},
                "Db": {"val_type", "act", "mask_values"},
                "Dc": {"type", "norm", "mask_values"},
                "Dn": {"closing_size", "norm", "mask_values", "decline_power"},
                "D": {"act", "mask_values"},
                "R": {"nrays", "mask_values"},
                "T": {"thickness"},
                "A": {"z_affinities", "y_affinities", "x_affinities", "widen_borders"},
                "E": {"center_mode", "medoid_max_points"},
                "E_offset": {"center_mode", "medoid_max_points"},
            }
            extra_list = list(cfg.PROBLEM.INSTANCE_SEG.DATA_CHANNELS_EXTRA_OPTS)
            opts_map = extra_list[0] if extra_list else {}
            if isinstance(opts_map, dict):
                # grouped channels (H/V/Z and Gv/Gh/Gz) share settings: opts
                # may be configured on only one of each group, or must be
                # identical (reference check_configuration.py:485-530)
                for group in (("Z", "V", "H"), ("Gz", "Gv", "Gh")):
                    with_opts = [c for c in group if c in opts_map]
                    if len(with_opts) > 1:
                        vals = [opts_map[c] for c in with_opts]
                        req(all(v == vals[0] for v in vals[1:]),
                            "DATA_CHANNELS_EXTRA_OPTS contains conflicting "
                            f"options for channels of the {'/'.join(group)} "
                            "group — these channels always share the same "
                            "settings; configure only one of them")
                for key, val in opts_map.items():
                    req(str(key) in cset or str(key) in INSTANCE_CHANNEL_CODES
                        or str(key).startswith("E"),
                        f"DATA_CHANNELS_EXTRA_OPTS has '{key}' which is not a "
                        "channel code")
                    allowed = _ALLOWED_OPTS.get(str(key))
                    if allowed is not None and isinstance(val, dict):
                        for opt in val:
                            req(str(opt) in allowed,
                                f"DATA_CHANNELS_EXTRA_OPTS['{key}'] option '{opt}' "
                                f"is not supported (valid: {sorted(allowed)})")
                    if str(key) == "C" and isinstance(val, dict) and "mode" in val:
                        req(str(val["mode"]) in ("thick", "inner", "outer",
                                                 "subpixel", "dense"),
                            "contour mode must be thick/inner/outer/subpixel/dense")
                    if str(key) in ("Gv", "Gh", "Gz") and isinstance(val, dict) \
                            and "gradient_type" in val:
                        req(str(val["gradient_type"]) in ("cellpose", "omnipose"),
                            "gradient_type must be 'cellpose' or 'omnipose'")
                    if str(key) == "Db" and isinstance(val, dict) \
                            and str(val.get("val_type")) == "discretize":
                        req(cset == {"Db"},
                            "'Db' must be the only channel when val_type is "
                            "'discretize'")
                    # fine-grained value checks (reference typed asserts,
                    # check_configuration.py:1615-1695)
                    if isinstance(val, dict):
                        if str(key) == "Db" and "val_type" in val:
                            req(str(val["val_type"]) in ("raw", "norm",
                                                         "discretize", "omnipose"),
                                "Db val_type must be raw/norm/discretize/omnipose")
                        if str(key) in ("P", "Dc") and "type" in val:
                            req(str(val["type"]) in ("centroid", "skeleton"),
                                f"'{key}' type must be 'centroid' or 'skeleton'")
                        if str(key) == "R" and "nrays" in val:
                            req(isinstance(val["nrays"], int) and val["nrays"] >= 1,
                                "R nrays must be an int >= 1")
                        if str(key) == "T" and "thickness" in val:
                            req(isinstance(val["thickness"], int)
                                and val["thickness"] >= 1,
                                "T thickness must be an int >= 1")
                        if str(key).startswith("E") and "center_mode" in val:
                            req(str(val["center_mode"]) in ("medoid", "centroid"),
                                "E center_mode must be 'medoid' or 'centroid'")
                        if str(key) == "A":
                            affs = (("z_affinities", "y_affinities", "x_affinities")
                                    if is_3d else ("y_affinities", "x_affinities"))
                            lens = []
                            for ax in affs:
                                if ax in val:
                                    ok = (isinstance(val[ax], (list, tuple))
                                          and all(isinstance(v, int) and v > 0
                                                  for v in val[ax]))
                                    req(ok, f"A {ax} must be a list of "
                                        "positive ints")
                                    lens.append(len(val[ax]))
                            req(len(set(lens)) <= 1,
                                "A affinity lists must have the same length")
                            if "widen_borders" in val:
                                req(isinstance(val["widen_borders"], int)
                                    and val["widen_borders"] >= 0,
                                    "A widen_borders must be an int >= 0")
            losses = list(cfg.PROBLEM.INSTANCE_SEG.DATA_CHANNELS_LOSSES)
            if losses:
                req(len(losses) == len([c for c in chans if c not in ("We", "I")]),
                    "PROBLEM.INSTANCE_SEG.DATA_CHANNELS_LOSSES must match DATA_CHANNELS "
                    "length (GT-only 'We'/'I' channels take no loss)")
                for ln in losses:
                    req(str(ln) in ("bce", "ce", "mse", "l1", "mae", "embedseg"),
                        f"DATA_CHANNELS_LOSSES values must be bce/ce/mse/l1/mae/embedseg, "
                        f"got '{ln}'")
            extra_l = list(cfg.PROBLEM.INSTANCE_SEG.DATA_CHANNELS_EXTRA_OPTS)
            extra = extra_l[0] if extra_l else {}
            if any(c in ("Gv", "Gh", "Gz") for c in chans) and \
                    str(extra.get("Gv", {}).get("gradient_type", "cellpose")) == "omnipose":
                # Omnipose reconstruction needs the predicted distance field
                # (reference check_configuration.py:711-721)
                req("Db" in chans and str(extra.get("Db", {}).get("val_type")) == "omnipose",
                    "Omnipose flows need a 'Db' channel with val_type 'omnipose'")
            if (cfg.PROBLEM.INSTANCE_SEG.SEPARATED_DECODERS_PER_HEAD and len(chans) > 1
                    and int(cfg.DATA.N_CLASSES) <= 2):
                # with N_CLASSES > 2 the class head provides the second decoder
                req(len(list(cfg.PROBLEM.INSTANCE_SEG.CHANNELS_PER_HEAD_INFO)) >= 2,
                    "SEPARATED_DECODERS_PER_HEAD needs CHANNELS_PER_HEAD_INFO with at "
                    "least 2 entries (reference check_configuration.py:787)")
            proc = str(cfg.PROBLEM.INSTANCE_SEG.INSTANCE_CREATION_PROCESS).lower()
            # reference canonical names (check_configuration.py:1493) plus our
            # accepted aliases (flow_tracking/gradient_tracking = gradient-flow,
            # nms = stardist, embedseg = embeddings)
            req(proc in ("", "watershed", "flow_tracking", "gradient_tracking",
                         "omnipose", "stardist", "nms", "embedseg", "embeddings",
                         "gradient-flow", "agglomeration"),
                f"Unknown INSTANCE_CREATION_PROCESS: {proc}")
            req(proc != "agglomeration",
                "INSTANCE_CREATION_PROCESS 'agglomeration' is not implemented "
                "(reference parity: NotImplementedError, "
                "check_configuration.py:1597)")
            cset_noaux = set(chans) - {"I", "We"}
            # E (embeddings) and A (affinities) are whole representations that
            # must stand alone (reference check_configuration.py:135-138)
            if "E" in cset_noaux or any(str(c).startswith("E_") for c in cset_noaux):
                req(cset_noaux <= {"E", "E_offset", "E_sigma", "E_seediness"},
                    "'E' representation can only be used alone")
            if "A" in cset_noaux:
                req(cset_noaux == {"A"}, "'A' representation can only be used alone")
            if proc in ("flow_tracking", "gradient_tracking", "omnipose",
                        "gradient-flow"):
                req(any(c in ("Gv", "Gh", "Gz") for c in chans),
                    f"{proc} needs flow channels (Gv/Gh/Gz) in DATA_CHANNELS, got {list(chans)}")
                # the flow set must come with a foreground/distance source
                # (reference check_configuration.py:1542-1549)
                req(cset_noaux - {"Gv", "Gh", "Gz"} <= {"Db", "F"}
                    and len(cset_noaux - {"Gv", "Gh", "Gz"}) == 1,
                    "gradient-flow channels must be exactly "
                    "{'Db'|'F', 'Gv', 'Gh'(, 'Gz' in 3D)}, got "
                    f"{sorted(cset_noaux)}")
            if proc in ("stardist", "nms"):
                req("R" in chans, f"StarDist NMS needs the 'R' ray channel, got {list(chans)}")
                req(cset_noaux == {"Db", "R"},
                    "'Db' and 'R' channels must be used (and only those) when "
                    "INSTANCE_CREATION_PROCESS is 'stardist' (reference "
                    "check_configuration.py:1535-1538)")
            if proc in ("embedseg", "embeddings"):
                req("E" in cset_noaux
                    or {"E_offset", "E_sigma", "E_seediness"} <= cset_noaux,
                    "'embeddings' instance creation needs the 'E' channel "
                    "representation (E_offset/E_sigma/E_seediness)")
            if proc == "watershed":
                # representation channels of other processes are meaningless
                # under watershed (reference check_configuration.py:1551-1553)
                for c in ("R", "Gv", "Gh", "E", "E_offset", "E_sigma",
                          "E_seediness"):
                    req(c not in cset_noaux,
                        f"'{c}' channel can not be used when "
                        "INSTANCE_CREATION_PROCESS is 'watershed'")
            ws = cfg.PROBLEM.INSTANCE_SEG.WATERSHED
            for sel in list(ws.SEED_CHANNELS) + list(ws.GROWTH_MASK_CHANNELS):
                req(str(sel) in [str(c) for c in chans] or sel in ("", None),
                    f"Watershed channel '{sel}' is not among DATA_CHANNELS {list(chans)}")
            req(all(str(c) in ("F", "B", "C", "Db", "Dc", "Dn", "D", "A", "P", "M")
                    for c in ws.GROWTH_MASK_CHANNELS),
                "WATERSHED.GROWTH_MASK_CHANNELS can only contain "
                "F/B/C/Db/Dc/Dn/D/A channels (reference "
                "check_configuration.py:1576)")
            for th in list(ws.SEED_CHANNELS_THRESH) + list(ws.GROWTH_MASK_CHANNELS_THRESH):
                if str(th) != "auto":
                    try:
                        float(th)
                    except (TypeError, ValueError):
                        req(False,
                            "WATERSHED SEED/GROWTH_MASK_CHANNELS_THRESH values "
                            "can only be 'auto' or a float")
            # either side may be empty (the engine fills channel defaults per
            # representation and 'auto' thresholds; the reference prefills
            # them in check_configuration instead) — when the user sets BOTH,
            # the lengths must agree
            req(not (list(ws.SEED_CHANNELS) and list(ws.SEED_CHANNELS_THRESH))
                or len(ws.SEED_CHANNELS) == len(ws.SEED_CHANNELS_THRESH),
                "WATERSHED.SEED_CHANNELS and SEED_CHANNELS_THRESH must have "
                "the same length")
            req(not (list(ws.GROWTH_MASK_CHANNELS)
                     and list(ws.GROWTH_MASK_CHANNELS_THRESH))
                or len(ws.GROWTH_MASK_CHANNELS) == len(ws.GROWTH_MASK_CHANNELS_THRESH),
                "WATERSHED.GROWTH_MASK_CHANNELS and GROWTH_MASK_CHANNELS_THRESH "
                "must have the same length")
            if ws.BY_2D_SLICES:
                req(is_3d or cfg.TEST.ANALIZE_2D_IMGS_AS_3D_STACK,
                    "WATERSHED.BY_2D_SLICES can only be activated when "
                    "PROBLEM.NDIM == 3D or in 2D with "
                    "TEST.ANALIZE_2D_IMGS_AS_3D_STACK (reference "
                    "check_configuration.py:1801)")
            for op in ws.SEED_MORPH_SEQUENCE:
                req(str(op) in ("dilate", "erode"),
                    "WATERSHED.SEED_MORPH_SEQUENCE entries must be 'dilate'/'erode'")
            req(len(ws.SEED_MORPH_SEQUENCE) == len(ws.SEED_MORPH_RADIUS),
                "WATERSHED.SEED_MORPH_SEQUENCE and SEED_MORPH_RADIUS must have "
                "the same length")
            # per-channel loss weights: one per non-auxiliary channel (+1 for
            # the class head when N_CLASSES > 2); the (1,1) default broadcasts
            # (reference check_configuration.py:931-945, 1745-1756)
            n_weighted = len([c for c in chans if c not in ("We", "I")])
            if int(cfg.DATA.N_CLASSES) > 2:
                n_weighted += 1
            dw = list(cfg.PROBLEM.INSTANCE_SEG.DATA_CHANNEL_WEIGHTS)
            if not any(str(c).startswith("E") for c in chans) \
                    and dw not in ([1, 1], [1]):
                req(len(dw) == n_weighted,
                    "PROBLEM.INSTANCE_SEG.DATA_CHANNEL_WEIGHTS needs to be of "
                    "the same length as the channels selected in DATA_CHANNELS "
                    f"(expected {n_weighted}, got {len(dw)}; one more weight "
                    "when DATA.N_CLASSES > 2)")
            if ws.ERODE_AND_DILATE_GROWTH_MASK:
                req(any(c in ("F", "B", "C", "D", "M") for c in chans),
                    "WATERSHED.ERODE_AND_DILATE_GROWTH_MASK needs one of F/B/C/D/M")
            if cfg.TEST.POST_PROCESSING.VORONOI_ON_MASK:
                req(any(c in ("F", "B", "C", "M") for c in chans),
                    "VORONOI_ON_MASK needs one of the F/B/C/M channels "
                    "(reference check_configuration.py:1782)")
            ir = cfg.TEST.POST_PROCESSING.INSTANCE_REFINEMENT
            if ir.ENABLE:
                req(len(ir.OPERATIONS) == len(ir.VALUES),
                    "INSTANCE_REFINEMENT OPERATIONS and VALUES must have the same "
                    "length ('none' for value-less ops)")
                for op, value in zip(ir.OPERATIONS, ir.VALUES):
                    req(str(op) in ("dilation", "erosion", "fill_holes", "clear_border",
                                    "remove_small_objects", "remove_big_objects"),
                        f"Unknown INSTANCE_REFINEMENT operation '{op}'")
                    if str(op) in ("dilation", "erosion"):
                        # int >= 1 or per-axis list (reference
                        # check_configuration.py:1767-1775)
                        ok = (isinstance(value, int) and value >= 1) or (
                            isinstance(value, (list, tuple)) and len(value) == nd
                            and all(isinstance(v, int) and v >= 1 for v in value))
                        req(ok,
                            f"INSTANCE_REFINEMENT value for '{op}' must be an "
                            f"int >= 1 or a list of {nd} ints >= 1")
                    if str(op) in ("remove_small_objects", "remove_big_objects"):
                        req(isinstance(value, int) and value >= 1,
                            f"INSTANCE_REFINEMENT value for '{op}' must be an int >= 1")
                    if str(op) in ("fill_holes", "clear_border"):
                        req(str(value) == "none",
                            f"INSTANCE_REFINEMENT value for '{op}' must be 'none'")
        else:  # synapses
            from biapy_tpu_torch.data.synapses import select_synapse_method

            try:
                select_synapse_method(list(chans))
            except ValueError as e:
                req(False, str(e))
            req(is_3d, "Synapse detection is 3D only (CREMI Zarr/H5 volumes)")
            req(str(cfg.PROBLEM.INSTANCE_SEG.SYNAPSES.POINT_CREATION_FUNCTION)
                in ("peak_local_max", "blob_log"),
                "SYNAPSES.POINT_CREATION_FUNCTION must be peak_local_max or blob_log")
            req(str(cfg.PROBLEM.INSTANCE_SEG.SYNAPSES.TH_TYPE)
                in ("auto", "manual", "relative", "relative_by_patch"),
                f"Unknown SYNAPSES.TH_TYPE: {cfg.PROBLEM.INSTANCE_SEG.SYNAPSES.TH_TYPE}")
    if cfg.PROBLEM.TYPE == "DETECTION":
        req(all(int(d) >= 0 for d in cfg.PROBLEM.DETECTION.CENTRAL_POINT_DILATION),
            "PROBLEM.DETECTION.CENTRAL_POINT_DILATION values must be >= 0")
        # a single value broadcasts to every spatial axis; otherwise the
        # length must match (reference check_configuration.py:1828-1837)
        req(len(cfg.PROBLEM.DETECTION.CENTRAL_POINT_DILATION) in (1, nd),
            f"PROBLEM.DETECTION.CENTRAL_POINT_DILATION needs to be a list of "
            f"{nd} ints (or one int, broadcast) in a {cfg.PROBLEM.NDIM} problem")
        req(float(cfg.TEST.DET_TOLERANCE) > 0, "TEST.DET_TOLERANCE must be > 0")
        req(str(cfg.TEST.DET_TH_TYPE) in ("manual", "auto"),
            "TEST.DET_TH_TYPE must be one of ['manual', 'auto']")
        req(str(cfg.TEST.DET_POINT_CREATION_FUNCTION) in ("peak_local_max", "blob_log"),
            "TEST.DET_POINT_CREATION_FUNCTION must be one of "
            "['peak_local_max', 'blob_log']")
        box = list(cfg.TEST.DET_IGNORE_POINTS_OUTSIDE_BOX)
        if box:
            req(all(int(x) > 0 for x in box),
                "TEST.DET_IGNORE_POINTS_OUTSIDE_BOX needs to be a list of "
                "positive integers")
            req(len(box) == nd,
                f"TEST.DET_IGNORE_POINTS_OUTSIDE_BOX needs to be of {nd} dimension")
        if int(cfg.DATA.N_CLASSES) > 2:
            req(len(cfg.PROBLEM.DETECTION.DATA_CHANNEL_WEIGHTS) == 2,
                "When DATA.N_CLASSES > 2, PROBLEM.DETECTION.DATA_CHANNEL_WEIGHTS "
                "needs two weights: one for the background and one for the "
                "foreground")
    if cfg.TEST.POST_PROCESSING.REMOVE_CLOSE_POINTS:
        req(int(cfg.TEST.POST_PROCESSING.REMOVE_CLOSE_POINTS_RADIUS) > 0,
            "TEST.POST_PROCESSING.REMOVE_CLOSE_POINTS_RADIUS needs to be set "
            "when REMOVE_CLOSE_POINTS is True")
        tres = [float(r) for r in cfg.DATA.TEST.RESOLUTION]
        req(bool(tres) and tres != [-1.0],
            "DATA.TEST.RESOLUTION must be set when using "
            "TEST.POST_PROCESSING.REMOVE_CLOSE_POINTS (the radius is in "
            "physical units)")
    if cfg.PROBLEM.TYPE == "DENOISING":
        n2v = cfg.PROBLEM.DENOISING
        if n2v.LOAD_GT_DATA or str(cfg.LOSS.TYPE).upper() == "CYCLEGAN":
            # (reference check_configuration.py:1947-1955)
            req(bool(cfg.DATA.TRAIN.GT_PATH)
                or bool(cfg.DATA.TRAIN.INPUT_ZARR_MULTIPLE_DATA)
                or not cfg.TRAIN.ENABLE,
                "Supervised denoising (CYCLEGAN or LOAD_GT_DATA=True) requires "
                "ground truth: DATA.TRAIN.GT_PATH must be provided")
        if not n2v.LOAD_GT_DATA:  # Noise2Void
            req(not cfg.DATA.TEST.LOAD_GT,
                "Noise2Void denoising is unsupervised — there is no ground "
                "truth to load; disable DATA.TEST.LOAD_GT "
                "(reference check_configuration.py:2024)")
            req(0.0 < float(n2v.N2V_PERC_PIX) <= 100.0,
                f"PROBLEM.DENOISING.N2V_PERC_PIX must be in (0,100], got {n2v.N2V_PERC_PIX}")
            req(str(n2v.N2V_MANIPULATOR) in (
                "uniform_withCP", "uniform_withoutCP", "normal_withoutCP", "normal_additive",
                "normal_fitted", "identity", "mean", "median"),
                f"Unknown N2V manipulator: {n2v.N2V_MANIPULATOR}")
    if cfg.PROBLEM.TYPE == "SUPER_RESOLUTION":
        ups = cfg.PROBLEM.SUPER_RESOLUTION.UPSCALING
        req(len(ups) == nd, f"PROBLEM.SUPER_RESOLUTION.UPSCALING must have {nd} values")
        req(all(int(u) >= 1 for u in ups), "UPSCALING factors must be >= 1")
    if cfg.PROBLEM.TYPE == "CLASSIFICATION":
        req(cfg.DATA.N_CLASSES >= 2, "DATA.N_CLASSES must be >= 2 for classification")
    if cfg.PROBLEM.TYPE == "SELF_SUPERVISED":
        req(cfg.PROBLEM.SELF_SUPERVISED.PRETEXT_TASK in ("crappify", "masking"),
            f"Unknown SSL pretext task: {cfg.PROBLEM.SELF_SUPERVISED.PRETEXT_TASK}")
        if cfg.PROBLEM.SELF_SUPERVISED.PRETEXT_TASK == "masking":
            req(str(cfg.MODEL.ARCHITECTURE).lower() == "mae",
                "SSL masking pretext requires MODEL.ARCHITECTURE == 'mae'")
            req(str(cfg.MODEL.MAE_MASK_TYPE) in ("random", "grid"),
                "MODEL.MAE_MASK_TYPE needs to be in ['random', 'grid']")
            if str(cfg.MODEL.MAE_MASK_TYPE) == "random":
                req(0.0 < float(cfg.MODEL.MAE_MASK_RATIO) < 1.0,
                    "MODEL.MAE_MASK_RATIO not in (0, 1) range")
        if cfg.PROBLEM.SELF_SUPERVISED.PRETEXT_TASK == "crappify":
            req(str(cfg.MODEL.ARCHITECTURE).lower() != "mae",
                "MODEL.ARCHITECTURE can not be 'mae' when the SSL pretext task "
                "is 'crappify' (mae only reconstructs masked tokens)")
            req(int(cfg.PROBLEM.SELF_SUPERVISED.RESIZING_FACTOR) in (2, 4, 6),
                "PROBLEM.SELF_SUPERVISED.RESIZING_FACTOR not in [2, 4, 6]")
            req(0.0 <= float(cfg.PROBLEM.SELF_SUPERVISED.NOISE) <= 1.0,
                "PROBLEM.SELF_SUPERVISED.NOISE not in [0, 1] range")
    if cfg.PROBLEM.TYPE == "IMAGE_TO_IMAGE":
        i2i = cfg.PROBLEM.IMAGE_TO_IMAGE
        if getattr(i2i, "SEPARATED_DECODERS_PER_HEAD", False):
            req(len(getattr(i2i, "CHANNELS_PER_HEAD_INFO", [])) >= 1,
                "SEPARATED_DECODERS_PER_HEAD requires CHANNELS_PER_HEAD_INFO")
        if list(i2i.CHANNELS_PER_HEAD_INFO):
            # (reference check_configuration.py:2089-2094)
            req(sum(int(c) for c in i2i.CHANNELS_PER_HEAD_INFO)
                == int(i2i.OUTPUT_CHANNELS),
                "The sum of PROBLEM.IMAGE_TO_IMAGE.CHANNELS_PER_HEAD_INFO "
                f"({sum(int(c) for c in i2i.CHANNELS_PER_HEAD_INFO)}) needs to "
                "equal PROBLEM.IMAGE_TO_IMAGE.OUTPUT_CHANNELS "
                f"({i2i.OUTPUT_CHANNELS})")
        if getattr(i2i, "MULTIPLE_RAW_ONE_TARGET_LOADER", False):
            req(not cfg.DATA.TRAIN.FILTER_SAMPLES.ENABLE
                and not cfg.DATA.VAL.FILTER_SAMPLES.ENABLE,
                "FILTER_SAMPLES can not be enabled together with "
                "PROBLEM.IMAGE_TO_IMAGE.MULTIPLE_RAW_ONE_TARGET_LOADER "
                "(samples are whole raw groups, not single images)")

    # -- zarr multiple-data sources --------------------------------------------
    # (reference: the per-split required-path rules, check_configuration.py:
    # 2180-2260 and 2331-2368)
    _zarr_splits = [("TRAIN", cfg.TRAIN.ENABLE), ("VAL", cfg.TRAIN.ENABLE),
                    ("TEST", cfg.TEST.ENABLE)]
    for split, active in _zarr_splits:
        node = cfg.DATA[split]
        if not (active and node.INPUT_ZARR_MULTIPLE_DATA):
            continue
        req(is_3d,
            f"DATA.{split}.INPUT_ZARR_MULTIPLE_DATA is only implemented in 3D "
            "workflows")
        req(str(node.INPUT_ZARR_MULTIPLE_DATA_RAW_PATH) != "",
            f"DATA.{split}.INPUT_ZARR_MULTIPLE_DATA_RAW_PATH needs to be set "
            f"when DATA.{split}.INPUT_ZARR_MULTIPLE_DATA is used")
        needs_gt = split != "TEST" or bool(cfg.DATA.TEST.LOAD_GT)
        if not needs_gt:
            continue
        if cfg.PROBLEM.TYPE == "INSTANCE_SEG" \
                and str(cfg.PROBLEM.INSTANCE_SEG.TYPE) == "synapses":
            for key in ("ID", "PARTNERS", "LOCATIONS", "RESOLUTION"):
                req(str(node[f"INPUT_ZARR_MULTIPLE_DATA_{key}_PATH"]) != "",
                    f"DATA.{split}.INPUT_ZARR_MULTIPLE_DATA_{key}_PATH needs "
                    f"to be set when DATA.{split}.INPUT_ZARR_MULTIPLE_DATA is "
                    "used and PROBLEM.INSTANCE_SEG.TYPE == 'synapses'")
        else:
            req(str(node.INPUT_ZARR_MULTIPLE_DATA_GT_PATH) != "",
                f"DATA.{split}.INPUT_ZARR_MULTIPLE_DATA_GT_PATH needs to be "
                f"set when DATA.{split}.INPUT_ZARR_MULTIPLE_DATA is used")

    # -- data path existence ---------------------------------------------------
    # (reference check_configuration.py:2160-2297, gated on check_data_paths)
    if check_data_paths:
        _no_gt_workflows = ("DENOISING", "CLASSIFICATION", "SELF_SUPERVISED")
        if cfg.TRAIN.ENABLE:
            req(os.path.exists(str(cfg.DATA.TRAIN.PATH)),
                f"Train data dir not found: {cfg.DATA.TRAIN.PATH}")
            if cfg.PROBLEM.TYPE not in _no_gt_workflows \
                    and not cfg.DATA.TRAIN.INPUT_ZARR_MULTIPLE_DATA \
                    and not (cfg.PROBLEM.TYPE == "DENOISING"):
                req(os.path.exists(str(cfg.DATA.TRAIN.GT_PATH)),
                    f"Train mask data dir not found: {cfg.DATA.TRAIN.GT_PATH}")
            if not cfg.DATA.VAL.FROM_TRAIN:
                req(os.path.exists(str(cfg.DATA.VAL.PATH)),
                    f"Validation data dir not found: {cfg.DATA.VAL.PATH}")
                if cfg.PROBLEM.TYPE not in _no_gt_workflows \
                        and not cfg.DATA.VAL.INPUT_ZARR_MULTIPLE_DATA:
                    req(os.path.exists(str(cfg.DATA.VAL.GT_PATH)),
                        f"Validation mask data dir not found: {cfg.DATA.VAL.GT_PATH}")
        if cfg.TEST.ENABLE and not cfg.DATA.TEST.USE_VAL_AS_TEST:
            req(os.path.exists(str(cfg.DATA.TEST.PATH)),
                f"Test data not found: {cfg.DATA.TEST.PATH}")
            if cfg.DATA.TEST.LOAD_GT \
                    and cfg.PROBLEM.TYPE not in ("CLASSIFICATION", "SELF_SUPERVISED") \
                    and not cfg.DATA.TEST.INPUT_ZARR_MULTIPLE_DATA:
                req(os.path.exists(str(cfg.DATA.TEST.GT_PATH)),
                    f"Test data mask not found: {cfg.DATA.TEST.GT_PATH}")
            if cfg.PROBLEM.TYPE == "CLASSIFICATION" \
                    and os.path.isdir(str(cfg.DATA.TEST.PATH)):
                # class folders must match N_CLASSES (reference
                # check_configuration.py:2271-2291)
                classes = sorted(
                    d for d in os.listdir(str(cfg.DATA.TEST.PATH))
                    if os.path.isdir(os.path.join(str(cfg.DATA.TEST.PATH), d)))
                req(len(classes) >= 1,
                    f"There is no folder/class for test in {cfg.DATA.TEST.PATH}")
                expected = int(cfg.DATA.N_CLASSES) if cfg.DATA.TEST.LOAD_GT else 1
                req(not classes or len(classes) == expected,
                    f"Found {len(classes)} classes for test (folders: "
                    f"{classes}) but expected {expected} "
                    f"({'DATA.N_CLASSES' if cfg.DATA.TEST.LOAD_GT else 'a single folder, as DATA.TEST.LOAD_GT is False'})")
        if cfg.TEST.ENABLE and cfg.DATA.TEST.ROI_MASK.ENABLE \
                and str(cfg.DATA.TEST.ROI_MASK.PATH):
            req(os.path.exists(str(cfg.DATA.TEST.ROI_MASK.PATH)),
                f"DATA.TEST.ROI_MASK.PATH not found: {cfg.DATA.TEST.ROI_MASK.PATH}")

    # REMOVE_CLOSE_POINTS radius is in physical units, so the resolution must
    # be fully specified (reference check_configuration.py:3439-3448)
    if cfg.TEST.POST_PROCESSING.REMOVE_CLOSE_POINTS:
        tres_ = [float(r) for r in cfg.DATA.TEST.RESOLUTION]
        if tres_ and tres_ != [-1.0]:
            req(len(tres_) == nd,
                f"DATA.TEST.RESOLUTION must match in length to {nd}, the "
                "number of dimensions, when using REMOVE_CLOSE_POINTS")

    # -- BMZ export metadata ---------------------------------------------------
    # (reference: check_bmz_export_fields, check_configuration.py:3550-3560 —
    # the RDF needs these to build a valid model card)
    exp = cfg.MODEL.BMZ.EXPORT
    if exp.ENABLE and exp.REUSE_BMZ_CONFIG:
        # reusing the imported package's model card requires having imported
        # one (reference check_configuration.py:3433-3436)
        req(str(cfg.MODEL.SOURCE).lower() == "bmz",
            "Seems that you are not loading a BioImage Model Zoo model. Thus, "
            "you can not activate 'MODEL.BMZ.EXPORT.REUSE_BMZ_CONFIG' as there "
            "will be nothing to reuse.")
    if exp.ENABLE and not exp.REUSE_BMZ_CONFIG:
        req(str(exp.MODEL_NAME) != "", "MODEL.BMZ.EXPORT.MODEL_NAME must be set")
        req(str(exp.DESCRIPTION) != "", "MODEL.BMZ.EXPORT.DESCRIPTION must be set")
        req(str(exp.LICENSE) != "", "MODEL.BMZ.EXPORT.LICENSE must be set")
        req(len(list(exp.TAGS)) > 0, "MODEL.BMZ.EXPORT.TAGS must be set")
        authors = list(exp.AUTHORS)
        req(len(authors) > 0 and all(
            isinstance(a, dict) and "name" in a and "github_user" in a
            for a in authors),
            "MODEL.BMZ.EXPORT.AUTHORS must be a non-empty list of dicts with "
            "'name' and 'github_user' keys")
        for c in list(exp.CITE):
            req(isinstance(c, dict) and "text" in c
                and set(c).issubset({"text", "doi", "url"}),
                "MODEL.BMZ.EXPORT.CITE entries must be dicts with at least "
                "'text' (valid keys: text/doi/url)")
        if str(exp.DOCUMENTATION) != "":
            req(str(exp.DOCUMENTATION).endswith(".md"),
                "MODEL.BMZ.EXPORT.DOCUMENTATION file suffix must be .md")
        di = exp.DATASET_INFO
        req(isinstance(di, (list, tuple)) and len(di) == 1
            and isinstance(di[0], dict)
            and set(di[0]).issubset({"name", "doi", "image_modality",
                                     "dataset_id", "id"}),
            "MODEL.BMZ.EXPORT.DATASET_INFO must be a list with a single dict "
            "inside (valid keys: name/doi/image_modality/dataset_id)")

    if errors:
        raise ValueError("Invalid configuration:\n  - " + "\n  - ".join(errors))
