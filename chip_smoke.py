#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``biapy_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit code:

1. environment: the card's name and power limit (nvidia-smi), CUDA version;
   no CUDA device, or no ``biapy_tpu_torch`` beside this script, exits 2;
2. build: the hand-written kernels from ``biapy_tpu_torch/csrc`` (nvcc,
   sm_90a), with the build seconds;
3. kernels vs plain: each of the seven kernels at every shape the serving
   and training paths give it, and the pool, its backward and zcat at the
   templates' (their three pools, the zcats of their 14 convs at batch 2, at
   depth 40 and at the detection template's 20; the denoising,
   super-resolution and image-to-image templates' two pools, two zd2s and
   zs2d and the zcats of their ten convs, at each template's batch and
   patch) (bf16 and f32, plus
   odd shapes: ragged sizes,
   c = 1, kz = 5, two images, tied pool windows with a NaN; for conv3d also
   odd shapes on each route: overhanging bricks, channel tails, widths off
   the 8 grid (Cin 28, 36, 84, Cout 28, 36, 12, 1), stems at Cin 1 and 3,
   an output-tile loop; and the 3D templates' 14 forward convs and 13 input
   gradients in bf16 at batch 2 and depth 40, with their sums against
   ``F.conv3d`` and the bound) against its plain PyTorch version, with the
   kernel's, the plain version's and the library call's device-side times
   (``device_ms``: CUDA events around ten back-to-back calls queued behind a
   spin kernel, divided by ten), the kernel's and the library call's call
   times (``time_ms``: events around one call, host work included), the
   bound (for the 3xTF32 route, three TF32 products a float32 one) and, for
   conv3d, the route; the same convs in float32, with the 3D templates' and
   the super-resolution template's forward and input gradients, and their
   sums and rows slower than ``F.conv3d`` (float32, TF32 off), phase 14
   c's rcan and dfcan convs (stems 1 -> 16 and 1 -> 64, bodies, up-sampling
   16 -> 128 and 64 -> 512, output convs 16 -> 1 and 64 -> 1 on the HR grid,
   their input gradients) and zcats in both dtypes, each conv row against
   ``F.conv3d`` and its bound, and the
   3xTF32 route's split of x bit-equal to its plain version; fails unless
   a main-path conv3d row runs above the CUDA cores' 67 TFLOP/s in bf16 and
   in float32;
4. serving path: ``BiaPy(cfg).predict`` at the bench's full width (resunet
   32/64/128, BatchNorm, ELU, 128^3 patches, halo 10, bf16, uint8 drain) on
   a seeded 216^3 uint8 volume, three calls, with the launch counters
   checked at 10 conv3d (9 on the tensor-core route, the stem on the stem
   route), 2 pool and 2 zd2s per patch;
5. whole path vs plain path: the same model at reduced width on the card
   and on the CPU (plain versions), probabilities compared, in float32
   (the stem kernel and the 3xTF32 conv) and in bf16 (the stem kernel and
   the tensor-core conv), each with its routes checked;
6. training path: ``prepare_model()`` and ``make_train_step`` on the same
   model at 128^3 under bf16 mixed precision, batch 1 then 2 (two steps to
   settle, at least six timed), with the launch counters checked per step
   (19 conv3d, 18 of them on the tensor-core route and the stem's on the
   stem route, 10 zcat, 2 each of
   pool, pool backward, zd2s, zs2d), a
   falling finite loss, changed weights and statistics, patches/s, peak
   memory and one profiled step;
7. the same with ``MODEL.LARGER_IO`` (two steps): the 5x5x5 convs take the
   cat2d path, so zcat (kz = 5) and zcat_bwd are counted too;
8. gradients on the card vs the plain path: one step at reduced width on
   the card and on the CPU, loss, gradients and updated weights compared;
9. the job: ``BiaPy(cfg).run_job()`` on a seeded dataset of uint8 TIFFs it
   writes under ``chiprun_out/chip_smoke_job/`` (deleted at the end): two
   epochs at batch 2, checkpoints, the test volume from disk; the launch
   counters over the job equal phase 6's per step plus phase 4's per
   forward batch; the checkpoints are read back and a model loaded from the
   best one predicts the written volume exactly; seconds per epoch, the
   loop's patches/s, the device's idle share over steady steps, checkpoint
   bytes and seconds and the test pass's Mvox/s are printed;
10. by-chunks: ``BiaPy(cfg).test()`` with ``TEST.BY_CHUNKS`` on seeded uint8
    Zarr volumes it writes under ``chiprun_out/chip_smoke_chunks/`` (deleted
    at the end): (a) a 432^3 volume in 2 x 2 x 2 tiles of 216^3, whose raw
    prediction must equal ``predict`` on the volume in memory within 1 uint8
    LSB (the count of differing voxels printed); (b) the bench's 1080 x 648
    x 648 volume in 45 tiles after a one-tile warm-up: seconds, Mvox/s, Zarr
    and drain times, peak memory, and the device's idle share over a
    profiled Z_START / Z_END sub-job of 9 tiles; every run's launch counters
    checked at phase 4's per-patch counts;
11. augmentation and test-time augmentation (TTA): (a) phase 9's job with
    the repository template's augmentations (RANDOM_ROT, VFLIP, HFLIP,
    ZFLIP) and TTA in its test pass, written under
    ``chiprun_out/chip_smoke_aug/`` (deleted at the end): seconds per epoch,
    the loop's patches/s against phase 6's device-resident rate at b = 2,
    the host's augmentation seconds per sample, the device's idle share
    over steady steps, the launch counters at phase 6's per step; (b) the
    test pass again with TTA (mean over 16 orientations) at batch 1: Mvox/s,
    launches at 16 x phase 4's per patch; (c) TTA at reduced width on the
    card against the CPU (plain versions), float32 and bf16, as phase 5, on a
    40 x 37 x 45 volume (the CPU side in the child of 19);
    (d) ``templates/semantic_segmentation/3d_semantic_segmentation.yaml``
    as it is but for its data paths (seeded TIFFs under
    ``chiprun_out/chip_smoke_template/``), EPOCHS 2 and a one-epoch warm-up:
    trains, writes its checkpoints, tests; seconds; conv3d's launches by
    route equal to the rule's for every forward (and backward) the model
    ran; every pool, pool backward and zcat launch on a 16-byte route
    (``build.SHUFFLE_ROUTES``);
12. the 3D instance-segmentation template: (a)
    ``templates/instance_segmentation/3d_instance_segmentation.yaml`` as it
    is but for its data (seeded TIFFs of non-touching ellipsoid instances
    and their labels under ``chiprun_out/chip_smoke_instance/``, deleted at
    the end) and EPOCHS 2: the native host ops built by g++, the B/C/D
    compile, training with the template's augmentations (rotated samples
    recompile D), the bf16 test pass, the watershed, the instance TIFF and
    the matching; compile seconds per volume, the loop's patches/s,
    regeneration seconds per rotated sample, test Mvox/s with its predict
    and watershed seconds, matching F1, peak memory and launches by kernel
    and route (conv3d's by route as the rule names them for the model's
    forwards, every pool, pool backward and zcat on a 16-byte route); (b)
    the best checkpoint's test pass on a 40 x 256 x 256 crop on the card and
    on the CPU (the CPU side in the child of 19), float32 and bf16, held to
    phase 5's tolerances, the instances at matching F1 >= 0.99 (IoU 0.5);
    (c) the best checkpoint by
    chunks with the template's commented BY_CHUNKS block uncommented
    (PATCHES_PER_TILE 1 x 1 x 1, IoU 0.3, bf16) on the test volume's first
    72 x 192 x 192 voxels as a uint8 Zarr (3 x 2 x 2 tiles): the raw
    prediction within 1 uint8 LSB of ``predict`` in memory, the merged
    ``instances.zarr`` id for id a plain merge written here (per-tile
    labels from the same raw prediction, face IoU edges, scipy's connected
    components), launches against the model's count; the seconds of each
    merge pass, Mvox/s and the ids before and after the merge;
13. point detection: (a) ``templates/detection/3d_detection.yaml`` as it is
    but for its data (seeded TIFFs of Gaussian blobs, sigma 2-3 voxels, in
    noise, with CSV points, under ``chiprun_out/chip_smoke_detection/``,
    deleted at the end), EPOCHS 2 and a one-epoch warm-up: the CSV to
    point-mask compile (cached next to the GT dirs: ``DETECTION_MASK_DIR``
    follows GT_PATH), training, the bf16 test pass and the points; mask
    seconds per volume, the loop's patches/s, test Mvox/s with its predict
    and point-extraction seconds, P/R/F1 at DET_TOLERANCE 8, peak memory,
    launches by kernel and route (conv3d's by route as the rule names them
    for the model's forwards; a ``scalar`` launch is reported, not
    failed); (b) the best checkpoint by chunks on a seeded 168 x 512 x 512
    Zarr with WORKFLOW_PROCESS on: its heatmap and candidate points equal
    ``predict``'s in memory (the candidates but near a tile core boundary),
    and on each side the points exactly the close-point removal over its own
    candidates (by chunks the per-tile sets in tile order); (c) the instance
    template's model and training with ``TYPE: synapses`` on seeded
    CREMI-layout Zarrs (72 x 256 x 256, 60 pairs), 2 epochs for each of
    simpsyn, synful, cleft and F_post_only, each tested in memory and by
    chunks (synful on a 48 x 128 x 128 volume, 10 pairs), the points held as
    in (b);
    (d) the best checkpoint of (a) on a 20 x 256 x 256 crop in float32 on
    the card and on the CPU (the CPU side in the child of 19): heatmaps
    within 1e-4, the same points;
14. the four 3D restoration templates: (a)
    ``templates/{denoising,super-resolution,self-supervised,image-to-image}/3d_*.yaml``
    as they are but for their data (seeded uint8 TIFFs of smooth structures
    in noise under ``chiprun_out/chip_smoke_restoration/``, deleted at the
    end: 64 x 256 x 256 noisy volumes; LR 64 x 256 x 256 with HR 64 x 512 x
    512 targets; 80 x 256 x 256 volumes; 80 x 256 x 256 sources with
    inverted blurred targets), EPOCHS 2 and, for super-resolution only,
    RANDOM_ROT off (the reference's rotation crops the SR target: ROADMAP
    section 3): run_job, train and test seconds, the loop's patches/s and
    the device's idle share over a profiled epoch, host seconds per sample
    of the target function (N2V manipulation, crappify) and of
    augmentation, test Mvox/s, PSNR and SSIM where there is GT, peak
    memory, launches by kernel and route against the counts read off the
    model for every forward it ran (zd2s and zs2d on the Z_DOWN 2 templates'
    decoders, none on the self-supervised template's Z_DOWN 1); (b) each
    best checkpoint on a crop of its test volume, card against CPU (float32
    within 1e-4; bf16 under the template's REDUCE_MEMORY no farther from
    float32 than the CPU's), and one float32 training step card against CPU
    (phase 8's rule); (c) the super-resolution template with its comment's
    ``rcan`` and ``dfcan`` at full width and depth and UPSCALING (2, 2, 2)
    (its own (1, 2, 2) fails at the first step's loss in both packages:
    ROADMAP section 3), RANDOM_ROT off, on seeded LR volumes of 16 x 256 x
    256 with HR targets twice them on every axis, through ``run_job``:
    seconds, PSNR and SSIM, launches by conv3d and zcat route against the
    counts read off the model (DFCAN's spectrum makes float32 of all after
    it), the best checkpoint card against CPU on an 8 x 128 x 128 crop
    (float32 within 1e-4 of the output's scale: rcan's outputs lie far
    above 1) and one float32 training step card against CPU (dfcan from
    the best checkpoint at phase 8's rule; rcan from its seeded weights at
    twice the JAX package's own float32 distance from float64,
    ``RCAN_STEP_TOLS``);
15. 3D classification and the U-Net variants: (a)
    ``templates/classification/3d_classification.yaml`` as it is but for its
    data (seeded uint8 TIFFs in three class folders that differ in texture
    and intensity, 40 x 80 x 80 volumes that RESIZE takes to the 32 x 64 x
    64 patch, under ``chiprun_out/chip_smoke_classification/``, deleted at
    the end) and EPOCHS 2, through ``run_job`` with simple_cnn at batch 8:
    run_job seconds, the loop's patches/s and the device's idle share over
    a profiled epoch, host seconds per sample of the resize and of
    augmentation, peak memory, test accuracy (a record: two epochs),
    predictions.csv row by row, launches by kernel and route against the
    counts read off the model; its best checkpoint card against CPU
    (float32 logits within 1e-4 of their scale and the same classes; bf16
    by phase 12 b's rule) and one float32 training step at batch 8 card
    against CPU (``CLS_STEP_TOLS``); (b) the
    same with ``MODEL.ARCHITECTURE: vit`` at the config's ViT defaults (the
    patch and RESIZE at 64^3: a ViT's patch must be the same on every
    axis); (c) the semantic template with ``seunet``, ``resunet_se`` and
    ``attention_unet``: bf16 training steps at its batch and patch and one
    ``predict``, launches against the model's count, no ``scalar`` route,
    card against CPU at a reduced patch;
16. the 2D templates: (a)
    ``templates/{semantic_segmentation,instance_segmentation,detection,denoising,image-to-image}/2d_*.yaml``
    as they are but for their data (seeded uint8 2D TIFFs made on the card
    under ``chiprun_out/chip_smoke_2d/``, deleted at the end: disks on a
    jittered grid with their masks or labels, Gaussian blobs with CSV
    points, smooth structures in noise and their inverted blur) and EPOCHS
    2, then ``2d_super-resolution.yaml`` with its ``rcan`` and RANDOM_ROT
    off (ROADMAP section 3) and ``2d_classification.yaml`` with its
    ``efficientnet_b0`` (four classes of 3-channel images in class folders,
    RESIZE to 224 x 224):
    run_job seconds, the loop's patches/s and the device's idle share over
    a profiled epoch, test Mpx/s, peak memory, the template's metric (IoU,
    matching F1, P/R/F1, PSNR/SSIM, accuracy: a record), launches by kernel
    and route against the counts read off the model (pool and pool
    backward only: no conv3d, zcat, zd2s or zs2d, none on ``scalar``); each
    best checkpoint card against CPU (float32 within 1e-4, of scale for
    rcan; bf16 under the template's REDUCE_MEMORY by phase 12 b's rule; the
    classifier on its logits) and one float32 training step card against
    CPU (phase 8's rule; rcan's from its seeded weights at
    ``RCAN_STEP_TOLS``); the super-resolution template's edsr, wdsr, dfcan
    and unet and the classification template's simple_cnn (the models this
    phase ran before rcan and efficientnet_b0 were ported: unet and
    simple_cnn) from seeded weights: a float32 forward at the template's patch card against
    CPU within 1e-4 of scale, and for unet and simple_cnn one float32
    training step card against CPU (phase 8's rule; simple_cnn at
    ``CLS_STEP_TOLS``, phase 15's); (b) one ``predict`` with
    TEST.FULL_IMG from the semantic template's best checkpoint, card against
    CPU; (c) ``vit`` in 2D at the config's defaults: one float32 forward
    card against CPU and one bf16 step;
17. the class heads (DATA.N_CLASSES 3) at the templates' widths, on
    ellipsoids made as phase 12 makes them (a seeded class for each; the GT
    their labels beside the class map) and blobs made as phase 13 makes
    them (a seeded ``class`` column in the CSVs), one training volume each,
    from seeded initial weights, through ``run_job`` for two epochs: (a) the
    instance template, (b) the detection template in memory and by chunks
    (72 x 192 x 192, 6 x 2 x 2 tiles, held against ``predict`` as phase 13 b
    does, the same classes at the same points); for each, launches against
    the model's count (``run_job``, by chunks and in memory), the best
    checkpoint's float32 forward on one patch of the template's size card
    against CPU within 1e-4 of scale for both heads, bf16 by phase 12 b's
    rule, the same voted classes (point classes) wherever the instances
    (points) are the same, and one float32 training step card against CPU
    on the same patch at the template's rate (loss 1e-6, weights 1e-6:
    phase 15's rule; gradients 1.3e-4, twice what the JAX package's own
    float32 step lies from float64 there);
18. rays and flows, each part on seeded data of its own through
    ``run_job`` (EPOCHS 2): (a) the 2D instance template with DATA_CHANNELS
    ['Db', 'R'] (its comment's StarDist), (b) the 3D instance template with
    ['F', 'Gv', 'Gh', 'Gz'] and the Cellpose defaults (the first-pass
    diameter and the in-plane rescale), (c) the 2D instance template with
    Omnipose ['Db', 'Gv', 'Gh']; for each, launches against the model's
    count, the best checkpoint's float32 prediction card against CPU within
    1e-4 of scale, the instances the CPU makes from the card's prediction
    identical to the card's, and those made from each side's prediction
    matched at IoU 0.5 (F1 >= 0.99 for StarDist and Omnipose; for Cellpose
    a record: a two-epoch network's 3D flow tracking parts them), the
    card's side profiled (the idle share), and the seconds of the
    ray NMS, the flow loop and the clustering; for (b) the check on one
    patch of the template's size at the network's input, ``follow_flows``'
    landings card against CPU on the same flows and a by-chunks run over 72
    x 192 x 192 held against ``predict`` of the same volume (phase 12 c's
    rule but the plain merge);
19. the card-vs-CPU comparisons of 11 c, 12 b, 13 d and 14-17, whose CPU
    sides (plain convs over whole crops and training steps, most of the
    run's CPU time) ran meanwhile in one child process with
    ``CPU_SIDE_THREADS`` torch threads, one after another, while the card
    went on with the later phases;
20. a ``{"kernels": [...]}`` line; the last line is ``{"ok": true, ...}``.

Phase 3 also holds the classification template's kernel shapes (its four
3x3x3 convs and their input gradients, its two 5x5x5 convs' zcats at kz 5
and zcat_bwds, its weight-gradient zcats and its two pools, forward and
backward, at batch 8; bf16 and float32), the U-Net variants' conv3d
(bf16) and zcat shapes that no other row covers, and the 2D templates'
pools and pool backwards at each template's batch and patch (``(batch, y,
x, C)`` with window 1 x 2 x 2, bit-checked, F.max_pool2d as the library
call).

``python3 chip_smoke.py --conv3d-only`` stops after the conv3d rows of
phase 3 (the quick check of a change to the conv kernels) and prints no
result line; ``--instance-only`` runs phases 1, 2 and 12 (with 12 c) alone,
``--class-heads-only`` phases 1, 2 and 17, ``--rays-flows-only`` phases 1, 2
and 18,
``--detection-only`` phases 1, 2 and 13, ``--restoration-only`` phases
1, 2, 3 and 14, ``--classification-only`` phases 1, 2, phase 3's
classification and variant rows and 15, and ``--2d-only`` phases 1, 2,
phase 3's 2D rows and 16; none prints a result line.

Details too long for the console go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DEVICE = "cuda:0"
OUT_DIR = REPO / "chiprun_out"

# (spatial size, Cin, Cout) of the 3x3x3 convs of one 128^3 patch through
# resunet 32/64/128, in network order: 10 launches
MAIN_CONVS = [(128, 1, 32), (128, 32, 32), (64, 32, 64), (64, 64, 64), (32, 64, 128),
              (32, 128, 128), (64, 192, 64), (64, 64, 64), (128, 96, 32), (128, 32, 32)]
# the input gradients of the same convs in one training step: the same
# kernel with Cin and Cout swapped; the stem's input needs none: 9 launches
DX_CONVS = [(s, cout, cin) for s, cin, cout in MAIN_CONVS[1:]]
MAIN_POOLS = [((128, 128, 128, 32), (2, 2, 2)), ((64, 64, 64, 64), (2, 2, 2))]
# the repository's 3D templates (resunet 28/36/48/64, Z_DOWN 1, batch 2;
# templates/semantic_segmentation/3d_semantic_segmentation.yaml and
# templates/instance_segmentation/3d_instance_segmentation.yaml at 40 x 128 x
# 128 patches, templates/detection/3d_detection.yaml at 20 x 128 x 128): three
# pools on folded rows 2 x depth, window 1 x 2 x 2, and 14 3x3x3 convs
# (spatial y = x, Cin, Cout) in network order, each of whose weight gradients
# takes one zcat of its input (rows 2 x depth)
TEMPLATE_DEPTH, DETECTION_DEPTH, TEMPLATE_BATCH = 40, 20, 2


def _template_pools(depth):
    return [((TEMPLATE_BATCH * depth, s, s, c), (1, 2, 2)) for s, c in ((128, 28), (64, 36),
                                                                         (32, 48))]


TEMPLATE_POOLS, DETECTION_POOLS = _template_pools(TEMPLATE_DEPTH), _template_pools(DETECTION_DEPTH)
TEMPLATE_CONVS = [(128, 1, 28), (128, 28, 28), (64, 28, 36), (64, 36, 36), (32, 36, 48),
                  (32, 48, 48), (16, 48, 64), (16, 64, 64), (32, 112, 48), (32, 48, 48),
                  (64, 84, 36), (64, 36, 36), (128, 64, 28), (128, 28, 28)]
MAIN_ZD2S = [((32, 64, 64, 256), 2), ((64, 128, 128, 128), 2)]
# the restoration templates' unet 16/32/64 with Z_DOWN 2 (the default), at
# each template's own patch and batch: the two pools (window 2 x 2 x 2, 16
# and 32 channels), the decoder's two zd2s (sz 2, to 32 and 16 channels) on
# folded rows, and the zcats of its ten 3x3x3 convs' weight gradients (kz 3,
# the conv's input (batch x depth, y, x, Cin) at its level's depth), in
# network order: (level, Cin) below; the super-resolution template's post
# up-sampling (1, 2, 2) adds no 3x3x3 conv
UNET_CONVS = [(0, 1), (0, 16), (1, 16), (1, 32), (2, 32), (2, 64), (1, 64), (1, 32), (0, 32),
              (0, 16)]


def _unet_rows(b, d, h, w):
    lv = [(d >> i, h >> i, w >> i) for i in range(3)]
    pools = [((b * d, h, w, 16), (2, 2, 2)), ((b * d // 2, h // 2, w // 2, 32), (2, 2, 2))]
    zd2s = [((b * d // 4, h // 2, w // 2, 2 * 32), 2), ((b * d // 2, h, w, 2 * 16), 2)]
    zcats = [((b * lv[i][0], lv[i][1], lv[i][2], cin), 3, lv[i][0]) for i, cin in UNET_CONVS]
    return pools, zd2s, zcats


# templates/denoising/3d_denoising.yaml (16 x 64 x 64 at batch 4),
# templates/super-resolution/3d_super-resolution.yaml (8 x 128 x 128 LR at
# batch 4) and templates/image-to-image/3d_image-to-image.yaml (20 x 128 x
# 128 at batch 2); the self-supervised template's resunet 28/36/48/64 at 20 x
# 128 x 128 and batch 2 runs the detection template's rows
RESTORATION_ROWS = {"denoising": _unet_rows(4, 16, 64, 64),
                    "sr": _unet_rows(4, 8, 128, 128),
                    "i2i": _unet_rows(2, 20, 128, 128)}
# templates/classification/3d_classification.yaml: simple_cnn at batch 8 on 32
# x 64 x 64 patches, two blocks of (3x3x3, 3x3x3, 5x5x5) convs at 32 then 64
# channels, each ending in a 2 x 2 x 2 pool: the block levels (d, h, w), the
# 3x3x3 convs as (level, Cin, Cout) and the 5x5x5 convs (cat2d: zcat at kz 5,
# one 2D conv, zcat_bwd for the input gradient) as (level, C), network order
CLS_BATCH = 8
CLS_LEVELS = [(32, 64, 64), (16, 32, 32)]
CLS_CONVS = [(0, 1, 32), (0, 32, 32), (1, 32, 64), (1, 64, 64)]
CLS_CAT2D = [(0, 32), (1, 64)]


def _cls_rows(b=CLS_BATCH):
    """The classification template's kernel shapes: the 3x3x3 convs (vol,
    Cin, Cout), their input gradients (all but the stem's), the two pools,
    the 5x5x5 convs' zcats (kz 5) and zcat_bwds, and the 3x3x3 convs'
    weight-gradient zcats (kz 3), all at batch ``b``."""
    def rows(lv, c):
        d, h, w = CLS_LEVELS[lv]
        return (b * d, h, w, c), d
    convs = [((b,) + CLS_LEVELS[lv], cin, cout) for lv, cin, cout in CLS_CONVS]
    dx = [((b,) + CLS_LEVELS[lv], cout, cin) for lv, cin, cout in CLS_CONVS[1:]]
    pools = [(rows(lv, c)[0], (2, 2, 2)) for lv, c in CLS_CAT2D]
    zcat5 = [(rows(lv, c)[0], 5, rows(lv, c)[1]) for lv, c in CLS_CAT2D]
    zcat3 = [(rows(lv, cin)[0], 3, rows(lv, cin)[1]) for lv, cin, _ in CLS_CONVS]
    return convs, dx, pools, zcat5, zcat3


# the 2D templates' pools (window 2 x 2 on (batch, y, x, C): the pool kernel
# on the unit-depth view, window 1 x 2 x 2) at each template's batch and
# patch: unet 16-256 at 8 x 256^2 (semantic), resunet / unet 16-128 at 6 x
# 256^2 (instance, detection), unet 16/32/64 at 16 x 64^2 (denoising), unet
# 16-128 at 8 x 256^2 (image-to-image) and simple_cnn's two at 32 x 224^2
# (the classification template's comment's alternative: its own
# efficientnet_b0 pools nothing, nor does the super-resolution template's
# rcan or its unet [16])
def _twod_pools(b, s, chans):
    return [((b, s >> i, s >> i, c), (1, 2, 2)) for i, c in enumerate(chans)]


TWOD_POOLS = {"semantic": _twod_pools(8, 256, (16, 32, 64, 128)),
              "instance": _twod_pools(6, 256, (16, 32, 64)),
              "detection": _twod_pools(6, 256, (16, 32, 64)),
              "denoising": _twod_pools(16, 64, (16, 32)),
              "image_to_image": _twod_pools(8, 256, (16, 32, 64)),
              "classification": _twod_pools(32, 224, (32, 64))}


# the U-Net variants on the semantic template (28/36/48/64, Z_DOWN 1, batch 2,
# 40 x 128 x 128: level i at 40 x 128 / 2^i squared): their 3x3x3 convs as
# (level, Cin, Cout) in network order. seunet and attention_unet decode as
# unet does (the up-sampled features at the level's width beside the skip),
# resunet_se as resunet (the up-sampled features keep the level below's
# width) with one more conv per block (the extra conv, then the block's two)
TEMPLATE_FM = (28, 36, 48, 64)


def _variant_convs(variant, fm=TEMPLATE_FM):
    residual = variant in ("resunet", "resunet_se")
    per = 3 if variant == "resunet_se" else 2
    out, cin = [], 1
    for lv, f in enumerate(fm):
        out += [(lv, cin, f)] + [(lv, f, f)] * (per - 1)
        cin = f
    for lv in range(len(fm) - 2, -1, -1):
        up = fm[lv + 1] if residual else fm[lv]
        out += [(lv, up + fm[lv], fm[lv])] + [(lv, fm[lv], fm[lv])] * (per - 1)
    return out


UNET_VARIANTS = ("seunet", "resunet_se", "attention_unet")


def _variant_rows():
    """The variants' bf16 conv3d shapes (forward, and the input gradients
    of all but the stem) and weight-gradient zcats (kz 3) at the template's
    batch 2 and depth 40, each once."""
    b, d = TEMPLATE_BATCH, TEMPLATE_DEPTH
    convs, zcats = [], []
    for v in UNET_VARIANTS:
        k3 = _variant_convs(v)
        for i, (lv, cin, cout) in enumerate(k3):
            s = 128 >> lv
            convs.append(((b, d, s, s), cin, cout))
            if i:
                convs.append(((b, d, s, s), cout, cin))
            zcats.append(((b * d, s, s, cin), 3, d))
    return list(dict.fromkeys(convs)), list(dict.fromkeys(zcats))


# the LARGER_IO model's two 5x5x5 convs (stem, out block) at batch 1: zcat's
# input and kz; the out block's input needs a gradient, the stem's does not
LARGER_IO_ZCATS = [((128, 128, 128, 1), 5), ((128, 128, 128, 32), 5)]
ZCAT_BWD_MAIN = LARGER_IO_ZCATS[1]
# launches per training step at batch 1 (the LARGER_IO model adds two kz = 5
# zcat forwards and one zcat backward)
TRAIN_LAUNCHES = {"conv3d": 19, "zcat": 10, "pool_max_folded": 2, "pool_max_folded_bwd": 2,
                  "zd2s": 2, "zs2d": 2, "zcat_bwd": 0, "pad_channels": 0, "tf32_split": 0}
LARGER_IO_LAUNCHES = dict(TRAIN_LAUNCHES, conv3d=20, zcat=12, zcat_bwd=1)
# conv3d's routes (biapy_tpu_torch/ops/kernels/conv3d.py::conv3d_route) and
# its launches by route: in bf16 the 1-channel stem's forward takes the stem
# kernel and every other conv the tensor cores; the 3xTF32 route runs
# float32 alone; with LARGER_IO the stem is a 5x5x5 conv (cat2d path), so
# every 3x3x3 conv has Cin = 32 or more
CONV3D_ROUTE_NAMES = ("wgmma", "stem", "tf32x3")
SERVE_ROUTES = {"wgmma": 9, "stem": 1, "tf32x3": 0}
TRAIN_ROUTES = {"wgmma": 18, "stem": 1, "tf32x3": 0}
LARGER_IO_ROUTES = {"wgmma": 20, "stem": 0, "tf32x3": 0}
# the 1-channel stems, ((N, D, H, W), Cin, Cout): the main path's, the 3D
# templates' and the classification template's
STEM_CONVS = [((1, 128, 128, 128), 1, 32), ((TEMPLATE_BATCH, TEMPLATE_DEPTH, 128, 128), 1, 28),
              ((CLS_BATCH,) + CLS_LEVELS[0], 1, 32)]
_SHUFFLE = "biapy_tpu_torch/csrc/shuffle.cu"
KERNEL_META = {
    "conv3d": ("biapy_tpu_torch/csrc/conv3d.cu", "biapy_tpu/ops/pallas/conv3d.py:213"),
    # conv3d's channel pad (tensor-core route, Cin off the 8 grid) and the
    # 3xTF32 route's split of x: parts of the same kernel's port
    "pad_channels": ("biapy_tpu_torch/csrc/conv3d.cu", "biapy_tpu/ops/pallas/conv3d.py:213"),
    "tf32_split": ("biapy_tpu_torch/csrc/conv3d.cu", "biapy_tpu/ops/pallas/conv3d.py:213"),
    "pool_max_folded": (_SHUFFLE, "biapy_tpu/ops/pallas/shuffle.py:232"),
    "zd2s": (_SHUFFLE, "biapy_tpu/ops/pallas/shuffle.py:294"),
    "zcat": (_SHUFFLE, "biapy_tpu/ops/pallas/shuffle.py:109"),
    "zcat_bwd": (_SHUFFLE, "biapy_tpu/ops/pallas/shuffle.py:152"),
    "pool_max_folded_bwd": (_SHUFFLE, "biapy_tpu/ops/pallas/shuffle.py:252"),
    "zs2d": (_SHUFFLE, "biapy_tpu/ops/pallas/shuffle.py:317"),
}


def peaks(card_name: str):
    """Dense peak rates of the card (NVIDIA data sheets): FLOP/s by dtype
    (``float32``: the CUDA cores; ``tf32``: the tensor cores on TF32
    operands), bytes/s of device memory."""
    if "PCIe" in card_name or "PCIE" in card_name:
        return {"bfloat16": 756e12, "float32": 51e12, "tf32": 378e12}, 2.0e12
    return {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}, 3.35e12


# conv3d's routes that do more than one product a multiply-add, and how
# many: the 3xTF32 route takes three TF32 products for each float32 one
ROUTE_PASSES = {"tf32x3": ("tf32", 3)}


def bound(flops, nbytes, dtype_name, card, route=None):
    """The least time of a call (ms) and what sets it: its ``flops`` at the
    card's peak for ``dtype_name`` (for a route in ``ROUTE_PASSES``, that
    many products a flop at its rate), or its ``nbytes`` at the memory's."""
    rates, bw = peaks(card)
    rate, passes = ROUTE_PASSES.get(route, (dtype_name, 1))
    t_ops = passes * flops / rates[rate] * 1e3
    t_bytes = nbytes / bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, reps=10, warmup=2):
    """Median of ``reps`` CUDA-event timings of one call of ``fn()`` after
    ``warmup``: the "call ms". A window around one call also holds the host
    work of the call (a wrapper's checks, allocation, launch), so for a short
    kernel it is longer than the kernel."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


_CYCLES_PER_MS = []


def _spin(ms):
    """Queue a kernel that keeps the device busy for about ``ms``."""
    import torch

    if not _CYCLES_PER_MS:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(20_000_000)
        b.record()
        b.synchronize()
        _CYCLES_PER_MS.append(20_000_000 / a.elapsed_time(b))
    torch.cuda._sleep(int(ms * _CYCLES_PER_MS[0]))


def device_ms(fn, reps=10):
    """Device-side ms per call of ``fn()``: CUDA events around ``reps``
    back-to-back calls, divided by ``reps``. The calls are queued behind a
    spin kernel that outlasts their host work, so the window holds only what
    the device runs (every kernel of the call: for conv3d the weight pack
    too). Returns ``(ms, hidden)``; ``hidden`` is false when the host took
    longer to queue the calls than the spin lasted."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3  # the host's part: it does not wait
    torch.cuda.synchronize()
    s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    t0 = time.perf_counter()
    s.record()
    _spin(2.0 + 2.0 * reps * host_ms)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    b.synchronize()
    return a.elapsed_time(b) / reps, queued_ms < s.elapsed_time(a)


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        sys.exit(2)
    if not (REPO / "biapy_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no biapy_tpu_torch package beside {__file__}", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(REPO))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}, "
          f"count {torch.cuda.device_count()}")
    # the plain versions and library yardsticks run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi, name


def phase_build():
    from biapy_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.lib()
    secs = time.perf_counter() - t0
    print(f"[build] kernels ready in {secs:.1f} s (cached: {build.BUILD_INFO.get('cached')})")
    # ptxas -v: registers and spills of every kernel go to the JSON; the
    # console gets the tensor-core conv's instances and any kernel that spills
    ptxas = []
    for ln in str(build.BUILD_INFO.get("log", "")).splitlines():
        if "Compiling entry" in ln:
            fn = ln.split("'")[1]
            tc = re.search(r"wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", fn)
            fn = ("conv3d_k3_wgmma_kernel<BN={}, KC={}, MINB={}, NWG={}>".format(*tc.groups())
                  if tc else fn)
            ptxas.append(dict(kernel=fn, spill_bytes=0, registers=None))
        elif ptxas and "spill stores" in ln:
            ptxas[-1]["spill_bytes"] = sum(int(v) for v in re.findall(r"(\d+) bytes spill", ln))
        elif ptxas and "registers" in ln:
            ptxas[-1]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    for k in ptxas:
        if "wgmma" in k["kernel"] or k["spill_bytes"]:
            print(f"[build] {k['kernel'][:100]}: {k['registers']} registers, "
                  f"{k['spill_bytes']} bytes of spills")
    # ptxas's performance warnings (C7520: wgmma serialized), which no
    # kernel should have
    losses = [ln for ln in str(build.BUILD_INFO.get("log", "")).splitlines()
              if "Potential Performance Loss" in ln]
    print(f"[build] ptxas performance warnings: {len(losses)}"
          + "".join(f"\n[build]   {ln.strip()[:200]}" for ln in losses[:4]))
    return secs, ptxas


def _check(got, ref, tol):
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    ok = err <= tol * scale
    return err, err / scale, ok


def _dt_name(dt):
    return str(dt).split(".")[-1]


class _Rows:
    """Collects one row per (kernel, dtype, shape): the check against the
    plain version, the device-side times of the kernel, its plain version and
    the library call (``device_ms``), and the call times of the kernel and
    the library call (``time_ms``)."""

    def __init__(self, card):
        self.card = card
        self.rows = []
        self.failures = []

    def add(self, kernel, dt, shape, got, ref, tol, fn, plain_fn, lib_fn, lib_name, nbytes,
            flops=0, **extra):
        import torch

        torch.cuda.synchronize()
        if tol == 0.0:
            # bit-equal, NaN == NaN
            ok = bool(torch.equal(got.isnan(), ref.isnan())
                      and torch.equal(got.nan_to_num(), ref.nan_to_num()))
            err = (got.float().nan_to_num() - ref.float().nan_to_num()).abs().max().item()
            rel = err
        else:
            err, rel, ok = _check(got, ref, tol)
        ms, hidden = device_ms(fn)
        call_ms = time_ms(fn)
        plain_ms, plain_hidden = device_ms(plain_fn)
        lib_ms = lib_call_ms = None
        lib_hidden = True
        if lib_fn is not None:
            lib_ms, lib_hidden = device_ms(lib_fn)
            lib_call_ms = time_ms(lib_fn)
        b_ms, b_by = bound(flops, nbytes, _dt_name(dt), self.card, extra.get("route"))
        row = dict(kernel=kernel, dtype=_dt_name(dt), shape=list(shape), max_abs_err=err,
                   max_rel_err=rel, tol=tol, ok=ok, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                   library_ms=lib_ms, library_call_ms=lib_call_ms, bound_ms=b_ms, bound_by=b_by,
                   gbps=nbytes / ms / 1e6, host_hidden=hidden and plain_hidden and lib_hidden,
                   **extra)
        if flops:
            row["tflops"] = flops / ms / 1e9
        self.rows.append(row)
        rate = f"{row['tflops']:.1f} TFLOP/s" if flops else f"{row['gbps']:.0f} GB/s"
        lib = (f"{lib_name} {lib_ms:.3f} ms (call {lib_call_ms:.3f})" if lib_ms is not None
               else "no library call")
        tag = " ".join(f"{k}={v}" for k, v in extra.items())
        print(f"[kernels] {kernel} {row['dtype']:8s} {tuple(shape)} {tag}: err {err:.3g} "
              f"(tol {tol}) {'ok' if ok else 'FAIL'} | kernel {ms:.3f} ms ({rate}; call "
              f"{call_ms:.3f}), plain {plain_ms:.3f} ms, {lib}, bound {b_ms:.3f} ms ({b_by})"
              + ("" if row["host_hidden"] else " [host not hidden]"))
        if not ok:
            self.failures.append(row)


# odd conv3d shapes, (N, D, H, W), Cin, Cout, on every route: in bf16 the
# tensor cores take bricks that overhang the volume, two images (the seam),
# channel tails (Cin 16 and 48: a 16-channel step; 24 and 5: zeros from TMA),
# x's channels padded to 8 (Cin 28, 36 with a tail step, 84, 5), tiles of
# Cout_p (8, 16, 32, 40) wider than Cout (1, 12, 28, 36: 2- and 8-byte
# stores), a loop over output tiles (264), and ragged volumes with bricks
# enough for the kernel's taller (16 x 16) brick (Cin 48, 28 and 36); the
# stem kernel takes Cin 3 and 1 (Cout 28, 36: two channel chunks, 1) in both
# dtypes; float32 at Cin >= 4 takes the 3xTF32 kernel (32-channel chunks
# at Cin 28 and 32, 16-channel ones elsewhere, an 8-channel tail step at
# Cin 24, 36 and 84 and alone at Cin 5, whose x it pads to 8 channels; a
# loop over 128-wide output tiles at Cout 264; 16- and 4-byte stores)
ODD_CONVS = [((2, 13, 7, 9), 24, 40), ((2, 13, 7, 9), 32, 40), ((2, 13, 7, 9), 48, 32),
             ((2, 13, 7, 9), 64, 264), ((2, 3, 19, 35), 16, 8), ((2, 40, 30, 35), 48, 40),
             ((2, 13, 7, 9), 28, 36), ((2, 13, 7, 9), 36, 28), ((2, 5, 21, 19), 84, 12),
             ((2, 13, 7, 9), 28, 1), ((2, 6, 11, 13), 5, 12), ((2, 40, 30, 35), 28, 28),
             ((2, 40, 30, 35), 36, 36), ((2, 9, 11, 13), 3, 28), ((2, 7, 10, 33), 1, 36),
             ((1, 4, 5, 6), 1, 1)]
# the CUDA cores' float32 peak: no FMA kernel can pass it, in bf16 or (the
# 3xTF32 route's effective rate, a float32 conv's flops) in float32
TENSOR_CORE_PROOF_TFLOPS = 67.0


def _template_conv_rows():
    """The 3D templates' 14 forward convs and 13 input gradients (all but
    the stem's: the same kernel with Cin and Cout swapped) at batch 2 and
    depth 40, as ((N, D, H, W), Cin, Cout) in network order."""
    vol = [((TEMPLATE_BATCH, TEMPLATE_DEPTH, s, s), cin, cout) for s, cin, cout in TEMPLATE_CONVS]
    return vol, [(v, cout, cin) for v, cin, cout in vol[1:]]


# the Cout of the restoration templates' unet 16/32/64 3x3x3 convs, in
# UNET_CONVS' order
UNET_COUTS = [16, 16, 32, 32, 64, 64, 32, 32, 16, 16]


def _sr_conv_rows():
    """The 3D super-resolution template's 10 forward convs and 9 input
    gradients (unet 16/32/64, Z_DOWN 2, 8 x 128 x 128 LR patches at batch
    4), as ((N, D, H, W), Cin, Cout) in network order: a template that
    trains and predicts in float32 (TEST.REDUCE_MEMORY off)."""
    b, d, h, w = 4, 8, 128, 128
    fwd = [((b, d >> lv, h >> lv, w >> lv), cin, cout)
           for (lv, cin), cout in zip(UNET_CONVS, UNET_COUTS)]
    return fwd, [(v, cout, cin) for v, cin, cout in fwd[1:]]


# phase 14 (c): the 3D super-resolution template with its comment's
# alternatives, rcan (MODEL.RCAN_* defaults: 16 filters, 10 groups of 20
# RCABs) and dfcan (64 filters, 4 groups of 4 FCABs), at UPSCALING (2, 2, 2),
# full width and depth, at the template's batch and 8 x 128 x 128 LR patch
SR3D_FILTERS = {"rcan": 16, "dfcan": 64}
SR3D_BATCH, SR3D_PATCH = 4, (8, 128, 128)


def _sr3d_rows(arch):
    """``arch``'s 3x3x3 convs at phase 14 (c)'s batch and patch, each shape
    once, as ((N, D, H, W), Cin, Cout): the stem, the body, the up-sampling
    conv (to 8 x the filters) on the LR grid and the output conv on the HR
    grid (twice the LR on every axis); their input gradients (all but the
    stem's: the same kernel with Cin and Cout swapped); and the weight
    gradients' zcats (kz 3) of each conv's input, (N x D, H, W, Cin)."""
    f, b = SR3D_FILTERS[arch], SR3D_BATCH
    lr, hr = (b,) + SR3D_PATCH, (b,) + tuple(2 * n for n in SR3D_PATCH)
    fwd = [(lr, 1, f), (lr, f, f), (lr, f, 8 * f), (hr, f, 1)]
    dx = [(v, cout, cin) for v, cin, cout in fwd[1:]]
    zcats = [((v[0] * v[1],) + v[2:] + (cin,), 3, v[1]) for v, cin, _ in fwd]
    return fwd, dx, zcats


def _sr3d_step_counts(arch):
    """How many of each of ``_sr3d_rows``' forward convs a forward runs:
    one stem, up-sampling and output conv, and the body's ``10 x (20 x 2 +
    1) + 1`` (rcan) or ``4 x 4 x 3`` (dfcan) convs."""
    body = 10 * (20 * 2 + 1) + 1 if arch == "rcan" else 4 * 4 * 3
    return [1, body, 1, 1]


def _template_conv_sums(rows):
    """Prints the templates' bf16 forward sum and forward-plus-dx sum
    against ``F.conv3d``'s and the bound, which of their rows and of the
    stems' (``STEM_CONVS``) took longer than ``F.conv3d``, the sums of
    each route's rows, and which float32 rows of the main path, the
    templates and the super-resolution template took longer than
    ``F.conv3d``; returns the sums."""
    def pick(shapes):
        return [next(r for r in rows if r["kernel"] == "conv3d" and r["dtype"] == "bfloat16"
                     and r["shape"] == list(v) + [cin] and r["cout"] == cout)
                for v, cin, cout in shapes]

    fwd, dx = _template_conv_rows()
    sums = {}
    for what, picked in (("forward", pick(fwd)), ("forward_dx", pick(fwd + dx))):
        sums[what] = {k: sum(r.get(k, 0.0) for r in picked)
                      for k in ("ms", "library_ms", "bound_ms", "pad_ms")}
        print(f"[kernels] conv3d templates' bf16 {what} ({len(picked)} convs) at 2 x 40 x "
              f"128^2: {sums[what]['ms']:.3f} ms (the channel pads {sums[what]['pad_ms']:.3f} "
              f"of it), F.conv3d {sums[what]['library_ms']:.3f} ms, bound "
              f"{sums[what]['bound_ms']:.3f} ms")
    slower = sorted({(tuple(r["shape"]), r["cout"], round(r["ms"], 4), round(r["library_ms"], 4))
                     for r in pick(fwd + dx + STEM_CONVS) if r["ms"] > r["library_ms"]})
    print(f"[kernels] conv3d templates' and stems' bf16 rows slower than F.conv3d (shape, "
          f"Cout, ms, F.conv3d ms): {slower if slower else 'none'}")
    # conv3d by route: the tensor cores at widths on the 8 grid (the main
    # path's 9 forward convs after the stem, a 128^3 serving patch), off it
    # (the templates' forward and dx convs with Cin or Cout that 8 does not
    # divide), the stems, and the 3xTF32 kernel in float32 (the same 9, their
    # 9 input gradients, the templates' 13 forward convs after the stem and
    # 13 input gradients, and the super-resolution template's 9 and 9)
    main9 = [((1, s, s, s), cin, cout) for s, cin, cout in MAIN_CONVS[1:]]
    main_dx = [((1, s, s, s), cin, cout) for s, cin, cout in DX_CONVS]
    sr_fwd, sr_dx = _sr_conv_rows()
    groups = (("wgmma on the grid, bf16", "bfloat16", main9),
              ("wgmma off the grid, bf16", "bfloat16",
               [r for r in fwd[1:] + dx if r[1] % 8 or r[2] % 8]),
              ("stem, bf16", "bfloat16", STEM_CONVS),
              ("tf32x3, float32", "float32", main9),
              ("tf32x3 main dx, float32", "float32", main_dx),
              ("tf32x3 templates, float32", "float32", fwd[1:] + dx),
              ("tf32x3 super-resolution, float32", "float32", sr_fwd[1:] + sr_dx))
    for what, dt, shapes in groups:
        picked = [next(r for r in rows if r["kernel"] == "conv3d" and r["dtype"] == dt
                       and r["shape"] == list(v) + [cin] and r["cout"] == cout)
                  for v, cin, cout in shapes]
        tot = {k: sum(r.get(k, 0.0) for r in picked)
               for k in ("ms", "pad_ms", "split_ms", "plain_ms", "library_ms", "bound_ms")}
        sums[what] = tot
        print(f"[kernels] conv3d route {what}: {len(picked)} rows, {tot['ms']:.3f} ms (the "
              f"channel pads {tot['pad_ms']:.3f} and the TF32 splits {tot['split_ms']:.3f} of "
              f"it), plain "
              f"{tot['plain_ms']:.3f} ms, F.conv3d {tot['library_ms']:.3f} ms, bound "
              f"{tot['bound_ms']:.3f} ms ({', '.join(sorted({r['route'] for r in picked}))})")
    # float32: the same rows against F.conv3d in float32 with TF32 off
    f32 = [next(r for r in rows if r["kernel"] == "conv3d" and r["dtype"] == "float32"
                and r["shape"] == list(v) + [cin] and r["cout"] == cout)
           for v, cin, cout in dict.fromkeys(main9 + main_dx + fwd + dx + sr_fwd + sr_dx)]
    slower = sorted({(tuple(r["shape"]), r["cout"], round(r["ms"], 4), round(r["library_ms"], 4))
                     for r in f32 if r["ms"] > r["library_ms"]})
    print(f"[kernels] conv3d float32 rows of the main path, the templates and super-resolution "
          f"slower than F.conv3d (shape, Cout, ms, F.conv3d ms): {slower if slower else 'none'}")
    return sums


def _sr3d_conv_report(rows):
    """Prints phase 14 (c)'s conv3d rows (rcan's and dfcan's forward convs
    and input gradients at the 3D super-resolution template's batch and
    patch) by dtype: each row's ms against ``F.conv3d``'s and its bound, the
    rows slower than ``F.conv3d`` or below half their bound, and the sums
    over one forward batch (each shape as many times as the model runs it)."""
    for arch in SR3D_FILTERS:
        fwd, dx, _ = _sr3d_rows(arch)
        for dt in ("bfloat16", "float32"):
            picked = [(next(r for r in rows if r["kernel"] == "conv3d" and r["dtype"] == dt
                            and r["shape"] == list(v) + [cin] and r["cout"] == cout), v, cin, cout)
                      for v, cin, cout in fwd + dx]
            print(f"[kernels] conv3d {arch} 3D x2 {dt} (shape, Cin -> Cout: ms, F.conv3d ms, "
                  "bound ms, route): " + "; ".join(
                      f"{tuple(v)} {cin}->{cout}: {r['ms']:.3f}, {r['library_ms']:.3f}, "
                      f"{r['bound_ms']:.3f}, {r['route']}" for r, v, cin, cout in picked))
            slow = [(tuple(v), cin, cout) for r, v, cin, cout in picked
                    if r["ms"] > r["library_ms"] or r["ms"] > 2 * r["bound_ms"]]
            counts = _sr3d_step_counts(arch)
            tot = {k: sum(n * r[k] for n, (r, *_) in zip(counts, picked[:len(fwd)]))
                   for k in ("ms", "library_ms", "bound_ms")}
            print(f"[kernels] conv3d {arch} 3D x2 {dt}: one forward batch ({sum(counts)} convs) "
                  f"{tot['ms']:.3f} ms, F.conv3d {tot['library_ms']:.3f} ms, bound "
                  f"{tot['bound_ms']:.3f} ms; rows slower than F.conv3d or below half their "
                  f"bound: {slow if slow else 'none'}")


def _pad_row(out, x):
    """The channel pad (``pad_channels``) of bf16 ``x`` against ``F.pad``,
    bit-equal with the zero lanes: the block the pad's output takes is
    filled with NaN first (the allocator hands a freed block of that size
    back), so a lane the kernel left unwritten shows. Bound by its bytes,
    x read once and the padded copy written once. Returns its ms."""
    import torch
    import torch.nn.functional as F

    from biapy_tpu_torch.ops.kernels.conv3d import pad_channels

    c = x.shape[-1]
    cp = -(-c // 8) * 8
    poison = torch.full(x.shape[:-1] + (cp,), float("nan"), dtype=x.dtype, device=x.device)
    del poison
    got = pad_channels(x)
    out.add("pad_channels", x.dtype, tuple(x.shape), got, F.pad(x, (0, cp - c)), 0.0,
            lambda: pad_channels(x), lambda: F.pad(x, (0, cp - c)),
            lambda: F.pad(x, (0, cp - c)), "F.pad",
            nbytes=(x.numel() + got.numel()) * x.element_size(), cp=cp)
    return out.rows[-1]["ms"]


def _split_row(out, x):
    """The 3xTF32 route's split of float32 ``x`` (``split_x``) against
    ``tf32_split`` and ``F.pad``, bit-equal with the zero lanes, over
    NaN-filled memory as for the pad. Bound by its bytes: x read once, the
    pair written once; no PyTorch call computes TF32's rounding. Returns its
    ms."""
    import torch
    import torch.nn.functional as F

    from biapy_tpu_torch.ops.kernels.conv3d import split_x, tf32_split

    c = x.shape[-1]
    cp = -(-c // 4) * 4
    poison = torch.full((2,) + x.shape[:-1] + (cp,), float("nan"), device=x.device)
    del poison
    got = torch.stack(split_x(x))

    def plain():
        return torch.stack([F.pad(t, (0, cp - c)) for t in tf32_split(x)])
    out.add("tf32_split", x.dtype, tuple(x.shape), got, plain(), 0.0, lambda: split_x(x), plain,
            None, None, nbytes=(x.numel() + got.numel()) * 4, cp=cp)
    return out.rows[-1]["ms"]


def conv_rows(out, rand, g, dev, classification_only=False):
    """conv3d against its plain version: every main-path forward and dx shape
    and the odd shapes, the classification template's and the 3D templates'
    forward and dx convs, in both dtypes, the U-Net variants' (whose runs
    train and serve in bf16) in bf16 and the super-resolution template's
    (which runs in float32) in float32; each row with the route it took.
    ``classification_only``: the classification template's and the
    variants' rows alone."""
    import torch
    import torch.nn.functional as F

    from biapy_tpu_torch.ops.kernels.conv3d import conv3d_fwd, conv3d_plain, conv3d_route

    # float32: both sides sum the same products in float32 in other orders;
    # bfloat16: both sum bf16 products in float32 and round once, so they
    # differ by at most about one bf16 ulp of the output (2^-8 relative)
    tols = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    shapes = [((1, s, s, s), cin, cout) for s, cin, cout in sorted(set(MAIN_CONVS + DX_CONVS))]
    cls_convs, cls_dx = _cls_rows()[:2]
    cls_shapes = list(dict.fromkeys(cls_convs + cls_dx))
    variant_shapes = [r for r in _variant_rows()[0] if r not in cls_shapes]
    tpl_fwd, tpl_dx = _template_conv_rows()
    tpl_shapes = [r for r in dict.fromkeys(tpl_fwd + tpl_dx)
                  if r not in cls_shapes and r not in variant_shapes]
    tpl32_shapes = [r for r in dict.fromkeys(tpl_fwd + tpl_dx) if r not in cls_shapes]
    sr_shapes = list(dict.fromkeys(sum(_sr_conv_rows(), [])))
    # phase 14 (c)'s rcan and dfcan: new widths in both dtypes
    sr3d_shapes = list(dict.fromkeys(row for arch in SR3D_FILTERS
                                     for row in sum(_sr3d_rows(arch)[:2], [])))
    pad_ms, split_ms = {}, {}  # x's shape -> its channel pad's, its TF32 split's ms
    for dt in (torch.bfloat16, torch.float32):
        todo = ([] if classification_only else shapes + ODD_CONVS) + cls_shapes
        if dt == torch.bfloat16:
            todo = todo + variant_shapes + ([] if classification_only else tpl_shapes)
        elif not classification_only:
            todo = todo + tpl32_shapes + sr_shapes
        if not classification_only:
            todo = todo + [r for r in sr3d_shapes if r not in todo]
        for vol, cin, cout in todo:
            shape = vol + (cin,)
            x = rand(shape, dt)
            w = (torch.randn((3, 3, 3, cin, cout), generator=g) / (27 * cin) ** 0.5).to(dev, dt)
            xc = x.permute(0, 4, 1, 2, 3)  # NCDHW view in channels_last_3d strides
            wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
            m = x.numel() // cin
            extra = dict(cout=cout, route=conv3d_route(dt, cin, cout))
            if extra["route"] == "wgmma" and cin % 8:
                # the channel-padded copy of x, a part of the row's time
                if shape not in pad_ms:
                    pad_ms[shape] = _pad_row(out, x)
                extra["pad_ms"] = pad_ms[shape]
            if extra["route"] == "tf32x3":
                # x's TF32 pair, a part of the row's time
                if shape not in split_ms:
                    split_ms[shape] = _split_row(out, x)
                extra["split_ms"] = split_ms[shape]
            out.add("conv3d", dt, shape, conv3d_fwd(x, w), conv3d_plain(x, w), tols[dt],
                    lambda: conv3d_fwd(x, w), lambda: conv3d_plain(x, w),
                    lambda: F.conv3d(xc, wc, padding=1), "F.conv3d",
                    nbytes=(x.numel() + w.numel() + m * cout) * x.element_size(),
                    flops=2 * 27 * cin * cout * m, **extra)
            del x, w, xc, wc
    if out.failures or classification_only:
        return
    _template_conv_sums(out.rows)
    _sr3d_conv_report(out.rows)
    main = [r for r in out.rows if r["kernel"] == "conv3d" and r["dtype"] == "bfloat16"
            and r["shape"][0] == 1]
    best = max(main, key=lambda r: r["tflops"])
    print(f"[kernels] conv3d fastest main-path bf16 row: {tuple(best['shape'])} -> {best['cout']} "
          f"at {best['tflops']:.1f} TFLOP/s (route {best['route']}); above "
          f"{TENSOR_CORE_PROOF_TFLOPS} only the tensor cores can have done it")
    if not best["tflops"] > TENSOR_CORE_PROOF_TFLOPS or best["route"] != "wgmma":
        raise AssertionError(f"no main-path bf16 conv3d row above {TENSOR_CORE_PROOF_TFLOPS} "
                             f"TFLOP/s: best {best}")
    # float32 (effective: the float32 conv's flops, not the three passes')
    main32 = sorted((r for r in out.rows if r["kernel"] == "conv3d" and r["dtype"] == "float32"
                     and r["shape"][0] == 1 and r["route"] == "tf32x3"),
                    key=lambda r: -r["tflops"])
    print(f"[kernels] conv3d main-path float32 rows, TFLOP/s (proof line "
          f"{TENSOR_CORE_PROOF_TFLOPS}): "
          + ", ".join(f"{tuple(r['shape'])}->{r['cout']} {r['tflops']:.1f}" for r in main32))
    if not main32[0]["tflops"] > TENSOR_CORE_PROOF_TFLOPS:
        raise AssertionError(f"no main-path float32 conv3d row above {TENSOR_CORE_PROOF_TFLOPS} "
                             f"TFLOP/s: best {main32[0]}")


def phase_kernels(card, conv3d_only=False, classification_only=False, twod_only=False):
    """Each kernel against its plain version at the main paths' shapes;
    ``classification_only``: the classification template's and the U-Net
    variants' rows alone; ``twod_only``: the 2D templates' pool and pool
    backward rows alone."""
    import torch
    import torch.nn.functional as F

    from biapy_tpu_torch.ops.kernels.shuffle import (
        pool_max_folded_bwd, pool_max_folded_bwd_plain, pool_max_folded_fwd,
        pool_max_folded_plain, zcat_bwd, zcat_bwd_plain, zcat_fwd, zcat_plain, zd2s_fwd,
        zd2s_plain, zs2d, zs2d_plain)

    dev = torch.device(DEVICE)
    g = torch.Generator(device="cpu").manual_seed(0)
    out = _Rows(card)

    def rand(shape, dt):
        return torch.randn(shape, generator=g).to(dev, dt)

    if not twod_only:
        conv_rows(out, rand, g, dev, classification_only)
    if out.failures:
        raise AssertionError(f"{len(out.failures)} conv3d and channel-pad checks failed: "
                             f"{out.failures}")
    if conv3d_only:
        return out.rows

    # odd, with ties, a NaN and a -0: ragged, c = 5, window 3x2x1; 28
    # channels under a 3x2x2 window (the rows16 route in bf16); the
    # templates' three pools at batch 2, at depth 40 and at the detection
    # template's 20 (the first of these also the 40-deep template at batch 1);
    # the denoising, super-resolution and image-to-image templates' two pools
    # the classification template's two pools; the U-Net variants run the
    # semantic template's three (TEMPLATE_POOLS)
    _, _, cls_pools, cls_zcat5, cls_zcat3 = _cls_rows()
    # the 2D templates' pools: (batch, y, x, C) with window 1 x 2 x 2, held
    # against F.max_pool2d as the library call
    twod = list(dict.fromkeys(row for rows_at in TWOD_POOLS.values() for row in rows_at))
    pools = ([] if classification_only or twod_only else
             MAIN_POOLS + [((6, 10, 14, 5), (3, 2, 1)), ((6, 10, 12, 28), (3, 2, 2))]
             + TEMPLATE_POOLS + DETECTION_POOLS
             + [row for pools_at, _, _ in RESTORATION_ROWS.values() for row in pools_at])
    pools += ([] if twod_only else cls_pools) + ([] if classification_only else twod)
    for dt in (torch.bfloat16, torch.float32):
        item = torch.empty((), dtype=dt).element_size()
        for shape, win in pools:
            flat = (shape, win) in twod
            x = rand(shape, dt)
            if shape[0] == 6 and not flat:
                # few distinct values: tied windows, a NaN and a -0 among them
                x = (x * 2).round() / 2
                x.view(-1)[7] = float("nan")
                x.view(-1)[11] = -0.0
            y = pool_max_folded_plain(x, win)
            if flat:  # NCHW views in channels-last strides
                xl, lwin = x.permute(0, 3, 1, 2), win[1:]
                pool_lib, lib_name = F.max_pool2d, "F.max_pool2d"
                bwd_lib, bwd_name = torch.ops.aten.max_pool2d_with_indices_backward, \
                    "max_pool2d backward"
            else:
                xl, lwin = x.view(1, *shape).permute(0, 4, 1, 2, 3), win
                pool_lib, lib_name = F.max_pool3d, "F.max_pool3d"
                bwd_lib, bwd_name = torch.ops.aten.max_pool3d_with_indices_backward, \
                    "max_pool3d backward"
            tag = dict(win=win, ndim=2) if flat else dict(win=win)
            out.add("pool_max_folded", dt, shape, pool_max_folded_fwd(x, win), y, 0.0,
                    lambda: pool_max_folded_fwd(x, win), lambda: pool_max_folded_plain(x, win),
                    lambda: pool_lib(xl, lwin, stride=lwin), lib_name,
                    nbytes=(x.numel() + y.numel()) * item, **tag)
            gy = rand(y.shape, dt)
            gl = (gy.permute(0, 3, 1, 2) if flat
                  else gy.view(1, *gy.shape).permute(0, 4, 1, 2, 3))
            _, idx = pool_lib(xl, lwin, stride=lwin, return_indices=True)
            zeros, ones = (0,) * len(lwin), (1,) * len(lwin)
            out.add("pool_max_folded_bwd", dt, shape, pool_max_folded_bwd(x, y, gy, win),
                    pool_max_folded_bwd_plain(x, y, gy, win), 0.0,
                    lambda: pool_max_folded_bwd(x, y, gy, win),
                    lambda: pool_max_folded_bwd_plain(x, y, gy, win),
                    # one argmax per window instead of every tied slot: the same
                    # function only where no window ties
                    lambda: bwd_lib(gl, xl, lwin, lwin, zeros, ones, False, idx),
                    bwd_name, nbytes=2 * (x.numel() + y.numel()) * item, **tag)
            del x, y, gy, xl, gl, idx
    if twod_only:
        torch.cuda.empty_cache()
        if out.failures:
            raise AssertionError(f"{len(out.failures)} kernel checks failed: {out.failures}")
        return out.rows
    for dt in (torch.bfloat16, torch.float32):
        item = torch.empty((), dtype=dt).element_size()

        # the bench's, the restoration templates' and an odd one (ragged, c =
        # 3, sz = 3)
        for shape, sz in ([] if classification_only else
                          MAIN_ZD2S + [row for _, zd2s, _ in RESTORATION_ROWS.values()
                                       for row in zd2s] + [((3, 5, 7, 9), 3)]):
            x = rand(shape, dt)
            r, h, w, szc = shape
            out.add("zd2s", dt, shape, zd2s_fwd(x, sz), zd2s_plain(x, sz), 0.0,
                    lambda: zd2s_fwd(x, sz), lambda: zd2s_plain(x, sz),
                    lambda: x.reshape(r, h, w, sz, szc // sz).permute(0, 3, 1, 2, 4).contiguous(),
                    "permute().contiguous()", nbytes=2 * x.numel() * item, sz=sz)
            gy = zd2s_plain(x, sz)  # zs2d's input has zd2s's output shape
            out.add("zs2d", dt, gy.shape, zs2d(gy, sz), zs2d_plain(gy, sz), 0.0,
                    lambda: zs2d(gy, sz), lambda: zs2d_plain(gy, sz),
                    lambda: gy.reshape(r, sz, h, w, szc // sz).permute(0, 2, 3, 1, 4).contiguous(),
                    "permute().contiguous()", nbytes=2 * x.numel() * item, sz=sz)
            del x, gy

        # zcat: the dw operand of every 3x3x3 conv (kz = 3), the LARGER_IO
        # 5x5x5 convs (kz = 5), batch 2 (depth = rows / 2), an odd shape, the
        # templates' at batch 2 (depth 40 and the detection template's 20),
        # the restoration templates' at their own batch and depths, the
        # classification template's (its two 5x5x5 convs at kz 5 and its four
        # 3x3x3 convs' weight gradients) and the U-Net variants' new ones
        zcats = ([] if classification_only else
                 [((s, s, s, cin), 3, None) for s, cin in sorted({(s, c) for s, c, _ in MAIN_CONVS})]
                 + [(shape, kz, None) for shape, kz in LARGER_IO_ZCATS]
                 + [((128, 64, 64, 64), 3, 64), ((6, 5, 7, 1), 5, 3)]
                 + [((TEMPLATE_BATCH * depth, s, s, cin), 3, depth)
                    for depth in (TEMPLATE_DEPTH, DETECTION_DEPTH)
                    for s, cin in sorted({(s, c) for s, c, _ in TEMPLATE_CONVS})]
                 + list(dict.fromkeys(row for _, _, zc in RESTORATION_ROWS.values()
                                      for row in zc)))
        template_zcats = {((TEMPLATE_BATCH * TEMPLATE_DEPTH, s, s, cin), 3, TEMPLATE_DEPTH)
                          for s, cin, _ in TEMPLATE_CONVS}
        zcats += cls_zcat5 + cls_zcat3 + [r for r in _variant_rows()[1]
                                          if r not in template_zcats]
        if not classification_only:
            # phase 14 (c)'s weight-gradient zcats: rcan's and dfcan's convs
            zcats += [r for r in dict.fromkeys(row for arch in SR3D_FILTERS
                                               for row in _sr3d_rows(arch)[2])
                      if r not in zcats]
        for shape, kz, depth in zcats:
            x = rand(shape, dt)
            hz = kz // 2
            d = shape[0] if depth is None else depth
            # each image padded in z on its own; (images, z, h * w, c): torch.cat
            # keeps its batched copy for up to four dimensions
            xp = F.pad(x.view(shape[0] // d, d, shape[1] * shape[2], shape[3]),
                       (0, 0, 0, 0, hz, hz))
            taps = [xp[:, t:t + d] for t in range(kz)]
            out.add("zcat", dt, shape, zcat_fwd(x, kz, depth), zcat_plain(x, kz, depth), 0.0,
                    lambda: zcat_fwd(x, kz, depth), lambda: zcat_plain(x, kz, depth),
                    # the concatenation alone, of views of an already padded copy
                    lambda: torch.cat(taps, dim=-1), "torch.cat",
                    nbytes=(1 + kz) * x.numel() * item, kz=kz, depth=depth)
            del x, xp, taps
        # zcat backward: the LARGER_IO out-block conv's input gradient, the
        # classification template's two 5x5x5 convs' and the odd shapes;
        # float32 sums of up to kz terms in tap order
        for shape, kz, depth in ([] if classification_only else
                                 [ZCAT_BWD_MAIN + (None,), ((128, 64, 64, 64), 3, 64),
                                  ((6, 5, 7, 1), 5, 3), ((6, 5, 7, 24), 3, None)]) + cls_zcat5:
            gy = rand(shape[:3] + (kz * shape[3],), dt)
            out.add("zcat_bwd", dt, shape, zcat_bwd(gy, kz, depth), zcat_bwd_plain(gy, kz, depth),
                    1e-6 if dt == torch.float32 else 2 ** -8,
                    lambda: zcat_bwd(gy, kz, depth), lambda: zcat_bwd_plain(gy, kz, depth),
                    None, "", nbytes=(1 + kz) * gy.numel() // kz * item, kz=kz, depth=depth)
            del gy
    torch.cuda.empty_cache()
    if out.failures:
        raise AssertionError(f"{len(out.failures)} kernel checks failed: {out.failures}")
    return out.rows


def _main_cfg():
    """The bench's job (bench.py build()): resunet 32/64/128, BatchNorm, ELU,
    128^3 patches, halo 10, overlap 0, bf16 (REDUCE_MEMORY), uint8 drain."""
    return {
        "PROBLEM": {"TYPE": "SEMANTIC_SEG", "NDIM": "3D"},
        "MODEL": {"ARCHITECTURE": "resunet", "FEATURE_MAPS": [32, 64, 128],
                  "DROPOUT_VALUES": [0.0, 0.0, 0.0], "Z_DOWN": [2, 2, 2],
                  "YX_DOWN": [2, 2, 2], "CONV_LAYERS": [2, 2, 2],
                  "NORMALIZATION": "bn", "ACTIVATION": "elu"},
        "DATA": {"PATCH_SIZE": [128, 128, 128, 1],
                 "TEST": {"PADDING": [10, 10, 10], "OVERLAP": [0.0, 0.0, 0.0]}},
        "TRAIN": {"ENABLE": True, "BATCH_SIZE": 1},
        "TEST": {"ENABLE": True, "REDUCE_MEMORY": True, "OUTPUT_QUANT_UINT8": True},
    }


def _random_bn_stats(model, seed):
    """Seeded, non-trivial BatchNorm running statistics (the weights come
    from the model's own seeded initialisation)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            vals = torch.rand(buf.shape, generator=g)
            buf.copy_(vals * 0.4 - 0.2 if name.endswith("mean") else vals + 0.5)


# The CPU sides of the card-vs-CPU checks of phases 11 c-17 (plain convs
# over whole crops, training steps) run in one child process, one after another,
# while the card goes on with the later phases. Each such check submits its
# CPU side, runs its card side at once and leaves a function that compares
# the two (its line, its assertion); the run calls those functions, in
# order, after its last phase (``_finish_cpu_sides``).
CPU_SIDE_THREADS = 4  # the child's torch threads, of the card machine's 8 cores
_CPU_SIDE = {"proc": None, "n": 0, "done": set(), "pending": []}
CPU_SIDE_RESULTS = OUT_DIR / "chip_smoke_cpu_side" / "results"  # the child's jobs' result_dir


def _cpu_side_worker():
    """The child's loop: on each line of stdin the path of a pickled
    ``(function name, kwargs)``; the function's value (or its traceback)
    pickled to the path with suffix ``.out``, then the path printed on
    stdout. The work's own prints go to stderr."""
    import pickle
    import traceback

    import torch

    torch.set_num_threads(CPU_SIDE_THREADS)
    sys.path.insert(0, str(REPO))
    reply, sys.stdout = sys.stdout, sys.stderr
    for line in sys.stdin:
        path = Path(line.strip())
        fn, kwargs = pickle.loads(path.read_bytes())
        try:
            out = ("ok", globals()[fn](**kwargs))
        except BaseException:  # noqa: BLE001 -- handed to the parent, which raises
            out = ("error", traceback.format_exc())
        path.with_suffix(".out").write_bytes(pickle.dumps(out))
        print(path, file=reply, flush=True)


def _stop_cpu_side():
    proc = _CPU_SIDE["proc"]
    if proc is None:
        return
    _CPU_SIDE["proc"] = None
    try:
        proc.stdin.close()
        proc.wait(timeout=30)
    except Exception:  # noqa: BLE001 -- a child that does not stop is killed
        proc.kill()
        proc.wait()


def _cpu_side(fn, **kwargs):
    """Queue ``fn(**kwargs)`` (a function of this script) on the CPU-side
    child, started on first use; returns a function that waits for its
    value and returns it (raising the child's error)."""
    import atexit
    import pickle

    if _CPU_SIDE["proc"] is None:
        _CPU_SIDE["proc"] = subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
             "import chip_smoke; chip_smoke._cpu_side_worker()", str(REPO)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=str(REPO))
        atexit.register(_stop_cpu_side)
    work = OUT_DIR / "chip_smoke_cpu_side"
    work.mkdir(parents=True, exist_ok=True)
    _CPU_SIDE["n"] += 1
    path = work / f"{_CPU_SIDE['n']:03d}_{fn}.pkl"
    path.write_bytes(pickle.dumps((fn, kwargs)))
    proc = _CPU_SIDE["proc"]
    proc.stdin.write(f"{path}\n")
    proc.stdin.flush()

    def wait():
        while str(path) not in _CPU_SIDE["done"]:
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError(f"the CPU-side child ended (rc {proc.poll()}) before {path}")
            _CPU_SIDE["done"].add(line.strip())
        status, value = pickle.loads(path.with_suffix(".out").read_bytes())
        path.unlink()
        path.with_suffix(".out").unlink()
        if status != "ok":
            raise RuntimeError(f"CPU side {fn} failed in the child:\n{value}")
        return value
    return wait


def _cpu_ckpt(c):
    """The job config ``c`` with its checkpoint (if any) copied beside the
    CPU-side child's work: the phase that wrote it may delete it before the
    child reads it."""
    import copy
    import shutil

    ckpt = c.get("PATHS", {}).get("CHECKPOINT_FILE")
    if not ckpt:
        return c
    work = OUT_DIR / "chip_smoke_cpu_side"
    work.mkdir(parents=True, exist_ok=True)
    _CPU_SIDE["n"] += 1
    dst = work / f"{_CPU_SIDE['n']:03d}_{Path(ckpt).name}"
    shutil.copyfile(ckpt, dst)
    c = copy.deepcopy(c)
    c["PATHS"] = dict(c["PATHS"], CHECKPOINT_FILE=str(dst))
    return c


def _finish_cpu_sides():
    """Finish every check whose CPU side ran in the child, in the order they
    were submitted, then stop the child; a check that fails is printed and
    the others still run, and the call then raises naming every failure.
    Returns the seconds spent here (the wait for the child included)."""
    import shutil

    t0 = time.perf_counter()
    failed = []
    try:
        while _CPU_SIDE["pending"]:
            try:
                _CPU_SIDE["pending"].pop(0)()
            except Exception as e:  # noqa: BLE001 -- raised below, with the others
                print(f"[cpu-sides] FAIL: {type(e).__name__}: {e}")
                failed.append(e)
    finally:
        _stop_cpu_side()
        shutil.rmtree(OUT_DIR / "chip_smoke_cpu_side", ignore_errors=True)
    if failed:
        raise AssertionError(f"{len(failed)} card-vs-CPU checks failed: "
                             + "; ".join(f"{type(e).__name__}: {e}" for e in failed))
    return time.perf_counter() - t0


def _cpu_predict(cfg, vol, result_dir, name, check_data_paths=True, bn_seed=None,
                 points=False):
    """``BiaPy(cfg, device="cpu").predict(vol)`` (the CPU side of a check, run
    in the child): the predictions' arrays, strings and numbers by role and
    the seconds of the call. ``bn_seed``: the model built from its seeded
    initialisation with ``_random_bn_stats(seed)`` first; ``points``: also the
    detection workflow's candidate points of the raw prediction."""
    import numpy as np

    from biapy_tpu_torch import BiaPy

    job = BiaPy(cfg, result_dir=result_dir, name=name, silent=True,
                check_data_paths=check_data_paths, device="cpu")
    if bn_seed is not None:
        job._build_workflow()
        job.workflow.prepare_model()
        _random_bn_stats(job.workflow.model, seed=bn_seed)
    t0 = time.perf_counter()
    preds = job.predict(vol)
    out = dict(seconds=time.perf_counter() - t0, preds=[
        {k: v for k, v in p.items()
         if isinstance(v, (np.ndarray, np.generic, str, int, float, list, tuple))}
        for p in preds])
    if points:
        heat = np.asarray(next(p for p in preds if p["role"] == "raw")["pred"], np.float32)
        out["candidates"] = job.workflow._extract_points(heat, global_post=False)
    return out


def phase_main_path():
    import numpy as np
    import torch

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.ops.kernels import build

    job = BiaPy(_main_cfg(), result_dir=str(OUT_DIR), name="chip_smoke", silent=True,
                check_data_paths=False)
    job._build_workflow()
    job.workflow.prepare_model()
    _random_bn_stats(job.workflow.model, seed=0)
    n_params = sum(p.numel() for p in job.workflow.model.parameters())
    vol = np.random.default_rng(0).integers(0, 256, (216, 216, 216), dtype=np.uint8)
    n_patches = 8  # (216 / (128 - 2*10))^3

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    secs = []
    out = None
    for _ in range(3):
        t0 = time.perf_counter()
        out = job.predict(vol)[0]["pred"]  # returns host numpy: synchronised
        secs.append(time.perf_counter() - t0)
    launches = dict(build.LAUNCHES)
    routes = dict(build.CONV3D_ROUTES)
    peak = torch.cuda.max_memory_allocated()
    for k, per_patch in SERVE_LAUNCHES.items():
        if launches[k] != 3 * n_patches * per_patch:
            raise AssertionError(f"{k}: {launches[k]} launches in 3 predict calls, want "
                                 f"{3 * n_patches * per_patch} ({per_patch} per patch)")
    _check_launches(routes, SERVE_ROUTES, 3 * n_patches, "serving, conv3d routes", "patches")
    if out.shape != (216, 216, 216, 1):
        raise AssertionError(f"prediction shape {out.shape}")
    if not np.all(np.isfinite(out)) or not np.array_equal(out, np.round(out)):
        raise AssertionError("prediction is not finite uint8-valued")
    p = out / 255.0
    if p.min() < 0.0 or p.max() > 1.0:
        raise AssertionError(f"probabilities outside [0, 1]: {p.min()}..{p.max()}")
    steady = secs[1:]
    mvox = [216 ** 3 / s / 1e6 for s in steady]
    print(f"[main] resunet 32/64/128 ({n_params:,} params), 216^3 uint8, 8 patches of 128^3 "
          f"per call, bf16 + uint8 drain: call seconds {[round(s, 4) for s in secs]}")
    print(f"[main] calls 2-3: {[round(m, 3) for m in mvox]} Mvox/s, "
          f"{[round(s / n_patches, 4) for s in steady]} s/patch, peak memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}; conv3d routes {routes}; "
          f"p mean {p.mean():.4f}")

    # where the time goes: one more call under the profiler (not in the
    # numbers above), device time summed by kernel name
    prof_wall, dev_total, table, _ = _profile_device(lambda: job.predict(vol))
    print(f"[profile] one call: wall {prof_wall:.3f} s, device busy {dev_total / 1e3:.3f} s "
          f"({100 * dev_total / 1e3 / prof_wall:.1f}% of wall)")
    for key, ms, cnt in table[:12]:
        print(f"[profile] {ms:10.2f} ms  {cnt:5d}x  {key[:90]}")
    return dict(call_seconds=secs, mvox_per_s=mvox, s_per_patch=[s / n_patches for s in steady],
                peak_bytes=peak, launches=launches, conv3d_routes=routes, n_params=n_params,
                profile=dict(wall_s=prof_wall, device_ms=dev_total,
                             top=[dict(name=k, ms=m, count=c) for k, m, c in table[:40]]))


def _profile_device(fn):
    """Run ``fn`` (which ends synchronised) under torch.profiler. Returns the
    wall seconds, the device-busy ms, ``[(kernel name, ms, count)]`` sorted by
    time, and the device-side events ``[(start us, name, ms)]`` in launch
    order. Device-side events only (kernels, copies): a host op's device time
    repeats that of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    events = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            events.append((ev.time_range.start, ev.name, dev_us / 1e3))
    events.sort()
    by_name = {}
    for _, name, ms in events:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + ms, cnt + 1)
    table = sorted(((k, v[0], v[1]) for k, v in by_name.items()), key=lambda r: -r[1])
    return wall, sum(r[1] for r in table), table, events


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _train_job(name, larger_io=False):
    from biapy_tpu_torch import BiaPy

    cfg = _main_cfg()
    cfg["MODEL"]["LARGER_IO"] = larger_io
    job = BiaPy(cfg, result_dir=str(OUT_DIR), name=name, silent=True, check_data_paths=False)
    job._build_workflow()
    job.workflow.prepare_model()  # model + optimizer state, on the card
    return job


def _train_batch(b, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    x = rng.random((b, 128, 128, 128, 1), np.float32)
    y = (rng.random((b, 128, 128, 128, 1), np.float32) > 0.5).astype(np.float32)
    return {"x": torch.from_numpy(x).to(dev), "y": torch.from_numpy(y).to(dev)}


def _check_launches(got, per_step, steps, what, unit="steps"):
    for k, n in per_step.items():
        if got[k] != n * steps:
            raise AssertionError(f"{what}: {k} launched {got[k]} times in {steps} {unit}, want "
                                 f"{n} each")


def phase_train():
    """The bench's training step at full width: resunet 32/64/128 at 128^3,
    forward, loss, backward and the optimizer update under bf16 mixed
    precision, batch 1 then batch 2: two steps to settle, then at least six
    timed, ended by a host read of the loss."""
    import torch

    from biapy_tpu_torch.engine.train_engine import make_train_step, resolve_mixed_precision
    from biapy_tpu_torch.ops.kernels import build

    res = {"by_batch": {}}
    for b in (1, 2):
        job = _train_job(f"chip_smoke_train_b{b}")
        wf = job.workflow
        cfg = wf.cfg.TRAIN
        mixed = resolve_mixed_precision("auto", wf.device)
        step = make_train_step(wf.loss, wf.train_metrics, mixed_precision=mixed)
        batch = _train_batch(b, wf.device)
        gen = torch.Generator(device=wf.device).manual_seed(0)
        before = _snapshot(wf.model)
        state = wf.state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        losses = []
        for _ in range(2):  # settle (allocator warm-up, cuDNN's algorithm choice)
            state, m = step(state, batch, gen)
            losses.append(m["loss"])
        float(m["loss"])
        n_steps = max(6, 10 // b)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, m = step(state, batch, gen)
            losses.append(m["loss"])
        float(m["loss"])  # the host read ends the timed window
        secs = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        routes = dict(build.CONV3D_ROUTES)
        peak = torch.cuda.max_memory_allocated()
        losses = [float(v) for v in losses]
        _check_launches(launches, TRAIN_LAUNCHES, n_steps + 2, f"train b={b}")
        _check_launches(routes, TRAIN_ROUTES, n_steps + 2, f"train b={b}, conv3d routes")
        if not all(v == v and abs(v) != float("inf") for v in losses):
            raise AssertionError(f"train b={b}: non-finite loss in {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train b={b}: the loss did not fall: {losses}")
        if state.step != n_steps + 2 or float(state.optimizer.state["count"]) != n_steps + 2:
            raise AssertionError(f"train b={b}: step count {state.step}")
        after = _snapshot(wf.model)
        moved = {k: (after[k] - before[k]).abs().max().item() for k in before}
        # a conv bias that feeds a BatchNorm has a zero gradient (and, from a
        # zero start, no decay): it may stay
        stuck = [k for k, v in moved.items() if not v > 0 and not k.endswith("Conv_0.bias")]
        if stuck:
            raise AssertionError(f"train b={b}: unchanged weights or statistics: {stuck}")
        pps = n_steps * b / secs
        print(f"[train] b={b}: {cfg.OPTIMIZER[0]} lr {cfg.LR[0]} wd {cfg.W_DECAY}, mixed "
              f"precision {mixed}; {n_steps} steps in {secs:.3f} s: {secs / n_steps:.4f} s/step, "
              f"{pps:.3f} patches/s, peak memory {peak / 2**30:.2f} GiB")
        print(f"[train] b={b}: loss {losses[0]:.6f} -> {losses[-1]:.6f} over {len(losses)} "
              f"steps; launches {launches}; conv3d routes {routes}")
        res["by_batch"][b] = dict(steps=n_steps, seconds=secs, s_per_step=secs / n_steps,
                                  patches_per_s=pps, peak_bytes=peak, losses=losses,
                                  launches=launches, conv3d_routes=routes,
                                  optimizer=cfg.OPTIMIZER[0],
                                  mixed_precision=mixed)
        if b == 1:
            res["launches"] = launches
            res["profile"] = _profile_train_step(lambda: float(step(state, batch, gen)[1]["loss"]))
        del job, wf, state, batch, before, after
        torch.cuda.empty_cache()
    return res


def _profile_train_step(run):
    """One more step under the profiler: device time by kernel family. The
    first ten launches of the hand conv kernel in a step are the forward,
    the next nine the input gradients. The trace has lost a conv3d event on
    the card (one of 19, on one run), so the step is traced up to three times
    until it holds every one."""
    for attempt in range(1, 4):
        wall, dev_total, table, events = _profile_device(run)
        n_conv = sum("conv3d_k3_" in name for _, name, _ in events)
        if n_conv == TRAIN_LAUNCHES["conv3d"]:
            break
        if attempt == 3:
            raise AssertionError(f"profiled step: {n_conv} conv3d kernel events, want 19")
        print(f"[train-profile] {n_conv} conv3d kernel events, want 19 (trace {attempt}); "
              "profiling again")
    fam = {"hand conv forward": 0.0, "hand conv dx": 0.0, "library dw (cuDNN wgrad)": 0.0,
           "zcat": 0.0, "pool fwd+bwd, zd2s, zs2d": 0.0, "library matmul (1x1x1, up-conv)": 0.0,
           "the rest (elementwise, reductions, copies)": 0.0}
    n_conv = 0
    for _, name, ms in events:
        low = name.lower()
        if "conv3d_k3_" in name:  # either route's kernel
            fam["hand conv forward" if n_conv < len(MAIN_CONVS) else "hand conv dx"] += ms
            n_conv += 1
        elif "zcat_" in name and "zcat_bwd" not in name:  # any of zcat's kernels
            fam["zcat"] += ms
        elif any(k in name for k in ("pool_max_kernel", "pool_channels_kernel", "pool_bwd_kernel",
                                     "zd2s_kernel", "zs2d_kernel")):
            fam["pool fwd+bwd, zd2s, zs2d"] += ms
        elif "wgrad" in low or "cudnn" in low:
            fam["library dw (cuDNN wgrad)"] += ms
        elif "gemm" in low or "cutlass" in low or "cublas" in low:
            fam["library matmul (1x1x1, up-conv)"] += ms
        else:
            fam["the rest (elementwise, reductions, copies)"] += ms
    print(f"[train-profile] one step, b=1: wall {wall:.3f} s, device busy {dev_total / 1e3:.3f} s "
          f"({100 * dev_total / 1e3 / wall:.1f}% of wall)")
    for k, ms in fam.items():
        print(f"[train-profile] {ms:10.2f} ms  {100 * ms / dev_total:5.1f}%  {k}")
    for key, ms, cnt in table[:14]:
        print(f"[train-profile]   {ms:10.2f} ms  {cnt:5d}x  {key[:90]}")
    return dict(wall_s=wall, device_ms=dev_total, families=fam,
                top=[dict(name=k, ms=m, count=c) for k, m, c in table[:40]])


def phase_train_larger_io():
    """The same model with MODEL.LARGER_IO: the 5x5x5 stem and out-block
    convs take the cat2d path (zcat with kz = 5 forward, zcat_bwd backward)."""
    import torch

    from biapy_tpu_torch.engine.train_engine import make_train_step, resolve_mixed_precision
    from biapy_tpu_torch.ops.kernels import build

    job = _train_job("chip_smoke_train_larger_io", larger_io=True)
    wf = job.workflow
    step = make_train_step(wf.loss, wf.train_metrics,
                           mixed_precision=resolve_mixed_precision("auto", wf.device))
    batch = _train_batch(1, wf.device)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    state, losses = wf.state, []
    t0 = time.perf_counter()
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    secs = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    routes = dict(build.CONV3D_ROUTES)
    _check_launches(launches, LARGER_IO_LAUNCHES, 2, "train LARGER_IO")
    _check_launches(routes, LARGER_IO_ROUTES, 2, "train LARGER_IO, conv3d routes")
    if not all(v == v and abs(v) != float("inf") for v in losses):
        raise AssertionError(f"train LARGER_IO: non-finite loss in {losses}")
    peak = torch.cuda.max_memory_allocated()
    print(f"[train-larger-io] 2 steps (first included) in {secs:.3f} s, losses {losses}, peak "
          f"memory {peak / 2**30:.2f} GiB; launches {launches}; conv3d routes {routes}")
    del job, wf, state, batch
    torch.cuda.empty_cache()
    return dict(seconds=secs, losses=losses, peak_bytes=peak, launches=launches,
                conv3d_routes=routes)


def phase_grads_vs_plain():
    """One training step at reduced width (fm 8/16/32, patch 32^3, float32,
    LARGER_IO on) on the card (kernels) and on the CPU (plain versions) from
    the same weights and batch: loss, every gradient, every updated weight."""
    import numpy as np
    import torch

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.engine.train_engine import loss_and_grads, make_train_step

    cfg = _main_cfg()
    cfg["MODEL"].update(FEATURE_MAPS=[8, 16, 32], LARGER_IO=True)
    cfg["DATA"]["PATCH_SIZE"] = [32, 32, 32, 1]
    cfg["TRAIN"].update(BATCH_SIZE=2, LR=[0.05])  # a rate at which one update shows
    rng = np.random.default_rng(2)
    x = rng.random((2, 32, 32, 32, 1), np.float32)
    y = (rng.random((2, 32, 32, 32, 1), np.float32) > 0.5).astype(np.float32)
    sides = []
    for dev in ("cuda:0", "cpu"):
        job = BiaPy(cfg, result_dir=str(OUT_DIR), name=f"chip_smoke_grads_{dev[:3]}",
                    silent=True, check_data_paths=False, device=dev)
        job._build_workflow()
        wf = job.workflow
        wf.prepare_model()  # seeded init: the same weights on both devices
        xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        loss, _, grads = loss_and_grads(wf.model, wf.loss, xt, yt)
        make_train_step(wf.loss, wf.train_metrics)(wf.state, {"x": xt, "y": yt})
        sides.append((float(loss), {k: v.cpu() for k, v in grads.items()},
                      {k: v.detach().cpu() for k, v in wf.model.named_parameters()}))
    tol = 1e-4  # float32 sums in other orders on the two devices, of each tensor's scale
    worst = {"loss": abs(sides[0][0] - sides[1][0])}
    for what, i in (("grad", 1), ("weight", 2)):
        worst[what] = 0.0
        for k, ref in sides[1][i].items():
            rel = ((sides[0][i][k] - ref).abs().max() / max(1.0, ref.abs().max().item())).item()
            worst[what] = max(worst[what], rel)
            if not rel <= tol:
                raise AssertionError(f"{what} {k}: card and CPU differ by {rel} of its scale")
    if not worst["loss"] <= tol:
        raise AssertionError(f"loss: card {sides[0][0]} vs CPU {sides[1][0]}")
    print(f"[grads-vs-plain] fm 8/16/32, patch 32^3, b=2, f32, LARGER_IO: loss {sides[0][0]:.6f}, "
          f"max scaled differences {worst} (tol {tol})")
    return worst


def phase_whole_vs_plain():
    """The port at reduced width on the card (kernels) and on the CPU (plain
    versions), same weights, same volume, float32."""
    import numpy as np
    import torch

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.ops.kernels import build

    cfg = _main_cfg()
    cfg["MODEL"]["FEATURE_MAPS"] = [8, 16, 32]
    cfg["DATA"]["PATCH_SIZE"] = [32, 32, 32, 1]
    cfg["DATA"]["TEST"] = {"PADDING": [4, 4, 4], "OVERLAP": [0.25, 0.25, 0.25]}
    cfg["TEST"] = {"ENABLE": True, "REDUCE_MEMORY": False, "OUTPUT_QUANT_UINT8": False}
    vol = np.random.default_rng(1).integers(0, 256, (40, 37, 45), dtype=np.uint8)
    preds = []
    build.reset_launches()
    for dev in ("cuda:0", "cpu"):
        job = BiaPy(cfg, result_dir=str(OUT_DIR), name=f"chip_smoke_small_{dev[:3]}",
                    silent=True, check_data_paths=False, device=dev)
        job._build_workflow()
        job.workflow.prepare_model()  # seeded init: the same weights on both devices
        _random_bn_stats(job.workflow.model, seed=1)
        preds.append(job.predict(vol)[0]["pred"])
    routes = dict(build.CONV3D_ROUTES)
    if routes["stem"] * 9 != routes["tf32x3"] or not routes["tf32x3"] or routes["wgmma"]:
        raise AssertionError(f"float32 small path: conv3d routes {routes}, want 9 tf32x3 per "
                             "stem and no wgmma")
    diff = float(np.abs(preds[0] - preds[1]).max())
    tol = 1e-4  # float32 sums in other orders on the two devices
    print(f"[whole-vs-plain] fm 8/16/32, patch 32^3, volume (40, 37, 45), f32: "
          f"max |p_card - p_cpu| = {diff:.3g} (tol {tol})")
    if not diff <= tol:
        raise AssertionError(f"card and CPU paths differ by {diff} > {tol}")
    return diff


def phase_whole_vs_plain_bf16():
    """The same comparison in the main path's dtype, so that the whole path
    through the tensor-core conv is held too: bf16 weights and activations
    (TEST.REDUCE_MEMORY) at feature maps 16/32/64 (every 3x3x3 conv but the
    stem has Cin a multiple of 16: 16, 32, 48, 64, 96), probabilities not
    quantised."""
    import numpy as np

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.ops.kernels import build

    cfg = _main_cfg()
    cfg["MODEL"]["FEATURE_MAPS"] = [16, 32, 64]
    cfg["DATA"]["PATCH_SIZE"] = [32, 32, 32, 1]
    cfg["DATA"]["TEST"] = {"PADDING": [4, 4, 4], "OVERLAP": [0.25, 0.25, 0.25]}
    cfg["TEST"] = {"ENABLE": True, "REDUCE_MEMORY": True, "OUTPUT_QUANT_UINT8": False}
    vol = np.random.default_rng(1).integers(0, 256, (40, 37, 45), dtype=np.uint8)
    preds = []
    build.reset_launches()
    for dev in ("cuda:0", "cpu"):
        job = BiaPy(cfg, result_dir=str(OUT_DIR), name=f"chip_smoke_small_bf16_{dev[:3]}",
                    silent=True, check_data_paths=False, device=dev)
        job._build_workflow()
        job.workflow.prepare_model()  # seeded init: the same weights on both devices
        _random_bn_stats(job.workflow.model, seed=1)
        preds.append(np.asarray(job.predict(vol)[0]["pred"], dtype=np.float32))
    routes = dict(build.CONV3D_ROUTES)
    if routes["stem"] * 9 != routes["wgmma"] or not routes["wgmma"] or routes["tf32x3"]:
        raise AssertionError(f"bf16 small path: conv3d routes {routes}, want 9 wgmma per stem "
                             "and no tf32x3")
    diff = np.abs(preds[0] - preds[1])
    worst, mean = float(diff.max()), float(diff.mean())
    # every layer rounds its activations to bf16 (2^-8 relative) and the two
    # devices break those roundings differently (float32 sums in other orders,
    # other exp and rsqrt), so errors of a few bf16 ulps of the pre-sigmoid
    # logits add up over the 10 convs; a wrong tap, seam or channel moves the
    # probabilities by tenths. Worst voxel within 5e-2, mean within 5e-3.
    tol_max, tol_mean = 5e-2, 5e-3
    print(f"[whole-vs-plain-bf16] fm 16/32/64, patch 32^3, volume (40, 37, 45), bf16: "
          f"max |p_card - p_cpu| = {worst:.3g} (tol {tol_max}), mean {mean:.3g} (tol {tol_mean}); "
          f"conv3d routes on the card {routes}")
    if not (worst <= tol_max and mean <= tol_mean):
        raise AssertionError(f"bf16 card and CPU paths differ by max {worst}, mean {mean}")
    return dict(max_abs=worst, mean_abs=mean, conv3d_routes=routes)


# the job phase: a seeded dataset of uint8 TIFFs (two 256^3 training volumes,
# eight 128^3 patches each, a quarter of the patches held out for validation;
# one 216^3 test volume), two epochs at batch 2
JOB_TRAIN_SHAPE, JOB_TEST_SHAPE, JOB_EPOCHS, JOB_BATCH = (256, 256, 256), (216, 216, 216), 2, 2
# launches of one forward batch of the serving path (phase 4's per patch at
# batch 1: the kernels take the whole batch in one launch)
SERVE_LAUNCHES = {"conv3d": 10, "pool_max_folded": 2, "zd2s": 2, "pad_channels": 0,
                  "tf32_split": 0}


def _job_volume(g, shape, dev):
    """A uint8 volume and its 0/255 mask: the mask is a smoothed random field
    above a threshold (blobs the model can learn), the image the mask
    brightened plus noise."""
    import torch
    import torch.nn.functional as F

    coarse = [max(2, n // 24) for n in shape]
    field = F.interpolate(torch.randn([1, 1] + coarse, generator=g, device=dev), size=shape,
                          mode="trilinear", align_corners=False)[0, 0]
    mask = field > 0.4
    img = 0.3 + 0.35 * mask + 0.12 * torch.randn(shape, generator=g, device=dev)
    return ((img.clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy(),
            (mask.to(torch.uint8) * 255).cpu().numpy())


def _write_job_data(root):
    import torch

    from biapy_tpu_torch.data.tiff import write_tiff

    g = torch.Generator(device=DEVICE).manual_seed(0)
    vols = {}
    for split, n, shape in (("train", 2, JOB_TRAIN_SHAPE), ("test", 1, JOB_TEST_SHAPE)):
        for d in ("x", "y"):
            (root / split / d).mkdir(parents=True)
        for i in range(n):
            img, msk = _job_volume(g, shape, DEVICE)
            write_tiff(str(root / split / "x" / f"{split}_{i:03d}.tif"), img)
            write_tiff(str(root / split / "y" / f"{split}_{i:03d}.tif"), msk)
            vols[f"{split}_{i}"] = (img, msk)
    return vols


def _steady_idle_share(events, per, units, what):
    """Idle share of the device from the first conv3d launch of the second
    unit (a training step, a tile) to the end of the last event; each unit
    launches conv3d ``per`` times, the first being a stem's (on the stem
    kernel, the unit's last on the tensor cores). Busy time is the union of
    the events' intervals on every stream (a tile's drain copy overlaps the
    next tile's compute).

    The window, units 2 on, must be whole: its ``per * (units - 1)`` conv3d
    events are the trace's last, and the first of them a stem; a lost event
    inside it would put a tensor-core conv there. The first unit, outside
    the window, may lack events: traces of augmented epochs on the card
    lost a conv3d kernel of the first step that the counters saw launched."""
    convs = [i for i, (_, name, _) in enumerate(events) if "conv3d_k3_" in name]
    steady = per * (units - 1)
    if not steady < len(convs) <= per * units or "wgmma" in events[convs[-steady]][1]:
        raise AssertionError(f"{what}: {len(convs)} conv3d events of {per * units}, the window "
                             f"of units 2-{units} not whole")
    if len(convs) < per * units:
        print(f"[profile] {what}: the trace lacks {per * units - len(convs)} of the first "
              f"unit's {per} conv3d events; units 2-{units} are whole")
    t0 = events[convs[-steady]][0]
    return _window_idle_share(sorted(e for e in events if e[0] >= t0))


def phase_job(serve, train):
    """The whole job through ``BiaPy(cfg).run_job()`` at the bench job's full
    width (resunet 32/64/128, BatchNorm, ELU, 128^3 patches, bf16 mixed
    precision, REDUCE_MEMORY, uint8 drain), batch 2, two epochs: TIFFs read
    from disk, SGD with validation, checkpoints in the JAX package's format,
    the best one reloaded, the test volume predicted and written. Then: the
    checkpoints read back, a model rebuilt from the best one predicts the
    written result exactly, launch counts against phases 4 and 6, one more
    epoch timed and one profiled, a second test pass timed."""
    import shutil

    import numpy as np
    import torch

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.data.tiff import read_tiff
    from biapy_tpu_torch.engine.train_engine import make_train_step, resolve_mixed_precision
    from biapy_tpu_torch.ops.kernels import build
    from biapy_tpu_torch.utils.misc import load_checkpoint

    root = OUT_DIR / "chip_smoke_job"
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        vols = _write_job_data(root)
        data_s = time.perf_counter() - t0
        cfg = _main_cfg()
        cfg["DATA"]["TRAIN"] = {"PATH": str(root / "train/x"), "GT_PATH": str(root / "train/y"),
                                "IN_MEMORY": True}
        cfg["DATA"]["VAL"] = {"FROM_TRAIN": True, "SPLIT_TRAIN": 0.25}
        cfg["DATA"]["TEST"].update(PATH=str(root / "test/x"), GT_PATH=str(root / "test/y"),
                                   LOAD_GT=True, IN_MEMORY=False)
        # a rate at which twelve SGD updates move the loss
        cfg["TRAIN"].update(EPOCHS=JOB_EPOCHS, BATCH_SIZE=JOB_BATCH, LR=[0.01])
        job = BiaPy(cfg, result_dir=str(root / "results"), name="chip_job", silent=True)
        job._build_workflow()
        calls = _count_forwards(job.workflow)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        job.run_job()
        torch.cuda.synchronize()
        job_s = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        wf = job.workflow
        hist = wf.history
        n_steps = len(wf.train_loader) * JOB_EPOCHS
        n_val = len(wf.val_loader) * JOB_EPOCHS
        n_test = int(np.prod([n // 108 for n in JOB_TEST_SHAPE])) // JOB_BATCH  # 108: the core
        per_step = {k: v // (train["by_batch"][1]["steps"] + 2)
                    for k, v in train["by_batch"][1]["launches"].items()}
        per_fwd = {k: serve["launches"].get(k, 0) // 24 for k in per_step}  # 3 calls x 8 patches
        want = {k: per_step[k] * n_steps + per_fwd[k] * (n_val + n_test) for k in per_step}
        # the tables are bf16's; the validation forwards run in float32, so
        # their 3xTF32 launches split x: the rule's count over the forwards
        want["tf32_split"] = _expected_launches(wf.model, calls)[0]["tf32_split"]
        if launches != want:
            raise AssertionError(f"job: launches {launches}, want {want} ({n_steps} train steps "
                                 f"x {per_step} + {n_val + n_test} forward batches x {per_fwd})")
        losses = [h["loss"] for h in hist] + [h["val_loss"] for h in hist]
        if len(hist) != JOB_EPOCHS or not all(np.isfinite(v) for v in losses):
            raise AssertionError(f"job: epochs {hist}")

        ck_dir = root / "results/chip_job/checkpoints"
        files = sorted(p.name for p in ck_dir.iterdir())
        if files != [f"chip_job-checkpoint-{JOB_EPOCHS - 1}.ckpt", "chip_job-checkpoint-best.ckpt"]:
            raise AssertionError(f"job: checkpoints {files}")
        ck_bytes = {f: (ck_dir / f).stat().st_size for f in files}
        t0 = time.perf_counter()
        cks = {f: load_checkpoint(str(ck_dir / f)) for f in files}
        read_s = (time.perf_counter() - t0) / len(files)
        last = cks[files[0]]
        if last["epoch"] != JOB_EPOCHS - 1 or "opt_state" not in last:
            raise AssertionError("job: the last checkpoint lacks its epoch or optimizer state")
        t0 = time.perf_counter()
        timing = wf.save_checkpoint(JOB_EPOCHS, metric="timing", with_optimizer=True)
        write_s = time.perf_counter() - t0
        timing_bytes = Path(timing).stat().st_size
        Path(timing).unlink()

        res = root / "results/chip_job/results/chip_job"
        written = read_tiff(str(res / "per_image/test_000.tif"))
        img, msk = vols["test_0"]
        # a new job on the same config that loads the best checkpoint (by
        # MODEL.LOAD_CHECKPOINT: BiaPy("x.ckpt") would need PyYAML to read the
        # embedded config, an optional dependency of the port)
        cfg["MODEL"]["LOAD_CHECKPOINT"] = True
        cfg["PATHS"] = {"CHECKPOINT_FILE": str(ck_dir / "chip_job-checkpoint-best.ckpt")}
        reload = BiaPy(cfg, result_dir=str(root), name="chip_job_reload", silent=True)
        again = reload.predict(img)[0]["pred"][..., 0]
        if written.shape != JOB_TEST_SHAPE or not np.array_equal(again, written):
            raise AssertionError(f"job: the reloaded model's prediction {again.shape} differs from "
                                 f"the written one {written.shape}: "
                                 f"{np.abs(again - written).max() if again.shape == written.shape else ''}")
        iou = wf.stats["iou"]
        fg, pred = msk > 127, written > 127.5
        iou_half = float(np.count_nonzero(fg & pred) / max(1, np.count_nonzero(fg | pred)))
        del reload

        # the loop alone: one more epoch timed, one profiled
        step = make_train_step(wf.loss, wf.train_metrics,
                               mixed_precision=resolve_mixed_precision("auto", wf.device))
        gen = torch.Generator(device=wf.device).manual_seed(1)
        steps = len(wf.train_loader)
        t0 = time.perf_counter()
        wf.train_one_epoch(step, JOB_EPOCHS, gen)  # ends on a host read of the last loss
        loop_s = time.perf_counter() - t0
        loop_pps = steps * JOB_BATCH / loop_s
        for attempt in range(1, 4):
            # a trace on the card can lose a conv3d event (see phase 11 a)
            wall, busy, table, events = _profile_device(
                lambda: wf.train_one_epoch(step, JOB_EPOCHS + attempt, gen))
            try:
                idle, window_ms = _steady_idle_share(events, TRAIN_LAUNCHES["conv3d"], steps,
                                                     "profiled epoch")
                break
            except AssertionError as e:
                if attempt == 3:
                    raise
                print(f"[profile] {e} (trace {attempt}); profiling again")

        # the test phase again, from disk, written again
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        job.test()
        test_s = time.perf_counter() - t0
        mvox = int(np.prod(JOB_TEST_SHAPE)) / test_s / 1e6

        device_pps = train["by_batch"][JOB_BATCH]["patches_per_s"]
        print(f"[job] run_job: {len(wf.train_data)} train / {len(wf.val_data)} val patches of "
              f"128^3 from 2 TIFF volumes of {JOB_TRAIN_SHAPE}, {JOB_EPOCHS} epochs of {steps} "
              f"steps at batch {JOB_BATCH}; data written in {data_s:.1f} s; run_job {job_s:.2f} s, "
              f"peak memory {peak / 2**30:.2f} GiB")
        print(f"[job] seconds per epoch (train, validation, checkpoints) "
              f"{[round(h['time'], 3) for h in hist]}; loss {[round(h['loss'], 5) for h in hist]}, "
              f"val_loss {[round(h['val_loss'], 5) for h in hist]}")
        print(f"[job] the loop: {loop_pps:.3f} training patches/s ({steps} steps in "
              f"{loop_s:.3f} s, loader and H2D included) vs {device_pps:.3f} device-resident "
              f"(phase 6, b={JOB_BATCH}): {100 * (1 - loop_pps / device_pps):.1f}% lower")
        print(f"[job] profiled epoch: device idle {100 * idle:.1f}% of steps 2-{steps} "
              f"({window_ms:.1f} ms); wall {wall:.3f} s, device busy {busy / 1e3:.3f} s")
        print(f"[job] checkpoints {ck_bytes} bytes; write {write_s:.3f} s ({timing_bytes} bytes, "
              f"optimizer state included), read {read_s:.3f} s each")
        print(f"[job] test from disk: {JOB_TEST_SHAPE} in {test_s:.3f} s, {mvox:.3f} Mvox/s "
              f"(read, predict, write); IoU {iou:.4f} (the workflow's, threshold 0.5 on the uint8 "
              f"values), {iou_half:.4f} at p > 0.5; the reloaded best checkpoint predicts the "
              f"written volume exactly")
        print(f"[job] launches over run_job {launches} = {n_steps} steps x {per_step} + "
              f"{n_val + n_test} forward batches x {per_fwd}")
        return dict(seconds=job_s, data_seconds=data_s, epoch_seconds=[h["time"] for h in hist],
                    history=hist, peak_bytes=peak, launches=launches, checkpoint_bytes=ck_bytes,
                    checkpoint_write_s=write_s, checkpoint_read_s=read_s,
                    loop_patches_per_s=loop_pps, device_patches_per_s=device_pps,
                    loop_seconds=loop_s, idle_share=idle, profile=dict(
                        wall_s=wall, device_ms=busy,
                        top=[dict(name=k, ms=m, count=c) for k, m, c in table[:30]]),
                    test_seconds=test_s, test_mvox_per_s=mvox, iou=iou, iou_p_half=iou_half)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the by-chunks phase: (a) a 432^3 volume, tiles = the whole volume; (b) the
# bench's geometry (bench.py:516-548), 5 x 3 x 3 tiles of 216^3 core
CHUNK_EQ_SHAPE = (432, 432, 432)
CHUNK_BENCH_SHAPE = (1080, 648, 648)
CHUNK_TILE = 216  # (128 - 2 * 10) * 2: PATCHES_PER_TILE (2, 2, 2)


def _chunks_cfg(test_dir, norm=None):
    cfg = _main_cfg()
    cfg["DATA"]["TEST"]["PATH"] = str(test_dir)
    if norm:
        cfg["DATA"]["NORMALIZATION"] = {"TYPE": norm}
    cfg["TEST"]["BY_CHUNKS"] = {"ENABLE": True,
                                "WORKFLOW_PROCESS": {"PATCHES_PER_TILE": [2, 2, 2]}}
    return cfg


def _chunks_job(test_dir, name, norm=None):
    from biapy_tpu_torch import BiaPy

    job = BiaPy(_chunks_cfg(test_dir, norm), result_dir=str(test_dir.parent / "results"),
                name=name, silent=True, check_data_paths=False)
    job._build_workflow()
    job.workflow.prepare_model()
    _random_bn_stats(job.workflow.model, seed=0)
    return job


def _write_chunked_volume(path, shape, seed):
    """A seeded uint8 Zarr (216^3 chunks, zlib level 1) of random voxels, one
    chunk per thread (zlib releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor
    from itertools import product

    import numpy as np

    from biapy_tpu_torch.data.zarr_store import ZarrArray

    z = ZarrArray.create(str(path), shape=shape + (1,), chunks=(CHUNK_TILE,) * 3 + (1,),
                         dtype="u1", compressor={"id": "zlib", "level": 1})
    starts = list(product(*(range(0, n, CHUNK_TILE) for n in shape)))

    def write(i):
        sl = tuple(slice(s0, min(s0 + CHUNK_TILE, n)) for s0, n in zip(starts[i], shape))
        rng = np.random.default_rng((seed, i))
        z[sl] = rng.integers(0, 256, size=tuple(e.stop - e.start for e in sl) + (1,),
                             dtype=np.uint8)

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(write, range(len(starts))))


def _chunk_launches(fn, n_patches, what):
    """Run ``fn`` with the launch counters set to 0, check them against phase
    4's per-patch counts, return them."""
    from biapy_tpu_torch.ops.kernels import build

    build.reset_launches()
    fn()
    launches = dict(build.LAUNCHES)
    routes = dict(build.CONV3D_ROUTES)
    _check_launches(launches, SERVE_LAUNCHES, n_patches, what, "patches")
    _check_launches(routes, SERVE_ROUTES, n_patches, what + ", conv3d routes", "patches")
    return launches


def phase_by_chunks():
    """The by-chunks engine (``TEST.BY_CHUNKS``) through ``BiaPy(cfg).test()``
    at the bench's full width, on seeded uint8 Zarr volumes written under
    ``chiprun_out/chip_smoke_chunks/`` (deleted at the end).

    (a) Tiles = the whole volume: a 432^3 volume (2 x 2 x 2 tiles, 64
    patches) with ``DATA.NORMALIZATION.TYPE: div``, whose statistics do not
    depend on the tile; with overlap 0 and real halos the tile grid is the
    whole-volume grid, so the raw prediction must equal ``predict`` on the
    volume in memory: at most 1 uint8 LSB anywhere, the count printed.
    (b) The bench's scale: 1080 x 648 x 648 (45 tiles of 216^3, 360 patches)
    with the bench's normalisation after a one-tile warm-up; the seconds,
    Mvox/s, Zarr read / prepare / write seconds (thread time), the drain's
    bytes and seconds, the peak memory; then a Z_START / Z_END sub-job of one
    z row of tiles (9) under the profiler for the device's idle share over
    its steady tiles (the second onwards)."""
    import shutil

    import numpy as np
    import torch

    from biapy_tpu_torch.data.zarr_store import ZarrArray
    from biapy_tpu_torch.engine.chunked import ChunkedInference

    root = OUT_DIR / "chip_smoke_chunks"
    shutil.rmtree(root, ignore_errors=True)
    per_tile = 8  # (2, 2, 2) patches of 128^3 (core 108) per 216^3 tile
    res = {}
    try:
        # ---- (a) tiles = the whole volume
        t0 = time.perf_counter()
        eq_dir = root / "eq" / "test"
        eq_dir.mkdir(parents=True)
        _write_chunked_volume(eq_dir / "vol.zarr", CHUNK_EQ_SHAPE, seed=5)
        job = _chunks_job(eq_dir, "chunks_eq", norm="div")
        n_eq = per_tile * int(np.prod([n // CHUNK_TILE for n in CHUNK_EQ_SHAPE]))
        t1 = time.perf_counter()
        launches_a = _chunk_launches(job.test, n_eq, "by-chunks (a)")
        eq_s = time.perf_counter() - t1
        per_image = Path(job.workflow.cfg.PATHS.RESULT_DIR.PER_IMAGE)
        got = np.asarray(ZarrArray(str(per_image / "vol_chunks/raw_pred.zarr")))
        vol = np.asarray(ZarrArray(str(eq_dir / "vol.zarr")))
        want = job.predict(vol)[0]["pred"]
        if got.shape != want.shape or got.dtype != np.uint8:
            raise AssertionError(f"by-chunks (a): {got.shape} {got.dtype} vs predict {want.shape}")
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        n_off = int(np.count_nonzero(diff))
        print(f"[chunks] (a) {CHUNK_EQ_SHAPE} uint8 Zarr, {n_eq} patches in "
              f"{n_eq // per_tile} tiles of {CHUNK_TILE}^3: "
              f"by-chunks test() {eq_s:.2f} s; vs predict() in memory: max diff "
              f"{int(diff.max())} uint8 LSB, {n_off} of {diff.size} voxels differ by 1 LSB; "
              f"p mean {got.mean() / 255:.4f}; launches {launches_a} (written in "
              f"{t1 - t0:.1f} s with the model)")
        if diff.max() > 1:
            raise AssertionError(f"by-chunks (a): {int(diff.max())} LSB from predict()")
        res["eq"] = dict(shape=CHUNK_EQ_SHAPE, seconds=eq_s, max_diff_lsb=int(diff.max()),
                         voxels_off_by_one=n_off, launches=launches_a)
        del got, vol, want, diff, job
        shutil.rmtree(root / "eq")

        # ---- (b) the bench's scale
        bench_dir = root / "bench" / "test"
        bench_dir.mkdir(parents=True)
        t0 = time.perf_counter()
        _write_chunked_volume(bench_dir / "vol.zarr", CHUNK_BENCH_SHAPE, seed=7)
        _write_chunked_volume(root / "warm.zarr", (CHUNK_TILE,) * 3, seed=8)
        data_s = time.perf_counter() - t0
        job = _chunks_job(bench_dir, "chunks_bench")
        wf = job.workflow
        n_tiles = int(np.prod([n // CHUNK_TILE for n in CHUNK_BENCH_SHAPE]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timed = {}

        def warm_and_timed():
            ChunkedInference(wf, (128, 128, 128), (0.0,) * 3, (10, 10, 10), (2, 2, 2), 1,
                             str(root)).predict_volume(str(root / "warm.zarr"),
                                                       out_name="warm_pred.zarr", verbose=False)
            torch.cuda.synchronize()
            t = time.perf_counter()
            job.test()  # ends when the last tile is written
            timed["s"] = time.perf_counter() - t

        launches_b = _chunk_launches(warm_and_timed, (n_tiles + 1) * per_tile, "by-chunks (b)")
        peak = torch.cuda.max_memory_allocated()
        secs = timed["s"]
        st = dict(wf.last_chunked.last_drain_stats)
        mvox = float(np.prod(CHUNK_BENCH_SHAPE)) / secs / 1e6
        raw_path = Path(wf.cfg.PATHS.RESULT_DIR.PER_IMAGE) / "vol_chunks"
        raw = ZarrArray(str(raw_path / "raw_pred.zarr"))
        chunk_files = [p for p in (raw_path / "raw_pred.zarr").iterdir()
                       if not p.name.startswith(".")]
        if (raw.shape != CHUNK_BENCH_SHAPE + (1,) or raw.dtype != np.uint8
                or len(chunk_files) != n_tiles or st["tiles"] != n_tiles):
            raise AssertionError(f"by-chunks (b): {raw.shape} {raw.dtype}, {len(chunk_files)} "
                                 f"chunk files, {st['tiles']} tiles, want {n_tiles}")
        tile = raw[CHUNK_TILE:2 * CHUNK_TILE, CHUNK_TILE:2 * CHUNK_TILE, CHUNK_TILE:2 * CHUNK_TILE]
        if not 0 < tile.std():
            raise AssertionError("by-chunks (b): a constant tile")

        # the profiled stretch: the second z row of tiles as a Z_START/Z_END
        # sub-job (9 tiles), rewriting the same chunks
        cfg = wf.cfg
        cfg.defrost()
        cfg.TEST.BY_CHUNKS.Z_START, cfg.TEST.BY_CHUNKS.Z_END = CHUNK_TILE, 2 * CHUNK_TILE
        cfg.freeze()
        row = CHUNK_BENCH_SHAPE[1] // CHUNK_TILE * (CHUNK_BENCH_SHAPE[2] // CHUNK_TILE)
        prof = {}

        def profiled():
            prof["wall"], _, prof["table"], prof["events"] = _profile_device(job.test)

        for attempt in range(1, 4):
            # a trace on the card can lose a conv3d event (see phase 11 a)
            launches_p = _chunk_launches(profiled, row * per_tile, "by-chunks (profiled sub-job)")
            events = prof["events"]
            try:
                idle, window_ms = _steady_idle_share(events, SERVE_LAUNCHES["conv3d"] * per_tile,
                                                     row, "profiled sub-job")
                break
            except AssertionError as e:
                if attempt == 3:
                    raise
                print(f"[profile] {e} (trace {attempt}); profiling again")
        d2h = sum(ms for _, name, ms in events if "DtoH" in name or "Device -> Pinned" in name)

        print(f"[chunks] (b) {CHUNK_BENCH_SHAPE} uint8 Zarr (216^3 chunks, zlib 1; written with "
              f"the warm-up volume in {data_s:.1f} s), {n_tiles} tiles of {CHUNK_TILE}^3, "
              f"{n_tiles * per_tile} patches of 128^3, halo 10, bf16, uint8 store: "
              f"{secs:.3f} s, {mvox:.3f} Mvox/s end to end (test(), after a one-tile warm-up); "
              f"peak memory {peak / 2**30:.2f} GiB")
        print(f"[chunks] (b) thread seconds: Zarr read {st['read_seconds']:.3f}, tile prepare "
              f"(pad, statistics, pin) {st['prep_seconds']:.3f}, Zarr write "
              f"{st['write_seconds']:.3f}; drain {st['bytes']} bytes in {st['seconds']:.4f} s "
              f"of D2H ({st['mb_per_s']:.0f} MB/s)")
        print(f"[chunks] (b) profiled Z_START/Z_END sub-job of {row} tiles: wall "
              f"{prof['wall']:.3f} s, device idle {100 * idle:.1f}% of tiles 2-{row} "
              f"({window_ms:.1f} ms), D2H {d2h:.2f} ms")
        for key, ms, cnt in prof["table"][:8]:
            print(f"[chunks] {ms:10.2f} ms  {cnt:6d}x  {key[:90]}")
        print(f"[chunks] (b) launches, warm-up + {n_tiles} tiles: {launches_b}")
        res["bench"] = dict(shape=CHUNK_BENCH_SHAPE, tiles=n_tiles, seconds=secs,
                            mvox_per_s=mvox, data_seconds=data_s, peak_bytes=peak, drain=st,
                            launches=launches_b, profile=dict(
                                tiles=row, wall_s=prof["wall"], idle_share=idle,
                                window_ms=window_ms, d2h_ms=d2h, launches=launches_p,
                                top=[dict(name=k, ms=m, count=c)
                                     for k, m, c in prof["table"][:30]]))
        res["launches"] = {k: launches_a[k] + launches_b[k] + launches_p[k] for k in launches_a}
        return res
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 11: the augmented job (the repository template's augmentations on
# phase 9's data), its test pass with test-time augmentation, TTA on the
# card against the CPU, and the repository template itself
AUG_SET = {"ENABLE": True, "RANDOM_ROT": True, "VFLIP": True, "HFLIP": True, "ZFLIP": True}
TTA_ORIENTATIONS = 16  # the 3D group (data/tta.py::build_axis_transform_group, "full")
TEMPLATE = REPO / "templates/semantic_segmentation/3d_semantic_segmentation.yaml"
TEMPLATE_TRAIN_SHAPE, TEMPLATE_TEST_SHAPE = (80, 256, 256), (80, 256, 256)


def _augment_seconds(ds, n=8, image_only=False):
    """Host seconds per training sample in one loader thread (torch threads
    as the loader's): ``PairDataset.get`` whole, the augmentation pass alone
    on the normalised sample, and one rotation of the image and mask
    (``affine_2d``, the warp RANDOM_ROT takes half of the time);
    ``image_only``: a classifier's sample, whose target is a label and not
    augmented."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from biapy_tpu_torch.data import augmentors
    from biapy_tpu_torch.data.generators import AUG_THREADS

    def run():
        rng = np.random.default_rng(0)
        get_s, aug_s, rot_s = [], [], []
        for i in range(n):
            t0 = time.perf_counter()
            s = ds.get(i % len(ds), rng)
            get_s.append(time.perf_counter() - t0)
            mask = None if image_only else s["y"]
            t0 = time.perf_counter()
            ds.aug(s["x"], mask, rng)
            aug_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            augmentors.affine_2d(s["x"], mask, rng, rot_deg=float(rng.uniform(-180, 180)))
            rot_s.append(time.perf_counter() - t0)
        return (statistics.mean(get_s), statistics.mean(aug_s), statistics.mean(rot_s))

    with ThreadPoolExecutor(1, initializer=torch.set_num_threads, initargs=(AUG_THREADS,)) as p:
        return p.submit(run).result()


def phase_augmented(serve, train):
    """(a) Phase 9's job with the template's augmentations (RANDOM_ROT,
    VFLIP, HFLIP, ZFLIP at their default probabilities) and test-time
    augmentation (mean over the 16 orientations) at batch 2, through
    ``run_job``: seconds per epoch, one more epoch timed (the loop's
    patches/s against phase 6's device-resident rate at b = 2, launches at
    phase 6's per step), one profiled (the idle share over steady steps),
    the host's augmentation seconds per sample. (b) The test pass again at
    batch 1 with TTA: Mvox/s, launches at 16 x phase 4's per patch."""
    import shutil

    import numpy as np
    import torch

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.data.tiff import read_tiff
    from biapy_tpu_torch.engine.train_engine import make_train_step, resolve_mixed_precision
    from biapy_tpu_torch.ops.kernels import build

    root = OUT_DIR / "chip_smoke_aug"
    shutil.rmtree(root, ignore_errors=True)
    try:
        _write_job_data(root)
        cfg = _main_cfg()
        cfg["DATA"]["TRAIN"] = {"PATH": str(root / "train/x"), "GT_PATH": str(root / "train/y"),
                                "IN_MEMORY": True}
        cfg["DATA"]["VAL"] = {"FROM_TRAIN": True, "SPLIT_TRAIN": 0.25}
        cfg["DATA"]["TEST"].update(PATH=str(root / "test/x"), GT_PATH=str(root / "test/y"),
                                   LOAD_GT=True, IN_MEMORY=False)
        cfg["TRAIN"].update(EPOCHS=JOB_EPOCHS, BATCH_SIZE=JOB_BATCH, LR=[0.01])
        cfg["AUGMENTOR"] = dict(AUG_SET)
        cfg["TEST"].update(AUGMENTATION=True, AUGMENTATION_MODE="mean", AUGMENTATION_GROUP="full")
        job = BiaPy(cfg, result_dir=str(root / "results"), name="chip_aug", silent=True)
        job._build_workflow()
        calls = _count_forwards(job.workflow)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        job.run_job()
        torch.cuda.synchronize()
        job_s = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        wf = job.workflow
        hist = wf.history
        n_steps = len(wf.train_loader) * JOB_EPOCHS
        n_val = len(wf.val_loader) * JOB_EPOCHS
        n_patches = int(np.prod([n // 108 for n in JOB_TEST_SHAPE]))  # 108: the core
        n_tta = TTA_ORIENTATIONS * n_patches // JOB_BATCH  # forward batches of the TTA pass
        per_step = {k: v // (train["by_batch"][1]["steps"] + 2)
                    for k, v in train["by_batch"][1]["launches"].items()}
        per_fwd = {k: serve["launches"].get(k, 0) // 24 for k in per_step}  # 3 calls x 8 patches
        want = {k: per_step[k] * n_steps + per_fwd[k] * (n_val + n_tta) for k in per_step}
        # as in phase 9: the float32 validation forwards' splits by the rule
        want["tf32_split"] = _expected_launches(wf.model, calls)[0]["tf32_split"]
        if launches != want:
            raise AssertionError(f"augmented job: launches {launches}, want {want} ({n_steps} "
                                 f"steps x {per_step} + {n_val} + {n_tta} forward batches x "
                                 f"{per_fwd})")
        losses = [h["loss"] for h in hist] + [h["val_loss"] for h in hist]
        if len(hist) != JOB_EPOCHS or not all(np.isfinite(v) for v in losses):
            raise AssertionError(f"augmented job: epochs {hist}")
        aug_dir = Path(wf.cfg.PATHS.DA_SAMPLES)
        if len(list(aug_dir.glob("aug_*_x.tif"))) != int(wf.cfg.AUGMENTOR.AUG_NUM_SAMPLES):
            raise AssertionError(f"augmented job: samples in {aug_dir}: {sorted(aug_dir.iterdir())}")
        get_s, aug_s, rot_s = _augment_seconds(wf.train_data)

        # the loop alone: one more epoch timed, one profiled
        step = make_train_step(wf.loss, wf.train_metrics,
                               mixed_precision=resolve_mixed_precision("auto", wf.device))
        gen = torch.Generator(device=wf.device).manual_seed(1)
        steps = len(wf.train_loader)
        build.reset_launches()
        t0 = time.perf_counter()
        wf.train_one_epoch(step, JOB_EPOCHS, gen)  # ends on a host read of the last loss
        loop_s = time.perf_counter() - t0
        loop_launches = dict(build.LAUNCHES)
        _check_launches(loop_launches, per_step, steps, "augmented loop")
        loop_pps = steps * JOB_BATCH / loop_s
        for attempt in range(1, 4):
            # this trace has lost conv3d events on the card, mostly of the
            # first step, which the window leaves out; once, of the window
            wall, busy, table, events = _profile_device(
                lambda: wf.train_one_epoch(step, JOB_EPOCHS + attempt, gen))
            try:
                idle, window_ms = _steady_idle_share(events, TRAIN_LAUNCHES["conv3d"], steps,
                                                     "augmented profiled epoch")
                break
            except AssertionError as e:
                if attempt == 3:
                    raise
                print(f"[profile] {e} (trace {attempt}); profiling again")

        # (b) the test pass with TTA again, at batch 1 (phase 4's), timed
        c = wf.cfg
        c.defrost()
        c.TRAIN.BATCH_SIZE = 1
        c.freeze()
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        job.test()
        test_s = time.perf_counter() - t0
        tta_launches = dict(build.LAUNCHES)
        tta_routes = dict(build.CONV3D_ROUTES)
        _check_launches(tta_launches, SERVE_LAUNCHES, TTA_ORIENTATIONS * n_patches,
                        "TTA test pass", "patches")
        _check_launches(tta_routes, SERVE_ROUTES, TTA_ORIENTATIONS * n_patches,
                        "TTA test pass, conv3d routes", "patches")
        written = read_tiff(str(root / "results/chip_aug/results/chip_aug/per_image/test_000.tif"))
        if (written.shape != JOB_TEST_SHAPE or not np.all(np.isfinite(written))
                or written.min() < 0 or written.max() > 1):
            raise AssertionError(f"TTA test pass: prediction {written.shape}, "
                                 f"{written.min()}..{written.max()}")
        mvox = int(np.prod(JOB_TEST_SHAPE)) / test_s / 1e6
        device_pps = train["by_batch"][JOB_BATCH]["patches_per_s"]
        print(f"[aug] run_job with {sorted(k for k in AUG_SET if k != 'ENABLE')} and TTA (mean, "
              f"{TTA_ORIENTATIONS} orientations): {len(wf.train_data)} train / "
              f"{len(wf.val_data)} val patches of 128^3, {JOB_EPOCHS} epochs of {steps} steps at "
              f"batch {JOB_BATCH}: {job_s:.2f} s, peak memory {peak / 2**30:.2f} GiB")
        print(f"[aug] seconds per epoch (train, validation, checkpoints) "
              f"{[round(h['time'], 3) for h in hist]}; loss {[round(h['loss'], 5) for h in hist]}, "
              f"val_loss {[round(h['val_loss'], 5) for h in hist]}")
        print(f"[aug] host seconds per sample in one loader thread: get {get_s:.4f} (read, crop, "
              f"normalise, augment), augmentation alone {aug_s:.4f}, one rotation of image and "
              f"mask {rot_s:.4f}")
        print(f"[aug] the loop: {loop_pps:.3f} training patches/s ({steps} steps in {loop_s:.3f} "
              f"s, loader, augmentation and H2D included) vs {device_pps:.3f} device-resident "
              f"(phase 6, b={JOB_BATCH}): {100 * (1 - loop_pps / device_pps):.1f}% lower; "
              f"launches {loop_launches} = {steps} x phase 6's per step")
        print(f"[aug] profiled epoch: device idle {100 * idle:.1f}% of steps 2-{steps} "
              f"({window_ms:.1f} ms); wall {wall:.3f} s, device busy {busy / 1e3:.3f} s")
        print(f"[aug] (b) TTA test pass at batch 1: {JOB_TEST_SHAPE} in {test_s:.3f} s, "
              f"{mvox:.3f} Mvox/s (read, {TTA_ORIENTATIONS} x {n_patches} patches, merge, "
              f"write); launches {tta_launches} = {TTA_ORIENTATIONS} x {n_patches} x phase 4's "
              f"per patch; conv3d routes {tta_routes}")
        return dict(seconds=job_s, epoch_seconds=[h["time"] for h in hist], history=hist,
                    peak_bytes=peak, launches_run_job=launches, sample_get_s=get_s,
                    augment_s=aug_s, rotation_s=rot_s, loop_seconds=loop_s,
                    loop_patches_per_s=loop_pps, device_patches_per_s=device_pps,
                    loop_launches=loop_launches, idle_share=idle, profile=dict(
                        wall_s=wall, device_ms=busy,
                        top=[dict(name=k, ms=m, count=c) for k, m, c in table[:30]]),
                    tta_test_seconds=test_s, tta_mvox_per_s=mvox, tta_launches=tta_launches,
                    tta_routes=tta_routes,
                    launches={k: launches.get(k, 0) + loop_launches.get(k, 0)
                              + tta_launches.get(k, 0) for k in KERNEL_META})
    finally:
        shutil.rmtree(root, ignore_errors=True)


TTA_SHAPE = (40, 37, 45)


def phase_tta_vs_plain():
    """(c) TTA (mean over the 16 orientations) at reduced width on the card
    and on the CPU (plain versions), same weights and volume, compared as
    phase 5 compares ``predict``: float32 at fm 8/16/32, bf16 at 16/32/64.
    The CPU sides run in the CPU-side child (``_cpu_side``); the comparison
    is finished after the last phase. Returns the result dict, which the
    comparison fills in."""
    import numpy as np

    from biapy_tpu_torch import BiaPy

    vol = np.random.default_rng(1).integers(0, 256, TTA_SHAPE, dtype=np.uint8)
    res = {}
    for dt, fm, reduce_mem in (("float32", [8, 16, 32], False), ("bfloat16", [16, 32, 64], True)):
        cfg = _main_cfg()
        cfg["MODEL"]["FEATURE_MAPS"] = fm
        cfg["DATA"]["PATCH_SIZE"] = [32, 32, 32, 1]
        cfg["DATA"]["TEST"] = {"PADDING": [4, 4, 4], "OVERLAP": [0.25, 0.25, 0.25]}
        cfg["TEST"] = {"ENABLE": True, "REDUCE_MEMORY": reduce_mem, "OUTPUT_QUANT_UINT8": False,
                       "AUGMENTATION": True, "AUGMENTATION_MODE": "mean",
                       "AUGMENTATION_GROUP": "full"}
        # seeded init: the same weights on both devices
        cpu = _cpu_side("_cpu_predict", cfg=cfg, vol=vol, result_dir=str(OUT_DIR),
                        name=f"chip_smoke_tta_{dt}_cpu", check_data_paths=False, bn_seed=1)
        job = BiaPy(cfg, result_dir=str(OUT_DIR), name=f"chip_smoke_tta_{dt}_cud",
                    silent=True, check_data_paths=False, device=DEVICE)
        job._build_workflow()
        job.workflow.prepare_model()
        _random_bn_stats(job.workflow.model, seed=1)
        t0 = time.perf_counter()
        card = np.asarray(job.predict(vol)[0]["pred"], dtype=np.float32)
        card_s = time.perf_counter() - t0

        def finish(dt=dt, fm=fm, card=card, card_s=card_s, cpu=cpu):
            got = cpu()
            diff = np.abs(card - np.asarray(got["preds"][0]["pred"], dtype=np.float32))
            worst, mean = float(diff.max()), float(diff.mean())
            # as phase 5: float32 sums in other orders; in bf16 every layer rounds
            tol_max, tol_mean = (1e-4, 1e-4) if dt == "float32" else (5e-2, 5e-3)
            print(f"[tta-vs-plain] fm {fm}, patch 32^3, volume {TTA_SHAPE}, {dt}, TTA mean of "
                  f"16: max |p_card - p_cpu| = {worst:.3g} (tol {tol_max}), mean {mean:.3g} "
                  f"(tol {tol_mean}); card {card_s:.2f} s, CPU {got['seconds']:.2f} s (the "
                  f"CPU-side child, {CPU_SIDE_THREADS} threads)")
            if not (worst <= tol_max and mean <= tol_mean):
                raise AssertionError(f"TTA {dt}: card and CPU differ by max {worst}, "
                                     f"mean {mean}")
            res[dt] = dict(max_abs=worst, mean_abs=mean, card_s=card_s, cpu_s=got["seconds"])
        _CPU_SIDE["pending"].append(finish)
    return res


def phase_template():
    """(d) The repository template
    (templates/semantic_segmentation/3d_semantic_segmentation.yaml) loaded as
    it is, with only the data paths (seeded TIFFs: two training volumes and
    one test volume of 80 x 256 x 256, eight (40, 128, 128) patches each),
    EPOCHS 2 and WARMUP_COSINE_DECAY_EPOCHS 1 changed: trains (resunet
    28/36/48/64, Z_DOWN 1: (1, 2, 2) pool windows, AdamW, warm-up cosine,
    its augmentations), writes its checkpoints and tests to the end."""
    import shutil

    import numpy as np
    import torch
    import yaml  # the template is YAML; PyYAML is optional for the port itself

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.data.tiff import read_tiff, write_tiff
    from biapy_tpu_torch.ops.kernels import build

    root = OUT_DIR / "chip_smoke_template"
    shutil.rmtree(root, ignore_errors=True)
    try:
        g = torch.Generator(device=DEVICE).manual_seed(3)
        for split, n, shape in (("train", 2, TEMPLATE_TRAIN_SHAPE), ("test", 1, TEMPLATE_TEST_SHAPE)):
            for d in ("x", "y"):
                (root / split / d).mkdir(parents=True)
            for i in range(n):
                img, msk = _job_volume(g, shape, DEVICE)
                write_tiff(str(root / split / "x" / f"{split}_{i:03d}.tif"), img)
                write_tiff(str(root / split / "y" / f"{split}_{i:03d}.tif"), msk)
        with open(TEMPLATE) as f:
            cfg = yaml.safe_load(f)
        cfg["DATA"]["TRAIN"].update(PATH=str(root / "train/x"), GT_PATH=str(root / "train/y"))
        cfg["DATA"]["TEST"].update(PATH=str(root / "test/x"), GT_PATH=str(root / "test/y"))
        cfg["TRAIN"]["EPOCHS"] = 2
        cfg["TRAIN"]["LR_SCHEDULER"]["WARMUP_COSINE_DECAY_EPOCHS"] = 1
        job = BiaPy(cfg, result_dir=str(root / "results"), name="template", silent=True)
        job._build_workflow()
        calls = _count_forwards(job.workflow)
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        job.run_job()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        routes = dict(build.CONV3D_ROUTES)
        shuffle_routes = {k: dict(v) for k, v in build.SHUFFLE_ROUTES.items()}
        wf = job.workflow
        hist = wf.history
        ck = sorted(p.name for p in Path(wf.cfg.PATHS.CHECKPOINT).iterdir())
        written = read_tiff(str(Path(wf.cfg.PATHS.RESULT_DIR.PER_IMAGE) / "test_000.tif"))
        if (len(hist) != 2 or not all(np.isfinite(h["loss"]) for h in hist)
                or ck != ["template-checkpoint-1.ckpt", "template-checkpoint-best.ckpt"]
                or written.shape != TEMPLATE_TEST_SHAPE or not np.all(np.isfinite(written))):
            raise AssertionError(f"template: epochs {hist}, checkpoints {ck}, prediction "
                                 f"{written.shape}")
        # conv3d's routes: each the rule names for the model's convs, its
        # counted number of times over every forward (and backward) it ran
        want, want_routes = _expected_launches(wf.model, calls)
        if not (launches["pool_max_folded"] and launches["pool_max_folded_bwd"]
                and launches["zd2s"] == 0 and routes == want_routes
                and launches["pad_channels"] == want["pad_channels"]):
            raise AssertionError(f"template: launches {launches}, conv3d routes {routes}, "
                                 f"want {want_routes} and {want['pad_channels']} pads")
        # every pool, pool backward and zcat of the template on 16-byte vectors
        if not all(launches[k] and shuffle_routes[k]["scalar"] == 0
                   and sum(shuffle_routes[k].values()) == launches[k] for k in shuffle_routes):
            raise AssertionError(f"template: launches {launches}, shuffle routes "
                                 f"{shuffle_routes}")
        print(f"[template] {TEMPLATE.relative_to(REPO)}: resunet {list(wf.cfg.MODEL.FEATURE_MAPS)}, "
              f"Z_DOWN {list(wf.cfg.MODEL.Z_DOWN)}, patch {list(wf.cfg.DATA.PATCH_SIZE)}, "
              f"{wf.cfg.TRAIN.OPTIMIZER[0]}, {len(wf.train_data)} train / {len(wf.val_data)} val "
              f"patches, 2 epochs: run_job {secs:.2f} s (seconds per epoch "
              f"{[round(h['time'], 3) for h in hist]}, loss {[round(h['loss'], 5) for h in hist]}, "
              f"test IoU {wf.stats['iou']:.4f})")
        print(f"[template] launches {launches}; conv3d routes {routes} (as the rule names them "
              f"for the {len(calls)} forwards: bf16 on the tensor cores and the stem kernel, "
              f"float32 on the 3xTF32 kernel); pool and zcat routes {shuffle_routes}")
        return dict(seconds=secs, epoch_seconds=[h["time"] for h in hist], launches=launches,
                    conv3d_routes=routes, shuffle_routes=shuffle_routes, iou=wf.stats["iou"])
    finally:
        shutil.rmtree(root, ignore_errors=True)



# phase 12: the repository's 3D instance-segmentation template on seeded
# TIFFs of non-touching ellipsoid instances, then its test pass card vs CPU
INSTANCE_TEMPLATE = REPO / "templates/instance_segmentation/3d_instance_segmentation.yaml"
INSTANCE_SHAPE, INSTANCE_CROP = (80, 256, 256), (40, 256, 256)
INSTANCE_COUNT = 40  # ellipsoids per volume


def _ellipsoids(shape, n, seed):
    """A uint8 volume of ``n`` seeded non-touching ellipsoids (semi-axes 3-7
    voxels in z, 6-14 in y and x, at least two voxels apart), bright in
    noise, and its uint16 instance labels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lab = np.zeros(shape, np.uint16)
    placed = 0
    for _ in range(50 * n):
        if placed == n:
            break
        ax = rng.uniform((3, 6, 6), (7, 14, 14))
        c = [rng.uniform(a + 1, s - a - 1) for a, s in zip(ax, shape)]
        lo = [max(0, int(ci - ai) - 3) for ci, ai in zip(c, ax)]
        hi = [min(s, int(ci + ai) + 4) for ci, ai, s in zip(c, ax, shape)]
        grid = np.ogrid[tuple(slice(a, b) for a, b in zip(lo, hi))]
        r = sum(((g - ci) / ai) ** 2 for g, ci, ai in zip(grid, c, ax))
        near = sum(((g - ci) / (ai + 2)) ** 2 for g, ci, ai in zip(grid, c, ax)) < 1
        box = lab[tuple(slice(a, b) for a, b in zip(lo, hi))]
        if box[near].any():
            continue
        placed += 1
        box[r < 1] = placed
    img = 50 + 120 * (lab > 0) + rng.normal(0, 25, shape)
    return img.clip(0, 255).astype(np.uint8), lab


def _timed(fn, sink):
    """``fn`` that appends each call's host seconds to ``sink``."""
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sink.append(time.perf_counter() - t0)
        return out
    return run


def phase_instance_template():
    """(a) templates/instance_segmentation/3d_instance_segmentation.yaml as it
    is but for its data (two 80 x 256 x 256 training volumes and one test
    volume of seeded non-touching ellipsoids, with their instance labels),
    EPOCHS 2 and WARMUP_COSINE_DECAY_EPOCHS 1, through ``run_job``: the B/C/D
    compile, training with the template's augmentations (rotated samples
    recompile D from the warped labels), the bf16 test pass, the watershed,
    the instance TIFF and the matching against the GT. Compile seconds per
    volume, the loop's patches/s, regeneration seconds per rotated sample,
    test Mvox/s from disk with its predict and watershed seconds, matching
    F1, peak memory and launches by kernel and route. (b) The best
    checkpoint's test pass on a 40 x 256 x 256 crop on the card and on the
    CPU, float32 and bf16: channel maps within the serving tolerances, the
    instances compared by matching. (c) The best checkpoint by chunks with the
    template's BY_CHUNKS block (``_instance_by_chunks``)."""
    import shutil

    import numpy as np
    import torch
    import yaml  # the template is YAML; PyYAML is optional for the port itself

    from biapy_tpu_torch import BiaPy, native
    from biapy_tpu_torch.data import pre_processing
    from biapy_tpu_torch.data.patching import axis_grid
    from biapy_tpu_torch.data.tiff import read_tiff, write_tiff
    from biapy_tpu_torch.engine import instance_seg
    from biapy_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    native._load()  # g++ on first use: the watershed, EDT and components
    native_s = time.perf_counter() - t0
    root = OUT_DIR / "chip_smoke_instance"
    shutil.rmtree(root, ignore_errors=True)
    compile_s, regen_s = [], []
    plain_compile, plain_regen = instance_seg.labels_into_channels, \
        pre_processing.labels_into_channels
    deferred = False
    try:
        vols = {}
        for split, n in (("train", 2), ("test", 1)):
            for d in ("x", "y"):
                (root / split / d).mkdir(parents=True)
            for i in range(n):
                img, lab = _ellipsoids(INSTANCE_SHAPE, INSTANCE_COUNT, seed=len(vols))
                write_tiff(str(root / split / "x" / f"{split}_{i:03d}.tif"), img)
                write_tiff(str(root / split / "y" / f"{split}_{i:03d}.tif"), lab)
                vols[(split, i)] = (img, lab)
        with open(INSTANCE_TEMPLATE) as f:
            cfg = yaml.safe_load(f)
        cfg["DATA"]["TRAIN"].update(PATH=str(root / "train/x"), GT_PATH=str(root / "train/y"))
        cfg["DATA"]["TEST"].update(PATH=str(root / "test/x"), GT_PATH=str(root / "test/y"))
        cfg["TRAIN"]["EPOCHS"] = 2
        cfg["TRAIN"]["LR_SCHEDULER"]["WARMUP_COSINE_DECAY_EPOCHS"] = 1
        # the compile (the workflow's own name) and the train-time
        # regeneration (the channel handler's, bound when the handler is
        # built) timed apart
        instance_seg.labels_into_channels = _timed(plain_compile, compile_s)
        pre_processing.labels_into_channels = _timed(plain_regen, regen_s)
        job = BiaPy(cfg, result_dir=str(root / "results"), name="instance", silent=True)
        job._build_workflow()
        wf = job.workflow
        calls = _count_forwards(wf)
        loop_s, predict_s, ws_s, train_s, test_s = [], [], [], [], []
        step_launches = []

        def one_epoch(*args, _plain=wf.train_one_epoch, **kwargs):
            before = dict(build.LAUNCHES)
            out = _timed(_plain, loop_s)(*args, **kwargs)
            step_launches.append({k: v - before[k] for k, v in build.LAUNCHES.items()})
            return out

        wf.train_one_epoch = one_epoch
        wf.predict_block_on_device = _timed(wf.predict_block_on_device, predict_s)
        wf.instance_seg_process = _timed(wf.instance_seg_process, ws_s)
        wf.train = _timed(wf.train, train_s)
        wf.test = _timed(wf.test, test_s)
        torch.cuda.synchronize()
        build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        job.run_job()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = dict(build.LAUNCHES)
        routes = dict(build.CONV3D_ROUTES)
        shuffle_routes = {k: dict(v) for k, v in build.SHUFFLE_ROUTES.items()}
        hist = wf.history
        ck = sorted(p.name for p in Path(wf.cfg.PATHS.CHECKPOINT).iterdir())
        inst = read_tiff(str(Path(wf.cfg.PATHS.RESULT_DIR.PER_IMAGE_INSTANCES) / "test_000.tif"))
        raw = read_tiff(str(Path(wf.cfg.PATHS.RESULT_DIR.PER_IMAGE) / "test_000.tif"))
        stats = {s["thresh"]: s for s in wf.matching_stats}
        if (len(hist) != 2 or not all(np.isfinite(h["loss"]) for h in hist)
                or ck != ["instance-checkpoint-1.ckpt", "instance-checkpoint-best.ckpt"]
                or inst.shape != INSTANCE_SHAPE or raw.shape != INSTANCE_SHAPE + (3,)
                or not np.all(np.isfinite(raw)) or sorted(stats) != [0.3, 0.5, 0.75]):
            raise AssertionError(f"instance template: epochs {hist}, checkpoints {ck}, "
                                 f"instances {inst.shape}, channel maps {raw.shape}, "
                                 f"matching {sorted(stats)}")
        want, want_routes = _expected_launches(wf.model, calls)
        if not (launches["conv3d"] and routes == want_routes
                and launches["pad_channels"] == want["pad_channels"]
                and launches["zd2s"] == 0 and launches["zs2d"] == 0):
            raise AssertionError(f"instance template: launches {launches}, routes {routes}, "
                                 f"want {want_routes} and {want['pad_channels']} pads")
        # every pool, pool backward and zcat of the template on 16-byte vectors
        if not all(launches[k] and shuffle_routes[k]["scalar"] == 0
                   and sum(shuffle_routes[k].values()) == launches[k] for k in shuffle_routes):
            raise AssertionError(f"instance template: launches {launches}, shuffle routes "
                                 f"{shuffle_routes}")
        if not regen_s:
            raise AssertionError("instance template: no training sample was regenerated")
        ps = tuple(wf.cfg.DATA.PATCH_SIZE)[:3]
        pad = tuple(wf.cfg.DATA.TEST.PADDING)
        n_patches = int(np.prod([axis_grid(n, p, 0.0, q).n
                                 for n, p, q in zip(INSTANCE_SHAPE, ps, pad)]))
        steps = len(wf.train_loader)
        bs = int(wf.cfg.TRAIN.BATCH_SIZE)
        per_step = {k: v / steps for k, v in step_launches[-1].items() if v}
        vox = float(np.prod(INSTANCE_SHAPE))
        res = dict(
            seconds=secs, native_build_seconds=native_s,
            compile_seconds_per_volume=compile_s, epoch_seconds=[h["time"] for h in hist],
            loop_seconds=loop_s, loop_patches_per_s=[steps * bs / t for t in loop_s],
            regen_count=len(regen_s), regen_seconds_mean=float(np.mean(regen_s)),
            regen_seconds_max=float(np.max(regen_s)), train_seconds=train_s[0],
            test_seconds=test_s[0], test_mvox_s=vox / test_s[0] / 1e6,
            predict_seconds=predict_s, watershed_seconds=ws_s,
            matching={str(t): {k: stats[t][k] for k in ("f1", "precision", "recall", "tp",
                                                       "fp", "fn")} for t in stats},
            n_instances=int(inst.max()), n_gt=int(vols[("test", 0)][1].max()),
            peak_bytes=peak, launches=launches, conv3d_routes=routes,
            shuffle_routes=shuffle_routes, launches_per_step=per_step, steps_per_epoch=steps,
            test_patches=n_patches, loss=[h["loss"] for h in hist],
            train_patches=len(wf.train_data), val_patches=len(wf.val_data))
        print(f"[instance] {INSTANCE_TEMPLATE.relative_to(REPO)}: codes "
              f"{list(wf.cfg.PROBLEM.INSTANCE_SEG.DATA_CHANNELS)}, resunet "
              f"{list(wf.cfg.MODEL.FEATURE_MAPS)}, patch {list(wf.cfg.DATA.PATCH_SIZE)}, "
              f"{len(wf.train_data)} train / {len(wf.val_data)} val patches, 2 epochs: run_job "
              f"{secs:.2f} s (train {train_s[0]:.2f}, test {test_s[0]:.2f}); native g++ build "
              f"{native_s:.2f} s")
        print(f"[instance] compile s per volume {[round(t, 3) for t in compile_s]}; loop s per "
              f"epoch {[round(t, 3) for t in loop_s]} ({[round(v, 2) for v in res['loop_patches_per_s']]} "
              f"patches/s), epoch s {[round(h['time'], 3) for h in hist]}, loss "
              f"{[round(h['loss'], 5) for h in hist]}; regeneration {len(regen_s)} rotated "
              f"samples, {res['regen_seconds_mean']:.4f} s mean, {res['regen_seconds_max']:.4f} "
              f"max (loader threads)")
        print(f"[instance] test from disk {res['test_mvox_s']:.3f} Mvox/s "
              f"({vox / 1e6:.2f} Mvox, {n_patches} patches, bf16): predict "
              f"{[round(t, 3) for t in predict_s]} s, watershed and post-processing "
              f"{[round(t, 3) for t in ws_s]} s; {res['n_instances']} instances against "
              f"{res['n_gt']} in the GT; matching " + ", ".join(
                  f"F1@{t} {stats[t]['f1']:.4f}" for t in sorted(stats))
              + f"; peak memory {peak / 2**30:.2f} GiB")
        print(f"[instance] launches {launches}; per training step {per_step}; conv3d routes "
              f"{routes}; pool and zcat routes {shuffle_routes}")
        best = str(Path(wf.cfg.PATHS.CHECKPOINT) / "instance-checkpoint-best.ckpt")
        crop = vols[("test", 0)][0][: INSTANCE_CROP[0]]
        # the data and the checkpoint stay until the comparison has run
        _instance_card_vs_cpu(cfg, best, crop, root, res,
                              lambda: shutil.rmtree(root, ignore_errors=True))
        deferred = True
        instance_seg.labels_into_channels = plain_compile
        pre_processing.labels_into_channels = plain_regen
        res["by_chunks"] = _instance_by_chunks(cfg, best, vols[("test", 0)][0], root)
        return res
    finally:
        instance_seg.labels_into_channels = plain_compile
        pre_processing.labels_into_channels = plain_regen
        if not deferred:
            shutil.rmtree(root, ignore_errors=True)


def _instance_card_vs_cpu(cfg, ckpt, crop, root, res, cleanup):
    """(b) ``predict`` of the best checkpoint on ``crop`` on the card and on
    the CPU (plain versions, in the CPU-side child), float32 and bf16 (the
    template's TEST.REDUCE_MEMORY): the channel maps against each other and
    each bf16 map against the card's float32 one, the instances compared by
    matching at IoU 0.5. The comparison runs after the last phase, puts its
    result in ``res["vs_plain"]`` and then calls ``cleanup``."""
    import copy

    import numpy as np

    from biapy_tpu_torch import BiaPy

    runs, cpu = {}, {}
    for dt, reduce_mem in (("float32", False), ("bfloat16", True)):
        c = copy.deepcopy(cfg)
        c["TRAIN"]["ENABLE"] = False
        c["MODEL"]["LOAD_CHECKPOINT"] = True
        c["PATHS"] = {"CHECKPOINT_FILE": ckpt}
        c["TEST"]["REDUCE_MEMORY"] = reduce_mem
        cpu[dt] = _cpu_side("_cpu_predict", cfg=c, vol=crop, result_dir=str(root / "vs_plain"),
                            name=f"{dt}_cpu")
        job = BiaPy(c, result_dir=str(root / "vs_plain"), name=f"{dt}_card", silent=True,
                    device=DEVICE)
        t0 = time.perf_counter()
        preds = {p["role"]: p for p in job.predict(crop)}
        runs[dt, "card"] = (np.asarray(preds["raw"]["pred"], np.float32),
                            preds["instances"]["instances"].astype(np.int32),
                            time.perf_counter() - t0)

    def finish():
        try:
            for dt in ("float32", "bfloat16"):
                got = cpu[dt]()
                preds = {p["role"]: p for p in got["preds"]}
                runs[dt, "cpu"] = (np.asarray(preds["raw"]["pred"], np.float32),
                                   preds["instances"]["instances"].astype(np.int32),
                                   got["seconds"])
            res["vs_plain"] = _instance_compare(runs, crop)
        finally:
            cleanup()
    _CPU_SIDE["pending"].append(finish)


def _instance_compare(runs, crop):
    import numpy as np

    from biapy_tpu_torch.utils.matching import matching

    ref = runs["float32", "card"][0]
    out = {}
    for dt in ("float32", "bfloat16"):
        (m_card, i_card, s_card), (m_cpu, i_cpu, s_cpu) = runs[dt, "card"], runs[dt, "cpu"]
        diff = np.abs(m_card - m_cpu)
        worst, mean = float(diff.max()), float(diff.mean())
        at = np.unravel_index(int(np.argmax(diff)), diff.shape)
        f1 = matching(i_cpu, i_card, thresh=[0.5])[0]["f1"] if i_cpu.max() else 1.0
        n_diff = int(np.count_nonzero(i_card != i_cpu))
        to_ref = {side: np.abs(runs[dt, side][0] - ref) for side in ("card", "cpu")}
        inst_ref = runs["float32", "card"][1]
        f1_ref = {side: matching(inst_ref, runs[dt, side][1], thresh=[0.5])[0]["f1"]
                  for side in ("card", "cpu")}
        out[dt] = dict(max_abs=worst, mean_abs=mean, worst_at=[int(v) for v in at],
                       worst_values=[float(m_card[at]), float(m_cpu[at]), float(ref[at])],
                       max_abs_by_channel=[float(v) for v in diff.reshape(-1, diff.shape[-1])
                                           .max(0)],
                       f1=f1, voxels_differ=n_diff,
                       n_instances=[int(i_card.max()), int(i_cpu.max())], card_s=s_card,
                       cpu_s=s_cpu,
                       to_f32={side: dict(max_abs=float(e.max()), mean_abs=float(e.mean()),
                                          p9999=float(np.quantile(e, 0.9999)),
                                          instances_f1=f1_ref[side])
                               for side, e in to_ref.items()})
        r = out[dt]
        print(f"[instance-vs-plain] best checkpoint, crop {tuple(crop.shape)}, {dt}: max "
              f"|p_card - p_cpu| = {worst:.3g} at {r['worst_at']} (card, CPU, float32 card: "
              f"{[round(v, 4) for v in r['worst_values']]}; by channel "
              f"{[float(f'{v:.3g}') for v in r['max_abs_by_channel']]}), mean {mean:.3g}; "
              f"against the card's float32 map: card max {r['to_f32']['card']['max_abs']:.3g} "
              f"mean {r['to_f32']['card']['mean_abs']:.3g} (instances F1@0.5 "
              f"{f1_ref['card']:.4f}), CPU max {r['to_f32']['cpu']['max_abs']:.3g} mean "
              f"{r['to_f32']['cpu']['mean_abs']:.3g} ({f1_ref['cpu']:.4f}); "
              f"instances {r['n_instances'][0]} card / {r['n_instances'][1]} CPU, matching "
              f"F1@0.5 {f1:.4f}, {n_diff} voxels differ; card {s_card:.2f} s, CPU {s_cpu:.2f} s "
              f"(the CPU-side child, {CPU_SIDE_THREADS} threads)")
    # float32: the serving tolerance and the same instances. bf16: the
    # serving mean; in place of its 5e-2 worst voxel, the card's bf16 map no
    # farther from the float32 one than the plain bf16 path's (the trained
    # template's D logits sit where one bf16 rounding moves tanh by 0.2 on
    # either device: PERF.md §6)
    f, b = out["float32"], out["bfloat16"]
    card, cpu = b["to_f32"]["card"], b["to_f32"]["cpu"]
    if not (f["max_abs"] <= 1e-4 and f["mean_abs"] <= 1e-4 and f["f1"] >= 0.99
            and b["mean_abs"] <= 5e-3 and card["max_abs"] <= 1.5 * cpu["max_abs"]
            and card["mean_abs"] <= 1.2 * cpu["mean_abs"]):
        raise AssertionError(f"instance test pass: card and CPU differ: {out}")
    return out


# phase 12 c: the template's BY_CHUNKS block on the test volume's first 72 x
# 192 x 192 voxels, a whole number of the 24 x 96 x 96 cores (patch 40 x 128 x
# 128 less twice the padding 8 x 16 x 16; PATCHES_PER_TILE 1 x 1 x 1): 3 x 2 x 2
# tiles, cut in z, y and x. The in-memory stitch spreads its patches to end
# at the volume's edge and tiles step by the core, so the two grids coincide
# only on whole cores (phase 13's DET_CHUNK_SHAPE)
INSTANCE_CHUNK_SHAPE = (72, 192, 192)


def _plain_instance_merge(raw_path, instance_fn, tile, halo, iou_th, min_size):
    """The by-chunks instance merge written plainly: each tile's labels from
    ``instance_fn`` over its core and halo of the raw prediction, offset by
    the tile maxima before it in tile order; an edge between two ids of
    adjacent cores whose IoU over the touching faces reaches ``iou_th``;
    scipy's connected components over ids 0..n (numbered in the order of
    each component's smallest id, the order the merge's compaction keeps);
    then, with ``min_size``, the merged instances below it dropped and the
    ids compacted again."""
    from itertools import product

    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from biapy_tpu_torch.data.zarr_store import ZarrArray
    from biapy_tpu_torch.engine.chunked import dequant_pred

    raw = ZarrArray(str(raw_path))
    shape = tuple(raw.shape[:3])
    counts = [-(-n // t) for n, t in zip(shape, tile)]
    out = np.zeros(shape, np.int64)
    total = 0
    cores = {}
    for idx in product(*(range(c) for c in counts)):  # C order: sorted tile order
        cs = [i * t for i, t in zip(idx, tile)]
        ce = [min(n, c + t) for n, c, t in zip(shape, cs, tile)]
        hs = [max(0, c - h) for c, h in zip(cs, halo)]
        he = [min(n, c + h) for n, c, h in zip(shape, ce, halo)]
        lab = np.asarray(instance_fn(dequant_pred(raw[tuple(slice(a, b) for a, b in
                                                               zip(hs, he)) + (slice(None),)])))
        core = lab[tuple(slice(c - h, e - h) for c, e, h in zip(cs, ce, hs))].astype(np.int64)
        sl = tuple(slice(c, e) for c, e in zip(cs, ce))
        out[sl] = np.where(core > 0, core + total, 0)
        total += int(core.max())
        cores[idx] = sl
    pairs = []
    for idx, sl in cores.items():
        for d in range(3):
            nb = tuple(v + (k == d) for k, v in enumerate(idx))
            if nb not in cores:
                continue
            face_a = tuple(slice(s.stop - 1, s.stop) if k == d else s for k, s in enumerate(sl))
            face_b = tuple(slice(cores[nb][d].start, cores[nb][d].start + 1) if k == d else s
                           for k, s in enumerate(sl))
            a, b = out[face_a].ravel(), out[face_b].ravel()
            area_a = np.bincount(a, minlength=total + 1)
            area_b = np.bincount(b, minlength=total + 1)
            both = (a > 0) & (b > 0)
            codes, inter = np.unique(a[both] * (total + 1) + b[both], return_counts=True)
            ia, ib = codes // (total + 1), codes % (total + 1)
            iou = inter / np.maximum(area_a[ia] + area_b[ib] - inter, 1)
            pairs += [(int(x), int(y)) for x, y in zip(ia[iou >= iou_th], ib[iou >= iou_th])]
    e = np.asarray(pairs, np.int64).reshape(-1, 2)
    graph = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(total + 1, total + 1))
    _, comp = connected_components(graph, directed=False)
    merged = comp[out]
    if min_size > 0:
        sizes = np.bincount(merged.ravel())
        keep = sizes >= min_size
        keep[0] = False
        ids = np.zeros(len(sizes), np.int64)
        ids[keep] = np.arange(1, int(keep.sum()) + 1)
        merged = ids[merged]
    return merged.astype(np.int32), total, len(pairs)


def _instance_by_chunks(cfg, ckpt, vol, root, plain_merge=True):
    """(c) ``TEST.BY_CHUNKS`` as the template's commented block has it
    (ENABLE: True, the defaults: PATCHES_PER_TILE 1 x 1 x 1, IoU 0.3; bf16
    under the template's REDUCE_MEMORY), from ``ckpt`` on ``vol``'s first
    INSTANCE_CHUNK_SHAPE voxels written as a uint8 Zarr, through
    ``BiaPy(cfg).test()``; the normalisation statistics the volume's own,
    fixed (a tile is otherwise normalised by its own). The raw prediction
    within 1 uint8 LSB of ``predict`` on the volume in memory (phase 10's
    rule); the merged ``instances.zarr`` equal, id for id, to
    ``_plain_instance_merge`` over the same raw prediction (unless
    ``plain_merge`` is off: phase 18 holds the merge no second time);
    launches equal to the model's count for the forwards it ran. The
    seconds of each merge pass, Mvox/s and the ids before and after the
    merge printed."""
    import copy

    import numpy as np
    import torch

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.data.zarr_store import ZarrArray
    from biapy_tpu_torch.engine.chunked import tile_grid
    from biapy_tpu_torch.ops.kernels import build

    t_phase = time.perf_counter()
    crop = np.ascontiguousarray(vol[tuple(slice(0, n) for n in INSTANCE_CHUNK_SHAPE)])
    test_dir = root / "chunks" / "test"
    test_dir.mkdir(parents=True)
    z = ZarrArray.create(str(test_dir / "vol.zarr"), shape=crop.shape + (1,),
                         chunks=(24, 96, 96, 1), dtype="u1", compressor={"id": "zlib", "level": 1})
    z[:, :, :, :] = crop[..., None]
    c = copy.deepcopy(cfg)
    c["TRAIN"]["ENABLE"] = False
    c["MODEL"]["LOAD_CHECKPOINT"] = True
    c["PATHS"] = {"CHECKPOINT_FILE": ckpt}
    c["DATA"]["TEST"].update(PATH=str(test_dir), LOAD_GT=False, IN_MEMORY=False)
    c["DATA"]["NORMALIZATION"] = _fixed_stats(crop)
    c["TEST"]["BY_CHUNKS"] = {"ENABLE": True}
    job = BiaPy(c, result_dir=str(root / "chunks_results"), name="instance_chunks", silent=True)
    job._build_workflow()
    wf = job.workflow
    calls = _count_forwards(wf)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    job.test()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, routes = dict(build.LAUNCHES), dict(build.CONV3D_ROUTES)
    want, want_routes = _expected_launches(wf.model, calls)
    ci = wf.last_chunked
    merge = ci.last_merge_stats
    (inst,) = [p for p in wf._predictions if p["role"] == "instances_zarr"]
    raw_path = Path(inst["path"]).parent / "raw_pred.zarr"
    got = np.asarray(ZarrArray(inst["path"])[:])
    t0 = time.perf_counter()
    if plain_merge:
        plain, plain_ids, plain_edges = _plain_instance_merge(
            raw_path, wf._instance_fn_no_size_filter, ci.tile_size, ci.halo,
            float(wf.cfg.TEST.BY_CHUNKS.WORKFLOW_PROCESS.INSTANCE_SEG_MERGE_IOU_TH), 0)
    else:
        plain, plain_ids, plain_edges = got, merge["ids_before"], None
    plain_s = time.perf_counter() - t0
    # the same volume in memory
    m = copy.deepcopy(c)
    m["TEST"].pop("BY_CHUNKS")
    jm = BiaPy(m, result_dir=str(root / "chunks_results"), name="instance_memory", silent=True)
    jm._build_workflow()
    calls_m = _count_forwards(jm.workflow)
    build.reset_launches()
    t0 = time.perf_counter()
    mem = {p["role"]: p for p in jm.predict(crop)}
    torch.cuda.synchronize()
    mem_s = time.perf_counter() - t0
    launches_m, routes_m = dict(build.LAUNCHES), dict(build.CONV3D_ROUTES)
    want_m, want_routes_m = _expected_launches(jm.workflow.model, calls_m)
    raw = np.asarray(ZarrArray(str(raw_path))[:], np.float32)
    diff = np.abs(raw - np.asarray(mem["raw"]["pred"], np.float32).reshape(raw.shape))
    n_tiles = len(tile_grid(crop.shape, ci.tile_size, ci.halo))
    vox = float(np.prod(crop.shape))
    res = dict(shape=list(crop.shape), tile=list(ci.tile_size), n_tiles=n_tiles, seconds=secs,
               mvox_s=vox / secs / 1e6, merge_pass_seconds=merge["pass_seconds"],
               ids_before=merge["ids_before"], ids_after=merge["ids_after"],
               n_instances=int(len(np.unique(got)) - 1), edges=merge["edges"],
               plain_ids=plain_ids, plain_edges=plain_edges, plain_seconds=plain_s,
               same_as_plain=bool(np.array_equal(got, plain)),
               raw_max_abs=float(diff.max()), raw_voxels_differ=int(np.count_nonzero(diff)),
               memory_seconds=mem_s, launches=launches, conv3d_routes=routes,
               memory_launches=launches_m,
               drain=wf.last_chunked.last_drain_stats)
    print(f"[instance-chunks] {tuple(crop.shape)} uint8 Zarr, {n_tiles} tiles of "
          f"{tuple(ci.tile_size)} (halo {tuple(ci.halo)}), bf16: test() {secs:.2f} s, "
          f"{res['mvox_s']:.3f} Mvox/s; merge passes s "
          f"{ {k: round(v, 3) for k, v in merge['pass_seconds'].items()} }, ids "
          f"{merge['ids_before']} tile-local -> {merge['ids_after']} merged "
          f"({res['n_instances']} instances, {merge['edges']} edges); "
          + (f"the plain merge (connected components) {plain_s:.2f} s, the same ids: "
             f"{res['same_as_plain']}; " if plain_merge else "")
          + f"raw "
          f"prediction against predict() in memory ({mem_s:.2f} s): max "
          f"{res['raw_max_abs']:.3g} ({res['raw_voxels_differ']} voxels differ); launches "
          f"{launches}")
    cut = all(n > t for n, t in zip(crop.shape, ci.tile_size))  # tiles cut z, y and x
    if not (cut and res["same_as_plain"] and plain_ids == merge["ids_before"]
            and diff.max() <= 1 / 255 + 1e-6 and merge["ids_before"] > merge["ids_after"] > 0
            and launches == want and routes == want_routes and launches_m == want_m
            and routes_m == want_routes_m):
        raise AssertionError(f"instance by chunks: {res}; launches want {want} {want_routes}, "
                             f"in memory {launches_m} {routes_m} want {want_m} {want_routes_m}")
    res["phase_seconds"] = time.perf_counter() - t_phase
    return res


# phase 13: point detection -- the repository's 3D detection template on
# seeded blob volumes with CSV points, by chunks, and the instance workflow's
# synapse mode on seeded CREMI-layout Zarrs
DETECTION_TEMPLATE = REPO / "templates/detection/3d_detection.yaml"
DET_SHAPE, DET_CHUNK_SHAPE, DET_CROP = (80, 256, 256), (168, 512, 512), (20, 256, 256)
DET_BLOBS = 150  # blobs per 80 x 256 x 256 volume
# PATCHES_PER_TILE by chunks. The in-memory stitch spreads its patches to
# end at the volume's edge (``data/patching.py::axis_grid``: at 512 in y and
# x a step of 84 for a 96-voxel core), tiles step by the core: the two grids
# only coincide where the tile holds the whole axis, or where the axis is a
# whole number of cores. At 160 in z (not a multiple of the 12-voxel core)
# the stitch shifts its last patch back by 8 and the last tile spreads two
# patches over 16 slices, and the heatmaps part there by up to 0.11 in bf16;
# 168 is 14 cores. Tiles of 24 x 576 x 576 cores: seven in z, one in y and x
DET_TILE = [2, 6, 6]
SYN_SHAPE, SYN_PAIRS = (72, 256, 256), 60  # 72: three 24-voxel cores in z
# synful is tested on a smaller CREMI volume: its decode clusters every post
# by scipy's single linkage, which holds all pairs, and an undertrained
# model's tens of thousands of posts on the 72 x 256 x 256 volume would take
# tens of GB
SYN_SMALL_SHAPE, SYN_SMALL_PAIRS = (48, 128, 128), 10
SYN_RESOLUTION = [40, 4, 4]  # nm per voxel, CREMI's
SYN_TILE = [1, 3, 3]  # 24 x 288 x 288 cores: three in z, one in y and x
SYN_METHODS = {"simpsyn": ["F_pre", "F_post"], "synful": ["F_post", "Z", "V", "H"],
               "cleft": ["F_cleft"], "F_post_only": ["F_post"]}
# synful's offset region around each post: 1 x 6 x 6 rather than the default
# 3 x 25 x 25, whose binary dilation takes seconds a site on the host
SYN_EXTRA = {"synful": {"H": {"dilation": [1, 6, 6]}}}
# the synapse test's point settings: a manual threshold (Otsu's would differ
# between a volume and its tiles) and peak_local_max's min_distance 1 (above
# 1 it suppresses greedily in peak order, as the close-point removal does)
SYN_POINTS = {"TH_TYPE": "manual", "MIN_TH_TO_BE_PEAK": 0.5, "PEAK_LOCAL_MAX_MIN_DISTANCE": 1,
              "REMOVE_CLOSE_PRE_POINTS_RADIUS": 3, "REMOVE_CLOSE_POST_POINTS_RADIUS": 3}


def _blob_volume(shape, n, seed):
    """A uint8 volume of ``n`` seeded Gaussian blobs (sigma 2-3 voxels, each
    in its own window) in noise, and the blob centres."""
    import numpy as np

    rng = np.random.default_rng(seed)
    heat = np.zeros(shape, np.float32)
    centres = np.stack([rng.integers(3, s - 3, n) for s in shape], axis=1)
    for c in centres:
        sigma = rng.uniform(2.0, 3.0)
        r = int(3 * sigma) + 1
        box = tuple(slice(max(0, ci - r), min(s, ci + r + 1)) for ci, s in zip(c, shape))
        grid = np.ogrid[box]
        d2 = sum((g - ci) ** 2 for g, ci in zip(grid, c))
        heat[box] = np.maximum(heat[box], np.exp(-0.5 * d2 / sigma ** 2))
    img = 40 + 160 * heat + rng.normal(0, 20, shape)
    return img.clip(0, 255).astype(np.uint8), centres


def _points_csv(path, pts):
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["axis-0", "axis-1", "axis-2"])
        w.writerows([int(v) for v in p] for p in pts)


def _cremi_zarr(path, shape, n_pairs, seed):
    """A seeded CREMI-layout Zarr (the layout of
    tests/test_synapses.py::_make_cremi): uint8 ``volumes/raw`` with its
    ``resolution`` attribute, bright blobs at pre sites and dimmer ones at
    post sites, ``annotations/{ids,partners,locations}`` in nm."""
    import numpy as np

    from biapy_tpu_torch.data.zarr_store import ZarrGroup

    rng = np.random.default_rng(seed)
    raw = rng.normal(40, 12, shape).astype(np.float32)
    ids, partners, locations = [], [], []
    for k in range(n_pairs):
        pre = np.array([rng.integers(4, shape[0] - 4), rng.integers(10, shape[1] - 10),
                        rng.integers(10, shape[2] - 10)])
        off = np.array([rng.integers(-1, 2), rng.integers(-5, 6), rng.integers(-5, 6)])
        post = np.clip(pre + off, 3, np.array(shape) - 4)
        for site, amp in ((pre, 150.0), (post, 80.0)):
            box = tuple(slice(max(0, c - r), min(s, c + r + 1))
                        for c, r, s in zip(site, (2, 6, 6), shape))
            zz, yy, xx = np.ogrid[box]
            d2 = ((zz - site[0]) * 4.0) ** 2 + (yy - site[1]) ** 2 + (xx - site[2]) ** 2
            raw[box] += amp * np.exp(-d2 / 6.0)
        ids += [2 * k + 1, 2 * k + 2]
        partners.append([2 * k + 1, 2 * k + 2])
        locations += [pre * SYN_RESOLUTION, post * SYN_RESOLUTION]
    g = ZarrGroup.create(str(path))
    a = g.create_dataset("volumes/raw", shape=shape, chunks=(40, 128, 128), dtype="uint8",
                         compressor={"id": "zlib", "level": 1})
    a[:, :, :] = raw.clip(0, 255).astype(np.uint8)
    a.attrs["resolution"] = SYN_RESOLUTION
    for name, arr, dt in (("ids", np.asarray(ids), "int64"),
                          ("partners", np.asarray(partners), "int64"),
                          ("locations", np.asarray(locations, np.float64), "float64")):
        d = g.create_dataset(f"annotations/{name}", shape=arr.shape, chunks=arr.shape, dtype=dt)
        d[tuple(slice(None) for _ in arr.shape)] = arr


def _fixed_stats(vol):
    """DATA.NORMALIZATION with ``vol``'s mean and standard deviation fixed
    (zero_mean_unit_variance, the default type)."""
    import numpy as np

    v = np.asarray(vol, np.float64)
    return {"TYPE": "zero_mean_unit_variance",
            "ZERO_MEAN_UNIT_VAR": {"MEAN_VAL": [float(v.mean())], "STD_VAL": [float(v.std())]}}


def _core_boundary_diff(a, b, tile, margin):
    """Points of ``a`` and ``b`` (rounded to voxels) that only one of them
    holds, and how many of those lie farther than ``margin`` voxels from
    every interior tile core boundary."""
    import numpy as np

    sa = {tuple(int(round(v)) for v in p) for p in np.asarray(a).reshape(-1, 3)}
    sb = {tuple(int(round(v)) for v in p) for p in np.asarray(b).reshape(-1, 3)}
    diff = sa ^ sb
    far = [p for p in diff
           if all(min(v % t, t - v % t) > margin for v, t in zip(p, tile))]
    return len(diff), len(far)


def _tile_points(check_dir, pattern):
    """The union of the per-tile point CSVs that by chunks writes before the
    merge."""
    import numpy as np

    from biapy_tpu_torch.engine.detection import read_points_csv

    files = sorted(Path(check_dir).glob(pattern))
    pts = [read_points_csv(str(f), 3) for f in files]
    return (np.concatenate(pts) if pts else np.zeros((0, 3), np.float32)), len(files)


def _same_points(a, b):
    """The same points, each as often, in any order."""
    import numpy as np

    a = np.asarray(a, np.float64).reshape(-1, 3)
    b = np.asarray(b, np.float64).reshape(-1, 3)
    return a.shape == b.shape and np.array_equal(a[np.lexsort(a.T[::-1])],
                                                 b[np.lexsort(b.T[::-1])])


def _detection_post(cfg, shape):
    """The detection workflow's whole-volume post steps, written out as a
    function of the candidate points: the border box, then the close-point
    removal at the test resolution."""
    import numpy as np

    from biapy_tpu_torch.data.post_processing import remove_close_points
    from biapy_tpu_torch.engine.detection import _filter_bbox, _test_resolution

    pp = cfg.TEST.POST_PROCESSING

    def post(cands):
        c = _filter_bbox(np.asarray(cands), cfg.TEST.DET_IGNORE_POINTS_OUTSIDE_BOX, shape, 3)
        if pp.REMOVE_CLOSE_POINTS and len(c):
            c = remove_close_points(c, float(pp.REMOVE_CLOSE_POINTS_RADIUS),
                                    resolution=_test_resolution(cfg, 3))
        return c

    return post


def _hold_by_chunks(wf_chunks, heat_mem, pts_mem, pts_chunks, cands_mem, pattern, min_distance,
                    post, candidates_match=True):
    """By chunks against in memory on one volume: the heatmaps within 1 uint8
    LSB (phase 10's rule); each tile's candidate points (before the close-point
    removal) against the whole volume's, equal but within ``min_distance`` of
    a tile core boundary; the points after the whole-volume post steps exactly
    ``post`` of each side's own candidates: by chunks the per-tile CSVs
    concatenated in tile order (the merge's order), in memory the volume's in
    peak order. The two orders keep other points of a dense candidate set,
    far from any boundary too: those are counted, not failed."""
    import numpy as np

    from biapy_tpu_torch.data.zarr_store import ZarrArray
    from biapy_tpu_torch.engine.chunked import dequant_pred

    raw = Path(wf_chunks.cfg.PATHS.RESULT_DIR.PER_IMAGE) / "vol_chunks" / "raw_pred.zarr"
    heat = dequant_pred(ZarrArray(str(raw))[:])
    diff = np.abs(heat - np.asarray(heat_mem, np.float32).reshape(heat.shape))
    tile = wf_chunks.last_chunked.tile_size
    cands_chunks, n_tiles = _tile_points(wf_chunks.cfg.PATHS.RESULT_DIR.DET_LOCAL_MAX_COORDS_CHECK,
                                         pattern)
    c_diff, c_far = _core_boundary_diff(cands_chunks, cands_mem, tile, min_distance)
    p_diff, p_far = _core_boundary_diff(pts_chunks, pts_mem, tile, min_distance)
    z_differ = np.nonzero(diff.reshape(diff.shape[0], -1).max(1))[0]
    post_exact = [_same_points(post(cands_chunks), pts_chunks),
                  _same_points(post(cands_mem), pts_mem)]
    out = dict(tile=list(tile), n_tiles=n_tiles, heat_max_abs=float(diff.max()),
               heat_voxels_differ=int(np.count_nonzero(diff)),
               heat_z_differ=[int(z_differ.min()), int(z_differ.max())] if len(z_differ) else [],
               n_candidates=[len(cands_chunks), len(cands_mem)], candidates_differ=c_diff,
               candidates_differ_far=c_far, n_points=[len(pts_chunks), len(pts_mem)],
               points_differ=p_diff, points_differ_far=p_far, min_distance=min_distance,
               points_are_post_of_candidates=post_exact)
    ok = diff.max() <= 1 / 255 and n_tiles > 1 and all(post_exact)
    if candidates_match:
        ok = ok and c_far == 0
    if not ok:
        raise AssertionError(f"by chunks against in memory: {out}")
    return out


def _held_line(h):
    return (f"heatmap max |by chunks - in memory| {h['heat_max_abs']:.3g} ({h['heat_voxels_differ']} "
            f"voxels differ, z {h['heat_z_differ']}), {h['n_tiles']} tiles of {h['tile']}; "
            "candidates (by chunks, in "
            f"memory) {h['n_candidates']}, {h['candidates_differ']} differ, "
            f"{h['candidates_differ_far']} farther than {h['min_distance']} voxels from a tile core "
            f"boundary; points after the close-point removal {h['n_points']}, each side exactly "
            f"the removal over its own candidates {h['points_are_post_of_candidates']}, "
            f"{h['points_differ']} differ, {h['points_differ_far']} far from a boundary")


def _launch_totals(total):
    """Add the launch counters to ``total`` and set them to 0."""
    from biapy_tpu_torch.ops.kernels import build

    for k, v in build.LAUNCHES.items():
        total["launches"][k] = total["launches"].get(k, 0) + v
    for k, v in build.CONV3D_ROUTES.items():
        total["conv3d_routes"][k] = total["conv3d_routes"].get(k, 0) + v
    for name, routes in build.SHUFFLE_ROUTES.items():
        for k, v in routes.items():
            total["shuffle_routes"].setdefault(name, {})
            total["shuffle_routes"][name][k] = total["shuffle_routes"][name].get(k, 0) + v
    build.reset_launches()


def phase_detection(smi):
    """(a) templates/detection/3d_detection.yaml as it is but for its data (two
    80 x 256 x 256 training volumes and one test volume of about 150 seeded
    Gaussian blobs, sigma 2-3 voxels, in noise, with CSV points), EPOCHS 2
    and WARMUP_COSINE_DECAY_EPOCHS 1, through ``run_job``: the CSV to
    point-mask compile, training, the bf16 test pass, point extraction and
    the metrics at DET_TOLERANCE 8. (b) Its best checkpoint by chunks on a
    168 x 512 x 512 Zarr with WORKFLOW_PROCESS on, the points held against
    ``predict`` of the same volume in memory. (c) The instance template's
    model and training with TYPE synapses on seeded CREMI-layout Zarrs:
    2 epochs for each of simpsyn, synful, cleft and F_post_only, each tested
    in memory and by chunks. (d) (a)'s best checkpoint on a 20 x 256 x
    256 crop in float32 on the card and on the CPU."""
    import copy
    import shutil

    import numpy as np
    import torch
    import yaml  # the templates are YAML; PyYAML is optional for the port itself

    from biapy_tpu_torch import BiaPy, native
    from biapy_tpu_torch.data import synapses
    from biapy_tpu_torch.data.io import open_lazy
    from biapy_tpu_torch.data.post_processing import remove_close_points
    from biapy_tpu_torch.data.tiff import read_tiff, write_tiff
    from biapy_tpu_torch.data.zarr_store import ZarrArray
    from biapy_tpu_torch.engine import detection
    from biapy_tpu_torch.ops.kernels import build

    native._load()
    root = OUT_DIR / "chip_smoke_detection"
    shutil.rmtree(root, ignore_errors=True)
    total = {"launches": {}, "conv3d_routes": {}, "shuffle_routes": {}}
    mask_s, syn_s = [], []
    plain_mask, plain_syn = detection.create_detection_masks, synapses.synapse_channel_creation
    res = {}
    deferred = False
    try:
        # (a) the template
        vols = {}
        for split, n in (("train", 2), ("test", 1)):
            for d in ("x", "csv"):
                (root / split / d).mkdir(parents=True)
            for i in range(n):
                img, pts = _blob_volume(DET_SHAPE, DET_BLOBS, seed=100 + len(vols))
                write_tiff(str(root / split / "x" / f"{split}_{i:03d}.tif"), img)
                _points_csv(root / split / "csv" / f"{split}_{i:03d}.csv", pts)
                vols[(split, i)] = (img, pts)
        with open(DETECTION_TEMPLATE) as f:
            cfg = yaml.safe_load(f)
        cfg["DATA"]["TRAIN"].update(PATH=str(root / "train/x"), GT_PATH=str(root / "train/csv"))
        cfg["DATA"]["TEST"].update(PATH=str(root / "test/x"), GT_PATH=str(root / "test/csv"))
        cfg["TRAIN"]["EPOCHS"] = 2
        cfg["TRAIN"]["LR_SCHEDULER"]["WARMUP_COSINE_DECAY_EPOCHS"] = 1
        detection.create_detection_masks = _timed(plain_mask, mask_s)
        job = BiaPy(cfg, result_dir=str(root / "results"), name="detection", silent=True)
        job._build_workflow()
        wf = job.workflow
        calls = _count_forwards(wf)
        # the point-mask caches sit next to the GT dirs, under this run's root
        # (update_dependencies derives DETECTION_MASK_DIR from GT_PATH)
        mask_dirs = [str(wf.cfg.DATA[s].DETECTION_MASK_DIR) for s in ("TRAIN", "TEST")]
        if not all(d.startswith(str(root)) for d in mask_dirs):
            raise AssertionError(f"detection: mask dirs {mask_dirs} outside {root}")
        loop_s, predict_s, points_s, train_s, test_s = [], [], [], [], []
        wf.train_one_epoch = _timed(wf.train_one_epoch, loop_s)
        wf.predict_block_on_device = _timed(wf.predict_block_on_device, predict_s)
        wf._extract_points = _timed(wf._extract_points, points_s)
        wf.train = _timed(wf.train, train_s)
        wf.test = _timed(wf.test, test_s)
        torch.cuda.synchronize()
        build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        job.run_job()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = dict(build.LAUNCHES)
        routes = dict(build.CONV3D_ROUTES)
        shuffle_routes = {k: dict(v) for k, v in build.SHUFFLE_ROUTES.items()}
        _launch_totals(total)
        hist = wf.history
        ck = sorted(p.name for p in Path(wf.cfg.PATHS.CHECKPOINT).iterdir())
        raw = read_tiff(str(Path(wf.cfg.PATHS.RESULT_DIR.PER_IMAGE) / "test_000.tif"))
        pts_a = detection.read_points_csv(
            str(Path(wf.cfg.PATHS.RESULT_DIR.DET_LOCAL_MAX_COORDS_CHECK) / "test_000_points.csv"), 3)
        stats = wf.stats
        if (len(hist) != 2 or not all(np.isfinite(h["loss"]) for h in hist)
                or ck != ["detection-checkpoint-1.ckpt", "detection-checkpoint-best.ckpt"]
                or raw.shape != DET_SHAPE or not np.all(np.isfinite(raw))
                or len(mask_s) != 3 or "det_f1" not in stats):
            raise AssertionError(f"detection template: epochs {hist}, checkpoints {ck}, "
                                 f"heatmap {raw.shape}, {len(mask_s)} mask compiles, "
                                 f"stats {stats}")
        want, want_routes = _expected_launches(wf.model, calls)
        if not (routes == want_routes and launches["pad_channels"] == want["pad_channels"]
                and launches["pool_max_folded"]
                and launches["pool_max_folded_bwd"] and launches["zcat"]
                and launches["zd2s"] == 0 and launches["zs2d"] == 0):
            raise AssertionError(f"detection template: launches {launches}, routes {routes}, "
                                 f"want {want_routes} and {want['pad_channels']} pads")
        scalar = {k: v["scalar"] for k, v in shuffle_routes.items() if v["scalar"]}
        steps = len(wf.train_loader)
        bs = int(wf.cfg.TRAIN.BATCH_SIZE)
        vox = float(np.prod(DET_SHAPE))
        res["template"] = dict(
            seconds=secs, mask_seconds_per_volume=mask_s, epoch_seconds=[h["time"] for h in hist],
            loop_seconds=loop_s, loop_patches_per_s=[steps * bs / t for t in loop_s],
            train_seconds=train_s[0], test_seconds=test_s[0], test_mvox_s=vox / test_s[0] / 1e6,
            predict_seconds=predict_s, point_seconds=points_s, n_points=len(pts_a),
            n_gt=len(vols[("test", 0)][1]),
            metrics={k: stats[k] for k in ("det_precision", "det_recall", "det_f1", "det_tp",
                                           "det_fp", "det_fn")},
            peak_bytes=peak, launches=launches, conv3d_routes=routes,
            shuffle_routes=shuffle_routes, scalar_launches=scalar,
            loss=[h["loss"] for h in hist], train_patches=len(wf.train_data),
            val_patches=len(wf.val_data))
        r = res["template"]
        print(f"[detection] {smi}: {DETECTION_TEMPLATE.relative_to(REPO)}: resunet "
              f"{list(wf.cfg.MODEL.FEATURE_MAPS)}, patch {list(wf.cfg.DATA.PATCH_SIZE)}, "
              f"{len(wf.train_data)} train / {len(wf.val_data)} val patches, 2 epochs: run_job "
              f"{secs:.2f} s (train {train_s[0]:.2f}, test {test_s[0]:.2f}); mask compile s per "
              f"volume {[round(t, 3) for t in mask_s]}; loop s per epoch "
              f"{[round(t, 3) for t in loop_s]} ({[round(v, 2) for v in r['loop_patches_per_s']]} "
              f"patches/s), loss {[round(h['loss'], 5) for h in hist]}")
        print(f"[detection] {smi}: test from disk {r['test_mvox_s']:.3f} Mvox/s ({vox / 1e6:.2f} "
              f"Mvox, bf16): predict {[round(t, 3) for t in predict_s]} s, point extraction "
              f"{[round(t, 3) for t in points_s]} s; {len(pts_a)} points against {r['n_gt']} in "
              f"the GT: P {stats['det_precision']:.4f} R {stats['det_recall']:.4f} F1 "
              f"{stats['det_f1']:.4f} at DET_TOLERANCE {wf.cfg.TEST.DET_TOLERANCE}; peak memory "
              f"{peak / 2**30:.2f} GiB")
        print(f"[detection] launches {launches}; conv3d routes {routes}; pool and zcat routes "
              f"{shuffle_routes}; on the scalar route: {scalar or 'none'}")
        best = str(Path(wf.cfg.PATHS.CHECKPOINT) / "detection-checkpoint-best.ckpt")
        detection.create_detection_masks = plain_mask

        # (b) by chunks against predict in memory, one 168 x 512 x 512 volume
        (root / "chunks/x").mkdir(parents=True)
        big, _ = _blob_volume(DET_CHUNK_SHAPE, DET_BLOBS * 8, seed=200)
        z = ZarrArray.create(str(root / "chunks/x/vol.zarr"), shape=DET_CHUNK_SHAPE + (1,),
                             chunks=(40, 128, 128, 1), dtype="u1",
                             compressor={"id": "zlib", "level": 1})
        z[:, :, :, :] = big[..., None]
        ccfg = copy.deepcopy(cfg)
        ccfg["TRAIN"]["ENABLE"] = False
        ccfg["MODEL"]["LOAD_CHECKPOINT"] = True
        ccfg["PATHS"] = {"CHECKPOINT_FILE": best}
        # no GT: the metrics of an undertrained model's hundreds of thousands
        # of points against 1200 would take scipy's assignment hours
        ccfg["DATA"]["TEST"].update(PATH=str(root / "chunks/x"), LOAD_GT=False, IN_MEMORY=False)
        # the volume's own statistics, fixed: by chunks a tile is otherwise
        # normalised by its own, and the two paths would see other inputs
        ccfg["DATA"]["NORMALIZATION"] = _fixed_stats(big)
        ccfg["TEST"]["BY_CHUNKS"] = {"ENABLE": True, "WORKFLOW_PROCESS": {
            "ENABLE": True, "PATCHES_PER_TILE": DET_TILE}}
        jc = BiaPy(ccfg, result_dir=str(root / "results"), name="det_chunks", silent=True)
        jc._build_workflow()
        merge_s = []
        jc.workflow.after_by_chunks_prediction = _timed(jc.workflow.after_by_chunks_prediction,
                                                        merge_s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        jc.test()
        torch.cuda.synchronize()
        chunk_s = time.perf_counter() - t0
        _launch_totals(total)
        pc = [p["points"] for p in jc.workflow._predictions if p["role"] == "points"]
        mcfg = copy.deepcopy(ccfg)
        mcfg["TEST"].pop("BY_CHUNKS")
        jm = BiaPy(mcfg, result_dir=str(root / "results"), name="det_memory", silent=True)
        t0 = time.perf_counter()
        pm = {p["role"]: p for p in jm.predict(big)}
        mem_s = time.perf_counter() - t0
        _launch_totals(total)
        if not (len(pc) == 1 and "points" in pm):
            raise AssertionError(f"detection by chunks: points {len(pc)}, in memory {sorted(pm)}")
        held = _hold_by_chunks(
            jc.workflow, pm["raw"]["pred"], pm["points"]["points"], pc[0],
            jm.workflow._extract_points(pm["raw"]["pred"], global_post=False), "vol_patch*_points.csv",
            int(wf.cfg.TEST.DET_PEAK_LOCAL_MAX_MIN_DISTANCE),
            _detection_post(jc.workflow.cfg, DET_CHUNK_SHAPE))
        vox_b = float(np.prod(DET_CHUNK_SHAPE))
        res["by_chunks"] = dict(seconds=chunk_s, mvox_s=vox_b / chunk_s / 1e6,
                                points_seconds=merge_s[0], memory_seconds=mem_s, **held)
        print(f"[detection-chunks] {smi}: {DET_CHUNK_SHAPE} uint8 Zarr, tiles {held['tile']}: "
              f"by chunks {chunk_s:.2f} s, {vox_b / chunk_s / 1e6:.3f} Mvox/s (the per-tile points "
              f"and their merge {merge_s[0]:.2f} s of it); predict in memory {mem_s:.2f} s; "
              f"{_held_line(held)}")

        # (c) synapses
        syn_root = root / "syn"
        for split, seed, shape, pairs in (("train", 300, SYN_SHAPE, SYN_PAIRS),
                                          ("test", 301, SYN_SHAPE, SYN_PAIRS),
                                          ("test_small", 302, SYN_SMALL_SHAPE, SYN_SMALL_PAIRS)):
            (syn_root / split).mkdir(parents=True)
            _cremi_zarr(syn_root / split / "vol.zarr", shape, pairs, seed)
        with open(INSTANCE_TEMPLATE) as f:
            icfg = yaml.safe_load(f)
        zmd = {"INPUT_ZARR_MULTIPLE_DATA": True, "INPUT_ZARR_MULTIPLE_DATA_RAW_PATH": "volumes.raw",
               "INPUT_IMG_AXES_ORDER": "ZYX",
               "INPUT_ZARR_MULTIPLE_DATA_PARTNERS_PATH": "annotations.partners"}
        for split in ("TRAIN", "TEST"):
            icfg["DATA"][split].pop("GT_PATH")
            icfg["DATA"][split].update(PATH=str(syn_root / split.lower()), **zmd)
        icfg["TRAIN"]["LR_SCHEDULER"]["WARMUP_COSINE_DECAY_EPOCHS"] = 1
        icfg["TEST"]["DET_TOLERANCE"] = 40  # nm: one z voxel, ten in y and x
        synapses.synapse_channel_creation = _timed(plain_syn, syn_s)
        res["synapses"] = {}
        for method, codes in SYN_METHODS.items():
            scfg = copy.deepcopy(icfg)
            scfg["PROBLEM"]["INSTANCE_SEG"] = {"TYPE": "synapses", "DATA_CHANNELS": codes,
                                               "DATA_CHANNELS_EXTRA_OPTS": [
                                                   SYN_EXTRA.get(method, {})],
                                               "SYNAPSES": dict(SYN_POINTS)}
            scfg["TRAIN"]["EPOCHS"] = 2
            test_dir = syn_root / ("test_small" if method == "synful" else "test")
            scfg["DATA"]["TEST"]["PATH"] = str(test_dir)
            # fixed statistics, as in (b): the test volume's
            scfg["DATA"]["NORMALIZATION"] = _fixed_stats(
                open_lazy(str(test_dir / "vol.zarr"), "volumes.raw")[0][:])
            js = BiaPy(scfg, result_dir=str(syn_root / "results"), name=f"syn_{method}",
                       silent=True)
            n_compiles = len(syn_s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            js.run_job()
            torch.cuda.synchronize()
            syn_secs = time.perf_counter() - t0
            _launch_totals(total)
            mem = [p for p in js.workflow._predictions if p["role"] == "synapse_points"]
            raw_m = [p["pred"] for p in js.workflow._predictions if p["role"] == "raw"]
            bcfg = copy.deepcopy(scfg)
            bcfg["TRAIN"]["ENABLE"] = False
            bcfg["MODEL"]["LOAD_CHECKPOINT"] = True
            best_s = Path(js.workflow.cfg.PATHS.CHECKPOINT) / f"syn_{method}-checkpoint-best.ckpt"
            if not best_s.exists():
                raise AssertionError(f"synapses {method}: no {best_s.name}")
            bcfg["PATHS"] = {"CHECKPOINT_FILE": str(best_s)}
            bcfg["TEST"]["BY_CHUNKS"] = {"ENABLE": True, "WORKFLOW_PROCESS": {
                "ENABLE": True, "PATCHES_PER_TILE": SYN_TILE}}
            jb = BiaPy(bcfg, result_dir=str(syn_root / "results"), name=f"syn_{method}_chunks",
                       silent=True)
            t0 = time.perf_counter()
            jb.test()
            torch.cuda.synchronize()
            chunk_secs = time.perf_counter() - t0
            _launch_totals(total)
            chk = [p for p in jb.workflow._predictions if p["role"] == "synapse_points"]
            if not (len(mem) == len(chk) == len(raw_m) == 1 and "metrics" in mem[0]
                    and "metrics" in chk[0]
                    and sorted(mem[0]["points"]) == sorted(chk[0]["points"])):
                raise AssertionError(f"synapses {method}: in memory {mem}, by chunks {chk}")
            cands = js.workflow._extract_synapse_points(raw_m[0], do_post_processing=False,
                                                        connect=False)
            held = {}
            for k in mem[0]["points"]:
                radius = float(SYN_POINTS.get(f"REMOVE_CLOSE_{k.upper()}_POINTS_RADIUS", 0))
                # synful's pres are the projections clustered per tile by
                # chunks, over the whole set in memory: held by the removal
                # over each side's own candidates alone
                held[k] = _hold_by_chunks(
                    jb.workflow, raw_m[0], mem[0]["points"][k], chk[0]["points"][k], cands[k],
                    f"vol_patch*_{k}_points.csv", SYN_POINTS["PEAK_LOCAL_MAX_MIN_DISTANCE"],
                    (lambda c, r=radius: remove_close_points(c, r)) if radius > 0
                    else (lambda c: c),
                    candidates_match=not (method == "synful" and k == "pre"))
            m, mc = mem[0]["metrics"], chk[0]["metrics"]
            r = dict(codes=codes, epochs=scfg["TRAIN"]["EPOCHS"], run_job_seconds=syn_secs,
                     compile_seconds=syn_s[n_compiles:], by_chunks_seconds=chunk_secs,
                     f1={k: m[f"f1 ({k} points)"] for k in held},
                     f1_by_chunks={k: mc[f"f1 ({k} points)"] for k in held}, held=held)
            res["synapses"][method] = r
            print(f"[synapses] {smi}: {method} {codes}, {r['epochs']} epoch(s): run_job "
                  f"{syn_secs:.2f} s, channel compile s "
                  f"{[round(t, 3) for t in r['compile_seconds']]}; by chunks {chunk_secs:.2f} s; "
                  f"F1 {r['f1']}, by chunks {r['f1_by_chunks']} (an undertrained model's F1 "
                  "says nothing of the port)")
            for k, h in held.items():
                print(f"[synapses] {method} {k}: {_held_line(h)}")
        synapses.synapse_channel_creation = plain_syn

        # (d) the card against the CPU, float32
        # the data and the checkpoint stay until the comparison has run
        _detection_card_vs_cpu(cfg, best, vols[("test", 0)][0][: DET_CROP[0]], root, res,
                               lambda: shutil.rmtree(root, ignore_errors=True))
        deferred = True
        res["launches"] = total["launches"]
        res["conv3d_routes"] = total["conv3d_routes"]
        res["shuffle_routes"] = total["shuffle_routes"]
        print(f"[detection] phase 13 launches {total['launches']}; conv3d routes "
              f"{total['conv3d_routes']}; pool and zcat routes {total['shuffle_routes']}")
        return res
    finally:
        detection.create_detection_masks = plain_mask
        synapses.synapse_channel_creation = plain_syn
        if not deferred:
            shutil.rmtree(root, ignore_errors=True)


def _detection_card_vs_cpu(cfg, ckpt, crop, root, res, cleanup):
    """(d) ``predict`` of the best checkpoint on ``crop`` in float32 on the
    card and on the CPU (plain versions, in the CPU-side child): the heatmaps
    within 1e-4; the candidate points (before the close-point removal) the
    same but for near ties (a voxel within twice the measured difference of
    the threshold or of another voxel of its peak window, where the two
    devices may rightly part), and the points after the removal the same,
    or, where a near tie parted the candidates, each side exactly the
    removal over its own. The comparison runs after the last phase, puts its
    result in ``res["vs_plain"]`` and then calls ``cleanup``."""
    import copy

    import numpy as np

    from biapy_tpu_torch import BiaPy

    c = copy.deepcopy(cfg)
    c["TRAIN"]["ENABLE"] = False
    c["MODEL"]["LOAD_CHECKPOINT"] = True
    c["PATHS"] = {"CHECKPOINT_FILE": ckpt}
    c["TEST"]["REDUCE_MEMORY"] = False
    cpu = _cpu_side("_cpu_predict", cfg=c, vol=crop, result_dir=str(root / "vs_plain"),
                    name="det_cpu", points=True)
    job = BiaPy(c, result_dir=str(root / "vs_plain"), name="det_card", silent=True,
                device=DEVICE)
    t0 = time.perf_counter()
    preds = {p["role"]: p for p in job.predict(crop)}
    secs = time.perf_counter() - t0
    heat = np.asarray(preds["raw"]["pred"], np.float32)
    runs = {"card": (heat, np.asarray(preds["points"]["points"]),
                     job.workflow._extract_points(heat, global_post=False), secs)}

    def finish():
        try:
            got = cpu()
            preds = {p["role"]: p for p in got["preds"]}
            runs["cpu"] = (np.asarray(preds["raw"]["pred"], np.float32),
                           np.asarray(preds["points"]["points"]), got["candidates"],
                           got["seconds"])
            res["vs_plain"] = _detection_compare(runs, job.workflow.cfg, crop)
        finally:
            cleanup()
    _CPU_SIDE["pending"].append(finish)


def _detection_compare(runs, wcfg, crop):
    import numpy as np

    (h_card, p_card, c_card, s_card), (h_cpu, p_cpu, c_cpu, s_cpu) = runs["card"], runs["cpu"]
    diff = np.abs(h_card - h_cpu)
    test = wcfg.TEST
    md = int(test.DET_PEAK_LOCAL_MAX_MIN_DISTANCE)
    post = _detection_post(wcfg, crop.shape[:3])
    eps = 2 * float(diff.max())
    sa = {tuple(int(v) for v in p) for p in c_card}
    sb = {tuple(int(v) for v in p) for p in c_cpu}
    untied = 0
    for p in sa ^ sb:
        v = h_card[p][0]
        win = h_card[tuple(slice(max(0, q - md), q + md + 1) for q in p)][..., 0]
        if abs(v - float(test.DET_MIN_TH_TO_BE_PEAK)) > eps and np.count_nonzero(win >= v - eps) < 2:
            untied += 1
    same = p_card.shape == p_cpu.shape and bool(np.array_equal(p_card, p_cpu))
    out = dict(max_abs=float(diff.max()), mean_abs=float(diff.mean()),
               n_candidates=[len(c_card), len(c_cpu)], candidates_differ=len(sa ^ sb),
               candidates_differ_not_near_ties=untied, n_points=[len(p_card), len(p_cpu)],
               same_points=same, points_differ=_core_boundary_diff(p_card, p_cpu, (1 << 30,) * 3,
                                                                   0)[0],
               card_s=s_card, cpu_s=s_cpu)
    print(f"[detection-vs-plain] best checkpoint, crop {tuple(crop.shape)}, float32: max "
          f"|p_card - p_cpu| = {out['max_abs']:.3g}, mean {out['mean_abs']:.3g}; candidates "
          f"{out['n_candidates']} card / CPU, {out['candidates_differ']} differ, "
          f"{untied} of them not near ties; points {len(p_card)} card / {len(p_cpu)} CPU, the "
          f"same: {same} ({out['points_differ']} differ); card {s_card:.2f} s, CPU {s_cpu:.2f} s "
          f"(the CPU-side child, {CPU_SIDE_THREADS} threads)")
    if not (out["max_abs"] <= 1e-4 and untied == 0
            and (same or (_same_points(post(c_card), p_card)
                          and _same_points(post(c_cpu), p_cpu)))):
        raise AssertionError(f"detection test pass: card and CPU differ: {out}")
    return out


# phase 14: the repository's four 3D restoration templates on seeded TIFFs,
# each through run_job, then its best checkpoint card vs CPU
RESTORATION_TEMPLATES = {
    "denoising": "templates/denoising/3d_denoising.yaml",
    "super_resolution": "templates/super-resolution/3d_super-resolution.yaml",
    "self_supervised": "templates/self-supervised/3d_self-supervised.yaml",
    "image_to_image": "templates/image-to-image/3d_image-to-image.yaml",
}
# the input volumes (z, y, x); the super-resolution GT is twice the input in
# y and x
RESTORATION_SHAPES = {"denoising": (64, 256, 256), "super_resolution": (64, 256, 256),
                      "self_supervised": (80, 256, 256), "image_to_image": (80, 256, 256)}
# (b): the test volumes' crops through the best checkpoint on both devices,
# sized for the CPU's plain convolutions (the self-supervised one a single
# core of the template's stitch: the CPU's resunet 28/36/48/64 took 31 s on
# 20 x 128 x 128, eight patches), and the y-x size of the one-sample
# training step
RESTORATION_CROPS = {"denoising": (16, 96, 96), "super_resolution": (8, 128, 128),
                     "self_supervised": (12, 96, 96), "image_to_image": (20, 128, 128)}
RESTORATION_STEP_YX = 64
# (c): the LR training and test volumes (two and one; the HR twice them on
# every axis): 2 x 2 x 2 patches of the template's 8 x 128 x 128 each
SR3D_SHAPE = (16, 256, 256)
# rcan's float32 training step card against CPU, from the seeded initial
# weights (the same on both devices). Phase 8's 1e-4 is beyond any float32
# implementation there: rcan at its defaults adds 200 RCABs' residuals
# unscaled, its outputs reach about 8e4 and 6e4 at init, and the JAX
# package's own float32 step lies from a float64 one, in the gradients and
# in the weights after SGD at 0.05, 1.29e-2 and 6.81e-3 in 3D (8 x 64 x 64
# LR) and 8.16e-2 and 7.81e-2 in 2D (64 x 64), most of it in the channel
# attentions' 1x1 convs; the port's CPU step 1.29e-2 and 7.95e-3, 1.09e-1
# and 4.63e-2 (``tools/torch_sr_step_witness.py``). The limits are twice
# the reference's, as phase 17's are; the loss keeps 1e-4. dfcan's step
# lies 2.7e-7 from float64 (the same witness) and keeps phase 8's rule
RCAN_STEP_TOLS = {3: {"loss": 1e-4, "grad": 2.6e-2, "weight": 1.4e-2},
                  2: {"loss": 1e-4, "grad": 1.7e-1, "weight": 1.6e-1}}


def _smooth_volume(g, shape, noise):
    """A uint8 volume (or 2D image) of smooth seeded structures (a random
    field on a coarse grid, linearly upsampled) plus Gaussian noise, made on
    the card."""
    import torch
    import torch.nn.functional as F

    coarse = [max(2, n // 16) for n in shape]
    field = F.interpolate(torch.randn([1, 1] + coarse, generator=g, device=DEVICE), size=shape,
                          mode="trilinear" if len(shape) == 3 else "bilinear",
                          align_corners=False)[0, 0]
    field = (field - field.min()) / (field.max() - field.min())
    img = 40 + 170 * field + noise * torch.randn(shape, generator=g, device=DEVICE)
    return img.clamp(0, 255).round().to(torch.uint8).cpu().numpy()


def _write_restoration_data(kind, root):
    """Two training volumes and one test volume: inputs under x/ and, for
    super-resolution (HR 2x in y and x; the LR the 2 x 2 y-x block mean) and
    image-to-image (255 minus a Gaussian blur of the source), targets under
    y/. Returns the test volume and its target (or None)."""
    import numpy as np
    import torch
    from scipy import ndimage

    from biapy_tpu_torch.data.tiff import write_tiff

    g = torch.Generator(device=DEVICE).manual_seed(14)
    shape = RESTORATION_SHAPES[kind]
    test = None
    for split, n in (("train", 2), ("test", 1)):
        for i in range(n):
            name = f"{split}_{i:03d}.tif"
            tgt = None
            if kind == "super_resolution":
                hr = _smooth_volume(g, (shape[0], 2 * shape[1], 2 * shape[2]), 6)
                img = hr.reshape(shape[0], shape[1], 2, shape[2], 2).mean(axis=(2, 4))
                img, tgt = np.round(img).astype(np.uint8), hr
            else:
                img = _smooth_volume(g, shape, 12)
                if kind == "image_to_image":
                    blur = ndimage.gaussian_filter(img.astype(np.float32), (0.5, 1.5, 1.5))
                    tgt = (255 - blur).round().clip(0, 255).astype(np.uint8)
            (root / split / "x").mkdir(parents=True, exist_ok=True)
            write_tiff(str(root / split / "x" / name), img)
            if tgt is not None:
                (root / split / "y").mkdir(parents=True, exist_ok=True)
                write_tiff(str(root / split / "y" / name), tgt)
            if split == "test":
                test = (img, tgt)
    return test


def _channel_pads(dtype, launched):
    """The channel pads of conv3d launches ``[(C of x, C of y), ...]``: one
    for each on the tensor-core route whose x has channels off the 8 grid."""
    from biapy_tpu_torch.ops.kernels.conv3d import conv3d_route

    return sum(1 for cin, cout in launched
               if conv3d_route(dtype, cin, cout) == "wgmma" and cin % 8)


def _model_launches(model, dtype, training):
    """Kernel launches of one forward (``training``: one training step,
    forward and backward) of a 3D U-Net, read off the model: a conv3d per
    3x3x3 conv (and in training its input gradient, but the stem's, whose
    input needs none, and one zcat for its weight gradient), a pool (in
    training and its backward) per encoder level, a zd2s (and zs2d) per
    transposed conv with a z factor; conv3d's routes by dtype and widths."""
    from biapy_tpu_torch.models.blocks import Conv, ConvTranspose
    from biapy_tpu_torch.ops.kernels.conv3d import conv3d_route

    convs = [tuple(m.kernel.shape) for m in model.modules() if isinstance(m, Conv)]
    odd = [k for k in convs if k[:3] not in ((3, 3, 3), (1, 1, 1))]
    if odd or model.parts.get("up_pre") is not None:
        raise AssertionError(f"launch count: convs {odd} or a pre-upsampling not counted here")
    k3 = [k[3:] for k in convs if k[:3] == (3, 3, 3)]
    z_ups = sum(1 for m in model.modules() if isinstance(m, ConvTranspose) and m.ks[0] > 1)
    pools = len(model.windows)
    routes = dict.fromkeys(CONV3D_ROUTE_NAMES, 0)
    launched = [(cin, cout) for cin, cout in k3]
    if training:  # the stem's input needs no gradient
        launched += [(cout, cin) for cin, cout in k3[1:]]
    for cin, cout in launched:
        routes[conv3d_route(dtype, cin, cout)] += 1
    out = {"conv3d": len(k3), "pool_max_folded": pools, "zd2s": z_ups, "zcat": 0,
           "zcat_bwd": 0, "pool_max_folded_bwd": 0, "zs2d": 0,
           "pad_channels": _channel_pads(dtype, launched),
           "tf32_split": routes["tf32x3"]}
    if training:
        out.update(conv3d=2 * len(k3) - 1, zcat=len(k3), pool_max_folded_bwd=pools, zs2d=z_ups)
    return out, routes


def _sr_launches(model, dtype, training):
    """Kernel launches of one forward (``training``: one training step,
    forward and backward) of a 3D super-resolution model (rcan, dfcan), read
    off it: a conv3d per 3x3x3 conv and in training its input gradient (but
    the stem's, whose input needs none) and one zcat for its weight
    gradient; the 1x1x1 convs are matmuls and ``pixel_shuffle`` a reshape,
    which launch nothing of the port. Each conv runs in the input's dtype,
    but in DFCAN every conv from the first FCAB's spectrum conv on runs in
    float32: the FFT takes complex64, and the block's output ``x + h * s``
    is float32 from there (the JAX package's promotion); conv3d's routes
    follow."""
    import torch

    from biapy_tpu_torch.models.blocks import Conv
    from biapy_tpu_torch.ops.kernels.conv3d import conv3d_route

    launched, n3, dt = [], 0, dtype
    for name, m in model.named_modules():
        if not (isinstance(m, Conv) and tuple(m.kernel.shape[:3]) == (3, 3, 3)):
            continue
        parts = name.split(".")
        if len(parts) > 1 and parts[-2].startswith("_FCAB") and parts[-1] == "Conv_2":
            dt = torch.float32
        cin, cout = (int(c) for c in m.kernel.shape[3:])
        launched.append((dt, cin, cout))
        if training and n3:
            launched.append((dt, cout, cin))
        n3 += 1
    routes = dict.fromkeys(CONV3D_ROUTE_NAMES, 0)
    for d, cin, cout in launched:
        routes[conv3d_route(d, cin, cout)] += 1
    out = dict.fromkeys(KERNEL_META, 0)
    out.update(conv3d=len(launched), zcat=n3 if training else 0,
               pad_channels=sum(1 for d, cin, cout in launched
                                if conv3d_route(d, cin, cout) == "wgmma" and cin % 8),
               tf32_split=routes["tf32x3"])
    return out, routes


def _count_forwards(wf, outputs=None):
    """Record (training, input dtype) of every forward of ``wf``'s model from
    the moment ``prepare_model`` builds it (the bf16 test copy keeps the
    hook); ``outputs``, a list: also every forward's output, as float32
    numpy."""
    calls = []
    prepare = wf.prepare_model

    def hook(m, args, out):
        calls.append((m.training, args[0].dtype))
        if outputs is not None:
            outputs.append({k: v.detach().float().cpu().numpy() for k, v in out.items()}
                           if isinstance(out, dict) else out.detach().float().cpu().numpy())

    def prepare_model():
        prepare()
        if not hasattr(wf.model, "_counted"):
            wf.model._counted = True
            wf.model.register_forward_hook(hook)

    wf.prepare_model = prepare_model
    return calls


def _expected_launches(model, calls, count=None):
    """The launches and conv3d routes of the recorded forwards (a training
    forward runs in its input's dtype, bf16 under mixed precision), each
    forward's read off the model by ``count`` (``_model_launches``)."""
    count = count or _model_launches
    want, routes = {}, dict.fromkeys(CONV3D_ROUTE_NAMES, 0)
    for training, dt in calls:
        n, r = count(model, dt, training)
        for k, v in n.items():
            want[k] = want.get(k, 0) + v
        for k, v in r.items():
            routes[k] += v
    return want, routes


def _step_on(c, batch, result_dir, name, dev):
    """One side of ``_restoration_step_vs_plain``: one float32 SGD step of the
    job ``c`` on ``batch`` on ``dev``, Dropout and DropPath held off. Returns the loss,
    the gradients the step applied (read as it hands them to the optimizer:
    one forward and backward), the updated weights and the floating-point
    buffers, as CPU tensors."""
    import torch

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.engine.train_engine import make_train_step
    from biapy_tpu_torch.models.blocks import DropPath, Dropout

    job = BiaPy(c, result_dir=result_dir, name=name, silent=True, check_data_paths=False,
                device=dev)
    job._build_workflow()
    wf = job.workflow
    wf.prepare_model()
    for m in wf.model.modules():
        if isinstance(m, (Dropout, DropPath)):
            m.rate = 0.0
    x, y = (torch.from_numpy(batch[k]).to(dev) for k in ("x", "y"))
    grads, update = {}, wf.state.optimizer.update

    def held(g, ok=None):
        grads.update(g)
        return update(g, ok=ok)
    wf.state.optimizer.update = held
    _, metrics = make_train_step(wf.loss, {})(wf.state, {"x": x, "y": y})
    return (float(metrics["loss"]), {k: v.cpu() for k, v in grads.items()},
            {k: v.detach().cpu() for k, v in wf.model.named_parameters()},
            {k: v.cpu() for k, v in wf.model.named_buffers() if v.is_floating_point()})


def _restoration_step_vs_plain(cfg, ckpt, batch, root, name, tols=None, lr=0.05, done=None):
    """One float32 training step from the best checkpoint (None: from the
    seeded initial weights, the same on both devices) on the card and on
    the CPU from the same batch, SGD at ``lr`` (phase 8's 0.05 unless given:
    a rate at which one update shows; Adam's first update is lr x sign(g),
    which makes a whole step of float32 noise in a near-zero gradient): the
    loss, every gradient and every updated weight within 1e-4 of its scale,
    phase 8's rule, or within ``tols`` ({"loss", "grad", "weight"} and, if
    given, "stats": every BatchNorm running statistic after the step).
    Dropout and DropPath are held off on both sides (their masks come from
    each device's generator); BatchNorm trains. The CPU side runs in the CPU-side child;
    the comparison, after the last phase, fills the returned dict and then
    calls ``done`` with it."""
    import copy

    c = copy.deepcopy(cfg)
    if ckpt is not None:
        c["MODEL"]["LOAD_CHECKPOINT"] = True
        c["PATHS"] = {"CHECKPOINT_FILE": ckpt}
    c["TRAIN"].update(OPTIMIZER=["SGD"], LR=[lr], LR_SCHEDULER={"NAME": ""})
    cpu = _cpu_side("_step_on", c=_cpu_ckpt(c), batch=batch, result_dir=str(CPU_SIDE_RESULTS),
                    name=f"{name}_step_cpu", dev="cpu")
    card = _step_on(c, batch, str(root / "vs_plain"), f"{name}_step_cud", DEVICE)
    tols = dict(tols or dict.fromkeys(("loss", "grad", "weight"), 1e-4))
    worst = {}

    def finish():
        got = cpu()
        w = {"loss": abs(card[0] - got[0]) / max(1.0, abs(got[0]))}
        for what, i in (("grad", 1), ("weight", 2), ("stats", 3)):
            if what in tols and got[i]:
                w[what] = max(((card[i][k] - ref).abs().max()
                               / max(1.0, ref.abs().max().item())).item()
                              for k, ref in got[i].items())
        if not all(w[k] <= tols[k] for k in w):
            raise AssertionError(f"{name}: one training step, card and CPU differ: {w} "
                                 f"(tolerances {tols})")
        worst.update(w, tolerances=tols)
        if done:
            done(worst)
    _CPU_SIDE["pending"].append(finish)
    return worst


def _restoration_card_vs_cpu(kind, cfg, ckpt, test, root, done=None):
    """(b) ``predict`` of the best checkpoint on a crop of the test volume on
    the card and on the CPU: ``_card_vs_cpu``'s rule. For super-resolution
    the upscaled output."""
    crop = test[0][tuple(slice(0, n) for n in RESTORATION_CROPS[kind])]
    return _card_vs_cpu(kind, cfg, ckpt, [crop], root, done=done)


def _predict_side(c, inputs, classifier, result_dir, name, dev):
    """One side of ``_card_vs_cpu``: ``predict`` of each input on ``dev``, the
    first prediction with a "pred" of each (the instance workflow's
    instances come before its raw channels), stacked; for a classifier also
    the logits of every forward (read by a hook); and the seconds."""
    import numpy as np

    from biapy_tpu_torch import BiaPy

    job = BiaPy(c, result_dir=result_dir, name=name, silent=True, check_data_paths=False,
                device=dev)
    logits = []
    if classifier:
        job._build_workflow()
        _count_forwards(job.workflow, logits)
    t0 = time.perf_counter()
    preds = np.stack([np.asarray(next(p["pred"] for p in job.predict(v) if "pred" in p),
                                 np.float32) for v in inputs])
    logits = [lg["class"] if isinstance(lg, dict) else lg for lg in logits]
    return preds, np.concatenate(logits) if classifier else None, time.perf_counter() - t0


def _card_vs_cpu(name, cfg, ckpt, inputs, root, classifier=False, done=None, scaled=False):
    """``predict`` of ``ckpt`` on each of ``inputs`` on the card and on the
    CPU (plain versions), float32 and, under the config's TEST.REDUCE_MEMORY,
    bf16: float32 within 1e-4 (``scaled``: of the output's scale, for a
    model whose outputs are far from 1); bf16 card no farther from the
    card's float32 output than the CPU's bf16 (1.5x at the worst voxel, 1.2x
    on the mean: phase 12 b's rule). ``classifier``: the rule holds the
    model's logits (read by a hook: the trained head saturates the
    probabilities), float32 within 1e-4 of their scale; the float32
    probabilities must also lie within 1e-4 and each input's predicted
    class must agree. The CPU side
    runs in the CPU-side child; the comparison, after the last phase, fills
    the returned dict and then calls ``done`` with it."""
    import copy

    import numpy as np

    dts = [("float32", False)] + ([("bfloat16", True)] if cfg["TEST"].get("REDUCE_MEMORY")
                                  else [])
    runs, cpu = {}, {}
    for dt, reduce_mem in dts:
        c = copy.deepcopy(cfg)
        c["TRAIN"]["ENABLE"] = False
        c["MODEL"]["LOAD_CHECKPOINT"] = True
        c["PATHS"] = {"CHECKPOINT_FILE": ckpt}
        c["TEST"]["REDUCE_MEMORY"] = reduce_mem
        cpu[dt] = _cpu_side("_predict_side", c=_cpu_ckpt(c), inputs=inputs,
                            classifier=classifier, result_dir=str(CPU_SIDE_RESULTS),
                            name=f"{name}_{dt}_cpu", dev="cpu")
        runs[dt, "card"] = _predict_side(c, inputs, classifier, str(root / "vs_plain"),
                                         f"{name}_{dt}_card", DEVICE)
    out = {}

    def finish():
        for dt, _ in dts:
            runs[dt, "cpu"] = cpu[dt]()
        # (preds, logits, seconds): a classifier's rule holds the logits
        probs = {k: v[0] for k, v in runs.items()}
        held = {k: (v[1] if classifier else v[0], v[2]) for k, v in runs.items()}
        ref = held["float32", "card"][0]
        for dt, _ in dts:
            (p_card, s_card), (p_cpu, s_cpu) = held[dt, "card"], held[dt, "cpu"]
            diff = np.abs(p_card - p_cpu)
            out[dt] = dict(shape=list(p_card.shape[1:]), max_abs=float(diff.max()),
                           mean_abs=float(diff.mean()), card_s=s_card, cpu_s=s_cpu,
                           to_f32={side: dict(
                               max_abs=float(np.abs(held[dt, side][0] - ref).max()),
                               mean_abs=float(np.abs(held[dt, side][0] - ref).mean()))
                               for side in ("card", "cpu")})
            if classifier:
                out[dt]["argmax"] = {side: probs[dt, side].argmax(-1).tolist()
                                     for side in ("card", "cpu")}
                out[dt]["prob_max_abs"] = float(np.abs(probs[dt, "card"]
                                                       - probs[dt, "cpu"]).max())
        f = out["float32"]
        scale = max(1.0, float(np.abs(ref).max())) if classifier or scaled else 1.0
        if classifier or scaled:
            f["scale"] = scale
        ok = f["max_abs"] <= 1e-4 * scale and (not classifier
                                               or (f["prob_max_abs"] <= 1e-4
                                                   and f["argmax"]["card"]
                                                   == f["argmax"]["cpu"]))
        if "bfloat16" in out:
            card, cpu_ = out["bfloat16"]["to_f32"]["card"], out["bfloat16"]["to_f32"]["cpu"]
            ok = ok and (card["max_abs"] <= 1.5 * cpu_["max_abs"]
                         and card["mean_abs"] <= 1.2 * cpu_["mean_abs"])
        if not ok:
            raise AssertionError(f"{name} test pass: card and CPU differ: {out}")
        if done:
            done(out)
    _CPU_SIDE["pending"].append(finish)
    return out


def _print_restoration_vs(kind, vs):
    for dt, v in vs.items():
        print(f"[restoration-vs-plain] {kind} best checkpoint, crop "
              f"{RESTORATION_CROPS[kind]} -> {tuple(v['shape'])}, {dt}: max |p_card - "
              f"p_cpu| = {v['max_abs']:.3g}, mean {v['mean_abs']:.3g}; against the card's "
              f"float32: card max {v['to_f32']['card']['max_abs']:.3g} mean "
              f"{v['to_f32']['card']['mean_abs']:.3g}, CPU max "
              f"{v['to_f32']['cpu']['max_abs']:.3g} mean "
              f"{v['to_f32']['cpu']['mean_abs']:.3g}; card {v['card_s']:.2f} s, CPU "
              f"{v['cpu_s']:.2f} s (the CPU-side child)")


def _write_sr3d_data(root):
    """Phase 14 (c)'s data: two training volumes and one test volume of
    SR3D_SHAPE under x/ and their HR targets (twice the LR on every axis;
    the LR the 2 x 2 x 2 block mean) under y/. Returns the test LR volume."""
    import numpy as np
    import torch

    from biapy_tpu_torch.data.tiff import write_tiff

    g = torch.Generator(device=DEVICE).manual_seed(19)
    d, h, w = SR3D_SHAPE
    for split, n in (("train", 2), ("test", 1)):
        for i in range(n):
            hr = _smooth_volume(g, (2 * d, 2 * h, 2 * w), 6)
            img = np.round(hr.reshape(d, 2, h, 2, w, 2).mean(axis=(1, 3, 5))).astype(np.uint8)
            for sub, vol in (("x", img), ("y", hr)):
                (root / split / sub).mkdir(parents=True, exist_ok=True)
                write_tiff(str(root / split / sub / f"{split}_{i:03d}.tif"), vol)
    return img


def _sr3d_job(arch, root, smi, total):
    """Phase 14 (c): the 3D super-resolution template with ``arch`` (rcan or
    dfcan at full width and depth) and UPSCALING (2, 2, 2), RANDOM_ROT off
    (ROADMAP section 3), on seeded LR / HR volumes, through ``run_job`` at
    EPOCHS 2: seconds, the test prediction's shape, PSNR and SSIM, peak
    memory, launches by kernel and route against the counts read off the
    model (``_sr_launches``) for every forward it ran, no zcat on the
    ``scalar`` route; then the best checkpoint on a crop of the test volume
    card against CPU (float32 within 1e-4 of the output's scale) and one
    float32 training step card against CPU (dfcan's from the best
    checkpoint at phase 8's rule, rcan's from its seeded weights at
    ``RCAN_STEP_TOLS``). The template's own (1, 2, 2) does not
    run with these models in either package (ROADMAP section 3)."""
    import numpy as np
    import torch
    import yaml

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.data.tiff import read_tiff
    from biapy_tpu_torch.ops.kernels import build

    tpl = RESTORATION_TEMPLATES["super_resolution"]
    t0 = time.perf_counter()
    test = _write_sr3d_data(root)
    data_s = time.perf_counter() - t0
    with open(REPO / tpl) as f:
        cfg = yaml.safe_load(f)
    cfg["MODEL"]["ARCHITECTURE"] = arch
    cfg["PROBLEM"]["SUPER_RESOLUTION"]["UPSCALING"] = [2, 2, 2]
    cfg["AUGMENTOR"]["RANDOM_ROT"] = False
    for split in ("TRAIN", "TEST"):
        cfg["DATA"][split]["PATH"] = str(root / split.lower() / "x")
        cfg["DATA"][split]["GT_PATH"] = str(root / split.lower() / "y")
    cfg["TRAIN"]["EPOCHS"] = 2
    job = BiaPy(cfg, result_dir=str(root / "results"), name=f"sr3d_{arch}", silent=True,
                device=DEVICE)
    job._build_workflow()
    wf = job.workflow
    calls = _count_forwards(wf)
    loop_s, test_s = [], []
    wf.train_one_epoch = _timed(wf.train_one_epoch, loop_s)
    wf.test = _timed(wf.test, test_s)
    torch.cuda.synchronize()
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    job.run_job()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(build.LAUNCHES)
    routes = dict(build.CONV3D_ROUTES)
    zcat_routes = dict(build.SHUFFLE_ROUTES["zcat"])
    _launch_totals(total)
    want, want_routes = _expected_launches(wf.model, calls, _sr_launches)
    hist = wf.history
    pred = read_tiff(str(Path(wf.cfg.PATHS.RESULT_DIR.PER_IMAGE) / "test_000.tif"))
    out_shape = tuple(2 * n for n in SR3D_SHAPE)
    stats = getattr(wf, "stats", None) or {}
    if (len(hist) != 2 or not all(np.isfinite(h["loss"]) for h in hist)
            or pred.shape[:3] != out_shape or not np.all(np.isfinite(pred))
            or not {"psnr", "ssim"} <= set(stats)):
        raise AssertionError(f"sr3d {arch}: epochs {hist}, prediction {pred.shape} (want "
                             f"{out_shape}), stats {stats}")
    if launches != want or routes != want_routes or zcat_routes.get("scalar"):
        raise AssertionError(f"sr3d {arch}: launches {launches} (want {want}), conv3d routes "
                             f"{routes} (want {want_routes}), zcat routes {zcat_routes}, "
                             f"{len(calls)} forwards")
    n_par = sum(p.numel() for p in wf.model.parameters())
    bs = int(wf.cfg.TRAIN.BATCH_SIZE)
    steps = len(wf.train_loader)
    r = dict(template=tpl, arch=arch, params=n_par, patch=list(wf.cfg.DATA.PATCH_SIZE),
             batch=bs, seconds=secs, data_seconds=data_s, loop_seconds=loop_s,
             loop_patches_per_s=[steps * bs / t for t in loop_s], test_seconds=test_s[0],
             test_mvox_in_per_s=float(np.prod(SR3D_SHAPE)) / test_s[0] / 1e6,
             loss=[h["loss"] for h in hist], metrics={k: stats[k] for k in ("psnr", "ssim")},
             peak_bytes=peak, launches=launches, conv3d_routes=routes, zcat_routes=zcat_routes,
             forwards=len(calls), steps=steps,
             change="MODEL.ARCHITECTURE " + arch + ", UPSCALING (2, 2, 2), AUGMENTOR.RANDOM_ROT "
                    "False")
    print(f"[restoration] {smi}: {tpl} with {arch} ({n_par:,} parameters), UPSCALING (2, 2, "
          f"2), patch {r['patch']}, batch {bs}, {len(wf.train_data)} train / "
          f"{len(wf.val_data)} val patches, 2 epochs: run_job {secs:.2f} s (data written in "
          f"{data_s:.1f} s); loop s per epoch {[round(t, 3) for t in loop_s]} "
          f"({[round(v, 2) for v in r['loop_patches_per_s']]} patches/s); test "
          f"{r['test_mvox_in_per_s']:.3f} Mvox/s in, prediction {pred.shape[:3]}; PSNR "
          f"{stats['psnr']:.4f} SSIM {stats['ssim']:.4f} (a record: 2 epochs); peak memory "
          f"{peak / 2**30:.2f} GiB; loss {[round(v, 5) for v in r['loss']]}")
    print(f"[restoration] sr3d {arch}: launches "
          f"{ {k: v for k, v in launches.items() if v} } over {len(calls)} forwards = the "
          f"model's count; conv3d routes {routes}; zcat routes {zcat_routes}")
    best = str(Path(wf.cfg.PATHS.CHECKPOINT) / f"sr3d_{arch}-checkpoint-best.ckpt")
    crop = test[tuple(slice(0, n) for n in RESTORATION_CROPS["super_resolution"])]
    # of the output's scale: rcan at its defaults (no residual scaling over
    # 200 RCABs) puts out values far above 1, in both packages (ROADMAP
    # section 3)
    vs = _card_vs_cpu(f"sr3d_{arch}", cfg, best, [crop], root,
                      done=lambda v: _print_vs_plain(f"sr3d {arch}", v, "restoration"),
                      scaled=True)
    sample = wf.val_data.get(0, np.random.default_rng(0))
    yx = RESTORATION_STEP_YX
    batch = {"x": sample["x"][None, :, :yx, :yx], "y": sample["y"][None, :, :2 * yx, :2 * yx]}
    rcan = arch == "rcan"
    step_worst = _restoration_step_vs_plain(
        cfg, None if rcan else best, batch, root, f"sr3d_{arch}",
        RCAN_STEP_TOLS[3] if rcan else None,
        done=lambda w, shape=batch["x"].shape: _print_step_vs_plain(
            f"sr3d {arch}", w, shape, "restoration"))
    build.reset_launches()
    r.update(card_vs_cpu=vs, step_vs_plain=step_worst)
    return r


def phase_restoration(smi):
    """(a) The four 3D restoration templates (denoising, super-resolution,
    self-supervised, image-to-image) loaded as they are, with only their data
    paths (seeded uint8 TIFFs: two training volumes and one test volume),
    EPOCHS 2 (WARMUP_COSINE_DECAY_EPOCHS 1 where the template has a warm-up)
    and, for super-resolution, RANDOM_ROT off (ROADMAP section 3), through
    ``run_job``: training with the templates' augmentations and
    target functions (N2V manipulation, crappify), checkpoints, the test
    pass (super-resolution on the host crop/merge path) and its metrics.
    Seconds, the loop's patches/s and the device's idle share over a
    profiled epoch's steady steps, the host seconds per sample of the
    target function and of augmentation, test Mvox/s, PSNR and SSIM where
    there is GT, peak memory, and launches by kernel and route against the
    counts read off the model for every forward it ran. (b) Each best
    checkpoint on a crop of its test volume, card against CPU, and one
    training step card against CPU."""
    import shutil

    import numpy as np
    import torch
    import yaml  # the templates are YAML; PyYAML is optional for the port itself

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.data.tiff import read_tiff
    from biapy_tpu_torch.engine.train_engine import make_train_step, resolve_mixed_precision
    from biapy_tpu_torch.ops.kernels import build

    root0 = OUT_DIR / "chip_smoke_restoration"
    shutil.rmtree(root0, ignore_errors=True)
    total = {"launches": {}, "conv3d_routes": {}, "shuffle_routes": {}}
    res = {}
    try:
        for kind, tpl in RESTORATION_TEMPLATES.items():
            root = root0 / kind
            t0 = time.perf_counter()
            test = _write_restoration_data(kind, root)
            data_s = time.perf_counter() - t0
            with open(REPO / tpl) as f:
                cfg = yaml.safe_load(f)
            cfg["DATA"]["TRAIN"]["PATH"] = str(root / "train/x")
            cfg["DATA"]["TEST"]["PATH"] = str(root / "test/x")
            if test[1] is not None:
                cfg["DATA"]["TRAIN"]["GT_PATH"] = str(root / "train/y")
                cfg["DATA"]["TEST"]["GT_PATH"] = str(root / "test/y")
            cfg["TRAIN"]["EPOCHS"] = 2
            sched = cfg["TRAIN"].get("LR_SCHEDULER", {})
            if "WARMUP_COSINE_DECAY_EPOCHS" in sched:
                # the configuration check wants the warm-up shorter than the
                # run, as in phases 11 d, 12 and 13
                sched["WARMUP_COSINE_DECAY_EPOCHS"] = 1
            if kind == "super_resolution":
                # the template's one change beyond data and epochs (ROADMAP
                # section 3): the reference's affine_2d warps the SR target to
                # the input's size, so a rotated sample breaks the batch
                cfg["AUGMENTOR"]["RANDOM_ROT"] = False
            job = BiaPy(cfg, result_dir=str(root / "results"), name=kind, silent=True,
                        device=DEVICE)
            job._build_workflow()
            wf = job.workflow
            calls = _count_forwards(wf)
            target_s, loop_s, train_s, test_s, predict_s = [], [], [], [], []
            def timed_targets(make=wf.prepare_targets_fn):
                fn = make()
                return None if fn is None else _timed(fn, target_s)

            wf.prepare_targets_fn = timed_targets
            one_epoch = wf.train_one_epoch
            wf.train_one_epoch = _timed(one_epoch, loop_s)
            wf.train, wf.test = _timed(wf.train, train_s), _timed(wf.test, test_s)
            wf.predict_block_on_device = _timed(wf.predict_block_on_device, predict_s)
            wf.predict_patches = _timed(wf.predict_patches, predict_s)
            torch.cuda.synchronize()
            build.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            job.run_job()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            launches = dict(build.LAUNCHES)
            routes = dict(build.CONV3D_ROUTES)
            shuffle_routes = {k: dict(v) for k, v in build.SHUFFLE_ROUTES.items()}
            _launch_totals(total)
            mixed = resolve_mixed_precision(wf.cfg.TRAIN.MIXED_PRECISION, wf.device)
            want, want_routes = _expected_launches(wf.model, calls)
            hist = wf.history
            ck = sorted(p.name for p in Path(wf.cfg.PATHS.CHECKPOINT).iterdir())
            pred = read_tiff(str(Path(wf.cfg.PATHS.RESULT_DIR.PER_IMAGE) / "test_000.tif"))
            up = wf.y_upscaling
            out_shape = tuple(n * u for n, u in zip(RESTORATION_SHAPES[kind], up))
            stats = getattr(wf, "stats", None) or {}
            if (len(hist) != 2 or not all(np.isfinite(h["loss"]) for h in hist)
                    or ck != [f"{kind}-checkpoint-1.ckpt", f"{kind}-checkpoint-best.ckpt"]
                    or pred.shape[:3] != out_shape or not np.all(np.isfinite(pred))
                    or (test[1] is not None and not {"psnr", "ssim"} <= set(stats))):
                raise AssertionError(f"{kind}: epochs {hist}, checkpoints {ck}, prediction "
                                     f"{pred.shape} (want {out_shape}), stats {stats}")
            # zd2s and zs2d on the Z_DOWN 2 templates' decoders, none at Z_DOWN 1
            z_down = any(int(z) > 1 for z in wf.cfg.MODEL.Z_DOWN)
            if (launches != want or routes != want_routes
                    or bool(launches["zd2s"] and launches["zs2d"]) != z_down
                    or any(v["scalar"] for v in shuffle_routes.values())):
                raise AssertionError(f"{kind}: launches {launches} (want {want}), conv3d routes "
                                     f"{routes} (want {want_routes}), shuffle routes "
                                     f"{shuffle_routes}, {len(calls)} forwards")
            # the loop alone: one more epoch profiled (a trace can lose a conv3d
            # event: up to three traces, as phase 9)
            step = make_train_step(wf.loss, wf.train_metrics, mixed_precision=mixed)
            gen = torch.Generator(device=wf.device).manual_seed(1)
            steps = len(wf.train_loader)
            per = _model_launches(wf.model, torch.bfloat16, True)[0]["conv3d"]
            for attempt in range(1, 4):
                wall, _, _, events = _profile_device(
                    lambda: one_epoch(step, 2 + attempt, gen))
                try:
                    idle, window_ms = _steady_idle_share(events, per, steps, f"{kind} epoch")
                    break
                except AssertionError as e:
                    if attempt == 3:
                        raise
                    print(f"[profile] {e} (trace {attempt}); profiling again")
            build.reset_launches()
            target_calls = len(target_s)
            target_mean = statistics.mean(target_s) if target_s else None
            get_s, aug_s, _ = _augment_seconds(wf.train_data, n=4)
            bs = int(wf.cfg.TRAIN.BATCH_SIZE)
            vin = float(np.prod(RESTORATION_SHAPES[kind]))
            r = res[kind] = dict(
                template=tpl, seconds=secs, data_seconds=data_s, train_seconds=train_s[0],
                test_seconds=test_s[0], epoch_seconds=[h["time"] for h in hist],
                loss=[h["loss"] for h in hist], val_loss=[h.get("val_loss") for h in hist],
                loop_seconds=loop_s, loop_patches_per_s=[steps * bs / t for t in loop_s],
                idle_share=idle, idle_window_ms=window_ms, profiled_epoch_s=wall,
                target_fn_seconds_per_sample=target_mean, target_fn_calls=target_calls,
                augment_seconds_per_sample=aug_s,
                get_seconds_per_sample=get_s, predict_seconds=predict_s,
                test_mvox_in_per_s=vin / test_s[0] / 1e6,
                test_mvox_out_per_s=vin * np.prod(up) / test_s[0] / 1e6,
                metrics={k: stats[k] for k in ("psnr", "ssim") if k in stats},
                peak_bytes=peak, launches=launches, conv3d_routes=routes,
                shuffle_routes=shuffle_routes, forwards=len(calls),
                train_patches=len(wf.train_data), val_patches=len(wf.val_data), steps=steps,
                batch=bs, change=("AUGMENTOR.RANDOM_ROT False" if kind == "super_resolution"
                                  else None))
            tf = f"{1e3 * target_mean:.2f} ms" if target_calls else "none"
            print(f"[restoration] {smi}: {tpl}: {wf.cfg.MODEL.ARCHITECTURE} "
                  f"{list(wf.cfg.MODEL.FEATURE_MAPS)}, Z_DOWN {list(wf.cfg.MODEL.Z_DOWN)}, patch "
                  f"{list(wf.cfg.DATA.PATCH_SIZE)}, batch {bs}, {len(wf.train_data)} train / "
                  f"{len(wf.val_data)} val patches, 2 epochs"
                  + (f", changed: {r['change']} (ROADMAP section 3: the reference's affine_2d "
                     "crops the SR target to the input's size)" if r["change"] else "")
                  + f": run_job {secs:.2f} s (train {train_s[0]:.2f}, test {test_s[0]:.2f}; "
                  f"data written in {data_s:.1f} s); loop s per epoch "
                  f"{[round(t, 3) for t in loop_s]} "
                  f"({[round(v, 2) for v in r['loop_patches_per_s']]} patches/s), device idle "
                  f"{100 * idle:.1f}% of a profiled epoch's steps 2-{steps}; loss "
                  f"{[round(v, 5) for v in r['loss']]}")
            print(f"[restoration] {kind}: host s per sample: target function {tf} "
                  f"({target_calls} calls in the job), augmentation {1e3 * aug_s:.2f} ms, the whole sample "
                  f"{1e3 * get_s:.2f} ms; test {r['test_mvox_in_per_s']:.3f} Mvox/s in"
                  + (f", {r['test_mvox_out_per_s']:.3f} out" if np.prod(up) > 1 else "")
                  + f" (predict {[round(t, 3) for t in predict_s]} s); "
                  + (f"PSNR {stats['psnr']:.4f} SSIM {stats['ssim']:.4f}; " if stats else "")
                  + f"peak memory {peak / 2**30:.2f} GiB")
            used = {k: v for k, v in shuffle_routes.items() if sum(v.values())}
            print(f"[restoration] {kind}: launches {launches} over {len(calls)} forwards = the "
                  f"model's count; conv3d routes {routes}; pool routes {used}")

            # (b) card against CPU: serving on a crop, one training step
            best = str(Path(wf.cfg.PATHS.CHECKPOINT) / f"{kind}-checkpoint-best.ckpt")
            vs = _restoration_card_vs_cpu(kind, cfg, best, test, root,
                                          done=lambda v, kind=kind: _print_restoration_vs(kind, v))
            sample = wf.val_data.get(0, np.random.default_rng(0))
            yx = RESTORATION_STEP_YX
            batch = {"x": sample["x"][None, :, :yx, :yx],
                     "y": sample["y"][None, :, :yx * up[1], :yx * up[2]]}
            step_worst = _restoration_step_vs_plain(
                cfg, best, batch, root, kind,
                done=lambda w, kind=kind, shape=batch["x"].shape: _print_step_vs_plain(
                    kind, w, shape, "restoration"))
            build.reset_launches()
            r.update(card_vs_cpu=vs, step_vs_plain=step_worst)
        # (c) the super-resolution template with rcan and dfcan in 3D
        for arch in SR3D_FILTERS:
            res[f"sr3d_{arch}"] = _sr3d_job(arch, root0 / f"sr3d_{arch}", smi, total)
        res["launches"] = total["launches"]
        res["conv3d_routes"] = total["conv3d_routes"]
        res["shuffle_routes"] = total["shuffle_routes"]
        return res
    finally:
        shutil.rmtree(root0, ignore_errors=True)


# phase 15: the repository's 3D classification template on seeded class
# folders, through run_job with simple_cnn (a) and vit (b), then the U-Net
# variants on the semantic template (c)
CLASSIFICATION_TEMPLATE = "templates/classification/3d_classification.yaml"
# three classes that differ in texture and intensity: a smooth dim field,
# mid-grey grain, bright stripes along x
CLS_CLASSES = ("smooth", "grainy", "striped")
CLS_SHAPE = (40, 80, 80)  # RESIZE takes each volume to the 32 x 64 x 64 patch
CLS_PER_CLASS = {"train": 30, "test": 5}
# (b): the template with vit at the config's ViT defaults; the configuration
# check wants a ViT's patch the same on every axis, so the patch (and RESIZE)
# goes to 64 x 64 x 64: 4 x 4 x 4 tokens of 16^3
VIT_PATCH = (64, 64, 64)
# (c): bf16 training steps at the template's batch on its patch, and a
# predict on a volume of 2 x 2 x 2 stitch cores (40 x 128 x 128 patches,
# padding 8 x 16 x 16); card against CPU at a reduced patch (the U-Nets'
# weights do not depend on it) on a crop of 2 x 2 x 2 of its cores
VARIANT_STEPS = 3
VARIANT_TEST_SHAPE = (48, 192, 192)
VARIANT_SMALL_PATCH, VARIANT_SMALL_PADDING = [8, 64, 64, 1], [2, 8, 8]
VARIANT_SMALL_CROP = (8, 96, 96)
# one float32 training step card against CPU, SGD at the template's rate
# (1e-3): the loss within 1e-6 of its scale, the gradients within 1e-5, the
# updated weights within 1e-6 and the BatchNorm statistics within 1e-5.
# simple_cnn's step cannot be held so close by a float32 implementation:
# its gradients change discontinuously where a rounding flips a max-pool
# winner or a ReLU's sign (at the template's batch about 200 pool windows
# lie within 1e-6 of a tie), and on a batch made as this phase makes it,
# from the same initial weights, the JAX package's own float32 step lies
# 4.1e-5 (loss), 1.5e-2 (gradients) and 8.9e-6 (statistics) from a float64
# step (``tools/torch_classification_step_witness.py``). Its limits are ones
# that the reference's float32 step meets against float64: loss 5e-5,
# gradients 3e-2, statistics 2e-5, and the weights 3e-4 (the rate times the
# gradient limit times 10: the gradients' scale reaches about 7)
CLS_STEP_TOLS = {"simple_cnn": {"loss": 5e-5, "grad": 3e-2, "weight": 3e-4, "stats": 2e-5},
                 "vit": {"loss": 1e-6, "grad": 1e-5, "weight": 1e-6, "stats": 1e-5}}
CLS_STEP_TOLS["unet"] = CLS_STEP_TOLS["vit"]


def _class_volume(g, ci, shape):
    """A uint8 volume of class ``ci``, made on the card."""
    import math

    import torch
    import torch.nn.functional as F

    noise = torch.randn(shape, generator=g, device=DEVICE)
    if ci == 0:
        coarse = [max(2, n // 10) for n in shape]
        field = F.interpolate(torch.randn([1, 1] + coarse, generator=g, device=DEVICE),
                              size=shape, mode="trilinear", align_corners=False)[0, 0]
        img = 60 + 25 * field + 4 * noise
    elif ci == 1:
        img = 120 + 35 * noise
    else:
        phase = float(torch.rand((), generator=g, device=DEVICE)) * 2 * math.pi
        x = torch.arange(shape[2], device=DEVICE, dtype=torch.float32)
        img = 180 + 45 * torch.sin(2 * math.pi * x / 6 + phase) + 6 * noise
    return img.clamp(0, 255).round().to(torch.uint8).cpu().numpy()


def _write_classification_data(root):
    """Class folders under train/ and test/; returns one test volume per
    class."""
    import torch

    from biapy_tpu_torch.data.tiff import write_tiff

    g = torch.Generator(device=DEVICE).manual_seed(15)
    firsts = []
    for split, n in CLS_PER_CLASS.items():
        for ci, cname in enumerate(CLS_CLASSES):
            (root / split / cname).mkdir(parents=True, exist_ok=True)
            for i in range(n):
                vol = _class_volume(g, ci, CLS_SHAPE)
                write_tiff(str(root / split / cname / f"{cname}_{i:03d}.tif"), vol)
                if split == "test" and i == 0:
                    firsts.append(vol)
    return firsts


def _classifier_launches(model, dtype, training):
    """Kernel launches of one forward (``training``: one training step) of a
    classifier, read off the model. SimpleCNN: a conv3d per 3x3x3 conv, a
    zcat (kz 5) per 5x5x5 conv (cat2d), a pool after each block's 5x5x5
    conv; in training the input gradients of all 3x3x3 convs but the stem,
    a weight-gradient zcat (kz 3) per 3x3x3 conv, a zcat_bwd per 5x5x5 conv
    (none is first) and a pool backward per pool. The ViT computes with
    PyTorch matmuls: no kernel of the port."""
    from biapy_tpu_torch.models.blocks import Conv
    from biapy_tpu_torch.models.simple_cnn import SimpleCNN
    from biapy_tpu_torch.ops.kernels.conv3d import conv3d_route

    out = dict.fromkeys(KERNEL_META, 0)
    routes = dict.fromkeys(CONV3D_ROUTE_NAMES, 0)
    if not isinstance(model, SimpleCNN):
        return out, routes
    convs = [tuple(m.kernel.shape) for m in model.modules() if isinstance(m, Conv)]
    k3 = [k[3:] for k in convs if k[:3] == (3, 3, 3)]
    k5 = [k for k in convs if k[:3] == (5, 5, 5)]
    if len(k3) + len(k5) != len(convs) or convs[0][:3] != (3, 3, 3):
        raise AssertionError(f"launch count: convs {convs} not counted here")
    launched = [(cin, cout) for cin, cout in k3]
    if training:  # the stem's input needs no gradient
        launched += [(cout, cin) for cin, cout in k3[1:]]
    for cin, cout in launched:
        routes[conv3d_route(dtype, cin, cout)] += 1
    out.update(conv3d=len(k3), zcat=len(k5), pool_max_folded=len(k5),
               pad_channels=_channel_pads(dtype, launched), tf32_split=routes["tf32x3"])
    if training:
        out.update(conv3d=2 * len(k3) - 1, zcat=len(k3) + len(k5), zcat_bwd=len(k5),
                   pool_max_folded_bwd=len(k5))
    return out, routes


def _window_idle_share(events):
    """Idle share of the device from the first to the last of ``events``
    (in start order; the union of their intervals on every stream is
    busy) and the window's ms."""
    t0 = events[0][0]
    busy, end = 0.0, t0
    for st, _, ms in events:
        en = st + ms * 1e3
        busy += max(0.0, en - max(st, end)) / 1e3
        end = max(end, en)
    window = (end - t0) / 1e3
    return 1.0 - busy / window, window


def _classification_job(name, cfg, root, smi, firsts, total):
    """One classification run_job on the card with its measurements, its
    launches held to the model's count and added to ``total``, then its
    best checkpoint card against CPU and one float32 training step card
    against CPU."""
    import numpy as np
    import torch

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.engine import classification as cls_engine
    from biapy_tpu_torch.engine.train_engine import make_train_step, resolve_mixed_precision
    from biapy_tpu_torch.ops.kernels import build

    job = BiaPy(cfg, result_dir=str(root / "results"), name=name, silent=True, device=DEVICE)
    job._build_workflow()
    wf = job.workflow
    calls = _count_forwards(wf)
    loop_s, train_s, test_s, resize_s = [], [], [], []
    one_epoch = wf.train_one_epoch
    wf.train_one_epoch = _timed(one_epoch, loop_s)
    wf.train, wf.test = _timed(wf.train, train_s), _timed(wf.test, test_s)
    preprocess = cls_engine.preprocess_image
    cls_engine.preprocess_image = _timed(preprocess, resize_s)
    try:
        torch.cuda.synchronize()
        build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        job.run_job()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        cls_engine.preprocess_image = preprocess
    peak = torch.cuda.max_memory_allocated()
    launches = dict(build.LAUNCHES)
    routes = dict(build.CONV3D_ROUTES)
    shuffle_routes = {k: dict(v) for k, v in build.SHUFFLE_ROUTES.items()}
    _launch_totals(total)
    want, want_routes = _expected_launches(wf.model, calls, _classifier_launches)
    hist = wf.history
    ck = sorted(p.name for p in Path(wf.cfg.PATHS.CHECKPOINT).iterdir())
    csv_rows = (Path(wf.cfg.PATHS.RESULT_DIR.PATH) / "predictions.csv").read_text().splitlines()
    n_test = CLS_PER_CLASS["test"] * len(CLS_CLASSES)
    acc = wf.stats["accuracy"]
    if (len(hist) != 2 or not all(np.isfinite(h["loss"]) and np.isfinite(h["val_loss"])
                                  for h in hist)
            or ck != [f"{name}-checkpoint-best.ckpt"] or csv_rows[0] != "filename,class"
            or len(csv_rows) != 1 + n_test or len(wf._predictions) != n_test
            or not all(np.all(np.isfinite(p["pred"])) and p["pred"].shape == (len(CLS_CLASSES),)
                       and abs(float(p["pred"].sum()) - 1) < 1e-4 for p in wf._predictions)):
        raise AssertionError(f"{name}: epochs {hist}, checkpoints {ck}, predictions.csv "
                             f"{csv_rows}")
    if (launches != want or routes != want_routes
            or any(v["scalar"] for v in shuffle_routes.values())):
        raise AssertionError(f"{name}: launches {launches} (want {want}), conv3d routes "
                             f"{routes} (want {want_routes}), shuffle routes {shuffle_routes}, "
                             f"{len(calls)} forwards")
    # the loop alone: one more epoch profiled (up to three traces, as phase
    # 14: a trace can lose a conv3d event)
    mixed = resolve_mixed_precision(wf.cfg.TRAIN.MIXED_PRECISION, wf.device)
    step = make_train_step(wf.loss, wf.train_metrics, mixed_precision=mixed)
    gen = torch.Generator(device=wf.device).manual_seed(1)
    steps = len(wf.train_loader)
    per = _classifier_launches(wf.model, torch.bfloat16, True)[0]["conv3d"]
    for attempt in range(1, 4):
        wall, _, _, events = _profile_device(lambda: one_epoch(step, 2 + attempt, gen))
        try:
            if per:
                idle, window_ms = _steady_idle_share(events, per, steps, f"{name} epoch")
            else:
                idle, window_ms = _window_idle_share(events)
            break
        except AssertionError as e:
            if attempt == 3:
                raise
            print(f"[profile] {e} (trace {attempt}); profiling again")
    build.reset_launches()
    get_s, aug_s, _ = _augment_seconds(wf.train_data, n=8, image_only=True)
    bs = int(wf.cfg.TRAIN.BATCH_SIZE)
    r = dict(template=CLASSIFICATION_TEMPLATE, arch=str(wf.cfg.MODEL.ARCHITECTURE),
             patch=list(wf.cfg.DATA.PATCH_SIZE), seconds=secs, train_seconds=train_s[0],
             test_seconds=test_s[0], epoch_seconds=[h["time"] for h in hist],
             loss=[h["loss"] for h in hist], val_loss=[h["val_loss"] for h in hist],
             accuracy=[h["accuracy"] for h in hist], val_accuracy=[h["val_accuracy"] for h in hist],
             loop_seconds=loop_s, loop_patches_per_s=[steps * bs / t for t in loop_s],
             idle_share=idle, idle_window_ms=window_ms, profiled_epoch_s=wall,
             resize_seconds_per_sample=statistics.mean(resize_s), resize_calls=len(resize_s),
             augment_seconds_per_sample=aug_s, get_seconds_per_sample=get_s,
             test_images_per_s=n_test / test_s[0], test_accuracy=acc, predictions_csv=csv_rows,
             peak_bytes=peak, launches=launches, conv3d_routes=routes,
             shuffle_routes=shuffle_routes, forwards=len(calls), steps=steps, batch=bs,
             train_samples=len(wf.train_data), val_samples=len(wf.val_data),
             params=sum(p.numel() for p in wf.model.parameters()))
    print(f"[classification] {smi}: {CLASSIFICATION_TEMPLATE} with {r['arch']}, patch "
          f"{r['patch']}, batch {bs}, {len(wf.train_data)} train / {len(wf.val_data)} val "
          f"volumes, {r['params']:,} parameters, 2 epochs: run_job {secs:.2f} s (train "
          f"{train_s[0]:.2f}, test {test_s[0]:.2f}); loop s per epoch "
          f"{[round(t, 3) for t in loop_s]} ({[round(v, 2) for v in r['loop_patches_per_s']]} "
          f"patches/s), device idle {100 * idle:.1f}% of a profiled epoch"
          + (f"'s steps 2-{steps}" if per else "") + f"; loss {[round(v, 5) for v in r['loss']]}, "
          f"val_loss {[round(v, 5) for v in r['val_loss']]}; test accuracy {acc:.4f} "
          "(a record, not a gate: 2 epochs)")
    print(f"[classification] {name}: host ms per sample: resize {1e3 * r['resize_seconds_per_sample']:.2f} "
          f"({len(resize_s)} volumes), augmentation {1e3 * aug_s:.2f}, the whole sample "
          f"{1e3 * get_s:.2f}; test {r['test_images_per_s']:.2f} volumes/s; peak memory "
          f"{peak / 2**30:.2f} GiB; launches {launches} over {len(calls)} forwards = the model's "
          f"count; conv3d routes {routes}; pool and zcat routes "
          f"{ {k: v for k, v in shuffle_routes.items() if sum(v.values())} }")
    print(f"[classification] {name}: predictions.csv: " + " | ".join(csv_rows))

    # card against CPU: the best checkpoint's logits on one test volume per
    # class, and one float32 training step at the template's batch of
    # validation samples from the seeded initial weights
    best = str(Path(wf.cfg.PATHS.CHECKPOINT) / f"{name}-checkpoint-best.ckpt")
    vcfg = dict(cfg, TEST=dict(cfg["TEST"], REDUCE_MEMORY=True))
    # predict takes a volume as it is: resized and fitted as the test pass does
    patch = tuple(wf.cfg.DATA.PATCH_SIZE)[:3]
    vols = [cls_engine._fit_to_patch(preprocess(wf.cfg.DATA.PREPROCESS, v[..., None],
                                                is_2d=False), patch) for v in firsts]
    vs = _card_vs_cpu(name, vcfg, best, vols, root, classifier=True,
                      done=lambda v: _print_vs_plain(name, v))
    samples = [wf.val_data.get(i % len(wf.val_data), np.random.default_rng(0))
               for i in range(bs)]
    batch = {k: np.stack([smp[k] for smp in samples]) for k in ("x", "y")}
    step_worst = _restoration_step_vs_plain(
        cfg, None, batch, root, name, CLS_STEP_TOLS[r["arch"]], float(wf.cfg.TRAIN.LR[0]),
        done=lambda w, shape=batch["x"].shape: _print_step_vs_plain(name, w, shape))
    build.reset_launches()
    r.update(card_vs_cpu=vs, step_vs_plain=step_worst)
    return r


def _print_vs_plain(name, vs, tag="classification"):
    for dt, v in vs.items():
        print(f"[{tag}-vs-plain] {name} {dt}: max |card - CPU| = "
              f"{v['max_abs']:.3g}, mean {v['mean_abs']:.3g}"
              + (f" (scale {v['scale']:.3g}" + (f"; probabilities {v['prob_max_abs']:.3g}"
                                                 if "prob_max_abs" in v else "") + ")"
                 if "scale" in v else "")
              + f"; against the card's float32: card "
              f"max {v['to_f32']['card']['max_abs']:.3g} mean "
              f"{v['to_f32']['card']['mean_abs']:.3g}, CPU max "
              f"{v['to_f32']['cpu']['max_abs']:.3g} mean {v['to_f32']['cpu']['mean_abs']:.3g}"
              + (f"; argmax card {v['argmax']['card']} CPU {v['argmax']['cpu']}"
                 if "argmax" in v else "")
              + f"; card {v['card_s']:.2f} s, CPU {v['cpu_s']:.2f} s")


def _print_step_vs_plain(name, step_worst, step_shape, tag="classification"):
    print(f"[{tag}-vs-plain] {name}: one float32 training step on {tuple(step_shape)}: "
          f"max scaled differences {step_worst}")


def _variant_run(variant, base_cfg, vols, root, smi, total):
    """(c) One U-Net variant on the semantic template: VARIANT_STEPS bf16
    training steps at the template's batch and patch and one ``predict``
    (bf16 under the template's REDUCE_MEMORY), launches held to the model's
    count and added to ``total``; then card against CPU at a reduced
    patch."""
    import copy

    import numpy as np
    import torch

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.data.norm import normalize_image
    from biapy_tpu_torch.engine.train_engine import make_train_step
    from biapy_tpu_torch.ops.kernels import build

    cfg = copy.deepcopy(base_cfg)
    cfg["MODEL"]["ARCHITECTURE"] = variant
    job = BiaPy(cfg, result_dir=str(root / "results"), name=variant, silent=True,
                check_data_paths=False, device=DEVICE)
    job._build_workflow()
    wf = job.workflow
    calls = _count_forwards(wf)
    wf.prepare_model()
    d, h, w = (int(v) for v in wf.cfg.DATA.PATCH_SIZE[:3])
    bs = int(wf.cfg.TRAIN.BATCH_SIZE)
    (img, msk), test_vol = vols
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(VARIANT_STEPS):
        xs, ys = [], []
        for _ in range(bs):
            z0, y0, x0 = (int(rng.integers(0, n - p + 1)) for n, p in zip(img.shape, (d, h, w)))
            sl = (slice(z0, z0 + d), slice(y0, y0 + h), slice(x0, x0 + w))
            xs.append(normalize_image(img[sl][..., None], wf.norm_spec)[0])
            ys.append((msk[sl][..., None] > 0).astype(np.float32))
        batches.append({"x": torch.from_numpy(np.stack(xs).astype(np.float32)).to(DEVICE),
                        "y": torch.from_numpy(np.stack(ys)).to(DEVICE)})
    step = make_train_step(wf.loss, wf.train_metrics, mixed_precision=True)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    torch.cuda.synchronize()
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = []
    for b in batches:
        wf.state, m = step(wf.state, b, gen)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / VARIANT_STEPS
    t0 = time.perf_counter()
    pred = job.predict(test_vol)[0]["pred"]
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(build.LAUNCHES)
    routes = dict(build.CONV3D_ROUTES)
    shuffle_routes = {k: dict(v) for k, v in build.SHUFFLE_ROUTES.items()}
    _launch_totals(total)
    want, want_routes = _expected_launches(wf.model, calls)
    if (not all(np.isfinite(losses)) or pred.shape != VARIANT_TEST_SHAPE + (1,)
            or not np.all(np.isfinite(pred))):
        raise AssertionError(f"{variant}: losses {losses}, prediction {pred.shape}")
    if (launches != want or routes != want_routes
            or any(v["scalar"] for v in shuffle_routes.values())):
        raise AssertionError(f"{variant}: launches {launches} (want {want}), conv3d routes "
                             f"{routes} (want {want_routes}), shuffle routes {shuffle_routes}, "
                             f"{len(calls)} forwards")
    n_par = sum(p.numel() for p in wf.model.parameters())
    print(f"[variants] {smi}: {variant} on the semantic template ({list(wf.cfg.MODEL.FEATURE_MAPS)}, "
          f"patch {[d, h, w]}, batch {bs}, {n_par:,} parameters): {VARIANT_STEPS} bf16 steps at "
          f"{step_s:.3f} s ({bs / step_s:.2f} patches/s), loss {[round(v, 5) for v in losses]}; "
          f"predict {VARIANT_TEST_SHAPE} {predict_s:.2f} s; peak memory {peak / 2**30:.2f} GiB; "
          f"launches {launches} = the model's count; conv3d routes {routes}; pool and zcat "
          f"routes { {k: v for k, v in shuffle_routes.items() if sum(v.values())} }")
    ckpt = wf.save_checkpoint(0, metric="best")
    small = copy.deepcopy(cfg)
    small["DATA"]["PATCH_SIZE"] = VARIANT_SMALL_PATCH
    small["DATA"]["TEST"]["PADDING"] = VARIANT_SMALL_PADDING
    crop = test_vol[tuple(slice(0, n) for n in VARIANT_SMALL_CROP)]
    vs = _card_vs_cpu(variant, small, ckpt, [crop], root,
                      done=lambda v: _print_vs_plain(variant, v))
    sd, sh, sw = VARIANT_SMALL_PATCH[:3]
    x = batches[0]["x"][:1, :sd, :sh, :sw].cpu().numpy()
    y = batches[0]["y"][:1, :sd, :sh, :sw].cpu().numpy()
    step_worst = _restoration_step_vs_plain(
        small, ckpt, {"x": x, "y": y}, root, variant, CLS_STEP_TOLS["unet"],
        float(wf.cfg.TRAIN.LR[0]),
        done=lambda w, shape=x.shape: _print_step_vs_plain(variant, w, shape))
    build.reset_launches()
    return dict(steps=VARIANT_STEPS, step_seconds=step_s, loss=losses, predict_seconds=predict_s,
                peak_bytes=peak, launches=launches, conv3d_routes=routes,
                shuffle_routes=shuffle_routes, params=n_par, card_vs_cpu=vs,
                step_vs_plain=step_worst)


def phase_classification(smi):
    """(a) ``templates/classification/3d_classification.yaml`` as it is but
    for its data paths (seeded class folders: CLS_PER_CLASS volumes of
    CLS_SHAPE per class) and EPOCHS 2, through ``run_job``: RESIZE, the
    template's augmentations, simple_cnn at batch 8 on 32 x 64 x 64, ADAMW
    and one-cycle, the best checkpoint, the test pass and predictions.csv;
    (b) the same with ``MODEL.ARCHITECTURE: vit`` at the config's ViT
    defaults (and the patch and RESIZE at VIT_PATCH); each with run_job
    seconds, the loop's patches/s and the device's idle share over a
    profiled epoch, host seconds per sample of the resize and of
    augmentation, peak memory, test accuracy, predictions.csv and launches
    by kernel and route against the counts read off the model; its best
    checkpoint card against CPU and one float32 training step card against
    CPU. (c) The semantic template with ``seunet``, ``resunet_se`` and
    ``attention_unet``: bf16 training steps and a predict, launches against
    the model's count, card against CPU."""
    import copy
    import shutil

    import torch
    import yaml  # the templates are YAML; PyYAML is optional for the port itself

    root0 = OUT_DIR / "chip_smoke_classification"
    shutil.rmtree(root0, ignore_errors=True)
    res = {}
    total = {"launches": {}, "conv3d_routes": {}, "shuffle_routes": {}}
    try:
        t0 = time.perf_counter()
        firsts = _write_classification_data(root0 / "data")
        res["data_seconds"] = time.perf_counter() - t0
        with open(REPO / CLASSIFICATION_TEMPLATE) as f:
            base = yaml.safe_load(f)
        base["DATA"]["TRAIN"]["PATH"] = str(root0 / "data/train")
        base["DATA"]["TEST"]["PATH"] = str(root0 / "data/test")
        base["TRAIN"]["EPOCHS"] = 2
        res["simple_cnn"] = _classification_job("classification", base, root0 / "simple_cnn",
                                                smi, firsts, total)
        vit = copy.deepcopy(base)
        vit["MODEL"]["ARCHITECTURE"] = "vit"
        vit["DATA"]["PATCH_SIZE"] = list(VIT_PATCH) + [1]
        vit["DATA"]["PREPROCESS"]["RESIZE"]["OUTPUT_SHAPE"] = list(VIT_PATCH)
        res["vit"] = _classification_job("classification_vit", vit, root0 / "vit", smi, firsts,
                                         total)

        with open(TEMPLATE) as f:
            sem = yaml.safe_load(f)
        g = torch.Generator(device=DEVICE).manual_seed(16)
        vols = (_job_volume(g, TEMPLATE_TRAIN_SHAPE, DEVICE),
                _job_volume(g, VARIANT_TEST_SHAPE, DEVICE)[0])
        for variant in UNET_VARIANTS:
            res[variant] = _variant_run(variant, sem, vols, root0 / variant, smi, total)
        res.update(total)
        return res
    finally:
        shutil.rmtree(root0, ignore_errors=True)


# phase 16: the repository's 2D templates on seeded 2D TIFFs, each through
# run_job, then its best checkpoint card vs CPU; one predict with
# TEST.FULL_IMG; the ViT in 2D
TWOD_TEMPLATES = {
    "semantic": "templates/semantic_segmentation/2d_semantic_segmentation.yaml",
    "instance": "templates/instance_segmentation/2d_instance_segmentation.yaml",
    "detection": "templates/detection/2d_detection.yaml",
    "denoising": "templates/denoising/2d_denoising.yaml",
    "image_to_image": "templates/image-to-image/2d_image-to-image.yaml",
    "super_resolution": "templates/super-resolution/2d_super-resolution.yaml",
    "classification": "templates/classification/2d_classification.yaml",
}
# the training images (count, (y, x)) and the test image's (y, x); for
# super-resolution the LR sizes (the HR twice them)
TWOD_DATA = {"semantic": (3, (768, 768), (512, 512)), "instance": (3, (768, 768), (512, 512)),
             "detection": (3, (768, 768), (512, 512)), "denoising": (2, (512, 512), (512, 512)),
             "image_to_image": (3, (768, 768), (512, 512)),
             "super_resolution": (3, (384, 384), (256, 256))}
# classification: four classes (the template's N_CLASSES) of 3-channel
# images that RESIZE takes to the 224 x 224 patch
TWOD_CLS_SHAPE, TWOD_CLS_PER_CLASS = (256, 256), {"train": 20, "test": 2}
# card vs CPU: a crop of the test image (SR: of the LR one) and the y-x size
# of the one-sample float32 training step (SR: LR)
TWOD_CROP, TWOD_STEP_YX = (256, 256), 128
# the whole-image forward: padded to 640 x 576 by reflection
TWOD_FULL_IMG = (600, 520)
# the disks' and blobs' grid spacing: one object per cell, never touching
TWOD_CELL = 32


def _twod_objects(g, shape, kind):
    """A uint8 image of objects on a jittered grid (one per TWOD_CELL cell,
    made on the card) and its target: for ``instance`` uint16 labels of
    disks (radius 6-11), for ``detection`` the blob centres as an (n, 2)
    array (Gaussian blobs, sigma 2-3), else a 0/255 mask of the disks."""
    import torch

    cy, cx = shape[0] // TWOD_CELL, shape[1] // TWOD_CELL
    n = cy * cx
    r = 6 + 5 * torch.rand(n, generator=g, device=DEVICE)
    off = r[:, None] + (TWOD_CELL - 2 * r[:, None]) * torch.rand((n, 2), generator=g,
                                                                  device=DEVICE)
    cell = torch.stack(torch.meshgrid(torch.arange(cy, device=DEVICE),
                                      torch.arange(cx, device=DEVICE), indexing="ij"),
                       -1).reshape(n, 2)
    centres = cell * TWOD_CELL + off
    yy, xx = torch.meshgrid(torch.arange(shape[0], device=DEVICE, dtype=torch.float32),
                            torch.arange(shape[1], device=DEVICE, dtype=torch.float32),
                            indexing="ij")
    ci = ((yy // TWOD_CELL).clamp(max=cy - 1) * cx + (xx // TWOD_CELL).clamp(max=cx - 1)).long()
    d2 = (yy - centres[ci, 0]) ** 2 + (xx - centres[ci, 1]) ** 2
    noise = torch.randn(shape, generator=g, device=DEVICE)
    if kind == "detection":
        sig = 2 + torch.rand(n, generator=g, device=DEVICE)
        img = 30 + 180 * torch.exp(-0.5 * d2 / sig[ci] ** 2) + 12 * noise
        target = centres.round().long().cpu().numpy()
    else:
        inside = d2 < r[ci] ** 2
        img = 60 + 110 * inside + 18 * noise
        target = (((ci + 1) * inside).to(torch.int32).cpu().numpy().astype("uint16")
                  if kind == "instance" else (inside.to(torch.uint8) * 255).cpu().numpy())
    return img.clamp(0, 255).round().to(torch.uint8).cpu().numpy(), target


def _twod_class_image(g, ci, shape):
    """A 3-channel uint8 image of class ``ci`` (four that differ in colour
    and texture), made on the card."""
    import math

    import torch

    noise = torch.randn(shape + (3,), generator=g, device=DEVICE)
    x = torch.arange(shape[1], device=DEVICE, dtype=torch.float32)
    base = torch.tensor([[60, 60, 60], [200, 90, 60], [60, 200, 90], [90, 60, 200]][ci],
                        device=DEVICE, dtype=torch.float32)
    stripes = 30 * torch.sin(2 * math.pi * x / (4 + 4 * ci))[None, :, None]
    img = base + stripes + 15 * noise
    return img.clamp(0, 255).round().to(torch.uint8).cpu().numpy()


def _write_2d_data(kind, root, n_train=None):
    """Training images under train/, one test image under test/ (inputs in
    x/, targets in y/: masks, labels, CSV points, HR images or
    image-to-image targets); classification: class folders; ``n_train``
    training images in place of TWOD_DATA's count. Returns the
    test image and its target (classification: one test image per
    class)."""
    import csv

    import numpy as np
    import torch
    from scipy import ndimage

    from biapy_tpu_torch.data.tiff import write_tiff

    g = torch.Generator(device=DEVICE).manual_seed(16)
    if kind == "classification":
        firsts = []
        for split, n in TWOD_CLS_PER_CLASS.items():
            for ci in range(4):
                d = root / split / f"class{ci}"
                d.mkdir(parents=True, exist_ok=True)
                for i in range(n):
                    img = _twod_class_image(g, ci, TWOD_CLS_SHAPE)
                    write_tiff(str(d / f"c{ci}_{i:03d}.tif"), img)
                    if split == "test" and i == 0:
                        firsts.append(img)
        return firsts
    n, shape, test_shape = TWOD_DATA[kind]
    n = n_train or n
    test = None
    for split, count, shp in (("train", n, shape), ("test", 1, test_shape)):
        (root / split / "x").mkdir(parents=True, exist_ok=True)
        (root / split / "y").mkdir(parents=True, exist_ok=True)
        for i in range(count):
            name = f"{split}_{i:03d}.tif"
            if kind in ("semantic", "instance", "detection"):
                img, tgt = _twod_objects(g, shp, kind)
            elif kind == "super_resolution":
                hr = _smooth_volume(g, (2 * shp[0], 2 * shp[1]), 6)
                img = np.round(hr.reshape(shp[0], 2, shp[1], 2).mean(axis=(1, 3))).astype(
                    np.uint8)
                tgt = hr
            else:
                img = _smooth_volume(g, shp, 12)
                tgt = None
                if kind == "image_to_image":
                    blur = ndimage.gaussian_filter(img.astype(np.float32), 1.5)
                    tgt = (255 - blur).round().clip(0, 255).astype(np.uint8)
            write_tiff(str(root / split / "x" / name), img)
            if kind == "detection":
                with open(root / split / "y" / name.replace(".tif", ".csv"), "w",
                          newline="") as f:
                    w = csv.writer(f)
                    w.writerow(["axis-0", "axis-1"])
                    w.writerows(tgt.tolist())
            elif tgt is not None:
                write_tiff(str(root / split / "y" / name), tgt)
            if split == "test":
                test = (img, tgt)
    return test


def _launches_2d(model, dtype, training):
    """Kernel launches of one forward (``training``: one training step) of a
    2D model, read off it: a pool per encoder level of a U-Net (two in
    simple_cnn) and in training its backward; no conv3d, zcat, zd2s or
    zs2d (2D convs are PyTorch's, the transposed conv has no z phase), no
    conv3d route. The ViT, the super-resolution family and EfficientNet
    launch no kernel of the port in 2D."""
    from biapy_tpu_torch.models.simple_cnn import SimpleCNN
    from biapy_tpu_torch.models.unet_family import UNetFamily

    out = dict.fromkeys(KERNEL_META, 0)
    pools = (len(model.windows) if isinstance(model, UNetFamily)
             else 2 if isinstance(model, SimpleCNN) else 0)
    out["pool_max_folded"] = pools
    if training:
        out["pool_max_folded_bwd"] = pools
    return out, dict.fromkeys(CONV3D_ROUTE_NAMES, 0)


def _twod_metric(kind, wf):
    """The template's metric, as a record (two epochs)."""
    if kind == "instance":
        m = {s["thresh"]: s for s in wf.matching_stats}
        return {"matching_f1@0.5": m[0.5]["f1"]} if 0.5 in m else {}
    stats = getattr(wf, "stats", None) or {}
    keys = {"semantic": ("iou",), "detection": ("det_precision", "det_recall", "det_f1"),
            "image_to_image": ("psnr", "ssim"), "super_resolution": ("psnr", "ssim"),
            "classification": ("accuracy",), "denoising": ()}[kind]
    return {k: stats[k] for k in keys if k in stats}


def _twod_job(kind, cfg, test, root, smi, total):
    """One 2D template through run_job on the card with its measurements,
    its launches held to the model's count and added to ``total``; then its
    best checkpoint card against CPU and one float32 training step card
    against CPU."""
    import numpy as np
    import torch

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.data.pre_processing import preprocess_image
    from biapy_tpu_torch.engine import classification as cls_engine
    from biapy_tpu_torch.engine.train_engine import make_train_step, resolve_mixed_precision
    from biapy_tpu_torch.ops.kernels import build

    tpl = TWOD_TEMPLATES[kind]
    job = BiaPy(cfg, result_dir=str(root / "results"), name=kind, silent=True, device=DEVICE)
    job._build_workflow()
    wf = job.workflow
    calls = _count_forwards(wf)
    loop_s, train_s, test_s = [], [], []
    one_epoch = wf.train_one_epoch
    wf.train_one_epoch = _timed(one_epoch, loop_s)
    wf.train, wf.test = _timed(wf.train, train_s), _timed(wf.test, test_s)
    torch.cuda.synchronize()
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    job.run_job()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(build.LAUNCHES)
    routes = dict(build.CONV3D_ROUTES)
    shuffle_routes = {k: dict(v) for k, v in build.SHUFFLE_ROUTES.items()}
    _launch_totals(total)
    want, want_routes = _expected_launches(wf.model, calls, _launches_2d)
    hist = wf.history
    if (len(hist) != 2 or not all(np.isfinite(h["loss"]) for h in hist)
            or launches != want or routes != want_routes
            or any(v["scalar"] for v in shuffle_routes.values())):
        raise AssertionError(f"{kind}: epochs {hist}, launches {launches} (want {want}), "
                             f"conv3d routes {routes}, shuffle routes {shuffle_routes}, "
                             f"{len(calls)} forwards")
    metric = _twod_metric(kind, wf)
    if kind == "classification":
        n_px = len(wf._predictions) * int(np.prod(TWOD_CLS_SHAPE))
        pred_ok = (len(wf._predictions) == 4 * TWOD_CLS_PER_CLASS["test"]
                   and all(np.all(np.isfinite(p["pred"])) and p["pred"].shape == (4,)
                           for p in wf._predictions))
    else:
        up = wf.y_upscaling
        n_px = int(np.prod(test[0].shape))
        pred = [p["pred"] for p in wf._predictions if p.get("role") == "raw"]
        out_shape = tuple(s * u for s, u in zip(test[0].shape, up))
        pred_ok = len(pred) == 1 and pred[0].shape[:2] == out_shape and np.all(
            np.isfinite(pred[0]))
    if not pred_ok or (kind != "denoising" and not metric):
        raise AssertionError(f"{kind}: test predictions {len(wf._predictions)}, metric {metric}")
    # the loop alone: one more epoch profiled; 2D launches no conv3d, so the
    # idle share is over the whole epoch's device events
    mixed = resolve_mixed_precision(wf.cfg.TRAIN.MIXED_PRECISION, wf.device)
    step = make_train_step(wf.loss, wf.train_metrics, mixed_precision=mixed)
    gen = torch.Generator(device=wf.device).manual_seed(1)
    steps = len(wf.train_loader)
    wall, _, _, events = _profile_device(lambda: one_epoch(step, 3, gen))
    idle, window_ms = _window_idle_share(events)
    build.reset_launches()
    bs = int(wf.cfg.TRAIN.BATCH_SIZE)
    r = dict(template=tpl, arch=str(wf.cfg.MODEL.ARCHITECTURE), patch=list(wf.cfg.DATA.PATCH_SIZE),
             batch=bs, seconds=secs, train_seconds=train_s[0], test_seconds=test_s[0],
             epoch_seconds=[h["time"] for h in hist], loss=[h["loss"] for h in hist],
             loop_seconds=loop_s, loop_patches_per_s=[steps * bs / t for t in loop_s],
             idle_share=idle, idle_window_ms=window_ms, profiled_epoch_s=wall,
             test_mpx_per_s=n_px / test_s[0] / 1e6, metric=metric, peak_bytes=peak,
             launches=launches, conv3d_routes=routes, shuffle_routes=shuffle_routes,
             forwards=len(calls), steps=steps, train_patches=len(wf.train_data),
             val_patches=len(wf.val_data),
             change=("AUGMENTOR.RANDOM_ROT False" if kind == "super_resolution" else None))
    fm = f" {list(wf.cfg.MODEL.FEATURE_MAPS)}" if r["arch"] in ("unet", "resunet") else ""
    print(f"[2d] {smi}: {tpl}: {r['arch']}{fm}, patch {r['patch']}, "
          f"batch {bs}, {len(wf.train_data)} train / {len(wf.val_data)} val patches, 2 epochs"
          + (f", changed: {r['change']}" if r["change"] else "")
          + (" (ROADMAP section 3: the reference's affine_2d crops the SR target to the "
             "input's size)" if kind == "super_resolution" else "")
          + f": run_job {secs:.2f} s (train {train_s[0]:.2f}, test {test_s[0]:.2f}); loop s per "
          f"epoch {[round(t, 3) for t in loop_s]} "
          f"({[round(v, 1) for v in r['loop_patches_per_s']]} patches/s), device idle "
          f"{100 * idle:.1f}% of a profiled epoch; test {r['test_mpx_per_s']:.3f} Mpx/s; "
          f"{ {k: round(float(v), 4) for k, v in metric.items()} } (a record: 2 epochs); "
          f"peak memory {peak / 2**30:.2f} GiB; launches "
          f"{ {k: v for k, v in launches.items() if v} } over {len(calls)} forwards = the "
          f"model's count, no conv3d route, pool routes "
          f"{ {k: v for k, v in shuffle_routes.items() if sum(v.values())} }")

    # card against CPU: the best checkpoint on a crop of the test image (for
    # classification one resized test image per class), one training step
    best = r["best"] = str(Path(wf.cfg.PATHS.CHECKPOINT) / f"{kind}-checkpoint-best.ckpt")
    if kind == "classification":
        patch = tuple(wf.cfg.DATA.PATCH_SIZE)[:2]
        inputs = [cls_engine._fit_to_patch(preprocess_image(wf.cfg.DATA.PREPROCESS, v,
                                                            is_2d=True), patch) for v in test]
        vcfg = dict(cfg, TEST=dict(cfg["TEST"], REDUCE_MEMORY=True))
        vs = _card_vs_cpu(kind, vcfg, best, inputs, root, classifier=True,
                          done=lambda v: _print_vs_plain(kind, v, "2d"))
    else:
        ch = TWOD_CROP if kind != "super_resolution" else tuple(c // 2 for c in TWOD_CROP)
        # super-resolution's rcan puts out values far above 1 (no residual
        # scaling over 200 RCABs, ROADMAP section 3): within 1e-4 of scale
        vs = _card_vs_cpu(kind, cfg, best, [test[0][:ch[0], :ch[1]]], root,
                          done=lambda v: _print_vs_plain(kind, v, "2d"),
                          scaled=kind == "super_resolution")
    if kind == "classification":
        samples = [wf.val_data.get(i % len(wf.val_data), np.random.default_rng(0))
                   for i in range(4)]
        batch = {k: np.stack([smp[k] for smp in samples]) for k in ("x", "y")}
        # simple_cnn's step at its own limits (CLS_STEP_TOLS); EfficientNet's
        # (SiLU, no max-pool) at phase 8's rule
        step_worst = _restoration_step_vs_plain(
            cfg, None, batch, root, kind, CLS_STEP_TOLS.get(r["arch"]),
            float(wf.cfg.TRAIN.LR[0]),
            done=lambda w, shape=batch["x"].shape: _print_step_vs_plain(kind, w, shape, "2d"))
    else:
        up = wf.y_upscaling
        yx = TWOD_STEP_YX if kind != "super_resolution" else TWOD_STEP_YX // 2
        sample = wf.val_data.get(0, np.random.default_rng(0))
        batch = {"x": sample["x"][None, :yx, :yx],
                 "y": sample["y"][None, :yx * up[0], :yx * up[1]]}
        # rcan's step from the seeded weights at RCAN_STEP_TOLS (2D)
        rcan = r["arch"] == "rcan"
        step_worst = _restoration_step_vs_plain(
            cfg, None if rcan else best, batch, root, kind, RCAN_STEP_TOLS[2] if rcan else None,
            done=lambda w, shape=batch["x"].shape: _print_step_vs_plain(kind, w, shape, "2d"))
    build.reset_launches()
    r.update(card_vs_cpu=vs, step_vs_plain=step_worst)
    return r, batch


def _forward_on(c, x, result_dir, name, dev):
    """One side of ``_forward_vs_cpu``: the job ``c``'s model from its seeded
    initial weights (drawn on the CPU from SYSTEM.SEED, so the same on either
    device) in eval, float32, on ``x``; its output (a classifier's logits)
    as float32 numpy, and the seconds of the forward."""
    import torch

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.engine.base_workflow import flat_outputs

    job = BiaPy(c, result_dir=result_dir, name=name, silent=True, check_data_paths=False,
                device=dev)
    job._build_workflow()
    wf = job.workflow
    wf.prepare_model()
    wf.model.eval()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = flat_outputs(wf.model(torch.from_numpy(x).to(dev))).float().cpu().numpy()
    return out, time.perf_counter() - t0


def _forward_vs_cpu(name, c, x, root, done=None):
    """The job ``c``'s model from its seeded initial weights on ``x``,
    float32, on the card and on the CPU (plain versions): within 1e-4 of the
    output's scale. The CPU side runs in the CPU-side child; the comparison,
    after the last phase, fills the returned dict and then calls ``done``
    with it."""
    import numpy as np

    cpu = _cpu_side("_forward_on", c=c, x=x, result_dir=str(CPU_SIDE_RESULTS),
                    name=f"{name}_fwd_cpu", dev="cpu")
    card, card_s = _forward_on(c, x, str(root / "vs_plain"), f"{name}_fwd_card", DEVICE)
    out = {}

    def finish():
        ref, cpu_s = cpu()
        scale = max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(card - ref).max())
        out.update(shape=list(card.shape), max_abs=err, scale=scale, card_s=card_s, cpu_s=cpu_s)
        if not (card.shape == ref.shape and err <= 1e-4 * scale):
            raise AssertionError(f"{name}: float32 forward, card and CPU differ: {out}")
        if done:
            done(out)
    _CPU_SIDE["pending"].append(finish)
    return out


def _print_forward_vs_plain(name, v):
    print(f"[2d-vs-plain] {name}: float32 forward from seeded weights on "
          f"{tuple(v['shape'])}: max |card - CPU| = {v['max_abs']:.3g} (scale "
          f"{v['scale']:.3g}); card {v['card_s']:.3f} s, CPU {v['cpu_s']:.3f} s")


def _twod_other_models(kind, cfg, patch, batch, root):
    """The other models of a 2D template's comment, each from its seeded
    initial weights, card against CPU: for super-resolution edsr, wdsr and
    dfcan (a float32 forward at the template's patch) and unet (the model
    phase 16 ran before the template's rcan: a forward and one float32
    training step), for classification simple_cnn (likewise, before
    efficientnet_b0; its step at ``CLS_STEP_TOLS``). ``batch`` is the
    template's own job's step batch, ``patch`` its DATA.PATCH_SIZE."""
    import copy

    import numpy as np

    archs = (("edsr", "wdsr", "dfcan", "unet") if kind == "super_resolution"
             else ("simple_cnn",))
    x = np.random.default_rng(16).standard_normal((2,) + tuple(patch)).astype(np.float32)
    res = {}
    for arch in archs:
        c = copy.deepcopy(cfg)
        c["MODEL"]["ARCHITECTURE"] = arch
        name = f"{kind}_{arch}"
        res[arch] = {"forward": _forward_vs_cpu(
            name, c, x, root, done=lambda v, name=name: _print_forward_vs_plain(name, v))}
        if arch in ("unet", "simple_cnn"):
            tols = CLS_STEP_TOLS["simple_cnn"] if arch == "simple_cnn" else None
            lr = cfg["TRAIN"]["LR"]
            lr = float(lr[0] if isinstance(lr, list) else lr) if arch == "simple_cnn" else 0.05
            res[arch]["step"] = _restoration_step_vs_plain(
                c, None, batch, root, name, tols, lr,
                done=lambda w, name=name, shape=batch["x"].shape: _print_step_vs_plain(
                    name, w, shape, "2d"))
    return res


def _twod_vit(cfg, root, smi):
    """The 2D classification template with ``vit`` at the config's ViT
    defaults (224 x 224 x 3: 196 tokens of 16^2): one float32 forward card
    against CPU (logits within 1e-4 of their scale) and one bf16 training
    step on the card (a finite loss, no kernel of the port launched)."""
    import copy

    import numpy as np
    import torch

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.engine.train_engine import make_train_step
    from biapy_tpu_torch.ops.kernels import build

    c = copy.deepcopy(cfg)
    c["MODEL"]["ARCHITECTURE"] = "vit"
    job = BiaPy(c, result_dir=str(root / "vit"), name="vit2d", silent=True,
                check_data_paths=False, device=DEVICE)
    job._build_workflow()
    wf = job.workflow
    wf.prepare_model()
    model = wf.model
    cpu = copy.deepcopy(model).to("cpu").eval()
    model.eval()
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2,) + tuple(wf.cfg.DATA.PATCH_SIZE)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x).to(DEVICE)).cpu()
        ref = cpu(torch.from_numpy(x))
    scale = max(1.0, float(ref.abs().max()))
    err = float((got - ref).abs().max())
    build.reset_launches()
    model.train()
    step = make_train_step(wf.loss, wf.train_metrics, mixed_precision=True)
    batch = {"x": torch.from_numpy(x).to(DEVICE),
             "y": torch.tensor([[1.0], [3.0]], device=DEVICE)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wf.state, m = step(wf.state, batch, torch.Generator(device=DEVICE).manual_seed(1))
    loss = float(m["loss"])
    step_s = time.perf_counter() - t0
    launched = sum(build.LAUNCHES.values())
    n_par = sum(p.numel() for p in model.parameters())
    print(f"[2d] {smi}: vit in 2D ({n_par:,} parameters, patch {list(wf.cfg.DATA.PATCH_SIZE)}): "
          f"float32 logits card vs CPU max {err:.3g} (scale {scale:.3g}); one bf16 step "
          f"{step_s:.3f} s (the first), loss {loss:.5f}, {launched} launches of the port's "
          "kernels")
    if not (err <= 1e-4 * scale and np.isfinite(loss) and launched == 0):
        raise AssertionError(f"vit 2D: logits {err} (scale {scale}), loss {loss}, "
                             f"{launched} launches")
    return dict(params=n_par, logits_max_abs=err, scale=scale, bf16_step_loss=loss,
                bf16_step_seconds=step_s, launches=launched)


def _twod_full_img(cfg, ckpt, root, smi, total):
    """``predict`` with TEST.FULL_IMG (the image reflect-padded to a multiple
    of 64, one forward, cropped back) from the semantic template's best
    checkpoint on a seeded TWOD_FULL_IMG image: Mpx/s and the launches of
    one forward on the card, card against CPU (``_card_vs_cpu``'s rule)."""
    import copy

    import numpy as np
    import torch

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.ops.kernels import build

    c = copy.deepcopy(cfg)
    c["TEST"]["FULL_IMG"] = True
    c["TRAIN"]["ENABLE"] = False
    c["MODEL"]["LOAD_CHECKPOINT"] = True
    c["PATHS"] = {"CHECKPOINT_FILE": ckpt}
    img = _twod_objects(torch.Generator(device=DEVICE).manual_seed(17), TWOD_FULL_IMG,
                        "semantic")[0]
    job = BiaPy(c, result_dir=str(root / "full_img"), name="full_img", silent=True,
                check_data_paths=False, device=DEVICE)
    job._build_workflow()
    calls = _count_forwards(job.workflow)
    job.predict(img)  # warm-up: builds the model and the bf16 copy
    build.reset_launches()
    calls.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = job.predict(img)[0]["pred"]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    _launch_totals(total)
    want, _ = _expected_launches(job.workflow.model, calls, _launches_2d)
    if pred.shape != TWOD_FULL_IMG + (1,) or not np.all(np.isfinite(pred)) or launches != want \
            or len(calls) != 1:
        raise AssertionError(f"FULL_IMG: prediction {pred.shape}, launches {launches} (want "
                             f"{want}), {len(calls)} forwards")
    vs = _card_vs_cpu("full_img", c, ckpt, [img], root,
                      done=lambda v: _print_vs_plain("full_img", v, "2d"))
    mpx = float(np.prod(TWOD_FULL_IMG)) / secs / 1e6
    print(f"[2d] {smi}: TEST.FULL_IMG predict {TWOD_FULL_IMG} (one forward at "
          f"{tuple(-(-n // 64) * 64 for n in TWOD_FULL_IMG)}): {secs:.3f} s, {mpx:.3f} Mpx/s; "
          f"launches { {k: v for k, v in launches.items() if v} } = one forward's")
    return dict(seconds=secs, mpx_per_s=mpx, launches=launches, card_vs_cpu=vs)


def phase_2d(smi):
    """(a) The 2D templates (semantic, instance, detection, denoising,
    image-to-image, super-resolution with its ``rcan`` and RANDOM_ROT off,
    and classification with its ``efficientnet_b0``) loaded as they are,
    with only their data paths (seeded uint8 TIFFs), EPOCHS 2 and that one
    change, through ``run_job``: seconds, the loop's patches/s and the
    device's idle share over a profiled epoch, test Mpx/s, peak memory, the
    template's metric (a record), launches by kernel and route against the
    counts read off the model (pool and pool backward only, none on
    ``scalar``); each best checkpoint card against CPU and one float32
    training step card against CPU; the super-resolution template's other
    models (edsr, wdsr, dfcan, unet) and the classification template's
    simple_cnn from seeded weights, card against CPU
    (``_twod_other_models``). (b) One ``predict`` with TEST.FULL_IMG. (c)
    ``vit`` in 2D: one float32 forward card against CPU and one bf16
    step."""
    import shutil

    import yaml  # the templates are YAML; PyYAML is optional for the port itself

    root0 = OUT_DIR / "chip_smoke_2d"
    shutil.rmtree(root0, ignore_errors=True)
    total = {"launches": {}, "conv3d_routes": {}, "shuffle_routes": {}}
    res = {}
    try:
        for kind, tpl in TWOD_TEMPLATES.items():
            root = root0 / kind
            t0 = time.perf_counter()
            test = _write_2d_data(kind, root)
            data_s = time.perf_counter() - t0
            with open(REPO / tpl) as f:
                cfg = yaml.safe_load(f)
            if kind == "classification":
                cfg["DATA"]["TRAIN"]["PATH"] = str(root / "train")
                cfg["DATA"]["TEST"]["PATH"] = str(root / "test")
            else:
                cfg["DATA"]["TRAIN"]["PATH"] = str(root / "train/x")
                cfg["DATA"]["TEST"]["PATH"] = str(root / "test/x")
                if "GT_PATH" in cfg["DATA"]["TRAIN"]:
                    cfg["DATA"]["TRAIN"]["GT_PATH"] = str(root / "train/y")
                    cfg["DATA"]["TEST"]["GT_PATH"] = str(root / "test/y")
            cfg["TRAIN"]["EPOCHS"] = 2
            if kind == "super_resolution":
                # RANDOM_ROT: ROADMAP section 3
                cfg["AUGMENTOR"]["RANDOM_ROT"] = False
            res[kind], batch = _twod_job(kind, cfg, test, root, smi, total)
            res[kind].update(data_seconds=data_s, wall_seconds=time.perf_counter() - t0)
            t0 = time.perf_counter()
            if kind in ("super_resolution", "classification"):
                res[f"{kind}_others"] = _twod_other_models(kind, cfg, res[kind]["patch"],
                                                           batch, root)
                res[f"{kind}_others"]["wall_seconds"] = time.perf_counter() - t0
                t0 = time.perf_counter()
            if kind == "semantic":
                res["full_img"] = _twod_full_img(cfg, res[kind]["best"], root, smi, total)
                res["full_img"]["wall_seconds"] = time.perf_counter() - t0
            if kind == "classification":
                res["vit"] = _twod_vit(cfg, root, smi)
                res["vit"]["wall_seconds"] = time.perf_counter() - t0
        print("[2d] wall seconds (data, run_job, checks): "
              + ", ".join(f"{k} {v['wall_seconds']:.1f}" for k, v in res.items()))
        res.update(total)
        return res
    finally:
        shutil.rmtree(root0, ignore_errors=True)


# phase 17: the class heads (DATA.N_CLASSES 3) of the 3D instance and
# detection templates, on ellipsoids made as phase 12's (a seeded class for
# each) and blobs made as phase 13's (a seeded class for each point), one
# training volume each
CLASS_N = 3
# the card-vs-CPU training step on one patch of the template's size at the
# template's rate (TRAIN.LR): loss and weights at phase 15's limits (vit,
# unet), the gradients at a limit that the reference meets. On this phase's
# instance checkpoint the JAX package's own float32 step lies 6.4e-5 of
# scale from a float64 one in the gradients (loss 1.7e-7), the port's
# CPU step 5.1e-6 to 8.7e-6 and its card step 6.5e-5, all at the first
# level's second conv (``tools/torch_instance_step_witness.py``, batch 1,
# 40 x 128 x 128): the gradients limit is twice the reference's 6.4e-5. On
# seeded weights the card lay farther than the reference (5.4e-5 against
# 3.2e-5) until conv3d's float32 weight gradient went by groups of planes
# and its float32 CUDA-core kernel summed each chunk of products apart
# (``ops/kernels/conv3d.py``): 2.8e-6 since; the 3xTF32 kernel that took
# its place sums each ring step apart
CLASS_STEP_TOLS = {"loss": 1e-6, "grad": 1.3e-4, "weight": 1e-6}
# by chunks: the test volume's first 72 x 192 x 192 voxels, whole 12 x 96 x 96
# cores of the detection template (patch 20 x 128 x 128, padding 4 x 16 x 16):
# 6 x 2 x 2 tiles (phase 12 c's reasoning)
CLASS_DET_CHUNK_SHAPE = (72, 192, 192)


def _class_head_sources(root):
    """Phase 12's first training and test volumes of ellipsoids (labels as GT)
    and phase 13's of blobs (CSV points), made with the same generators and
    seeds, under ``root``."""
    import yaml

    from biapy_tpu_torch.data.tiff import write_tiff

    out = {}
    for kind, tpl in (("instance", INSTANCE_TEMPLATE), ("detection", DETECTION_TEMPLATE)):
        src = root / f"src_{kind}"
        with open(tpl) as f:
            cfg = yaml.safe_load(f)
        for split, seed in (("train", 0), ("test", 2)):
            for d in ("x", "y" if kind == "instance" else "csv"):
                (src / split / d).mkdir(parents=True)
            if kind == "instance":
                img, lab = _ellipsoids(INSTANCE_SHAPE, INSTANCE_COUNT, seed=seed)
                write_tiff(str(src / split / "y" / f"{split}_000.tif"), lab)
            else:
                img, pts = _blob_volume(DET_SHAPE, DET_BLOBS, seed=100 + seed)
                _points_csv(src / split / "csv" / f"{split}_000.csv", pts)
            write_tiff(str(src / split / "x" / f"{split}_000.tif"), img)
        out[kind] = dict(root=str(src), cfg=cfg)
    return out


def _class_head_cfg(src, kind, root):
    """The template of ``src`` with DATA.N_CLASSES 3, EPOCHS 2, its first
    training volume and its test volume (links under ``root``) and the GT
    with classes written by the caller under ``root``."""
    import copy
    import os
    import shutil

    cfg = copy.deepcopy(src["cfg"])
    gt = "y" if kind == "instance" else "csv"
    for split in ("train", "test"):
        (root / split / "x").mkdir(parents=True)
        (root / split / gt).mkdir(parents=True)
        f = sorted((Path(src["root"]) / split / "x").iterdir())[0]
        try:
            os.link(f, root / split / "x" / f.name)
        except OSError:
            shutil.copy(f, root / split / "x" / f.name)
        cfg["DATA"][split.upper()].update(PATH=str(root / split / "x"),
                                          GT_PATH=str(root / split / gt))
    cfg["DATA"]["N_CLASSES"] = CLASS_N
    cfg["TRAIN"]["EPOCHS"] = 2
    cfg["TRAIN"]["LR_SCHEDULER"]["WARMUP_COSINE_DECAY_EPOCHS"] = 1
    return cfg


def _class_head_job(kind, cfg, root, smi, total):
    """``run_job`` of a class-head config: launches against the model's count
    for every forward it ran (none on ``scalar``), two finite epochs and the
    best checkpoint; its seconds, loss, test metrics (a record: two epochs)."""
    import numpy as np
    import torch

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.ops.kernels import build

    job = BiaPy(cfg, result_dir=str(root / "results"), name=f"{kind}_cls", silent=True)
    job._build_workflow()
    wf = job.workflow
    calls = _count_forwards(wf)
    train_s, test_s = [], []
    wf.train, wf.test = _timed(wf.train, train_s), _timed(wf.test, test_s)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    job.run_job()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, routes = dict(build.LAUNCHES), dict(build.CONV3D_ROUTES)
    shuffle_routes = {k: dict(v) for k, v in build.SHUFFLE_ROUTES.items()}
    _launch_totals(total)
    want, want_routes = _expected_launches(wf.model, calls)
    hist = wf.history
    best = Path(wf.cfg.PATHS.CHECKPOINT) / f"{kind}_cls-checkpoint-best.ckpt"
    if (len(hist) != 2 or not all(np.isfinite(h["loss"]) for h in hist) or not best.exists()
            or launches != want or routes != want_routes
            or any(v["scalar"] for v in shuffle_routes.values())
            or wf.output_channels[-1] != CLASS_N or wf.output_channel_info[-1] != "class"):
        raise AssertionError(f"{kind} class head: epochs {hist}, {best.name} "
                             f"{best.exists()}, launches {launches} (want {want}), routes "
                             f"{routes} (want {want_routes}), shuffle routes {shuffle_routes}, "
                             f"heads {wf.output_channels} {wf.output_channel_info}")
    out = dict(seconds=secs, train_seconds=train_s[0], test_seconds=test_s[0],
               loss=[h["loss"] for h in hist], train_patches=len(wf.train_data),
               launches=launches, conv3d_routes=routes, forwards=len(calls), best=str(best))
    print(f"[class-heads] {smi}: {kind} template, N_CLASSES {CLASS_N}, heads "
          f"{wf.output_channels} {wf.output_channel_info}, {len(wf.train_data)} train patches, 2 "
          f"epochs: run_job {secs:.2f} s (train {train_s[0]:.2f}, test {test_s[0]:.2f}), loss "
          f"{[round(h['loss'], 5) for h in hist]}; launches {launches} over {len(calls)} "
          f"forwards, conv3d routes {routes}")
    return wf, out


def _class_head_side(c, crop, kind, result_dir, name, dev):
    """One side of ``_class_head_card_vs_cpu``: ``predict`` of ``crop`` on
    ``dev``; the model's heads of its one forward (read by a hook), the
    instances and their classes (or the points and theirs), the seconds."""
    import numpy as np

    from biapy_tpu_torch import BiaPy

    job = BiaPy(c, result_dir=result_dir, name=name, silent=True, check_data_paths=False,
                device=dev)
    job._build_workflow()
    outs = []
    _count_forwards(job.workflow, outs)
    t0 = time.perf_counter()
    preds = {p["role"]: p for p in job.predict(crop)}
    secs = time.perf_counter() - t0
    if len(outs) != 1 or sorted(outs[0]) != ["class", "pred"]:
        raise AssertionError(f"{kind} class head: {len(outs)} forwards of one patch, "
                             f"outputs {[sorted(o) for o in outs]}")
    if kind == "instance":
        found = (preds["instances"]["instances"].astype(np.int64),
                 preds["class_map"]["classes"].astype(np.int64))
    else:
        found = (np.asarray(preds["points"]["points"], np.int64),
                 np.asarray(preds["points"]["classes"], np.int64))
    return outs[0], found, secs


def _class_head_card_vs_cpu(kind, cfg, ckpt, crop, root):
    """``predict`` of ``ckpt`` on ``crop`` (one patch of the template's size:
    TEST.PADDING 0) on the card and on the CPU (plain versions), float32 and
    bf16 (REDUCE_MEMORY): the model's two heads (read by a hook: ``pred`` and
    ``class`` logits) within 1e-4 of their scale in float32, and in bf16 no
    farther from the card's float32 ones than the CPU's bf16 (phase 12 b's
    rule: 1.5x at the worst voxel, 1.2x on the mean); where the float32
    instances (or points) are the same on both sides, the same voted classes
    (point classes). The launches of the card's side are set back to 0. The
    CPU side runs in the CPU-side child; the comparison, after the last
    phase, fills the returned dict."""
    import copy

    from biapy_tpu_torch.ops.kernels import build

    runs, cpu = {}, {}
    for dt, reduce_mem in (("float32", False), ("bfloat16", True)):
        c = copy.deepcopy(cfg)
        c["TRAIN"]["ENABLE"] = False
        c["MODEL"].update(LOAD_CHECKPOINT=True, SKIP_UNMATCHED_LAYERS=False)
        c["PATHS"] = {"CHECKPOINT_FILE": ckpt}
        c["DATA"]["TEST"]["PADDING"] = [0, 0, 0]
        c["TEST"]["REDUCE_MEMORY"] = reduce_mem
        cpu[dt] = _cpu_side("_class_head_side", c=_cpu_ckpt(c), crop=crop, kind=kind,
                            result_dir=str(CPU_SIDE_RESULTS), name=f"{kind}_{dt}_cpu",
                            dev="cpu")
        runs[dt, "card"] = _class_head_side(c, crop, kind, str(root / "vs_plain"),
                                            f"{kind}_{dt}_card", DEVICE)
    build.reset_launches()
    res = {}

    def finish():
        for dt in ("float32", "bfloat16"):
            runs[dt, "cpu"] = cpu[dt]()
        res.update(_class_head_compare(kind, runs, crop))
    _CPU_SIDE["pending"].append(finish)
    return res


def _class_head_compare(kind, runs, crop):
    import numpy as np

    out = {}
    ok = True
    for dt in ("float32", "bfloat16"):
        heads, (f_card, f_cpu) = {}, (runs[dt, "card"][1], runs[dt, "cpu"][1])
        for h in ("pred", "class"):
            card, cpu = runs[dt, "card"][0][h], runs[dt, "cpu"][0][h]
            ref = runs["float32", "card"][0][h]
            scale = max(1.0, float(np.abs(runs["float32", "cpu"][0][h]).max()))
            heads[h] = dict(max_abs=float(np.abs(card - cpu).max()), scale=scale,
                            to_f32={side: dict(max_abs=float(np.abs(v - ref).max()),
                                               mean_abs=float(np.abs(v - ref).mean()))
                                    for side, v in (("card", card), ("cpu", cpu))})
            if dt == "float32":
                ok = ok and heads[h]["max_abs"] <= 1e-4 * scale
            else:
                tc, tp = heads[h]["to_f32"]["card"], heads[h]["to_f32"]["cpu"]
                ok = ok and (tc["max_abs"] <= 1.5 * tp["max_abs"]
                             and tc["mean_abs"] <= 1.2 * tp["mean_abs"])
        if kind == "instance":
            (i_card, c_card), (i_cpu, c_cpu) = f_card, f_cpu
            same = (i_card == i_cpu) & (i_card > 0)
            n_same, n_cls_diff = int(same.sum()), int(np.count_nonzero(c_card[same] != c_cpu[same]))
            found = dict(instances=[int(i_card.max()), int(i_cpu.max())],
                         voxels_differ=int(np.count_nonzero(i_card != i_cpu)))
        else:
            (p_card, c_card), (p_cpu, c_cpu) = f_card, f_cpu
            cls_cpu = {tuple(p): k for p, k in zip(p_cpu.tolist(), c_cpu.tolist())}
            common = [(tuple(p), k) for p, k in zip(p_card.tolist(), c_card.tolist())
                      if tuple(p) in cls_cpu]
            n_same = len(common)
            n_cls_diff = sum(1 for p, k in common if cls_cpu[p] != k)
            found = dict(points=[len(p_card), len(p_cpu)])
        out[dt] = dict(heads=heads, same=n_same, classes_differ_where_same=n_cls_diff,
                       card_s=runs[dt, "card"][2], cpu_s=runs[dt, "cpu"][2], **found)
        if dt == "float32":
            ok = ok and n_cls_diff == 0
        print(f"[class-heads-vs-plain] {kind}, best checkpoint on one {crop.shape} patch, "
              f"{dt}: " + "; ".join(
                  f"{h} max |card - CPU| {v['max_abs']:.3g} (scale {v['scale']:.3g}), to the "
                  f"card's float32 card {v['to_f32']['card']['max_abs']:.3g} / CPU "
                  f"{v['to_f32']['cpu']['max_abs']:.3g}" for h, v in heads.items())
              + f"; {found}, {n_same} the same on both sides ({'voxels' if kind == 'instance' else 'points'}), "
              f"{n_cls_diff} of them with other classes; card {out[dt]['card_s']:.2f} s, CPU "
              f"{out[dt]['cpu_s']:.2f} s")
    if not ok:
        raise AssertionError(f"{kind} class head: card and CPU differ: {out}")
    return out


def _class_window(centre, patch, shape):
    """The ``patch`` window of a volume of ``shape`` centred on ``centre`` as
    far as the volume allows."""
    start = [min(max(int(c) - n // 2, 0), s - n) for c, n, s in zip(centre, patch, shape)]
    return tuple(slice(a, a + n) for a, n in zip(start, patch))


def _class_step_batch(kind, wf, img, gt, win):
    """One float32 training sample, the window ``win`` of ``img``: the input
    normalised by its own statistics and the GT as the workflow's loss reads
    it (instance: the compiled channels, then the class map; detection: the
    mask and class channel of the points inside ``win``)."""
    import numpy as np

    from biapy_tpu_torch.data.pre_processing import create_detection_masks, labels_into_channels

    x = img[win].astype(np.float32)
    x = (x - x.mean()) / max(float(x.std()), 1e-6)
    if kind == "instance":
        lab, cls = gt
        y = np.concatenate([labels_into_channels(lab[win][..., None], wf.channel_codes,
                                                 wf.channel_extra_opts),
                            cls[win][..., None].astype(np.float32)], axis=-1)
    else:
        pts, cls = gt
        inside = np.all([(pts[:, d] >= w.start) & (pts[:, d] < w.stop)
                         for d, w in enumerate(win)], axis=0)
        pts, cls = pts[inside], cls[inside]
        dil = list(wf.cfg.PROBLEM.DETECTION.CENTRAL_POINT_DILATION)
        y = create_detection_masks(pts - np.asarray([w.start for w in win]), x.shape,
                                   dilation=dil * (3 // len(dil)), classes=cls, n_classes=CLASS_N)
    return {"x": x[None, ..., None], "y": y[None].astype(np.float32)}


def _counted_run(job, run):
    """``run()`` (``job.test`` or ``predict``) with the launch counters set
    to 0 just before it: the launches and conv3d routes it made, and those
    that the model's count gives for the forwards it ran."""
    import torch

    from biapy_tpu_torch.ops.kernels import build

    job._build_workflow()
    calls = _count_forwards(job.workflow)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = (dict(build.LAUNCHES), dict(build.CONV3D_ROUTES))
    return out, secs, got, _expected_launches(job.workflow.model, calls)


def phase_class_heads(smi):
    """(a) The 3D instance template with DATA.N_CLASSES 3 on phase 12's first
    training and test volumes of ellipsoids (``_class_head_sources``), the
    GT their labels beside a seeded class map (a class for each ellipsoid),
    from seeded initial weights, through ``run_job``: launches against the
    model's count, the instances TIFF with its class channel, the class IoU
    and matching; its best checkpoint card against CPU on one patch of the
    template's size (``_class_head_card_vs_cpu``) and one float32 training
    step card against CPU on a patch of the template's size at its rate
    (CLASS_STEP_TOLS, phase 15's rule). (b) The 3D detection template with DATA.N_CLASSES 3 on phase
    13's blobs with a seeded ``class`` column in the CSVs, the same way, the
    points CSV with its class column and the class-aware metrics; then by
    chunks on the test volume's first CLASS_DET_CHUNK_SHAPE voxels held
    against ``predict`` in memory (phase 13 b's rule) with the same classes
    at the same points, the launches of each against the model's count.
    ``total`` adds up the launches of ``run_job``, by chunks and in memory;
    those of the card-vs-CPU checks are set back to 0."""
    import copy
    import shutil

    import numpy as np

    from biapy_tpu_torch import BiaPy, native
    from biapy_tpu_torch.data.tiff import read_tiff, write_tiff
    from biapy_tpu_torch.data.zarr_store import ZarrArray
    from biapy_tpu_torch.engine.detection import read_points_csv
    from biapy_tpu_torch.ops.kernels import build

    native._load()
    root0 = OUT_DIR / "chip_smoke_class_heads"
    shutil.rmtree(root0, ignore_errors=True)
    total = {"launches": {}, "conv3d_routes": {}, "shuffle_routes": {}}
    res = {}
    try:
        t_all = time.perf_counter()
        srcs = _class_head_sources(root0)
        rng = np.random.default_rng(17)

        def card_vs_cpu(kind, cfg, wf, r, img, gt, centre, root):
            """``_class_head_card_vs_cpu`` and the training step, each on one
            patch of the template's size centred on ``centre``."""
            patch = tuple(int(n) for n in wf.cfg.DATA.PATCH_SIZE[:3])
            win = _class_window(centre, patch, img.shape)
            r["vs_plain"] = _class_head_card_vs_cpu(kind, cfg, r["best"], img[win], root)
            t0 = time.perf_counter()
            r["step_vs_plain"] = _restoration_step_vs_plain(
                cfg, r["best"], _class_step_batch(kind, wf, img, gt, win), root, f"{kind}_cls",
                CLASS_STEP_TOLS, float(wf.cfg.TRAIN.LR[0]),
                done=lambda w, kind=kind, shape=img[win].shape: _print_step_vs_plain(
                    kind, w, shape, "class-heads"))
            r["step_vs_plain_seconds"] = time.perf_counter() - t0
            build.reset_launches()
            print(f"[class-heads-vs-plain] {kind}: the training step on the card (its CPU "
                  f"side in the child) {r['step_vs_plain_seconds']:.2f} s")

        # (a) instances with a class head
        root = root0 / "instance"
        cfg = _class_head_cfg(srcs["instance"], "instance", root)
        gts = {}
        for split in ("train", "test"):
            src_y = sorted((Path(srcs["instance"]["root"]) / split / "y").iterdir())[0]
            lab = read_tiff(str(src_y))
            cls_of = np.concatenate([[0], 1 + rng.integers(0, CLASS_N - 1, int(lab.max()))])
            cls = cls_of[lab].astype(lab.dtype)
            write_tiff(str(root / split / "y" / src_y.name), np.stack([lab, cls], axis=-1))
            gts[split] = (lab, cls)
        wf, r = _class_head_job("instance", cfg, root, smi, total)
        per_image = Path(wf.cfg.PATHS.RESULT_DIR.PER_IMAGE_INSTANCES)
        inst = read_tiff(str(next(per_image.glob("*.tif"))))
        cmaps = [p["classes"] for p in wf._predictions if p["role"] == "class_map"]
        if (inst.shape != INSTANCE_SHAPE + (2,) or len(cmaps) != 1
                or not np.array_equal(inst[..., 1], cmaps[0])
                or not set(np.unique(cmaps[0])) <= set(range(CLASS_N))
                or len(wf._class_ious) != 1 or not wf.matching_stats):
            raise AssertionError(f"instance class head: instances {inst.shape}, class maps "
                                 f"{len(cmaps)}, class IoU {wf._class_ious}")
        r.update(class_iou=wf._class_ious[0], n_instances=int(inst[..., 0].max()),
                 matching={str(s["thresh"]): s["f1"] for s in wf.matching_stats})
        print(f"[class-heads] instance: {r['n_instances']} instances, class IoU "
              f"{r['class_iou']:.4f}, matching F1 {r['matching']} (two epochs: a record)")
        test_img = read_tiff(str(next((root / "test" / "x").iterdir())))
        # one patch around the largest test ellipsoid
        lab = gts["test"][0]
        big_id = int(np.argmax(np.bincount(lab.ravel())[1:])) + 1
        card_vs_cpu("instance", cfg, wf, r, test_img, gts["test"],
                    np.argwhere(lab == big_id).mean(0), root)
        res["instance"] = r

        # (b) detection with a class head, in memory and by chunks
        root = root0 / "detection"
        cfg = _class_head_cfg(srcs["detection"], "detection", root)
        gts = {}
        for split in ("train", "test"):
            src_csv = sorted((Path(srcs["detection"]["root"]) / split / "csv").glob("*.csv"))[0]
            pts = read_points_csv(str(src_csv), 3).astype(np.int64)
            cls = 1 + rng.integers(0, CLASS_N - 1, len(pts))
            with open(root / split / "csv" / src_csv.name, "w") as f:
                f.write("axis-0,axis-1,axis-2,class\n")
                f.writelines(f"{p[0]},{p[1]},{p[2]},{k}\n" for p, k in zip(pts, cls))
            gts[split] = (pts, cls)
        wf, r = _class_head_job("detection", cfg, root, smi, total)
        check = Path(wf.cfg.PATHS.RESULT_DIR.DET_LOCAL_MAX_COORDS_CHECK)
        head = next(check.glob("*_points.csv")).read_text().splitlines()[0]
        pts = [p for p in wf._predictions if p["role"] == "points"]
        stats = wf.stats
        if (head != "axis-0,axis-1,axis-2,class" or len(pts) != 1
                or len(pts[0]["classes"]) != len(pts[0]["points"])
                or "det_f1_class" not in stats):
            raise AssertionError(f"detection class head: CSV header {head!r}, points {len(pts)}, "
                                 f"stats {sorted(stats)}")
        r.update(n_points=len(pts[0]["points"]),
                 metrics={k: stats[k] for k in ("det_precision", "det_recall", "det_f1",
                                                "det_precision_class", "det_recall_class",
                                                "det_f1_class")})
        print(f"[class-heads] detection: {r['n_points']} points; "
              + ", ".join(f"{k[4:]} {v:.4f}" for k, v in r["metrics"].items())
              + " (two epochs: a record)")
        test_img = read_tiff(str(next((root / "test" / "x").iterdir())))
        # one patch around the test volume's first GT point
        card_vs_cpu("detection", cfg, wf, r, test_img, gts["test"], gts["test"][0][0], root)
        # by chunks against in memory
        big = np.ascontiguousarray(test_img[tuple(slice(0, n) for n in CLASS_DET_CHUNK_SHAPE)])
        (root / "chunks").mkdir()
        z = ZarrArray.create(str(root / "chunks" / "vol.zarr"), shape=big.shape + (1,),
                             chunks=(24, 96, 96, 1), dtype="u1",
                             compressor={"id": "zlib", "level": 1})
        z[:, :, :, :] = big[..., None]
        ccfg = copy.deepcopy(cfg)
        ccfg["TRAIN"]["ENABLE"] = False
        ccfg["MODEL"]["LOAD_CHECKPOINT"] = True
        ccfg["PATHS"] = {"CHECKPOINT_FILE": r["best"]}
        ccfg["DATA"]["TEST"].update(PATH=str(root / "chunks"), LOAD_GT=False, IN_MEMORY=False)
        ccfg["DATA"]["NORMALIZATION"] = _fixed_stats(big)
        ccfg["TEST"]["BY_CHUNKS"] = {"ENABLE": True, "WORKFLOW_PROCESS": {"ENABLE": True}}
        jc = BiaPy(ccfg, result_dir=str(root / "results"), name="det_cls_chunks", silent=True)
        _, chunk_s, got_c, want_c = _counted_run(jc, jc.test)
        _launch_totals(total)
        (pc,) = [p for p in jc.workflow._predictions if p["role"] == "points"]
        mcfg = copy.deepcopy(ccfg)
        mcfg["TEST"].pop("BY_CHUNKS")
        jm = BiaPy(mcfg, result_dir=str(root / "results"), name="det_cls_memory", silent=True)
        pm, mem_s, got_m, want_m = _counted_run(jm, lambda: jm.predict(big))
        _launch_totals(total)
        pm = {p["role"]: p for p in pm}
        held = _hold_by_chunks(
            jc.workflow, pm["raw"]["pred"], pm["points"]["points"], pc["points"],
            jm.workflow._extract_points(pm["raw"]["pred"], global_post=False),
            "vol_patch*_points.csv", int(jc.workflow.cfg.TEST.DET_PEAK_LOCAL_MAX_MIN_DISTANCE),
            _detection_post(jc.workflow.cfg, CLASS_DET_CHUNK_SHAPE))
        cls_mem = {tuple(int(v) for v in p): int(k)
                   for p, k in zip(pm["points"]["points"], pm["points"]["classes"])}
        common = [(tuple(int(v) for v in p), int(k))
                  for p, k in zip(pc["points"], pc["classes"])
                  if tuple(int(v) for v in p) in cls_mem]
        cls_diff = sum(1 for p, k in common if cls_mem[p] != k)
        r["by_chunks"] = dict(seconds=chunk_s, mvox_s=float(np.prod(big.shape)) / chunk_s / 1e6,
                              memory_seconds=mem_s, launches=got_c[0], memory_launches=got_m[0],
                              common_points=len(common), classes_differ=cls_diff, **held)
        print(f"[class-heads] detection by chunks {big.shape}: {chunk_s:.2f} s, in memory "
              f"{mem_s:.2f} s; {_held_line(held)}; {len(common)} points on both sides, "
              f"{cls_diff} with other classes; launches by chunks {got_c[0]}, in memory "
              f"{got_m[0]}")
        if cls_diff or not common or got_c != want_c or got_m != want_m:
            raise AssertionError(f"detection class head by chunks: {r['by_chunks']}; launches "
                                 f"and routes by chunks {got_c} (want {want_c}), in memory "
                                 f"{got_m} (want {want_m})")
        res["detection"] = r
        res.update(total, seconds=time.perf_counter() - t_all)
        print(f"[class-heads] phase 17 launches {total['launches']}; conv3d routes "
              f"{total['conv3d_routes']}")
        return res
    finally:
        shutil.rmtree(root0, ignore_errors=True)


# phase 18: rays and flows -- StarDist (the 2D instance template with the
# ['Db', 'R'] its comment names), Cellpose flows (the 3D instance template
# with ['F', 'Gv', 'Gh', 'Gz'] and the Cellpose defaults: DIAMETER 0, so the
# test pass takes the diameter from a first pass and rescales) and Omnipose
# in 2D (['Db', 'Gv', 'Gh'], gradient_type and Db val_type 'omnipose'). Each
# part makes its own seeded data, one training image or volume and one test
# one: the 2D parts as phase 16 makes its instance data, the 3D part as
# phase 12 makes its ellipsoids, at seeds of its own
RF_PARTS = {
    "stardist": (TWOD_TEMPLATES["instance"], ["Db", "R"], {}),
    "cellpose": (str(INSTANCE_TEMPLATE.relative_to(REPO)), ["F", "Gv", "Gh", "Gz"], {}),
    "omnipose": (TWOD_TEMPLATES["instance"], ["Db", "Gv", "Gh"],
                 {"Db": {"val_type": "omnipose"}, "Gv": {"gradient_type": "omnipose"}}),
}
RF_SEEDS = (180, 182)  # the Cellpose part's training volume and its test volume
# card vs CPU: the 2D parts on phase 16's crop of the test image, the 3D part
# on one window of the template's depth whose in-plane size times the
# Cellpose rescale factor is the template's patch (128): one patch of the
# template's size at the network's input


def _rf_timers():
    """Wrap the host and device stages of the instance creation that phase
    18 times: the ray NMS (2D and 3D), the flow loop (``follow_flows``, on
    the card synchronised at its end), the clustering (Cellpose's landing
    histogram, the port's DBSCAN), Cellpose's whole flow tracking
    (``flows_to_instances``: the loop, the clustering and the flow-error
    check) and the test-time rescale (``before_test_sample`` and
    ``post_merge_transform``). Returns the lists of seconds by stage, the
    last positions ``follow_flows`` returned on each device type (with its
    step count) and a function that puts the originals back."""
    import torch

    from biapy_tpu_torch.data import polygon_nms
    from biapy_tpu_torch.engine.instance_seg import Instance_Segmentation_Workflow as wf_cls
    from biapy_tpu_torch.ops import flows, omnipose

    secs = {"nms": [], "flow_loop": [], "clustering": [], "flow_tracking": [], "rescale": []}
    last = {}
    saved = []

    def wrap(mod, name, stage, sync=False):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                if out.device.type == "cuda":
                    torch.cuda.synchronize(out.device)
                last[out.device.type] = (out, kwargs.get("n_iter", args[1] if len(args) > 1
                                                        else None))
            secs[stage].append(time.perf_counter() - t0)
            return out
        setattr(mod, name, run)

    wrap(polygon_nms, "stardist_nms_2d", "nms")
    wrap(polygon_nms, "stardist_nms_3d", "nms")
    wrap(flows, "follow_flows", "flow_loop", sync=True)
    wrap(flows, "_cluster_landings", "clustering")
    wrap(omnipose, "dbscan_labels", "clustering")
    wrap(flows, "flows_to_instances", "flow_tracking")
    wrap(wf_cls, "before_test_sample", "rescale")
    wrap(wf_cls, "post_merge_transform", "rescale")

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return secs, last, restore


def _rf_stage_line(secs):
    return ", ".join(f"{k} {sum(v):.3f} s over {len(v)} calls" for k, v in secs.items() if v)


def _rf_data(part, root):
    """The part's seeded data under ``root``: (test image, its labels)."""
    from biapy_tpu_torch.data.tiff import write_tiff

    if part != "cellpose":
        return _write_2d_data("instance", root, n_train=1)
    for split, seeds in (("train", RF_SEEDS[:1]), ("test", RF_SEEDS[1:])):
        for d in ("x", "y"):
            (root / split / d).mkdir(parents=True)
        for i, seed in enumerate(seeds):
            img, lab = _ellipsoids(INSTANCE_SHAPE, INSTANCE_COUNT, seed=seed)
            write_tiff(str(root / split / "x" / f"{split}_{i:03d}.tif"), img)
            write_tiff(str(root / split / "y" / f"{split}_{i:03d}.tif"), lab)
    return img, lab


def _rf_job(part, root, smi, total, secs):
    """The part's template through ``run_job`` on the card (EPOCHS 2): launches
    against the model's count (none on ``scalar``), the instances TIFF and
    the matching; the seconds of each instance-creation stage."""
    import numpy as np
    import torch
    import yaml

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.data.tiff import read_tiff
    from biapy_tpu_torch.ops.kernels import build

    tpl, codes, extra = RF_PARTS[part]
    with open(REPO / tpl) as f:
        cfg = yaml.safe_load(f)
    inst = cfg["PROBLEM"]["INSTANCE_SEG"]
    inst["DATA_CHANNELS"] = codes
    if extra:
        inst["DATA_CHANNELS_EXTRA_OPTS"] = [extra]
    cfg["DATA"]["TRAIN"].update(PATH=str(root / "train/x"), GT_PATH=str(root / "train/y"))
    cfg["DATA"]["TEST"].update(PATH=str(root / "test/x"), GT_PATH=str(root / "test/y"))
    cfg["TRAIN"]["EPOCHS"] = 2
    if cfg["TRAIN"]["LR_SCHEDULER"]["NAME"] == "warmupcosine":
        cfg["TRAIN"]["LR_SCHEDULER"]["WARMUP_COSINE_DECAY_EPOCHS"] = 1
    job = BiaPy(cfg, result_dir=str(root / "results"), name=part, silent=True)
    job._build_workflow()
    wf = job.workflow
    calls = _count_forwards(wf)
    train_s, test_s = [], []
    wf.train, wf.test = _timed(wf.train, train_s), _timed(wf.test, test_s)
    for v in secs.values():
        v.clear()
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    job.run_job()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, routes = dict(build.LAUNCHES), dict(build.CONV3D_ROUTES)
    shuffle_routes = {k: dict(v) for k, v in build.SHUFFLE_ROUTES.items()}
    _launch_totals(total)
    want, want_routes = _expected_launches(wf.model, calls,
                                           _launches_2d if wf.nd == 2 else None)
    hist = wf.history
    inst_img = read_tiff(str(next(Path(wf.cfg.PATHS.RESULT_DIR.PER_IMAGE_INSTANCES)
                              .glob("*.tif"))))
    stats = {s["thresh"]: s for s in getattr(wf, "matching_stats", None) or []}
    if (len(hist) != 2 or not all(np.isfinite(h["loss"]) for h in hist)
            or launches != want or routes != want_routes
            or any(v["scalar"] for v in shuffle_routes.values()) or 0.5 not in stats):
        raise AssertionError(f"{part}: epochs {hist}, launches {launches} (want {want}), "
                             f"routes {routes} (want {want_routes}), shuffle routes "
                             f"{shuffle_routes}, matching {sorted(stats)}")
    r = dict(template=tpl, codes=codes, extra=extra, seconds=run_s, train_seconds=train_s[0],
             test_seconds=test_s[0], loss=[h["loss"] for h in hist],
             train_patches=len(wf.train_data), launches=launches, conv3d_routes=routes,
             forwards=len(calls), n_instances=int(inst_img.max()),
             matching_f1={str(t): s["f1"] for t, s in stats.items()},
             test_stages={k: list(v) for k, v in secs.items()},
             best=str(Path(wf.cfg.PATHS.CHECKPOINT) / f"{part}-checkpoint-best.ckpt"),
             cellpose_diameter=getattr(wf, "cellpose_diameter", None),
             test_diameter=getattr(wf, "_cellpose_diam", None),
             test_factor=getattr(wf, "_cellpose_factor", None))
    print(f"[rays-flows] {smi}: {tpl} with {codes}{' ' + str(extra) if extra else ''}, "
          f"{len(wf.train_data)} train patches, 2 epochs: run_job {run_s:.2f} s (train "
          f"{train_s[0]:.2f}, test {test_s[0]:.2f}), loss {[round(h['loss'], 4) for h in hist]}; "
          f"{r['n_instances']} instances, matching F1 "
          f"{ {t: round(v, 4) for t, v in r['matching_f1'].items()} } (two epochs: a record); "
          f"test pass stages: {_rf_stage_line(secs)}"
          + (f"; training median diameter {r['cellpose_diameter']:.2f}, test first-pass "
             f"diameter {r['test_diameter']}, rescale factor {r['test_factor']}"
             if part == "cellpose" else "")
          + f"; launches {launches} over {len(calls)} forwards = the model's count")
    return cfg, wf, r


def _rf_card_vs_cpu(part, cfg, ckpt, crop, root, secs, diameter=None):
    """``predict`` of ``ckpt`` on ``crop`` in float32 on the card and on the CPU
    (plain versions; TEST.REDUCE_MEMORY off; for Cellpose DIAMETER set to
    ``diameter``, so both sides rescale alike): the prediction within 1e-4
    of its scale; the instances made on the CPU from the card's prediction
    identical to the card's; the instances made from each side's own
    prediction matched at IoU 0.5, F1 >= 0.99 (PR 9's float32 rule) for
    StarDist and Omnipose, a record for Cellpose: a two-epoch network's 3D
    flows do not converge, and their tracking turns a difference of 1e-6 in
    the flows into other landings and other instances (PERF.md, ROADMAP
    section 3). The card's side runs under torch.profiler (the device's idle
    share over the call); its launches are set back to 0."""
    import copy

    import numpy as np

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.ops.kernels import build
    from biapy_tpu_torch.utils.matching import matching

    runs = {}
    c = copy.deepcopy(cfg)
    c["TRAIN"]["ENABLE"] = False
    c["MODEL"]["LOAD_CHECKPOINT"] = True
    c["PATHS"] = {"CHECKPOINT_FILE": ckpt}
    c["TEST"]["REDUCE_MEMORY"] = False
    if diameter:
        c["PROBLEM"]["INSTANCE_SEG"].setdefault("CELLPOSE", {})["DIAMETER"] = float(diameter)
    for side, dev in (("card", DEVICE), ("cpu", "cpu")):
        for v in secs.values():
            v.clear()
        job = BiaPy(c, result_dir=str(root / "vs_plain"), name=f"{part}_{side}", silent=True,
                    check_data_paths=False, device=dev)
        held = {}

        def run():
            held.update(p={q["role"]: q for q in job.predict(crop)})
        if side == "card":
            wall, busy, _, events = _profile_device(run)
            idle, window_ms = _window_idle_share(events)
        else:
            t0 = time.perf_counter()
            run()
            wall = time.perf_counter() - t0
        preds = held["p"]
        runs[side] = (np.asarray(preds["raw"]["pred"], np.float32),
                      preds["instances"]["instances"].astype(np.int32),
                      wall, {k: list(v) for k, v in secs.items()})
    # the card's prediction made into instances on the CPU (the flow parts:
    # the ray NMS runs on the host on either side)
    same_cpu = (runs["card"][1] if part == "stardist" else
                job.workflow.instance_seg_process(runs["card"][0]).astype(np.int32))
    build.reset_launches()
    (p_card, i_card, s_card, st_card), (p_cpu, i_cpu, s_cpu, st_cpu) = runs["card"], runs["cpu"]
    scale = max(1.0, float(np.abs(p_cpu).max()))
    max_abs = float(np.abs(p_card - p_cpu).max())
    if i_cpu.max() and i_card.max():
        f1 = matching(i_cpu, i_card, thresh=[0.5])[0]["f1"]
    else:
        f1 = float(i_cpu.max() == i_card.max())
    same_differ = int(np.count_nonzero(same_cpu != i_card))
    out = dict(shape=list(p_card.shape), max_abs=max_abs, scale=scale, f1=f1,
               same_prediction_voxels_differ=same_differ,
               n_instances=[int(i_card.max()), int(i_cpu.max())],
               voxels_differ=int(np.count_nonzero(i_card != i_cpu)), card_s=s_card,
               cpu_s=s_cpu, card_stages=st_card, cpu_stages=st_cpu, card_busy_ms=busy,
               card_idle_share=idle, card_window_ms=window_ms)
    print(f"[rays-flows-vs-plain] {part}, best checkpoint, float32 on {tuple(crop.shape)}"
          + (f" (DIAMETER {diameter:.2f})" if diameter else "")
          + f": max |card - CPU| {max_abs:.3g} (scale {scale:.3g}); the card's prediction "
          f"made into instances on the CPU: {same_differ} voxels differ from the card's; "
          f"instances from each side's prediction {out['n_instances'][0]} card / "
          f"{out['n_instances'][1]} CPU, matching F1@0.5 {f1:.4f}"
          f"{' (a record)' if part == 'cellpose' else ''}, {out['voxels_differ']} voxels "
          f"differ; card {s_card:.2f} s (profiled; "
          f"{_rf_stage_line(st_card)}; device busy {busy:.1f} ms, idle {100 * idle:.1f}% of "
          f"{window_ms:.0f} ms), CPU {s_cpu:.2f} s ({_rf_stage_line(st_cpu)})")
    if not (max_abs <= 1e-4 * scale and same_differ == 0
            and (f1 >= 0.99 or part == "cellpose")):
        raise AssertionError(f"{part}: card and CPU differ: {out}")
    return out, p_card


def _rf_landings(pred, last):
    """``follow_flows``' landings on the card's float32 flows (``pred``'s Gz,
    Gv, Gh channels), made on the card by its own test pass and on the CPU
    from the card's prediction (``_rf_card_vs_cpu``; ``last`` from
    ``_rf_timers``): the largest difference in pixels and the share of
    foreground voxels (F > 0.5) whose landing bin (the positions truncated,
    as the clustering takes them) differs."""
    import numpy as np

    (card, n_card), (cpu, n_cpu) = last["cuda"], last["cpu"]
    card, cpu = card.cpu().numpy(), cpu.numpy()
    fg = pred[..., 0] > 0.5
    if card.shape != fg.shape + (3,) or cpu.shape != card.shape or n_card != n_cpu:
        raise AssertionError(f"cellpose landings: {card.shape}, {cpu.shape} over {fg.shape}, "
                             f"steps {n_card}, {n_cpu}")
    diff = np.abs(card - cpu)
    bins = np.any(card.astype(np.int32) != cpu.astype(np.int32), axis=-1)
    out = dict(n_iter=n_card, voxels=int(fg.size), fg_voxels=int(fg.sum()),
               max_px=float(diff.max()),
               bins_differ_share=float(bins[fg].mean()) if fg.any() else 0.0)
    print(f"[rays-flows-vs-plain] cellpose follow_flows on the card's flows "
          f"{tuple(card.shape)}, {n_card} steps, card and CPU: max |card - CPU| "
          f"{out['max_px']:.3g} px, {100 * out['bins_differ_share']:.4f}% of "
          f"{out['fg_voxels']} foreground voxels in another bin")
    if out["max_px"] > 1e-3:
        raise AssertionError(f"cellpose landings: card and CPU differ: {out}")
    return out


def phase_rays_flows(smi):
    """(a) The 2D instance template with DATA_CHANNELS ['Db', 'R'] (its
    comment's StarDist), (b) the 3D instance template with ['F', 'Gv', 'Gh',
    'Gz'] and the Cellpose defaults, (c) the 2D instance template with
    Omnipose ['Db', 'Gv', 'Gh'], each on seeded data of its own through
    ``run_job`` (EPOCHS 2) on the card: launches against the model's count,
    the instances and the matching; the best checkpoint card against CPU
    in float32 (``_rf_card_vs_cpu``, its card side profiled: the idle
    share); for (b) also ``follow_flows``' landings card against CPU on the
    same flows (``_rf_landings``) and a by-chunks run over a whole number of
    cores (phase 12 c's ``_instance_by_chunks``), held against ``predict`` of
    the same test volume in memory, whose launches are held too: that is the
    part's ``predict``, with DIAMETER at DIAM_MEAN so that the in-memory pass
    does not rescale (by chunks never does; the merge itself is held by
    12 c). The template's own test path (DIAMETER 0: the first-pass diameter
    and the rescale) runs over the whole test volume in ``run_job``'s test
    pass. The checks of (b) and (c) hold the
    instances with the flow-error check off (FLOW_THRESHOLD 0): a two-epoch
    network's flows fail it, which leaves them nothing to compare. The seconds of the NMS, the flow
    loop and the clustering throughout. ``total`` adds up the launches of
    the jobs and the by-chunks runs with their predicts; those of the card-vs-CPU
    checks are set back to 0."""
    import copy
    import shutil

    import numpy as np

    from biapy_tpu_torch import native

    native._load()
    root0 = OUT_DIR / "chip_smoke_rays_flows"
    shutil.rmtree(root0, ignore_errors=True)
    total = {"launches": {}, "conv3d_routes": {}, "shuffle_routes": {}}
    res = {}
    secs, last, restore = _rf_timers()
    try:
        t_all = time.perf_counter()
        for part in RF_PARTS:
            t_part = time.perf_counter()
            root = root0 / part
            test_img, _ = _rf_data(part, root)
            print(f"[rays-flows] {part}: data made in {time.perf_counter() - t_part:.1f} s",
                  flush=True)
            cfg, wf, r = _rf_job(part, root, smi, total, secs)
            # the checks hold the flow parts' instances before the flow-error
            # check, which leaves a two-epoch network few or none to compare
            checked = copy.deepcopy(cfg)
            if part != "stardist":
                inst = checked["PROBLEM"]["INSTANCE_SEG"]
                inst.setdefault("CELLPOSE", {})["FLOW_THRESHOLD"] = 0.0
                inst.setdefault("OMNIPOSE", {})["FLOW_THRESHOLD"] = 0.0
            if part == "cellpose":
                diam = r["test_diameter"] or float(wf.cfg.PROBLEM.INSTANCE_SEG.CELLPOSE.DIAM_MEAN)
                factor = r["test_factor"] or 1.0
                yx = min(INSTANCE_SHAPE[1],
                         int(np.ceil(int(wf.cfg.DATA.PATCH_SIZE[1]) / factor)))
                crop = test_img[:int(wf.cfg.DATA.PATCH_SIZE[0]), :yx, :yx]
                r["vs_plain"], pred = _rf_card_vs_cpu(part, checked, r["best"], crop, root,
                                                      secs, diameter=diam)
                r["landings"] = _rf_landings(pred, last)
            else:
                crop = test_img[:TWOD_CROP[0], :TWOD_CROP[1]]
                r["vs_plain"], _ = _rf_card_vs_cpu(part, checked, r["best"], crop, root, secs)
            if part == "cellpose":
                ccfg = copy.deepcopy(checked)
                cp = ccfg["PROBLEM"]["INSTANCE_SEG"].setdefault("CELLPOSE", {})
                cp["DIAMETER"] = float(wf.cfg.PROBLEM.INSTANCE_SEG.CELLPOSE.DIAM_MEAN)
                for v in secs.values():
                    v.clear()
                r["by_chunks"] = _instance_by_chunks(ccfg, r["best"], test_img, root,
                                                     plain_merge=False)
                r["by_chunks"]["stages"] = {k: list(v) for k, v in secs.items()}
                for k in ("launches", "memory_launches"):
                    for kk, v in r["by_chunks"][k].items():
                        total["launches"][kk] = total["launches"].get(kk, 0) + v
                print(f"[rays-flows] cellpose by chunks: stages {_rf_stage_line(secs)}")
            r["part_seconds"] = time.perf_counter() - t_part
            print(f"[rays-flows] {part}: {r['part_seconds']:.1f} s in all", flush=True)
            res[part] = r
            shutil.rmtree(root, ignore_errors=True)
        res.update(total, seconds=time.perf_counter() - t_all)
        print(f"[rays-flows] phase 18 launches {total['launches']}; conv3d routes "
              f"{total['conv3d_routes']}; seconds by part "
              f"{ {k: round(v['part_seconds'], 1) for k, v in res.items() if k in RF_PARTS} }")
        return res
    finally:
        restore()
        shutil.rmtree(root0, ignore_errors=True)


def summarise(rows, serve, train, larger_io, job, chunks, aug, template, instance, detection,
              restoration, classification, twod, heads, rays_flows):
    """One entry per kernel, in the main paths' dtype (bf16): ms, plain_ms,
    bound_ms and library_ms (device-side times, ``device_ms``; call_ms: the
    wrapper's call time, ``time_ms``) are sums over the kernel's launches in
    one unit of its path's work: one 128^3 serving patch for the three forward
    kernels (conv3d also carries the sums over one training step, forward +
    dx, under ``train_step_*``), one training step at batch 1 for the four
    backward-side kernels (zcat_bwd: one LARGER_IO step), and for conv3d's
    channel pad (pad_channels), which no main path launches (their widths
    are on the 8 grid), one training step of the 3D templates at batch 2 and
    depth 40 (their forward and dx convs whose x has 28, 36 or 84
    channels), and for the 3xTF32 route's split of x (tf32_split), which
    only float32 runs launch, one 128^3 serving patch in float32.
    ``launches`` adds
    up the runs of the paths (serving, training, LARGER_IO, the job, the
    by-chunks runs, the augmented job with its TTA passes, the template),
    each counted from zero, the instance template's (phase 12), phase 13's
    (the detection template, by chunks, the synapse jobs, card vs CPU) and
    the four restoration templates' ``run_job`` (phase 14). The pool, pool
    backward and zcat entries also carry ``template_*`` sums: the templates'
    three pools (one forward or backward) and their 14 zcats (one training
    step) at batch 2 and depth 40, and ``detection_*`` sums, the same at the
    detection template's depth 20; the pool, pool backward, zd2s, zs2d and
    zcat entries ``denoising_*``, ``sr_*`` and ``i2i_*`` sums: the
    denoising, super-resolution and image-to-image templates' two of each
    and their ten zcats (one forward batch or training step at the
    template's batch and patch); the conv3d, pool, pool backward, zcat and
    zcat_bwd entries ``classification_*`` sums: the classification
    template's (simple_cnn, batch 8, 32 x 64 x 64) four 3x3x3 convs (one
    forward batch), its two pools and pool backwards, its six zcats of a
    training step (two at kz 5, four at kz 3) and its two zcat_bwds; the
    conv3d entry ``float32_*`` and ``float32_train_step_*`` sums: the same
    serving patch and training step in float32 (the stem kernel and the
    3xTF32 route).
    The conv3d and zcat entries carry ``sr3d_rcan_*`` and ``sr3d_dfcan_*``
    sums: phase 14 c's 3D super-resolution template with rcan and dfcan at
    UPSCALING (2, 2, 2), batch 4, in float32: one forward batch's convs and
    one training step's zcats, each shape as many times as the model runs
    it (``_sr3d_step_counts``).
    ``launches`` also counts phase 15's runs (the classification template
    with simple_cnn and vit, and the U-Net variants) and phase 16's (the 2D
    templates and the TEST.FULL_IMG predict: pool and pool backward only),
    and the pool and pool backward entries carry ``2d_<template>_*`` sums:
    the 2D templates' pools (one forward or backward at the template's
    batch and patch). ``launches`` also counts phase 12 c's runs (the
    instance template by chunks with the merge, and ``predict`` in memory:
    ``instance_merge``), phase 17's (the class heads: ``class_heads``) and
    phase 18's (StarDist, Cellpose and Omnipose: ``rays_flows``)."""
    import torch

    def pick(name, wants, dtype="bfloat16"):
        picked = []
        for want in wants:
            for r in rows:
                if (r["kernel"] == name and r["dtype"] == dtype
                        and all(r.get(k) == v for k, v in want.items())):
                    picked.append(r)
                    break
        assert len(picked) == len(wants), name
        return picked

    def sums(picked, prefix=""):
        ops_ms = sum(r["bound_ms"] for r in picked if r["bound_by"] == "operations")
        byte_ms = sum(r["bound_ms"] for r in picked if r["bound_by"] == "bytes")
        libs = [r["library_ms"] for r in picked]
        return {prefix + "ms": sum(r["ms"] for r in picked),
                prefix + "call_ms": sum(r["call_ms"] for r in picked),
                prefix + "plain_ms": sum(r["plain_ms"] for r in picked),
                prefix + "bound_ms": sum(r["bound_ms"] for r in picked),
                prefix + "bound_by": "operations" if ops_ms >= byte_ms else "bytes",
                prefix + "library_ms": None if any(v is None for v in libs) else sum(libs)}

    def conv(shapes):
        return [dict(shape=[1, s, s, s, cin], cout=cout) for s, cin, cout in shapes]

    per_unit = {
        "conv3d": conv(MAIN_CONVS),
        "pool_max_folded": [dict(shape=list(s)) for s, _ in MAIN_POOLS],
        "zd2s": [dict(shape=list(s)) for s, _ in MAIN_ZD2S],
        "zcat": [dict(shape=[s, s, s, cin], kz=3, depth=None) for s, cin, _ in MAIN_CONVS],
        "zcat_bwd": [dict(shape=list(ZCAT_BWD_MAIN[0]), kz=ZCAT_BWD_MAIN[1], depth=None)],
        "pool_max_folded_bwd": [dict(shape=list(s)) for s, _ in MAIN_POOLS],
        "zs2d": [dict(shape=[r * sz, h, w, c // sz]) for (r, h, w, c), sz in MAIN_ZD2S],
        # the main paths' widths are all on the 8 grid: the pad's unit is the
        # templates' training step (forward and dx) at batch 2 and depth 40
        "pad_channels": [dict(shape=list(vol) + [cin]) for vol, cin, cout in
                         sum(_template_conv_rows(), [])
                         if _channel_pads(torch.bfloat16, [(cin, cout)])],
        # the 3xTF32 route's split of x: one 128^3 serving patch in float32
        "tf32_split": [dict(shape=[1, s, s, s, cin]) for s, cin, _ in MAIN_CONVS[1:]],
    }
    def per_template(depth, pools):
        return {
            "pool_max_folded": [dict(shape=list(s)) for s, _ in pools],
            "pool_max_folded_bwd": [dict(shape=list(s)) for s, _ in pools],
            "zcat": [dict(shape=[TEMPLATE_BATCH * depth, s, s, cin], kz=3, depth=depth)
                     for s, cin, _ in TEMPLATE_CONVS],
        }

    def per_restoration(pools, zd2s, zcats):
        return {
            "pool_max_folded": [dict(shape=list(s)) for s, _ in pools],
            "pool_max_folded_bwd": [dict(shape=list(s)) for s, _ in pools],
            "zd2s": [dict(shape=list(s)) for s, _ in zd2s],
            "zs2d": [dict(shape=[r * sz, h, w, c // sz]) for (r, h, w, c), sz in zd2s],
            "zcat": [dict(shape=list(s), kz=kz, depth=depth) for s, kz, depth in zcats],
        }
    cls_convs, _, cls_pools, cls_zcat5, cls_zcat3 = _cls_rows()
    per_classification = {
        "conv3d": [dict(shape=list(vol) + [cin], cout=cout) for vol, cin, cout in cls_convs],
        "pool_max_folded": [dict(shape=list(s)) for s, _ in cls_pools],
        "pool_max_folded_bwd": [dict(shape=list(s)) for s, _ in cls_pools],
        "zcat": [dict(shape=list(s), kz=kz, depth=d) for s, kz, d in cls_zcat5 + cls_zcat3],
        "zcat_bwd": [dict(shape=list(s), kz=kz, depth=d) for s, kz, d in cls_zcat5],
    }
    kernels = []
    for name, wants in per_unit.items():
        src, replaces = KERNEL_META[name]
        by_path = {"serve": serve["launches"].get(name, 0), "train": train["launches"][name],
                   "train_larger_io": larger_io["launches"][name], "job": job["launches"][name],
                   "by_chunks": chunks["launches"].get(name, 0),
                   "augmented_and_tta": aug["launches"].get(name, 0),
                   "template": template["launches"].get(name, 0),
                   "instance_template": instance["launches"].get(name, 0),
                   "detection": detection["launches"].get(name, 0),
                   "restoration": restoration["launches"].get(name, 0),
                   "classification": classification["launches"].get(name, 0),
                   "2d": twod["launches"].get(name, 0),
                   "instance_merge": (instance["by_chunks"]["launches"].get(name, 0)
                                      + instance["by_chunks"]["memory_launches"].get(name, 0)),
                   "class_heads": heads["launches"].get(name, 0),
                   "rays_flows": rays_flows["launches"].get(name, 0)}
        entry = dict(name=name, route="cuda", source=src, replaces=replaces,
                     launches=sum(by_path.values()), launches_by_path=by_path,
                     max_abs_err=max(r["max_abs_err"] for r in rows if r["kernel"] == name),
                     **sums(pick(name, wants,
                                 "float32" if name == "tf32_split" else "bfloat16")))
        if name == "conv3d":
            entry.update(sums(pick(name, conv(MAIN_CONVS + DX_CONVS)), "train_step_"))
            # float32 (the stem and the 3xTF32 route): a serving patch, a step
            entry.update(sums(pick(name, conv(MAIN_CONVS), "float32"), "float32_"))
            entry.update(sums(pick(name, conv(MAIN_CONVS + DX_CONVS), "float32"),
                              "float32_train_step_"))
        for prefix, depth, pools in (("template_", TEMPLATE_DEPTH, TEMPLATE_POOLS),
                                     ("detection_", DETECTION_DEPTH, DETECTION_POOLS)):
            rows_at = per_template(depth, pools).get(name)
            if rows_at:
                entry.update(sums(pick(name, rows_at), prefix))
        for key, rows_of in RESTORATION_ROWS.items():
            rows_at = per_restoration(*rows_of).get(name)
            if rows_at:
                entry.update(sums(pick(name, rows_at), key + "_"))
        rows_at = per_classification.get(name)
        if rows_at:
            entry.update(sums(pick(name, rows_at), "classification_"))
        if name in ("conv3d", "zcat"):
            # phase 14 (c): one float32 forward batch (conv3d) or training
            # step (the weight gradients' zcats), each shape as often as the
            # model runs it
            for arch in SR3D_FILTERS:
                fwd, _, zcats = _sr3d_rows(arch)
                wants = ([dict(shape=list(v) + [cin], cout=cout) for v, cin, cout in fwd]
                         if name == "conv3d" else
                         [dict(shape=list(sh), kz=kz, depth=d) for sh, kz, d in zcats])
                wants = [w for w, n in zip(wants, _sr3d_step_counts(arch)) for _ in range(n)]
                entry.update(sums(pick(name, wants, "float32"), f"sr3d_{arch}_"))
        if name in ("pool_max_folded", "pool_max_folded_bwd"):
            for tpl, pools in TWOD_POOLS.items():
                entry.update(sums(pick(name, [dict(shape=list(s), ndim=2) for s, _ in pools]),
                                  f"2d_{tpl}_"))
        if entry["launches"] == 0:
            raise AssertionError(f"{name}: no main path launched it")
        kernels.append(entry)
    return kernels


def main():
    conv3d_only = sys.argv[1:] == ["--conv3d-only"]
    instance_only = sys.argv[1:] == ["--instance-only"]
    detection_only = sys.argv[1:] == ["--detection-only"]
    restoration_only = sys.argv[1:] == ["--restoration-only"]
    classification_only = sys.argv[1:] == ["--classification-only"]
    twod_only = sys.argv[1:] == ["--2d-only"]
    class_heads_only = sys.argv[1:] == ["--class-heads-only"]
    rays_flows_only = sys.argv[1:] == ["--rays-flows-only"]
    if sys.argv[1:] and not (conv3d_only or instance_only or detection_only or restoration_only
                             or classification_only or twod_only or class_heads_only
                             or rays_flows_only):
        sys.exit("usage: chip_smoke.py [--conv3d-only | --instance-only | --detection-only | "
                 "--restoration-only | --classification-only | --2d-only | "
                 "--class-heads-only | --rays-flows-only]")
    smi, name = phase_environment()
    t_start = time.perf_counter()
    build_s, ptxas = phase_build()
    if instance_only:
        # phases 1-2 and 12 alone: the quick check of the instance workflow;
        # prints no result line
        instance = phase_instance_template()
        _finish_cpu_sides()
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_instance.json").write_text(json.dumps(dict(
            card=smi, build_seconds=build_s, instance=instance,
            seconds=time.perf_counter() - t_start), indent=1))
        print(f"[done] phases 1, 2 and 12 in {time.perf_counter() - t_start:.0f} s")
        return
    if class_heads_only:
        # phases 1-2 and 17 alone, on data made as phases 12 and 13 make theirs
        # (no checkpoint to start from): the quick check of the class heads;
        # prints no result line
        heads = phase_class_heads(smi)
        _finish_cpu_sides()
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_class_heads.json").write_text(json.dumps(dict(
            card=smi, build_seconds=build_s, class_heads=heads,
            seconds=time.perf_counter() - t_start), indent=1))
        print(f"[done] phases 1, 2 and 17 in {time.perf_counter() - t_start:.0f} s")
        return
    if rays_flows_only:
        # phases 1-2 and 18 alone: the quick check of StarDist, Cellpose and
        # Omnipose; prints no result line
        rf = phase_rays_flows(smi)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_rays_flows.json").write_text(json.dumps(dict(
            card=smi, build_seconds=build_s, rays_flows=rf,
            seconds=time.perf_counter() - t_start), indent=1))
        print(f"[done] phases 1, 2 and 18 in {time.perf_counter() - t_start:.0f} s")
        return
    if detection_only:
        # phases 1-2 and 13 alone: the quick check of point detection; prints
        # no result line
        det = phase_detection(smi)
        _finish_cpu_sides()
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_detection.json").write_text(json.dumps(dict(
            card=smi, build_seconds=build_s, detection=det,
            seconds=time.perf_counter() - t_start), indent=1))
        print(f"[done] phases 1, 2 and 13 in {time.perf_counter() - t_start:.0f} s")
        return
    if restoration_only:
        # phases 1-3 and 14 alone: the quick check of the restoration
        # templates; prints no result line
        rows = phase_kernels(smi)
        rest = phase_restoration(smi)
        _finish_cpu_sides()
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_restoration.json").write_text(json.dumps(dict(
            card=smi, build_seconds=build_s, kernel_rows=rows, restoration=rest,
            seconds=time.perf_counter() - t_start), indent=1))
        print(f"[done] phases 1, 2, 3 and 14 in {time.perf_counter() - t_start:.0f} s")
        return
    if classification_only:
        # phases 1-2, phase 3's classification and variant rows and phase 15
        # alone: the quick check of classification; prints no result line
        t0 = time.perf_counter()
        rows = phase_kernels(smi, classification_only=True)
        rows_s = time.perf_counter() - t0
        cls = phase_classification(smi)
        _finish_cpu_sides()
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_classification.json").write_text(json.dumps(dict(
            card=smi, build_seconds=build_s, kernel_rows=rows, kernel_rows_seconds=rows_s,
            classification=cls, seconds=time.perf_counter() - t0), indent=1))
        print(f"[done] phases 1, 2, 3 (the classification and variant rows, {rows_s:.0f} s) "
              f"and 15 in {time.perf_counter() - t_start:.0f} s")
        return
    if twod_only:
        # phases 1-2, phase 3's 2D rows and phase 16 alone: the quick check of
        # the 2D templates; prints no result line
        t0 = time.perf_counter()
        rows = phase_kernels(smi, twod_only=True)
        rows_s = time.perf_counter() - t0
        twod = phase_2d(smi)
        _finish_cpu_sides()
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_2d.json").write_text(json.dumps(dict(
            card=smi, build_seconds=build_s, kernel_rows=rows, kernel_rows_seconds=rows_s,
            twod=twod, seconds=time.perf_counter() - t0), indent=1))
        print(f"[done] phases 1, 2, 3 (the 2D rows, {rows_s:.0f} s) and 16 in "
              f"{time.perf_counter() - t_start:.0f} s")
        return
    if conv3d_only:
        # phases 1-2 and the conv3d rows of phase 3 alone: the quick check of
        # a change to the conv kernels; prints no result line
        rows = phase_kernels(smi, conv3d_only=True)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_conv3d.json").write_text(json.dumps(dict(
            card=smi, build_seconds=build_s, ptxas=ptxas, kernel_rows=rows), indent=1))
        return
    phase_s = {}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[phase] = round(time.perf_counter() - t0, 1)
        return out

    rows = timed("3 kernels", phase_kernels, smi)
    serve = timed("4 serving", phase_main_path)
    diff = timed("5 vs plain", phase_whole_vs_plain)
    diff_bf16 = timed("5 vs plain bf16", phase_whole_vs_plain_bf16)
    train = timed("6 training", phase_train)
    larger_io = timed("7 LARGER_IO", phase_train_larger_io)
    grads = timed("8 grads vs plain", phase_grads_vs_plain)
    job = timed("9 job", phase_job, serve, train)
    chunks = timed("10 by chunks", phase_by_chunks)
    aug = timed("11 augmented", phase_augmented, serve, train)
    tta = timed("11 c TTA vs plain", phase_tta_vs_plain)
    template = timed("11 d template", phase_template)
    instance = timed("12 instance", phase_instance_template)
    # 12 c apart: the by-chunks run with the merge
    phase_s["12 c by chunks"] = round(instance["by_chunks"]["phase_seconds"], 1)
    phase_s["12 instance"] = round(phase_s["12 instance"] - phase_s["12 c by chunks"], 1)
    det = timed("13 detection", phase_detection, smi)
    rest = timed("14 restoration", phase_restoration, smi)
    cls = timed("15 classification", phase_classification, smi)
    twod = timed("16 2D", phase_2d, smi)
    heads = timed("17 class heads", phase_class_heads, smi)
    rf = timed("18 rays and flows", phase_rays_flows, smi)
    # the card-vs-CPU comparisons whose CPU sides ran in the child meanwhile
    # (the wait for the child, if any, included)
    timed("19 CPU sides finished", _finish_cpu_sides)
    print(f"[time] seconds by phase (build {build_s:.1f}): {phase_s}")
    kernels = summarise(rows, serve, train, larger_io, job, chunks, aug, template, instance, det,
                        rest, cls, twod, heads, rf)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        card=smi, build_seconds=build_s, ptxas=ptxas, kernel_rows=rows, main=serve, train=train,
        train_larger_io=larger_io, job=job, by_chunks=chunks, augmented=aug,
        tta_vs_plain=tta, template=template, instance_template=instance, detection=det,
        restoration=rest, classification=cls, twod=twod, class_heads=heads, rays_flows=rf,
        whole_vs_plain_max_abs=diff,
        whole_vs_plain_bf16=diff_bf16, grads_vs_plain=grads,
        kernels=kernels, phase_seconds=phase_s, seconds=time.perf_counter() - t_start),
        indent=1))
    import torch

    print(f"[done] all phases in {time.perf_counter() - t_start:.0f} s")
    print(smi)
    print("(kernels: ms, plain_ms, bound_ms and library_ms (device-side; call_ms: one wrapper "
          "call, host work included) are sums over each kernel's launches in one serving patch "
          "(conv3d, pool_max_folded, zd2s) or one training step at batch 1 (the others; conv3d's "
          "train_step_* too; pad_channels: one training step of the 3D templates at batch 2 and "
          "depth 40), bf16; the template_* sums of pool_max_folded, pool_max_folded_bwd "
          "and zcat are over the templates' three pools and their 14 zcats of a training step at "
          "batch 2 and depth 40, the detection_* sums the same at the detection template's depth "
          "20, the denoising_*, sr_* and i2i_* sums of pool_max_folded, pool_max_folded_bwd, "
          "zd2s and zs2d over those templates' two of each and of zcat over their ten, at each "
          "template's batch and patch; the classification_* sums over the classification "
          "template's four conv3d forwards, two pools and pool backwards, six zcats and two "
          "zcat_bwds at batch 8; the sr3d_rcan_* and sr3d_dfcan_* sums of conv3d and zcat over "
          "one float32 forward batch's convs and one training step's zcats of the 3D "
          "super-resolution template with rcan and dfcan at UPSCALING (2, 2, 2), batch 4, each "
          "shape as often as the model runs it; the 2d_<template>_* sums of pool_max_folded and "
          "pool_max_folded_bwd over each 2D template's pools at its batch and patch; launches add "
          "up the main paths' runs, the job's, the by-chunks runs', the augmented job's with its "
          "TTA passes, the template's, the instance template's (by chunks with the merge "
          "apart: instance_merge), phase 13's, the restoration templates', phase 15's, the 2D "
          "templates', the class heads' and phase 18's rays and flows included)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
