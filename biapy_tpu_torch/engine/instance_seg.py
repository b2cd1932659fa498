"""Instance segmentation workflow, its watershed family.

Counterpart of ``biapy_tpu/engine/instance_seg.py``: channel-representation
heads with per-channel activations and losses, the GT label -> channel
compile cached next to the GT (``_prepare_instance_data``, the JAX
package's cache format, so either package reuses the other's), train-time
regeneration of geometry-derived channels under augmentation
(``data/tta.py::TrainChannelHandler``), instance creation by
marker-controlled watershed (``data/post_processing.py``) with the
post-processing chain (INSTANCE_REFINEMENT, REPARE_LARGE_BLOBS_SIZE,
VORONOI_ON_MASK, MEASURE_PROPERTIES), and matching against the GT
instances (``utils/matching.py``).

Channel codes B, F, P, C, T, M, D, Db, Dc, Dn, H/V/Z and A, plus the GT-only
We, are ported, and the synapse mode (PROBLEM.INSTANCE_SEG.TYPE 'synapses':
CREMI point annotations painted into channel Zarrs by
``data/synapses.py::synapse_channel_creation``, byte-identical to the JAX
package's; pre/post/cleft points extracted from the predicted channels,
paired, and scored against the annotations; by chunks, tile by tile with
core ownership and one merge over the volume). With DATA.N_CLASSES > 2 the
model grows a class head: the GT carries a class map beside the labels,
the loss adds its cross-entropy on the instances, and each instance takes
the majority class of the head's argmax. By chunks (TEST.BY_CHUNKS with
WORKFLOW_PROCESS), the instances are made tile by tile and merged across
the tiles (``engine/chunked.py::ChunkedInference.create_and_merge_instances``)
into ``instances.zarr``, or, with WORKFLOW_PROCESS.TYPE ``entire_pred``,
made once over the whole raw prediction. StarDist rays (R) make the
instances by the ray-polygon NMS (``data/polygon_nms.py``); Cellpose flows
(Gv/Gh/Gz) by flow tracking on the workflow's device
(``ops/flows.py::follow_flows``) and the clustering of the landings on the
host, with the test-time diameter rescale (``before_test_sample`` /
``post_merge_transform``) and the training median diameter cached as
``cellpose_diam.json`` beside the channels; Omnipose (gradient_type or
Db val_type 'omnipose') by ``ops/omnipose.py::compute_masks_omnipose``.
EmbedSeg and the contrastive head raise ``NotImplementedError`` (ROADMAP
queue 1 item 9).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from biapy_tpu_torch.data.io import list_image_files, read_img_as_ndarray, save_tif
from biapy_tpu_torch.data.post_processing import (relabel_sequential, voronoi_on_mask,
                                                  watershed_by_channels)
from biapy_tpu_torch.data.pre_processing import channels_per_code, labels_into_channels
from biapy_tpu_torch.engine import metrics as M
from biapy_tpu_torch.engine.base_workflow import Base_Workflow, _not_ported
from biapy_tpu_torch.parallel import barrier, is_main_process
from biapy_tpu_torch.utils.matching import aggregate_matching, matching

BINARY_CODES = ("B", "F", "P", "C", "T", "M", "F_pre", "F_post", "F_cleft")
FLOW_CODES = ("Gv", "Gh", "Gz")
ITEM = "queue 1 item 9, other workflows"


class Instance_Segmentation_Workflow(Base_Workflow):
    def _check_ported(self):
        """Raise for the instance modes this slice does not port."""
        cfg = self.cfg
        inst = cfg.PROBLEM.INSTANCE_SEG
        codes = list(inst.DATA_CHANNELS)
        process = str(inst.INSTANCE_CREATION_PROCESS or "").lower()
        if any(c.startswith("E") for c in codes) or process in ("embedseg", "embeddings"):
            raise _not_ported("EmbedSeg (the E* channels)", ITEM)
        if cfg.LOSS.CONTRAST.ENABLE:
            raise _not_ported("LOSS.CONTRAST (the contrastive head)", ITEM)

    def define_activations_and_channels(self):
        self._check_ported()
        inst = self.cfg.PROBLEM.INSTANCE_SEG
        self.channel_codes: List[str] = list(inst.DATA_CHANNELS)
        self.synapse_mode = str(inst.TYPE) == "synapses"
        if self.synapse_mode:
            from biapy_tpu_torch.data.synapses import select_synapse_method

            self.synapse_method = select_synapse_method(self.channel_codes)
        extra_l = list(inst.DATA_CHANNELS_EXTRA_OPTS)
        self.channel_extra_opts: Dict = extra_l[0] if extra_l else {}
        losses = list(inst.DATA_CHANNELS_LOSSES)
        if not losses:
            # auto defaults (reference: check_configuration.py:375): bce for
            # binary codes, l1 for distances, mse for offsets
            losses = []
            for c in self.channel_codes:
                if c in BINARY_CODES or c == "A":
                    losses.append("bce")
                elif c in FLOW_CODES or c in ("H", "V", "Z"):
                    losses.append("mse")
                else:
                    losses.append("l1")
        self.channel_losses = losses

        if "We" in self.channel_codes and self.channel_codes[-1] != "We":
            raise ValueError("'We' (border weight map) must be the LAST entry of "
                             "PROBLEM.INSTANCE_SEG.DATA_CHANNELS — it is a GT-only "
                             "channel consumed by the loss (reference: metrics.py:1637)")
        acts: List[str] = []
        self.channels_per_output: List[int] = []
        for c in self.channel_codes:
            n = channels_per_code(c, self.channel_extra_opts, self.nd)
            self.channels_per_output.append(n)
            if c == "We":
                # GT-only weight channel: never predicted (reference:
                # instance_seg.py:440)
                continue
            if c in BINARY_CODES or c == "A":
                acts.extend(["ce_sigmoid"] * n)
            elif c == "D":
                acts.extend(["tanh"] * n)
            elif c in ("H", "V", "Z"):
                acts.extend(["tanh" if self.channel_extra_opts.get(c, {}).get("act") == "tanh"
                             else "linear"] * n)
            else:
                acts.extend(["linear"] * n)
        total = sum(n for c, n in zip(self.channel_codes, self.channels_per_output)
                    if c != "We")  # predicted channels only
        # activations apply channel by channel at inference; the loss sees
        # the raw outputs (the D channel is trained on its logits)
        self._act_channels = [1] * total
        info = "+".join(c for c in self.channel_codes if c != "We")
        self.output_channels = [total]
        self.output_channel_info = [info]
        # the class head (DATA.N_CLASSES > 2; reference: instance_seg.py:
        # 459-465, 955-995): the GT carries a class map beside the labels,
        # the model a second, N_CLASSES softmax head whose probabilities
        # travel flat after the instance channels at inference and whose
        # argmax is voted per instance at test time
        self.n_class_channels = 0
        if int(self.cfg.DATA.N_CLASSES) > 2 and not self.synapse_mode:
            self.n_class_channels = int(self.cfg.DATA.N_CLASSES)
            acts.append("ce_softmax")
            self._act_channels.append(self.n_class_channels)
            self.output_channels = [total, self.n_class_channels]
            self.output_channel_info = [info, "class"]
        self.activations = acts

    def define_metrics(self):
        inst = self.cfg.PROBLEM.INSTANCE_SEG
        weights = list(inst.DATA_CHANNEL_WEIGHTS)
        # with a class head, DATA_CHANNEL_WEIGHTS may carry one more entry,
        # the class head's (reference: check_configuration.py:122 counts the
        # class channel into channels_provided)
        class_w = 1.0
        if self.n_class_channels and len(weights) > len(self.channel_codes):
            class_w = float(weights[len(self.channel_codes)])
        if len(weights) < len(self.channel_codes):
            weights = weights + [1.0] * (len(self.channel_codes) - len(weights))
        mask_distances = {}
        for c in self.channel_codes:
            opts = self.channel_extra_opts.get(c, {})
            # 'R' and the flows mask like the other regressions by default
            # (reference config.py:217: the rays' loss restricted to the
            # binary foreground)
            if c in ("Db", "Dc", "Dn", "H", "V", "Z", "R") or c in FLOW_CODES:
                # Omnipose's Db carries a negative background value the model
                # must learn: never masked to the foreground
                default_mask = not (c == "Db" and str(opts.get("val_type", "")) == "omnipose")
                mask_distances[c] = bool(opts.get("mask_values", default_mask))
        self.loss = M.instance_segmentation_loss(
            out_channels=self.channel_codes,
            losses_to_use=self.channel_losses,
            channel_weights=weights,
            channels_per_output=self.channels_per_output,
            mask_distances=mask_distances,
            class_rebalance_within_channels=bool(inst.CLASS_REBALANCE_WITHIN_CHANNELS),
            n_classes=self.n_class_channels,
            class_channel_weight=class_w,
        )
        # IoU of the first binary channel during training
        first_bin = 0
        off = 0
        for c, n in zip(self.channel_codes, self.channels_per_output):
            if c in BINARY_CODES:
                first_bin = off
                break
            off += n
        self.train_metrics = {
            "iou": lambda out, y, _o=first_bin: M.jaccard_index(
                (out["pred"] if isinstance(out, dict) else out)[..., _o:_o + 1],
                y[..., _o:_o + 1],
            )
        }

    def tta_spec(self):
        from biapy_tpu_torch.data.tta import build_tta_spec

        # predictions carry neither the GT-only 'We' channel nor (as codes)
        # the class head; the class probabilities are per-voxel scalars
        codes = [c for c in self.channel_codes if c != "We"]
        cpo = [n for c, n in zip(self.channel_codes, self.channels_per_output) if c != "We"]
        if self.n_class_channels:
            codes.append("class")
            cpo.append(self.n_class_channels)
        return build_tta_spec(codes, cpo, self.nd, self.channel_extra_opts)

    # -- data: GT labels -> channel masks --------------------------------------
    def _prepare_instance_data(self, split: str):
        """Compile and cache the channel masks (reference:
        prepare_instance_data, instance_seg.py:2864) in
        DATA.<split>.INSTANCE_CHANNELS_MASK_DIR, in the JAX package's format:
        one float32 ``.npy`` per GT image with the raw label column appended
        (with a class head, the GT's class map, its second channel, between
        the two), and ``_channels_meta.json``; then point
        DATA.<split>.GT_PATH at it."""
        node = self.cfg.DATA[split]
        gt_dir = str(node.GT_PATH)
        out_dir = str(node.INSTANCE_CHANNELS_MASK_DIR)
        gts = list_image_files(gt_dir)
        if not gts:
            raise FileNotFoundError(f"No GT instance label images in {gt_dir}")
        # cache format contract: recompile when the channel spec changed or
        # the cache predates the appended label column (meta absent)
        meta_path = os.path.join(out_dir, "_channels_meta.json")
        meta_want = {"codes": list(self.channel_codes), "label_col_appended": True,
                     "n_class_channels": self.n_class_channels}
        meta_ok = False
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    meta_ok = json.load(f) == meta_want
            except (OSError, ValueError):
                meta_ok = False
        # rank 0 writes the cache; other ranks wait — concurrent writers
        # would truncate each other's .npy files mid-read (reference wraps
        # creation in dist.barrier, instance_seg.py:2890)
        if (not os.path.isdir(out_dir) or len(list_image_files(out_dir)) != len(gts)
                or not meta_ok) and is_main_process():
            os.makedirs(out_dir, exist_ok=True)
            if self.verbose:
                print(f"Creating {self.channel_codes} channel masks for {split} in {out_dir}")
            compute_diam = (split == "TRAIN"
                            and any(c in self.channel_codes for c in FLOW_CODES))
            diams: List[float] = []
            for p in gts:
                lab = read_img_as_ndarray(p, is_3d=self.is_3d)
                class_map = None
                if self.n_class_channels:
                    # channel 0 the instance labels, channel 1 the class map
                    # (reference: pre_processing.py:527-549)
                    if lab.shape[-1] != 2:
                        raise ValueError(
                            "With DATA.N_CLASSES > 2, instance GT images need two "
                            "channels (instance labels + class map), got shape "
                            f"{lab.shape} for {p}")
                    class_map = lab[..., 1:2].astype(np.float32)
                    lab = lab[..., :1]
                if compute_diam:
                    d = self._estimate_diameter(lab[..., 0].astype(np.int64))
                    if d:
                        diams.append(d)
                chans = labels_into_channels(lab, self.channel_codes, self.channel_extra_opts)
                if class_map is not None:
                    chans = np.concatenate([chans, class_map], axis=-1)
                # the raw instance-label column rides along so train-time
                # geometric augmentation can regenerate geometry-derived
                # channels from the warped labels; PairDataset.get drops it
                chans = np.concatenate([chans, lab.astype(np.float32)], axis=-1)
                base = os.path.splitext(os.path.basename(p))[0]
                np.save(os.path.join(out_dir, base + ".npy"), chans.astype(np.float32))
            with open(meta_path, "w") as f:
                json.dump(meta_want, f)
            if compute_diam and diams:
                # the training median diameter beside the channels, the JAX
                # package's bytes (reference: cellpose diameter stats cache,
                # pre_processing.py:67)
                with open(os.path.join(out_dir, "cellpose_diam.json"), "w") as f:
                    json.dump({"median_diameter": float(np.median(diams))}, f)
        barrier("instance_masks_" + split.lower())
        self._build_aug_channel_handler()
        diam_file = os.path.join(out_dir, "cellpose_diam.json")
        if split == "TRAIN" and os.path.exists(diam_file):
            with open(diam_file) as f:
                self.cellpose_diameter = float(json.load(f)["median_diameter"])
        frozen = self.cfg.is_frozen()
        if frozen:
            self.cfg.defrost()
        # keep the raw instance GT dir for test-time matching stats
        self._instance_gt_dirs = getattr(self, "_instance_gt_dirs", {})
        self._instance_gt_dirs[split] = gt_dir
        self.cfg.DATA[split].GT_PATH = out_dir
        if frozen:
            self.cfg.freeze()

    def _build_aug_channel_handler(self):
        """Representation-aware train augmentation: flips and rot90 remap the
        channels exactly; resampling transforms regenerate geometry-derived
        columns from the appended label column (reference:
        pair_base_data_generator.py:1567 -> labels_into_channels)."""
        if self.aug_channel_handler is not None:
            return
        from biapy_tpu_torch.data.tta import build_train_channel_handler

        # the compile cache holds the class map as ONE channel of class ids,
        # so the label column sits one past it
        self.aug_channel_handler = build_train_channel_handler(
            self.channel_codes, self.nd, self.channel_extra_opts,
            n_class_channels=1 if self.n_class_channels else 0)

    def _prepare_synapse_data(self, split: str):
        """Compile and cache the synapse channel Zarrs from the CREMI point
        annotations (reference: synapse_channel_creation,
        pre_processing.py:2272) in DATA.<split>.INSTANCE_CHANNELS_MASK_DIR;
        the raw stays nested in the original Zarr, GT_PATH points at the
        channel dir."""
        from biapy_tpu_torch.data.synapses import synapse_channel_creation

        node = self.cfg.DATA[split]
        if not bool(node.INPUT_ZARR_MULTIPLE_DATA):
            raise ValueError("Synapse detection needs 3D Zarr/H5 data with CREMI "
                             "annotations (DATA.*.INPUT_ZARR_MULTIPLE_DATA)")
        out_dir = str(node.INSTANCE_CHANNELS_MASK_DIR)
        zi = {
            "raw_data_path": str(node.INPUT_ZARR_MULTIPLE_DATA_RAW_PATH) or "volumes.raw",
            "id_path": str(node.INPUT_ZARR_MULTIPLE_DATA_ID_PATH),
            "partners_path": str(node.INPUT_ZARR_MULTIPLE_DATA_PARTNERS_PATH),
            "locations_path": str(node.INPUT_ZARR_MULTIPLE_DATA_LOCATIONS_PATH),
            "resolution_path": str(node.INPUT_ZARR_MULTIPLE_DATA_RESOLUTION_PATH),
        }
        os.makedirs(out_dir, exist_ok=True)
        for p in list_image_files(str(node.PATH)):
            out_path = os.path.join(out_dir, os.path.splitext(os.path.basename(p))[0] + ".zarr")
            # rank 0 compiles; the others wait at the barrier below
            if not os.path.exists(os.path.join(out_path, ".zarray")) and is_main_process():
                if self.verbose:
                    print(f"Compiling synapse channels for {p} -> {out_path}")
                synapse_channel_creation(p, out_path, self.channel_codes,
                                         self.channel_extra_opts, zarr_info=zi,
                                         verbose=self.verbose)
        barrier("synapse_channels_" + split.lower())
        frozen = self.cfg.is_frozen()
        if frozen:
            self.cfg.defrost()
        node.GT_PATH = out_dir
        node.INPUT_ZARR_MULTIPLE_DATA_GT_PATH = ""
        if frozen:
            self.cfg.freeze()

    def train(self):
        prepare = self._prepare_synapse_data if self.synapse_mode else self._prepare_instance_data
        prepare("TRAIN")
        if not self.cfg.DATA.VAL.FROM_TRAIN:
            prepare("VAL")
        super().train()

    def test(self, image=None, gt=None):
        self.all_matching_stats: List[List[Dict]] = []
        self._class_ious: List[float] = []
        if image is None and self.cfg.DATA.TEST.LOAD_GT:
            # raw instance GT for matching; the channels are not needed
            self._instance_gt_dirs = getattr(self, "_instance_gt_dirs", {})
            self._instance_gt_dirs["TEST"] = str(self.cfg.DATA.TEST.GT_PATH)
        super().test(image=image, gt=gt)

    # -- instances --------------------------------------------------------------
    def instance_seg_process(self, pred: np.ndarray) -> np.ndarray:
        """Channel maps -> instance labels (reference: instance_seg_process,
        instance_seg.py:924): Cellpose / Omnipose flow tracking with flow
        channels, StarDist NMS with rays (or as
        PROBLEM.INSTANCE_SEG.INSTANCE_CREATION_PROCESS names them), else the
        marker-controlled watershed and the post-processing chain."""
        cfg = self.cfg
        process = str(cfg.PROBLEM.INSTANCE_SEG.INSTANCE_CREATION_PROCESS or "").lower()
        has_flows = any(c in FLOW_CODES for c in self.channel_codes)
        has_rays = "R" in self.channel_codes
        # "gradient-flow" is the reference's canonical name
        # (check_configuration.py:1495); flow_tracking/gradient_tracking are
        # accepted aliases
        if process in ("flow_tracking", "gradient_tracking", "gradient-flow") \
                or (not process and has_flows):
            return self._instances_from_flows(pred)
        if process in ("stardist", "nms") or (not process and has_rays):
            return self._instances_from_rays(pred)
        ws = cfg.PROBLEM.INSTANCE_SEG.WATERSHED
        # one channel per code for the watershed; affinities travel whole
        # (the A-only recipe takes the min over the first three channels,
        # reference: post_processing.py:273)
        flat_codes: List[str] = []
        flat_idx: List[int] = []
        off = 0
        for c, n in zip(self.channel_codes, self.channels_per_output):
            if c == "We":  # GT-only weight channel: not in predictions
                continue
            if c == "A":
                for k in range(n):
                    flat_codes.append("A")
                    flat_idx.append(off + k)
            else:
                flat_codes.append(c)
                flat_idx.append(off)
            off += n
        data = np.stack([pred[..., i] for i in flat_idx], axis=-1)
        labels = watershed_by_channels(
            data,
            flat_codes,
            seed_channels=list(ws.SEED_CHANNELS),
            seed_channel_ths=list(ws.SEED_CHANNELS_THRESH),
            growth_mask_channels=list(ws.GROWTH_MASK_CHANNELS),
            growth_mask_channel_ths=list(ws.GROWTH_MASK_CHANNELS_THRESH),
            topo_surface_channel=str(ws.TOPOGRAPHIC_SURFACE_CHANNEL),
            seed_morph_sequence=list(ws.SEED_MORPH_SEQUENCE),
            seed_morph_radius=list(ws.SEED_MORPH_RADIUS),
            erode_and_dilate_growth_mask=bool(ws.ERODE_AND_DILATE_GROWTH_MASK),
            fore_erosion_radius=int(ws.FORE_EROSION_RADIUS),
            fore_dilation_radius=int(ws.FORE_DILATION_RADIUS),
            remove_before=bool(ws.DATA_REMOVE_BEFORE_MW),
            thres_small_before=int(ws.DATA_REMOVE_SMALL_OBJ_BEFORE),
        )
        pp = cfg.TEST.POST_PROCESSING
        # reference chain order: refinement -> repair large blobs -> voronoi
        # (instance_seg.py:1202-1216)
        if pp.INSTANCE_REFINEMENT.ENABLE:
            from biapy_tpu_torch.data.post_processing import apply_label_refinement

            labels = apply_label_refinement(labels, list(pp.INSTANCE_REFINEMENT.OPERATIONS),
                                            list(pp.INSTANCE_REFINEMENT.VALUES))
        if int(pp.REPARE_LARGE_BLOBS_SIZE) > 0:
            from biapy_tpu_torch.data.post_processing import repair_large_blobs

            labels = repair_large_blobs(labels, int(pp.REPARE_LARGE_BLOBS_SIZE))
        if pp.VORONOI_ON_MASK:
            # mask source as the reference's (instance_seg.py:1216): M, else
            # F(+C), else 1-B, else C, else the first channel
            def _ch(code):
                return pred[..., flat_idx[flat_codes.index(code)]]

            if "M" in flat_codes:
                vor = _ch("M")
            elif "F" in flat_codes:
                vor = _ch("F") + (_ch("C") if "C" in flat_codes else 0)
            elif "B" in flat_codes:
                vor = 1.0 - _ch("B")
            elif "C" in flat_codes:
                vor = _ch("C")
            else:
                vor = pred[..., flat_idx[0]]
            labels = voronoi_on_mask(labels, vor > float(pp.VORONOI_TH or 0.5))
        mp = pp.MEASURE_PROPERTIES
        if mp.ENABLE and mp.REMOVE_BY_PROPERTIES.ENABLE:
            from biapy_tpu_torch.data.post_processing import filter_instances_by_properties

            alias = {"npixels": "size"}  # the reference's synonym
            for props, values, signs in zip(mp.REMOVE_BY_PROPERTIES.PROPS,
                                            mp.REMOVE_BY_PROPERTIES.VALUES,
                                            mp.REMOVE_BY_PROPERTIES.SIGNS):
                props = [alias.get(str(p), str(p)) for p in props]
                labels = filter_instances_by_properties(labels, props, values, signs)
        return relabel_sequential(labels)

    # -- synapses ---------------------------------------------------------------
    def _extract_synapse_points(self, pred: np.ndarray, out_dir: Optional[str] = None,
                                do_post_processing: bool = True,
                                connect: bool = True) -> Dict[str, np.ndarray]:
        """Points from the synapse prediction channels. By chunks this runs
        per tile with ``do_post_processing=False`` and ``connect=False``, so
        close-point removal and the pre/post pairing run once over the merged
        set (reference: per-chunk synapse_seg_process(do_post_processing=False),
        instance_seg.py:1880)."""
        from biapy_tpu_torch.data.post_processing import _otsu, remove_close_points
        from biapy_tpu_torch.data.synapses import (connect_pre_post_points_by_distance,
                                                   extract_points_in_predictions,
                                                   extract_synful_synapses)

        syn = self.cfg.PROBLEM.INSTANCE_SEG.SYNAPSES
        th_type = str(syn.TH_TYPE).lower()
        ths = [_otsu(pred[..., c]) if th_type == "auto" else float(syn.MIN_TH_TO_BE_PEAK)
               for c in range(pred.shape[-1])]
        common = dict(
            point_creation_func=str(syn.POINT_CREATION_FUNCTION),
            min_distance=int(syn.PEAK_LOCAL_MAX_MIN_DISTANCE),
            min_sigma=float(syn.BLOB_LOG_MIN_SIGMA),
            max_sigma=float(syn.BLOB_LOG_MAX_SIGMA),
            num_sigma=int(syn.BLOB_LOG_NUM_SIGMA),
            exclude_border=bool(syn.EXCLUDE_BORDER),
            relative_th_value=th_type in ("relative", "relative_by_patch"),
            out_dir=out_dir,
        )
        codes = self.channel_codes
        points: Dict[str, np.ndarray] = {}
        if self.synapse_method == "synful":
            res = extract_synful_synapses(pred, codes, threshold_abs=0.2, min_distance=1,
                                          cluster_distance=5.0, out_dir=out_dir)
            points["pre"], points["post"] = res["pre"], res["post"]
        elif self.synapse_method == "simpsyn":
            i_pre, i_post = codes.index("F_pre"), codes.index("F_post")
            _, points["pre"] = extract_points_in_predictions(
                pred[..., i_pre], "pre", min_th_to_be_peak=ths[i_pre], **common)
            _, points["post"] = extract_points_in_predictions(
                pred[..., i_post], "post", min_th_to_be_peak=ths[i_post], **common)
            if connect:
                connect_pre_post_points_by_distance(points["pre"], points["post"],
                                                    out_dir=out_dir)
        elif self.synapse_method == "cleft":
            _, points["cleft"] = extract_points_in_predictions(
                pred[..., 0], "cleft", min_th_to_be_peak=ths[0], **common)
        else:  # F_post_only
            _, points["post"] = extract_points_in_predictions(
                pred[..., 0], "post", min_th_to_be_peak=ths[0], **common)
        if not do_post_processing:
            return points
        # removal of too-close points
        radii = {"pre": float(syn.REMOVE_CLOSE_PRE_POINTS_RADIUS),
                 "post": float(syn.REMOVE_CLOSE_POST_POINTS_RADIUS)}
        ch_for = {"pre": codes.index("F_pre") if "F_pre" in codes else 0,
                  "post": codes.index("F_post") if "F_post" in codes else pred.shape[-1] - 1}
        for k, r in radii.items():
            if r > 0 and k in points and len(points[k]):
                if bool(syn.REMOVE_CLOSE_POINTS_RADIUS_BY_MASK):
                    # suppression only within one connected blob of the
                    # binarised prediction (reference: post_processing.py:1839)
                    from biapy_tpu_torch.data.post_processing import remove_close_points_by_mask
                    from biapy_tpu_torch.native import connected_components

                    c = ch_for[k]
                    labs, _ = connected_components((pred[..., c] > ths[c]).astype(np.uint8))
                    points[k] = remove_close_points_by_mask(points[k], r, labs)
                else:
                    points[k] = remove_close_points(points[k], r)
        return points

    def synapse_seg_process(self, pred: np.ndarray, fname: str, out_dir: Optional[str] = None,
                            calculate_metrics: bool = True) -> Dict:
        """Prediction channels -> pre/post/cleft point sets and their
        detection metrics against the CREMI annotations (reference:
        synapse_seg_process, instance_seg.py:1499)."""
        points = self._extract_synapse_points(pred, out_dir=out_dir)
        return self._synapse_metrics_and_result(points, fname, calculate_metrics)

    def _synapse_metrics_and_result(self, points: Dict[str, np.ndarray], fname: str,
                                    calculate_metrics: bool = True) -> Dict:
        from biapy_tpu_torch.data.synapses import load_synapse_gt_points
        from biapy_tpu_torch.utils.matching import detection_metrics

        cfg = self.cfg
        result = {"points": points, "file": fname}
        cur_file = self._current_test_file
        if cur_file is not None and not os.path.exists(cur_file):
            cur_file = None  # in-memory predict(): no CREMI file to read the GT from
        if not (calculate_metrics and cfg.DATA.TEST.LOAD_GT and cur_file):
            return result
        node = cfg.DATA.TEST
        gt = load_synapse_gt_points(
            cur_file,
            id_path=str(node.INPUT_ZARR_MULTIPLE_DATA_ID_PATH),
            partners_path=str(node.INPUT_ZARR_MULTIPLE_DATA_PARTNERS_PATH),
            locations_path=str(node.INPUT_ZARR_MULTIPLE_DATA_LOCATIONS_PATH),
            resolution_path=str(node.INPUT_ZARR_MULTIPLE_DATA_RESOLUTION_PATH),
        )
        m: Dict[str, float] = {}
        for k in points:
            dm = detection_metrics(gt[k], points[k], float(cfg.TEST.DET_TOLERANCE),
                                   gt["resolution"])
            for mk, mv in dm.items():
                m[f"{mk} ({k} points)"] = mv
            if self.verbose:
                print(f"  {fname} synapse {k}: " + " ".join(
                    f"{a}={b:.4f}" if isinstance(b, float) else f"{a}={b}"
                    for a, b in dm.items()))
        result["metrics"] = m
        self.metrics_per_test_file.append(m)
        return result

    def _instance_fn_no_size_filter(self, pred: np.ndarray) -> np.ndarray:
        """A tile's instances without the size filter, which applies over
        the whole volume after the merge instead."""
        mp = self.cfg.TEST.POST_PROCESSING.MEASURE_PROPERTIES
        was = mp.ENABLE
        frozen = self.cfg.is_frozen()
        if frozen:
            self.cfg.defrost()
        mp.ENABLE = False
        try:
            return self.instance_seg_process(pred)
        finally:
            mp.ENABLE = was
            if frozen:
                self.cfg.freeze()

    def _channel_slice(self, code: str) -> Optional[slice]:
        off = 0
        for c, n in zip(self.channel_codes, self.channels_per_output):
            if c == code:
                return slice(off, off + n)
            off += n
        return None

    # -- Cellpose test-time diameter rescale ---------------------------------
    # (reference: CellposeTestPhaseMixin, workflow_utils/cellpose.py — rescale
    # the input by DIAM_MEAN/diameter before the network, resize the flows
    # back to native after the merge, derive niter from the diameter.)
    def _cellpose_rescale_active(self) -> bool:
        c = self.cfg.PROBLEM.INSTANCE_SEG
        extra = self.channel_extra_opts.get("Gv", {})
        return (any(ch in self.channel_codes for ch in FLOW_CODES)
                and str(extra.get("gradient_type", "cellpose")) != "omnipose"
                and str(c.INSTANCE_CREATION_PROCESS).lower() != "omnipose"
                and not self.cfg.TEST.BY_CHUNKS.ENABLE)

    def _estimate_diameter(self, labels: np.ndarray) -> Optional[float]:
        """Median equivalent diameter over instances (the reference caches
        these stats during channel creation, pre_processing.py:67-385)."""
        ids, counts = np.unique(labels[labels > 0], return_counts=True)
        if len(ids) == 0:
            return None
        if labels.ndim == 3:
            diams = 2 * (counts * 3 / (4 * np.pi)) ** (1 / 3)
        else:
            diams = 2 * np.sqrt(counts / np.pi)
        return float(np.median(diams))

    def before_test_sample(self, img, gt, fname):
        self._cellpose_factor = None
        if not self._cellpose_rescale_active():
            return img, gt
        cp = self.cfg.PROBLEM.INSTANCE_SEG.CELLPOSE
        diam = float(cp.DIAMETER)
        if diam <= 0 and bool(cp.TEST_DOUBLE_INFERENCE):
            diam = self._first_pass_diameter(img) or 0.0
        if diam <= 0:
            diam = float(getattr(self, "cellpose_diameter", 0.0) or 0.0)
        if diam <= 0:
            return img, gt
        factor = min(4.0, max(0.25, float(cp.DIAM_MEAN) / diam))
        self._cellpose_diam = diam
        if abs(factor - 1.0) <= 1e-3:
            return img, gt
        from scipy import ndimage

        # in-plane rescale only (z untouched), like Cellpose resample=True
        zoomf = [1.0] * (self.nd - 2) + [factor, factor] + [1.0]
        self._cellpose_factor = factor
        self._cellpose_orig_shape = img.shape
        img = ndimage.zoom(img, zoomf, order=1)
        if self.verbose:
            print(f"[Cellpose test rescale] {fname}: diameter={diam:.2f}px, "
                  f"factor={factor:.4f}, shape {self._cellpose_orig_shape} -> {img.shape}")
        return img, gt

    def _first_pass_diameter(self, img: np.ndarray) -> Optional[float]:
        """Cheap first inference on ONE central patch: run the model, create
        instances at native scale, measure their median diameter
        (reference: _estimate_cellpose_diameter_first_pass,
        workflow_utils/cellpose.py:55)."""
        from biapy_tpu_torch.data.norm import normalize_image
        from biapy_tpu_torch.data.patching import pad_to_min_shape

        ps = tuple(self.cfg.DATA.PATCH_SIZE)[: self.nd]
        img_n, _ = normalize_image(img, self.norm_spec)
        img_n, _ = pad_to_min_shape(img_n, ps)
        starts = [(img_n.shape[d] - ps[d]) // 2 for d in range(self.nd)]
        patch = img_n[tuple(slice(s, s + p) for s, p in zip(starts, ps))]
        pred = np.asarray(self.predict_patches(patch[None]))[0]
        lab = self._instances_from_flows(pred)
        return self._estimate_diameter(lab)

    def post_merge_transform(self, pred: np.ndarray, fname: str) -> np.ndarray:
        if getattr(self, "_cellpose_factor", None) is None:
            return pred
        from scipy import ndimage

        tgt = self._cellpose_orig_shape[: self.nd]
        zoomf = [t / s for t, s in zip(tgt, pred.shape[: self.nd])] + [1.0]
        return ndimage.zoom(pred, zoomf, order=1)

    def _instances_from_flows(self, pred: np.ndarray) -> np.ndarray:
        """Cellpose/Omnipose flow tracking (reference: gradient_tracking.py),
        the integration on the workflow's device."""
        from biapy_tpu_torch.ops.flows import flows_to_instances

        axes = [("Gz", 0), ("Gv", self.nd - 2), ("Gh", self.nd - 1)]
        comps = []
        for code, _ in axes:
            sl = self._channel_slice(code)
            if sl is not None:
                comps.append((code, pred[..., sl][..., 0]))
        # order components by spatial axis: (z,)y,x
        order = {"Gz": 0, "Gv": 1 if self.nd == 3 else 0, "Gh": 2 if self.nd == 3 else 1}
        comps.sort(key=lambda t: order[t[0]])
        flows = np.stack([c for _, c in comps], axis=-1)
        fg_sl = self._channel_slice("F")
        fg_th = float(self.cfg.PROBLEM.INSTANCE_SEG.CELLPOSE.FG_THRESH)
        if fg_sl is not None:
            # PROBLEM.INSTANCE_SEG.CELLPOSE.FG_THRESH (reference:
            # create_instances_from_flows fg_thresh, gradient_tracking.py:681)
            fg = pred[..., fg_sl][..., 0] > fg_th
        else:
            fg = np.linalg.norm(flows, axis=-1) > 0.3
        # Omnipose is selected either by the process alias 'omnipose' or, in
        # the reference's convention, by gradient_type 'omnipose' under the
        # canonical 'gradient-flow' process (check_configuration.py:712)
        suppressed = (
            str(self.cfg.PROBLEM.INSTANCE_SEG.INSTANCE_CREATION_PROCESS).lower() == "omnipose"
            or str(self.channel_extra_opts.get("Gv", {})
                   .get("gradient_type", "cellpose")) == "omnipose")
        db_sl = self._channel_slice("Db")
        db_opts = self.channel_extra_opts.get("Db", {})
        if suppressed and db_sl is not None and str(db_opts.get("val_type", "")) == "omnipose":
            # full Omnipose reconstruction: hysteresis fg from the distance
            # field, div-rescaled suppressed Euler, DBSCAN clustering
            # (reference: compute_masks_omnipose, omnipose_core.py:501)
            from biapy_tpu_torch.ops.omnipose import compute_masks_omnipose

            om = self.cfg.PROBLEM.INSTANCE_SEG.OMNIPOSE
            return compute_masks_omnipose(
                flows, pred[..., db_sl][..., 0],
                mask_threshold=float(om.MASK_THRESHOLD),
                flow_threshold=float(om.FLOW_THRESHOLD),
                niter=int(om.NITER) if int(om.NITER) > 0 else None,
                device=self.device,
            )
        cp = self.cfg.PROBLEM.INSTANCE_SEG.CELLPOSE
        n_iter = int(cp.N_STEPS) if int(cp.N_STEPS) > 0 else 200
        diam = getattr(self, "_cellpose_diam", 0.0)
        if diam and float(cp.DIAM_MEAN) > 0:
            # Cellpose: niter = (diameter / diam_mean) * 200 (reference:
            # workflow_utils/cellpose.py niter derivation)
            n_iter = max(1, int(round(diam / float(cp.DIAM_MEAN) * 200)))
        return flows_to_instances(flows, fg, n_iter=n_iter, suppressed=suppressed,
                                  flow_error_th=float(cp.FLOW_THRESHOLD),
                                  expansion_gate=str(getattr(cp, "EXPANSION_GATE", "cellpose")),
                                  device=self.device)

    def _instances_from_rays(self, pred: np.ndarray) -> np.ndarray:
        """StarDist ray NMS — 2D polygons / 3D polyhedra (reference:
        polygon_nms.py:395)."""
        from biapy_tpu_torch.data.polygon_nms import stardist_nms_2d, stardist_nms_3d

        rays_sl = self._channel_slice("R")
        prob_sl = self._channel_slice("P") or self._channel_slice("F")
        prob = pred[..., prob_sl][..., 0] if prob_sl is not None else np.ones(pred.shape[:-1],
                                                                              np.float32)
        sd = self.cfg.PROBLEM.INSTANCE_SEG.STARDIST
        kw = dict(prob_threshold=float(sd.PROB_THRESH),
                  iou_threshold=float(sd.NMS_IOU_THRESH))
        if sd.GRID:
            kw["grid_step"] = int(list(sd.GRID)[0])
        if self.nd == 3:
            return stardist_nms_3d(prob, pred[..., rays_sl], **kw)
        return stardist_nms_2d(prob, pred[..., rays_sl], **kw)

    def after_by_chunks_prediction(self, ci, raw_path: str, base: str) -> None:
        """By chunks with WORKFLOW_PROCESS (reference:
        after_all_chunk_prediction_workflow_process, instance_seg.py:1915):
        the instances tile by tile and their merge across the tiles into
        ``instances.zarr`` beside the raw prediction (``chunk_by_chunk``,
        ``ChunkedInference.create_and_merge_instances``), or the per-image
        post-processing once over the whole raw prediction
        (``entire_pred``, for volumes that fit the host's memory). In
        synapse mode, per-tile point extraction with core ownership, then
        one pass of close-point removal, pre/post pairing and metrics over
        the merged set (reference: instance_seg.py:1874-1913 per chunk,
        :2395-2440 the merge); the synful method too, which the reference
        leaves out by chunks."""
        bc = self.cfg.TEST.BY_CHUNKS
        if not bc.WORKFLOW_PROCESS.ENABLE:
            return
        if self.synapse_mode:
            self._synapse_by_chunks(ci, raw_path, base)
            return
        if str(bc.WORKFLOW_PROCESS.TYPE) == "entire_pred":
            if is_main_process():
                from biapy_tpu_torch.data.zarr_store import ZarrArray
                from biapy_tpu_torch.engine.chunked import dequant_pred

                self.after_merge_patches(dequant_pred(ZarrArray(raw_path)), None,
                                         base + ".tif")
            return
        # the size filter applies after the merge: the minimum of the
        # REMOVE_BY_PROPERTIES 'size lt/le' rules
        min_size = 0
        mp = self.cfg.TEST.POST_PROCESSING.MEASURE_PROPERTIES
        if mp.ENABLE and mp.REMOVE_BY_PROPERTIES.ENABLE:
            dropped = []
            for props, values, signs in zip(mp.REMOVE_BY_PROPERTIES.PROPS,
                                            mp.REMOVE_BY_PROPERTIES.VALUES,
                                            mp.REMOVE_BY_PROPERTIES.SIGNS):
                for p, v, sign in zip(props, values, signs):
                    if str(p) in ("size", "area", "npixels", "volume") and sign in ("lt", "le",
                                                                                    "lte"):
                        min_size = max(min_size, int(v))
                    else:
                        dropped.append((str(p), str(sign), v))
            if dropped and self.verbose:
                # other property rules would need a second measurement pass
                # over the whole volume: never drop them silently
                print("WARNING: by-chunks instance filtering only applies "
                      "'size lt/le' rules after the merge; these "
                      f"REMOVE_BY_PROPERTIES conditions are NOT applied: {dropped}. "
                      "Run the per-image path (TEST.BY_CHUNKS.ENABLE=False) or "
                      "post-process the instances Zarr to filter on them.")
        phases = [str(p) for p in bc.PHASES]
        if "instance_creation" in phases or "instance_merging" in phases:
            inst_path = ci.create_and_merge_instances(
                raw_path, self._instance_fn_no_size_filter,
                merge_iou_th=float(bc.WORKFLOW_PROCESS.INSTANCE_SEG_MERGE_IOU_TH),
                min_instance_size=min_size, verbose=self.verbose)
            self._predictions.append({"role": "instances_zarr", "path": inst_path, "file": base})

    def _synapse_by_chunks(self, ci, raw_path: str, base: str) -> None:
        from biapy_tpu_torch.data.post_processing import remove_close_points
        from biapy_tpu_torch.data.synapses import connect_pre_post_points_by_distance
        from biapy_tpu_torch.data.zarr_store import ZarrArray
        from biapy_tpu_torch.engine.chunked import core_keep_mask, dequant_pred, owned_tiles
        from biapy_tpu_torch.engine.detection import write_points_csv
        from biapy_tpu_torch.parallel import all_gather_objects

        cfg = self.cfg
        syn = cfg.PROBLEM.INSTANCE_SEG.SYNAPSES
        pred = ZarrArray(raw_path)
        tiles, mine = owned_tiles(ci, tuple(pred.shape[: self.nd]))
        check_dir = cfg.PATHS.RESULT_DIR.DET_LOCAL_MAX_COORDS_CHECK
        if self.save_to_disk:
            os.makedirs(check_dir, exist_ok=True)
        zfill = len(str(len(tiles)))
        # ownership is by point location for every key: the tile whose core
        # holds a point emits it, so the per-tile sets are disjoint (synful
        # pres by their projected location: the halo must cover the offset
        # range for a border pre to be seen by its owning tile)
        local: Dict[str, list] = {}
        for ti, t in mine:
            region = tuple(slice(t.halo_start[d], t.halo_end[d]) for d in range(self.nd))
            p = dequant_pred(pred[region + (slice(None),)])
            pts = self._extract_synapse_points(p, do_post_processing=False, connect=False)
            shift = np.asarray(t.halo_start, np.float32)
            for k, arr in pts.items():
                arr = np.asarray(arr, np.float32).reshape(-1, self.nd)
                if len(arr):
                    arr = arr[core_keep_mask(arr, t, self.nd)]
                arr = arr + shift
                local.setdefault(k, []).append(arr)
                if self.save_to_disk:
                    write_points_csv(os.path.join(
                        check_dir, f"{base}_patch{str(ti).zfill(zfill)}_{k}_points.csv"),
                        arr, self.nd, cast=float)
        gathered = all_gather_objects({k: np.concatenate(v, axis=0) if v else
                                       np.zeros((0, self.nd), np.float32)
                                       for k, v in local.items()})
        if not is_main_process():
            return
        points: Dict[str, np.ndarray] = {}
        for g in gathered:
            for k, arr in g.items():
                points[k] = np.concatenate([points[k], arr], axis=0) if k in points else arr
        # close-point removal per point type, by radius (the by-mask variant
        # needs the whole volume's component labels)
        radii = {"pre": float(syn.REMOVE_CLOSE_PRE_POINTS_RADIUS),
                 "post": float(syn.REMOVE_CLOSE_POST_POINTS_RADIUS)}
        for k, r in radii.items():
            if r > 0 and k in points and len(points[k]):
                points[k] = remove_close_points(points[k], r)
        out_dir = cfg.PATHS.RESULT_DIR.PER_IMAGE_INSTANCES if self.save_to_disk else None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            for k, arr in points.items():
                write_points_csv(os.path.join(out_dir, f"{base}_all_{k}_points.csv"), arr,
                                 self.nd, cast=float)
        if self.synapse_method == "simpsyn" and "pre" in points and "post" in points:
            connect_pre_post_points_by_distance(points["pre"], points["post"], out_dir=out_dir)
        res = self._synapse_metrics_and_result(points, base)
        self._predictions.append({"role": "synapse_points", **res})

    def after_merge_patches(self, pred, sample, fname):
        cfg = self.cfg
        if self.synapse_mode:
            out_dir = cfg.PATHS.RESULT_DIR.PER_IMAGE_INSTANCES if self.save_to_disk else None
            res = self.synapse_seg_process(pred, fname, out_dir=out_dir)
            self._predictions.append({"role": "synapse_points", **res})
            return
        instances = self.instance_seg_process(pred)
        class_map = None
        if self.n_class_channels:
            # the voxels' class argmax voted per instance (reference:
            # instance_seg.py:970-995, 'Adapting class channel')
            pix_cls = np.argmax(pred[..., -self.n_class_channels:], axis=-1).astype(np.int32)
            class_map = self._majority_vote_classes(instances, pix_cls)
            self._predictions.append({"role": "class_map", "classes": class_map, "file": fname})
        self._predictions.append({"role": "instances", "instances": instances, "file": fname})
        if self.save_to_disk:
            dt = np.uint16 if instances.max() < 2**16 else np.uint32
            out_img = instances[None][..., None].astype(dt)
            if class_map is not None:
                # the instances and their voted classes side by side
                # (reference: instance_seg.py:995-1005)
                out_img = np.concatenate([out_img, class_map[None][..., None].astype(dt)],
                                         axis=-1)
            save_tif(out_img, cfg.PATHS.RESULT_DIR.PER_IMAGE_INSTANCES, [fname], verbose=False)
            mp = cfg.TEST.POST_PROCESSING.MEASURE_PROPERTIES
            if mp.ENABLE:
                # per-instance property CSV (+ MEASURE_PROPERTIES.EXTRA_PROPS
                # columns; reference: post_processing.py:2420-2470)
                from biapy_tpu_torch.data.post_processing import instance_properties_csv

                res = list(cfg.DATA.TEST.RESOLUTION) if cfg.DATA.TEST.RESOLUTION and \
                    cfg.DATA.TEST.RESOLUTION != [-1] else (1.0,) * self.nd
                instance_properties_csv(
                    instances,
                    os.path.join(cfg.PATHS.RESULT_DIR.PER_IMAGE_INSTANCES,
                                 os.path.splitext(fname)[0] + "_properties.csv"),
                    resolution=res, extra_props=list(mp.EXTRA_PROPS))
        # matching stats vs the raw instance GT
        gt_dir = getattr(self, "_instance_gt_dirs", {}).get("TEST")
        if not (gt_dir and cfg.TEST.MATCHING_STATS):
            return
        gt_path = os.path.join(gt_dir, fname)
        if not os.path.exists(gt_path) and os.path.isdir(gt_dir):
            # the GT may use another extension than the input image
            stem = fname.split(".")[0]
            cands = [p for p in list_image_files(gt_dir)
                     if os.path.basename(p).split(".")[0] == stem]
            if cands:
                gt_path = cands[0]
        if not os.path.exists(gt_path):
            return
        gt_img = read_img_as_ndarray(gt_path, is_3d=self.is_3d)
        gt_lab = gt_img[..., 0].astype(np.int32)
        if class_map is not None and gt_img.shape[-1] >= 2:
            # the voted class map's IoU against the GT class map, the mean
            # over the foreground classes present (reference:
            # jaccard_index_matching, instance_seg.py:1088)
            gt_cls = gt_img[..., 1].astype(np.int32)
            ious = []
            for k in range(1, self.n_class_channels):
                union = np.count_nonzero((class_map == k) | (gt_cls == k))
                if union:
                    ious.append(np.count_nonzero((class_map == k) & (gt_cls == k)) / union)
            if ious:
                self._class_ious.append(float(np.mean(ious)))
                if self.verbose:
                    print(f"  {fname} class IoU: {self._class_ious[-1]:.4f}")
        stats = matching(gt_lab, instances, thresh=list(cfg.TEST.MATCHING_STATS_THS))
        self.all_matching_stats.append(stats)
        if self.verbose:
            for s in stats:
                print(f"  {fname} matching@{s['thresh']}: f1={s['f1']:.4f} "
                      f"(tp={s['tp']} fp={s['fp']} fn={s['fn']})")
        # RGB match-status overlays: green TP / red FN / blue FP (reference:
        # TEST.MATCHING_STATS_THS_COLORED_IMG, instance_seg.py:1166-1196)
        cths = [t for t in cfg.TEST.MATCHING_STATS_THS_COLORED_IMG
                if t in list(cfg.TEST.MATCHING_STATS_THS)]
        if cths and self.save_to_disk:
            for s in matching(gt_lab, instances, thresh=cths, report_matches=True):
                pairs = s.get("matched_pairs", [])
                m_gt = {t for t, _ in pairs}
                m_pr = {p for _, p in pairs}
                colored = np.zeros(instances.shape + (3,), np.uint8)
                gt_ids = np.unique(gt_lab)
                for g in gt_ids[gt_ids > 0]:
                    colored[gt_lab == g] = (0, 255, 0) if int(g) in m_gt else (255, 0, 0)
                pr_ids = np.unique(instances)
                for p in pr_ids[pr_ids > 0]:
                    if int(p) not in m_pr:
                        colored[instances == p] = (0, 0, 255)
                stem = os.path.splitext(fname)[0]
                save_tif(colored[None], cfg.PATHS.RESULT_DIR.INST_ASSOC_POINTS,
                         [f"{stem}_th_{s['thresh']}.tif"], verbose=False)

    def _majority_vote_classes(self, instances: np.ndarray,
                               pix_cls: np.ndarray) -> np.ndarray:
        """Each instance's majority class over the voxels' argmax, the
        background never winning; an instance with no class evidence takes
        class 1 (reference: instance_seg.py:975-988)."""
        n = int(instances.max())
        if n == 0:
            return np.zeros_like(instances, dtype=np.int32)
        k = self.n_class_channels
        lab = instances.ravel().astype(np.int64)
        cls = pix_cls.ravel().astype(np.int64)
        counts = np.bincount(lab * k + cls, minlength=(n + 1) * k).reshape(n + 1, k)
        counts[:, 0] = 0  # background never wins the vote
        winner = np.argmax(counts, axis=1).astype(np.int32)
        winner[counts.sum(axis=1) == 0] = 1
        winner[0] = 0
        return winner[instances]

    def after_all_images(self):
        if getattr(self, "_class_ious", None) and self.verbose:
            print(f"Test class IoU (per image): {float(np.mean(self._class_ious)):.6f}")
        if getattr(self, "all_matching_stats", None):
            agg = aggregate_matching(self.all_matching_stats,
                                     by_image=bool(self.cfg.TEST.MATCHING_STATS_BY_IMAGE))
            self.matching_stats = agg
            if self.verbose:
                for s in agg:
                    print(f"Dataset matching@{s['thresh']}: f1={s['f1']:.4f} "
                          f"precision={s['precision']:.4f} recall={s['recall']:.4f}")

    def metric_calculation(self, pred: np.ndarray, gt: Optional[np.ndarray]) -> Dict[str, float]:
        """IoU of the first binary channel against the binarised GT labels
        (B, the background channel, through its complement)."""
        if gt is None:
            return {}
        off = 0
        fg_off = b_off = None
        for c, n in zip(self.channel_codes, self.channels_per_output):
            if c == "B":
                b_off = off if b_off is None else b_off
            elif c in BINARY_CODES and fg_off is None:
                fg_off = off
            off += n
        gtb = (gt[..., :1] > 0.5).astype(np.float32)
        if fg_off is not None:
            p = pred[..., fg_off:fg_off + 1]
        elif b_off is not None:
            p = 1.0 - pred[..., b_off:b_off + 1]
        else:
            return {}
        return {"iou": float(M.jaccard_index_numpy(gtb, p))}
