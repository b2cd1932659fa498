"""Representation-aware test-time augmentation, copied from the JAX
package's ``data/tta.py``: the orientation group (``AxisTransform``,
``rot90_transform``, ``flip_transform``, ``build_axis_transform_group``),
the channel groups, ``TTASpec`` / ``build_tta_spec`` and
``ensemble_predictions``, and the instance workflows' train-time channel
handler (``TrainChannelHandler``, ``GEOMETRY_CODES``,
``build_train_channel_handler``).

Reference analog: biapy/data/post_processing/tta.py (AxisTransform:65,
ChannelGroup:262, ScalarChannels:319, VectorChannels:334, RayChannels:408,
AffinityChannels:488, TTASpec:551, build_tta_spec:701) and
ensemble_predictions (post_processing.py:1371).

Orientation group: in 2D the 8 rot90/flip symmetries of the square; in 3D
the same 8 in-plane orientations times an optional z-flip (16). Channel
semantics survive the inverse remap:
  * scalars — values unchanged,
  * vectors (flows / HoVer offsets) — components permuted with the axes and
    sign-flipped on flipped axes,
  * StarDist rays — ray-index permutation (needs nrays % 4 == 0 for rot90;
    transforms that cannot be represented degrade the orientation set),
  * affinities — channel follows its axis; flipping along the offset axis
    additionally rolls the map by the offset distance.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class AxisTransform:
    """Spatial orthogonal transform: permute spatial axes then flip some.

    ``perm[i] = j`` means output axis i takes input axis j. Applies to
    channels-last arrays (spatial..., C).
    """

    perm: Tuple[int, ...]
    flips: Tuple[bool, ...]

    @property
    def ndim(self) -> int:
        return len(self.perm)

    @classmethod
    def identity(cls, ndim: int) -> "AxisTransform":
        return cls(tuple(range(ndim)), (False,) * ndim)

    @property
    def is_identity(self) -> bool:
        return self.perm == tuple(range(self.ndim)) and not any(self.flips)

    def inverse(self) -> "AxisTransform":
        inv_perm = [0] * self.ndim
        inv_flips = [False] * self.ndim
        for i, j in enumerate(self.perm):
            inv_perm[j] = i
            inv_flips[j] = self.flips[i]
        return AxisTransform(tuple(inv_perm), tuple(inv_flips))

    def apply(self, arr: np.ndarray) -> np.ndarray:
        """Apply to (spatial..., C) or batched (B, spatial..., C) arrays."""
        lead = arr.ndim - self.ndim - 1  # 0 or 1 leading batch dims
        axes = tuple(range(lead)) + tuple(lead + p for p in self.perm) + (arr.ndim - 1,)
        out = np.transpose(arr, axes)
        for i, f in enumerate(self.flips):
            if f:
                out = np.flip(out, axis=lead + i)
        return out

    def transform_vector_components(self, vec: np.ndarray) -> np.ndarray:
        """Remap a (..., ndim) stack of per-axis vector components."""
        out = vec[..., list(self.perm)]
        signs = np.array([-1.0 if f else 1.0 for f in self.flips], vec.dtype)
        return out * signs

    def compose(self, first: "AxisTransform") -> "AxisTransform":
        """``(self ∘ first).apply(x) == self.apply(first.apply(x))``."""
        perm = tuple(first.perm[self.perm[i]] for i in range(self.ndim))
        flips = tuple(self.flips[i] != first.flips[self.perm[i]]
                      for i in range(self.ndim))
        return AxisTransform(perm, flips)


def rot90_transform(k: int, ndim: int) -> AxisTransform:
    """AxisTransform equal to ``np.rot90(x, k, axes=(-3, -2))`` on a
    channels-last array (pinned by tests/test_aug_channels.py): one CCW
    quarter-turn of the (y, x) block is transpose + flip of the new y axis."""
    if ndim == 2:
        q = AxisTransform((1, 0), (True, False))
    else:
        q = AxisTransform((0, 2, 1), (False, True, False))
    t = AxisTransform.identity(ndim)
    for _ in range(k % 4):
        t = q.compose(t)
    return t


def flip_transform(axis: int, ndim: int) -> AxisTransform:
    """AxisTransform equal to ``np.flip`` along spatial ``axis``."""
    flips = tuple(d == axis for d in range(ndim))
    return AxisTransform(tuple(range(ndim)), flips)


def build_axis_transform_group(ndim: int, zflip: bool = True,
                               level: str = "full") -> List[AxisTransform]:
    """8 orientations in 2D; 16 in 3D (reference: 8/16 TTA variants).
    ``level``: 'full'/'auto' = rot90s + flips; 'flips' = axis flips only
    (4 in 2D, 8 in 3D — what Cellpose does upstream); 'none' = identity
    (reference: TEST.AUGMENTATION_GROUP)."""
    level = (level or "full").lower()
    if level == "none":
        return [AxisTransform.identity(ndim)]
    group: List[AxisTransform] = []
    rots = [
        ((0, 1), (False, False)),   # identity
        ((1, 0), (False, True)),    # rot90
        ((0, 1), (True, True)),     # rot180
        ((1, 0), (True, False)),    # rot270
    ]
    if level == "flips":
        rots = [((0, 1), (False, False)), ((0, 1), (True, False))]  # id + vflip
    for perm2, flips2 in rots:
        for hflip in (False, True):
            f = (flips2[0], flips2[1] != hflip)
            if ndim == 2:
                group.append(AxisTransform(perm2, f))
            else:
                for zf in ((False,) if not zflip else (False, True)):
                    group.append(AxisTransform((0, perm2[0] + 1, perm2[1] + 1), (zf,) + f))
    return group


# ---------------------------------------------------------------------------
# channel groups
# ---------------------------------------------------------------------------
@dataclass
class ChannelGroup:
    channels: Tuple[int, ...]

    def supports(self, t: AxisTransform) -> bool:
        return True

    def remap(self, pred: np.ndarray, t: AxisTransform) -> None:
        """In-place channel-content fix AFTER the spatial inverse was applied;
        ``t`` is the forward transform being undone."""


@dataclass
class ScalarChannels(ChannelGroup):
    pass


@dataclass
class VectorChannels(ChannelGroup):
    """Channels = per-axis vector components, ordered like the spatial axes
    (e.g. (Gz, Gv, Gh) -> axes (z, y, x)). ``signed=False`` for per-axis
    magnitudes (e.g. EmbedSeg sigmas): components permute with the axes but
    never change sign under flips."""

    signed: bool = True

    def remap(self, pred: np.ndarray, t: AxisTransform) -> None:
        inv = t.inverse()
        comps = pred[..., list(self.channels)]
        if self.signed:
            comps = inv.transform_vector_components(comps)
        else:
            comps = comps[..., list(inv.perm)]
        pred[..., list(self.channels)] = comps


@dataclass
class PartialVectorChannels(ChannelGroup):
    """Vector components covering only SOME spatial axes (e.g. H+V without
    Z in 3D — a combination validation allows): transforms mixing covered
    and uncovered axes are dropped from the ensemble; the rest permute and
    sign-flip like full vectors. Treating these as scalars would average
    +g against -g under flips and null the offsets."""

    axes: Tuple[int, ...] = ()

    def supports(self, t: AxisTransform) -> bool:
        return all(t.perm[ax] in self.axes for ax in self.axes)

    def remap(self, pred: np.ndarray, t: AxisTransform) -> None:
        inv = t.inverse()
        chan_of = dict(zip(self.axes, self.channels))
        orig = {ax: pred[..., chan_of[ax]].copy() for ax in self.axes}
        for ax in self.axes:
            v = orig[inv.perm[ax]]
            if inv.flips[ax]:
                v = -v
            pred[..., chan_of[ax]] = v


@dataclass
class RayChannels(ChannelGroup):
    """StarDist radial distances at angles 2*pi*k/nrays, measured in (y, x)
    with angle from +x toward +y."""

    def _permutation(self, t: AxisTransform) -> Optional[np.ndarray]:
        """idx[k] = source ray for output ray k = angle-index of t(d_k)
        (forward transform on ray directions; pinned by the oracle tests)."""
        n = len(self.channels)
        o = t.ndim - 2  # 2D spatial part (last two axes in 3D)
        perm2 = tuple(p - o for p in t.perm[o:])
        flips2 = t.flips[o:]
        ang = 2 * np.pi * np.arange(n) / n
        d = np.stack([np.sin(ang), np.cos(ang)], axis=-1)  # (n, [y,x])
        nd = d[:, list(perm2)]
        signs = np.array([-1.0 if f else 1.0 for f in flips2])
        nd = nd * signs
        new_ang = np.arctan2(nd[:, 0], nd[:, 1]) % (2 * np.pi)
        idx = new_ang / (2 * np.pi / n)
        idx_round = np.round(idx).astype(int) % n
        if not np.allclose(idx, np.round(idx), atol=1e-6):
            return None
        return idx_round

    def supports(self, t: AxisTransform) -> bool:
        if t.ndim == 3:
            # 3D rays are a Fibonacci sphere (pre_processing.generate_rays):
            # no orientation maps the ray set onto itself, so only the
            # identity keeps the representation consistent (the reference
            # likewise degrades the orientation set for non-equivariant
            # representations, tta.py:701).
            ident = all(p == i for i, p in enumerate(t.perm)) and not any(t.flips)
            return ident
        return self._permutation(t) is not None

    def remap(self, pred: np.ndarray, t: AxisTransform) -> None:
        perm = self._permutation(t)
        chans = np.asarray(self.channels)
        # The value measured along direction k in transformed space equals the
        # value along direction perm[k] in original space.
        pred[..., chans] = pred[..., chans[perm]]


@dataclass
class AffinityChannels(ChannelGroup):
    """One channel per (axis, offset) pair; affinity(x) = same-instance
    indicator between x and x + offset*e_axis."""

    offsets: Tuple[Tuple[int, int], ...] = ()  # (axis, distance) per channel

    def supports(self, t: AxisTransform) -> bool:
        # the permuted axis must carry an affinity with the same distance set
        by_axis = {}
        for (ax, dist) in self.offsets:
            by_axis.setdefault(ax, []).append(dist)
        for ax, dists in by_axis.items():
            src = t.perm[ax]
            if sorted(by_axis.get(src, [])) != sorted(dists):
                return False
        return True

    def remap(self, pred: np.ndarray, t: AxisTransform) -> None:
        # Derivation pinned by tests/test_tta_equivariance.py: the output
        # channel for (ax, d) sources the channel of axis t.perm[ax]; when
        # the undo flipped the output axis (t.inverse().flips[ax]), the
        # neighbour relation reverses direction -> roll the map by -d.
        inv = t.inverse()
        chans = list(self.channels)
        lead = pred.ndim - inv.ndim - 1
        orig = {(ax, d): pred[..., c].copy() for (ax, d), c in zip(self.offsets, chans)}
        for (ax, dist), c in zip(self.offsets, chans):
            src_ax = t.perm[ax]
            vals = orig[(src_ax, dist)]
            if inv.flips[ax]:
                vals = np.roll(vals, -dist, axis=lead + ax)
            pred[..., c] = vals


@dataclass
class TTASpec:
    ndim: int
    n_channels: int
    groups: List[ChannelGroup] = field(default_factory=list)

    @property
    def is_scalar_only(self) -> bool:
        return all(isinstance(g, ScalarChannels) for g in self.groups)


def build_tta_spec(channel_codes: Sequence[str], channels_per_code: Sequence[int],
                   ndim: int, channel_extra_opts: Optional[dict] = None) -> TTASpec:
    """Build the channel-semantics spec from instance channel codes
    (reference: build_tta_spec, tta.py:701)."""
    extra = channel_extra_opts or {}
    groups: List[ChannelGroup] = []
    off = 0
    scalars: List[int] = []
    # vector components collected by family
    hover: dict = {}
    flows: dict = {}
    axis_of = {"Z": 0, "V": ndim - 2, "H": ndim - 1, "Gz": 0, "Gv": ndim - 2, "Gh": ndim - 1}
    for code, n in zip(channel_codes, channels_per_code):
        chans = tuple(range(off, off + n))
        if code in ("H", "V", "Z"):
            hover[axis_of[code]] = off
        elif code in ("Gh", "Gv", "Gz"):
            flows[axis_of[code]] = off
        elif code == "R":
            groups.append(RayChannels(chans))
        elif code == "A":
            from biapy_tpu_torch.data.pre_processing import affinity_offsets

            # the SAME enumeration the compiler/channel counter use — a
            # divergent default here shifted every (axis, dist) pairing
            groups.append(AffinityChannels(
                chans, offsets=tuple(affinity_offsets(extra, ndim))))
        elif code.startswith("E"):
            # EmbedSeg: offsets are spatial vectors, sigmas are per-axis
            # magnitudes (permute, never sign-flip), seediness is a scalar
            if code == "E":
                groups.append(VectorChannels(chans[:ndim]))
                groups.append(VectorChannels(chans[ndim:2 * ndim], signed=False))
                scalars.extend(chans[2 * ndim:])
            elif code == "E_offset":
                groups.append(VectorChannels(chans))
            elif code == "E_sigma":
                groups.append(VectorChannels(chans, signed=False))
            else:
                scalars.extend(chans)
        else:
            scalars.extend(chans)
        off += n
    for fam in (hover, flows):
        if fam:
            if len(fam) == ndim:
                ordered = tuple(fam[d] for d in range(ndim))
                groups.append(VectorChannels(ordered))
            else:
                axes = tuple(sorted(fam))
                groups.append(PartialVectorChannels(
                    tuple(fam[a] for a in axes), axes=axes))
    if scalars:
        groups.insert(0, ScalarChannels(tuple(sorted(scalars))))
    return TTASpec(ndim=ndim, n_channels=off, groups=groups)


def ensemble_predictions(
    pred_fn: Callable[[np.ndarray], np.ndarray],
    img: np.ndarray,
    spec: Optional[TTASpec] = None,
    ndim: Optional[int] = None,
    mode: str = "mean",
    zflip: bool = True,
    group_level: str = "full",
) -> np.ndarray:
    """Orientation-averaged prediction (reference: ensemble_predictions,
    post_processing.py:1371). ``pred_fn`` maps a channels-last image (or
    batch) to activated predictions; transforms whose channel semantics
    cannot be inverted are dropped from the ensemble."""
    nd = spec.ndim if spec is not None else (ndim or img.ndim - 1)
    group = build_axis_transform_group(nd, zflip=zflip, level=group_level)
    if spec is not None and not spec.is_scalar_only:
        group = [t for t in group if all(g.supports(t) for g in spec.groups)]
        if not group:
            group = [AxisTransform.identity(nd)]
    outs = []
    for t in group:
        x = t.apply(img)
        y = np.asarray(pred_fn(x))
        y = t.inverse().apply(y)
        if spec is not None:
            y = y.copy()
            for g in spec.groups:
                g.remap(y, t)
        outs.append(y)
    stack = np.stack(outs)
    if mode == "mean":
        return stack.mean(axis=0)
    if mode == "min":
        return stack.min(axis=0)
    if mode == "max":
        return stack.max(axis=0)
    raise ValueError(f"Unknown TTA reduction: {mode}")


# ---------------------------------------------------------------------------
# train-time channel semantics
# ---------------------------------------------------------------------------
@dataclass
class TrainChannelHandler:
    """Representation-aware GEOMETRIC augmentation of compiled GT channels.

    The reference keeps the raw instance-label column through every
    transform (nearest-interpolated) and regenerates geometry-derived
    channels from the augmented labels each batch
    (pair_base_data_generator.py:1567-1579 -> labels_into_channels); flow
    vectors are additionally re-oriented during the warp itself
    (augmentors.py:1892 rotate_flow_vectors, :1936 flip_flow_vectors).

    Here orthogonal transforms (flips / rot90) use the EXACT channel remap
    the TTA groups define — distances are isometry-invariant scalars,
    vectors permute/sign-flip, rays permute their angle index, affinities
    follow their axis — so the common augmentations pay nothing; only
    resampling transforms (affine / elastic / z-zoom / cut ops on the mask)
    fall back to the reference's regeneration from the label column.
    """

    spec: TTASpec
    label_col: Optional[int] = None            # raw instance-id column
    regen_cols: Tuple[int, ...] = ()           # geometry-derived columns
    regen_fn: Optional[Callable] = None        # labels (...,1) -> compiled stack
    affine_mode: Optional[str] = None          # e.g. cellpose flows -> constant

    @property
    def can_regen(self) -> bool:
        return (self.label_col is not None and self.regen_fn is not None
                and len(self.regen_cols) > 0)

    def supports(self, t: AxisTransform) -> bool:
        return all(g.supports(t) for g in self.spec.groups)

    def remap_forward(self, mask: np.ndarray, t: AxisTransform) -> None:
        """Fix channel CONTENTS in place after ``t`` was applied spatially.

        The TTA groups define ``remap(y, s)`` = content fix after the
        spatial inverse of ``s`` was applied to a field expressed in
        s-space; a field in original space to which forward ``t`` was
        applied spatially is the same situation with ``s = t.inverse()``.
        """
        ti = t.inverse()
        for g in self.spec.groups:
            g.remap(mask, ti)

    def regen(self, mask: np.ndarray) -> np.ndarray:
        """Recompile geometry-derived columns from the (augmented) label
        column, exactly as the offline targets were built."""
        labels = np.rint(mask[..., self.label_col]).astype(np.int32)[..., None]
        full = self.regen_fn(labels)
        cols = list(self.regen_cols)
        mask[..., cols] = full[..., cols]
        return mask


# channel codes whose values are functions of geometry (regenerated from the
# label column after a resampling transform; the reference regenerates its
# "no_bin"/"flow"-typed channels + affinities the same way)
GEOMETRY_CODES = frozenset(
    {"H", "V", "Z", "Gh", "Gv", "Gz", "Db", "Dc", "Dn", "D", "R", "A", "We"})


def build_train_channel_handler(channel_codes: Sequence[str], ndim: int,
                                channel_extra_opts: Optional[dict] = None,
                                n_class_channels: int = 0) -> TrainChannelHandler:
    """TrainChannelHandler for a compiled-channel stack laid out as
    [codes block][class map][label column] (instance_seg compile cache)."""
    from biapy_tpu_torch.data.pre_processing import channels_per_code, labels_into_channels

    extra = channel_extra_opts or {}
    codes = list(channel_codes)
    widths = [channels_per_code(c, extra, ndim) for c in codes]
    spec = build_tta_spec(codes, widths, ndim, extra)
    label_col = sum(widths) + int(n_class_channels or 0)
    regen_cols: List[int] = []
    off = 0
    for c, n in zip(codes, widths):
        if c in GEOMETRY_CODES:
            regen_cols.extend(range(off, off + n))
        off += n
    gradient_type = next(
        (str(extra.get(g, {}).get("gradient_type", ""))
         for g in ("Gv", "Gh", "Gz") if extra.get(g, {}).get("gradient_type")),
        "cellpose")
    has_flows = any(c in ("Gv", "Gh", "Gz") for c in codes)
    # Cellpose flows pad with zeros: reflecting a flow field fabricates
    # border cells; Omnipose completes border cells by reflection
    # (reference: pair_base_data_generator.py:570-575)
    affine_mode = "constant" if has_flows and gradient_type == "cellpose" else None
    return TrainChannelHandler(
        spec=spec,
        label_col=label_col,
        regen_cols=tuple(regen_cols),
        regen_fn=lambda lab: labels_into_channels(lab, codes, extra),
        affine_mode=affine_mode,
    )
