"""The port's conv3d routing rule and weight packs, on the CPU.

``conv3d_route`` decides from (dtype, Cin, Cout) alone which CUDA kernel a
launch takes; ``pack_weights`` / ``pack_weights_dx`` build the K-major,
zero-padded ``(27, Cout_p, Cin_p)`` operand of the tensor-core kernels,
``tf32_split`` / ``split_x`` the 3xTF32 kernel's TF32 pairs, and
``pad_channels`` the bf16 kernel's channel-padded x. The kernels run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); here their operands are
held against their definitions, and their arithmetic (the tensor-core
kernels' 27 shifted ``x_p @ pack[t].T`` products, the 3xTF32 kernel's three
terms, the stem kernel's 32-channel weight chunks) against
``conv3d_plain`` and against autograd's input gradient.
"""

import sys
from collections import Counter
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from biapy_tpu_torch.ops.kernels import build
from biapy_tpu_torch.ops.kernels.conv3d import (STEM_CIN, conv3d, conv3d_dx, conv3d_plain,
                                                conv3d_route, pack_weights, pack_weights_dx,
                                                pad_channels, split_x, tf32_round, tf32_split)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (imports nothing but the standard library at import)

torch.set_num_threads(2)


@pytest.mark.parametrize("size,cin,cout", chip_smoke.MAIN_CONVS)
def test_route_of_main_path_forward_shapes(size, cin, cout):
    # the 1-channel stem takes the stem kernel in either dtype; the rest the
    # tensor cores, in bf16 and (3xTF32) in float32
    assert conv3d_route(torch.bfloat16, cin, cout) == ("stem" if cin == 1 else "wgmma")
    assert conv3d_route(torch.float32, cin, cout) == ("stem" if cin == 1 else "tf32x3")


@pytest.mark.parametrize("size,cin,cout", chip_smoke.DX_CONVS)
def test_route_of_main_path_dx_shapes(size, cin, cout):
    assert conv3d_route(torch.bfloat16, cin, cout) == "wgmma"
    assert conv3d_route(torch.float32, cin, cout) == "tf32x3"


@pytest.mark.parametrize("dtype,cin,cout,want", [
    (torch.bfloat16, 16, 8, "wgmma"),     # the narrowest widths the rule takes
    (torch.bfloat16, 48, 40, "wgmma"),    # a channel tail, a tile wider than Cout
    (torch.bfloat16, 80, 264, "wgmma"),   # a loop over output tiles
    (torch.bfloat16, 24, 40, "wgmma"),    # Cin % 16 != 0: zeros from TMA
    (torch.bfloat16, 8, 8, "wgmma"),
    (torch.bfloat16, 32, 12, "wgmma"),    # Cout % 8 != 0: a tile of Cout_p
    (torch.bfloat16, 32, 1, "wgmma"),
    (torch.bfloat16, 1, 32, "stem"),      # the 1-channel stem
    (torch.bfloat16, 28, 28, "wgmma"),    # the templates' widths: x padded to 32 channels
    (torch.bfloat16, 28, 36, "wgmma"),
    (torch.bfloat16, 36, 36, "wgmma"),    # x padded to 40, a 16-channel tail step
    (torch.bfloat16, 84, 36, "wgmma"),
    (torch.bfloat16, 36, 84, "wgmma"),
    (torch.bfloat16, 3, 32, "stem"),      # a 3-channel image
    (torch.bfloat16, 3, 28, "stem"),
    (torch.bfloat16, STEM_CIN - 1, 32, "stem"),  # the stem cut
    (torch.bfloat16, STEM_CIN, 32, "wgmma"),
    (torch.float32, STEM_CIN - 1, 32, "stem"),
    (torch.float32, STEM_CIN, 32, "tf32x3"),
    (torch.float32, 1, 28, "stem"),
    (torch.float32, 28, 28, "tf32x3"),
    (torch.float16, 1, 32, "tf32x3"),     # no stem kernel in half either
    (torch.float32, 64, 64, "tf32x3"),    # float32 at float32's accuracy on the tensor cores
    (torch.float16, 32, 32, "tf32x3"),    # (and is refused there: no half kernel)
    (torch.float64, 32, 32, "tf32x3"),
    (torch.float32, 28, 36, "tf32x3"),    # the templates' widths: 16-byte rows, no pad
    (torch.float32, 36, 28, "tf32x3"),
    (torch.float32, 84, 36, "tf32x3"),
    (torch.float32, 112, 48, "tf32x3"),
    (torch.float32, 5, 12, "tf32x3"),     # Cin % 4 != 0: x channel-padded to 8
])
def test_route_rule(dtype, cin, cout, want):
    assert conv3d_route(dtype, cin, cout) == want


def test_route_counts_of_the_smoke_run_follow_from_the_rule():
    def count(shapes, dtype=torch.bfloat16):
        got = Counter(conv3d_route(dtype, cin, cout) for _, cin, cout in shapes)
        return {k: got.get(k, 0) for k in build.CONV3D_ROUTES}

    assert count(chip_smoke.MAIN_CONVS) == chip_smoke.SERVE_ROUTES
    assert count(chip_smoke.MAIN_CONVS + chip_smoke.DX_CONVS) == chip_smoke.TRAIN_ROUTES
    # with LARGER_IO the stem is a 5x5x5 conv, the first 3x3x3 conv has
    # Cin = 32 and gets an input gradient as well
    larger_io = [(128, 32, 32)] + chip_smoke.MAIN_CONVS[1:]
    both = larger_io + [(s, cout, cin) for s, cin, cout in larger_io]
    assert count(both) == chip_smoke.LARGER_IO_ROUTES
    for routes, launches in ((chip_smoke.TRAIN_ROUTES, chip_smoke.TRAIN_LAUNCHES),
                             (chip_smoke.LARGER_IO_ROUTES, chip_smoke.LARGER_IO_LAUNCHES)):
        assert sum(routes.values()) == launches["conv3d"]
    assert set(build.CONV3D_ROUTES) == set(chip_smoke.CONV3D_ROUTE_NAMES) == {"wgmma", "stem",
                                                                             "tf32x3"}
    # the 3D templates' 14 forward convs (the stem on its kernel, the rest,
    # 28 and 36 channels included, on the tensor cores) and 13 input
    # gradients (all on the tensor cores); in float32 all but the stem on
    # the 3xTF32 kernel
    fwd, dx = chip_smoke._template_conv_rows()
    assert count(fwd) == {"wgmma": 13, "stem": 1, "tf32x3": 0}
    assert count(dx) == {"wgmma": 13, "stem": 0, "tf32x3": 0}
    assert count(fwd + dx, torch.float32) == {"wgmma": 0, "stem": 1, "tf32x3": 26}
    # the forward convs that hand the tensor cores a channel-padded x, and
    # the input gradients that do (gy of 28 or 36 channels): the pads of a
    # template step, none on the main paths
    assert [cin for _, cin, _ in fwd[1:] if cin % 8] == [28, 28, 36, 36, 84, 36, 28]
    assert [cin for _, cin, _ in dx if cin % 8] == [28, 36, 36, 36, 36, 28, 28]

    def pads(shapes, dtype=torch.bfloat16):
        return chip_smoke._channel_pads(dtype, [(cin, cout) for *_, cin, cout in shapes])
    assert pads(fwd) + pads(dx) == 14 and pads(fwd + dx, torch.float32) == 0
    assert pads(chip_smoke.MAIN_CONVS) == chip_smoke.SERVE_LAUNCHES["pad_channels"] == 0
    assert (pads(chip_smoke.MAIN_CONVS + chip_smoke.DX_CONVS)
            == chip_smoke.TRAIN_LAUNCHES["pad_channels"] == 0)
    assert set(chip_smoke.KERNEL_META) == set(build.LAUNCHES)
    # the stems the script times, all on the stem kernel in either dtype
    for dtype in (torch.bfloat16, torch.float32):
        assert count(chip_smoke.STEM_CONVS, dtype) == {"wgmma": 0, "stem": 3, "tf32x3": 0}
    # the odd shapes of the smoke run: the last three on the stem kernel, the
    # rest on the tensor cores, in bf16 and (3xTF32) in float32
    odd = [conv3d_route(torch.bfloat16, cin, cout) for _, cin, cout in chip_smoke.ODD_CONVS]
    assert odd == ["wgmma"] * (len(odd) - 3) + ["stem"] * 3
    odd32 = [conv3d_route(torch.float32, cin, cout) for _, cin, cout in chip_smoke.ODD_CONVS]
    assert odd32 == ["tf32x3"] * (len(odd) - 3) + ["stem"] * 3
    # the one float32 x of them whose TF32 pair the split pads (to 8)
    assert [cin for _, cin, _ in chip_smoke.ODD_CONVS if cin >= STEM_CIN and cin % 4] == [5]
    assert {cin for _, cin, _ in chip_smoke.ODD_CONVS} >= {28, 36, 84, 3, 1}
    assert {cout for _, _, cout in chip_smoke.ODD_CONVS} >= {28, 36, 12, 1}


def _weights(cin, cout, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((3, 3, 3, cin, cout), generator=g) / (27 * cin) ** 0.5).to(dtype)


def _r8(n):
    return -(-n // 8) * 8


@pytest.mark.parametrize("cin,cout", [(16, 8), (48, 40), (32, 32), (3, 5), (28, 36), (36, 28),
                                      (84, 12), (5, 1)])
def test_pack_weights_matches_its_definition(cin, cout):
    """(27, Cout_p, Cin_p), both widths rounded up to 8, zero in the pad."""
    w = _weights(cin, cout)
    p = pack_weights(w)
    assert p.shape == (27, _r8(cout), _r8(cin)) and p.is_contiguous()
    flat = w.reshape(27, cin, cout)
    for t, co, ci in ((0, 0, 0), (13, cout - 1, 0), (26, cout // 2, cin - 1),
                      (5, cout // 2, cin // 2)):
        assert p[t, co, ci] == flat[t, ci, co]
    assert torch.equal(p[:, :cout, :cin], flat.permute(0, 2, 1))
    assert not p[:, cout:].any() and not p[:, :, cin:].any()


@pytest.mark.parametrize("cin,cout", [(16, 8), (48, 40), (32, 96), (3, 5), (28, 36), (36, 84)])
def test_dx_pack_is_a_flip_and_no_transpose(cin, cout):
    w = _weights(cin, cout, seed=1)
    wdx = w.flip(0, 1, 2).transpose(3, 4)  # the dx conv's DHWIO weights: (3,3,3,Cout,Cin)
    p = pack_weights_dx(w)
    assert p.shape == (27, _r8(cin), _r8(cout)) and p.is_contiguous()
    assert torch.equal(pack_weights(wdx)[:, :cin, :cout], w.flip(0, 1, 2).reshape(27, cin, cout))
    assert torch.equal(p, pack_weights(wdx))
    assert not p[:, cin:].any() and not p[:, :, cout:].any()


@pytest.mark.parametrize("c", [1, 3, 8, 28, 36, 84])
def test_pad_channels_pads_to_eight_with_zeros(c):
    build.reset_launches()
    x = torch.randn((2, 3, 4, 5, c), generator=torch.Generator().manual_seed(c))
    xp = pad_channels(x)
    assert xp.shape == (2, 3, 4, 5, _r8(c))
    assert torch.equal(xp[..., :c], x) and not xp[..., c:].any()
    if c % 8 == 0:
        assert xp is x  # no copy where TMA reads x as it is
    assert build.LAUNCHES["pad_channels"] == 0  # a CPU tensor takes F.pad


@pytest.mark.parametrize("c", [1, 3, 5, 8, 28, 36, 84, 112])
def test_split_x_is_the_tf32_pair_padded_to_four(c):
    """The 3xTF32 route's x: its TF32 pair, channels zero-padded to 4 (16-byte
    rows): the templates' 28, 36, 84 and 112 need no pad; a CPU x counts no
    launch."""
    build.reset_launches()
    x = torch.randn((2, 3, 4, 5, c), generator=torch.Generator().manual_seed(c))
    hi, lo = split_x(x)
    cp = -(-c // 4) * 4
    want_hi, want_lo = tf32_split(x)
    for got, want in ((hi, want_hi), (lo, want_lo)):
        assert got.shape == (2, 3, 4, 5, cp) and got.dtype == torch.float32
        assert torch.equal(got[..., :c], want) and not got[..., c:].any()
    assert build.LAUNCHES["tf32_split"] == 0


def test_packs_are_rebuilt_from_the_weights_as_they_are_now():
    """No pack outlives its launch, so an optimizer's in-place update can
    never leave a stale one: the pack of an updated tensor is the updated
    pack."""
    w = _weights(16, 8, seed=2)
    before, before_dx = pack_weights(w), pack_weights_dx(w)
    version = w._version
    w.mul_(0.5).add_(1.0)
    assert w._version > version
    assert torch.equal(pack_weights(w), before * 0.5 + 1.0)
    assert torch.equal(pack_weights_dx(w), before_dx * 0.5 + 1.0)
    assert not torch.equal(pack_weights(w), before)


def _conv_from_packed(x, packed, cout, acc=torch.float32):
    """What the tensor-core kernel computes from its operands: x with its
    channels padded to the pack's Cin_p (``pad_channels``, then TMA's zeros
    up to 16), for tap t = (dz, dy, dx) the shifted x times ``packed[t].T``,
    summed in float32 over the whole Cout_p tile; the first ``cout``
    channels are written."""
    n, d, h, wd, _ = x.shape
    xk = pad_channels(x)
    assert xk.shape[-1] == packed.shape[2]
    xp = F.pad(xk.to(acc), (0, 0, 1, 1, 1, 1, 1, 1))
    out = torch.zeros((n, d, h, wd, packed.shape[1]), dtype=acc)
    for t in range(27):
        dz, dy, dx = t // 9, (t // 3) % 3, t % 3
        out += xp[:, dz:dz + d, dy:dy + h, dx:dx + wd, :] @ packed[t].to(acc).T
    return out[..., :cout].to(x.dtype)


def _stem_from_chunks(x, w):
    """What the stem kernel computes: each voxel's 27 * Cin taps (tap-major,
    then input channel, zero outside the volume) times the (27 * Cin, 32)
    weight chunk of each 32 output channels, zero past Cout, summed in
    float32; the first Cout channels are written."""
    n, d, h, wd, cin = x.shape
    cout = w.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    taps = torch.cat([xp[:, dz:dz + d, dy:dy + h, dx:dx + wd, :]
                      for dz in range(3) for dy in range(3) for dx in range(3)], dim=-1)
    wk = F.pad(w.float().reshape(27 * cin, cout), (0, -cout % 32))
    out = torch.cat([taps @ wk[:, c:c + 32] for c in range(0, wk.shape[1], 32)], dim=-1)
    return out[..., :cout].to(x.dtype)


@pytest.mark.parametrize("shape,cout", [((2, 5, 7, 9, 16), 8), ((1, 3, 9, 17, 48), 40),
                                        ((2, 3, 5, 6, 28), 36), ((1, 4, 6, 5, 36), 28)])
def test_packed_arithmetic_matches_plain_forward_and_dx(shape, cout):
    g = torch.Generator().manual_seed(3)
    cin = shape[-1]
    x = torch.randn(shape, generator=g)
    w = _weights(cin, cout, seed=4)
    ref = conv3d_plain(x, w)
    got = _conv_from_packed(x, pack_weights(w), cout)
    assert (got - ref).abs().max().item() <= 1e-5  # float32 sums in another order, |y| ~ 1
    gy = torch.randn(shape[:4] + (cout,), generator=g)
    ref_dx = conv3d_plain(gy, w.flip(0, 1, 2).transpose(3, 4).contiguous())
    got_dx = _conv_from_packed(gy, pack_weights_dx(w), cin)
    assert (got_dx - ref_dx).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape,cout", [((2, 5, 7, 9, 1), 28), ((1, 4, 6, 35, 1), 36),
                                        ((1, 3, 9, 10, 3), 28)])
def test_stem_chunk_arithmetic_matches_plain(shape, cout):
    """The stem kernel's operands: the 27 * Cin taps and zero-padded
    32-channel weight chunks (1 -> 28: one chunk, 1 -> 36: two)."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(shape, generator=g)
    w = _weights(shape[-1], cout, seed=9)
    assert conv3d_route(torch.bfloat16, shape[-1], cout) == "stem"
    got = _stem_from_chunks(x, w)
    assert (got - conv3d_plain(x, w)).abs().max().item() <= 1e-5


def test_conv3d_dx_is_the_input_gradient():
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 4, 6, 5, 16), generator=g, requires_grad=True)
    w = _weights(16, 8, seed=6)
    gy = torch.randn((2, 4, 6, 5, 8), generator=g)
    (want,) = torch.autograd.grad(conv3d_plain(x, w), x, gy)
    assert (conv3d_dx(gy, w) - want).abs().max().item() <= 1e-5
    # and the differentiable entry point hands out the same through its backward
    x2 = x.detach().clone().requires_grad_(True)
    (got,) = torch.autograd.grad(conv3d(x2, w), x2, gy)
    assert torch.equal(got, conv3d_dx(gy, w))


def test_cpu_conv_counts_no_route():
    build.reset_launches()
    x = torch.randn(1, 3, 4, 5, 16).to(torch.bfloat16)
    w = _weights(16, 8, dtype=torch.bfloat16)
    conv3d(x, w)
    conv3d_dx(torch.randn(1, 3, 4, 5, 8).to(torch.bfloat16), w)
    assert build.CONV3D_ROUTES == {"wgmma": 0, "stem": 0, "tf32x3": 0}
    assert build.LAUNCHES["conv3d"] == 0
    build.CONV3D_ROUTES["wgmma"] = 3
    build.CONV3D_ROUTES["stem"] = 2
    build.reset_launches()
    assert build.CONV3D_ROUTES == {"wgmma": 0, "stem": 0, "tf32x3": 0}


def _tf32_bits_zero(t):
    return not (t.view(torch.int32) & 0x1FFF).any()


def test_tf32_split_rounds_as_cvt_rna_and_keeps_float32_accuracy():
    """hi is a TF32 value (its low 13 mantissa bits zero), rounded to
    nearest with ties away from zero, as ``cvt.rna.tf32.f32``; lo is the
    rest rounded the same way; ``|hi + lo - a| <= 2^-22 |a|``."""
    g = torch.Generator().manual_seed(13)
    a = torch.cat([torch.randn(100_000, generator=g) * 10.0 ** torch.randint(-30, 30, (100_000,), generator=g),
                   torch.tensor([0.0, -0.0, 1.0, -1.0, 3.0e38, 1e-40, -1e-40])])
    hi, lo = tf32_split(a)
    assert _tf32_bits_zero(hi) and _tf32_bits_zero(lo)
    assert hi.dtype == lo.dtype == torch.float32
    assert torch.equal((a - hi).double(), a.double() - hi.double())  # a - hi exact in float32
    # hi is the nearest TF32 value: no farther than half of its unit (for
    # a and its rest away from float32's subnormals, whose unit is fixed)
    normal = a.abs() >= 2.0 ** -100
    a64, hi64, lo64 = a[normal].double(), hi[normal].double(), lo[normal].double()
    unit = torch.ldexp(torch.ones_like(a64), torch.frexp(a64)[1] - 11)
    assert ((a64 - hi64).abs() <= unit / 2).all()
    assert ((hi64 + lo64 - a64).abs() <= 2.0 ** -22 * a64.abs()).all()
    # ties: 1 + 2^-11 (exactly half a TF32 unit above 1) goes up, away from
    # zero, as does its negative; one bit below the tie goes down
    bits = torch.tensor([0x3F801000, -0x407FF000, 0x3F800FFF, 0x3F803000], dtype=torch.int32)
    want = torch.tensor([0x3F802000, -0x407FE000, 0x3F800000, 0x3F804000], dtype=torch.int32)
    assert torch.equal(tf32_round(bits.view(torch.float32)).view(torch.int32), want)
    nan = tf32_round(torch.tensor([float("nan"), float("inf"), -float("inf")]))
    assert nan[0].isnan() and nan[1] == float("inf") and nan[2] == -float("inf")


@pytest.mark.parametrize("shape,cout", [((2, 3, 5, 6, 28), 36), ((1, 4, 6, 5, 36), 28)])
def test_tf32x3_terms_from_split_packs_match_plain_forward_and_dx(shape, cout):
    """The 3xTF32 kernel's arithmetic: the packs and x split into TF32
    pairs, the three terms x_lo w_hi + x_hi w_lo + x_hi w_hi summed in
    float64, equal ``conv3d_plain`` within 1e-6 of scale, forward and dx;
    the x_hi w_hi term alone (one TF32 pass) lies at least 100x farther."""
    g = torch.Generator().manual_seed(14)
    cin = shape[-1]
    x = torch.randn(shape, generator=g)
    w = _weights(cin, cout, seed=15)
    gy = torch.randn(shape[:4] + (cout,), generator=g)
    for inp, packed, n_out, ref in (
            (x, pack_weights(w), cout, conv3d_plain(x, w)),
            (gy, pack_weights_dx(w), cin,
             conv3d_plain(gy, w.flip(0, 1, 2).transpose(3, 4).contiguous()))):
        (xh, xl), (wh, wl) = split_x(inp), tf32_split(packed)

        def term(a, b):
            return _conv_from_packed(a.double(), b, n_out, torch.float64)
        three = term(xl, wh) + term(xh, wl) + term(xh, wh)
        scale = ref.abs().max().item()
        err3 = (three - ref.double()).abs().max().item()
        err1 = (term(xh, wh) - ref.double()).abs().max().item()
        assert err3 <= 1e-6 * scale, err3
        assert err1 >= 100 * err3, (err1, err3)


def test_sr_conv_rows_are_the_super_resolution_templates(tmp_path, monkeypatch):
    """``chip_smoke.py``'s float32 rows of the 3D super-resolution template
    (which trains and predicts in float32) are the 3x3x3 convs its model
    runs at the template's patch (recorded at batch 1; the rows take its
    batch, 4)."""
    import yaml

    import biapy_tpu_torch
    from biapy_tpu_torch.ops.kernels import conv3d as kconv

    repo = Path(__file__).resolve().parents[1]
    with open(repo / "templates/super-resolution/3d_super-resolution.yaml") as f:
        raw = yaml.safe_load(f)
    job = biapy_tpu_torch.BiaPy(raw, result_dir=str(tmp_path), name="t", silent=True,
                                check_data_paths=False, device="cpu")
    job._build_workflow()
    wf = job.workflow
    wf.prepare_model()
    seen = []

    def record(x, w):
        seen.append(((int(wf.cfg.TRAIN.BATCH_SIZE),) + tuple(x.shape[1:4]), x.shape[4],
                     w.shape[4]))
        return x.new_zeros(x.shape[:4] + (w.shape[4],))
    monkeypatch.setattr(kconv, "conv3d_fwd", record)
    d, h, w = (int(v) for v in wf.cfg.DATA.PATCH_SIZE[:3])
    with torch.no_grad():
        wf.model(torch.zeros((1, d, h, w, 1)))
    fwd, dx = chip_smoke._sr_conv_rows()
    assert seen == fwd and dx == [(v, cout, cin) for v, cin, cout in fwd[1:]]
    assert not wf.cfg.TEST.REDUCE_MEMORY  # the test pass runs in float32
    assert [conv3d_route(torch.float32, cin, cout) for _, cin, cout in fwd + dx] == (
        ["stem"] + ["tf32x3"] * 18)
