"""The port's CUDA kernels against their plain versions, on the card.

Each test skips without a CUDA device (decided inside the test, never at
import). On the card, where JAX is not installed (``tests/conftest.py``
imports it, hence ``--noconftest``):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

This file imports no JAX.
"""

import pytest
import torch

from biapy_tpu_torch.ops.kernels import build
from biapy_tpu_torch.ops.kernels.conv3d import (conv3d, conv3d_dx, conv3d_fwd, conv3d_plain,
                                                conv3d_route, pad_channels, split_x, tf32_split)
from biapy_tpu_torch.ops.kernels.shuffle import (_launch_pool_bwd, pool_max_folded,
                                                 pool_max_folded_bwd,
                                                 pool_max_folded_bwd_plain, pool_max_folded_fwd,
                                                 pool_max_folded_plain, pool_route, zcat,
                                                 zcat_bwd, zcat_bwd_plain, zcat_fwd, zcat_plain,
                                                 zcat_route, zd2s, zd2s_plain, zs2d, zs2d_plain)

torch.set_num_threads(2)


def test_cuda_kernels_match_plain_on_the_card():
    """Each kernel against its plain version at small odd shapes, in
    float32 and bfloat16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    g = torch.Generator(device="cpu").manual_seed(0)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for shape, cout in (((1, 5, 7, 9, 1), 4), ((2, 3, 6, 5, 8), 40), ((1, 4, 5, 3, 24), 12)):
            x = torch.randn(shape, generator=g).to(dev, dt)
            w = (torch.randn((3, 3, 3, shape[-1], cout), generator=g) * 0.1).to(dev, dt)
            got = conv3d(x, w).float()
            ref = conv3d_plain(x, w).float()
            assert (got - ref).abs().max().item() <= tol * max(1.0, ref.abs().max().item())
        # c = 5 takes the one-element path, c = 16 the 16-byte vector path
        for shape, win in (((6, 4, 6, 5), (3, 2, 1)), ((4, 6, 4, 16), (2, 2, 2))):
            x = torch.randn(shape, generator=g).to(dev, dt)
            x.view(-1)[7] = float("nan")  # NaN propagates as in jnp.max
            got, ref = pool_max_folded(x, win), pool_max_folded_plain(x, win)
            assert torch.equal(got.isnan(), ref.isnan())
            assert torch.equal(got.nan_to_num(), ref.nan_to_num())
        x = torch.randn((2, 3, 4, 9), generator=g).to(dev, dt)
        assert torch.equal(zd2s(x, 3), zd2s_plain(x, 3))
    torch.cuda.synchronize()


def test_cuda_wrappers_count_launches_and_raise_on_bad_input():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    build.reset_launches()
    x = torch.randn(1, 4, 4, 4, 8, device=dev)
    w = torch.randn(3, 3, 3, 8, 8, device=dev)
    conv3d(x, w)
    pool_max_folded(x.view(4, 4, 4, 8), (2, 2, 2))
    zd2s(x.view(4, 4, 4, 8), 2)
    # float32: the conv's x split into its TF32 pair first
    assert build.LAUNCHES == {"conv3d": 1, "pad_channels": 0, "tf32_split": 1, "pool_max_folded": 1,
                              "pool_max_folded_bwd": 0, "zd2s": 1, "zs2d": 0, "zcat": 0,
                              "zcat_bwd": 0}
    with pytest.raises(TypeError):
        conv3d(x.half(), w.half())
    with pytest.raises(ValueError):
        conv3d(x.transpose(1, 2), w)
    with pytest.raises(ValueError):
        conv3d(x, w[..., :4, :])


@pytest.mark.parametrize("channels", [28, 36])
def test_pool_at_a_window_of_1_2_2_matches_plain_on_the_card(channels):
    """The pool and its backward at the (1, 2, 2) windows of
    ``MODEL.Z_DOWN: [1, 1, 1, 1]`` (the 3D semantic-segmentation template)
    with its odd widths, odd row counts and h, w of odd halves, ties, a NaN
    and a -0, in float32 and bfloat16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    g = torch.Generator(device="cpu").manual_seed(channels)
    win = (1, 2, 2)
    for dt in (torch.float32, torch.bfloat16):
        for shape in ((5, 8, 6, channels), (3, 10, 14, channels)):
            x = torch.randint(-2, 3, shape, generator=g).to(dev, dt) * 0.5  # ties
            x.view(-1)[7] = float("nan")
            x.view(-1)[11] = -0.0
            y, ref = pool_max_folded(x, win), pool_max_folded_plain(x, win)
            assert torch.equal(y.isnan(), ref.isnan())
            assert torch.equal(y.nan_to_num(), ref.nan_to_num())
            gy = torch.randn(ref.shape, generator=g).to(dev, dt)
            assert torch.equal(pool_max_folded_bwd(x, ref, gy, win),
                               pool_max_folded_bwd_plain(x, ref, gy, win))
    torch.cuda.synchronize()


# c * itemsize of the route tests: 2 (the stem's c = 1 in bf16), 4, 8, the
# template's 56 and 72 (28 and 36 bf16 channels), 64 and 256 bytes
_CHANNEL_BYTES = (2, 4, 8, 56, 72, 64, 256)


def _at_element_offset(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose ``data_ptr`` lies one element past
    the allocator's 16-byte grid."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    out.copy_(t)
    return out


def _equal_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal but for the sign of a zero, NaN where the other has NaN."""
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(), b.nan_to_num()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_routes_match_plain_on_the_card(dtype):
    """The pool forward on every route at every channel width of
    ``_CHANNEL_BYTES``, windows 2x2x2, 1x2x2, 3x2x1 and 1x2x2 on 11 pooled
    columns, ties, a NaN and a -0, at the allocator's alignment and one
    element off it; rows wide enough to be cut into column chunks; each
    launch on the route ``pool_route`` names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    dt = getattr(torch, dtype)
    item = torch.empty((), dtype=dt).element_size()
    g = torch.Generator(device="cpu").manual_seed(6)
    cases = [((4, 6, 8), (2, 2, 2)), ((3, 8, 10), (1, 2, 2)), ((6, 4, 6), (3, 2, 1)),
             ((2, 6, 22), (1, 2, 2))]
    shapes = [(rhw + (nbytes // item,), win) for nbytes in _CHANNEL_BYTES if nbytes % item == 0
              for rhw, win in cases]
    # rows of more than the 24 KB a block stages: two column chunks
    shapes += [((2, 2, 472, 56 // item), (1, 2, 2)), ((4, 2, 512, 72 // item), (2, 2, 2))]
    seen = set()
    for shape, win in shapes:
        x = torch.randint(-2, 3, shape, generator=g).to(dev, dt) * 0.5  # ties
        x.view(-1)[7] = float("nan")
        x.view(-1)[11] = -0.0
        ref = pool_max_folded_plain(x, win)
        for xin in (x, _at_element_offset(x)):
            build.reset_launches()
            y = pool_max_folded_fwd(xin, win)
            route = pool_route(shape, item, win, xin.data_ptr(), y.data_ptr())
            seen.add(route)
            assert build.SHUFFLE_ROUTES["pool_max_folded"] == {
                k: int(route == k) for k in ("channels16", "rows16", "scalar")}
            assert _equal_nan(y, ref), (shape, win, route)
    assert seen == {"channels16", "rows16", "scalar"}
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_bwd_routes_match_plain_on_the_card(dtype):
    """The pool backward on every route at every channel width of
    ``_CHANNEL_BYTES``, windows 2x2x2, 1x2x2, 3x2x1 and 1x2x2 on 11 pooled
    columns, ties, a NaN and a -0; rows of 472 and 512 positions (which the
    forward cuts into column chunks); x, y, g and dx each at the allocator's
    alignment and one element off it; each launch on the route
    ``pool_route`` names, bit-equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    dt = getattr(torch, dtype)
    item = torch.empty((), dtype=dt).element_size()
    gen = torch.Generator(device="cpu").manual_seed(8)
    cases = [((4, 6, 8), (2, 2, 2)), ((3, 8, 10), (1, 2, 2)), ((6, 4, 6), (3, 2, 1)),
             ((2, 6, 22), (1, 2, 2))]
    shapes = [(rhw + (nbytes // item,), win) for nbytes in _CHANNEL_BYTES if nbytes % item == 0
              for rhw, win in cases]
    shapes += [((2, 2, 472, 56 // item), (1, 2, 2)), ((4, 2, 512, 72 // item), (2, 2, 2))]
    seen = set()
    for shape, win in shapes:
        x = torch.randint(-2, 3, shape, generator=gen).to(dev, dt) * 0.5  # ties
        x.view(-1)[7] = float("nan")
        x.view(-1)[11] = -0.0
        y = pool_max_folded_plain(x, win)
        g = torch.randn(y.shape, generator=gen).to(dev, dt)
        ref = pool_max_folded_bwd_plain(x, y, g, win)
        # every operand aligned, then each in turn one element off the grid
        for off in (None, 0, 1, 2, 3):
            ops = [_at_element_offset(t) if i == off else t
                   for i, t in enumerate((x, y, g, torch.empty_like(x)))]
            build.reset_launches()
            _launch_pool_bwd(*ops, win)
            route = pool_route(shape, item, win, *(t.data_ptr() for t in ops))
            seen.add(route)
            assert build.SHUFFLE_ROUTES["pool_max_folded_bwd"] == {
                k: int(route == k) for k in ("channels16", "rows16", "scalar")}
            assert torch.equal(ops[3], ref), (shape, win, off, route)
    assert seen == {"channels16", "rows16", "scalar"}
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8", "float64"])
def test_zcat_routes_match_plain_on_the_card(dtype):
    """zcat on every route at every channel width of ``_CHANNEL_BYTES`` (for
    the raw 1- and 8-byte dtypes: c = 1, 3, 9 and 16 bytes), two to four
    images with kz 3 and 5 (images of 1 and 2 planes among them), planes of
    35, 64 and 320 positions, at the allocator's alignment and one element
    off it, bit-equal to the plain version; each launch on the route
    ``zcat_route`` names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    dt = getattr(torch, dtype)
    item = torch.empty((), dtype=dt).element_size()
    g = torch.Generator(device="cpu").manual_seed(7)
    widths = ([n // item for n in _CHANNEL_BYTES if n % item == 0] if item in (2, 4)
              else [1, 3, 9, 16 // item])
    seen = set()
    for c in widths:
        for rows, depth, kz in ((8, 4, 3), (9, 3, 5), (12, 4, 5), (30, 10, 3), (4, 1, 3),
                                (6, 2, 5)):
            for hw in ((5, 7), (8, 8), (16, 20)):
                shape = (rows,) + hw + (c,)
                x = (torch.randn(shape, generator=g) * 50).to(dev, dt)
                ref = zcat_plain(x, kz, depth)
                for xin in (x, _at_element_offset(x)):
                    build.reset_launches()
                    out = zcat_fwd(xin, kz, depth)
                    route = zcat_route(shape, item, xin.data_ptr(), out.data_ptr())
                    seen.add(route)
                    assert build.SHUFFLE_ROUTES["zcat"] == {
                        k: int(route == k) for k in ("channels16", "rows16", "scalar")}
                    assert torch.equal(out, ref), (shape, kz, depth, route)
    assert seen == {"channels16", "rows16", "scalar"}
    torch.cuda.synchronize()


def test_cuda_backward_kernels_match_plain_on_the_card():
    """pool backward, zs2d, zcat and zcat backward against their plain
    versions at small odd shapes (ragged h and w, c = 1, kz = 5, two images,
    tied windows with a NaN and a -0), in float32 and bfloat16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    g = torch.Generator(device="cpu").manual_seed(1)
    for dt in (torch.float32, torch.bfloat16):
        for shape, win in (((6, 4, 6, 5), (3, 2, 1)), ((4, 6, 4, 16), (2, 2, 2))):
            x = torch.randint(-1, 2, shape, generator=g).to(dev, dt) * 0.5  # ties everywhere
            x.view(-1)[7] = float("nan")
            x.view(-1)[11] = -0.0
            y = pool_max_folded_plain(x, win)
            gy = torch.randn(y.shape, generator=g).to(dev, dt)
            assert torch.equal(pool_max_folded_bwd(x, y, gy, win),
                               pool_max_folded_bwd_plain(x, y, gy, win))
        for shape, sz in (((6, 3, 5, 3), 3), ((4, 2, 2, 8), 2)):
            gy = torch.randn(shape, generator=g).to(dev, dt)
            assert torch.equal(zs2d(gy, sz), zs2d_plain(gy, sz))
            assert torch.equal(zd2s(zs2d(gy, sz), sz), gy)
        for shape, kz, depth in (((6, 3, 5, 1), 3, None), ((6, 3, 5, 3), 5, 3),
                                 ((4, 2, 2, 8), 3, 2)):
            x = torch.randn(shape, generator=g).to(dev, dt)
            assert torch.equal(zcat(x, kz, depth), zcat_plain(x, kz, depth))
            gy = torch.randn(shape[:3] + (kz * shape[3],), generator=g).to(dev, dt)
            got, ref = zcat_bwd(gy, kz, depth).float(), zcat_bwd_plain(gy, kz, depth).float()
            # float32 sums of up to kz terms in tap order on both sides
            assert (got - ref).abs().max().item() <= (1e-6 if dt == torch.float32 else 2 ** -7)
    torch.cuda.synchronize()


def test_cuda_functions_backward_match_plain_on_the_card():
    """Autograd through the Functions on the card (kernels both ways)
    against the same Functions on the CPU (plain both ways)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")

    def both(fn, *shapes):
        outs = []
        for d in ("cpu", dev):
            gen = torch.Generator(device="cpu").manual_seed(3)
            args = [torch.randn(s, generator=gen).to(d).requires_grad_(True) for s in shapes]
            y = fn(*args)
            gy = torch.randn(y.shape, generator=gen).to(d)
            outs.append([y] + list(torch.autograd.grad(y, args, gy)))
        for a, b in zip(*outs):
            scale = max(1.0, a.abs().max().item())
            assert (a - b.cpu()).abs().max().item() <= 1e-4 * scale

    build.reset_launches()
    both(conv3d, (2, 3, 6, 5, 8), (3, 3, 3, 8, 40))
    both(lambda x: pool_max_folded(x, (2, 2, 1)), (4, 6, 3, 5))
    both(lambda x: zd2s(x, 2), (3, 4, 5, 6))
    both(lambda x: zcat(x, 5, 3), (6, 3, 5, 2))
    # conv3d: forward + dx, each splitting its float32 input; zcat: the conv's
    # dw operand + zcat's own forward
    assert build.LAUNCHES == {"conv3d": 2, "pad_channels": 0, "tf32_split": 2,
                              "pool_max_folded": 1,
                              "pool_max_folded_bwd": 1, "zd2s": 1, "zs2d": 1, "zcat": 2,
                              "zcat_bwd": 1}


def test_cuda_conv3d_tensor_core_route_matches_plain_on_the_card():
    """The tensor-core conv at small odd shapes in bf16: bricks that overhang
    the volume, two images, a channel tail (Cin 16, 48, and 272 for dx), an
    output tile wider than Cout (8, 40), a loop over output tiles (264,
    272) and a ragged volume with bricks enough for the taller 16 x 16
    brick; forward, and dx through ``Conv3dK3``; the route counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    g = torch.Generator(device="cpu").manual_seed(4)
    dt = torch.bfloat16
    build.reset_launches()
    want = {"wgmma": 0, "stem": 0, "tf32x3": 0}
    for shape, cout in (((2, 5, 7, 9, 16), 8), ((2, 3, 19, 35, 48), 40), ((1, 4, 9, 17, 64), 264),
                        ((2, 13, 7, 9, 48), 32), ((1, 3, 10, 20, 64), 272),
                        ((2, 24, 30, 35, 16), 8), ((2, 24, 30, 35, 48), 32)):
        cin = shape[-1]
        x = torch.randn(shape, generator=g).to(dev, dt).requires_grad_(True)
        w = (torch.randn((3, 3, 3, cin, cout), generator=g) / (27 * cin) ** 0.5).to(dev, dt)
        gy = torch.randn(shape[:4] + (cout,), generator=g).to(dev, dt)
        assert conv3d_route(dt, cin, cout) == "wgmma"
        y = conv3d(x, w)
        (dx,) = torch.autograd.grad(y, x, gy)
        want["wgmma"] += 1
        want[conv3d_route(dt, cout, cin)] += 1
        # both sides sum bf16 products in float32 and round once: one bf16
        # ulp of the output's scale
        for got, ref in ((y, conv3d_plain(x.detach(), w)),
                         (dx, conv3d_plain(gy, w.flip(0, 1, 2).transpose(3, 4).contiguous()))):
            assert got.dtype == dt and got.shape == ref.shape
            err = (got.float() - ref.float()).abs().max().item()
            assert err <= 1e-2 * max(1.0, ref.float().abs().max().item())
    torch.cuda.synchronize()
    assert want["wgmma"] == 14  # every dx takes the tensor cores too, at any width
    assert build.CONV3D_ROUTES == want
    assert build.LAUNCHES["conv3d"] == sum(want.values())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_conv3d_odd_widths_on_every_route_match_plain_on_the_card(dtype):
    """Forward and dx against ``conv3d_plain`` at widths off the 8 grid: Cin
    28 and 36 (a channel-padded x; 36 with a 16-channel tail step), 84, the
    stems at Cin 1 and 3, Cout 28, 36, 12 and 1 (tiles wider than Cout, 8-
    and 2-byte stores), ragged volumes (one with bricks enough for the
    16 x 16 brick) and two images; each launch on the route the rule
    names (bf16: tensor cores or stem; float32: 3xTF32 or stem)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    g = torch.Generator(device="cpu").manual_seed(11)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4  # one bf16 ulp; float32 sum orders
    build.reset_launches()
    want = {"wgmma": 0, "stem": 0, "tf32x3": 0}
    pads = 0
    for shape, cout in (((2, 5, 7, 9, 28), 36), ((2, 3, 11, 6, 36), 28), ((1, 4, 9, 17, 84), 12),
                        ((2, 24, 30, 35, 28), 28), ((2, 24, 30, 35, 36), 36),
                        ((2, 5, 7, 9, 28), 1), ((2, 5, 9, 33, 1), 28), ((1, 3, 5, 6, 1), 1),
                        ((2, 4, 11, 13, 3), 36), ((1, 6, 7, 40, 3), 12)):
        cin = shape[-1]
        x = torch.randn(shape, generator=g).to(dev, dtype)
        w = (torch.randn((3, 3, 3, cin, cout), generator=g) / (27 * cin) ** 0.5).to(dev, dtype)
        gy = torch.randn(shape[:4] + (cout,), generator=g).to(dev, dtype)
        y, dx = conv3d_fwd(x, w), conv3d_dx(gy, w)
        for a, b in ((cin, cout), (cout, cin)):
            want[conv3d_route(dtype, a, b)] += 1
            pads += conv3d_route(dtype, a, b) == "wgmma" and a % 8 != 0
        for got, ref in ((y, conv3d_plain(x, w)),
                         (dx, conv3d_plain(gy, w.flip(0, 1, 2).transpose(3, 4).contiguous()))):
            assert got.dtype == dtype and got.shape == ref.shape
            err = (got.float() - ref.float()).abs().max().item()
            assert err <= tol * max(1.0, ref.float().abs().max().item()), (shape, cout, err)
    torch.cuda.synchronize()
    # the dx of a conv to one channel is a stem too
    assert want["stem"] == 6 and want["tf32x3" if dtype == torch.float32 else "wgmma"] == 14
    assert build.CONV3D_ROUTES == want
    # each tensor-core launch whose x has channels off the 8 grid pads them;
    # each 3xTF32 launch splits its x
    assert pads == (14 if dtype == torch.bfloat16 else 0)
    assert build.LAUNCHES["tf32_split"] == want["tf32x3"]
    assert build.LAUNCHES["pad_channels"] == pads


def test_cuda_pad_channels_matches_f_pad_with_zero_lanes_on_the_card():
    """The channel pad against ``F.pad``, bit-equal: the pad lanes zero even
    where the output's block held NaN before (a freed block of that size is
    handed back), on the 8-byte and the one-element path (an x whose start
    is 2-byte aligned only); one launch a padded x, none for an x on the 8
    grid; other dtypes on the card are refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.nn.functional as F

    dev = torch.device("cuda:0")
    g = torch.Generator(device="cpu").manual_seed(12)
    build.reset_launches()
    launched = 0
    for shape in ((2, 3, 5, 7, 1), (1, 4, 5, 6, 3), (2, 3, 4, 5, 12), (2, 5, 7, 9, 28),
                  (1, 6, 11, 13, 36), (1, 4, 9, 17, 84), (1, 2, 3, 4, 16)):
        c = shape[-1]
        cp = -(-c // 8) * 8
        for offset in (0, 1):
            flat = torch.randn(torch.Size(shape).numel() + offset, generator=g)
            x = flat.to(dev, torch.bfloat16)[offset:].view(shape)
            assert x.is_contiguous() and (x.data_ptr() % 8 == 0) == (offset == 0)
            poison = torch.full(shape[:4] + (cp,), float("nan"), dtype=x.dtype, device=dev)
            del poison
            got = pad_channels(x)
            assert torch.equal(got, F.pad(x, (0, cp - c)))
            if c % 8 == 0:
                assert got is x
            else:
                launched += 1
            assert build.LAUNCHES["pad_channels"] == launched
    assert launched == 12
    with pytest.raises(TypeError):
        pad_channels(torch.zeros((1, 2, 2, 2, 3), device=dev))


def test_cuda_tf32_split_matches_plain_with_zero_lanes_on_the_card():
    """The 3xTF32 route's split of x against ``tf32_split`` and ``F.pad``,
    bit-equal: the pad lanes of both halves zero even where their blocks
    held NaN before, on the 16-byte and the one-element path (C off the 4
    grid, or an x whose start is not 16-byte aligned); one launch a call;
    other dtypes on the card are refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.nn.functional as F

    dev = torch.device("cuda:0")
    g = torch.Generator(device="cpu").manual_seed(14)
    build.reset_launches()
    launched = 0
    for shape in ((2, 3, 5, 7, 1), (1, 4, 5, 6, 5), (2, 3, 4, 5, 12), (2, 5, 7, 9, 28),
                  (1, 6, 11, 13, 36), (1, 4, 9, 17, 84), (1, 2, 3, 4, 6)):
        c = shape[-1]
        cp = -(-c // 4) * 4
        for offset in (0, 1):
            flat = torch.randn(torch.Size(shape).numel() + offset, generator=g) * 1e3
            x = flat.to(dev)[offset:].view(shape)
            assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == (offset == 0)
            poison = torch.full((2,) + shape[:4] + (cp,), float("nan"), device=dev)
            del poison
            hi, lo = split_x(x)
            launched += 1
            for got, want in zip((hi, lo), tf32_split(x)):
                assert torch.equal(got, F.pad(want, (0, cp - c)))
            assert build.LAUNCHES["tf32_split"] == launched
    with pytest.raises(TypeError):
        split_x(torch.zeros((1, 2, 2, 2, 4), device=dev, dtype=torch.float16))


def test_cuda_conv3d_float32_pad_and_one_channel_on_the_card():
    """The 3xTF32 route where x's channels need a pad (Cin 5: its TF32 pair
    written at 8 channels, an 8-channel tail step alone) and at Cout 1 (a
    tile of 8, one channel written with 4-byte stores), forward and dx,
    against ``conv3d_plain`` at 1e-4 of scale; the routes and the splits
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    g = torch.Generator(device="cpu").manual_seed(13)
    build.reset_launches()
    for shape, cout in (((2, 6, 11, 13, 5), 12), ((2, 5, 7, 9, 28), 1), ((1, 4, 9, 17, 5), 1)):
        cin = shape[-1]
        x = torch.randn(shape, generator=g).to(dev)
        w = (torch.randn((3, 3, 3, cin, cout), generator=g) / (27 * cin) ** 0.5).to(dev)
        gy = torch.randn(shape[:4] + (cout,), generator=g).to(dev)
        assert conv3d_route(torch.float32, cin, cout) == "tf32x3"
        for got, ref in ((conv3d_fwd(x, w), conv3d_plain(x, w)),
                         (conv3d_dx(gy, w),
                          conv3d_plain(gy, w.flip(0, 1, 2).transpose(3, 4).contiguous()))):
            assert got.dtype == torch.float32 and got.shape == ref.shape
            err = (got - ref).abs().max().item()
            assert err <= 1e-4 * max(1.0, ref.abs().max().item()), (shape, cout, err)
    torch.cuda.synchronize()
    # dx: 12 -> 5 on the 3xTF32 kernel, 1 -> 28 and 1 -> 5 on the stem kernel
    assert build.CONV3D_ROUTES == {"wgmma": 0, "stem": 2, "tf32x3": 4}
    assert build.LAUNCHES["tf32_split"] == 4 and build.LAUNCHES["pad_channels"] == 0


def test_cuda_conv3d_routes_are_counted_and_the_forward_and_dx_entries_agree():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    g = torch.Generator(device="cpu").manual_seed(5)
    build.reset_launches()
    xb = torch.randn((1, 4, 8, 16, 32), generator=g).to(dev, torch.bfloat16)
    wb = (torch.randn((3, 3, 3, 32, 16), generator=g) * 0.05).to(dev, torch.bfloat16)
    conv3d_fwd(xb, wb)                  # bf16, 32 -> 16: tensor cores
    conv3d_fwd(xb.float(), wb.float())  # float32: tensor cores, 3xTF32
    conv3d_fwd(xb[..., :1].contiguous(), wb[:, :, :, :1].contiguous())  # Cin = 1: the stem kernel
    assert build.CONV3D_ROUTES == {"wgmma": 1, "stem": 1, "tf32x3": 1}
    # dx through its own entry is the forward entry on the flipped, swapped weights
    gy = torch.randn((1, 4, 8, 16, 16), generator=g).to(dev, torch.bfloat16)
    a = conv3d_dx(gy, wb)
    b = conv3d_fwd(gy, wb.flip(0, 1, 2).transpose(3, 4).contiguous())
    assert torch.equal(a, b)
    assert build.CONV3D_ROUTES == {"wgmma": 3, "stem": 1, "tf32x3": 1}
    assert build.LAUNCHES["conv3d"] == 5


def test_by_chunks_on_a_card_other_than_the_current_one(tmp_path):
    """The by-chunks engine on cuda:1 while cuda:0 is the current device:
    each tile's event is recorded on the workflow's card, so the drain's
    copy waits for the tile, and the Zarr equals ``predict`` in memory
    (overlap 0, whole patch cores, ``div`` normalisation: the tile grid is
    the whole volume's) within 1 uint8 LSB."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import numpy as np

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.data.zarr_store import ZarrArray
    from biapy_tpu_torch.engine.chunked import ChunkedInference

    cfg = {
        "PROBLEM": {"TYPE": "SEMANTIC_SEG", "NDIM": "3D"},
        "MODEL": {"ARCHITECTURE": "resunet", "FEATURE_MAPS": [16, 32], "DROPOUT_VALUES": [0.0, 0.0],
                  "Z_DOWN": [2], "YX_DOWN": [2], "CONV_LAYERS": [2, 2], "NORMALIZATION": "bn",
                  "ACTIVATION": "elu"},
        "DATA": {"PATCH_SIZE": [32, 32, 32, 1], "NORMALIZATION": {"TYPE": "div"},
                 "TEST": {"PADDING": [4, 4, 4], "OVERLAP": [0.0, 0.0, 0.0]}},
        "TRAIN": {"ENABLE": True, "BATCH_SIZE": 1},  # the model's seeded initialisation
        "TEST": {"ENABLE": True, "REDUCE_MEMORY": True, "OUTPUT_QUANT_UINT8": True},
    }
    torch.cuda.set_device(0)
    job = BiaPy(cfg, result_dir=str(tmp_path), name="card1", silent=True, check_data_paths=False,
                device="cuda:1")
    job._build_workflow()
    vol = np.random.default_rng(0).integers(0, 256, (96, 96, 96, 1), dtype=np.uint8)
    z = ZarrArray.create(str(tmp_path / "vol.zarr"), shape=vol.shape, chunks=(48, 48, 48, 1),
                         dtype=vol.dtype, compressor={"id": "zlib", "level": 1})
    z[:, :, :, :] = vol
    wf = job.workflow

    def late(*args, **kwargs):
        # the tile's result lands well after the launch loop moves on: a
        # drain that does not wait for it on the workflow's card reads
        # memory not yet written
        pred = type(wf).predict_block_on_device(wf, *args, **kwargs)
        with torch.cuda.device(pred.device):
            torch.cuda._sleep(50_000_000)
            return pred.clone()

    ci = ChunkedInference(wf, (32, 32, 32), (0.0,) * 3, (4, 4, 4), (2, 2, 2), 1,
                          str(tmp_path / "out"))
    wf.predict_block_on_device = late
    try:
        raw = np.asarray(ZarrArray(ci.predict_volume(str(tmp_path / "vol.zarr"), verbose=False)))
    finally:
        del wf.predict_block_on_device
    assert torch.cuda.current_device() == 0
    assert ci.last_drain_stats["tiles"] == 8
    whole = job.predict(vol)[0]["pred"]  # float32 of the uint8 values
    assert raw.dtype == np.uint8 and raw.shape == whole.shape == (96, 96, 96, 1)
    assert np.abs(raw.astype(np.float64) - whole).max() <= 1
    assert raw.std() > 0


@pytest.mark.parametrize("suppressed", [False, True], ids=["plain", "suppressed"])
def test_follow_flows_on_the_card_equals_the_cpu(suppressed):
    """``ops/flows.py::follow_flows`` on the card gives the CPU's positions
    bit for bit (the same IEEE float64 operations emulate the fused sums on
    both), at small odd shapes in 2D and 3D."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from biapy_tpu_torch.ops.flows import follow_flows

    g = torch.Generator(device="cpu").manual_seed(3)
    for shape in ((13, 11, 2), (5, 9, 7, 3)):
        flows = torch.randn(shape, generator=g)
        cpu = follow_flows(flows, n_iter=25, suppressed=suppressed)
        card = follow_flows(flows.to("cuda:0"), n_iter=25, suppressed=suppressed)
        assert card.device.type == "cuda"
        assert torch.equal(card.cpu(), cpu)


def test_float32_weight_gradient_in_groups_of_planes_on_the_card():
    """conv3d's float32 weight gradient on the card, summed in groups of
    planes (26 planes: a ragged last group), against the float64 one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from biapy_tpu_torch.ops.kernels import conv3d as kconv

    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn((2, 13, 7, 9, 8), generator=g).to("cuda:0")
    gy = torch.randn((2, 13, 7, 9, 12), generator=g).to("cuda:0")
    ref = kconv.conv3d_wgrad(x.double(), gy.double())
    got = kconv.conv3d_wgrad(x, gy)
    assert got.dtype == torch.float32 and got.shape == (3, 3, 3, 8, 12)
    assert (got.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_float32_conv_sums_chunks_apart_on_the_card():
    """The 3xTF32 conv3d in float32 at Cin 112 (K = 3024 products a voxel)
    no farther from float64 than its plain version's tap-by-tap sums, times
    2.5: one chain of K additions lies about an order of magnitude farther,
    and so would the tensor cores' own additions over all of K."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cpu").manual_seed(7)
    x = torch.randn((1, 5, 7, 9, 112), generator=g)
    w = torch.randn((3, 3, 3, 112, 24), generator=g) * 0.05
    ref = torch.nn.functional.conv3d(x.double().movedim(-1, 1),
                                     w.double().permute(4, 3, 0, 1, 2), padding=1).movedim(1, -1)
    plain = conv3d_plain(x, w)
    dev = torch.device("cuda:0")
    assert conv3d_route(torch.float32, 112, 24) == "tf32x3"
    card = conv3d_fwd(x.to(dev), w.to(dev)).cpu()
    err_plain = (plain.double() - ref).abs().max().item()
    err_card = (card.double() - ref).abs().max().item()
    assert err_card <= 2.5 * err_plain, (err_card, err_plain)
