"""The port's conv3d routing rule and weight packs, on the CPU.

``conv3d_route`` decides from (dtype, Cin, Cout) alone which CUDA kernel a
launch takes; ``pack_weights`` / ``pack_weights_dx`` build the K-major
``(27, Cout, Cin)`` operand of the tensor-core kernel. The kernel itself
runs only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``);
here its operands are held against their definitions, and the packed
arithmetic (27 shifted ``x @ pack[t].T`` products) against ``conv3d_plain``
and against autograd's input gradient.
"""

import sys
from collections import Counter
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from biapy_tpu_torch.ops.kernels import build
from biapy_tpu_torch.ops.kernels.conv3d import (conv3d, conv3d_dx, conv3d_plain, conv3d_route,
                                                pack_weights, pack_weights_dx)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (imports nothing but the standard library at import)

torch.set_num_threads(2)


@pytest.mark.parametrize("size,cin,cout", chip_smoke.MAIN_CONVS)
def test_route_of_main_path_forward_shapes(size, cin, cout):
    want = "fma" if cin == 1 else "wgmma"  # only the 1-channel stem stays on the CUDA cores
    assert conv3d_route(torch.bfloat16, cin, cout) == want
    assert conv3d_route(torch.float32, cin, cout) == "fma"


@pytest.mark.parametrize("size,cin,cout", chip_smoke.DX_CONVS)
def test_route_of_main_path_dx_shapes(size, cin, cout):
    assert conv3d_route(torch.bfloat16, cin, cout) == "wgmma"
    assert conv3d_route(torch.float32, cin, cout) == "fma"


@pytest.mark.parametrize("dtype,cin,cout,want", [
    (torch.bfloat16, 16, 8, "wgmma"),     # the narrowest widths the rule takes
    (torch.bfloat16, 48, 40, "wgmma"),    # a channel tail, a tile wider than Cout
    (torch.bfloat16, 80, 264, "wgmma"),   # a loop over output tiles
    (torch.bfloat16, 24, 40, "fma"),      # Cin % 16 != 0
    (torch.bfloat16, 8, 8, "fma"),
    (torch.bfloat16, 32, 12, "fma"),      # Cout % 8 != 0
    (torch.bfloat16, 32, 1, "fma"),
    (torch.bfloat16, 1, 32, "fma"),
    (torch.float32, 64, 64, "fma"),       # float32 stays full float32
    (torch.float16, 32, 32, "fma"),       # (and is refused there: no half kernel)
    (torch.float64, 32, 32, "fma"),
])
def test_route_rule(dtype, cin, cout, want):
    assert conv3d_route(dtype, cin, cout) == want


def test_route_counts_of_the_smoke_run_follow_from_the_rule():
    def count(shapes):
        return dict(Counter(conv3d_route(torch.bfloat16, cin, cout) for _, cin, cout in shapes))

    assert count(chip_smoke.MAIN_CONVS) == chip_smoke.SERVE_ROUTES
    assert count(chip_smoke.MAIN_CONVS + chip_smoke.DX_CONVS) == chip_smoke.TRAIN_ROUTES
    # with LARGER_IO the stem is a 5x5x5 conv, the first 3x3x3 conv has
    # Cin = 32 and gets an input gradient as well
    larger_io = [(128, 32, 32)] + chip_smoke.MAIN_CONVS[1:]
    both = larger_io + [(s, cout, cin) for s, cin, cout in larger_io]
    got = count(both)
    assert {"wgmma": got.get("wgmma", 0), "fma": got.get("fma", 0)} == chip_smoke.LARGER_IO_ROUTES
    for routes, launches in ((chip_smoke.TRAIN_ROUTES, chip_smoke.TRAIN_LAUNCHES),
                             (chip_smoke.LARGER_IO_ROUTES, chip_smoke.LARGER_IO_LAUNCHES)):
        assert sum(routes.values()) == launches["conv3d"]
    assert set(build.CONV3D_ROUTES) == {"wgmma", "fma"}
    # the odd shapes of the smoke run: the first on the CUDA cores, the rest not
    odd = [conv3d_route(torch.bfloat16, cin, cout) for _, cin, cout in chip_smoke.ODD_CONVS]
    assert odd == ["fma"] + ["wgmma"] * (len(odd) - 1)


def _weights(cin, cout, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((3, 3, 3, cin, cout), generator=g) / (27 * cin) ** 0.5).to(dtype)


@pytest.mark.parametrize("cin,cout", [(16, 8), (48, 40), (32, 32), (3, 5)])
def test_pack_weights_matches_its_definition(cin, cout):
    w = _weights(cin, cout)
    p = pack_weights(w)
    assert p.shape == (27, cout, cin) and p.is_contiguous()
    flat = w.reshape(27, cin, cout)
    for t, co, ci in ((0, 0, 0), (13, cout - 1, 0), (26, 1, cin - 1), (5, cout // 2, cin // 2)):
        assert p[t, co, ci] == flat[t, ci, co]
    assert torch.equal(p, flat.permute(0, 2, 1))


@pytest.mark.parametrize("cin,cout", [(16, 8), (48, 40), (32, 96), (3, 5)])
def test_dx_pack_is_a_flip_and_no_transpose(cin, cout):
    w = _weights(cin, cout, seed=1)
    wdx = w.flip(0, 1, 2).transpose(3, 4)  # the dx conv's DHWIO weights: (3,3,3,Cout,Cin)
    p = pack_weights_dx(w)
    assert p.shape == (27, cin, cout) and p.is_contiguous()
    assert torch.equal(pack_weights(wdx), w.flip(0, 1, 2).reshape(27, cin, cout))
    assert torch.equal(p, pack_weights(wdx))


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


def _conv_from_packed(x, packed):
    """What the tensor-core kernel computes from its operands: for tap
    t = (dz, dy, dx) the shifted x times ``packed[t].T``, summed in float32."""
    n, d, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros((n, d, h, wd, packed.shape[1]))
    for t in range(27):
        dz, dy, dx = t // 9, (t // 3) % 3, t % 3
        acc += xp[:, dz:dz + d, dy:dy + h, dx:dx + wd, :] @ packed[t].float().T
    return acc.to(x.dtype)


@pytest.mark.parametrize("shape,cout", [((2, 5, 7, 9, 16), 8), ((1, 3, 9, 17, 48), 40)])
def test_packed_arithmetic_matches_plain_forward_and_dx(shape, cout):
    g = torch.Generator().manual_seed(3)
    cin = shape[-1]
    x = torch.randn(shape, generator=g)
    w = _weights(cin, cout, seed=4)
    ref = conv3d_plain(x, w)
    got = _conv_from_packed(x, pack_weights(w))
    assert (got - ref).abs().max().item() <= 1e-5  # float32 sums in another order, |y| ~ 1
    gy = torch.randn(shape[:4] + (cout,), generator=g)
    ref_dx = conv3d_plain(gy, w.flip(0, 1, 2).transpose(3, 4).contiguous())
    got_dx = _conv_from_packed(gy, pack_weights_dx(w))
    assert (got_dx - ref_dx).abs().max().item() <= 1e-5


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
    assert build.CONV3D_ROUTES == {"wgmma": 0, "fma": 0}
    assert build.LAUNCHES["conv3d"] == 0
    build.CONV3D_ROUTES["wgmma"] = 3
    build.reset_launches()
    assert build.CONV3D_ROUTES == {"wgmma": 0, "fma": 0}
