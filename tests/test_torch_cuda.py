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
from biapy_tpu_torch.ops.kernels.conv3d import conv3d, conv3d_plain
from biapy_tpu_torch.ops.kernels.shuffle import (pool_max_folded, pool_max_folded_bwd,
                                                 pool_max_folded_bwd_plain,
                                                 pool_max_folded_plain, zcat, zcat_bwd,
                                                 zcat_bwd_plain, zcat_plain, zd2s, zd2s_plain,
                                                 zs2d, zs2d_plain)

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
    assert build.LAUNCHES == {"conv3d": 1, "pool_max_folded": 1, "pool_max_folded_bwd": 0,
                              "zd2s": 1, "zs2d": 0, "zcat": 0, "zcat_bwd": 0}
    with pytest.raises(TypeError):
        conv3d(x.half(), w.half())
    with pytest.raises(ValueError):
        conv3d(x.transpose(1, 2), w)
    with pytest.raises(ValueError):
        conv3d(x, w[..., :4, :])


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
    # conv3d: forward + dx; zcat: the conv's dw operand + zcat's own forward
    assert build.LAUNCHES == {"conv3d": 2, "pool_max_folded": 1, "pool_max_folded_bwd": 1,
                              "zd2s": 1, "zs2d": 1, "zcat": 2, "zcat_bwd": 1}
