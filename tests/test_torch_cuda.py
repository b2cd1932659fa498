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
from biapy_tpu_torch.ops.kernels.shuffle import (pool_max_folded, pool_max_folded_plain,
                                                 zd2s, zd2s_plain)

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
    assert build.LAUNCHES == {"conv3d": 1, "pool_max_folded": 1, "zd2s": 1}
    with pytest.raises(TypeError):
        conv3d(x.half(), w.half())
    with pytest.raises(ValueError):
        conv3d(x.transpose(1, 2), w)
    with pytest.raises(ValueError):
        conv3d(x, w[..., :4, :])


