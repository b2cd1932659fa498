"""The port's differentiable ops against the JAX package's custom VJPs.

Each ``torch.autograd.Function`` of ``biapy_tpu_torch.ops.kernels`` runs its
plain forward and its plain backward on the CPU. Here forward and VJP are
held against the JAX ops as the JAX package's own tests run them on the
CPU: the Pallas shuffle kernels in interpret mode
(``tests/test_pallas_shuffle.py``), ``ops.pallas.conv3d.conv3d`` through
its XLA route with its own ``_bwd``, and ``ops.conv3d.conv3d_cat2d``.
Inputs come from a numpy seed and go to both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biapy_tpu.ops import conv3d as jax_ops_conv3d
from biapy_tpu.ops.pallas import conv3d as jax_conv3d
from biapy_tpu.ops.pallas import shuffle as jax_shuffle
from biapy_tpu_torch.ops.conv3d import conv_same
from biapy_tpu_torch.ops.kernels.conv3d import conv3d
from biapy_tpu_torch.ops.kernels.shuffle import pool_max_folded, zcat, zd2s

torch.set_num_threads(2)


def _pair(a: np.ndarray, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``
    ('float32' or 'bfloat16'; bf16 values are rounded once, on the torch
    side, so both frameworks start from the same numbers)."""
    if dtype == "bfloat16":
        t = torch.from_numpy(a).to(torch.bfloat16)
        return jnp.asarray(t.float().numpy(), jnp.bfloat16), t
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype(jnp.float32))


def _torch_vjp(fn, x: torch.Tensor, g: torch.Tensor):
    x = x.clone().requires_grad_(True)
    y = fn(x)
    (dx,) = torch.autograd.grad(y, x, g)
    return y, dx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kz,c", [(3, 3), (5, 2), (3, 1)])
def test_zcat_forward_and_vjp_match_pallas(kz, c, dtype):
    rng = np.random.default_rng(kz * 10 + c)
    xj, xt = _pair(rng.standard_normal((6, 5, 7, c)).astype(np.float32), dtype)
    gj, gt = _pair(rng.standard_normal((6, 5, 7, kz * c)).astype(np.float32), dtype)
    ref, vjp = jax.vjp(lambda v: jax_shuffle.zcat(v, kz), xj)
    got, dx = _torch_vjp(lambda v: zcat(v, kz), xt, gt)
    assert got.dtype == xt.dtype and dx.dtype == xt.dtype
    np.testing.assert_array_equal(_np(got), _np(ref))  # a copy is exact
    # up to kz terms summed in float32 in the same order, one rounding:
    # 1e-6 in float32; in bf16 both round the same float32 sum
    np.testing.assert_allclose(_np(dx), _np(vjp(gj)[0]), rtol=0,
                               atol=1e-6 if dtype == "float32" else 0)


def test_zcat_with_depth_keeps_taps_inside_each_image():
    """rows = 2 images of 4 planes: the port's ``depth`` argument must equal
    the single-image Pallas op applied per image, forward and VJP."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 3, 4, 2)).astype(np.float32)
    g = rng.standard_normal((8, 3, 4, 6)).astype(np.float32)
    refs, dxs = [], []
    for i in range(2):
        r, vjp = jax.vjp(lambda v: jax_shuffle.zcat(v, 3), jnp.asarray(x[4 * i:4 * i + 4]))
        refs.append(np.asarray(r))
        dxs.append(np.asarray(vjp(jnp.asarray(g[4 * i:4 * i + 4]))[0]))
    got, dx = _torch_vjp(lambda v: zcat(v, 3, depth=4), torch.from_numpy(x),
                         torch.from_numpy(g))
    np.testing.assert_array_equal(_np(got), np.concatenate(refs))
    np.testing.assert_allclose(_np(dx), np.concatenate(dxs), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("win,ties", [((2, 2, 2), False), ((1, 2, 2), False), ((2, 2, 2), True),
                                      ((2, 1, 2), True)])
def test_pool_max_folded_forward_and_vjp_match_pallas(win, ties, dtype):
    rng = np.random.default_rng(sum(win) + ties)
    shape = (4, 6, 8, 3)
    if ties:
        # few distinct values: most windows tie, some at 0 and -0; one NaN
        x = rng.integers(-1, 2, shape).astype(np.float32) * 0.5
        x[1, 2, 3, 0] = -0.0
        x[0, 0, 0, 1] = np.nan
    else:
        x = (rng.permutation(int(np.prod(shape))).astype(np.float32) / 64.0).reshape(shape)
    wz, wy, wx = win
    g = rng.standard_normal((4 // wz, 6 // wy, 8 // wx, 3)).astype(np.float32)
    xj, xt = _pair(x, dtype)
    gj, gt = _pair(g, dtype)
    ref, vjp = jax.vjp(lambda v: jax_shuffle.pool_max_folded(v, win), xj)
    got, dx = _torch_vjp(lambda v: pool_max_folded(v, win), xt, gt)
    # a max and a select are exact: every tied slot gets the full cotangent,
    # a NaN window gets none
    np.testing.assert_array_equal(_np(got), _np(ref))
    np.testing.assert_array_equal(_np(dx), _np(vjp(gj)[0]))
    if ties:
        assert np.count_nonzero(_np(dx)) > g.size  # ties really were amplified


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [28, 36])
def test_pool_at_the_template_widths_matches_pallas(c, dtype):
    """The template's pools (``Z_DOWN: [1, 1, 1, 1]``: window 1x2x2) at its
    28 and 36 channels, ties, a NaN and a -0, forward and VJP."""
    rng = np.random.default_rng(c)
    win = (1, 2, 2)
    x = rng.integers(-2, 3, (3, 4, 8, c)).astype(np.float32) * 0.5
    x[1, 2, 3, 5] = -0.0
    x[0, 0, 1, 2] = np.nan
    g = rng.standard_normal((3, 2, 4, c)).astype(np.float32)
    xj, xt = _pair(x, dtype)
    gj, gt = _pair(g, dtype)
    ref, vjp = jax.vjp(lambda v: jax_shuffle.pool_max_folded(v, win), xj)
    got, dx = _torch_vjp(lambda v: pool_max_folded(v, win), xt, gt)
    np.testing.assert_array_equal(_np(got), _np(ref))  # a max and a select are exact
    np.testing.assert_array_equal(_np(dx), _np(vjp(gj)[0]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zcat_at_the_template_width_with_depth_matches_pallas(dtype):
    """zcat at the template's first width (c = 28) on two images of 3 planes
    (``depth``; kz 3): the single-image Pallas op per image, forward and
    VJP."""
    rng = np.random.default_rng(28)
    x = rng.standard_normal((6, 4, 5, 28)).astype(np.float32)
    g = rng.standard_normal((6, 4, 5, 84)).astype(np.float32)
    refs, dxs = [], []
    for i in range(2):
        xj, _ = _pair(x[3 * i:3 * i + 3], dtype)
        gj, _ = _pair(g[3 * i:3 * i + 3], dtype)
        r, vjp = jax.vjp(lambda v: jax_shuffle.zcat(v, 3), xj)
        refs.append(_np(r))
        dxs.append(_np(vjp(gj)[0]))
    _, xt = _pair(x, dtype)
    _, gt = _pair(g, dtype)
    got, dx = _torch_vjp(lambda v: zcat(v, 3, depth=3), xt, gt)
    np.testing.assert_array_equal(_np(got), np.concatenate(refs))  # a copy is exact
    # up to 3 terms summed in float32 in tap order, one rounding: 1e-6 in
    # float32; in bf16 both round the same float32 sum
    np.testing.assert_allclose(_np(dx), np.concatenate(dxs), rtol=0,
                               atol=1e-6 if dtype == "float32" else 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sz", [2, 3])
def test_zd2s_forward_and_vjp_match_pallas(sz, dtype):
    rng = np.random.default_rng(sz)
    xj, xt = _pair(rng.standard_normal((3, 4, 5, sz * 3)).astype(np.float32), dtype)
    gj, gt = _pair(rng.standard_normal((3 * sz, 4, 5, 3)).astype(np.float32), dtype)
    ref, vjp = jax.vjp(lambda v: jax_shuffle.zd2s(v, sz), xj)
    got, dx = _torch_vjp(lambda v: zd2s(v, sz), xt, gt)
    np.testing.assert_array_equal(_np(got), _np(ref))  # copies, both ways
    np.testing.assert_array_equal(_np(dx), _np(vjp(gj)[0]))


def _scaled_close(got, ref, tol, what):
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: max err {err:.3g} > {tol} * scale {scale:.3g}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout", [((1, 5, 6, 7, 3), 4), ((2, 4, 5, 6, 8), 5),
                                        ((2, 3, 4, 4, 1), 6)])
def test_conv3d_k3_vjp_matches_jax_custom_vjp(shape, cout, dtype):
    """dx (the same conv on flipped, IO-swapped weights) and dw (the cat2d
    weight gradient; at batch 2 no z tap may cross the image seam) against
    ``jax.vjp`` of the JAX package's ``conv3d``."""
    rng = np.random.default_rng(shape[0] + cout)
    cin = shape[-1]
    xj, xt = _pair(rng.standard_normal(shape).astype(np.float32), dtype)
    wj, wt = _pair((rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)
                    ).astype(np.float32), dtype)
    gj, gt = _pair(rng.standard_normal(shape[:-1] + (cout,)).astype(np.float32), dtype)
    ref, vjp = jax.vjp(jax_conv3d.conv3d, xj, wj)
    dx_ref, dw_ref = vjp(gj)
    xt = xt.requires_grad_(True)
    wt = wt.requires_grad_(True)
    got = conv3d(xt, wt)
    dx, dw = torch.autograd.grad(got, (xt, wt), gt)
    assert dx.dtype == xt.dtype and dw.dtype == wt.dtype
    # float32: the same products summed in float32 in another order. bf16:
    # both keep a float32 sum of bf16 products and round once, so they differ
    # by about one bf16 ulp (2^-8) of the result
    tol = 1e-5 if dtype == "float32" else 2e-2
    _scaled_close(_np(got), _np(ref), tol, "y")
    _scaled_close(_np(dx), _np(dx_ref), tol, "dx")
    _scaled_close(_np(dw), _np(dw_ref), tol, "dw")


def test_conv3d_k3_skips_the_gradients_nobody_asked_for():
    x = torch.randn(1, 3, 4, 4, 2)
    w = torch.randn(3, 3, 3, 2, 3, requires_grad=True)
    (dw,) = torch.autograd.grad(conv3d(x, w).sum(), w)  # the stem: no dx
    assert dw.shape == w.shape
    x = x.requires_grad_(True)
    (dx,) = torch.autograd.grad(conv3d(x, w.detach()).sum(), x)  # a frozen weight: no dw
    assert dx.shape == x.shape


@pytest.mark.parametrize("ks,shape,cout", [((5, 5, 5), (1, 6, 7, 6, 1), 4),
                                           ((5, 5, 5), (2, 5, 6, 6, 3), 4),
                                           ((3, 5, 5), (2, 4, 6, 5, 2), 3)])
def test_cat2d_conv_path_matches_jax_cat2d(ks, shape, cout):
    """Odd-kz convs other than 3x3x3 (the LARGER_IO 5x5x5 convs): one 2D
    conv over z-concatenated channels, forward and both gradients against
    the JAX package's ``conv3d_cat2d``."""
    rng = np.random.default_rng(sum(ks))
    cin = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(ks + (cin, cout)) / np.sqrt(np.prod(ks) * cin)).astype(np.float32)
    g = rng.standard_normal(shape[:-1] + (cout,)).astype(np.float32)
    ref, vjp = jax.vjp(jax_ops_conv3d.conv3d_cat2d, jnp.asarray(x), jnp.asarray(w))
    dx_ref, dw_ref = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = conv_same(xt, wt)
    dx, dw = torch.autograd.grad(got, (xt, wt), torch.from_numpy(g))
    # float32 sums of up to 125 * Cin products in another order
    _scaled_close(_np(got), _np(ref), 1e-5, "y")
    _scaled_close(_np(dx), _np(dx_ref), 1e-5, "dx")
    _scaled_close(_np(dw), _np(dw_ref), 1e-5, "dw")
