"""The PyTorch port's kernel modules against the JAX package's functions.

On the CPU every wrapper of ``biapy_tpu_torch.ops.kernels`` takes its plain
PyTorch version (the CUDA kernels are held against those versions on the
card by ``chip_smoke.py`` and by ``tests/test_torch_cuda.py``). Here the
plain versions are held against the JAX package exactly as its own tests
run it on the CPU: ``conv3d`` falls to its XLA reference ``_conv3d_xla``,
and the Pallas shuffle kernels run in interpret mode.

Also here: the isolation check that the port imports nothing of JAX (nor
msgpack), and the optional packages only inside functions.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from biapy_tpu.ops.pallas import conv3d as jax_conv3d
from biapy_tpu.ops.pallas import shuffle as jax_shuffle
from biapy_tpu_torch.ops.kernels import build
from biapy_tpu_torch.ops.kernels.conv3d import conv3d, conv3d_plain
from biapy_tpu_torch.ops.kernels.shuffle import (pool_max_folded, pool_max_folded_bwd,
                                                 pool_max_folded_bwd_plain,
                                                 pool_max_folded_plain, pool_route, zcat,
                                                 zcat_bwd, zcat_bwd_plain, zcat_plain,
                                                 zcat_route, zd2s, zd2s_plain, zs2d, zs2d_plain)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    """float32 values that bfloat16 holds exactly, so both frameworks start
    from the same bf16 tensor."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("shape,cout", [
    ((1, 5, 7, 9, 1), 4),     # the stem's Cin = 1, odd D/H/W
    ((2, 3, 6, 5, 8), 8),     # batch 2: no z bleed across images
    ((1, 4, 5, 3, 24), 12),   # Cin = 24, odd
])
def test_conv3d_matches_jax(shape, cout):
    rng = np.random.default_rng(0)
    cin = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    ref = np.asarray(jax_conv3d.conv3d(jnp.asarray(x), jnp.asarray(w)))
    got = conv3d(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    # float32 sums of 27*Cin products in another order: |y| ~ 1, so the
    # rounding difference stays near 1e-6
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_conv3d_bf16_keeps_dtype_and_rounds_once():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 4, 5, 6, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 8, 8)).astype(np.float32) * 0.1)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    got = conv3d(xb, wb)
    assert got.dtype == torch.bfloat16
    # f32 accumulation of the bf16 operands, one rounding at the end
    want = conv3d_plain(xb.float(), wb.float()).to(torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("shape,win", [
    ((4, 6, 8, 3), (2, 2, 2)),
    ((6, 4, 6, 5), (3, 2, 1)),
    ((2, 8, 4, 16), (1, 2, 2)),
])
def test_pool_max_folded_matches_pallas(shape, win, dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    x[0, 0, 0, 0] = np.nan  # jnp.max propagates NaN; the port must too
    if dtype == "bfloat16":
        x = _bf16_exact(x)
        xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    ref = np.asarray(jax_shuffle.pool_max_folded(xj, win)).astype(np.float32)
    got = pool_max_folded(xt, win).float().numpy()
    np.testing.assert_array_equal(got, ref)  # a max is exact


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("shape,sz", [((3, 4, 5, 6), 2), ((2, 3, 4, 9), 3), ((5, 2, 2, 4), 1)])
def test_zd2s_matches_pallas(shape, sz, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16_exact(x)
        xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    ref = np.asarray(jax_shuffle.zd2s(xj, sz)).astype(np.float32)
    got = zd2s(xt, sz).float().numpy()
    np.testing.assert_array_equal(got, ref)  # a copy is exact


# (kernel, (rows, h, w, c), itemsize, pool window, pointers, route); the
# pointers are (input, output), or (x, y, g, dx) for the pool backward
_ROUTES = {
    # the bench ResUNet (bf16): its two pools and the zcats of its wgrads
    "bench-pool-1": ("pool", (128, 128, 128, 32), 2, (2, 2, 2), (0, 512), "channels16"),
    "bench-pool-2": ("pool", (64, 64, 64, 64), 2, (2, 2, 2), (0, 512), "channels16"),
    "bench-zcat-stem": ("zcat", (128, 128, 128, 1), 2, None, (0, 512), "rows16"),
    "bench-zcat-32": ("zcat", (32, 32, 32, 128), 2, None, (0, 512), "channels16"),
    "larger-io-zcat-f32": ("zcat", (128, 128, 128, 32), 4, None, (0, 512), "channels16"),
    # the template at batch 2 (bf16, 28 / 36 / 48 channels: 56 / 72 / 96 bytes)
    "template-pool-1": ("pool", (80, 128, 128, 28), 2, (1, 2, 2), (0, 512), "rows16"),
    "template-pool-2": ("pool", (80, 64, 64, 36), 2, (1, 2, 2), (0, 512), "rows16"),
    "template-pool-3": ("pool", (80, 32, 32, 48), 2, (1, 2, 2), (0, 512), "channels16"),
    "template-zcat-stem": ("zcat", (80, 128, 128, 1), 2, None, (0, 512), "rows16"),
    "template-zcat-28": ("zcat", (80, 128, 128, 28), 2, None, (0, 512), "rows16"),
    "template-zcat-84": ("zcat", (80, 64, 64, 84), 2, None, (0, 512), "rows16"),
    "template-zcat-112": ("zcat", (80, 32, 32, 112), 2, None, (0, 512), "channels16"),
    # odd: 16-byte channels in rows off the grid, a row of 70 bf16 elements, a
    # pooled row of 24 bytes, planes of 35 positions, a pointer one element off
    # the 16-byte grid
    "odd-pool-channels": ("pool", (4, 6, 6, 8), 2, (2, 2, 2), (0, 512), "channels16"),
    "odd-pool-row": ("pool", (6, 10, 14, 5), 2, (3, 2, 1), (0, 512), "scalar"),
    "odd-pool-pooled-row": ("pool", (2, 2, 24, 1), 2, (1, 2, 2), (0, 512), "scalar"),
    "odd-pool-offset-in": ("pool", (4, 8, 8, 16), 4, (2, 2, 2), (4, 512), "scalar"),
    "odd-pool-offset-out": ("pool", (80, 128, 128, 28), 2, (1, 2, 2), (0, 514), "scalar"),
    "odd-zcat-plane": ("zcat", (6, 5, 7, 1), 2, None, (0, 512), "scalar"),
    "odd-zcat-channels": ("zcat", (6, 5, 7, 8), 2, None, (0, 512), "channels16"),
    "odd-zcat-offset-in": ("zcat", (8, 8, 8, 3), 2, None, (2, 512), "scalar"),
    "odd-zcat-offset-out": ("zcat", (128, 64, 64, 64), 2, None, (0, 520), "scalar"),
    # the pool backward: the bench's two pools, the template's three (bf16,
    # batch 2), a pointer of g or dx one element off the grid, a pooled row
    # of 24 bytes
    "bench-pool-bwd-1": ("pool_bwd", (128, 128, 128, 32), 2, (2, 2, 2), (0, 512, 1024, 1536),
                         "channels16"),
    "bench-pool-bwd-2": ("pool_bwd", (64, 64, 64, 64), 2, (2, 2, 2), (0, 512, 1024, 1536),
                         "channels16"),
    "template-pool-bwd-1": ("pool_bwd", (80, 128, 128, 28), 2, (1, 2, 2), (0, 512, 1024, 1536),
                            "rows16"),
    "template-pool-bwd-2": ("pool_bwd", (80, 64, 64, 36), 2, (1, 2, 2), (0, 512, 1024, 1536),
                            "rows16"),
    "template-pool-bwd-3": ("pool_bwd", (80, 32, 32, 48), 2, (1, 2, 2), (0, 512, 1024, 1536),
                            "channels16"),
    "odd-pool-bwd-offset-g": ("pool_bwd", (80, 128, 128, 28), 2, (1, 2, 2),
                              (0, 512, 1026, 1536), "scalar"),
    "odd-pool-bwd-offset-dx": ("pool_bwd", (128, 128, 128, 32), 2, (2, 2, 2),
                               (0, 512, 1024, 1538), "scalar"),
    "odd-pool-bwd-pooled-row": ("pool_bwd", (2, 2, 24, 1), 2, (1, 2, 2), (0, 512, 1024, 1536),
                                "scalar"),
}


@pytest.mark.parametrize("case", sorted(_ROUTES))
def test_shuffle_route_rule(case):
    """The routes of the pool, its backward and zcat are a rule on shape,
    itemsize and pointer alignment alone: 16-byte vectors on every main-path
    shape (of channels where c * itemsize allows, else of whole rows), one
    element per access where a run or a pointer leaves the 16-byte grid."""
    kernel, shape, itemsize, win, ptrs, want = _ROUTES[case]
    if kernel == "zcat":
        assert zcat_route(shape, itemsize, *ptrs) == want
    else:
        assert pool_route(shape, itemsize, win, *ptrs) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3d_plain_buffered_form_equals_the_functional_form(dtype):
    """Outside autograd the plain conv writes each tap's product into
    buffers allocated once; the functional form, which autograd takes, must
    give the same bits."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 5, 9, 7, 28), generator=g).to(dtype)
    w = (torch.randn((3, 3, 3, 28, 36), generator=g) / 16).to(dtype)
    buffered = conv3d_plain(x, w)
    functional = conv3d_plain(x.clone().requires_grad_(True), w).detach()
    assert buffered.dtype == functional.dtype == dtype
    assert torch.equal(buffered, functional)


def test_cpu_tensors_take_plain_path_and_count_no_launch():
    build.reset_launches()
    x = torch.randn(2, 4, 4, 4, 3)
    w = torch.randn(3, 3, 3, 3, 5)
    assert torch.equal(conv3d(x, w), conv3d_plain(x, w))
    x4 = x.reshape(8, 4, 4, 3)
    assert torch.equal(pool_max_folded(x4, (2, 2, 2)), pool_max_folded_plain(x4, (2, 2, 2)))
    y4 = pool_max_folded_plain(x4, (2, 2, 2))
    assert torch.equal(pool_max_folded_bwd(x4, y4, y4, (2, 2, 2)),
                       pool_max_folded_bwd_plain(x4, y4, y4, (2, 2, 2)))
    x6 = torch.randn(2, 3, 3, 6)
    assert torch.equal(zd2s(x6, 2), zd2s_plain(x6, 2))
    assert torch.equal(zs2d(x6, 2), zs2d_plain(x6, 2))
    assert torch.equal(zs2d(zd2s(x6, 3), 3), x6)  # inverse of each other
    assert torch.equal(zcat(x6, 3), zcat_plain(x6, 3))
    assert torch.equal(zcat_bwd(x6, 3), zcat_bwd_plain(x6, 3))
    assert set(build.LAUNCHES) == {"conv3d", "pad_channels", "tf32_split", "pool_max_folded",
                                   "pool_max_folded_bwd", "zd2s", "zs2d", "zcat", "zcat_bwd"}
    assert all(n == 0 for n in build.LAUNCHES.values())
    assert build.SHUFFLE_ROUTES == {k: {"channels16": 0, "rows16": 0, "scalar": 0}
                                    for k in ("pool_max_folded", "pool_max_folded_bwd", "zcat")}


def test_non_cpu_non_cuda_tensor_raises_instead_of_falling_back():
    x = torch.empty(1, 3, 3, 3, 2, device="meta")
    w = torch.empty(3, 3, 3, 2, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv3d(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        pool_max_folded(x.reshape(3, 3, 3, 2)[:2, :2, :2], (2, 2, 2))
    with pytest.raises(ValueError, match="CUDA"):
        zd2s(x.reshape(3, 3, 3, 2), 2)
    x4 = torch.empty(4, 2, 2, 6, device="meta")
    y4 = torch.empty(2, 1, 1, 6, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pool_max_folded_bwd(x4, y4, y4, (2, 2, 2))
    with pytest.raises(ValueError, match="CUDA"):
        zs2d(x4, 2)
    with pytest.raises(ValueError, match="CUDA"):
        zcat(x4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        zcat_bwd(x4, 3)


@pytest.mark.parametrize("call", [
    lambda x: zcat(x, 2),                # even kz
    lambda x: zcat(x, 3, depth=3),       # depth does not divide rows
    lambda x: zcat_bwd(x, 5),            # channels not a multiple of kz
    lambda x: zs2d(x, 3),                # rows not a multiple of sz
    lambda x: pool_max_folded(x, (3, 2, 2)),
], ids=["even-kz", "bad-depth", "bad-channels", "bad-rows", "bad-window"])
def test_shuffle_wrappers_reject_shapes_they_do_not_take(call):
    with pytest.raises(ValueError):
        call(torch.zeros(4, 2, 2, 6))


_FORBIDDEN = ("jax", "flax", "optax", "biapy_tpu", "msgpack", "cv2", "sklearn")
# optional dependencies of the port: imported only inside the functions
# that use them, where they are optional
_LAZY_ONLY = ("matplotlib", "yaml", "PIL", "h5py", "imageio")


def _imports(path: Path, top_level_only: bool = False):
    tree = ast.parse(path.read_text(), filename=str(path))
    nodes = ast.walk(tree)
    if top_level_only:
        # module scope, including the bodies of top-level if/try blocks
        nodes = [n for top in tree.body for n in ast.walk(top)
                 if not isinstance(top, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))]
    for node in nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "biapy_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(f.relative_to(REPO)) for f in files}
    assert {"biapy_tpu_torch/engine/train_engine.py", "biapy_tpu_torch/engine/schedulers.py",
            "biapy_tpu_torch/engine/metrics.py", "biapy_tpu_torch/utils/flax_msgpack.py",
            "biapy_tpu_torch/utils/misc.py", "biapy_tpu_torch/engine/chunked.py",
            "biapy_tpu_torch/data/zarr_store.py", "biapy_tpu_torch/data/io.py",
            "biapy_tpu_torch/parallel/__init__.py", "biapy_tpu_torch/native/__init__.py",
            "biapy_tpu_torch/engine/instance_seg.py", "biapy_tpu_torch/utils/matching.py",
            "biapy_tpu_torch/data/post_processing.py"} <= names
    # the native host ops build from the port's own copy of their source
    from biapy_tpu_torch import native

    assert native._SRC == REPO / "biapy_tpu_torch/native/hostops.cpp" and native._SRC.exists()
    assert native._BUILD_DIR == REPO / "biapy_tpu_torch/_build"
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in _FORBIDDEN:
                bad.append(f"{f.relative_to(REPO)}: {mod}")
        for mod in _imports(f, top_level_only=True):
            if mod.split(".")[0] in _LAZY_ONLY:
                bad.append(f"{f.relative_to(REPO)}: {mod} at module level")
    assert not bad, ("the port must not import JAX, the JAX package, msgpack, OpenCV or "
                     "scikit-learn, and "
                     "imports optional packages inside functions:\n" + "\n".join(bad))
