"""The port's node kernels (matmul, copy, stencil) against the JAX
package's, on the CPU.

On the CPU each wrapper takes its plain version, which walks the CUDA
kernel's tiles (``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the
kernels against those plain versions on the card).  Inputs are made from a
seed with numpy and go through ``matmul_pallas`` / ``copy_pallas`` /
``stencil_pallas`` in interpret mode, as ``tests/test_kernels.py`` runs
them, through ``repro.kernels.ref``'s oracles, and through the port's
``ops``.  Tolerances are the reference's own: matmul 2e-4 in float32 and
2e-2 in bfloat16, stencil 1e-5 in float32, copy exact.  A bfloat16
stencil sums in float32 here and in bfloat16 in the reference, so it is
held at 2e-2.  Ragged shapes, which Pallas refuses, are held against the
JAX oracle alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.copy import copy_pallas
from repro.kernels.matmul import matmul_pallas
from repro.kernels.stencil import stencil_pallas
from repro_torch.kernels import copy, matmul, ops, ref, stencil

torch.set_num_threads(1)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _pair(x, dtype):
    """x as a jax array and a torch tensor holding the same ``dtype``
    values."""
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else x.dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    return jx, (tx.to(torch.bfloat16) if dtype == "bfloat16"
                else torch.from_numpy(np.array(jx)))


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


# -- matmul ------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (512, 256, 256), (128, 512, 384)])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4),
                                       ("bfloat16", 2e-2)])
def test_matmul_matches_pallas_and_ref(m, k, n, dtype, tol):
    ja, ta = _pair(_normal((m, k), 1), dtype)
    jb, tb = _pair(_normal((k, n), 2), dtype)
    got = ops.matmul(ta, tb)
    assert got.dtype == ta.dtype and got.shape == (m, n)
    for want in (matmul_pallas(ja, jb, interpret=True),
                 jref.matmul_ref(ja, jb)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def _offset_view(x: torch.Tensor) -> torch.Tensor:
    """x's values in a contiguous tensor one element past an aligned
    start, so its pointer is off a 16-byte boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype)[1:]
    flat.copy_(x.reshape(-1))
    return flat.view(x.shape)


@pytest.mark.parametrize("dtype,m,k,n,offset,path", [
    (torch.bfloat16, 4096, 4096, 4096, False, "wgmma"),
    (torch.bfloat16, 300, 512, 200, False, "wgmma"),      # TMA-filled edges
    (torch.bfloat16, 37, 4096, 264, False, "wgmma"),
    (torch.bfloat16, 1, 8, 8, False, "wgmma"),
    (torch.bfloat16, 64, 36, 128, False, "general"),      # K % 8
    (torch.bfloat16, 64, 64, 132, False, "general"),      # N % 8
    (torch.bfloat16, 256, 256, 256, True, "general"),     # a off 16 bytes
    (torch.float32, 4096, 4096, 4096, False, "fma_pipelined"),
    (torch.float32, 300, 512, 200, False, "fma_pipelined"),
    (torch.float32, 64, 36, 132, False, "fma_pipelined"),  # 16-byte rows
    (torch.float32, 130, 200, 70, False, "general"),      # N % 4
    (torch.float32, 37, 513, 129, False, "general"),      # K % 4
    (torch.float32, 256, 256, 256, True, "general"),
    (torch.float32, 64, 0, 32, False, "general"),         # K = 0
    (torch.bfloat16, 64, 0, 32, False, "general"),
])
def test_matmul_path_choice(dtype, m, k, n, offset, path):
    """Which kernel takes a product is a plain function of dtype, shape
    and alignment; on the CPU the same function picks the tiles that the
    plain version walks."""
    a, b = torch.zeros((m, k), dtype=dtype), torch.zeros((k, n), dtype=dtype)
    if offset:
        a = _offset_view(a)
        assert a.data_ptr() % 16
    assert matmul.matmul_path(a, b) == path
    assert matmul.matmul_path(a, b) in matmul.PATHS


@pytest.mark.parametrize("m,k,n", [(128, 128, 256), (128, 128, 384),
                                   (256, 256, 512), (384, 128, 768)])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4),
                                       ("bfloat16", 2e-2)])
def test_matmul_plain_at_the_fast_paths_tiles_matches_pallas(m, k, n, dtype,
                                                             tol):
    """N across the 128 x 256 output tiles of both fast paths (one tile, a
    tile and a ragged half, two and three tiles), against the Pallas
    kernel in interpret mode."""
    ja, ta = _pair(_normal((m, k), 11), dtype)
    jb, tb = _pair(_normal((k, n), 12), dtype)
    assert matmul.TILES[matmul.matmul_path(ta, tb)] == (128, 256)
    got = matmul.matmul_plain(ta, tb)
    np.testing.assert_allclose(
        _f32(got), _f32(matmul_pallas(ja, jb, interpret=True)), rtol=tol,
        atol=tol)


@pytest.mark.parametrize("m,k,n", [(130, 70, 200), (1, 300, 7), (37, 1, 129)])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4),
                                       ("bfloat16", 2e-2)])
def test_matmul_ragged_against_ref(m, k, n, dtype, tol):
    """Shapes off the 128 tiling (matmul_pallas refuses them): the plain
    version cuts the edge tiles short, as the kernel masks them."""
    ja, ta = _pair(_normal((m, k), 3), dtype)
    jb, tb = _pair(_normal((k, n), 4), dtype)
    np.testing.assert_allclose(_f32(ops.matmul(ta, tb)),
                               _f32(jref.matmul_ref(ja, jb)), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("a_shape,b_shape", [((3, 40, 50), (50, 20)),
                                             ((2, 3, 8), (4, 8, 5)),
                                             ((50,), (50, 3)), ((6, 7), (7,)),
                                             ((), (4, 4))])
def test_matmul_other_ranks_follow_the_reference(a_shape, b_shape):
    """``ops.matmul`` of operands that are not both matrices is
    ``matmul_ref``'s ``jnp.dot`` product, as in the reference (which never
    gives those to its kernel)."""
    a, b = _normal(a_shape, 5), _normal(b_shape, 6)
    want = np.asarray(jref.matmul_ref(jnp.asarray(a), jnp.asarray(b)))
    for got in (ops.matmul(torch.from_numpy(a), torch.from_numpy(b)),
                ref.matmul_ref(torch.from_numpy(a), torch.from_numpy(b))):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


# -- copy --------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(512, 1024), (1024, 2048), (64, 128)])
def test_copy_matches_pallas_and_ref(shape):
    x = _normal(shape, 7)
    got = ops.copy(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(copy_pallas(
        jnp.asarray(x), interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jref.copy_ref(
        jnp.asarray(x))))


@pytest.mark.parametrize("shape", [(1000, 77), (12345,), (3, 5, 7), (),
                                   (0, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_copy_any_shape_and_dtype_against_ref(shape, dtype):
    x = np.asarray(_normal(shape, 8) * 1000)
    if dtype == "int32":
        jx, tx = jnp.asarray(x.astype(np.int32)), torch.from_numpy(
            x.astype(np.int32))
    else:
        jx, tx = _pair(x, dtype)
    got = ops.copy(tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_array_equal(_f32(got) if dtype == "bfloat16"
                                  else got.numpy(),
                                  np.asarray(jref.copy_ref(jx), np.float32)
                                  if dtype == "bfloat16"
                                  else np.asarray(jref.copy_ref(jx)))


def test_copy_gives_a_fresh_buffer():
    x = torch.from_numpy(_normal((600, 1100), 9))
    keep = x.clone()
    for y in (ops.copy(x), ref.copy_ref(x)):
        assert y.data_ptr() != x.data_ptr()
        y.zero_()
        assert torch.equal(x, keep)


# -- stencil -----------------------------------------------------------------

@pytest.mark.parametrize("b,h,w,bh,bw", [(1, 256, 256, 128, 128),
                                         (2, 512, 256, 256, 128),
                                         (1, 128, 128, 128, 128)])
def test_stencil_matches_pallas_and_ref(b, h, w, bh, bw):
    u = _normal((b, h, w), 10)
    got = ops.stencil(torch.from_numpy(u)).numpy()
    for want in (stencil_pallas(jnp.asarray(u), bh=bh, bw=bw, interpret=True),
                 jref.stencil_ref(jnp.asarray(u))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_stencil_bf16_against_pallas_and_ref():
    """The reference sums bfloat16 in bfloat16 (in two different orders);
    the port sums in float32 and rounds once."""
    ju, tu = _pair(_normal((2, 256, 256), 11), "bfloat16")
    got = ops.stencil(tu)
    assert got.dtype == torch.bfloat16
    for want in (stencil_pallas(ju, bh=128, bw=128, interpret=True),
                 jref.stencil_ref(ju)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("shape", [(2, 100, 70), (1, 33, 65), (3, 1, 1),
                                   (1, 70, 200)])
def test_stencil_ragged_against_ref(shape):
    """Shapes off the (8, 128) tiling: the plain version's edge tiles read a
    zero halo past the domain, as the kernel's do."""
    u = _normal(shape, 12)
    want = np.asarray(jref.stencil_ref(jnp.asarray(u)))
    for got in (ops.stencil(torch.from_numpy(u)),
                ref.stencil_ref(torch.from_numpy(u))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_stencil_boundary_is_dirichlet():
    out = ops.stencil(torch.ones((1, 128, 128)))
    # interior average of 4 ones = 1; corners see two zero neighbours
    assert out[0, 0, 0] == pytest.approx(0.5)
    assert out[0, 64, 64] == pytest.approx(1.0)
    assert out[0, 0, 64] == pytest.approx(0.75)


# -- the wrappers ------------------------------------------------------------

def test_cpu_calls_count_no_launch():
    a = torch.from_numpy(_normal((64, 32), 13))
    u = torch.from_numpy(_normal((1, 40, 40), 14))
    before = (matmul.launches.count, copy.launches.count,
              stencil.launches.count)
    ops.matmul(a, a.T.contiguous())
    ops.copy(a)
    ops.stencil(u)
    assert (matmul.launches.count, copy.launches.count,
            stencil.launches.count) == before


@pytest.mark.parametrize("call", [
    lambda: ops.matmul(torch.zeros(4, 5), torch.zeros(6, 3)),   # K differs
    lambda: ops.matmul(torch.zeros(4, 5, dtype=torch.float64),
                       torch.zeros(5, 3, dtype=torch.float64)),
    lambda: ops.matmul(torch.zeros(4, 5), torch.zeros(5, 3).bfloat16()),
    lambda: ops.matmul(torch.zeros(4, 5, dtype=torch.int32),
                       torch.zeros(5, 3, dtype=torch.int32)),
    lambda: ops.stencil(torch.zeros(8, 8)),                     # rank 2
    lambda: ops.stencil(torch.zeros(1, 8, 8, dtype=torch.float16)),
    lambda: ops.copy(torch.zeros(8, 8).T),                      # strided
], ids=["matmul-inner", "matmul-f64", "matmul-mixed", "matmul-int",
        "stencil-rank", "stencil-f16", "copy-strided"])
def test_bad_shapes_and_dtypes_raise(call):
    with pytest.raises(ValueError):
        call()
