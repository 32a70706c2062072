"""The port's kernels: plain PyTorch versions against the JAX package's
Pallas kernels (interpret mode) on the same numpy inputs.

Bitmaps cross the boundary as uint32 numpy words, viewed as int32 for
torch.  The hand-written CUDA kernels are held against the plain versions
on the card in ``test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ops as jax_ops, ref as jref
from repro.kernels.bitmap_ops import frontier_update as jax_frontier_update
from repro.kernels.frontier_spmv import core_spmv as jax_core_spmv
from repro.kernels.spmv_mxu import spmv_mxu as jax_spmv_mxu
from repro_torch.kernels import bitmap_ops, cin, frontier_spmv, ops, ref, spmv_mxu

torch.set_num_threads(2)


def rand_u32(rng, shape, density=0.5):
    bits = rng.random(shape + (32,)) < density
    return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little") \
        .view(np.uint32).reshape(shape)


def to_t(words: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32).copy()).to(device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def corner_cases():
    w = 1024
    ones = np.full(w, 0xFFFFFFFF, np.uint32)
    zeros = np.zeros(w, np.uint32)
    bit31 = np.full(w, 0x80000000, np.uint32)
    return [(ones, zeros), (ones, ones), (zeros, ones), (bit31, zeros),
            (ones, bit31), (bit31, bit31)]


# ---------------------------------------------------------------------------
# Plain versions vs the JAX kernels (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_words", [1024, 4096])
@pytest.mark.parametrize("density", [0.01, 0.5])
def test_frontier_update_plain_matches_jax(n_words, density):
    rng = np.random.default_rng(n_words)
    nxt = rand_u32(rng, (n_words,), density)
    vis = rand_u32(rng, (n_words,), density)
    want = jax_frontier_update(jnp.asarray(nxt), jnp.asarray(vis), interpret=True)
    got = ops.frontier_update(to_t(nxt), to_t(vis))
    np.testing.assert_array_equal(to_u32(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(to_u32(got[1]), np.asarray(want[1]))
    assert got[2].dtype == torch.int32 and int(got[2]) == int(want[2])


@pytest.mark.parametrize("case", range(6))
def test_frontier_update_corners_match_jax(case):
    nxt, vis = corner_cases()[case]
    want = jax_frontier_update(jnp.asarray(nxt), jnp.asarray(vis), interpret=True)
    got = ref.frontier_update_ref(to_t(nxt), to_t(vis))
    np.testing.assert_array_equal(to_u32(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(to_u32(got[1]), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])
    if case == 0:
        assert int(got[2]) == 1024 * 32


@pytest.mark.parametrize("density", [0.001, 0.05])
def test_core_spmv_plain_matches_jax(density):
    rng = np.random.default_rng(4096)
    k = 4096
    a = rand_u32(rng, (k, k // 32), density)
    f = rand_u32(rng, (k // 32,), 0.1)
    want = jax_core_spmv(jnp.asarray(a), jnp.asarray(f), interpret=True)
    got = ops.core_spmv(to_t(a), to_t(f))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _min_neighbour_case():
    k = 4096
    a = np.zeros((k, k // 32), np.uint32)
    for j in (5, 70, 4000):
        a[0, j // 32] |= np.uint32(1) << np.uint32(j % 32)
    f = np.zeros((k // 32,), np.uint32)
    for j in (70, 4000):
        f[j // 32] |= np.uint32(1) << np.uint32(j % 32)
    return a, f


def test_core_spmv_finds_min_neighbor():
    a, f = _min_neighbour_case()
    got = ref.core_spmv_ref(to_t(a), to_t(f))
    want = jax_core_spmv(jnp.asarray(a), jnp.asarray(f), interpret=True)
    assert int(got[0]) == 70 and int(got[1]) == ref.BIG == jref.BIG
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_core_spmv_bit31_column():
    # column 31 of word 0 and column 63 of word 1 sit in the int32 sign bit
    k = 4096
    a = np.zeros((k, k // 32), np.uint32)
    a[0, 0] = 0x80000000
    a[1, 1] = 0x80000001
    f = np.zeros((k // 32,), np.uint32)
    f[0] = 0x80000000
    f[1] = 0x80000000
    got = ref.core_spmv_ref(to_t(a), to_t(f))
    want = np.asarray(jax_core_spmv(jnp.asarray(a), jnp.asarray(f), interpret=True))
    assert int(got[0]) == 31 and int(got[1]) == 63
    np.testing.assert_array_equal(got.numpy(), want)


def test_popcount_ctz_match_jax():
    rng = np.random.default_rng(0)
    w = np.concatenate([rng.integers(0, 2**32, size=1000, dtype=np.uint32),
                        np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF],
                                 np.uint32)])
    np.testing.assert_array_equal(ref.popcount_u32(to_t(w)).numpy(),
                                  np.asarray(jref.popcount_u32(jnp.asarray(w))))
    ctz = ref.ctz_u32(to_t(w)).numpy()
    np.testing.assert_array_equal(ctz, np.asarray(jref.ctz_u32(jnp.asarray(w))))
    assert ctz[-5] == 32 and ctz[-3] == 31
    expect = np.array([bin(int(x)).count("1") for x in w])
    np.testing.assert_array_equal(ref.popcount_u32(to_t(w)).numpy(), expect)


def test_cpu_dispatch_never_launches():
    before = ops.launch_counts()
    a, f = _min_neighbour_case()
    ops.core_spmv(to_t(a), to_t(f))
    ops.frontier_update(to_t(a[0]), to_t(a[1]))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("wrapper", ["frontier_update", "core_spmv"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    # no fallback: the kernel wrapper itself never runs the plain version
    a, f = _min_neighbour_case()
    with pytest.raises(ValueError, match="CUDA tensor"):
        if wrapper == "frontier_update":
            bitmap_ops.frontier_update(to_t(a[0]), to_t(a[1]))
        else:
            frontier_spmv.core_spmv(to_t(a), to_t(f))


# ---------------------------------------------------------------------------
# spmv_mxu and cin_layer: plain versions and CPU dispatch vs the JAX kernels
# ---------------------------------------------------------------------------

def int8_operands(rng, k, r, full_range):
    """A8 [K, K], F8 [K, R]: 0/1 (a Boolean core and frontiers) or every
    int8 value, -128 included."""
    if full_range:
        return (rng.integers(-128, 128, (k, k), dtype=np.int8),
                rng.integers(-128, 128, (k, r), dtype=np.int8))
    return ((rng.random((k, k)) < 0.05).astype(np.int8),
            (rng.random((k, r)) < 0.1).astype(np.int8))


@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("k,r", [(256, 128), (512, 256)])
def test_spmv_mxu_plain_matches_jax(k, r, full_range):
    # integer products: bit-exact
    rng = np.random.default_rng(k * r + full_range)
    a, f = int8_operands(rng, k, r, full_range)
    want = np.asarray(jax_spmv_mxu(jnp.asarray(a), jnp.asarray(f), interpret=True))
    got = ops.multi_source_spmv(torch.from_numpy(a), torch.from_numpy(f))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.spmv_mxu_ref(torch.from_numpy(a), torch.from_numpy(f), chunk_rows=96).numpy(),
        want)
    if full_range:
        assert a.min() == -128 and f.min() == -128


@pytest.mark.parametrize("k,r", [(200, 128), (256, 100), (0, 128)])
def test_spmv_mxu_refuses_untiled_shapes(k, r):
    a = torch.zeros((k, k), dtype=torch.int8)
    f = torch.zeros((k, r), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 128"):
        ops.multi_source_spmv(a, f)


def cin_operands(rng, b, f0, fl, h, d):
    """x0, xl ~ N(0, 1) and w at the model's init scale sqrt(1 / (F0 Fl))."""
    return (rng.normal(size=(b, f0, d)).astype(np.float32),
            rng.normal(size=(b, fl, d)).astype(np.float32),
            (rng.normal(size=(h, f0, fl)) * np.sqrt(1.0 / (f0 * fl))).astype(np.float32))


@pytest.mark.parametrize("b,f0,fl,h,d", [
    (128, 8, 8, 16, 4), (256, 12, 20, 8, 10), (128, 39, 16, 8, 10),
    (64, 39, 200, 200, 10)])
def test_cin_layer_plain_matches_jax(b, f0, fl, h, d):
    # fp32 sums in another order than XLA's: rtol = atol = 2e-4, the
    # tolerance of the JAX package's own kernel test
    rng = np.random.default_rng(b + f0 + fl)
    x0, xl, w = cin_operands(rng, b, f0, fl, h, d)
    want = np.asarray(jax_ops.cin_layer(jnp.asarray(x0), jnp.asarray(xl), jnp.asarray(w)))
    got = ops.cin_layer(torch.from_numpy(x0), torch.from_numpy(xl), torch.from_numpy(w))
    assert got.shape == (b, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    plain = ref.cin_layer_ref(torch.from_numpy(x0), torch.from_numpy(xl), torch.from_numpy(w))
    np.testing.assert_allclose(plain.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("wrapper", ["spmv_mxu", "cin_layer"])
def test_new_kernel_wrappers_refuse_cpu_tensors(wrapper):
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        if wrapper == "spmv_mxu":
            spmv_mxu.spmv_mxu(torch.zeros((128, 128), dtype=torch.int8),
                              torch.zeros((128, 128), dtype=torch.int8))
        else:
            cin.cin_layer(torch.zeros((4, 3, 2)), torch.zeros((4, 5, 2)),
                          torch.zeros((6, 3, 5)))
    assert ops.launch_counts() == before
    assert set(before) == {"frontier_update", "core_spmv", "spmv_mxu", "cin_layer"}
