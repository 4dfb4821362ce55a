"""DCT/DST I-IV: oracle parity, round-trips, batching, dtypes.

Mirrors the reference strategy (testall.c:61-266): forward vs naive
oracle, round-trip back to input, default + ortho scaling, mixed-radix
sizes including 60 = 4*3*5.
"""
import numpy as np
import pytest

from cfftpack_jax.ops.dct import dct, idct, dst, idst
import oracles as O

SIZES = [2, 3, 4, 5, 8, 15, 16, 32, 60, 101]
TOL = 1e-11


def rng_real(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("n", SIZES)
def test_dct_forward_oracles(n):
    x = rng_real((n,), seed=n)
    np.testing.assert_allclose(np.asarray(dct(x, 1)), O.naive_dct1(x, 1),
                               atol=TOL)
    np.testing.assert_allclose(np.asarray(dct(x, 3)), O.naive_dct3(x),
                               atol=TOL)
    np.testing.assert_allclose(np.asarray(idct(x, 3)), O.naive_dct2(x),
                               atol=TOL)
    np.testing.assert_allclose(np.asarray(dct(x, 4)), O.naive_dct4(x, 1),
                               atol=TOL)


@pytest.mark.parametrize("n", SIZES)
def test_dst_forward_oracles(n):
    x = rng_real((n,), seed=n + 1)
    np.testing.assert_allclose(np.asarray(dst(x, 1)), O.naive_dst1(x, 1),
                               atol=TOL)
    np.testing.assert_allclose(np.asarray(dst(x, 3)), O.naive_dst3(x),
                               atol=TOL)
    np.testing.assert_allclose(np.asarray(idst(x, 3)), O.naive_dst2(x),
                               atol=TOL)
    np.testing.assert_allclose(np.asarray(dst(x, 4)), O.naive_dst4(x, 1),
                               atol=TOL)


@pytest.mark.parametrize("n", SIZES)
def test_ortho_oracles(n):
    x = rng_real((n,), seed=n + 2)
    np.testing.assert_allclose(np.asarray(dct(x, 1, norm="ortho")),
                               O.naive_dct1(x, 0), atol=TOL)
    np.testing.assert_allclose(np.asarray(dct(x, 2, norm="ortho")),
                               O.naive_dct2(x, ortho=True), atol=TOL)
    np.testing.assert_allclose(np.asarray(dct(x, 3, norm="ortho")),
                               O.naive_dct3(x, ortho=True), atol=TOL)
    np.testing.assert_allclose(np.asarray(dct(x, 4, norm="ortho")),
                               O.naive_dct4(x, 0), atol=TOL)
    np.testing.assert_allclose(np.asarray(dst(x, 1, norm="ortho")),
                               O.naive_dst1(x, 0), atol=TOL)
    np.testing.assert_allclose(np.asarray(dst(x, 4, norm="ortho")),
                               O.naive_dst4(x, 0), atol=TOL)


@pytest.mark.parametrize("n", SIZES)
def test_ortho_dst23_true_orthonormal(n):
    """Modern API uses TRUE orthonormal DST-II/III (norm-preserving),
    unlike the reference's quirk of scaling index 0 (naivepack.c:163-180
    scales y[0] where the special DST-II row is the last one).  The
    reference behavior lives in the compat layer."""
    x = rng_real((n,), seed=n + 3)
    k = np.arange(n)
    S2 = np.sin(np.pi * np.outer(k + 1.0, k + 0.5) / n)
    D2o = S2.copy()
    D2o[: n - 1] *= np.sqrt(2.0 / n)
    D2o[n - 1] *= np.sqrt(1.0 / n)
    np.testing.assert_allclose(np.asarray(dst(x, 2, norm="ortho")), D2o @ x,
                               atol=TOL)
    np.testing.assert_allclose(np.asarray(dst(x, 3, norm="ortho")), D2o.T @ x,
                               atol=TOL)
    # norm preservation
    assert abs(np.linalg.norm(np.asarray(dst(x, 2, norm="ortho")))
               - np.linalg.norm(x)) < TOL * n


@pytest.mark.parametrize("n", [2, 4, 15, 32, 60, 101])
@pytest.mark.parametrize("t", [1, 2, 3, 4])
@pytest.mark.parametrize("norm", ["fftpack", "ortho", "backward"])
def test_roundtrips(n, t, norm):
    x = rng_real((n,), seed=7)
    np.testing.assert_allclose(
        np.asarray(idct(dct(x, t, norm=norm), t, norm=norm)), x, atol=TOL)
    np.testing.assert_allclose(
        np.asarray(idst(dst(x, t, norm=norm), t, norm=norm)), x, atol=TOL)


def test_batched_and_axis():
    x = rng_real((3, 5, 32), seed=11)
    np.testing.assert_allclose(np.asarray(dct(x, 3)), O.naive_dct3(x),
                               atol=TOL)
    got = np.asarray(dct(x, 2, axis=1))
    want = np.moveaxis(np.asarray(dct(np.moveaxis(x, 1, -1), 2)), -1, 1)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_float32():
    x = rng_real((64,), seed=13).astype(np.float32)
    got = np.asarray(dct(x, 2, norm="ortho"))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, O.naive_dct2(x, ortho=True), atol=2e-4)


def test_rejects_complex_and_bad_type():
    with pytest.raises(TypeError):
        dct(np.ones(8, dtype=np.complex128))
    with pytest.raises(ValueError):
        dct(np.ones(8), type=9)
    with pytest.raises(ValueError):
        dct(np.ones(1), type=1)  # DCT-I needs n >= 2


def test_grad_flows():
    import jax
    x = rng_real((16,), seed=17)

    def loss(v):
        import jax.numpy as jnp
        return jnp.sum(dct(v, 2, norm="ortho") ** 2)

    g = jax.grad(loss)(x)
    # ortho DCT is an isometry: grad of ||Dx||^2 is 2x
    np.testing.assert_allclose(np.asarray(g), 2 * x, atol=1e-10)


@pytest.mark.parametrize("n", [2, 6, 10, 514, 1022])
def test_dct3_fused_mod2_sizes(n):
    """n % 4 == 2 runs the generalized fused DCT-III path (equal-length
    interleave streams + tail slice); pin against scipy ortho and the
    fftpack round-trip."""
    import scipy.fft as sf
    x = rng_real((3, n), seed=n)
    got = np.asarray(dct(x, 3, norm="ortho"))
    np.testing.assert_allclose(got, sf.dct(x, 3, norm="ortho", axis=-1),
                               atol=1e-12 * max(1, n ** 0.5))
    rt = np.asarray(idct(dct(x, 3), 3))
    np.testing.assert_allclose(rt, x, atol=1e-12 * max(1, n ** 0.5))
