"""Complex FFT parity vs naive O(n^2) oracle + round-trip properties.

Mirrors the reference test strategy (testall.c): oracle comparison at
1e-13-ish (f64) / 1e-4 (f32) absolute tolerance, round-trip back to the
input, both default (FFTPACK) and orthonormal scaling, mixed-radix sizes
including 60 = 4*3*5 plus the BASELINE.json sizes 960/1000/1250 and
prime/odd lengths the reference handles via its generic radix.
"""
import numpy as np
import pytest

import cfftpack_jax as ct
from oracles import naive_fft, naive_ifft

SIZES = [1, 2, 3, 4, 5, 6, 8, 15, 16, 25, 32, 49, 60, 101, 120, 210, 243,
         256, 960, 1000, 1024, 1250]

F64_TOL = 1e-12
F32_TOL = 2e-4


def rng_complex(shape, seed=0):
    r = np.random.default_rng(seed)
    return r.standard_normal(shape) + 1j * r.standard_normal(shape)


@pytest.mark.parametrize("n", SIZES)
def test_fft_matches_naive_f64(n):
    x = rng_complex((n,), seed=n)
    got = np.asarray(ct.fft(x))
    want = naive_fft(x)
    np.testing.assert_allclose(got, want, atol=F64_TOL * max(1, n ** 0.5))


@pytest.mark.parametrize("n", SIZES)
def test_ifft_matches_naive_f64(n):
    x = rng_complex((n,), seed=n + 1)
    got = np.asarray(ct.ifft(x))
    want = naive_ifft(x)
    np.testing.assert_allclose(got, want, atol=F64_TOL * max(1, n))


@pytest.mark.parametrize("n", SIZES)
def test_roundtrip_fftpack_norm(n):
    x = rng_complex((n,), seed=n + 2)
    y = np.asarray(ct.ifft(ct.fft(x)))
    np.testing.assert_allclose(y, x, atol=F64_TOL * max(1, n ** 0.5))


@pytest.mark.parametrize("n", [2, 32, 60, 101, 1000])
@pytest.mark.parametrize("norm", ["fftpack", "ortho", "backward", "forward"])
def test_roundtrip_all_norms(n, norm):
    x = rng_complex((n,), seed=7)
    y = np.asarray(ct.ifft(ct.fft(x, norm=norm), norm=norm))
    np.testing.assert_allclose(y, x, atol=F64_TOL * max(1, n ** 0.5))


def test_ortho_matches_naive():
    x = rng_complex((60,), seed=3)
    np.testing.assert_allclose(
        np.asarray(ct.fft(x, norm="ortho")), naive_fft(x, ortho=True),
        atol=F64_TOL * 8)
    np.testing.assert_allclose(
        np.asarray(ct.ifft(x, norm="ortho")), naive_ifft(x, ortho=True),
        atol=F64_TOL * 8)


def test_batched_and_axis():
    x = rng_complex((3, 5, 64), seed=11)
    got = np.asarray(ct.fft(x))
    want = naive_fft(x)
    np.testing.assert_allclose(got, want, atol=F64_TOL * 8)
    # middle axis
    got_ax = np.asarray(ct.fft(x, axis=1))
    want_ax = np.moveaxis(naive_fft(np.moveaxis(x, 1, -1)), -1, 1)
    np.testing.assert_allclose(got_ax, want_ax, atol=F64_TOL * 8)


def test_fft2_matches_naive():
    x = rng_complex((8, 6), seed=13)
    got = np.asarray(ct.fft2(x))
    want = naive_fft(naive_fft(x).swapaxes(-1, -2)).swapaxes(-1, -2)
    np.testing.assert_allclose(got, want, atol=F64_TOL * 8)
    rt = np.asarray(ct.ifft2(ct.fft2(x)))
    np.testing.assert_allclose(rt, x, atol=F64_TOL * 8)


def test_fftn_roundtrip():
    x = rng_complex((4, 6, 10), seed=17)
    rt = np.asarray(ct.ifftn(ct.fftn(x)))
    np.testing.assert_allclose(rt, x, atol=F64_TOL * 8)


@pytest.mark.parametrize("n", [32, 60, 101, 1000])
def test_complex64_path(n):
    x = rng_complex((n,), seed=n).astype(np.complex64)
    got = np.asarray(ct.fft(x))
    assert got.dtype == np.complex64
    want = naive_fft(x)
    np.testing.assert_allclose(got, want, atol=F32_TOL)


def test_real_input_promoted():
    x = np.random.default_rng(0).standard_normal(32)
    got = np.asarray(ct.fft(x))
    np.testing.assert_allclose(got, naive_fft(x), atol=F64_TOL * 8)


def test_jit_and_vmap_compose():
    import jax
    x = rng_complex((4, 64), seed=23)
    f = jax.jit(lambda a: ct.fft(a))
    got = np.asarray(f(x))
    np.testing.assert_allclose(got, naive_fft(x), atol=F64_TOL * 8)
    got_v = np.asarray(jax.vmap(lambda a: ct.fft(a))(x))
    np.testing.assert_allclose(got_v, got, atol=0)


def test_grad_flows():
    import jax
    x = np.random.default_rng(1).standard_normal(16)

    def loss(v):
        import jax.numpy as jnp
        return jnp.sum(jnp.abs(ct.fft(v)) ** 2)

    g = jax.grad(loss)(x)
    assert np.all(np.isfinite(np.asarray(g)))


@pytest.mark.parametrize("n", [8192, 12288, 10000])
def test_local_fourstep_matches_numpy(n):
    """Large n routes through the in-core four-step decomposition
    (core._fourstep_local); parity vs numpy in f64 pins the twiddle
    and digit-reversal order."""
    from cfftpack_jax.ops import core
    assert core._fourstep_split_n(n) is not None
    r = np.random.default_rng(5)
    x = r.standard_normal(n) + 1j * r.standard_normal(n)
    got = np.asarray(ct.fft(x))
    want = np.fft.fft(x) / n
    np.testing.assert_allclose(got, want, atol=1e-11)
    back = np.asarray(ct.ifft(ct.fft(x)))
    np.testing.assert_allclose(back, x, atol=1e-11)


def test_local_fourstep_large_bluestein_roundtrip():
    """Bluestein's internal length-m transforms also route through the
    four-step for large m; round-trip at a large prime n."""
    r = np.random.default_rng(6)
    n = 8209   # prime > _FOURSTEP_MIN
    x = r.standard_normal(n) + 1j * r.standard_normal(n)
    got = np.asarray(ct.fft(x))
    want = np.fft.fft(x) / n
    np.testing.assert_allclose(got, want, atol=1e-10)


@pytest.mark.parametrize("kind", ["mapflat", "mapfour"])
def test_chunked_batch_dispatch_matches_numpy(kind, monkeypatch):
    """The big-working-set tiers of core._fft_any (sequential lax.map
    over batch chunks) must be
    bit-for-bit row-wise equal to the mathematically identical unchunked
    engine.  Thresholds are patched down so the tiers trigger at
    CPU-test sizes."""
    from cfftpack_jax.ops import core
    monkeypatch.setattr(core, "_BIG_ELEMS", 1 << 12)
    if kind == "mapfour":
        monkeypatch.setattr(core, "_MAPFOUR_MIN_N", 1024)
        b, n = 32, 1024          # -> lax.map four-step, bc=32
    else:
        b, n = 256, 64           # -> lax.map flat, bc=128
    x = rng_complex((b, n), seed=7)
    got = np.asarray(ct.fft(x))
    want = np.fft.fft(x, axis=-1) / n
    np.testing.assert_allclose(got, want, atol=1e-11)
    back = np.asarray(ct.ifft(ct.fft(x)))
    np.testing.assert_allclose(back, x, atol=1e-11)


def test_fft2_split_matches_fft2():
    """fft2_split/ifft2_split agree with fft2 bin-for-bin, incl. odd axis-0,
    batch dims, non-default axes and norms."""
    x = rng_complex((3, 7, 12), seed=23).astype(np.complex64)
    for norm in ("fftpack", "ortho"):
        yr, yi = ct.fft2_split(x.real, x.imag, norm=norm)
        want = np.asarray(ct.fft2(x, norm=norm))
        got = np.asarray(yr) + 1j * np.asarray(yi)
        np.testing.assert_allclose(got, want, atol=F32_TOL)
        zr, zi = ct.ifft2_split(yr, yi, norm=norm)
        np.testing.assert_allclose(np.asarray(zr) + 1j * np.asarray(zi),
                                   x, atol=F32_TOL)
    # non-trailing axes
    yr, yi = ct.fft2_split(x.real, x.imag, axes=(0, -1))
    want = np.asarray(ct.fft2(x, axes=(0, -1)))
    np.testing.assert_allclose(np.asarray(yr) + 1j * np.asarray(yi),
                               want, atol=F32_TOL)


def test_bluestein_stream_pad(monkeypatch):
    """Bluestein pad selection: any valid 5-smooth convolution pad
    m >= 2n-1 (plan.bluestein_tables(n, m)) gives the same transform as
    the default smallest pad."""
    import jax.numpy as jnp
    from cfftpack_jax import plan
    from cfftpack_jax.ops import core

    with pytest.raises(ValueError):
        plan.bluestein_tables(101, 150)   # not 5-smooth / too small
    with pytest.raises(ValueError):
        plan.bluestein_tables(101, 200)   # < 2n-1

    n = 101
    x = rng_complex((3, n), seed=5)
    xr = jnp.asarray(x.real)
    xi = jnp.asarray(x.imag)
    want = naive_fft(x) * n          # core._bluestein is unscaled
    tables = plan.bluestein_tables
    for m in (None, 256, 2048):
        if m is not None:
            monkeypatch.setattr(plan, "bluestein_tables",
                                lambda n_, m=m: tables(n_, m))
        assert plan.bluestein_tables(n)[0] == (m or 216)
        yr, yi = core._bluestein(xr, xi, n, False)
        got = np.asarray(yr) + 1j * np.asarray(yi)
        np.testing.assert_allclose(got, want, atol=F64_TOL * 64 * n)
