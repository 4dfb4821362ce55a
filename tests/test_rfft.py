"""Real FFT parity vs naive oracle + round-trip, packed-layout checks.

Mirrors the reference strategy (testall.c tolerances; rfft packed layout
from cfftpack.c:433-494).
"""
import numpy as np
import pytest

import cfftpack_jax as ct
from oracles import naive_rfft

SIZES = [1, 2, 3, 4, 5, 6, 8, 15, 16, 25, 32, 49, 60, 101, 120, 243, 256,
         960, 1000, 1024, 1250]

F64_TOL = 1e-12


def rng_real(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("n", SIZES)
def test_rfft_matches_naive(n):
    x = rng_real((n,), seed=n)
    got = np.asarray(ct.rfft(x))
    want = naive_rfft(x)
    assert got.shape == (n // 2 + 1,)
    np.testing.assert_allclose(got, want, atol=F64_TOL * max(1, n ** 0.5))


@pytest.mark.parametrize("n", SIZES)
def test_rfft_roundtrip(n):
    x = rng_real((n,), seed=n + 1)
    y = ct.rfft(x)
    back = np.asarray(ct.irfft(y, n))
    np.testing.assert_allclose(back, x, atol=F64_TOL * max(1, n ** 0.5))


@pytest.mark.parametrize("n", [2, 32, 60, 101, 1000])
@pytest.mark.parametrize("norm", ["fftpack", "ortho", "backward"])
def test_rfft_roundtrip_norms(n, norm):
    x = rng_real((n,), seed=5)
    back = np.asarray(ct.irfft(ct.rfft(x, norm=norm), n, norm=norm))
    np.testing.assert_allclose(back, x, atol=F64_TOL * max(1, n ** 0.5))


def test_rfft_packed_layout_exact_zeros():
    for n in (16, 17):
        y = np.asarray(ct.rfft(rng_real((n,), seed=n)))
        assert y[0].imag == 0.0
        if n % 2 == 0:
            assert y[-1].imag == 0.0


def test_rfft_batched():
    x = rng_real((4, 7, 64), seed=2)
    got = np.asarray(ct.rfft(x))
    want = naive_rfft(x)
    np.testing.assert_allclose(got, want, atol=F64_TOL * 8)


def test_rfft_middle_axis():
    x = rng_real((3, 32, 5), seed=9)
    got = np.asarray(ct.rfft(x, axis=1))
    want = np.moveaxis(naive_rfft(np.moveaxis(x, 1, -1)), -1, 1)
    np.testing.assert_allclose(got, want, atol=F64_TOL * 8)
    back = np.asarray(ct.irfft(ct.rfft(x, axis=1), 32, axis=1))
    np.testing.assert_allclose(back, x, atol=F64_TOL * 8)


def test_rfft_float32():
    x = rng_real((256,), seed=3).astype(np.float32)
    got = np.asarray(ct.rfft(x))
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, naive_rfft(x), atol=2e-4)
    back = np.asarray(ct.irfft(ct.rfft(x), 256))
    assert back.dtype == np.float32
    np.testing.assert_allclose(back, x, atol=2e-4)


def test_rfft_rejects_complex():
    with pytest.raises(TypeError):
        ct.rfft(np.ones(8, dtype=np.complex128))


def test_irfft_bad_bins():
    with pytest.raises(ValueError):
        ct.irfft(np.ones(5, dtype=np.complex128), 16)


@pytest.mark.parametrize("shape", [(8, 6), (7, 9), (16, 16)])
def test_rfft2_matches_naive(shape):
    from oracles import naive_fft
    x = rng_real(shape, seed=shape[0])
    got = np.asarray(ct.rfft2(x))
    full = naive_fft(naive_fft(x).swapaxes(-1, -2)).swapaxes(-1, -2)
    want = full[..., : shape[1] // 2 + 1]
    np.testing.assert_allclose(got, want, atol=F64_TOL * 8)
    back = np.asarray(ct.irfft2(got, shape))
    np.testing.assert_allclose(back, x, atol=F64_TOL * 8)


def test_rfft_grad_flows():
    import jax

    def loss(v):
        import jax.numpy as jnp
        return jnp.sum(jnp.abs(ct.rfft(v)) ** 2)

    g = jax.grad(loss)(rng_real((32,), seed=4))
    assert np.all(np.isfinite(np.asarray(g)))


# ------------------------------------------------ fused real filter

@pytest.mark.parametrize("n", [2, 8, 16, 60, 61, 1024])
@pytest.mark.parametrize("norm", ["fftpack", "ortho", "backward"])
def test_rfilter_split_matches_composition(n, norm):
    """rfilter_split == irfft(rfft(x) * F) exactly, every norm/parity."""
    r = np.random.default_rng(11)
    x = r.standard_normal((3, n))
    f = r.standard_normal(n)
    yr, yi = ct.rfft_split(f, norm="fftpack")
    sr, si = ct.rfft_split(x, norm=norm)
    tr = sr * yr - si * yi
    ti = sr * yi + si * yr
    want = np.asarray(ct.irfft_split(tr, ti, n, norm=norm))
    got = np.asarray(ct.rfilter_split(x, yr, yi, norm=norm))
    np.testing.assert_allclose(got, want, atol=1e-12 * max(1.0, n))


def test_rfilter_split_axis_and_validation():
    r = np.random.default_rng(12)
    x = r.standard_normal((6, 5))
    f = r.standard_normal(6)
    yr, yi = ct.rfft_split(f)
    got = np.asarray(ct.rfilter_split(x, yr, yi, axis=0))
    want = np.asarray(ct.rfilter_split(x.T, yr, yi)).T
    np.testing.assert_allclose(got, want, atol=1e-12)
    with pytest.raises(ValueError):
        ct.rfilter_split(x, yr[:-1], yi[:-1], axis=0)


@pytest.mark.parametrize("n", [9, 101, 625])
def test_rfft_batchpair_engine(n):
    """Odd n with an even flat batch routes through the batch-pair
    engine (core._srfft_batchpair: one half-batch full-length FFT);
    parity vs the oracle, the packed
    exact-zero contract, and the round-trip must all hold, and the odd
    flat batch fallback must agree with the pair path."""
    from cfftpack_jax.ops import core
    xe = rng_real((6, n), seed=n)       # even batch -> pair engine
    got = np.asarray(ct.rfft(xe))
    np.testing.assert_allclose(got, naive_rfft(xe), atol=F64_TOL * 8)
    assert (got[..., 0].imag == 0.0).all()
    back = np.asarray(ct.irfft(ct.rfft(xe), n))
    np.testing.assert_allclose(back, xe, atol=F64_TOL * max(1, n ** 0.5))
    xo = xe[:5]                         # odd batch -> legacy fallback
    np.testing.assert_allclose(np.asarray(ct.rfft(xo)), got[:5],
                               atol=F64_TOL * 8)
    # the two engines are selected as documented
    assert core._use_pair(n, 6) and not core._use_pair(n, 5)
    assert not core._use_pair(n - 1, 6)   # even n keeps half-length


@pytest.mark.parametrize("idiom", ["stack", "select"])
def test_interleave_idioms_agree(idiom):
    """Both riffle idioms behind core._interleave must produce identical
    transforms (dct4 uses the select idiom at large n)."""
    from cfftpack_jax.ops import core
    x = rng_real((3, 64), seed=7)
    old = core._RIFFLE_IDIOM
    try:
        core._RIFFLE_IDIOM = idiom
        # fresh traces: call through the cores directly (jit caches on
        # the public API would otherwise hide the flag)
        yr, yi = core.srfft(jnp_array(x), 64)
        back = np.asarray(core.sirfft(yr, yi, 64)) / 64.0
        np.testing.assert_allclose(back, x, atol=F64_TOL * 8)
        got2 = np.asarray(core._interleave(jnp_array(x[..., :32]),
                                           jnp_array(x[..., 32:])))
        want2 = np.stack([x[..., :32], x[..., 32:]], axis=-1
                         ).reshape(3, 64)
        np.testing.assert_allclose(got2, want2, rtol=0)
        got4 = np.asarray(core._interleave(
            *(jnp_array(x[..., 16 * i:16 * (i + 1)]) for i in range(4))))
        want4 = np.stack([x[..., 16 * i:16 * (i + 1)] for i in range(4)],
                         axis=-1).reshape(3, 64)
        np.testing.assert_allclose(got4, want4, rtol=0)
    finally:
        core._RIFFLE_IDIOM = old


def jnp_array(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


def test_real_entry_points_reject_complex():
    """Advisor round-2: complex input silently flowed through the real
    engine (promote_types(complex, f32) stays complex) — now a TypeError."""
    z = np.ones((4, 8), dtype=np.complex64)
    with pytest.raises(TypeError, match="real input required"):
        ct.rfft_split(z)
    with pytest.raises(TypeError, match="real input required"):
        ct.irfft_split(z[..., :5], np.zeros((4, 5), np.float32), n=8)
    with pytest.raises(TypeError, match="real input required"):
        ct.rfilter_split(z, np.ones(5, np.float32), np.zeros(5, np.float32))


def test_rfft2_split_matches_rfft2():
    """rfft2_split/irfft2_split agree with
    rfft2 bin-for-bin, incl. odd n1 and both norms."""
    F32_TOL = 2e-4
    for shape in ((6, 8), (5, 9)):
        x = rng_real((2,) + shape, seed=shape[1]).astype(np.float32)
        for norm in ("fftpack", "ortho"):
            yr, yi = ct.rfft2_split(x, norm=norm)
            want = np.asarray(ct.rfft2(x, norm=norm))
            got = np.asarray(yr) + 1j * np.asarray(yi)
            np.testing.assert_allclose(got, want, atol=F32_TOL)
            back = np.asarray(ct.irfft2_split(yr, yi, shape, norm=norm))
            np.testing.assert_allclose(back, x, atol=F32_TOL)


def test_rfft2_split_padded_middle():
    """The ragged-axis pad (ops/rfft._ragged_pad: pad to a multiple of
    128 around the axis-0 complex passes) must be equivalent to the
    unpadded path; forced on here (it is backend-gated off on CPU)."""
    import sys
    R = sys.modules["cfftpack_jax.ops.rfft"]   # attr `rfft` on the
    # package is the FUNCTION re-export; get the real module
    x = rng_real((2, 8, 10), seed=9).astype(np.float32)
    want_r, want_i = ct.rfft2_split(x)
    back_want = np.asarray(ct.irfft2_split(want_r, want_i, (8, 10)))
    orig = R._ragged_pad
    R._ragged_pad = lambda shape, axes, _o=orig: (
        128 if (tuple(a % len(shape) for a in axes)
                == (len(shape) - 2, len(shape) - 1)) else 0)
    try:
        got_r, got_i = R._rfft2_split_core(x, (-2, -1), "fftpack")
        # (XLA:CPU vectorizes the padded batch differently, so
        # f32-tolerance here)
        np.testing.assert_allclose(np.asarray(got_r),
                                   np.asarray(want_r), atol=1e-5)
        np.testing.assert_allclose(np.asarray(got_i),
                                   np.asarray(want_i), atol=1e-5)
        back = np.asarray(R._irfft2_split_core(got_r, got_i, (8, 10),
                                               (-2, -1), "fftpack"))
        np.testing.assert_allclose(back, back_want, atol=1e-5)
        # non-trailing axes must NOT pad (the ragged axis is not in
        # lanes there) and still agree with the reference path
        got_r2, got_i2 = R._rfft2_split_core(
            np.moveaxis(x, 0, -1), (0, 1), "fftpack")
        np.testing.assert_allclose(
            np.asarray(np.moveaxis(got_r2, -1, 0)), np.asarray(want_r),
            atol=2e-4)
    finally:
        R._ragged_pad = orig


def test_bodychunk_dispatch_parity(monkeypatch):
    """Whole-body chunking (core._use_bodychunk, round 5): srfft/sirfft
    and the DCT cores must be bit-close to the unchunked path.  The
    2^24-element threshold is patched down so the gate fires at test
    sizes."""
    import importlib
    import numpy as np
    import jax.numpy as jnp
    from cfftpack_jax.ops import core
    dctmod = importlib.import_module("cfftpack_jax.ops.dct")
    r = np.random.default_rng(91)
    B, n = 2048, 64
    x = r.standard_normal((B, n)).astype(np.float32)
    want_r = np.fft.rfft(x.astype(np.float64))
    want_d2 = np.asarray(dctmod._dct2_core(jnp.asarray(x[:2]), n))
    monkeypatch.setattr(core, "_BIG_ELEMS", 1 << 10)
    assert core._use_bodychunk(n, B)
    yr, yi = core.srfft(jnp.asarray(x), n)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert np.abs(got - want_r).max() / np.abs(want_r).max() < 5e-6
    back = np.asarray(core.sirfft(yr, yi, n)) / n
    assert np.abs(back - x).max() < 5e-5
    d2 = np.asarray(dctmod._dct2_core(jnp.asarray(x), n))
    assert np.abs(d2[:2] - want_d2).max() / np.abs(want_d2).max() < 5e-6
    d3 = np.asarray(dctmod._dct3_core(jnp.asarray(d2), n)) * (2.0 / n)
    assert np.abs(d3 - x).max() < 5e-5
    d4 = np.asarray(dctmod._dct4_core(jnp.asarray(x), n))
    rt4 = np.asarray(dctmod._dct4_core(jnp.asarray(d4), n)) * (2.0 / n)
    assert np.abs(rt4 - x).max() < 5e-5


def test_rfilter_bodychunk_parity(monkeypatch):
    """rfilter_split's whole-body chunk branch must match the fused
    body exactly (threshold patched down)."""
    import numpy as np
    import jax.numpy as jnp
    import cfftpack_jax as ct
    from cfftpack_jax.ops import core
    r = np.random.default_rng(95)
    B, n = 2048, 64
    x = r.standard_normal((B, n)).astype(np.float32)
    h1 = n // 2 + 1
    F = r.standard_normal(h1) + 1j * r.standard_normal(h1)
    F[0] = F[0].real
    F[-1] = F[-1].real
    fr = F.real.astype(np.float32)
    fi = F.imag.astype(np.float32)
    want = np.asarray(ct.rfilter_split(x[:2], fr, fi))
    monkeypatch.setattr(core, "_BIG_ELEMS", 1 << 10)
    got = np.asarray(ct.rfilter_split(x, fr, fi))
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got[:2] - want).max() / scale < 5e-6
