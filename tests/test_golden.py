"""Bit-level parity vs golden vectors produced by the reference C library.

tests/golden/golden.npz is generated by tools/make_golden.py running the
actual reference (FFTPACK 5.1 + cfftpack wrapper) — the strongest oracle
we have (<=1e-12 f64 vs reference C).  Default and ortho
scaling modes for every 1-D family, plus fft2 and fast-size tables.

Reference-quirk deviations (documented, reproduced only in compat):
 * fft "ortho": reference forward = F/n^1.5, inverse = B*sqrt(n)
   (the 1/sqrt(n) rescale is applied on top of the already-1/n-scaled
   cfft1f_, cfftpack.c:69-77) — not orthonormal; modern API uses 1/sqrt(n).
 * rfft ignores fft_ortho entirely (no ortho branch in rfft_forward,
   cfftpack.c:454-480).
 * rfft packing: reference interior bins are 2*conj(X_k) (cos/sin series
   coefficients); modern API uses the standard packed DFT spectrum.
 * dst ortho scales index 0 instead of the Nyquist row (naivepack.c
   naive_dst2/3) — modern API is truly orthonormal.
"""
import numpy as np
import pytest

import cfftpack_jax as ct
from cfftpack_jax.ops.dct import dct, idct, dst, idst

GOLD = np.load(__file__.rsplit("/", 1)[0] + "/golden/golden.npz")
TOL = 1e-12


def _tol(n):
    return TOL * max(1.0, n ** 0.5)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 16, 32, 60, 101,
                               960, 1000, 1024, 1250])
def test_fft_golden(n):
    x = GOLD[f"fft_in_{n}"]
    np.testing.assert_allclose(np.asarray(ct.fft(x)), GOLD[f"fft_fwd_{n}"],
                               atol=_tol(n))
    np.testing.assert_allclose(np.asarray(ct.ifft(x)), GOLD[f"fft_inv_{n}"],
                               atol=_tol(n) * n)


@pytest.mark.parametrize("lm", [(4, 4), (8, 6), (6, 10)])
def test_fft2_golden(lm):
    l, m = lm
    x = GOLD[f"fft2_in_{l}x{m}"]
    np.testing.assert_allclose(np.asarray(ct.fft2(x)),
                               GOLD[f"fft2_fwd_{l}x{m}"], atol=_tol(l * m))
    np.testing.assert_allclose(np.asarray(ct.ifft2(x)),
                               GOLD[f"fft2_inv_{l}x{m}"],
                               atol=_tol(l * m) * l * m)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 16, 32, 60, 101,
                               960, 1000, 1024, 1250])
def test_rfft_golden(n):
    """Reference packing: bin0 and Nyquist match; interior = 2*conj."""
    x = GOLD[f"rfft_in_{n}"]
    mine = np.asarray(ct.rfft(x))
    ref = GOLD[f"rfft_fwd_{n}"]
    np.testing.assert_allclose(mine[0], ref[0], atol=_tol(n))
    if n % 2 == 0:
        np.testing.assert_allclose(mine[-1], ref[-1], atol=_tol(n))
    hi = n // 2 + (0 if n % 2 == 0 else 1)
    np.testing.assert_allclose(2 * np.conj(mine[1:hi]), ref[1:hi],
                               atol=_tol(n))
    # reference round-trip of its own spectrum reproduces the input
    np.testing.assert_allclose(GOLD[f"rfft_roundtrip_{n}"], x, atol=_tol(n))


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 16, 32, 60, 960, 1000,
                               1250])
def test_dct_pair_golden(n):
    x = GOLD[f"dct_in_{n}"]
    np.testing.assert_allclose(np.asarray(dct(x, 3)), GOLD[f"dct_fwd_{n}"],
                               atol=_tol(n))
    np.testing.assert_allclose(np.asarray(idct(x, 3)), GOLD[f"dct_inv_{n}"],
                               atol=_tol(n) * n)
    np.testing.assert_allclose(np.asarray(dct(x, 3, norm="ortho")),
                               GOLD[f"dct_fwd_{n}_ortho"], atol=_tol(n))
    np.testing.assert_allclose(np.asarray(idct(x, 3, norm="ortho")),
                               GOLD[f"dct_inv_{n}_ortho"], atol=_tol(n) * n)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 16, 32, 60, 961, 1000])
def test_dct1_golden(n):
    x = GOLD[f"dct1_in_{n}"]
    np.testing.assert_allclose(np.asarray(dct(x, 1)), GOLD[f"dct1_fwd_{n}"],
                               atol=_tol(n))
    np.testing.assert_allclose(np.asarray(idct(x, 1)), GOLD[f"dct1_inv_{n}"],
                               atol=_tol(n) * n)
    np.testing.assert_allclose(np.asarray(dct(x, 1, norm="ortho")),
                               GOLD[f"dct1_fwd_{n}_ortho"], atol=_tol(n) * n)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 16, 32, 60, 960, 1000,
                               1250])
def test_dst_pair_golden(n):
    x = GOLD[f"dst_in_{n}"]
    np.testing.assert_allclose(np.asarray(dst(x, 3)), GOLD[f"dst_fwd_{n}"],
                               atol=_tol(n))
    np.testing.assert_allclose(np.asarray(idst(x, 3)), GOLD[f"dst_inv_{n}"],
                               atol=_tol(n) * n)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 16, 32, 60, 959, 999])
def test_dst1_golden(n):
    x = GOLD[f"dst1_in_{n}"]
    np.testing.assert_allclose(np.asarray(dst(x, 1)), GOLD[f"dst1_fwd_{n}"],
                               atol=_tol(n))
    np.testing.assert_allclose(np.asarray(idst(x, 1)), GOLD[f"dst1_inv_{n}"],
                               atol=_tol(n) * n)
    np.testing.assert_allclose(np.asarray(dst(x, 1, norm="ortho")),
                               GOLD[f"dst1_fwd_{n}_ortho"], atol=_tol(n))


@pytest.mark.parametrize("n", [2, 4, 8, 16, 32, 60, 960, 1000, 1250])
def test_dct4_dst4_golden(n):
    x = GOLD[f"dct4_in_{n}"]
    np.testing.assert_allclose(np.asarray(dct(x, 4)), GOLD[f"dct4_fwd_{n}"],
                               atol=_tol(n))
    np.testing.assert_allclose(np.asarray(idct(x, 4)), GOLD[f"dct4_inv_{n}"],
                               atol=_tol(n) * n)
    np.testing.assert_allclose(np.asarray(dct(x, 4, norm="ortho")),
                               GOLD[f"dct4_fwd_{n}_ortho"], atol=_tol(n))
    y = GOLD[f"dst4_in_{n}"]
    np.testing.assert_allclose(np.asarray(dst(y, 4)), GOLD[f"dst4_fwd_{n}"],
                               atol=_tol(n))
    np.testing.assert_allclose(np.asarray(idst(y, 4)), GOLD[f"dst4_inv_{n}"],
                               atol=_tol(n) * n)
    np.testing.assert_allclose(np.asarray(dst(y, 4, norm="ortho")),
                               GOLD[f"dst4_fwd_{n}_ortho"], atol=_tol(n))


def test_fast_size_tables_golden():
    ns = np.arange(1, 2000)
    got = np.array([ct.fft_next_fast_size(int(v)) for v in ns])
    np.testing.assert_array_equal(got, GOLD["fft_next_fast_size"])
    got = np.array([ct.fft_next_fast_even_size(int(v)) for v in ns])
    np.testing.assert_array_equal(got, GOLD["fft_next_fast_even_size"])
    got = np.array([ct.fft_next_fast_size_2nm1(int(v)) for v in ns])
    np.testing.assert_array_equal(got, GOLD["fft_next_fast_size_2nm1"])
    got = np.array([ct.fft_next_fast_size_2np1(int(v)) for v in ns])
    np.testing.assert_array_equal(got, GOLD["fft_next_fast_size_2np1"])
