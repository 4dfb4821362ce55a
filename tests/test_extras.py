"""Extras: GDFT, shifts, odd DCT/DST V-VIII, N-D DCT — golden parity.

Reference-quirk deviations (documented in the modules):
 * reference gdft_inverse is broken for time-shift != 0 (unconjugated
   final ramp, cfftextra.c:474-478) — ours is the true inverse.
 * reference's ortho dct7 is base/(2*sqrt(M)) which does NOT invert its
   ortho dct6 (composition = Id/2) — ours keeps the invertible pair.
"""
import numpy as np
import pytest

import cfftpack_jax as ct
from oracles import naive_gdft

GOLD = np.load(__file__.rsplit("/", 1)[0] + "/golden/golden.npz")
TOL = 1e-12


def rng_complex(shape, seed=0):
    r = np.random.default_rng(seed)
    return r.standard_normal(shape) + 1j * r.standard_normal(shape)


@pytest.mark.parametrize("n", [4, 8, 16, 60, 960])
@pytest.mark.parametrize("ab", [(0.0, 0.0), (0.5, 0.0), (0.0, 0.5),
                                (0.5, 0.5), (0.25, 0.1)])
def test_gdft_golden_forward(n, ab):
    """ref gdft_forward(a_ref,b_ref) == gdft(x, a=b_ref, b=a_ref)/... with
    fftpack 1/n scaling."""
    a_ref, b_ref = ab
    key = f"{n}_{a_ref}_{b_ref}"
    x = GOLD[f"gdft_in_{key}"]
    got = np.asarray(ct.gdft(x, a=b_ref, b=a_ref))  # fftpack norm: 1/n
    np.testing.assert_allclose(got, GOLD[f"gdft_fwd_{key}"],
                               atol=TOL * max(1, n ** 0.5))


@pytest.mark.parametrize("n", [4, 8, 60, 101])
@pytest.mark.parametrize("ab", [(0.0, 0.0), (0.5, 0.5), (0.25, 0.7)])
@pytest.mark.parametrize("norm", ["fftpack", "ortho", "backward"])
def test_gdft_roundtrip_and_oracle(n, ab, norm):
    a, b = ab
    x = rng_complex((n,), seed=n)
    y = ct.gdft(x, a=a, b=b, norm=norm)
    back = np.asarray(ct.igdft(y, a=a, b=b, norm=norm))
    np.testing.assert_allclose(back, x, atol=TOL * max(1, n))
    if norm == "backward":  # unscaled forward == naive definition
        np.testing.assert_allclose(np.asarray(y), naive_gdft(x, a=a, c=b),
                                   atol=TOL * n)


def test_gdft_reduces_to_fft():
    x = rng_complex((32,), seed=1)
    np.testing.assert_allclose(np.asarray(ct.gdft(x)), np.asarray(ct.fft(x)),
                               atol=1e-14)


@pytest.mark.parametrize("n", [8, 15])
def test_shift_golden(n):
    x = GOLD[f"shift_in_{n}"]
    np.testing.assert_array_equal(np.asarray(ct.fftshift(x)),
                                  GOLD[f"fftshift_{n}"])
    np.testing.assert_array_equal(np.asarray(ct.ifftshift(x)),
                                  GOLD[f"ifftshift_{n}"])
    # round-trip, including odd length where the two differ
    np.testing.assert_array_equal(
        np.asarray(ct.ifftshift(ct.fftshift(x))), x)


def test_shift_2d_axes():
    x = rng_complex((6, 15), seed=2)
    np.testing.assert_array_equal(np.asarray(ct.fftshift(x)),
                                  np.fft.fftshift(x))
    np.testing.assert_array_equal(np.asarray(ct.fftshift(x, axes=1)),
                                  np.fft.fftshift(x, axes=1))
    np.testing.assert_array_equal(np.asarray(ct.ifftshift(x, axes=(0,))),
                                  np.fft.ifftshift(x, axes=(0,)))


_ODD_FAMS = [("dct5", 5, True), ("dct6", 6, False), ("dct7", 7, False),
             ("dct8", 8, True), ("dst5", 5, True), ("dst6", 6, False),
             ("dst7", 7, False), ("dst8", 8, True)]


@pytest.mark.parametrize("fam,t,has_inv", _ODD_FAMS)
@pytest.mark.parametrize("n", [2, 3, 5, 8, 13])
def test_odd_types_golden(fam, t, has_inv, n):
    x = GOLD[f"{fam}_in_{n}"]
    is_dct = fam.startswith("dct")
    fwd = ct.dct if is_dct else ct.dst
    inv = ct.idct if is_dct else ct.idst
    np.testing.assert_allclose(np.asarray(fwd(x, t)), GOLD[f"{fam}_fwd_{n}"],
                               atol=TOL * n)
    if has_inv:
        np.testing.assert_allclose(np.asarray(inv(x, t)),
                                   GOLD[f"{fam}_inv_{n}"], atol=TOL * n * n)
    if fam != "dct7":  # reference ortho dct7 quirk — see module docstring
        np.testing.assert_allclose(np.asarray(fwd(x, t, norm="ortho")),
                                   GOLD[f"{fam}_fwd_{n}_ortho"],
                                   atol=TOL * n)


@pytest.mark.parametrize("t", [5, 6, 7, 8])
@pytest.mark.parametrize("n", [2, 5, 13, 31])
@pytest.mark.parametrize("norm", ["fftpack", "ortho"])
def test_odd_types_roundtrip(t, n, norm):
    x = np.random.default_rng(n).standard_normal(n)
    np.testing.assert_allclose(
        np.asarray(ct.idct(ct.dct(x, t, norm=norm), t, norm=norm)), x,
        atol=TOL * n * 10)
    np.testing.assert_allclose(
        np.asarray(ct.idst(ct.dst(x, t, norm=norm), t, norm=norm)), x,
        atol=TOL * n * 10)


@pytest.mark.parametrize("mn", [(4, 4), (8, 6), (6, 10), (64, 48)])
def test_dct2d_golden(mn):
    """reference dct_2d == dctn(type=3) forward / idctn(type=3) inverse."""
    M, N = mn
    x = GOLD[f"dct2d_in_{M}x{N}"]
    np.testing.assert_allclose(np.asarray(ct.dctn(x, 3)),
                               GOLD[f"dct2d_fwd_{M}x{N}"], atol=TOL * M * N)
    np.testing.assert_allclose(np.asarray(ct.idctn(x, 3)),
                               GOLD[f"dct2d_inv_{M}x{N}"], atol=TOL * M * N)


def test_dctn_dstn_roundtrip():
    x = np.random.default_rng(0).standard_normal((4, 6, 8))
    for t in (1, 2, 3, 4):
        np.testing.assert_allclose(
            np.asarray(ct.idctn(ct.dctn(x, t), t)), x, atol=1e-11)
        np.testing.assert_allclose(
            np.asarray(ct.idstn(ct.dstn(x, t), t)), x, atol=1e-11)
    # axis subsets
    np.testing.assert_allclose(
        np.asarray(ct.idctn(ct.dctn(x, 2, axes=(1, 2)), 2, axes=(1, 2))), x,
        atol=1e-11)


def test_gdft_batched():
    x = rng_complex((3, 16), seed=5)
    got = np.asarray(ct.gdft(x, a=0.5, b=0.25, norm="backward"))
    want = naive_gdft(x, a=0.5, c=0.25)
    np.testing.assert_allclose(got, want, atol=1e-12)
