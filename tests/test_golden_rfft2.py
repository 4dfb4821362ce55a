"""Parity of rfft2/irfft2 vs the reference 2-D real FFT core.

golden_rfft2.npz holds raw packed in-place outputs of the reference's
``rfft2f_``/``rfft2b_`` (fftpack.c:13113-13445), generated by
tools/make_golden_rfft2.py (layout documented there).  This pins the one
transform family that round 1 validated only against a numpy oracle —
including the reference's Nyquist-row and sign fixups.
"""
import numpy as np
import pytest

import cfftpack_jax as ct

GOLD = np.load(__file__.rsplit("/", 1)[0] + "/golden/golden_rfft2.npz")

SIZES = [(4, 4), (5, 4), (4, 5), (5, 5), (6, 10), (8, 6),
         (31, 30), (30, 31), (60, 48)]


def _decode_packed(P, l, m):
    """rfft2f_ packed (l, m) real array -> full (l, m) complex spectrum.

    Layout (verified against the running reference during generation):
    row 0 and (even l) row l-1 are rfft-packed along m; rows 2k-1, 2k
    are re/im of complex row k; remaining rows by conjugate symmetry.
    """
    F = np.zeros((l, m), dtype=np.complex128)

    def unpack_row(r):
        row = np.zeros(m, dtype=np.complex128)
        row[0] = r[0]
        for k in range(1, (m - 1) // 2 + 1):
            row[k] = r[2 * k - 1] + 1j * r[2 * k]
            row[m - k] = np.conj(row[k])
        if m % 2 == 0:
            row[m // 2] = r[m - 1]
        return row

    F[0] = unpack_row(P[0])
    for k in range(1, (l + 1) // 2):
        F[k] = P[2 * k - 1] + 1j * P[2 * k]
    if l % 2 == 0:
        F[l // 2] = unpack_row(P[l - 1])
    for k in range(1, (l + 1) // 2):
        F[l - k, 0] = np.conj(F[k, 0])
        F[l - k, 1:] = np.conj(F[k, 1:][::-1])
    return F


@pytest.mark.parametrize("lm", SIZES)
def test_rfft2_forward_golden(lm):
    l, m = lm
    x = GOLD[f"rfft2_in_{l}x{m}"]
    F = _decode_packed(GOLD[f"rfft2_fwd_{l}x{m}"], l, m)
    # ours: r2c over the LAST axis -> feed x.T so the real axis is l,
    # matching the reference's stride-1 real dimension
    mine = np.asarray(ct.rfft2(x.T))            # (m, l//2 + 1)
    np.testing.assert_allclose(mine, F[: l // 2 + 1, :].T,
                               atol=1e-12 * max(l, m))


@pytest.mark.parametrize("lm", SIZES)
def test_irfft2_roundtrip_golden(lm):
    l, m = lm
    x = GOLD[f"rfft2_in_{l}x{m}"]
    # reference's own roundtrip is the identity (rfft2b_ undoes rfft2f_)
    np.testing.assert_allclose(GOLD[f"rfft2_rt_{l}x{m}"], x, atol=1e-12)
    # our inverse applied to the DECODED REFERENCE spectrum returns x:
    # pins irfft2's scaling + packing against reference data, not just
    # against our own forward
    F = _decode_packed(GOLD[f"rfft2_fwd_{l}x{m}"], l, m)
    spec = F[: l // 2 + 1, :].T
    back = np.asarray(ct.irfft2(spec, (m, l)))
    np.testing.assert_allclose(back, x.T, atol=1e-12 * max(l, m))
