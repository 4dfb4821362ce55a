"""Generate golden vectors for the reference 2-D REAL FFT core.

The reference's L2 wrapper never exposes rfft2, but the core routines
``rfft2i_``/``rfft2f_``/``rfft2b_`` are exported from fftpack.c
(/root/reference/cfftpack/fftpack.c:13113-13516).  This tool calls them
directly via ctypes and commits their raw packed in-place outputs, so
cfftpack_jax.rfft2/irfft2 can be pinned against the running C core —
including the Nyquist-row and sign fixups (fftpack.c:13357-13371,
13388-13396, 13419-13431) that a numpy-style oracle cannot witness.

Build only fftpack.c (no wrapper patches needed):

    gcc -O2 -fPIC -shared -I/root/reference/cfftpack \
        /root/reference/cfftpack/fftpack.c -lm -o /tmp/refbuild/libfftpackonly.so
    python tools/make_golden_rfft2.py

Packed layout produced by rfft2f_ for an (l, m) Fortran array r(l, m)
(l = stride-1 "real" axis, m = complex axis), determined empirically and
asserted against the full DFT during generation:

    row 0       : rfft-packed along m: [c0, re1, im1, ..., (c_{m/2})]
    rows 2k-1,2k: re/im of full complex row k, k = 1..ceil(l/2)-1
    row l-1     : (l even) Nyquist row, rfft-packed along m

with forward normalization 1/(l*m); rfft2b_ is the unscaled inverse
(roundtrip returns l*m*x... no: rfft2b_(rfft2f_(x)) == x, both saved).
Outputs are DATA from running the reference; no code is copied.
"""
from __future__ import annotations

import ctypes
import math
import os
import sys

import numpy as np

LIB = sys.argv[1] if len(sys.argv) > 1 else "/tmp/refbuild/libfftpackonly.so"
OUT = sys.argv[2] if len(sys.argv) > 2 else "tests/golden/golden_rfft2.npz"

lib = ctypes.CDLL(LIB)


def _ip(v: int):
    return ctypes.byref(ctypes.c_int(v))


def _workspaces(l: int, m: int):
    lw = l + int(math.log(l) / math.log(2.0)) + 4
    mw = 2 * m + int(math.log(m) / math.log(2.0)) + 4
    mm = m + int(math.log(m) / math.log(2.0)) + 4
    lensav = lw + mw + mm
    wsave = np.zeros(lensav)
    ier = ctypes.c_int(0)
    lib.rfft2i_(_ip(l), _ip(m), wsave.ctypes.data_as(ctypes.c_void_p),
                _ip(lensav), ctypes.byref(ier))
    assert ier.value == 0, f"rfft2i_ ier={ier.value}"
    lenwrk = (l + 1) * m
    return wsave, lensav, np.zeros(lenwrk), lenwrk


def _run(name: str, l: int, m: int, r_f: np.ndarray, wsave, lensav,
         work, lenwrk) -> np.ndarray:
    r = np.asfortranarray(r_f.astype(np.float64))
    ier = ctypes.c_int(0)
    getattr(lib, name)(_ip(l), _ip(l), _ip(m),
                       r.ctypes.data_as(ctypes.c_void_p),
                       wsave.ctypes.data_as(ctypes.c_void_p), _ip(lensav),
                       work.ctypes.data_as(ctypes.c_void_p), _ip(lenwrk),
                       ctypes.byref(ier))
    assert ier.value == 0, f"{name} ier={ier.value}"
    return np.ascontiguousarray(r)


def decode_packed(P: np.ndarray, l: int, m: int) -> np.ndarray:
    """Packed rfft2f_ output -> full (l, m) complex spectrum."""
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


def main():
    rng = np.random.default_rng(20260817)
    g = {}
    sizes = [(4, 4), (5, 4), (4, 5), (5, 5), (6, 10), (8, 6),
             (31, 30), (30, 31), (60, 48)]
    for (l, m) in sizes:
        wsave, lensav, work, lenwrk = _workspaces(l, m)
        x = rng.standard_normal((l, m))
        fwd = _run("rfft2f_", l, m, x, wsave, lensav, work, lenwrk)
        back = _run("rfft2b_", l, m, fwd, wsave, lensav, work, lenwrk)
        # generation-time sanity: decoded packed == scaled full DFT,
        # and the reference's own roundtrip is the identity
        F = decode_packed(fwd, l, m)
        ref = np.fft.fft2(x) / (l * m)
        assert np.abs(F - ref).max() < 1e-12, (l, m, np.abs(F - ref).max())
        assert np.abs(back - x).max() < 1e-12, (l, m)
        key = f"{l}x{m}"
        g[f"rfft2_in_{key}"] = x
        g[f"rfft2_fwd_{key}"] = fwd
        g[f"rfft2_rt_{key}"] = back
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **g)
    print(f"wrote {OUT}: {len(g)} arrays")


if __name__ == "__main__":
    main()
