"""Generate golden parity vectors from the reference C library.

Builds nothing itself: expects the reference (mounted read-only at
/root/reference) compiled once into a shared object, e.g.

    gcc -O2 -fPIC -shared -I/root/reference/cfftpack \
        /root/reference/cfftpack/fftpack.c \
        /root/reference/cfftpack/cfftpack.c \
        /root/reference/cfftpack/cfftextra.c -lm -o /tmp/refbuild/libcfftref.so
    python tools/make_golden.py /tmp/refbuild/libcfftref.so

Writes tests/golden/golden.npz: for every public transform of the
reference (fft, fft2, rfft, dct, dct1, dct4, dst, dst1, dst4, dct5-8,
dst5-8, gdft, dct_2d, fftshift/ifftshift), deterministic inputs and the
reference outputs in default and (where supported) orthonormal scaling.
These are DATA produced by running the reference, used as the parity
oracle demanded by the north star ("forward outputs <=1e-12 f64 vs
reference C"); no reference code is copied.
"""
from __future__ import annotations

import ctypes
import sys

import numpy as np

LIB = sys.argv[1] if len(sys.argv) > 1 else "/tmp/refbuild/libcfftref.so"
OUT = sys.argv[2] if len(sys.argv) > 2 else "tests/golden/golden.npz"

lib = ctypes.CDLL(LIB)
lib.fft_create.restype = ctypes.c_void_p
for name in ("fft2_create dct_create dct1_create dst_create dst1_create "
             "rfft_create dct4_create dst4_create dct_2d_create gdft_create "
             "dct5_create dct6_create dct7_create dct8_create dst5_create "
             "dst6_create dst7_create dst8_create").split():
    getattr(lib, name).restype = ctypes.c_void_p
lib.gdft_create.argtypes = [ctypes.c_int, ctypes.c_double, ctypes.c_double]
lib.fft2_create.argtypes = [ctypes.c_int, ctypes.c_int]
lib.dct_2d_create.argtypes = [ctypes.c_int, ctypes.c_int]
lib.fft_ortho.argtypes = [ctypes.c_void_p, ctypes.c_bool]
lib.fft_free.argtypes = [ctypes.c_void_p]


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def run_inplace(create_args, fwd_name, inv_name, x, ortho, create_name):
    """Run reference forward and inverse in-place on copies of x.

    The buffer passed to the reference is over-allocated by 8 entries:
    some reference transforms write one slot past the user array
    (dst5_inverse writes n+1 outputs into an n-length array,
    cfftextra.c:787-790) — a reference bug we must not inherit.
    """
    f = getattr(lib, create_name)(*create_args)
    assert f, f"{create_name}{create_args} returned NULL"
    if ortho:
        lib.fft_ortho(ctypes.c_void_p(f), True)
    outs = {}
    for tag, fn in (("fwd", fwd_name), ("inv", inv_name)):
        if fn is None:
            continue
        flat = x.ravel()
        d = np.concatenate([flat, np.zeros(8, dtype=x.dtype)])
        rc = getattr(lib, fn)(ctypes.c_void_p(f), _ptr(d))
        assert rc == 0, f"{fn} rc={rc}"
        outs[tag] = d[: flat.size].reshape(x.shape).copy()
    lib.fft_free(ctypes.c_void_p(f))
    return outs


def main():
    rng = np.random.default_rng(20170814)
    g = {}

    def save(key, arr):
        g[key] = np.asarray(arr)

    # ---- complex fft ----
    for n in (1, 2, 3, 4, 5, 8, 16, 32, 60, 101, 960, 1000, 1024, 1250):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        save(f"fft_in_{n}", x)
        for ortho in (False, True):
            o = run_inplace((n,), "fft_forward", "fft_inverse",
                            x.copy(), ortho, "fft_create")
            sfx = "_ortho" if ortho else ""
            save(f"fft_fwd_{n}{sfx}", o["fwd"])
            save(f"fft_inv_{n}{sfx}", o["inv"])

    # ---- fft2: fortran c(l, m) == numpy row-major (m, l) ----
    for (l, m) in ((4, 4), (8, 6), (6, 10)):
        x = (rng.standard_normal((m, l)) + 1j * rng.standard_normal((m, l)))
        save(f"fft2_in_{l}x{m}", x)
        o = run_inplace((l, m), "fft2_forward", "fft2_inverse",
                        x.copy(), False, "fft2_create")
        save(f"fft2_fwd_{l}x{m}", o["fwd"])
        save(f"fft2_inv_{l}x{m}", o["inv"])

    # ---- rfft (separate in/out buffers) ----
    lib.rfft_forward.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.rfft_inverse.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p]
    for n in (2, 3, 4, 5, 8, 16, 32, 60, 101, 960, 1000, 1024, 1250):
        x = rng.standard_normal(n)
        save(f"rfft_in_{n}", x)
        for ortho in (False, True):
            f = lib.rfft_create(n)
            if ortho:
                lib.fft_ortho(ctypes.c_void_p(f), True)
            xin = x.copy()  # hold refs: ctypes pointers don't keep arrays alive
            spec = np.zeros(n // 2 + 1, dtype=np.complex128)
            rc = lib.rfft_forward(ctypes.c_void_p(f), _ptr(xin), _ptr(spec))
            assert rc == 0
            sin_ = spec.copy()
            back = np.zeros(n)
            rc = lib.rfft_inverse(ctypes.c_void_p(f), _ptr(sin_), _ptr(back))
            assert rc == 0
            lib.fft_free(ctypes.c_void_p(f))
            sfx = "_ortho" if ortho else ""
            save(f"rfft_fwd_{n}{sfx}", spec)
            save(f"rfft_roundtrip_{n}{sfx}", back)

    # ---- real 1-D families, in-place ----
    fams = [
        ("dct", "dct_forward", "dct_inverse",
         (2, 3, 4, 5, 8, 16, 32, 60, 960, 1000, 1250), True),
        ("dct1", "dct1_forward", "dct1_inverse",
         (2, 3, 4, 5, 8, 16, 32, 60, 961, 1000), True),
        ("dst", "dst_forward", "dst_inverse",
         (2, 3, 4, 5, 8, 16, 32, 60, 960, 1000, 1250), True),
        ("dst1", "dst1_forward", "dst1_inverse",
         (2, 3, 4, 5, 8, 16, 32, 60, 959, 999), True),
        ("dct4", "dct4_forward", "dct4_inverse",
         (2, 4, 8, 16, 32, 60, 960, 1000, 1250), True),
        ("dst4", "dst4_forward", "dst4_inverse",
         (2, 4, 8, 16, 32, 60, 960, 1000, 1250), True),
        ("dct5", "dct5_forward", "dct5_inverse", (2, 3, 4, 5, 8, 13), True),
        ("dct6", "dct6_transform", None, (2, 3, 4, 5, 8, 13), True),
        ("dct7", "dct7_transform", None, (2, 3, 4, 5, 8, 13), True),
        ("dct8", "dct8_forward", "dct8_inverse", (2, 3, 4, 5, 8, 13), True),
        ("dst5", "dst5_forward", "dst5_inverse", (2, 3, 4, 5, 8, 13), True),
        ("dst6", "dst6_transform", None, (2, 3, 4, 5, 8, 13), True),
        ("dst7", "dst7_transform", None, (2, 3, 4, 5, 8, 13), True),
        ("dst8", "dst8_forward", "dst8_inverse", (2, 3, 4, 5, 8, 13), True),
    ]
    for fam, fwd, inv, sizes, has_ortho in fams:
        for n in sizes:
            x = rng.standard_normal(n)
            save(f"{fam}_in_{n}", x)
            for ortho in ((False, True) if has_ortho else (False,)):
                o = run_inplace((n,), fwd, inv, x.copy(), ortho,
                                f"{fam}_create")
                sfx = "_ortho" if ortho else ""
                save(f"{fam}_fwd_{n}{sfx}", o["fwd"])
                if inv is not None:
                    save(f"{fam}_inv_{n}{sfx}", o["inv"])

    # ---- gdft ----
    for n in (4, 8, 16, 60, 960):
        for (a, b) in ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (0.5, 0.5),
                       (0.25, 0.1)):
            x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
            key = f"{n}_{a}_{b}"
            save(f"gdft_in_{key}", x)
            f = lib.gdft_create(n, a, b)
            assert f
            d = x.copy()
            assert lib.gdft_forward(ctypes.c_void_p(f), _ptr(d)) == 0
            save(f"gdft_fwd_{key}", d)
            d2 = x.copy()
            assert lib.gdft_inverse(ctypes.c_void_p(f), _ptr(d2)) == 0
            save(f"gdft_inv_{key}", d2)
            lib.fft_free(ctypes.c_void_p(f))

    # ---- dct_2d: despite the header comment (cfftextra.h:138-139), the
    # implementation treats the buffer as N rows x M cols row-major
    # (verified empirically against per-axis 1-D transforms) ----
    for (M, N) in ((4, 4), (8, 6), (6, 10), (64, 48)):
        x = rng.standard_normal((N, M))
        save(f"dct2d_in_{M}x{N}", x)
        o = run_inplace((M, N), "dct_2d_forward", "dct_2d_inverse",
                        x.copy(), False, "dct_2d_create")
        save(f"dct2d_fwd_{M}x{N}", o["fwd"])
        save(f"dct2d_inv_{M}x{N}", o["inv"])

    # ---- shifts (complex, even + odd) ----
    lib.fftshift.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ifftshift.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for n in (8, 15):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        save(f"shift_in_{n}", x)
        d = x.copy()
        lib.fftshift(_ptr(d), n)
        save(f"fftshift_{n}", d)
        d = x.copy()
        lib.ifftshift(_ptr(d), n)
        save(f"ifftshift_{n}", d)

    # ---- fast sizes ----
    ns = np.arange(1, 2000)
    lib.fft_next_fast_size.restype = ctypes.c_int
    for fn in ("fft_next_fast_size", "fft_next_fast_even_size",
               "fft_next_fast_size_2nm1", "fft_next_fast_size_2np1"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.c_int]
        save(fn, np.array([getattr(lib, fn)(int(v)) for v in ns]))

    import os
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **g)
    print(f"wrote {OUT}: {len(g)} arrays")


if __name__ == "__main__":
    main()
