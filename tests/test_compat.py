"""Compat layer vs golden vectors: bit-compatible with the reference C,
INCLUDING the quirky modes the modern API deviates on."""
import numpy as np
import pytest

import cfftpack_jax.compat as cc

GOLD = np.load(__file__.rsplit("/", 1)[0] + "/golden/golden.npz")
TOL = 1e-12


def _t(n):
    return TOL * max(1.0, n)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 16, 32, 60, 101])
@pytest.mark.parametrize("ortho", [False, True])
def test_fft_compat(n, ortho):
    f = cc.fft_create(n)
    cc.fft_ortho(f, ortho)
    x = GOLD[f"fft_in_{n}"]
    sfx = "_ortho" if ortho else ""
    np.testing.assert_allclose(np.asarray(f.forward(x)),
                               GOLD[f"fft_fwd_{n}{sfx}"], atol=_t(n))
    np.testing.assert_allclose(np.asarray(f.inverse(x)),
                               GOLD[f"fft_inv_{n}{sfx}"], atol=_t(n) * n)


@pytest.mark.parametrize("lm", [(4, 4), (8, 6), (6, 10)])
def test_fft2_compat(lm):
    l, m = lm
    f = cc.fft2_create(l, m)
    x = GOLD[f"fft2_in_{l}x{m}"]
    np.testing.assert_allclose(np.asarray(f.forward(x)),
                               GOLD[f"fft2_fwd_{l}x{m}"], atol=_t(l * m))
    np.testing.assert_allclose(np.asarray(f.inverse(x)),
                               GOLD[f"fft2_inv_{l}x{m}"], atol=_t(l * m) * 60)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 16, 32, 60, 101])
@pytest.mark.parametrize("ortho", [False, True])
def test_rfft_compat(n, ortho):
    """Exact reference packing; ortho toggle IGNORED like the reference."""
    f = cc.rfft_create(n)
    cc.fft_ortho(f, ortho)
    x = GOLD[f"rfft_in_{n}"]
    sfx = "_ortho" if ortho else ""
    spec = np.asarray(f.forward(x))
    np.testing.assert_allclose(spec, GOLD[f"rfft_fwd_{n}{sfx}"], atol=_t(n))
    back = np.asarray(f.inverse(spec))
    np.testing.assert_allclose(back, x, atol=_t(n))


_FAMS_1D = [
    ("dct", cc.dct_create, (2, 3, 4, 5, 8, 16, 32, 60)),
    ("dct1", cc.dct1_create, (2, 3, 4, 5, 8, 16, 32, 60)),
    ("dst", cc.dst_create, (2, 3, 4, 5, 8, 16, 32, 60)),
    ("dst1", cc.dst1_create, (2, 3, 4, 5, 8, 16, 32, 60)),
    ("dct4", cc.dct4_create, (2, 4, 8, 16, 32, 60)),
    ("dst4", cc.dst4_create, (2, 4, 8, 16, 32, 60)),
    ("dct5", cc.dct5_create, (2, 3, 5, 8, 13)),
    ("dct8", cc.dct8_create, (2, 3, 5, 8, 13)),
    ("dst5", cc.dst5_create, (2, 3, 5, 8, 13)),
    ("dst8", cc.dst8_create, (2, 3, 5, 8, 13)),
]


@pytest.mark.parametrize("fam,create,sizes", _FAMS_1D)
@pytest.mark.parametrize("ortho", [False, True])
def test_real_families_compat(fam, create, sizes, ortho):
    for n in sizes:
        f = create(n)
        cc.fft_ortho(f, ortho)
        x = GOLD[f"{fam}_in_{n}"]
        sfx = "_ortho" if ortho else ""
        np.testing.assert_allclose(np.asarray(f.forward(x)),
                                   GOLD[f"{fam}_fwd_{n}{sfx}"],
                                   atol=_t(n), err_msg=f"{fam} fwd n={n}")
        if f"{fam}_inv_{n}{sfx}" in GOLD:
            np.testing.assert_allclose(np.asarray(f.inverse(x)),
                                       GOLD[f"{fam}_inv_{n}{sfx}"],
                                       atol=_t(n) * n,
                                       err_msg=f"{fam} inv n={n}")


_TRANSFORM_FAMS = [
    ("dct6", cc.dct6_create), ("dct7", cc.dct7_create),
    ("dst6", cc.dst6_create), ("dst7", cc.dst7_create),
]


@pytest.mark.parametrize("fam,create", _TRANSFORM_FAMS)
@pytest.mark.parametrize("ortho", [False, True])
def test_transform_families_compat(fam, create, ortho):
    for n in (2, 3, 5, 8, 13):
        f = create(n)
        cc.fft_ortho(f, ortho)
        x = GOLD[f"{fam}_in_{n}"]
        sfx = "_ortho" if ortho else ""
        np.testing.assert_allclose(np.asarray(f.transform(x)),
                                   GOLD[f"{fam}_fwd_{n}{sfx}"],
                                   atol=_t(n), err_msg=f"{fam} n={n}")


@pytest.mark.parametrize("mn", [(4, 4), (8, 6), (6, 10)])
def test_dct2d_compat(mn):
    M, N = mn
    f = cc.dct_2d_create(M, N)
    x = GOLD[f"dct2d_in_{M}x{N}"]
    np.testing.assert_allclose(np.asarray(f.forward(x)),
                               GOLD[f"dct2d_fwd_{M}x{N}"], atol=_t(M * N))
    np.testing.assert_allclose(np.asarray(f.inverse(x)),
                               GOLD[f"dct2d_inv_{M}x{N}"], atol=_t(M * N))


@pytest.mark.parametrize("n", [4, 8, 16, 60])
@pytest.mark.parametrize("ab", [(0.0, 0.0), (0.5, 0.0), (0.0, 0.5),
                                (0.5, 0.5), (0.25, 0.1)])
def test_gdft_compat_forward(n, ab):
    a, b = ab
    f = cc.gdft_create(n, a, b)
    key = f"{n}_{a}_{b}"
    x = GOLD[f"gdft_in_{key}"]
    np.testing.assert_allclose(np.asarray(f.forward(x)),
                               GOLD[f"gdft_fwd_{key}"], atol=_t(n))
    # inverse is the FIXED one: must round-trip (reference's does not)
    back = np.asarray(f.inverse(f.forward(x)))
    np.testing.assert_allclose(back, x, atol=_t(n))


def test_shift_compat():
    for n in (8, 15):
        x = GOLD[f"shift_in_{n}"]
        np.testing.assert_array_equal(np.asarray(cc.fftshift(x)),
                                      GOLD[f"fftshift_{n}"])
        np.testing.assert_array_equal(np.asarray(cc.ifftshift(x)),
                                      GOLD[f"ifftshift_{n}"])


def test_create_validation():
    with pytest.raises(ValueError):
        cc.fft_create(0)
    with pytest.raises(ValueError):
        cc.dct1_create(1)
    with pytest.raises(ValueError):
        cc.dct4_create(5)   # even only
    with pytest.raises(ValueError):
        cc.gdft_create(8, 1.5, 0.0)
    f = cc.fft_create(8)
    with pytest.raises(ValueError):
        f.forward(np.ones(9, dtype=np.complex128))
    cc.fft_free(f)  # no-op, must not raise


def test_fft_stride_column_walk():
    """fft_stride (round-5: the last stubbed API) — the reference's own
    use case: naive_real_2d's column walk (naivepack.c:269-288) strides
    the second-axis transform through a flat column-major buffer.
    Equivalence: strided forward == forward(gathered view) scattered
    back, and the 2-D composition matches fft2."""
    import numpy as np
    from cfftpack_jax import compat as cp
    import cfftpack_jax as ct
    r = np.random.default_rng(81)
    m, n = 8, 6
    x = (r.standard_normal((m, n)) + 1j * r.standard_normal((m, n)))
    # column-major flat buffer like the C harness: y[i + j*m] = x[i, j]
    y = np.asarray(x).flatten(order="F").astype(np.complex128)
    fm = cp.fft_create(m)
    fn = cp.fft_create(n)
    cp.fft_stride(fn, m)
    # rows of the buffer = contiguous length-m columns of x
    for j in range(n):
        y[j * m:(j + 1) * m] = np.asarray(fm.forward(y[j * m:(j + 1) * m]))
    # strided pass: offset i, stride m — the reference's second loop
    for i in range(m):
        seg = y[i: i + (n - 1) * m + 1]
        y[i: i + (n - 1) * m + 1] = np.asarray(fn.forward(seg))
    got = y.reshape((m, n), order="F")
    want = np.asarray(ct.fft2(x))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12
    # gap elements untouched by a strided call
    f3 = cp.fft_create(3)
    cp.fft_stride(f3, 2)
    buf = np.arange(6, dtype=np.complex128)
    out = np.asarray(f3.forward(buf))
    assert np.allclose(out[1::2], buf[1::2])     # gaps preserved
    view = np.asarray(cp.fft_create(3).forward(buf[0:5:2]))
    assert np.allclose(out[0:5:2], view)
    # reset semantics + error on short buffers
    cp.fft_stride(f3, 0)
    assert f3.inc == 1
    cp.fft_stride(f3, 4)
    try:
        f3.forward(np.zeros(5, np.complex128))
        raise AssertionError("short strided buffer accepted")
    except ValueError:
        pass
