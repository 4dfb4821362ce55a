"""f64 routing: under the opt-in config.set_f64_policy("hp"), double
inputs to the MAIN dtype API run on the double-float engine (ops/hp.py)
and come back as host numpy arrays at the reference's C-double
tolerance (fftpack.h:59-64); the default "native" policy computes in f64.
"""
import numpy as np
import pytest

import cfftpack_jax as ct
from cfftpack_jax import config
from cfftpack_jax.ops import hp

from oracles import naive_fft


@pytest.fixture
def hp_policy():
    config.set_f64_policy("hp")
    try:
        yield
    finally:
        config.set_f64_policy("native")


rng = np.random.default_rng(20260818)


def test_policy_validation():
    with pytest.raises(ValueError):
        config.set_f64_policy("bogus")
    assert config.f64_policy() == "native"


def test_no_route_on_cpu_backend():
    # default policy: f64 input runs the native x64 path (jnp out)
    x = rng.standard_normal((2, 8)) + 1j * rng.standard_normal((2, 8))
    y = ct.fft(x)
    assert not isinstance(y, np.ndarray)  # jax array, not hp host path


def test_fft_routes_to_hp(hp_policy):
    x = rng.standard_normal((3, 20)) + 1j * rng.standard_normal((3, 20))
    y = ct.fft(x)
    assert isinstance(y, np.ndarray) and y.dtype == np.complex128
    ref = naive_fft(x)
    assert np.max(np.abs(y - ref)) < 1e-13
    back = ct.ifft(y)
    assert np.max(np.abs(back - x)) < 1e-13


def test_fft_axis_routes(hp_policy):
    x = rng.standard_normal((6, 3)) + 1j * rng.standard_normal((6, 3))
    y = ct.fft(x, axis=0)
    ref = np.moveaxis(hp.fft_hp(np.moveaxis(x, 0, -1)), -1, 0)
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-15)


def test_f32_does_not_route(hp_policy):
    # single-precision input keeps the native f32 engine under the hp
    # policy; only doubles route
    assert not config.hp_route(np.zeros(4, np.float32))
    assert not config.hp_route(np.zeros(4, np.complex64))
    assert config.hp_route(np.zeros(4, np.float64))
    assert config.hp_route(np.zeros(4, np.complex128))
    assert config.hp_route([0.0, 1.0])       # python floats -> f64


def test_native_policy_escape(hp_policy):
    config.set_f64_policy("native")
    try:
        assert not config.hp_route(np.zeros(4, np.float64))
        assert not isinstance(ct.fft(np.zeros(4, np.complex128)),
                              np.ndarray)
    finally:
        config.set_f64_policy("hp")
    assert config.hp_route(np.zeros(4, np.float64))


def test_fftn_routes_2d_and_general(hp_policy):
    x = rng.standard_normal((2, 4, 6)) + 1j * rng.standard_normal((2, 4, 6))
    y = ct.fftn(x, axes=(-2, -1))
    ref = hp.fft2_hp(x)
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-15)
    y3 = ct.ifftn(x, axes=(1,))
    ref3 = np.moveaxis(hp.ifft_hp(np.moveaxis(x, 1, -1)), -1, 1)
    np.testing.assert_allclose(y3, ref3, rtol=0, atol=1e-15)


def test_rfft_irfft_route(hp_policy):
    for n in (16, 9):
        x = rng.standard_normal((4, n))
        y = ct.rfft(x)
        assert isinstance(y, np.ndarray) and y.dtype == np.complex128
        ref = np.fft.rfft(x) / n
        assert np.max(np.abs(y - ref)) < 1e-13
        back = ct.irfft(y, n)
        assert np.max(np.abs(back - x)) < 1e-13


def test_rfft2_route(hp_policy):
    x = rng.standard_normal((5, 8))
    y = ct.rfft2(x)
    assert isinstance(y, np.ndarray)
    ref = hp.rfft2_hp(x)
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-15)
    back = ct.irfft2(y, (5, 8))
    assert np.max(np.abs(back - x)) < 1e-13
    # non-default axes
    x3 = rng.standard_normal((6, 2, 4))
    y3 = ct.rfft2(x3, axes=(0, -1))
    ref3 = np.moveaxis(hp.rfft2_hp(np.moveaxis(x3, 0, -2)), -2, 0)
    np.testing.assert_allclose(y3, ref3, rtol=0, atol=1e-15)
    back3 = ct.irfft2(y3, (6, 4), axes=(0, -1))
    assert np.max(np.abs(back3 - x3)) < 1e-13


def test_dct_dst_route(hp_policy):
    x = rng.standard_normal((3, 10))
    for t in (1, 2, 4, 6):
        y = ct.dct(x, type=t)
        assert isinstance(y, np.ndarray) and y.dtype == np.float64
        ref = hp.dct_hp(x, type=t)
        np.testing.assert_allclose(y, ref, rtol=0, atol=1e-15)
        assert np.max(np.abs(ct.idct(y, type=t) - x)) < 1e-12
    y = ct.dst(x, type=2, axis=0)
    ref = np.moveaxis(hp.dst_hp(np.moveaxis(x, 0, -1), type=2), -1, 0)
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-15)
    assert np.max(np.abs(ct.idst(y, type=2, axis=0) - x)) < 1e-12


def test_dctn_route(hp_policy):
    x = rng.standard_normal((4, 6))
    y = ct.dctn(x, type=3, axes=(-2, -1))
    assert isinstance(y, np.ndarray)
    np.testing.assert_allclose(
        y, hp.dctn_hp(x, type=3, axes=(-2, -1)), rtol=0, atol=1e-15)
    back = ct.idctn(y, type=3, axes=(-2, -1))
    assert np.max(np.abs(back - x)) < 1e-12
    ys = ct.dstn(x, type=2)
    np.testing.assert_allclose(ys, hp.dstn_hp(x, type=2),
                               rtol=0, atol=1e-15)
    assert np.max(np.abs(ct.idstn(ys, type=2) - x)) < 1e-12


def test_gdft_route(hp_policy):
    x = rng.standard_normal((2, 12)) + 1j * rng.standard_normal((2, 12))
    y = ct.gdft(x, a=0.5, b=0.25)
    assert isinstance(y, np.ndarray) and y.dtype == np.complex128
    np.testing.assert_allclose(y, hp.gdft_hp(x, a=0.5, b=0.25),
                               rtol=0, atol=1e-15)
    back = ct.igdft(y, a=0.5, b=0.25)
    assert np.max(np.abs(back - x)) < 1e-13


def test_compat_plans_route(hp_policy):
    """The reference-compatible plan API routes f64 too — its _check
    must NOT jnp.asarray-truncate doubles before the ops layer sees
    the dtype (compat._host_or_device)."""
    from cfftpack_jax import compat as cp
    p = cp.fft_create(24)
    x = rng.standard_normal(24) + 1j * rng.standard_normal(24)
    y = cp.fft_forward(p, x)
    assert isinstance(y, np.ndarray) and y.dtype == np.complex128
    assert np.max(np.abs(cp.fft_inverse(p, y) - x)) < 1e-13
    cp.fft_ortho(p, True)           # reference's stacked-scale quirk
    y2 = cp.fft_forward(p, x)
    assert np.max(np.abs(y2 - np.fft.fft(x) / 24 / np.sqrt(24))) < 1e-13
    pr = cp.rfft_create(16)
    v = rng.standard_normal(16)
    s = pr.forward(v)               # 2*conj packing applied on host
    assert isinstance(s, np.ndarray)
    assert np.max(np.abs(pr.inverse(s) - v)) < 1e-13
    p2 = cp.dct_2d_create(6, 8)
    img = rng.standard_normal((8, 6))
    f2 = p2.forward(img)
    assert isinstance(f2, np.ndarray)
    assert np.max(np.abs(p2.inverse(f2) - img)) < 1e-12
    pg = cp.gdft_create(15, 0.5, 0.25)
    z = rng.standard_normal(15) + 1j * rng.standard_normal(15)
    yg = pg.forward(z)
    assert isinstance(yg, np.ndarray)
    assert np.max(np.abs(pg.inverse(yg) - z)) < 1e-13


def test_shift_and_convolve_route(hp_policy):
    """fftshift/circular_convolve keep f64 on host under routing —
    jnp.asarray would silently truncate before the engine dispatch."""
    x = rng.standard_normal(9)
    y = ct.fftshift(x)
    assert isinstance(y, np.ndarray) and y.dtype == np.float64
    np.testing.assert_array_equal(y, np.fft.fftshift(x))
    np.testing.assert_array_equal(ct.ifftshift(y), x)
    a = rng.standard_normal(12)
    b = rng.standard_normal(12)
    c = ct.circular_convolve(a, b)
    assert isinstance(c, np.ndarray)
    ref = np.real(np.fft.ifft(np.fft.fft(a) * np.fft.fft(b)))
    assert np.max(np.abs(c - ref)) < 1e-12
    z = a + 1j * b
    cz = ct.circular_convolve(z, z)
    refz = np.fft.ifft(np.fft.fft(z) ** 2)
    assert np.max(np.abs(cz - refz)) < 1e-12
