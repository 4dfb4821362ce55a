"""Property sweeps: every length 1..96 plus awkward composites, and
bitwise determinism (BASELINE 'round-trip bit-stable')."""
import numpy as np
import pytest

import cfftpack_jax as ct

AWKWARD = [97, 121, 127, 128, 169, 210, 255, 256, 343, 510, 512, 625,
           675, 899, 961]


@pytest.mark.parametrize("n", list(range(1, 97)) + AWKWARD)
def test_fft_roundtrip_every_length(n):
    r = np.random.default_rng(n)
    x = r.standard_normal(n) + 1j * r.standard_normal(n)
    back = np.asarray(ct.ifft(ct.fft(x)))
    np.testing.assert_allclose(back, x, atol=1e-11 * max(1, n))


@pytest.mark.parametrize("n", [1, 2, 7, 36, 97, 210])
def test_rfft_roundtrip_every_length(n):
    r = np.random.default_rng(n + 1)
    x = r.standard_normal(n)
    back = np.asarray(ct.irfft(ct.rfft(x), n))
    np.testing.assert_allclose(back, x, atol=1e-11 * max(1, n))


def test_parseval_energy():
    """ortho transforms preserve energy (Parseval) for fft and dct2."""
    r = np.random.default_rng(5)
    x = r.standard_normal(210) + 1j * r.standard_normal(210)
    y = np.asarray(ct.fft(x, norm="ortho"))
    np.testing.assert_allclose(np.sum(np.abs(y) ** 2),
                               np.sum(np.abs(x) ** 2), rtol=1e-12)
    v = r.standard_normal(128)
    c = np.asarray(ct.dct(v, 2, norm="ortho"))
    np.testing.assert_allclose(np.sum(c ** 2), np.sum(v ** 2), rtol=1e-12)


def test_linearity_and_shift_theorem():
    r = np.random.default_rng(7)
    n = 60
    x = r.standard_normal(n) + 1j * r.standard_normal(n)
    y = r.standard_normal(n) + 1j * r.standard_normal(n)
    lhs = np.asarray(ct.fft(2.0 * x + 3.0 * y))
    rhs = 2.0 * np.asarray(ct.fft(x)) + 3.0 * np.asarray(ct.fft(y))
    np.testing.assert_allclose(lhs, rhs, atol=1e-13)
    # circular shift <-> phase ramp
    s = 7
    shifted = np.asarray(ct.fft(np.roll(x, s)))
    ramp = np.exp(-2j * np.pi * s * np.arange(n) / n)
    np.testing.assert_allclose(shifted, np.asarray(ct.fft(x)) * ramp,
                               atol=1e-13)


def test_bitwise_determinism():
    """Identical inputs produce identical bits across calls (required
    for reproducible pipelines; races are designed out)."""
    r = np.random.default_rng(9)
    x = r.standard_normal((4, 960)) + 1j * r.standard_normal((4, 960))
    a = np.asarray(ct.fft(x))
    b = np.asarray(ct.fft(x.copy()))
    assert a.tobytes() == b.tobytes()
    v = r.standard_normal((4, 128))
    c1 = np.asarray(ct.dct(v, 2))
    c2 = np.asarray(ct.dct(v.copy(), 2))
    assert c1.tobytes() == c2.tobytes()


def test_impulse_and_constant_signals():
    n = 30
    # impulse -> flat spectrum (1/n with fftpack norm)
    imp = np.zeros(n)
    imp[0] = 1.0
    np.testing.assert_allclose(np.asarray(ct.fft(imp)),
                               np.full(n, 1.0 / n, dtype=complex),
                               atol=1e-14)
    # constant -> delta at DC
    c = np.ones(n)
    spec = np.asarray(ct.fft(c))
    np.testing.assert_allclose(spec[0], 1.0, atol=1e-14)
    np.testing.assert_allclose(spec[1:], 0.0, atol=1e-13)


def test_fuzz_fft_random_shapes_axes():
    """Randomized (seeded) shape/axis/dtype fuzz vs numpy."""
    r = np.random.default_rng(1234)
    for _ in range(25):
        rank = int(r.integers(1, 4))
        shape = tuple(int(r.integers(1, 13)) for _ in range(rank))
        axis = int(r.integers(-rank, rank))
        x = r.standard_normal(shape) + 1j * r.standard_normal(shape)
        got = np.asarray(ct.fft(x, axis=axis))
        want = np.fft.fft(x, axis=axis) / x.shape[axis]
        np.testing.assert_allclose(got, want, atol=1e-12,
                                   err_msg=f"{shape} axis={axis}")


def test_fuzz_rfft_random_shapes():
    r = np.random.default_rng(4321)
    for _ in range(15):
        rank = int(r.integers(1, 3))
        shape = tuple(int(r.integers(1, 40)) for _ in range(rank))
        x = r.standard_normal(shape)
        got = np.asarray(ct.rfft(x))
        want = np.fft.rfft(x) / shape[-1]
        np.testing.assert_allclose(got, want, atol=1e-12, err_msg=str(shape))


def test_huge_prime_bluestein():
    """A large prime length routes through Bluestein with a ~2^18-smooth
    convolution; parity vs numpy at full length."""
    n = 104729  # the 10000th prime
    r = np.random.default_rng(0)
    x = r.standard_normal(n) + 1j * r.standard_normal(n)
    got = np.asarray(ct.fft(x))
    want = np.fft.fft(x) / n
    assert np.abs(got - want).max() < 1e-10


def test_dispatch_gate_boundaries():
    """Pure-shape unit checks of the dispatch gates (no compiles): band
    edges sit where docs/DISPATCH.md puts them."""
    import numpy as np
    from cfftpack_jax.ops import core

    # body chunk: 2^24 elems, 128-divisible batch, >= 2048 rows
    assert core._use_bodychunk(1024, 65536)
    assert not core._use_bodychunk(1024, 65536 - 64)     # % 128
    assert not core._use_bodychunk(65536, 256)           # < 2048 rows
    assert not core._use_bodychunk(1024, 8192)           # < 2^24 elems
    # batch-pair real engine: odd n with an even batch, nothing else
    assert core._use_pair(65537, 4)
    assert not core._use_pair(65537, 3)                  # odd batch
    assert not core._use_pair(65536, 256)                # even n
    assert not core._use_pair(1, 4)
    # four-step split: n1 closest to 64 in [8, 256] with n2 >= 128
    assert core._fourstep_split_n(1 << 20) == (64, 1 << 14)
    assert core._fourstep_split_n(8192) == (64, 128)
    assert core._fourstep_split_n(4099) is None          # prime
