"""Native C++ planner: build it, then verify parity with the pure-
Python planning layer (factor/fast sizes/twiddles/chirp)."""
import numpy as np
import pytest

from cfftpack_jax.native import build as native_build
from cfftpack_jax import plan


@pytest.fixture(scope="module")
def nat():
    try:
        native_build.build(verbose=False)
    except Exception as e:  # toolchain missing -> skip, fallbacks cover
        pytest.skip(f"native build unavailable: {e}")
    import importlib
    from cfftpack_jax.native import planner
    importlib.reload(planner)  # re-probe the freshly built library
    if not planner.available():
        pytest.skip("libplancore.so did not load")
    return planner


@pytest.mark.parametrize("n", [1, 2, 12, 60, 101, 960, 1024, 7 * 11 * 13,
                               104729])
def test_factor_parity(nat, n):
    assert tuple(nat.factor(n)) == plan._factor_py(n)


def test_fast_sizes_parity(nat):
    for n in list(range(1, 300)) + [1000, 4097, 65537]:
        assert nat.next_fast_size(n) == plan.fft_next_fast_size(n)
        assert nat.next_fast_even_size(n) == plan.fft_next_fast_even_size(n)
        assert nat.next_fast_size_2nm1(n) == plan.fft_next_fast_size_2nm1(n)
        assert nat.next_fast_size_2np1(n) == plan.fft_next_fast_size_2np1(n)


def test_max_prime_factor(nat):
    assert nat.max_prime_factor(1) == 1
    assert nat.max_prime_factor(2 ** 10) == 2
    assert nat.max_prime_factor(60) == 5
    assert nat.max_prime_factor(101) == 101
    assert nat.max_prime_factor(2 * 3 * 104729) == 104729


@pytest.mark.parametrize("n", [8, 60, 960, 1024])
def test_stage_twiddles_parity(nat, n):
    got = nat.stage_twiddles_flat(n)
    want = np.concatenate([t.ravel() for t in plan.stage_twiddles(n)])
    np.testing.assert_allclose(got, want, atol=1e-15)


@pytest.mark.parametrize("n", [5, 101, 1000])
def test_bluestein_chirp_parity(nat, n):
    got = nat.bluestein_chirp(n)
    _, chirp, _ = plan.bluestein_tables(n)
    np.testing.assert_allclose(got, chirp, atol=1e-14)
