"""Finance applications: acceptance tests vs closed forms and the
reference's published anchors (test/vargamma.c:117-119 QuantLib target;
blackscholes.cpp strike table; montecarlo.c QMC variance reduction)."""
import numpy as np
import pytest

from cfftpack_jax.models import (conv_bsvg_option, conv_option_price,
                                 vg_mc_price, asian_option_qmc,
                                 asian_option_qmc_device,
                                 brownian_paths_qmc, bs_cf, vg_cf,
                                 cf_moment_sigma, ShortRateMesh,
                                 callable_bond_demo)
from cfftpack_jax.models.chfun import normal_cf, nig_cf, alpha_stable_cf
from cfftpack_jax.utils import (normal_cdf, normal_icdf, halton, primes,
                                black_scholes_option, brent)

# reference benchmark parameters (vargamma.c:108-121)
S, K, SIGMA, THETA, KAPPA, R, T = 100.0, 98.0, 0.12, -0.14, 0.2, 0.05, 1.0
VG_TARGET = 9.3424659413582116       # QuantLib (vargammaql.cpp)
VG_CONV = 9.342473370823516          # reference conv pricer at N=2^18
# (the comment in vargamma.c:119 claims 9.3424663333837259, but the
#  reference BINARY actually converges to 9.34247337 — verified by
#  compiling and running it; our pricer matches it digit-for-digit)


def test_black_scholes_closed_form():
    c = float(black_scholes_option(S, K, SIGMA, T, R, True))
    p = float(black_scholes_option(S, K, SIGMA, T, R, False))
    # put-call parity
    np.testing.assert_allclose(c - p, S - K * np.exp(-R * T), atol=1e-10)
    assert 8.0 < c < 10.0


def test_conv_pricer_bs_converges_to_closed_form():
    cbs = float(black_scholes_option(S, K, SIGMA, T, R, True))
    prev_err = None
    for n in (1 << 10, 1 << 14, 1 << 16):
        c = conv_bsvg_option(n, S, K, SIGMA, THETA, KAPPA, T, R,
                             is_call=True, is_bs=True)
        err = abs(c - cbs)
        if prev_err is not None:
            assert err <= prev_err * 1.01
        prev_err = err
    assert prev_err < 2e-8


def test_conv_pricer_vg_hits_quantlib_target():
    c = conv_bsvg_option(1 << 16, S, K, SIGMA, THETA, KAPPA, T, R,
                         is_call=True, is_bs=False)
    # the reference binary's convergence differs from QuantLib by 7.4e-6
    assert abs(c - VG_CONV) < 1e-7
    assert abs(c - VG_TARGET) < 1e-5


def test_conv_pricer_strike_ladder_batched():
    """Strike table of blackscholes.cpp:82-108 in ONE batched call."""
    sig, t, r = 0.15, 1.0 / 12.0, 0.03
    strikes = np.arange(85.0, 115.1, 2.5)
    got = conv_option_price(S, strikes, t, r,
                            lambda u: bs_cf(u, t, sig, r),
                            n=8192, grid_sigma=sig, is_call=True)
    want = np.asarray(black_scholes_option(S, strikes, sig, t, r, True))
    # reference prints % error ~1e-5 level at N=8192
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_conv_pricer_put():
    sig, t, r = 0.15, 1.0 / 12.0, 0.03
    got = conv_option_price(S, 100.0, t, r,
                            lambda u: bs_cf(u, t, sig, r),
                            n=8192, grid_sigma=sig, is_call=False)
    want = float(black_scholes_option(S, 100.0, sig, t, r, False))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_normal_icdf_accuracy():
    np.testing.assert_allclose(float(normal_icdf(0.975)),
                               1.959963984540054, atol=1e-9)
    x = np.linspace(-5, 5, 101)
    back = np.asarray(normal_icdf(normal_cdf(x)))
    np.testing.assert_allclose(back, x, atol=1e-8)
    assert np.isinf(float(normal_icdf(0.0)))
    assert np.isinf(float(normal_icdf(1.0)))


def test_primes_and_halton():
    ps = primes(10)
    np.testing.assert_array_equal(ps, [2, 3, 5, 7, 11, 13, 17, 19, 23, 29])
    assert primes(512)[-1] == 3671  # matches the reference's table end
    # radical inverse base 2: 1->0.5, 2->0.25, 3->0.75
    h = halton(np.array([1, 2, 3]), 2)
    np.testing.assert_allclose(h[:, 0], [0.5, 0.25, 0.75])
    np.testing.assert_allclose(h[:, 1], [1 / 3, 2 / 3, 1 / 9])


def test_halton_batch_matches_host():
    """Device radical inverse (digit-parallel broadcast-reduce) == host
    numpy sequence, including across a block boundary and high
    indices."""
    from cfftpack_jax.utils.qmc import halton_batch
    got = np.asarray(halton_batch(100001, 64, 32, dtype="float64"))
    want = halton(np.arange(100001, 100065), 32)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_asian_qmc_device_matches_host_pipeline():
    """The single-program device pricer reproduces the host-setup
    pipeline (and therefore the reference binary's digit-for-digit
    anchors) in f64; f32 agrees to grid accuracy."""
    a = asian_option_qmc(samples=500, run_index=1)
    b = asian_option_qmc_device(samples=500, run_index=1, dtype="float64")
    c = asian_option_qmc_device(samples=500, run_index=1, dtype="float32")
    assert abs(a - b) < 1e-12
    assert abs(a - c) < 2e-3


def test_qmc_paths_are_standard_normal_ish():
    z = np.asarray(brownian_paths_qmc(512, 64))
    assert z.shape == (512, 64)
    assert abs(z.mean()) < 0.05
    assert abs(z.std() - 1.0) < 0.05


def test_asian_qmc_beats_mc_variance():
    """montecarlo.c's acceptance: QMC stdev < MC stdev across runs."""
    runs = 12
    qmc = [asian_option_qmc(samples=500, qmc=True, run_index=i)
           for i in range(runs)]
    mc = [asian_option_qmc(samples=500, qmc=False, run_index=i, seed=7)
          for i in range(runs)]
    assert np.std(qmc, ddof=1) < np.std(mc, ddof=1)
    # both estimate the same price
    assert abs(np.mean(qmc) - np.mean(mc)) < 0.15


def test_vg_mc_price_near_conv_price():
    mc = vg_mc_price(S, K, SIGMA, THETA, KAPPA, R, T, samples=200000,
                     seed=1)
    assert abs(mc - VG_TARGET) < 0.2   # MC error at 200k samples


def test_vg_mc_price_device_matches_host_pipeline():
    """The single-program device pipeline (vg_mc.cpp:56-108 end-to-end
    in one jit) draws the same uniforms as the host-sampled path, so
    the two prices differ only by the f32 grid: ~1e-5, far inside the
    0.2 MC band around the QuantLib anchor."""
    from cfftpack_jax.models import vg_mc_price_device
    dev = vg_mc_price_device(S, K, SIGMA, THETA, KAPPA, R, T,
                             samples=200000, seed=1)
    host = vg_mc_price(S, K, SIGMA, THETA, KAPPA, R, T, samples=200000,
                       seed=1)
    assert abs(dev - host) < 1e-3
    assert abs(dev - VG_TARGET) < 0.2


def test_cf_moment_sigma():
    # for GBM the stddev over t is sigma*sqrt(t)
    phi = lambda u, dt: bs_cf(u, T, 0.2, 0.0)      # noqa: E731
    est = cf_moment_sigma(phi, T)
    np.testing.assert_allclose(est, 0.2, rtol=1e-3)
    with pytest.raises(ValueError):
        cf_moment_sigma(lambda u, dt: np.complex128(2.0), 1.0)


def test_brent_root():
    assert abs(brent(lambda x: x ** 2 - 4, guess=1.0) - 2.0) < 1e-12
    assert abs(brent(np.cos, guess=1.0) - np.pi / 2) < 1e-12


@pytest.mark.parametrize("model,conv", [(1, "linear"), (0, "exponential")])
def test_shortrate_mesh_fits_curve(model, conv):
    """After fit(), Arrow-Debreu prices must reprice the zero curve."""
    sigma = 0.01 if model == 1 else 0.275
    times = np.linspace(0.0, 5.0, 41)
    mesh = ShortRateMesh(256, times, normal_cf(sigma),
                         mean_reversion=0.01, conv=conv)
    disc = np.exp(-0.02 * times)
    mesh.fit(disc)
    # sum of AD prices at each step == fitted discount factor
    for i in (5, 20, 40):
        np.testing.assert_allclose(mesh.ad[i].sum(), disc[i], rtol=1e-8)


def test_callable_bond_demo_consistency():
    straight, pv_check, callable_pv = callable_bond_demo(
        model=1, nstep=60, n_fft=256, maturity=5.0)
    # unreachable strike reprices the straight bond
    np.testing.assert_allclose(pv_check, straight, rtol=1e-6)
    # the call feature cannot make the bond worth more
    assert callable_pv <= straight + 1e-6
    assert callable_pv > 0.5 * straight


def test_chfun_sanity():
    u = np.linspace(-5, 5, 11)
    for phi in (nig_cf(100.14, 5.52, 6.361e-5),
                alpha_stable_cf(1.8, 0.0, 0.08),
                normal_cf(0.1)):
        v = phi(u, 0.5)
        assert np.all(np.abs(v) <= 1.0 + 1e-12)
        np.testing.assert_allclose(phi(0.0, 0.5), 1.0, atol=1e-12)
    np.testing.assert_allclose(vg_cf(0.0, T, SIGMA, THETA, KAPPA, R), 1.0,
                               atol=1e-12)


def test_heston_pricer_reduces_to_bs_at_zero_volvol():
    """With vanishing vol-of-vol and v0 == theta == sigma_bs^2, Heston
    degenerates to Black-Scholes — the conv pricer must agree."""
    from cfftpack_jax.models import heston_cf
    sig, t, r = 0.2, 0.5, 0.02
    phi = lambda u: heston_cf(u, t, v0=sig ** 2, kappa=5.0,     # noqa: E731
                              theta=sig ** 2, sigma=1e-4, rho=0.0, r=r)
    np.testing.assert_allclose(phi(0.0), 1.0, atol=1e-12)
    got = conv_option_price(100.0, 100.0, t, r, phi, n=1 << 14,
                            grid_sigma=sig)
    want = float(black_scholes_option(100.0, 100.0, sig, t, r, True))
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_heston_pricer_smile():
    """Nonzero correlation produces a monotone skewed call ladder."""
    from cfftpack_jax.models import heston_cf
    t, r = 0.5, 0.02
    phi = lambda u: heston_cf(u, t, v0=0.04, kappa=2.0,         # noqa: E731
                              theta=0.04, sigma=0.6, rho=-0.7, r=r)
    strikes = np.array([80.0, 100.0, 120.0])
    got = conv_option_price(100.0, strikes, t, r, phi, n=1 << 14,
                            grid_sigma=0.25)
    assert np.all(got > 0) and got[0] > got[1] > got[2]


def test_asian_qmc_matches_reference_binary_digit_for_digit():
    """End-to-end QMC pipeline parity: Halton -> Acklam icdf ->
    orthonormal DCT-IV -> path pricing.  Values produced by compiling
    and running the reference C (test/montecarlo.c semantics) with
    samples=500, steps=128 — our batched implementation reproduces
    them to ~1e-14."""
    want = [1.331389466495620, 1.330757038060973, 1.326960062625530]
    got = [asian_option_qmc(S=100.0, K=98.0, sigma=0.17, t=0.25, r=0.02,
                            steps=128, samples=500, is_call=False,
                            qmc=True, run_index=run)
           for run in range(3)]
    np.testing.assert_allclose(got, want, atol=5e-14)


def test_bs_conv_matches_reference_binary():
    """Strike ladder parity vs the compiled reference conv_option
    (blackscholes.cpp semantics, complex-FFT + fftshift variant) at
    N=8192 — our rfft-based pricer agrees to ~1e-14 despite the
    different transform path."""
    want = [15.212299372488037, 5.453853872366270, 0.323130053038668,
            0.000959919044600]
    ks = np.array([85.0, 95.0, 105.0, 115.0])
    got = conv_option_price(100.0, ks, 1 / 12, 0.03,
                            lambda u: bs_cf(u, 1 / 12, 0.15, 0.03),
                            n=8192, grid_sigma=0.15)
    np.testing.assert_allclose(got, want, atol=2e-13)


def test_vg_distribution_matches_reference_binary():
    """The deterministic FFT part of vg_mc.cpp (delta -> fft ->
    conj(phi) -> ifft -> CDF) vs the compiled reference binary at
    N=2048: CDF agrees to ~1e-14 at spot-checked quantiles."""
    from cfftpack_jax.models.montecarlo import vg_distribution_grid
    _, pdf = vg_distribution_grid(SIGMA, THETA, KAPPA, R, T, 2048)
    cum = np.cumsum(pdf)
    want = {512: 0.000098313654346, 1024: 0.344910732462461,
            1536: 0.999999669680804, 2047: 1.000000000000000}
    for i, v in want.items():
        np.testing.assert_allclose(cum[i], v, atol=2e-13)


def test_shortrate_alpha_stable_fit():
    """Model 5 (alpha-stable + shifted exponential): the mesh must still
    reprice the curve after calibration."""
    from cfftpack_jax.models.chfun import alpha_stable_cf
    times = np.linspace(0.0, 3.0, 25)
    mesh = ShortRateMesh(256, times, alpha_stable_cf(1.8, 0.0, 0.08),
                         mean_reversion=0.01, conv="shifted_exponential",
                         shift=0.02)
    disc = np.exp(-0.02 * times)
    mesh.fit(disc)
    np.testing.assert_allclose(mesh.ad[-1].sum(), disc[-1], rtol=5e-7)


@pytest.mark.parametrize("model,conv,shift,guess", [
    (2, "shifted_exponential", 0.04, None),   # shifted Black-Karasinski
    (3, None, 0.0, None),                     # NIG (Hainaut-MacGilchrist)
    (4, "square", 0.0, (0.1, 0.01, 1e-8)),    # Pelsser squared-Gaussian
])
def test_shortrate_other_models_fit(model, conv, shift, guess):
    """Models 2/3/4 of shortrate.cpp:332-410: the calibration must
    reprice the curve (Pelsser needs the tuned root guess, as the
    reference notes)."""
    from cfftpack_jax.models.chfun import normal_cf, nig_cf
    times = np.linspace(0.0, 3.0, 25)
    if model == 2:
        phi = normal_cf(0.10)
    elif model == 3:
        phi, conv = nig_cf(100.14, 5.52, 6.361e-5), "linear"
    else:
        phi = normal_cf(0.02)
    mesh = ShortRateMesh(256, times, phi, mean_reversion=0.01,
                         conv=conv, shift=shift)
    if guess:
        mesh.root_guess, mesh.root_step, mesh.root_lo = guess
    disc = np.exp(-0.025 * times)
    mesh.fit(disc)
    np.testing.assert_allclose(mesh.ad[-1].sum(), disc[-1], rtol=5e-7)
