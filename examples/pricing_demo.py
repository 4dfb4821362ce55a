"""Option-pricing demos — the reference's acceptance workloads.

Reproduces the printed tables of test/vargamma.c (BS + VG convergence
sweep), test/blackscholes.cpp (strike ladder), test/montecarlo.c
(MC vs QMC convergence) and test/shortrate.cpp (callable bond), on
whatever backend JAX finds (GPU or CPU).

Run: python examples/pricing_demo.py [bsvg|strikes|qmc|vgmc|shortrate|all]
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

def demo_bsvg():
    from cfftpack_jax.models import conv_bsvg_option
    from cfftpack_jax.utils import black_scholes_option
    S, K, sigma, theta, kappa, r, t = 100.0, 98.0, 0.12, -0.14, 0.2, 0.05, 1.0
    cbs = float(black_scholes_option(S, K, sigma, t, r, True))
    vg_target = 9.3424659413582116
    print("\nStock Option Pricing Benchmark (vargamma.c analog)")
    print(f"BS closed form: {cbs:.12f}")
    print(f"{'N':>10}{'CONV BS':>20}{'Error':>16}{'CONV VG':>20}"
          f"{'VG-QL err':>16}{'Time':>10}")
    for n in [1 << k for k in range(7, 19)]:
        t0 = time.perf_counter()
        c_bs = conv_bsvg_option(n, S, K, sigma, theta, kappa, t, r,
                                True, True)
        c_vg = conv_bsvg_option(n, S, K, sigma, theta, kappa, t, r,
                                True, False)
        dt = time.perf_counter() - t0
        print(f"{n:>10}{c_bs:>20.12f}{c_bs - cbs:>16.2e}"
              f"{c_vg:>20.12f}{c_vg - vg_target:>16.2e}{dt:>10.4f}")


def demo_strikes():
    from cfftpack_jax.models import conv_option_price, bs_cf
    from cfftpack_jax.utils import black_scholes_option
    S, sigma, r, t = 100.0, 0.15, 0.03, 1.0 / 12.0
    strikes = np.arange(85.0, 115.1, 2.5)
    print("\nStrike ladder (blackscholes.cpp analog) — ONE batched call")
    got = conv_option_price(S, strikes, t, r,
                            lambda u: bs_cf(u, t, sigma, r),
                            n=8192, grid_sigma=sigma)
    print(f"{'Strike':>8}{'BS Call':>12}{'CONV Call':>12}{'% err':>12}")
    for K, c in zip(strikes, np.atleast_1d(got)):
        c1 = float(black_scholes_option(S, K, sigma, t, r, True))
        print(f"{K:>8.2f}{c1:>12.6f}{c:>12.6f}{100 * (c - c1) / c1:>12.7f}")


def demo_qmc():
    from cfftpack_jax.models import asian_option_qmc
    print("\nQuasi-Monte Carlo (montecarlo.c analog): "
          "DCT-IV Brownian paths vs plain MC")
    for samples in (500, 1000, 2000):
        for qmc in (True, False):
            vals = [asian_option_qmc(samples=samples, qmc=qmc, run_index=i,
                                     seed=11)
                    for i in range(10)]
            print(f"  samples={samples:>5} {'QMC' if qmc else ' MC'}: "
                  f"mean {np.mean(vals):>9.6f}  stdev {np.std(vals, ddof=1):>9.6f}")


def demo_vgmc():
    from cfftpack_jax.models import vg_mc_price, vg_mc_price_device
    print("\nVariance-Gamma inverse-CDF Monte Carlo (vg_mc.cpp analog)")
    p = vg_mc_price(samples=200000, seed=3)
    print(f"  VG call price (host sampling):   {p:.6f}  "
          f"(QuantLib target 9.342466)")
    # single-program device pipeline (pass mesh=<jax Mesh> to shard the
    # draws across a device grid)
    pd_ = vg_mc_price_device(samples=200000, seed=3)
    print(f"  VG call price (device pipeline): {pd_:.6f}")


def demo_shortrate():
    from cfftpack_jax.models import callable_bond_demo
    print("\nFFT short-rate lattice (shortrate.cpp analog, QuantLib-free)")
    for model, name in ((1, "Hull-White"), (0, "Black-Karasinski"),
                        (5, "alpha-stable + shifted exp")):
        straight, check, callable_pv = callable_bond_demo(
            model=model, nstep=120, n_fft=512, maturity=10.0)
        print(f"  {name:<28} straight {straight:>12.4f}  "
              f"check {check:>12.4f}  callable {callable_pv:>12.4f}")


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    demos = {"bsvg": demo_bsvg, "strikes": demo_strikes, "qmc": demo_qmc,
             "vgmc": demo_vgmc, "shortrate": demo_shortrate}
    for name, fn in demos.items():
        if which in (name, "all"):
            fn()
