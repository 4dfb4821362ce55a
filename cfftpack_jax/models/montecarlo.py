"""Monte-Carlo / quasi-Monte-Carlo spectral applications.

* ``vg_mc_price`` — back out the Variance-Gamma PDF from its
  characteristic function by FFT, build the CDF, inverse-CDF sample it,
  price a call (test/vg_mc.cpp:27-114).  Sampling is one vectorized
  searchsorted over all draws (the reference loops lower_bound per
  draw).
* ``brownian_paths_qmc`` / ``asian_option_qmc`` — Brownian paths from
  Halton points via inverse normal CDF + orthonormal DCT-IV (the
  PCA-equivalent construction, Leobacher 2012; test/montecarlo.c:37-57),
  batched: ALL samples form one (samples, steps) array and one batched
  DCT-IV builds every path at once.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from functools import partial

from ..ops.dct import dct
from ..ops.cfft import fft_split, ifft_split
from ..ops.shift import fftshift, ifftshift
from ..utils.qmc import halton, normal_icdf, _halton_device
from .chfun import vg_cf, cf_moment_sigma

__all__ = ["vg_mc_price", "vg_mc_price_device", "asian_option_qmc",
           "asian_option_qmc_device", "brownian_paths_qmc"]


def _vg_grid_setup(sigma, theta, kappa, r, t, n: int):
    """Host-side (f64) frequency-grid setup shared by the VG MC paths:
    grid spacing dx from the CF's finite-difference stddev and the
    conjugated characteristic-function table (vg_mc.cpp:44-54)."""
    N = int(n)
    N2 = N // 2

    def phi(u, dt=t):
        return vg_cf(u, dt, sigma, theta, kappa, r)

    vgsigma = cf_moment_sigma(lambda u, dt: phi(u), t)
    L = 2 * 10 * vgsigma
    dx = L / N
    du = 2 * np.pi / (dx * N)
    u = (np.arange(N) - N2) * du
    return dx, np.conj(phi(u))                # forward-in-time propagation


def vg_distribution_grid(sigma, theta, kappa, r, t, n: int = 2048):
    """(outcomes, pdf) for the VG log-return over [0, t] via FFT
    propagation of a delta distribution (vg_mc.cpp:38-77)."""
    N = int(n)
    N2 = N // 2
    dx, ph = _vg_grid_setup(sigma, theta, kappa, r, t, N)
    prob = np.zeros(N)
    prob[N2] = 1.0

    @jax.jit
    def run(p, pr, pi):
        sr, si = fft_split(p, jnp.zeros_like(p))
        sr, si = fftshift(sr), fftshift(si)
        tr = sr * pr - si * pi
        ti = sr * pi + si * pr
        tr, ti = ifftshift(tr), ifftshift(ti)
        outr, _ = ifft_split(tr, ti)
        return outr

    pdf = np.asarray(run(jnp.asarray(prob), jnp.asarray(ph.real),
                         jnp.asarray(ph.imag)))
    outcomes = (np.arange(N) - N2) * dx
    return outcomes, pdf


def vg_mc_price(S=100.0, K=98.0, sigma=0.12, theta=-0.14, kappa=0.2,
                r=0.05, t=1.0, n: int = 2048, samples: int = 100000,
                seed: int = 0):
    """VG call by inverse-CDF Monte Carlo over the FFT-derived
    distribution (vg_mc.cpp end-to-end)."""
    outcomes, pdf = vg_distribution_grid(sigma, theta, kappa, r, t, n)
    cumdist = np.cumsum(pdf)
    key = jax.random.PRNGKey(seed)
    p = np.asarray(jax.random.uniform(key, (samples,), dtype=jnp.float32),
                   dtype=np.float64)
    j = np.searchsorted(cumdist, p)
    j = np.minimum(j, len(outcomes) - 1)
    x = outcomes[j]
    payoff = np.maximum(np.exp(x) * S - K, 0.0)
    return float(payoff.mean() * np.exp(-r * t))


def _vg_mc_body(seed, n: int, samples: int, is_call: bool,
                dtype_name: str, params, phr, phi_, dx):
    """Body of the single-program VG Monte-Carlo pipeline
    (vg_mc.cpp:56-108): delta spike -> FFT -> x conj(phi) -> inverse
    FFT -> cumulative distribution -> inverse-CDF sampling of uniform
    draws -> discounted payoff mean.  The reference walks the 100k
    draws through std::lower_bound one at a time; here the draws ride
    the batch axis and the CDF lookup is one vectorized searchsorted
    (same nearest-grid-point convention, no interpolation).  Traceable
    under jit directly (``_vg_mc_program``) or per-shard inside
    shard_map (``vg_mc_price_device(mesh=...)``)."""
    S, K, r, t = params
    dtype = jnp.dtype(dtype_name)
    N2 = n // 2
    spike = jnp.zeros((n,), dtype).at[N2].set(1.0)
    sr, si = fft_split(spike, jnp.zeros_like(spike))
    sr, si = fftshift(sr), fftshift(si)
    tr = sr * phr - si * phi_
    ti = sr * phi_ + si * phr
    tr, ti = ifftshift(tr), ifftshift(ti)
    pdf, _ = ifft_split(tr, ti)
    cdf = jnp.cumsum(pdf)
    p = jax.random.uniform(jax.random.PRNGKey(seed), (samples,), dtype)
    # method="sort" (one co-sort of cdf+draws) over the default "scan"
    # (log2 n sequential gather rounds): bit-identical bin choice; the
    # choice was made on the earlier backend and is unmeasured on the
    # H100
    j = jnp.minimum(jnp.searchsorted(cdf, p, method="sort"), n - 1)
    x = (j.astype(dtype) - N2) * dx
    s_t = S * jnp.exp(x)
    pay = (jnp.maximum(s_t - K, 0.0) if is_call
           else jnp.maximum(K - s_t, 0.0))
    return jnp.mean(pay) * jnp.exp(-r * t)


_vg_mc_program = partial(jax.jit, static_argnums=(1, 2, 3, 4))(_vg_mc_body)


def _device_linear_index(mesh):
    """Traced linear index of this shard over EVERY mesh axis."""
    idx = jnp.int32(0)
    for a in mesh.axis_names:
        idx = idx * mesh.shape[a] + jax.lax.axis_index(a)
    return idx


# The sharded MC programs below are MODULE-LEVEL jits with the (hashable)
# Mesh as a static argument: a per-call @jax.jit closure never hits the
# jit cache, so every mesh= price would retrace + recompile (measured
# 4.6-6.8 s per warm call on the 8-device CPU mesh vs milliseconds
# cached).  Draws are embarrassingly parallel: the whole device grid
# works one equal-size draw shard each, one pmean over all axes
# combines, and the tiny setup tables are replicated.

@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _vg_mc_sharded(seed, mesh, n: int, sh_samples: int, is_call: bool,
                   dtype_name: str, params, phr, phi_, dx):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    names = tuple(mesh.axis_names)
    nd = mesh.size

    def f(seed, params, phr, phi_, dx):
        # disjoint PRNG sub-streams per shard
        local = _vg_mc_body(seed * nd + _device_linear_index(mesh), n,
                            sh_samples, is_call, dtype_name, params,
                            phr, phi_, dx)
        return jax.lax.pmean(local, names)

    return shard_map(f, mesh=mesh, in_specs=(P(),) * 5, out_specs=P())(
        seed, params, phr, phi_, dx)


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6, 7))
def _asian_qmc_sharded(start, mesh, sh_samples: int, steps: int, nd: int,
                       is_call: bool, dtype_name: str, exact: bool,
                       params):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    names = tuple(mesh.axis_names)

    def f(start, params):
        # shard d draws the Halton index sub-range start + d*S/D ..
        local = _asian_qmc_body(
            start + _device_linear_index(mesh) * sh_samples, sh_samples,
            steps, nd, is_call, dtype_name, params, exact)
        return jax.lax.pmean(local, names)

    return shard_map(f, mesh=mesh, in_specs=(P(), P()), out_specs=P())(
        start, params)


def vg_mc_price_device(S=100.0, K=98.0, sigma=0.12, theta=-0.14, kappa=0.2,
                       r=0.05, t=1.0, n: int = 2048, samples: int = 100000,
                       seed: int = 0, is_call=True, dtype=jnp.float32,
                       mesh=None):
    """VG call by inverse-CDF Monte Carlo with the ENTIRE pipeline on
    device (vs ``vg_mc_price``'s host sampling) — distribution build,
    draw generation, CDF lookup and payoff reduction are one jitted
    program; only the host-f64 characteristic-function table and one
    scalar cross the host boundary.

    ``mesh``: optional jax Mesh — the draws are sharded over the WHOLE
    device grid (each device samples a disjoint PRNG sub-stream and the
    means combine by pmean; the N-point distribution build is
    replicated, it is trivial next to the draw batch).  ``samples``
    must be divisible by the mesh device count."""
    dx, ph = _vg_grid_setup(sigma, theta, kappa, r, t, n)
    dtype = jnp.dtype(dtype)
    params = tuple(jnp.asarray(v, dtype=dtype) for v in (S, K, r, t))
    tables = (params, jnp.asarray(ph.real, dtype=dtype),
              jnp.asarray(ph.imag, dtype=dtype),
              jnp.asarray(float(dx), dtype=dtype))
    if mesh is None:
        return float(_vg_mc_program(jnp.int32(seed), int(n), int(samples),
                                    bool(is_call), dtype.name, *tables))
    nd = mesh.size
    if samples % nd:
        raise ValueError(f"samples={samples} must be divisible by the "
                         f"mesh device count {nd}")
    return float(_vg_mc_sharded(jnp.int32(seed), mesh, int(n),
                                int(samples) // nd, bool(is_call),
                                dtype.name, *tables))


def brownian_paths_qmc(n_paths: int, steps: int, start_index: int = 1):
    """(n_paths, steps) standard-normal increments with QMC structure:
    Halton -> inverse normal CDF -> orthonormal DCT-IV
    (montecarlo.c:37-57; fft_ortho(dct4, true))."""
    pts = halton(np.arange(start_index, start_index + n_paths), steps)
    z = normal_icdf(jnp.asarray(pts))
    return dct(z, type=4, norm="ortho")


def _asian_qmc_body(start, samples: int, steps: int, nd: int,
                    is_call: bool, dtype_name: str, params,
                    exact_halton: bool = False):
    """ONE device program for the whole QMC asian pipeline: Halton
    digits -> inverse normal CDF -> orthonormal DCT-IV path build ->
    cumulative log-return walk -> discounted average payoff.  The
    reference runs this per path with scalar loops
    (montecarlo.c:63-103); here every stage is a (samples, steps)
    batch op, so path count rides the 128-lane axis and the DCT-IV is
    one batched transform."""
    S, K, sigma, t, r = params
    dtype = jnp.dtype(dtype_name)
    pts = _halton_device(start, samples, steps, nd, dtype,
                         exact=exact_halton)
    z = dct(normal_icdf(pts), type=4, norm="ortho")
    dt = t / steps
    var = sigma * jnp.sqrt(dt)
    drift = (r - 0.5 * sigma * sigma) * dt
    s_path = S * jnp.exp(jnp.cumsum(z * var + drift, axis=-1))
    pay = (jnp.maximum(s_path - K, 0.0) if is_call
           else jnp.maximum(K - s_path, 0.0))
    return jnp.mean(pay) * jnp.exp(-r * t)


_asian_qmc_program = partial(jax.jit,
                             static_argnums=(1, 2, 3, 4, 5, 7))(
                                 _asian_qmc_body)


def asian_option_qmc_device(S=100.0, K=98.0, sigma=0.17, t=0.25, r=0.02,
                            steps: int = 128, samples: int = 2000,
                            is_call=False, run_index: int = 0,
                            dtype=jnp.float32, mesh=None):
    """Arithmetic-average Asian option with the ENTIRE QMC pipeline on
    device (vs ``asian_option_qmc``'s host-numpy Halton setup) — the
    serving-path variant: no host->device transfer scales with the
    sample count, only five scalars cross.

    ``mesh``: optional jax Mesh — the Halton index range is partitioned
    over the WHOLE device grid (device d draws indices start + d*S/D
    ..), so the sharded price estimates the SAME quasi-random point set
    as the single-chip call; pmean combines the shard means.
    ``samples`` must be divisible by the mesh device count."""
    if steps % 2:
        raise ValueError("steps must be even (DCT-IV path construction)")
    start = samples * run_index + 1
    last = start + samples - 1
    if last >= 1 << 31:
        raise ValueError(
            f"asian_option_qmc_device: last Halton index {last} >= 2**31 "
            "overflows the device int32 index arithmetic (lower samples "
            "or run_index)")
    nd = max(1, int(np.floor(np.log2(max(last, 1)))) + 1)
    nd = (nd + 7) // 8 * 8
    dtype = jnp.dtype(dtype)
    params = tuple(jnp.asarray(v, dtype=dtype) for v in (S, K, sigma, t, r))
    if mesh is None:
        return float(_asian_qmc_program(jnp.int32(start), int(samples),
                                        int(steps), nd, bool(is_call),
                                        dtype.name, params,
                                        last >= 1 << 24))
    ndev = mesh.size
    if samples % ndev:
        raise ValueError(f"samples={samples} must be divisible by the "
                         f"mesh device count {ndev}")
    return float(_asian_qmc_sharded(jnp.int32(start), mesh,
                                    int(samples) // ndev, int(steps), nd,
                                    bool(is_call), dtype.name,
                                    last >= 1 << 24, params))


def asian_option_qmc(S=100.0, K=98.0, sigma=0.17, t=0.25, r=0.02,
                     steps: int = 128, samples: int = 2000,
                     is_call=False, qmc=True, run_index: int = 0,
                     seed: int = 0):
    """Arithmetic-average Asian option, fully batched
    (montecarlo.c:63-103): every sample path is a row; the path build,
    cumulative product and payoff average are single array ops."""
    if steps % 2:
        raise ValueError("steps must be even (DCT-IV path construction)")
    dt = t / steps
    var = float(sigma * np.sqrt(dt))
    drift = float((r - 0.5 * sigma * sigma) * dt)
    if qmc:
        index = samples * run_index
        z = brownian_paths_qmc(samples, steps, start_index=index + 1)
    else:
        key = jax.random.PRNGKey(seed + run_index)
        z = jax.random.normal(key, (samples, steps), dtype=jnp.float64)

    @jax.jit
    def value(zmat):
        logret = zmat * var + drift
        s_path = S * jnp.exp(jnp.cumsum(logret, axis=-1))
        pay = (jnp.maximum(s_path - K, 0.0) if is_call
               else jnp.maximum(K - s_path, 0.0))
        avg = jnp.mean(pay, axis=-1)          # average over path steps
        return jnp.mean(avg) * float(np.exp(-r * t))

    return float(value(z))
