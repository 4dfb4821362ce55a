"""High-precision (double-float) FFT — f64-class accuracy from f32 pairs.

``fft_hp``/``ifft_hp`` run the same Stockham mixed-radix schedule as the
f32 engine (core._stockham; reference stage schedule c1fm1f_,
cfftpack/fftpack.c:2041-2142) but carry every value as
a double-float (hi, lo) pair of f32 arrays (ops/df64.py), with all
twiddle/butterfly constants split exactly from host f64.  Measured
accuracy ~1e-14 relative — the reference's C-double tolerance class
(testall.c's 1e-13 bar) — from pure f32 arithmetic.  It is reached
explicitly (the ``*_hp`` functions) or through the opt-in
config.set_f64_policy("hp"); whether it beats native f64 on the H100
is unmeasured (ROADMAP D2).

Scope: ANY length — mixed-radix stockham for factors up to
plan.MAX_DIRECT_RADIX (every fast size and odd primes to 31), df
Bluestein chirp-z beyond, same as the f32 engine.

Cost: several times the f32 engine's arithmetic — the accuracy mode,
not the throughput mode.  Its cost on the H100 is unmeasured.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .. import plan
from ..config import DEFAULT_NORM, check_norm, fwd_scale, inv_scale
from .df64 import (df_add, df_sub, df_mul, df_neg, df_split_host,
                   df_merge_host)

__all__ = ["fft_hp", "ifft_hp", "fft2_hp", "ifft2_hp", "sfft_hp",
           "rfft_hp", "irfft_hp", "rfft2_hp", "irfft2_hp",
           "dct2_hp", "idct2_hp", "dst2_hp",
           "idst2_hp", "dct4_hp", "idct4_hp", "dst4_hp", "idst4_hp",
           "dct1_hp", "idct1_hp", "dst1_hp", "idst1_hp",
           "dct_hp", "idct_hp", "dst_hp", "idst_hp",
           "dctn_hp", "idctn_hp", "dstn_hp", "idstn_hp",
           "gdft_hp", "igdft_hp"]

def _cmul_df(ar, ai, br, bi):
    """Complex product of df-complex values (each a (hi, lo) pair)."""
    t1 = df_mul(*ar, *br)
    t2 = df_mul(*ai, *bi)
    t3 = df_mul(*ar, *bi)
    t4 = df_mul(*ai, *br)
    return (df_sub(*t1, *t2), df_add(*t3, *t4))


def _cadd(a, b):
    return (df_add(*a[0], *b[0]), df_add(*a[1], *b[1]))


def _csub(a, b):
    return (df_sub(*a[0], *b[0]), df_sub(*a[1], *b[1]))


def _cmul_j(a, sgn: float):
    """Multiply by sgn*1j: exact (swap + negate)."""
    re, im = a
    if sgn > 0:
        return (df_neg(*im), re)
    return (im, df_neg(*re))


def _dft4_cols(X, sgn: float):
    """Radix-4 butterfly on 4 df-complex columns (the p==4 algebra)."""
    a = _cadd(X[0], X[2])
    b = _csub(X[0], X[2])
    c = _cadd(X[1], X[3])
    d = _cmul_j(_csub(X[1], X[3]), sgn)
    return [_cadd(a, c), _cadd(b, d), _csub(a, c), _csub(b, d)]


def _butterfly_hp(T, p: int, inverse: bool, cpu: bool = False):
    """Length-p DFT over axis -2 of df-complex T = (re_pair, im_pair);
    each pair element has shape (..., p, m).  Mirrors core._butterfly's
    radix algebra with exactly-split constants."""
    sgn = 1.0 if inverse else -1.0

    def pick(j):
        return ((T[0][0][..., j, :], T[0][1][..., j, :]),
                (T[1][0][..., j, :], T[1][1][..., j, :]))

    X = [pick(j) for j in range(p)]

    def stack(cols):
        re_h = jnp.stack([c[0][0] for c in cols], axis=-2)
        re_l = jnp.stack([c[0][1] for c in cols], axis=-2)
        im_h = jnp.stack([c[1][0] for c in cols], axis=-2)
        im_l = jnp.stack([c[1][1] for c in cols], axis=-2)
        return ((re_h, re_l), (im_h, im_l))

    if p == 1:
        return T
    if p == 2:
        return stack([_cadd(X[0], X[1]), _csub(X[0], X[1])])
    if p == 4:
        return stack(_dft4_cols(X, sgn))
    # generic small radix (3, 5, odd primes <= 31): dense DFT sum with
    # df-split matrix constants.  Vectorized over the OUTPUT bin axis
    # (each term is a (..., p, m) df op against a (p, 1) constant
    # column), so the traced graph is O(p) ops, not O(p^2) — the
    # unrolled double loop made p=31 compile-prohibitive.
    D = plan.dft_matrix(p)
    if inverse:
        D = np.conj(D)
    dtype = T[0][0].dtype
    mw = T[0][0].shape[-1]

    def col_const(v):
        # CPU: materialize the (p, m) column constant (broadcast df
        # constants hit the XLA:CPU hazards — see _bluestein_hp_jit);
        # other backends: keep the memory-lean (p, 1) broadcast form
        c = np.broadcast_to(v[:, None], (p, mw)) if cpu else v[:, None]
        hi, lo = df_split_host(c)
        return (jnp.asarray(hi, dtype=dtype),
                jnp.asarray(lo, dtype=dtype))

    acc = None
    for j in range(p):
        dr = col_const(D[:, j].real)               # (p, 1) df pairs
        di = col_const(D[:, j].imag)
        xr, xi = X[j]
        xr_b = (xr[0][..., None, :], xr[1][..., None, :])
        xi_b = (xi[0][..., None, :], xi[1][..., None, :])
        term = _cmul_df(xr_b, xi_b, dr, di)        # (..., p, m)
        acc = term if acc is None else _cadd(acc, term)
    return acc


def _twiddle_tables_hp(tw, inverse: bool, dtype):
    twi = np.conj(tw) if inverse else tw
    rh, rl = df_split_host(twi.real)
    ih, il = df_split_host(twi.imag)
    return tuple(jnp.asarray(v, dtype=dtype)[None, None]
                 for v in (rh, rl, ih, il))


def _stockham_hp(Rh, Rl, Ih, Il, n: int, inverse: bool,
                 cpu: bool = False):
    shape = Rh.shape
    arrs = [a.reshape(-1, 1, n) for a in (Rh, Rl, Ih, Il)]
    B = arrs[0].shape[0]
    L, m = 1, n
    for p, tw in zip(plan.factor(n), plan.stage_twiddles(n)):
        mn = m // p
        view = [a.reshape(B, L, p, mn) for a in arrs]
        T = ((view[0], view[1]), (view[2], view[3]))
        U = _butterfly_hp(T, p, inverse, cpu)
        if mn > 1:
            trh, trl, tih, til = _twiddle_tables_hp(tw, inverse,
                                                    arrs[0].dtype)
            re, im = _cmul_df((U[0][0], U[0][1]), (U[1][0], U[1][1]),
                              (trh, trl), (tih, til))
            U = (re, im)
        flat = []
        for pair in (U[0], U[1]):
            for a in pair:
                flat.append(jnp.swapaxes(a, 1, 2).reshape(B, L * p, mn))
        arrs = flat
        L *= p
        m = mn
    return tuple(a.reshape(shape) for a in arrs)


@partial(jax.jit, static_argnums=(4, 5, 6))
def _sfft_hp_jit(Rh, Rl, Ih, Il, n: int, inverse: bool,
                 cpu: bool = False):
    return _stockham_hp(Rh, Rl, Ih, Il, n, inverse, cpu)


@partial(jax.jit, static_argnums=(4, 5, 6))
def _bluestein_hp_jit(Rh, Rl, Ih, Il, n: int, inverse: bool,
                      cpu_tables: bool = False):
    """Bluestein chirp-z at double-float precision: df chirp premul,
    two length-m df FFTs around the df kernel product, chirp postmul
    (mirrors core._bluestein; m is 5-smooth so the stockham path
    applies).  The 1/m convolution scale is a df-split constant.

    CPU-backend caveat: XLA:CPU's fused elementwise codegen loses the
    df compensation terms when a table operand is BROADCAST against
    batched data in this program (measured 3.4e-8 instead of 2e-15;
    the HLO keeps every op and barriers do not help, so it is a
    backend emitter behavior, not an HLO rewrite).  On CPU the tables
    are therefore embedded pre-broadcast at the full batch shape — fine
    for CPU-scale workloads; other backends keep the memory-lean
    broadcast form."""
    # pow2 pad preference off the CPU: odd 3/5-heavy pads cost the df
    # engine more than power-of-two ones (O(p)-traced odd-radix
    # stages); taken when it costs <= 15% more elements.  Tuned on the
    # earlier backend, unmeasured on the H100.
    m0 = plan.fft_next_fast_size(2 * n - 1)
    ms = None
    if not cpu_tables and m0 & (m0 - 1):
        p2 = 1 << (2 * n - 2).bit_length()
        if p2 <= m0 * 1.15:
            ms = p2
    m, chirp, bq = (plan.bluestein_tables(n) if ms is None
                    else plan.bluestein_tables(n, ms))
    if inverse:
        chirp = np.conj(chirp)
        bq = np.conj(bq)
    dtype = Rh.dtype
    lead = Rh.shape[:-1]

    def tab(v):
        return _df_tab_b(v, dtype, lead, cpu_tables)

    cr = tab(chirp.real)
    ci = tab(chirp.imag)
    ar, ai = _cmul_df((Rh, Rl), (Ih, Il), cr, ci)
    pad = [(0, 0)] * (Rh.ndim - 1) + [(0, m - n)]
    ar = tuple(jnp.pad(a, pad) for a in ar)
    ai = tuple(jnp.pad(a, pad) for a in ai)
    A = _stockham_hp(ar[0], ar[1], ai[0], ai[1], m, False, cpu_tables)
    br = tab(bq.real)
    bi = tab(bq.imag)
    Cr, Ci = _cmul_df((A[0], A[1]), (A[2], A[3]), br, bi)
    E = _stockham_hp(Cr[0], Cr[1], Ci[0], Ci[1], m, True, cpu_tables)
    sm = _df_tab(np.float64(1.0 / m), dtype)
    Er = df_mul(E[0][..., :n], E[1][..., :n], *sm)
    Ei = df_mul(E[2][..., :n], E[3][..., :n], *sm)
    outr, outi = _cmul_df(Er, Ei, cr, ci)
    return outr[0], outr[1], outi[0], outi[1]


def _fourstep_hp(Rh, Rl, Ih, Il, n: int, inverse: bool, cpu: bool):
    """In-core four-step at df64 precision (core._fourstep_local
    analog re-derived for the 4-plane quad): view x[j1*n2+j2] as
    (n1, n2), outer df FFT over j1 (transpose + stockham — no dense
    matmul form exists for df arithmetic), df twiddle cmul, df FFT over
    j2, digit-reversal transpose to natural order."""
    from .core import _fourstep_split_n
    n1, n2 = _fourstep_split_n(n)
    lead = Rh.shape[:-1]
    dtype = Rh.dtype
    q = [a.reshape(lead + (n1, n2)) for a in (Rh, Rl, Ih, Il)]
    t = [jnp.swapaxes(a, -1, -2) for a in q]
    A = _stockham_hp(t[0], t[1], t[2], t[3], n1, inverse, cpu)
    A = [jnp.swapaxes(a, -1, -2) for a in A]
    k1 = np.arange(n1)[:, None]
    j2 = np.arange(n2)[None, :]
    sgn = 2j * np.pi / n if inverse else -2j * np.pi / n
    tw = np.exp(sgn * (k1 * j2))
    twr = _df_tab_b(tw.real, dtype, lead, cpu)
    twi = _df_tab_b(tw.imag, dtype, lead, cpu)
    Tr, Ti = _cmul_df((A[0], A[1]), (A[2], A[3]), twr, twi)
    flat = [a.reshape(-1, n2) for a in (Tr[0], Tr[1], Ti[0], Ti[1])]
    Y = _stockham_hp(flat[0], flat[1], flat[2], flat[3], n2, inverse,
                     cpu)
    out = []
    for a in Y:
        a = a.reshape(lead + (n1, n2))
        out.append(jnp.swapaxes(a, -1, -2).reshape(lead + (n,)))
    return tuple(out)


_fourstep_hp_jit = partial(jax.jit, static_argnums=(4, 5, 6))(
    _fourstep_hp)


@partial(jax.jit, static_argnums=(4, 5, 6, 7, 8))
def _chunked_hp_jit(Rh, Rl, Ih, Il, n: int, inverse: bool, cpu: bool,
                    bc: int, four: bool):
    """Sequential lax.map over ``bc``-row batch chunks so each chunk's
    df stage chain works on a bounded slice (the hp analog of
    core._map_chunks; the 4-plane quad doubles the working set, so the
    chunk threshold sits at HALF the f32 engine's element count)."""
    lead = Rh.shape[:-1]
    arrs = tuple(a.reshape(-1, bc, n) for a in (Rh, Rl, Ih, Il))
    body = _fourstep_hp if four else _stockham_hp
    out = jax.lax.map(
        lambda c: body(c[0], c[1], c[2], c[3], n, inverse, cpu), arrs)
    return tuple(o.reshape(lead + (n,)) for o in out)


# Dispatch thresholds for the 4-plane df64 working set.  They were
# tuned on the earlier backend and are unmeasured on the H100.
_HP_FOURSTEP_MIN = 8192       # b < 128 and n >= this: four-step
_HP_LANE_BATCH = 128
_HP_BIG_ELEMS = 1 << 23       # half the f32 engine's 2^24 (4 planes)
_HP_MAPFOUR_MIN_N = 1 << 16


def _fft_any_hp(Rh, Rl, Ih, Il, n: int, inverse: bool, cpu: bool):
    """Batch-aware engine dispatch for the df64 stockham (the hp
    analog of core._fft_any, with thresholds for the doubled working
    set).  CPU backends always take the flat path: the XLA:CPU df
    compile pathologies (see _cpu_dense/_dense_half) punish the extra
    jit variants and CPU-scale workloads never need the chunking."""
    from .core import _fourstep_split_n
    bp = 1
    for d in Rh.shape[:-1]:
        bp *= int(d)
    if cpu:
        return _sfft_hp_jit(Rh, Rl, Ih, Il, n, inverse, cpu)
    split = _fourstep_split_n(n)
    if n >= _HP_FOURSTEP_MIN and bp < _HP_LANE_BATCH and split is not None:
        return _fourstep_hp_jit(Rh, Rl, Ih, Il, n, inverse, cpu)
    if bp * n >= _HP_BIG_ELEMS and bp % 32 == 0:
        if n >= _HP_MAPFOUR_MIN_N and split is not None:
            return _chunked_hp_jit(Rh, Rl, Ih, Il, n, inverse, cpu,
                                   32, True)
        if bp % _HP_LANE_BATCH == 0 and bp >= 2 * _HP_LANE_BATCH:
            return _chunked_hp_jit(Rh, Rl, Ih, Il, n, inverse, cpu,
                                   _HP_LANE_BATCH, False)
    return _sfft_hp_jit(Rh, Rl, Ih, Il, n, inverse, cpu)


def _on_cpu(x) -> bool:
    """True when this CONCRETE array will execute on a CPU device (the
    df-broadcast hazard backend; see _bluestein_hp_jit).  Committed
    device wins over the process default — a CPU-device_put array in a
    GPU-default process still compiles for XLA:CPU."""
    try:
        devs = x.devices()
        if devs:
            return next(iter(devs)).platform == "cpu"
    except Exception:
        pass
    return jax.default_backend() == "cpu"


def sfft_hp(Rh, Rl, Ih, Il, n: int, inverse: bool):
    """Unscaled df64 DFT over the last axis of a df-complex quad
    (re_hi, re_lo, im_hi, im_lo) — the on-device entry point.  Any n:
    mixed-radix stockham for factors up to plan.MAX_DIRECT_RADIX, df
    Bluestein beyond."""
    cpu = _on_cpu(Rh)
    if plan.needs_bluestein(n):
        return _bluestein_hp_jit(Rh, Rl, Ih, Il, n, inverse, cpu)
    return _fft_any_hp(Rh, Rl, Ih, Il, n, inverse, cpu)


def _fft_hp(x, inverse: bool, norm: str):
    x = np.asarray(x)
    n = x.shape[-1]
    if n == 0:
        raise ValueError("fft_hp: empty transform axis")
    xr = np.asarray(x.real, dtype=np.float64)
    xi = np.asarray(x.imag, dtype=np.float64)
    Rh, Rl = df_split_host(xr)
    Ih, Il = df_split_host(xi)
    out = sfft_hp(jnp.asarray(Rh), jnp.asarray(Rl), jnp.asarray(Ih),
                  jnp.asarray(Il), n, inverse)
    rh, rl, ih, il = (np.asarray(a) for a in out)
    yr = df_merge_host(rh, rl)
    yi = df_merge_host(ih, il)
    s = inv_scale(norm, n) if inverse else fwd_scale(norm, n)
    y = yr + 1j * yi
    if s != 1.0:
        y = y * np.float64(s)
    return y


def fft_hp(x, norm: str = DEFAULT_NORM):
    """Forward FFT at double-float precision (host f64 in/out; the
    transform itself runs on-device in f32 pairs)."""
    return _fft_hp(x, False, check_norm(norm))


def ifft_hp(y, norm: str = DEFAULT_NORM):
    return _fft_hp(y, True, check_norm(norm))


# ------------------------------------------------- real + DCT hp paths

def _hp_norm(norm: str) -> str:
    """check_norm + collapse the 'forward' alias onto fftpack (their
    scaling tables are identical, config.py)."""
    norm = check_norm(norm)
    return "fftpack" if norm == "forward" else norm


def _df_tab_b(v, dtype, lead, cpu: bool):
    """Host f64 table -> df pair of device constants, pre-broadcast to
    the full batch shape on the CPU backend (the XLA:CPU fused-loop
    emitter loses df compensation terms on broadcast table operands —
    see _bluestein_hp_jit; other backends keep the memory-lean
    broadcast form)."""
    if cpu and len(lead) > 0:
        v = np.broadcast_to(v, tuple(lead) + np.shape(v))
    return _df_tab(v, dtype)


def _df_tab(v, dtype):
    """Host f64 table -> df pair of device constants."""
    hi, lo = df_split_host(np.asarray(v, dtype=np.float64))
    return (jnp.asarray(hi, dtype=dtype), jnp.asarray(lo, dtype=dtype))


def _quad_split(x_f64):
    """Host f64 real array -> df pair of device arrays."""
    hi, lo = df_split_host(x_f64)
    return jnp.asarray(hi), jnp.asarray(lo)


def _dense_half(n: int) -> bool:
    """True when n is even and n//2 has a prime factor > 5 — the
    combination whose half-length srfft/sirfft wrapper (deinterleave /
    merge FMA around a dense-radix sub-FFT) hits a pathological
    superlinear XLA:CPU compile (minutes-to-never; the plain full-length
    stockham at the same n compiles in seconds).  On CPU such sizes take the full-length
    path instead (2x compute — irrelevant for CPU-scale use)."""
    return n % 2 == 0 and n >= 4 and max(plan.factor(n // 2)) > 5


def _cpu_dense(n: int) -> bool:
    """n (or its half) has a prime factor > 5 — the sizes whose
    permutation-wrapper hp programs (Makhoul / half-length pack around
    a dense-radix sub-FFT) compile pathologically on XLA:CPU.  Such
    sizes route to the pad+ramp+flat-FFT embedding formulation on CPU,
    which compiles in seconds for the same lengths."""
    return n > 1 and (max(plan.factor(n)) > 5 or _dense_half(n))


@partial(jax.jit, static_argnums=(2, 3))
def _srfft_hp_jit(xh, xl, n: int, cpu: bool = False):
    """Unscaled r2c of a df real input -> df-complex quad of n//2+1
    bins.  Even n: half-length complex trick with the (Z, Z-mirror)
    merge FMA of core.srfft, every table df-split; odd n (and, on CPU,
    even n with a dense half — see _dense_half): full-length transform
    of (x, 0), truncated."""
    from .core import _rfft_merge_tables
    z = jnp.zeros_like(xh)
    if n % 2 == 0 and not (cpu and _dense_half(n)):
        h = n // 2
        quads = (xh[..., 0::2], xl[..., 0::2], xh[..., 1::2],
                 xl[..., 1::2])
        Zr_h, Zr_l, Zi_h, Zi_l = _sfft_hp_body(*quads, h, False, cpu)
        tabs = [_df_tab_b(t[1:], xh.dtype, xh.shape[:-1], cpu)
                for t in _rfft_merge_tables(n)]
        a1, a2, a3, a4, b1, b2, b3, b4 = tabs
        Zrc = (Zr_h[..., 1:], Zr_l[..., 1:])
        Zic = (Zi_h[..., 1:], Zi_l[..., 1:])
        Zrf = (Zrc[0][..., ::-1], Zrc[1][..., ::-1])
        Zif = (Zic[0][..., ::-1], Zic[1][..., ::-1])

        def fma(t1, t2, t3, t4):
            acc = df_mul(*Zrc, *t1)
            acc = df_add(*acc, *df_mul(*Zic, *t2))
            acc = df_add(*acc, *df_mul(*Zrf, *t3))
            return df_add(*acc, *df_mul(*Zif, *t4))

        yr_c = fma(a1, a2, a3, a4)
        yi_c = fma(b1, b2, b3, b4)
        dc = df_add(Zr_h[..., :1], Zr_l[..., :1],
                    Zi_h[..., :1], Zi_l[..., :1])
        nyq = df_sub(Zr_h[..., :1], Zr_l[..., :1],
                     Zi_h[..., :1], Zi_l[..., :1])
        z1 = jnp.zeros_like(dc[0])
        yr = tuple(jnp.concatenate([d, c, q], axis=-1)
                   for d, c, q in zip(dc, yr_c, nyq))
        yi = tuple(jnp.concatenate([z1, c, z1], axis=-1) for c in yi_c)
        return yr[0], yr[1], yi[0], yi[1]
    Yh, Yl, Ih_, Il_ = _sfft_hp_body(xh, xl, z, z, n, False, cpu)
    k = n // 2 + 1
    ih = Ih_[..., :k].at[..., 0].set(0.0)
    il = Il_[..., :k].at[..., 0].set(0.0)
    if n % 2 == 0:         # packed-contract exact zero at Nyquist too
        ih = ih.at[..., k - 1].set(0.0)
        il = il.at[..., k - 1].set(0.0)
    return Yh[..., :k], Yl[..., :k], ih, il


def rfft_hp(x, norm: str = DEFAULT_NORM):
    """Real FFT at double-float precision: host f64 real in, packed
    (n//2+1) complex128 out (reference layout, cfftpack.c:466-471)."""
    norm = check_norm(norm)
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    xh, xl = _quad_split(x)
    rh, rl, ih, il = (np.asarray(a) for a in
                      _srfft_hp_jit(xh, xl, n, _on_cpu(xh)))
    y = df_merge_host(rh, rl) + 1j * df_merge_host(ih, il)
    s = fwd_scale(norm, n)
    return y * np.float64(s) if s != 1.0 else y


@partial(jax.jit, static_argnums=(2, 3))
def _dct2_hp_jit(xh, xl, n: int, cpu: bool = False):
    """Unscaled DCT-II via the Makhoul permutation + half-spectrum
    phase reconstruction (the all-n path of dct._dct2_core, df
    throughout).  The phase tables are trace-time constants (n is
    static), so repeated calls re-use the cached program with no
    per-call host table build or transfer."""
    from .dct import _cexp_half
    ph = _cexp_half(n, -1.0)
    h = n // 2
    lead = xh.shape[:-1]
    # host-slice the phase table BEFORE the df split so the CPU-backend
    # pre-broadcast (_df_tab_b, the fused-emitter hazard workaround)
    # broadcasts each slice to its batched operand shape
    phr_lo, phi_lo = _df_tab_b(ph.real[: h + 1], xh.dtype, lead, cpu)
    pir_lo, pii_lo = _df_tab_b(ph.imag[: h + 1], xh.dtype, lead, cpu)
    phr_hi, phi_hi = _df_tab_b(ph.real[h + 1:], xh.dtype, lead, cpu)
    pir_hi, pii_hi = _df_tab_b(ph.imag[h + 1:], xh.dtype, lead, cpu)
    vh = jnp.concatenate([xh[..., 0::2], xh[..., 1::2][..., ::-1]],
                         axis=-1)
    vl = jnp.concatenate([xl[..., 0::2], xl[..., 1::2][..., ::-1]],
                         axis=-1)
    Vr_h, Vr_l, Vi_h, Vi_l = _srfft_hp_jit.__wrapped__(vh, vl, n,
                                                       cpu)
    # y_low = Re(ph * V) = phr*Vr - phi*Vi
    y_lo = df_sub(*df_mul(Vr_h, Vr_l, phr_lo, phi_lo),
                  *df_mul(Vi_h, Vi_l, pir_lo, pii_lo))
    # high bins k = h+1..n-1 read conj(V[n-k]): y = phr*Vr_u + phi*Vi_u.
    # With Vr_u[i] = Vr[h-i], n-k = h-i gives start i = 2h-n+1: 1 for
    # even n (skip the Nyquist copy), 0 for odd
    Vr_u = (Vr_h[..., 1:][..., ::-1], Vr_l[..., 1:][..., ::-1])
    Vi_u = (Vi_h[..., 1:][..., ::-1], Vi_l[..., 1:][..., ::-1])
    take = n - (h + 1)
    s0 = 2 * h - n + 1
    y_hi = df_add(*df_mul(Vr_u[0][..., s0:s0 + take],
                          Vr_u[1][..., s0:s0 + take], phr_hi, phi_hi),
                  *df_mul(Vi_u[0][..., s0:s0 + take],
                          Vi_u[1][..., s0:s0 + take], pir_hi, pii_hi))
    return tuple(jnp.concatenate([lo, hi], axis=-1)
                 for lo, hi in zip(y_lo, y_hi))


def dct2_hp(x, norm: str = DEFAULT_NORM):
    """DCT-II at double-float precision (host f64 in/out).

    Scaling matches ops.dct.dct(type=2) for every norm: the fftpack
    pairing puts the 2/N on this forward side (idct type=2 is the
    unscaled type-3 sum), ortho is orthonormal, backward is the
    unscaled sum (the full scale moves to the inverse)."""
    norm = _hp_norm(norm)
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    if n == 1:
        y = x.copy()
    else:
        xh, xl = _quad_split(x)
        cpu = _on_cpu(xh)
        if cpu and _cpu_dense(n):
            # Makhoul wrapper around a dense-radix FFT compiles
            # pathologically on XLA:CPU; the equivalent half-shift
            # embedding (DCT-II[k] = Re U(a=.5, b=0, m=2n)) does not
            y, _ = _u_hp(x, n, 2 * n, 0.5, 0.0)
        else:
            yh, yl = _dct2_hp_jit(xh, xl, n, cpu)
            y = df_merge_host(np.asarray(yh), np.asarray(yl))
    if norm == "ortho":
        y = y * np.sqrt(2.0 / n)
        y[..., 0] = y[..., 0] / np.sqrt(2.0)
        return y
    if norm == "backward":
        return y
    return y * (2.0 / n)


@partial(jax.jit, static_argnums=(4, 5))
def _sirfft_hp_jit(yrh, yrl, yih, yil, n: int, cpu: bool = False):
    """Unscaled c2r of a packed df spectrum (n//2+1 bins) -> df pair of
    n * x (core.sirfft's contract, df throughout).  CPU dense-half
    sizes use the conjugate-extension full-length path (_dense_half)."""
    from .core import _irfft_merge_tables
    if n % 2 == 0 and not (cpu and _dense_half(n)):
        h = n // 2
        ya = (yrh[..., :h], yrl[..., :h])
        yb = (yih[..., :h], yil[..., :h])
        ymr = (yrh[..., 1:][..., ::-1], yrl[..., 1:][..., ::-1])
        ymi = (yih[..., 1:][..., ::-1], yil[..., 1:][..., ::-1])
        a1, a2, a3, a4, b1, b2, b3, b4 = (
            _df_tab_b(t, yrh.dtype, yrh.shape[:-1], cpu)
            for t in _irfft_merge_tables(n))

        def fma(t1, t2, t3, t4):
            acc = df_mul(*ya, *t1)
            acc = df_add(*acc, *df_mul(*yb, *t2))
            acc = df_add(*acc, *df_mul(*ymr, *t3))
            return df_add(*acc, *df_mul(*ymi, *t4))

        Zr = fma(a1, a2, a3, a4)
        Zi = fma(b1, b2, b3, b4)
        zrh, zrl, zih, zil = _sfft_hp_body(Zr[0], Zr[1], Zi[0], Zi[1],
                                           h, True, cpu)
        from .core import _interleave
        return _interleave(zrh, zih), _interleave(zrl, zil)
    # full-length: rebuild the conjugate-symmetric spectrum.  The
    # mirror reads bins n-k for k = h+1..n-1: slice [1:h] for even n
    # (skip DC and Nyquist), [1:h+1] for odd
    stop = (n // 2) if n % 2 == 0 else (n // 2 + 1)
    trh = yrh[..., 1:stop][..., ::-1]
    trl = yrl[..., 1:stop][..., ::-1]
    tih = -yih[..., 1:stop][..., ::-1]
    til = -yil[..., 1:stop][..., ::-1]
    fr_h = jnp.concatenate([yrh, trh], axis=-1)
    fr_l = jnp.concatenate([yrl, trl], axis=-1)
    fi_h = jnp.concatenate([yih, tih], axis=-1)
    fi_l = jnp.concatenate([yil, til], axis=-1)
    zrh, zrl, _, _ = _sfft_hp_body(fr_h, fr_l, fi_h, fi_l, n, True, cpu)
    return zrh, zrl


def irfft_hp(y, n: int, norm: str = DEFAULT_NORM):
    """Inverse real FFT at double-float precision: packed (n//2+1)
    complex128 spectrum in, host f64 real out."""
    norm = check_norm(norm)
    y = np.asarray(y, dtype=np.complex128)
    if y.shape[-1] != n // 2 + 1:
        raise ValueError(
            f"irfft_hp: spectrum axis has {y.shape[-1]} bins, expected "
            f"n//2+1 = {n // 2 + 1} for n={n}")
    rh, rl = df_split_host(y.real)
    ih, il = df_split_host(y.imag)
    rh_j = jnp.asarray(rh)
    oh, ol = (np.asarray(a) for a in _sirfft_hp_jit(
        rh_j, jnp.asarray(rl), jnp.asarray(ih), jnp.asarray(il), n,
        _on_cpu(rh_j)))
    x = df_merge_host(oh, ol)                 # n * x for an unscaled
    # spectrum; the forward already carried fwd_scale, so inv_scale
    # alone is the exact factor (fftpack 1, ortho 1/sqrt(n))
    s = inv_scale(norm, n)
    return x * np.float64(s) if s != 1.0 else x


def idct2_hp(y, norm: str = DEFAULT_NORM):
    """Inverse of dct2_hp (the DCT-III side), double-float.

    Makhoul inverse: V[k] = e^{i pi k/2n} (y[k] - i y[n-k]) rebuilds
    the half-spectrum, an inverse real FFT recovers the permuted
    sequence, and the even/odd de-permutation restores x."""
    norm = _hp_norm(norm)
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[-1]
    if n == 1:
        return y / 2.0 if norm == "fftpack" else y.copy()
    # undo the forward's scaling -> unscaled core-DCT-II coefficients
    # (the body below computes (2/n) * DCT-III(u); backward's forward
    # side was the unscaled sum, so u = y gives the full-scale inverse)
    if norm == "ortho":
        u = y / np.sqrt(2.0 / n)
        u[..., 0] = y[..., 0] * np.sqrt(n)
    elif norm == "backward":
        u = y.copy()
    else:
        u = y * (n / 2.0)
    if jax.default_backend() == "cpu" and _cpu_dense(n):
        # CPU dense sizes: DCT-III via the b=1/2 output-shift embedding
        # (input DC halved makes the plain sum the exact core-III)
        uhat = u.copy()
        uhat[..., 0] *= 0.5
        re, _ = _u_hp(uhat, n, 2 * n, 0.0, 0.5)
        return re * (2.0 / n)
    h = n // 2
    k = np.arange(1, h + 1)
    c = np.cos(np.pi * k / (2 * n))
    s = np.sin(np.pi * k / (2 * n))
    yk = u[..., 1:h + 1]
    ynk = u[..., n - h:][..., ::-1]
    Vr = np.concatenate([u[..., :1], c * yk + s * ynk], axis=-1)
    Vi = np.concatenate([np.zeros_like(u[..., :1]), s * yk - c * ynk],
                        axis=-1)
    if n % 2 == 0:
        # k=h: y_{n-h} is y_h itself; the slice above already read it
        pass
    # irfft_hp(fftpack) of the UNSCALED spectrum returns n * v
    v = irfft_hp(Vr + 1j * Vi, n, norm="fftpack") / n
    x = np.empty_like(v)
    nceil = (n + 1) // 2
    x[..., 0::2] = v[..., :nceil]
    x[..., 1::2] = v[..., nceil:][..., ::-1]
    return x


def dst2_hp(x, norm: str = DEFAULT_NORM):
    """DST-II at double-float precision via the exact flip/sign
    identity dst2(x) = flip(dct2((-1)^j x)) (ops/dct._dst2_core);
    the sign and reversal are exact, so accuracy equals dct2_hp.
    Scaling matches ops.dct.dst(type=2)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    sgn = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    return dct2_hp(x * sgn, norm)[..., ::-1]


def idst2_hp(y, norm: str = DEFAULT_NORM):
    """Inverse of dst2_hp (the DST-III side)."""
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[-1]
    sgn = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    return idct2_hp(y[..., ::-1], norm) * sgn


def _sfft_hp_body(Rh, Rl, Ih, Il, n: int, inverse: bool,
                  cpu_tables: bool):
    """Traceable any-length df64 DFT body (trace-time stockham /
    Bluestein dispatch) for composition inside larger jits.  Routes
    through the batch-aware _fft_any_hp so 2-D programs get the
    large-n engines (four-step / chunked lax.map) on EVERY axis pass
    — each 2-D axis pass carries the full image batch, which is
    exactly the >= 2^23-element regime the chunked dispatch covers."""
    if plan.needs_bluestein(n):
        return _bluestein_hp_jit.__wrapped__(Rh, Rl, Ih, Il, n, inverse,
                                             cpu_tables)
    return _fft_any_hp(Rh, Rl, Ih, Il, n, inverse, cpu_tables)


@partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _sfft2_hp_jit(Rh, Rl, Ih, Il, n0: int, n1: int, inverse: bool,
                  cpu_tables: bool):
    """Row-column 2-D df64 DFT in ONE device program (the reference
    2-D driver order, cfft2f_ fftpack.c:2363-2434) — the swapaxes stay
    on-device; only one transfer each way (unlike composing two fft_hp
    calls, which would merge/split and round-trip the quad twice)."""
    def one_axis(quad, n):
        return _sfft_hp_body(*quad, n, inverse, cpu_tables)

    q = one_axis((Rh, Rl, Ih, Il), n1)
    q = tuple(jnp.swapaxes(a, -1, -2) for a in q)
    q = one_axis(q, n0)
    return tuple(jnp.swapaxes(a, -1, -2) for a in q)


def fft2_hp(x, norm: str = DEFAULT_NORM):
    """2-D FFT at double-float precision over the trailing two axes
    (host f64 in/out; one on-device row-column program)."""
    return _fft2_hp(x, False, check_norm(norm))


def ifft2_hp(y, norm: str = DEFAULT_NORM):
    return _fft2_hp(y, True, check_norm(norm))


def _fft2_hp(x, inverse: bool, norm: str):
    x = np.asarray(x)
    if x.ndim < 2 or x.shape[-1] == 0 or x.shape[-2] == 0:
        raise ValueError("fft2_hp: need a non-empty trailing 2-D block")
    n0, n1 = x.shape[-2], x.shape[-1]
    Rh, Rl = df_split_host(np.asarray(x.real, dtype=np.float64))
    Ih, Il = df_split_host(np.asarray(x.imag, dtype=np.float64))
    q = tuple(jnp.asarray(v) for v in (Rh, Rl, Ih, Il))
    out = _sfft2_hp_jit(*q, n0, n1, inverse, _on_cpu(q[0]))
    rh, rl, ih, il = (np.asarray(a) for a in out)
    y = df_merge_host(rh, rl) + 1j * df_merge_host(ih, il)
    s = ((inv_scale(norm, n0) * inv_scale(norm, n1)) if inverse
         else (fwd_scale(norm, n0) * fwd_scale(norm, n1)))
    if s != 1.0:
        y = y * np.float64(s)
    return y


@partial(jax.jit, static_argnums=(2, 3, 4))
def _rfft2_hp_jit(xh, xl, n0: int, n1: int, cpu: bool):
    """2-D real-forward df program: packed r2c over the last axis, then
    a complex df FFT across rows — the reference 2-D real driver order
    (rfft2f_: rfftm along dim 1 then cfftm across rows,
    fftpack.c:13282-13445), all inside ONE device program."""
    q = _srfft_hp_jit.__wrapped__(xh, xl, n1, cpu)
    q = tuple(jnp.swapaxes(a, -1, -2) for a in q)
    q = _sfft_hp_body(*q, n0, False, cpu)
    return tuple(jnp.swapaxes(a, -1, -2) for a in q)


@partial(jax.jit, static_argnums=(4, 5, 6))
def _irfft2_hp_jit(rh, rl, ih, il, n0: int, n1: int, cpu: bool):
    q = tuple(jnp.swapaxes(a, -1, -2) for a in (rh, rl, ih, il))
    q = _sfft_hp_body(*q, n0, True, cpu)
    q = tuple(jnp.swapaxes(a, -1, -2) for a in q)
    return _sirfft_hp_jit.__wrapped__(*q, n1, cpu)


def rfft2_hp(x, norm: str = DEFAULT_NORM):
    """2-D real FFT at double-float precision over the trailing two
    axes: host f64 real (..., n0, n1) in, packed (..., n0, n1//2+1)
    complex128 out — the rfft2 layout (rfft2f_, fftpack.c:13282-13445)
    at the reference's C-double accuracy class."""
    norm = check_norm(norm)
    x = np.asarray(x, dtype=np.float64)
    if x.ndim < 2 or x.shape[-1] == 0 or x.shape[-2] == 0:
        raise ValueError("rfft2_hp: need a non-empty trailing 2-D block")
    n0, n1 = x.shape[-2], x.shape[-1]
    xh, xl = _quad_split(x)
    out = _rfft2_hp_jit(xh, xl, n0, n1, _on_cpu(xh))
    rh, rl, ih, il = (np.asarray(a) for a in out)
    y = df_merge_host(rh, rl) + 1j * df_merge_host(ih, il)
    s = fwd_scale(norm, n0) * fwd_scale(norm, n1)
    return y * np.float64(s) if s != 1.0 else y


def irfft2_hp(y, s, norm: str = DEFAULT_NORM):
    """Inverse 2-D real FFT at double-float precision; ``s = (n0, n1)``
    is the real output shape (the packed axis is parity-ambiguous)."""
    norm = check_norm(norm)
    n0, n1 = int(s[0]), int(s[1])
    y = np.asarray(y, dtype=np.complex128)
    if y.ndim < 2 or y.shape[-2] != n0 or y.shape[-1] != n1 // 2 + 1:
        raise ValueError(
            f"irfft2_hp: spectrum block is {y.shape[-2:]}, expected "
            f"({n0}, {n1 // 2 + 1}) for s={s!r}")
    rh, rl = df_split_host(y.real)
    ih, il = df_split_host(y.imag)
    q = tuple(jnp.asarray(v) for v in (rh, rl, ih, il))
    oh, ol = _irfft2_hp_jit(*q, n0, n1, _on_cpu(q[0]))
    x = df_merge_host(np.asarray(oh), np.asarray(ol))
    sc = inv_scale(norm, n0) * inv_scale(norm, n1)
    return x * np.float64(sc) if sc != 1.0 else x


@partial(jax.jit, static_argnums=(2, 3))
def _dct4_hp_jit(xh, xl, n: int, cpu_tables: bool):
    """Unscaled DCT-IV (y[k] = sum_j x[j] cos(pi(k+.5)(j+.5)/n)), df
    throughout — mirrors dct._dct4_core: even n via the half-length
    pack + quarter-phase rotations around one n/2 FFT; odd n via the
    half-shift GDFT embedding of length 2n."""
    dtype = xh.dtype
    lead = xh.shape[:-1]

    def tab(v):
        return _df_tab_b(v, dtype, lead, cpu_tables)

    if n % 2 == 0 and n >= 4 and not (cpu_tables and _dense_half(n)):
        h = n // 2
        p = np.arange(h)
        pre = np.exp(-1j * np.pi * p / n)
        post = np.exp(-1j * np.pi * (2 * p + 0.5) / (2 * n))
        prer = tab(pre.real)
        prei = tab(pre.imag)
        cr = (xh[..., 0::2], xl[..., 0::2])
        ci = (xh[..., ::-1][..., 0::2], xl[..., ::-1][..., 0::2])
        Wr, Wi = _cmul_df(cr, ci, prer, prei)
        W = _sfft_hp_body(Wr[0], Wr[1], Wi[0], Wi[1], h, False,
                          cpu_tables)
        postr = tab(post.real)
        posti = tab(post.imag)
        Zr, Zi = _cmul_df((W[0], W[1]), (W[2], W[3]), postr, posti)
        from .core import _interleave
        yh = _interleave(Zr[0], -Zi[0][..., ::-1])
        yl = _interleave(Zr[1], -Zi[1][..., ::-1])
        return yh, yl
    # odd n (and CPU dense-half even n): the length-2n half-shift
    # embedding, real part — works for every n
    out = _shifted_real_hp_body(xh, xl, n, 2 * n, 0.5, 0.5, cpu_tables)
    return out[0], out[1]


def dct4_hp(x, norm: str = DEFAULT_NORM):
    """DCT-IV at double-float precision (host f64 in/out; any n).

    Scaling matches ops.dct.dct(type=4) for every norm: fftpack
    forward carries 2/n (the inverse is the unscaled involution),
    ortho is sqrt(2/n) (self-inverse), backward is the unscaled sum."""
    norm = _hp_norm(norm)
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    xh, xl = _quad_split(x)
    yh, yl = _dct4_hp_jit(xh, xl, n, _on_cpu(xh))
    y = df_merge_host(np.asarray(yh), np.asarray(yl))
    if norm == "ortho":
        return y * np.sqrt(2.0 / n)
    if norm == "backward":
        return y
    return y * (2.0 / n)


def idct4_hp(y, norm: str = DEFAULT_NORM):
    """Inverse of dct4_hp (DCT-IV is an involution up to scale)."""
    norm = _hp_norm(norm)
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[-1]
    yh, yl = _quad_split(y)
    xh, xl = _dct4_hp_jit(yh, yl, n, _on_cpu(yh))
    x = df_merge_host(np.asarray(xh), np.asarray(xl))
    if norm == "ortho":
        return x * np.sqrt(2.0 / n)
    if norm == "backward":
        # backward: the forward was unscaled, the inverse carries 2/n
        return x * (2.0 / n)
    # fftpack: y = (2/n) C x with C^2 = (n/2) I  =>  x = C y unscaled
    return x


def dst4_hp(x, norm: str = DEFAULT_NORM):
    """DST-IV via the exact identity dst4(x) = (-1)^k dct4(flip(x))."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    sgn = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    return dct4_hp(x[..., ::-1], norm) * sgn


def idst4_hp(y, norm: str = DEFAULT_NORM):
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[-1]
    sgn = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    return idct4_hp(y * sgn, norm)[..., ::-1]


def _re_bins_hp(ext, m: int):
    """Unscaled r2c of a host-f64 extension sequence -> host f64
    (re, im) bins 0..m//2 via the df engine."""
    xh, xl = _quad_split(ext)
    rh, rl, ih, il = (np.asarray(a) for a in
                      _srfft_hp_jit(xh, xl, m, _on_cpu(xh)))
    return df_merge_host(rh, rl), df_merge_host(ih, il)


def dct1_hp(x, norm: str = DEFAULT_NORM):
    """DCT-I at double-float precision via the exact even extension
    (dct._dct1_re; reference cost machinery cost1f_).  Scaling matches
    ops.dct.dct(type=1) for every norm, incl. the closed-form
    orthonormal DCT-I (cfftpack_orthogonal_dct1, cfftpack.c:249-279).
    backward's forward side is the unscaled even-extension sum — which
    is exactly idct1_hp's fftpack body."""
    norm = _hp_norm(norm)
    if norm == "backward":
        return idct1_hp(x, "fftpack")
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    if n < 2:
        raise ValueError("dct1_hp requires n >= 2")
    ext = np.concatenate([x, x[..., 1:-1][..., ::-1]], axis=-1)
    re, _ = _re_bins_hp(ext, 2 * (n - 1))
    M = n - 1.0
    w = np.ones(n)
    if norm == "fftpack":
        w[0] = w[-1] = 0.5
        return re * (1.0 / M) * w
    sgn = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    c = 1.0 / np.sqrt(2.0) - 0.5
    y = 0.5 * re + c * (x[..., :1] + sgn * x[..., -1:])
    w[0] = w[-1] = 1.0 / np.sqrt(2.0)
    return y * np.sqrt(2.0 / M) * w


def idct1_hp(y, norm: str = DEFAULT_NORM):
    """Inverse of dct1_hp: the unscaled even-extension sum for the
    fftpack pairing; the orthonormal DCT-I is self-inverse; backward
    moves the full 1/(n-1) scale to this inverse side (== dct1_hp's
    fftpack body)."""
    norm = _hp_norm(norm)
    if norm == "ortho":
        return dct1_hp(y, "ortho")
    if norm == "backward":
        return dct1_hp(y, "fftpack")
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[-1]
    if n < 2:
        raise ValueError("idct1_hp requires n >= 2")
    ext = np.concatenate([y, y[..., 1:-1][..., ::-1]], axis=-1)
    re, _ = _re_bins_hp(ext, 2 * (n - 1))
    sgn = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    return 0.5 * re + 0.5 * (y[..., :1] + sgn * y[..., -1:])


def dst1_hp(x, norm: str = DEFAULT_NORM):
    """DST-I at double-float precision via the exact odd extension
    (dct._dst1_core; reference sint machinery sint1f_).  All norms:
    backward's forward side is the unscaled odd-extension sum
    (== idst1_hp's fftpack body)."""
    norm = _hp_norm(norm)
    if norm == "backward":
        return idst1_hp(x, "fftpack")
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    z = np.zeros_like(x[..., :1])
    ext = np.concatenate([z, x, z, -x[..., ::-1]], axis=-1)
    _, im = _re_bins_hp(ext, 2 * (n + 1))
    y = (-0.5) * im[..., 1: n + 1]
    if norm == "fftpack":
        return y * (2.0 / (n + 1))
    return y * np.sqrt(2.0 / (n + 1))


def idst1_hp(y, norm: str = DEFAULT_NORM):
    """Inverse of dst1_hp (DST-I is an involution up to scale; the
    orthonormal form is self-inverse; backward carries the full
    2/(n+1) scale on this side == dst1_hp's fftpack body)."""
    norm = _hp_norm(norm)
    if norm == "ortho":
        return dst1_hp(y, "ortho")
    if norm == "backward":
        return dst1_hp(y, "fftpack")
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[-1]
    z = np.zeros_like(y[..., :1])
    ext = np.concatenate([z, y, z, -y[..., ::-1]], axis=-1)
    _, im = _re_bins_hp(ext, 2 * (n + 1))
    return (-0.5) * im[..., 1: n + 1]


# --------------------------------------- odd types V-VIII + generic API

def _shifted_real_hp_body(xh, xl, n: int, m: int, a: float, b: float,
                          cpu: bool):
    """Traceable df shifted real DFT (core.s_shifted_dft_real, nout=n):
    U[k] = sum_{j<n} x_j e^{-2i pi (j+a)(k+b)/m}, x zero-padded to m —
    the workhorse of the odd types V-VIII (Martucci embeddings,
    reference cfftextra.c:481-958) and the CPU-safe route for the
    _cpu_dense sizes of DCT-II/III/IV (pad + ramps + flat FFT: no
    permutation wrapper, so no XLA:CPU compile pathology)."""
    dtype = xh.dtype
    lead = xh.shape[:-1]

    def tab(v):
        return _df_tab_b(v, dtype, lead, cpu)

    j = np.arange(m)
    pre = np.exp(-2j * np.pi * (j + a) * b / m)
    k = np.arange(n)
    post = np.exp(-2j * np.pi * k * a / m)
    pad = [(0, 0)] * (xh.ndim - 1) + [(0, m - n)]
    xph = jnp.pad(xh, pad)
    xpl = jnp.pad(xl, pad)
    ar = df_mul(xph, xpl, *tab(pre.real))
    ai = df_mul(xph, xpl, *tab(pre.imag))
    A = _sfft_hp_body(ar[0], ar[1], ai[0], ai[1], m, False, cpu)
    Ar = (A[0][..., :n], A[1][..., :n])
    Ai = (A[2][..., :n], A[3][..., :n])
    pr = tab(post.real)
    pi_ = tab(post.imag)
    Ur = df_sub(*df_mul(*Ar, *pr), *df_mul(*Ai, *pi_))
    Ui = df_add(*df_mul(*Ar, *pi_), *df_mul(*Ai, *pr))
    return Ur + Ui


_shifted_dft_real_hp_jit = partial(
    jax.jit, static_argnums=(2, 3, 4, 5, 6))(_shifted_real_hp_body)


def _u_hp(x, n: int, m: int, a: float, b: float):
    """Host wrapper: (Re U, Im U) as f64 arrays."""
    xh, xl = _quad_split(x)
    out = _shifted_dft_real_hp_jit(xh, xl, n, m, float(a), float(b),
                                   _on_cpu(xh))
    rh, rl, ih, il = (np.asarray(v) for v in out)
    return df_merge_host(rh, rl), df_merge_host(ih, il)


def _alt_np(n: int):
    return (-1.0) ** np.arange(n)


def _odd_base_hp(kind: str, t: int, x, n: int):
    """The exact linear map of oddtypes._base_* in host f64 around the
    hp shifted DFT (weights and boundary corrections are exact)."""
    if kind == "dct":
        if t == 5:
            return 2.0 * _u_hp(x, n, 2 * n - 1, 0.0, 0.0)[0] - x[..., :1]
        if t == 6:
            return (2.0 * _u_hp(x, n, 2 * n - 1, 0.5, 0.0)[0]
                    - _alt_np(n) * x[..., -1:])
        if t == 7:
            return 2.0 * _u_hp(x, n, 2 * n - 1, 0.0, 0.5)[0] - x[..., :1]
        return 2.0 * _u_hp(x, n, 2 * n + 1, 0.5, 0.5)[0]          # VIII
    if t == 5:
        return -2.0 * _u_hp(x, n, 2 * n + 1, 1.0, 1.0)[1]
    if t == 6:
        return -2.0 * _u_hp(x, n, 2 * n + 1, 0.5, 1.0)[1]
    if t == 7:
        return -2.0 * _u_hp(x, n, 2 * n + 1, 1.0, 0.5)[1]
    w = np.ones(n)
    w[-1] = 0.5                                   # dst8 embedding quirk
    return -2.0 * _u_hp(x * w, n, 2 * n - 1, 0.5, 0.5)[1]


# per-type M and which mode carries the 1/M scale, copied from
# oddtypes.*_apply (golden-verified there): "fwd" = only mode>0 scales,
# "both" = both non-ortho modes scale, "none" = neither
_ODD_SCALE = {
    ("dct", 5): ("fwd", -1), ("dct", 6): ("none", -1),
    ("dct", 7): ("both", -1), ("dct", 8): ("fwd", +1),
    ("dst", 5): ("fwd", +1), ("dst", 6): ("both", +1),
    ("dst", 7): ("none", +1), ("dst", 8): ("fwd", -1),
}


def _odd_apply_hp(kind: str, t: int, x, n: int, mode: int):
    y = _odd_base_hp(kind, t, x, n)
    rule, pm = _ODD_SCALE[(kind, t)]
    M = 2 * n + pm
    if mode == 0:
        return y * (1.0 / np.sqrt(M))
    if rule == "both" or (rule == "fwd" and mode > 0):
        return y * (1.0 / M)
    return y


_ODD_INV = {5: 5, 6: 7, 7: 6, 8: 8}


def _trig_hp(kind: str, x, t: int, norm: str, inverse: bool):
    norm = _hp_norm(norm)
    if t not in range(1, 9):
        raise ValueError(f"{kind}_hp: type must be 1..8, got {t}")
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    if t >= 5:
        # dct._norm_modes semantics: fftpack = full scale forward /
        # unscaled inverse, backward the reverse, ortho orthonormal
        fm, im = (0, 0) if norm == "ortho" else (
            (-1, 1) if norm == "backward" else (1, -1))
        tt = _ODD_INV[t] if inverse else t
        return _odd_apply_hp(kind, tt, x, n, im if inverse else fm)
    fwd = {("dct", 1): dct1_hp, ("dct", 2): dct2_hp, ("dct", 4): dct4_hp,
           ("dst", 1): dst1_hp, ("dst", 2): dst2_hp, ("dst", 4): dst4_hp}
    inv = {("dct", 1): idct1_hp, ("dct", 2): idct2_hp,
           ("dct", 4): idct4_hp, ("dst", 1): idst1_hp,
           ("dst", 2): idst2_hp, ("dst", 4): idst4_hp}
    if t in (1, 2, 4):
        return (inv if inverse else fwd)[(kind, t)](x, norm)
    # type 3 = the other side of the type-2 pairing: forward type 3 ==
    # inverse-of-type-2 up to the norm's scale placement; ortho is the
    # orthonormal transpose.  idct2_hp(fftpack) IS the unscaled type-3
    # core; dct2_hp(fftpack) the fully-scaled type-2 (dct._dct3_apply /
    # _dct2_apply mode algebra).
    if norm == "ortho":
        return (fwd if inverse else inv)[(kind, 2)](x, "ortho")
    if norm == "backward":
        if inverse:                  # full-scale type-2 sum
            return fwd[(kind, 2)](x, "fftpack")
        return inv[(kind, 2)](x, "fftpack")     # unscaled type-3 sum
    if inverse:                      # fftpack: unscaled type-2 sum
        return fwd[(kind, 2)](x, "fftpack") * (n / 2.0)
    return inv[(kind, 2)](x, "fftpack") * (2.0 / n)


def dct_hp(x, type: int = 2, norm: str = DEFAULT_NORM):
    """Forward DCT of ANY type 1..8 at double-float precision — the
    complete reference trig-transform surface (cosq/cost/cfftextra
    V-VIII) at C-double accuracy from f32 pairs.  Same type pairing and
    scaling as ops.dct.dct."""
    return _trig_hp("dct", x, int(type), norm, False)


def idct_hp(y, type: int = 2, norm: str = DEFAULT_NORM):
    """Inverse DCT of any type 1..8: idct_hp(dct_hp(x, t), t) == x."""
    return _trig_hp("dct", y, int(type), norm, True)


def dst_hp(x, type: int = 2, norm: str = DEFAULT_NORM):
    """Forward DST of any type 1..8 at double-float precision."""
    return _trig_hp("dst", x, int(type), norm, False)


def idst_hp(y, type: int = 2, norm: str = DEFAULT_NORM):
    return _trig_hp("dst", y, int(type), norm, True)


def _ndtrig_hp(kind: str, x, t: int, axes, norm: str, inverse: bool):
    """Separable N-D trig transform at double-float precision — the
    host-side row-column composition of the 1-D hp transforms (each
    axis one df device program; the reference 2-D DCT is the same
    separable cosqm composition, cfftextra.c:306-395)."""
    x = np.asarray(x, dtype=np.float64)
    if axes is None:
        axes = tuple(range(x.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    y = x
    for ax in axes:
        ax = int(ax) % x.ndim
        v = np.moveaxis(y, ax, -1) if ax != x.ndim - 1 else y
        v = _trig_hp(kind, v, int(t), norm, inverse)
        y = np.moveaxis(v, -1, ax) if ax != x.ndim - 1 else v
    return y


def dctn_hp(x, type: int = 2, axes=None, norm: str = DEFAULT_NORM):
    """N-D DCT at double-float precision (host f64 in/out); same
    separable semantics as ops.dct.dctn — ``dctn_hp(x, 3, axes=(-2,-1))``
    is the reference dct_2d_forward (cfftextra.c:306-395) at C-double
    accuracy."""
    return _ndtrig_hp("dct", x, int(type), axes, norm, False)


def idctn_hp(y, type: int = 2, axes=None, norm: str = DEFAULT_NORM):
    return _ndtrig_hp("dct", y, int(type), axes, norm, True)


def dstn_hp(x, type: int = 2, axes=None, norm: str = DEFAULT_NORM):
    """N-D DST at double-float precision (host f64 in/out)."""
    return _ndtrig_hp("dst", x, int(type), axes, norm, False)


def idstn_hp(y, type: int = 2, axes=None, norm: str = DEFAULT_NORM):
    return _ndtrig_hp("dst", y, int(type), axes, norm, True)


@partial(jax.jit, static_argnums=(4, 5, 6, 7, 8))
def _gdft_hp_jit(Rh, Rl, Ih, Il, n: int, a: float, b: float,
                 inverse: bool, cpu: bool):
    """Generalized DFT (gdft._gdft_core's ramp composition) on a
    df-complex quad — the last reference transform family at
    double-float precision (cfftextra.c:397-479 analog, with the TRUE
    inverse)."""
    dtype = Rh.dtype
    lead = Rh.shape[:-1]

    def tab(v):
        return _df_tab_b(v, dtype, lead, cpu)

    j = np.arange(n)
    pre = np.exp(-2j * np.pi * j * b / n)
    post = np.exp(-2j * np.pi * (j * a + a * b) / n)
    if inverse:
        pre, post = np.conj(post), np.conj(pre)
    re, im = _cmul_df((Rh, Rl), (Ih, Il),
                      tab(pre.real), tab(pre.imag))
    q = _sfft_hp_body(re[0], re[1], im[0], im[1], n, inverse, cpu)
    re, im = _cmul_df((q[0], q[1]), (q[2], q[3]),
                      tab(post.real), tab(post.imag))
    return re + im


def _gdft_hp(x, a: float, b: float, norm: str, inverse: bool):
    norm = check_norm(norm)
    x = np.asarray(x)
    n = x.shape[-1]
    Rh, Rl = df_split_host(np.asarray(x.real, dtype=np.float64))
    Ih, Il = df_split_host(np.asarray(x.imag, dtype=np.float64))
    q = tuple(jnp.asarray(v) for v in (Rh, Rl, Ih, Il))
    out = _gdft_hp_jit(*q, n, float(a), float(b), inverse, _on_cpu(q[0]))
    rh, rl, ih, il = (np.asarray(v) for v in out)
    y = df_merge_host(rh, rl) + 1j * df_merge_host(ih, il)
    s = inv_scale(norm, n) if inverse else fwd_scale(norm, n)
    return y * np.float64(s) if s != 1.0 else y


def gdft_hp(x, a: float = 0.0, b: float = 0.0, norm: str = DEFAULT_NORM):
    """Generalized DFT at double-float precision (host complex128
    in/out): y[k] = scale * sum_j x[j] e^{-2i pi (j+a)(k+b)/n}."""
    return _gdft_hp(x, a, b, norm, False)


def igdft_hp(y, a: float = 0.0, b: float = 0.0, norm: str = DEFAULT_NORM):
    """True inverse of gdft_hp (the reference's gdft_inverse is broken
    for a != 0 — see ops/gdft.py)."""
    return _gdft_hp(y, a, b, norm, True)
