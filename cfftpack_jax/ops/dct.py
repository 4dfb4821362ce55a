"""DCT/DST types I-IV over the last axis, FFT-based, any length.

Re-design of the reference's cosine/sine machinery
(cfftpack/fftpack.c cosq/cost/sinq/sint drivers
:5374-6611, 14123-15122, wrapped by cfftpack.c:155-431 and the DCT-IV/
DST-IV composites cfftextra.c:132-303):

* DCT-II/III use Makhoul's N-point algorithm: an even/odd interleave
  permutation + one length-N complex FFT + a phase rotation — fully
  parallel dense vector ops instead of FFTPACK's fold/recurrence
  pre/post stages (cosqf1_/cosqb1_ fftpack.c:5576-5741), which are
  sequential and hostile to vectorization.
* DST-II/III come from DCT-II/III by the classic flip/sign identities
  (the same trick the reference uses, sinq1f_ fftpack.c:14201-14270).
* DCT-I embeds into a 2(N-1) even extension, DST-I into a 2(N+1) odd
  extension, both via one real FFT (cost1f_/sint1f_ analogs).
* DCT-IV embeds into a length-2N half-shift GDFT (phase-ramped FFT);
  DST-IV = flip/sign of DCT-IV (as cfftextra.c:289-303).

Scaling modes follow the reference wrapper conventions:
``norm="fftpack"`` applies FFTPACK's full forward scaling and an
unscaled inverse (dct == cosq pair semantics, cfftpack.c:155-221);
``norm="ortho"`` is orthonormal both ways (including the DCT-I
boundary correction the reference implements by hand,
cfftpack.c:249-279); ``norm="backward"`` scales the inverse only.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_NORM, check_norm, hp_route
from .cfft import _apply_axis, _hp_last_axis

__all__ = ["dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn"]

_SQRT2 = float(np.sqrt(2.0))


def _cexp_half(n: int, sign: float) -> np.ndarray:
    """exp(sign * 1j*pi*k/(2n)) for k=0..n-1 (host f64 table)."""
    k = np.arange(n)
    return np.exp(sign * 1j * np.pi / (2 * n) * k)


# ---------------------------------------------------------------- cores
# All cores are "unscaled": plain trig sums with FFTPACK's half-term
# conventions (the mode<0 semantics of the reference's naive test
# oracles, test/naivepack.c:12-228).

def _dct2_tables(n: int):
    """Even n.  Coefficients of (Zr, Zi, Zmr, Zmi) at output bin k,
    shaped (2, n/2) so the (B, h) operands broadcast straight to the
    (B, 2, h) output (k = c*h + j) with NO mirror/concat assembly.

    Derivation: y_k = Re(ph_k V_k), V_k = Ze_{k%h} + w_k Zo_{k%h}
    (valid for ALL k < n since Ze/Zo are h-periodic and w picks up the
    half-period sign), ph = e^{-i pi k/(2n)}; substituting Ze/Zo in
    (Z, conj(Zm)) and collecting terms gives, with q = ph*w =
    e^{-5i pi k/(2n)}:  y = T1*Zr + T2*Zi + T3*Zmr + T4*Zmi.
    """
    h = n // 2
    k = np.arange(n)
    ph = np.exp(-1j * np.pi * k / (2 * n))
    q = np.exp(-5j * np.pi * k / (2 * n))
    T1 = (ph.real + q.imag) / 2
    T2 = (q.real - ph.imag) / 2
    T3 = (ph.real - q.imag) / 2
    T4 = (ph.imag + q.real) / 2
    return tuple(t.reshape(2, h) for t in (T1, T2, T3, T4))


def _dct2_core(x, n: int):
    """y[k] = sum_j x[j] cos(pi*k*(2j+1)/(2n))  (Makhoul N-point).

    Even n runs the FUSED path: the Makhoul permutation is composed
    with the half-length packing into direct stride-4 gathers of x, one
    n/2-point complex FFT (core.sfft), and a single broadcast table-FMA
    producing all n outputs — replacing the reference's sequential
    cosqf1_ fold/rotate/rfft/unpack pipeline (fftpack.c:5665-5741) with
    three data-parallel passes.  Split-real throughout.
    """
    from . import core
    if n == 1:
        return x
    if core._use_bodychunk(n, core._flat_batch(x.shape)):
        # huge batch: chunk the WHOLE gather+FFT+table pipeline, not
        # just the inner FFT (gate in core._use_bodychunk); the 2-D
        # dctn row pass lives here
        return core.map_body_chunks(lambda c: _dct2_core(c, n), x, n)
    if n % 2:
        # odd n: Makhoul permutation + full-length real DFT
        v = jnp.concatenate([x[..., 0::2], x[..., 1::2][..., ::-1]],
                            axis=-1)
        Vr, Vi = core.srfft(v, n)                  # bins 0..n//2
        ph = _cexp_half(n, -1.0)
        phr = jnp.asarray(ph.real, dtype=x.dtype)
        phi = jnp.asarray(ph.imag, dtype=x.dtype)
        h = n // 2
        y_low = phr[: h + 1] * Vr - phi[: h + 1] * Vi
        Vr_u = Vr[..., 1:][..., ::-1]
        Vi_u = Vi[..., 1:][..., ::-1]
        y_high = phr[h + 1:] * Vr_u + phi[h + 1:] * Vi_u
        return jnp.concatenate([y_low, y_high], axis=-1)
    h = n // 2
    if n % 4 == 0:
        # z_p = v[2p] + i v[2p+1] with v = [x_even, rev(x_odd)]
        # composes to stride-4 gathers of x
        zr = jnp.concatenate([x[..., 0::4], x[..., 3::4][..., ::-1]],
                             axis=-1)
        zi = jnp.concatenate([x[..., 2::4], x[..., 1::4][..., ::-1]],
                             axis=-1)
    else:
        v = jnp.concatenate([x[..., 0::2], x[..., 1::2][..., ::-1]],
                            axis=-1)
        zr = v[..., 0::2]
        zi = v[..., 1::2]
    Zr, Zi = core.sfft(zr, zi, h, inverse=False)
    T1, T2, T3, T4 = _dct2_tables(n)
    # interior bins via slice+flip mirror operands (fuses into the FMA;
    # see core.srfft note), bin-0 column from Z_0 where Zm == Z
    t1, t2, t3, t4 = (jnp.asarray(t[:, 1:], dtype=x.dtype)
                      for t in (T1, T2, T3, T4))
    Zrc = Zr[..., None, 1:]
    Zic = Zi[..., None, 1:]
    Zrf = Zrc[..., ::-1]
    Zif = Zic[..., ::-1]
    y_c = t1 * Zrc + t2 * Zic + t3 * Zrf + t4 * Zif
    c0r = jnp.asarray((T1 + T3)[:, :1], dtype=x.dtype)
    c0i = jnp.asarray((T2 + T4)[:, :1], dtype=x.dtype)
    y_0 = c0r * Zr[..., None, :1] + c0i * Zi[..., None, :1]
    y2 = jnp.concatenate([y_0, y_c], axis=-1)
    return y2.reshape(*x.shape[:-1], n)


def _dct3_tables(n: int):
    """Even n.  Coefficients of the gathered quadruple
    (x_k, x_{n-k}, x_{h-k}, x_{h+k}) for (Zr, Zi) at bins k = 0..h-1.

    Composition of the DCT-III phase stage V_k = ph_k (x_k - i x_{n-k})
    with the c2r merge (see core._irfft_merge_tables) so the whole
    pre-FFT pipeline is ONE table FMA instead of phase + merge passes
    over ragged (n/2+1)-wide arrays.
    """
    h = n // 2
    k = np.arange(h)
    ph = np.exp(1j * np.pi * k / (2 * n))
    phr, phi = ph.real, ph.imag
    phF = np.exp(1j * np.pi * (h - k) / (2 * n))
    phrF, phiF = phF.real, phF.imag
    w = np.exp(-2j * np.pi * k / n)
    wr, wi = w.real, w.imag
    A = (phr * (1 + wi) - wr * phi, phi * (1 + wi) + wr * phr,
         phrF * (1 - wi) - wr * phiF, phiF * (1 - wi) + wr * phrF)
    B = (phi * (1 + wi) + wr * phr, -phr * (1 + wi) + wr * phi,
         -phiF * (1 - wi) - wr * phrF, phrF * (1 - wi) - wr * phiF)
    return A, B


def _dct3_core(x, n: int):
    """y[k] = x[0]/2 + sum_{j>=1} x[j] cos(pi*j*(2k+1)/(2n)).

    EVERY even n runs the fused path: four slice/flip gathers of x, one
    table FMA building the half-length spectrum directly, one inverse
    complex FFT, and a 4-way interleave writing all n outputs (the
    composed Makhoul + re/im un-permutations).  For n % 4 == 2 the four
    interleave streams are ragged (q+1, q+1, q, q); equal-length m =
    (n+2)//4 streams stay in range, so one stack emits n+2 entries and
    a tail slice drops the 2 extras — still a single pass.  Odd n keeps
    the phase + c2r formulation.
    """
    from . import core
    if n == 1:
        return 0.5 * x
    if core._use_bodychunk(n, core._flat_batch(x.shape)):
        return core.map_body_chunks(lambda c: _dct3_core(c, n), x, n)
    h = n // 2
    if n % 2 == 0:
        m = (n + 2) // 4 if n % 4 else n // 4
        z0 = jnp.zeros_like(x[..., :1])
        xa = x[..., :h]                                   # x_k
        xb = jnp.concatenate([z0, x[..., h + 1:][..., ::-1]], axis=-1)
        xc = x[..., 1: h + 1][..., ::-1]                  # x_{h-k}
        xd = x[..., h:]                                   # x_{h+k}
        A, B = _dct3_tables(n)
        a1, a2, a3, a4 = (jnp.asarray(t, dtype=x.dtype) for t in A)
        b1, b2, b3, b4 = (jnp.asarray(t, dtype=x.dtype) for t in B)
        Zr = xa * a1 + xb * a2 + xc * a3 + xd * a4
        Zi = xa * b1 + xb * b2 + xc * b3 + xd * b4
        zr, zi = core.sfft(Zr, Zi, h, inverse=True)
        zr = 0.5 * zr
        zi = 0.5 * zi
        # y[4u..4u+3] = [zr_u, zi_{h-1-u}, zi_u, zr_{h-1-u}]
        y4 = core._interleave(zr[..., :m], zi[..., h - m:][..., ::-1],
                              zi[..., :m], zr[..., h - m:][..., ::-1])
        return y4[..., :n] if 4 * m != n else y4
    xr = x[..., 1:][..., ::-1]  # x[n-k] for k=1..n-1
    pad = jnp.zeros_like(x[..., :1])
    xnk = jnp.concatenate([pad, xr], axis=-1)  # x[n-k], x[n]==0
    ph = _cexp_half(n, +1.0)
    phr = jnp.asarray(ph.real, dtype=x.dtype)
    phi = jnp.asarray(ph.imag, dtype=x.dtype)
    # V = ph * (x - i*xnk); w = IDFT(V) is real, so V is conjugate-
    # symmetric: only bins 0..n//2 are needed and the inverse is one
    # c2r transform (half-length trick inside core.sirfft)
    Vr = (phr * x + phi * xnk)[..., : h + 1]
    Vi = (phi * x - phr * xnk)[..., : h + 1]
    wr = core.sirfft(Vr, Vi, n)                 # unscaled c2r inverse
    v = 0.5 * wr
    # un-permute: y[2j] = v[j], y[2j+1] = v[n-1-j] (n odd here — every
    # even n takes the fused path above — so the riffle is ragged:
    # half evens, half-1 odds; lane scatter)
    half = (n + 1) // 2
    out = jnp.zeros_like(v)
    out = out.at[..., 0::2].set(v[..., :half])
    out = out.at[..., 1::2].set(v[..., half:][..., ::-1])
    return out


def _alt_sign(n: int) -> np.ndarray:
    return (-1.0) ** np.arange(n)


def _dst2_core(x, n: int):
    """y[k] = sum_j x[j] sin(pi*(k+1)*(2j+1)/(2n)) = flip(dct2((-1)^j x))."""
    s = jnp.asarray(_alt_sign(n), dtype=x.dtype)
    return _dct2_core(x * s, n)[..., ::-1]


def _dst3_core(x, n: int):
    """y[k] = (-1)^k x[n-1]/2 + sum_{j<n-1} x[j] sin(pi*(j+1)*(2k+1)/(2n))."""
    s = jnp.asarray(_alt_sign(n), dtype=x.dtype)
    return s * _dct3_core(x[..., ::-1], n)


def _dct1_re(x, n: int):
    """Re(DFT of the even extension): x0 + (-1)^k x_{n-1} + 2*sum_mid."""
    from . import core
    m = 2 * (n - 1)
    ext = jnp.concatenate([x, x[..., 1:-1][..., ::-1]], axis=-1)
    yr, _ = core.srfft(ext, m)  # bins 0..n-1
    return yr


def _dst1_core(x, n: int):
    """y[k] = sum_j x[j] sin(pi*(j+1)*(k+1)/(n+1)) via odd extension."""
    from . import core
    m = 2 * (n + 1)
    z = jnp.zeros_like(x[..., :1])
    ext = jnp.concatenate([z, x, z, -x[..., ::-1]], axis=-1)
    _, yi = core.srfft(ext, m)  # bins 0..n+1
    return (-0.5) * yi[..., 1: n + 1]


def _dct4_core(x, n: int):
    """y[k] = sum_j x[j] cos(pi*(k+.5)*(j+.5)/n).

    Even n: the classic half-length algorithm — pack pairs
    c[p] = x[2p] + i*x[n-1-2p], pre/post quarter-phase rotations around
    ONE n/2-point FFT; y[2t] = Re, y[n-1-2t] = -Im.  4x cheaper than
    the reference's composite (two half-length DCT-IIs plus recurrence,
    cfftextra.c:132-244) in sequential ops and fully parallel.
    Odd n: half-shift GDFT embedding of length 2n (any length works,
    unlike the reference's even-only dct4, cfftextra.h:34-36).
    """
    from . import core
    if core._use_bodychunk(n, core._flat_batch(x.shape)):
        # same whole-body chunking as _dct2_core
        return core.map_body_chunks(lambda c: _dct4_core(c, n), x, n)
    if n % 2 == 0 and n >= 4:
        h = n // 2
        p = np.arange(h)
        cr = x[..., 0::2]
        ci = x[..., ::-1][..., 0::2]          # x[n-1-2p]
        pre = np.exp(-1j * np.pi * p / n)
        post = np.exp(-1j * np.pi * (2 * p + 0.5) / (2 * n))
        prer = jnp.asarray(pre.real, dtype=x.dtype)
        prei = jnp.asarray(pre.imag, dtype=x.dtype)
        wr = cr * prer - ci * prei
        wi = cr * prei + ci * prer
        Wr, Wi = core.sfft(wr, wi, h, inverse=False)
        postr = jnp.asarray(post.real, dtype=x.dtype)
        posti = jnp.asarray(post.imag, dtype=x.dtype)
        zr = Wr * postr - Wi * posti
        zi = Wr * posti + Wi * postr
        # y[2t] = Re z[t], y[2t+1] = -Im z[h-1-t] (riffle idiom per
        # core._interleave).  The select idiom from n >= 16384 is a
        # crossover carried from the earlier backend, unmeasured on the
        # H100.
        idm = "select" if n >= 16384 else None
        return core._interleave(zr, -zi[..., ::-1], idiom=idm)
    m = 2 * n
    # U[k] = sum_{j<2n} xpad[j] e^{-2i pi (j+.5)(k+.5)/(2n)}
    ur, _ = core.s_shifted_dft_real(x, n, m, 0.5, 0.5, n)
    return ur


def _dst4_core(x, n: int):
    """y[k] = sum_j x[j] sin(pi*(k+.5)*(j+.5)/n) = (-1)^k dct4(flip(x))."""
    s = jnp.asarray(_alt_sign(n), dtype=x.dtype)
    return s * _dct4_core(x[..., ::-1], n)


# ------------------------------------------------------ scaling wrappers

def _ends_weight(n: int, w: float, dtype) -> jnp.ndarray:
    v = np.ones(n)
    v[0] = w
    v[-1] = w
    return jnp.asarray(v, dtype=dtype)


def _dct1_apply(x, n: int, mode: int):
    """DCT-I with oracle-mode scaling: +1 fftpack fwd, -1 unscaled, 0 ortho.

    The ortho mode reproduces the reference's hand-built orthonormal
    DCT-I (cfftpack_orthogonal_dct1, cfftpack.c:249-279) in closed form.
    """
    if n < 2:
        raise ValueError("dct type 1 requires n >= 2")
    M = n - 1.0
    re = _dct1_re(x, n)
    sgn = jnp.asarray(_alt_sign(n), dtype=x.dtype)
    x0 = x[..., :1]
    xN = x[..., -1:]
    if mode > 0:  # fftpack forward: (x0/2 + sum + (-1)^k xN/2)*(2/M), ends/2
        y = re * (1.0 / M)
        return y * _ends_weight(n, 0.5, x.dtype)
    if mode < 0:  # unscaled: x0 + (-1)^k xN + sum
        return 0.5 * re + 0.5 * (x0 + sgn * xN)
    # ortho: sqrt(2/M)*(x0/sqrt2 + sum + (-1)^k xN/sqrt2), ends /sqrt2
    c = 1.0 / _SQRT2 - 0.5
    y = 0.5 * re + c * (x0 + sgn * xN)
    y = y * float(np.sqrt(2.0 / M))
    return y * _ends_weight(n, 1.0 / _SQRT2, x.dtype)


def _dst1_apply(x, n: int, mode: int):
    y = _dst1_core(x, n)
    if mode > 0:
        return y * (2.0 / (n + 1))
    if mode < 0:
        return y
    return y * float(np.sqrt(2.0 / (n + 1)))


def _dct2_apply(x, n: int, mode: int):
    if mode < 0:  # unscaled — the reference's DCT-II side (cosq1b_)
        return _dct2_core(x, n)
    if mode > 0:  # fftpack "forward carries the scale" pairing
        return _dct2_core(x, n) * (2.0 / n)
    # ortho: y0*sqrt(1/n), yk*sqrt(2/n)
    y = _dct2_core(x, n)
    w = np.full(n, np.sqrt(2.0 / n))
    w[0] = np.sqrt(1.0 / n)
    return y * jnp.asarray(w, dtype=x.dtype)


def _dct3_apply(x, n: int, mode: int):
    if mode < 0:
        return _dct3_core(x, n)
    if mode > 0:  # fftpack forward (cosq1f_): 2/n overall
        return _dct3_core(x, n) * (2.0 / n)
    # ortho (transpose of orthonormal DCT-II): column scales sqrt(2/n),
    # except the DC column 1/sqrt(n); the core's built-in 1/2 on x0
    # means the input weight there is 2/sqrt(n).
    w = np.full(n, np.sqrt(2.0 / n))
    w[0] = 2.0 / np.sqrt(n)
    xs = x * jnp.asarray(w, dtype=x.dtype)
    return _dct3_core(xs, n)


def _dst2_apply(x, n: int, mode: int):
    if mode < 0:
        return _dst2_core(x, n)
    if mode > 0:
        return _dst2_core(x, n) * (2.0 / n)
    y = _dst2_core(x, n)
    w = np.full(n, np.sqrt(2.0 / n))
    w[-1] = np.sqrt(1.0 / n)
    return y * jnp.asarray(w, dtype=x.dtype)


def _dst3_apply(x, n: int, mode: int):
    if mode < 0:
        return _dst3_core(x, n)
    if mode > 0:
        return _dst3_core(x, n) * (2.0 / n)
    # ortho (transpose of orthonormal DST-II): column scales sqrt(2/n),
    # except the Nyquist column 1/sqrt(n); core halves x[n-1], so 2/sqrt(n).
    w = np.full(n, np.sqrt(2.0 / n))
    w[-1] = 2.0 / np.sqrt(n)
    xs = x * jnp.asarray(w, dtype=x.dtype)
    return _dst3_core(xs, n)


def _dct4_apply(x, n: int, mode: int):
    y = _dct4_core(x, n)
    if mode > 0:
        return y * (2.0 / n)
    if mode < 0:
        return y
    return y * float(np.sqrt(2.0 / n))


def _dst4_apply(x, n: int, mode: int):
    y = _dst4_core(x, n)
    if mode > 0:
        return y * (2.0 / n)
    if mode < 0:
        return y
    return y * float(np.sqrt(2.0 / n))


from .oddtypes import (dct5_apply, dct6_apply, dct7_apply, dct8_apply,
                       dst5_apply, dst6_apply, dst7_apply, dst8_apply)

_FWD = {1: _dct1_apply, 2: _dct2_apply, 3: _dct3_apply, 4: _dct4_apply,
        5: dct5_apply, 6: dct6_apply, 7: dct7_apply, 8: dct8_apply}
_FWD_S = {1: _dst1_apply, 2: _dst2_apply, 3: _dst3_apply, 4: _dst4_apply,
          5: dst5_apply, 6: dst6_apply, 7: dst7_apply, 8: dst8_apply}
# operator inverse of each type (I/IV/V/VIII are involutions up to scale;
# VI and VII are transposes of each other, Martucci 1994)
_INV_TYPE = {1: 1, 2: 3, 3: 2, 4: 4, 5: 5, 6: 7, 7: 6, 8: 8}


def _norm_modes(norm: str) -> tuple[int, int]:
    """(forward mode, inverse mode) per norm.

    fftpack: full scale forward, unscaled inverse (reference default).
    ortho:   orthonormal both ways.
    backward/forward aliases follow the complex-FFT table in config.py:
    "forward" == fftpack; "backward" puts the full scale on the inverse.
    """
    if norm in ("fftpack", "forward"):
        return 1, -1
    if norm == "ortho":
        return 0, 0
    return -1, 1  # backward


def _check_type(t) -> int:
    t = int(t)
    if t not in (1, 2, 3, 4, 5, 6, 7, 8):
        raise ValueError(f"transform type must be 1..8, got {t}")
    return t


def _prep_real(x):
    x = jnp.asarray(x)
    if jnp.iscomplexobj(x):
        raise TypeError("DCT/DST require real input")
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(jnp.float64)
    return x


def _run(table, t: int, x, axis: int, mode: int):
    n = x.shape[axis]
    return _apply_axis(x, axis, partial(table[t], n=n, mode=mode))


def _dct_impl(x, t: int, axis: int, norm: str, inverse: bool):
    fm, im = _norm_modes(norm)
    if inverse:
        return _run(_FWD, _INV_TYPE[t], x, axis, im)
    return _run(_FWD, t, x, axis, fm)


def _dst_impl(x, t: int, axis: int, norm: str, inverse: bool):
    fm, im = _norm_modes(norm)
    if inverse:
        return _run(_FWD_S, _INV_TYPE[t], x, axis, im)
    return _run(_FWD_S, t, x, axis, fm)


_dct_jit = jax.jit(_dct_impl, static_argnums=(1, 2, 3, 4))
_dst_jit = jax.jit(_dst_impl, static_argnums=(1, 2, 3, 4))


def _hp_trig_route(kind: str, x, t: int, axis: int, norm: str,
                   inverse: bool):
    """f64 input under config.set_f64_policy("hp") -> the double-float
    engine (host f64 out); see ops.cfft.fft."""
    from . import hp
    fn = {("dct", False): hp.dct_hp, ("dct", True): hp.idct_hp,
          ("dst", False): hp.dst_hp, ("dst", True): hp.idst_hp}[
              (kind, inverse)]
    return _hp_last_axis(fn, x, axis, type=t, norm=norm)


def dct(x, type: int = 2, axis: int = -1, norm: str = DEFAULT_NORM):
    """Forward DCT of the given type (1-8) along ``axis``.

    norm="fftpack" follows the reference pairing: the type-3 transform
    carries the full 2/N scaling (it is FFTPACK's "forward" DCT,
    cfftpack.h:143-158) and types 2 (and the I/IV involutions' inverse
    direction) are unscaled; ``idct`` undoes ``dct`` for every norm.

    f64 input under config.set_f64_policy("hp") routes to the
    double-float engine (numpy out) — see ops.cfft.fft.
    """
    if hp_route(x):
        return _hp_trig_route("dct", x, _check_type(type), axis,
                              norm, False)
    return _dct_jit(_prep_real(x), _check_type(type), axis,
                    check_norm(norm), False)


def idct(x, type: int = 2, axis: int = -1, norm: str = DEFAULT_NORM):
    """Inverse DCT: idct(dct(x, type=t), type=t) == x for every norm."""
    if hp_route(x):
        return _hp_trig_route("dct", x, _check_type(type), axis,
                              norm, True)
    return _dct_jit(_prep_real(x), _check_type(type), axis,
                    check_norm(norm), True)


def dst(x, type: int = 2, axis: int = -1, norm: str = DEFAULT_NORM):
    """Forward DST of the given type (1-8) along ``axis``."""
    if hp_route(x):
        return _hp_trig_route("dst", x, _check_type(type), axis,
                              norm, False)
    return _dst_jit(_prep_real(x), _check_type(type), axis,
                    check_norm(norm), False)


def idst(x, type: int = 2, axis: int = -1, norm: str = DEFAULT_NORM):
    """Inverse DST: idst(dst(x, type=t), type=t) == x for every norm."""
    if hp_route(x):
        return _hp_trig_route("dst", x, _check_type(type), axis,
                              norm, True)
    return _dst_jit(_prep_real(x), _check_type(type), axis,
                    check_norm(norm), True)


# ------------------------------------------------------------- N-D forms

def _nd_impl(impl, x, t: int, axes, norm: str, inverse: bool):
    y = x
    for ax in axes:
        y = impl(y, t, ax, norm, inverse)
    return y


_dctn_jit = jax.jit(partial(_nd_impl, _dct_impl), static_argnums=(1, 2, 3, 4))
_dstn_jit = jax.jit(partial(_nd_impl, _dst_impl), static_argnums=(1, 2, 3, 4))


def _norm_axes(x, axes):
    if axes is None:
        return tuple(range(x.ndim))
    if isinstance(axes, int):
        return (axes,)
    return tuple(int(a) for a in axes)


def dctn(x, type: int = 2, axes=None, norm: str = DEFAULT_NORM):
    """N-D DCT: separable 1-D passes per axis.

    ``dctn(x, 3, axes=(-2, -1))`` reproduces the reference's
    ``dct_2d_forward`` (batched cosqmf row+column passes,
    cfftextra.c:306-395); ``idctn(x, 3, ...)`` its inverse.

    f64 input under config.set_f64_policy("hp") routes to the
    double-float engine (numpy out) — see ops.cfft.fft.
    """
    if hp_route(x):
        from .hp import dctn_hp
        return dctn_hp(x, type=_check_type(type), axes=axes, norm=norm)
    x = _prep_real(x)
    return _dctn_jit(x, _check_type(type), _norm_axes(x, axes),
                     check_norm(norm), False)


def idctn(x, type: int = 2, axes=None, norm: str = DEFAULT_NORM):
    if hp_route(x):
        from .hp import idctn_hp
        return idctn_hp(x, type=_check_type(type), axes=axes, norm=norm)
    x = _prep_real(x)
    return _dctn_jit(x, _check_type(type), _norm_axes(x, axes),
                     check_norm(norm), True)


def dstn(x, type: int = 2, axes=None, norm: str = DEFAULT_NORM):
    if hp_route(x):
        from .hp import dstn_hp
        return dstn_hp(x, type=_check_type(type), axes=axes, norm=norm)
    x = _prep_real(x)
    return _dstn_jit(x, _check_type(type), _norm_axes(x, axes),
                     check_norm(norm), False)


def idstn(x, type: int = 2, axes=None, norm: str = DEFAULT_NORM):
    if hp_route(x):
        from .hp import idstn_hp
        return idstn_hp(x, type=_check_type(type), axes=axes, norm=norm)
    x = _prep_real(x)
    return _dstn_jit(x, _check_type(type), _norm_axes(x, axes),
                     check_norm(norm), True)
