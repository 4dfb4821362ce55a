"""Real FFT (r2c / c2r), packed (n//2+1) spectrum, plus 2-D real FFT.

Re-design of the reference's real engine (``rfftf1_``/``rfftb1_``
with reversed-factor real radix kernels, cfftpack/
fftpack.c:13517-13854, wrapped by ``rfft_forward``/``rfft_inverse``,
cfftpack.c:433-494; 2-D core ``rfft2f_``/``rfft2b_`` fftpack.c:13113-13445):

* Even n uses the half-length complex trick: pack x into z[j] =
  x[2j] + i*x[2j+1], one length-n/2 complex FFT, then an O(n) split
  stage — the same ~2x win over a full complex FFT the reference gets
  from its real kernels, but expressed as dense vector ops.
* Odd n falls back to a complex FFT of the real input (truncated to
  n//2+1 bins); the inverse rebuilds the full spectrum by conjugate
  symmetry.  Mixed-radix/Bluestein support means ANY length works.
* Output layout matches the reference's packed convention: n//2+1
  complex bins with imag(DC) == 0 and, for even n, imag(Nyquist) == 0
  (cfftpack.c:466-471 zeroes those slots explicitly; so do we).

Scaling: the unscaled cores satisfy irfft_core(rfft_core(x)) == n*x,
so the public API applies the same fwd/inv norm scalars as the complex
path (FFTPACK default: 1/n on forward, none on inverse).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (DEFAULT_NORM, check_norm, complex_dtype_of, fwd_scale,
                      hp_route, inv_scale, real_dtype_of)
from .cfft import _apply_axis, _hp_last_axis

__all__ = ["rfft", "irfft", "rfft2", "irfft2", "rfilter_split",
           "rfft2_split", "irfft2_split"]


def _rfft_core(x, n: int):
    """Unscaled forward DFT of real x over the last axis -> n//2+1 bins.

    Complex boundary over the split engine (core.srfft).
    """
    from . import core
    cdtype = complex_dtype_of(x.dtype)
    yr, yi = core.srfft(x, n)
    return jax.lax.complex(yr, yi).astype(cdtype)


def _irfft_core(y, n: int):
    """Unscaled inverse: returns n * x for y = _rfft_core(x).  Real out."""
    from . import core
    rdtype = real_dtype_of(y.dtype)
    yr = jnp.real(y).astype(rdtype)
    yi = jnp.imag(y).astype(rdtype)
    return core.sirfft(yr, yi, n)


def _rfft_impl(x, axis: int, norm: str):
    x = jnp.asarray(x)
    if jnp.iscomplexobj(x):
        raise TypeError("rfft requires real input; use fft for complex")
    n = x.shape[axis]
    y = _apply_axis(x, axis, partial(_rfft_core, n=n))
    s = fwd_scale(norm, n)
    if s != 1.0:
        y = y * jnp.asarray(s, dtype=y.dtype)
    return y


def _irfft_impl(y, n: int, axis: int, norm: str):
    y = jnp.asarray(y)
    y = y.astype(complex_dtype_of(y.dtype))
    if y.shape[axis] != n // 2 + 1:
        raise ValueError(
            f"irfft: spectrum axis has {y.shape[axis]} bins, expected "
            f"n//2+1 = {n // 2 + 1} for n={n}")
    x = _apply_axis(y, axis, partial(_irfft_core, n=n))
    s = inv_scale(norm, n)
    if s != 1.0:
        x = x * jnp.asarray(s, dtype=x.dtype)
    return x


_rfft_jit = jax.jit(_rfft_impl, static_argnums=(1, 2))
_irfft_jit = jax.jit(_irfft_impl, static_argnums=(1, 2, 3))


def rfft(x, axis: int = -1, norm: str = DEFAULT_NORM):
    """Real-to-complex forward FFT: (..., n) real -> (..., n//2+1) complex.

    Packed layout and FFTPACK 1/n forward scaling match the reference's
    ``rfft_forward`` (cfftpack.c:433-471).  Any length n is supported.

    f64 input under config.set_f64_policy("hp") routes to the
    double-float engine (numpy out) — see ops.cfft.fft.
    """
    if hp_route(x):
        from .hp import rfft_hp
        return _hp_last_axis(rfft_hp, x, axis, norm=norm)
    return _rfft_jit(x, axis, check_norm(norm))


def irfft(y, n: int, axis: int = -1, norm: str = DEFAULT_NORM):
    """Complex-to-real inverse FFT of a packed (n//2+1)-bin spectrum.

    ``n`` is the real output length (the packed layout is ambiguous
    about parity, so it must be given — the reference stores it in the
    plan, cfftintern.h:31-38).
    """
    if hp_route(y):
        from .hp import irfft_hp
        return _hp_last_axis(irfft_hp, y, axis, n=int(n), norm=norm)
    return _irfft_jit(y, int(n), axis, check_norm(norm))


def _rfft2_impl(x, axes, norm: str):
    """2-D real FFT: r2c along axes[-1], complex FFT along axes[0].

    Row-column order mirrors the reference 2-D real core ``rfft2f_``
    (fftpack.c:13282-13445: rfftm along dim 1 then cfftm across rows).
    """
    from .cfft import _fft_impl
    a0, a1 = axes
    y = _rfft_impl(x, a1, norm)
    return _fft_impl(y, a0, norm, inverse=False)


def _irfft2_impl(y, n0_n1, axes, norm: str):
    from .cfft import _fft_impl
    a0, a1 = axes
    n0, n1 = n0_n1
    if y.shape[a0] != n0:
        raise ValueError(
            f"irfft2: axis {a0} has {y.shape[a0]} bins, expected n0={n0}")
    z = _fft_impl(y, a0, norm, inverse=True)
    return _irfft_impl(z, n1, a1, norm)


_rfft2_jit = jax.jit(_rfft2_impl, static_argnums=(1, 2))
_irfft2_jit = jax.jit(_irfft2_impl, static_argnums=(1, 2, 3))


def _hp_trailing2(fn, x, axes, **kw):
    """Run a trailing-2-axes hp transform over ``axes`` of host f64
    data (the opt-in f64->df64 route, config.set_f64_policy("hp"))."""
    x = np.asarray(x)
    axes = tuple(int(a) % x.ndim for a in axes)
    move = axes != (x.ndim - 2, x.ndim - 1)
    if move:
        x = np.moveaxis(x, axes, (-2, -1))
    y = fn(x, **kw)
    if move:
        y = np.moveaxis(y, (-2, -1), axes)
    return y


def rfft2(x, axes=(-2, -1), norm: str = DEFAULT_NORM):
    """2-D real FFT -> (..., n0, n1//2+1) packed complex spectrum.

    f64 input under config.set_f64_policy("hp") routes to the
    double-float engine (numpy out) — see ops.cfft.fft.
    """
    if hp_route(x):
        from .hp import rfft2_hp
        return _hp_trailing2(rfft2_hp, x, axes, norm=norm)
    return _rfft2_jit(x, tuple(int(a) for a in axes), check_norm(norm))


def irfft2(y, s, axes=(-2, -1), norm: str = DEFAULT_NORM):
    """Inverse 2-D real FFT; ``s = (n0, n1)`` is the real output shape."""
    if hp_route(y):
        from .hp import irfft2_hp
        return _hp_trailing2(irfft2_hp, y, axes,
                             s=(int(s[0]), int(s[1])), norm=norm)
    return _irfft2_jit(y, (int(s[0]), int(s[1])),
                       tuple(int(a) for a in axes), check_norm(norm))


# ------------------------------------------------- split (re, im) API

def _as_real_plane(x, name: str):
    """Coerce a REAL-plane operand to a >=32-bit float dtype.

    Complex dtypes are rejected outright: promote_types(complex, f32)
    stays complex, so a complex array would silently flow into the
    real engine and produce wrong results (advisor finding, round 2).
    """
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise TypeError(
            f"{name}: real input required, got {x.dtype} — take .real "
            "explicitly or use the complex fft API")
    if not jnp.issubdtype(x.dtype, jnp.floating):
        return x.astype(jnp.promote_types(x.dtype, jnp.float32))
    if jnp.finfo(x.dtype).bits < 32:      # bf16/f16 twiddles lose ~1e-2
        return x.astype(jnp.float32)
    return x


def _rfft_split_impl(x, axis: int, norm: str):
    from . import core
    x = _as_real_plane(jnp.asarray(x), "rfft_split")
    n = x.shape[axis]
    axis = axis % x.ndim
    move = axis != x.ndim - 1
    if move:
        x = jnp.moveaxis(x, axis, -1)
    yr, yi = core.srfft(x, n)
    s = fwd_scale(norm, n)
    if s != 1.0:
        yr = yr * s
        yi = yi * s
    if move:
        yr = jnp.moveaxis(yr, -1, axis)
        yi = jnp.moveaxis(yi, -1, axis)
    return yr, yi


def _irfft_split_impl(yr, yi, n: int, axis: int, norm: str):
    from . import core
    yr = jnp.asarray(yr)
    yi = jnp.asarray(yi)
    if yr.shape != yi.shape:
        raise ValueError("re/im shapes differ")
    yr = _as_real_plane(yr, "irfft_split")
    if yi.dtype != yr.dtype:
        yi = _as_real_plane(yi, "irfft_split").astype(yr.dtype)
    if yr.shape[axis] != n // 2 + 1:
        raise ValueError(
            f"irfft_split: spectrum axis has {yr.shape[axis]} bins, "
            f"expected n//2+1 = {n // 2 + 1} for n={n}")
    axis = axis % yr.ndim
    move = axis != yr.ndim - 1
    if move:
        yr = jnp.moveaxis(yr, axis, -1)
        yi = jnp.moveaxis(yi, axis, -1)
    x = core.sirfft(yr, yi, n)
    s = inv_scale(norm, n)
    if s != 1.0:
        x = x * s
    if move:
        x = jnp.moveaxis(x, -1, axis)
    return x


_rfft_split_jit = jax.jit(_rfft_split_impl, static_argnums=(1, 2))
_irfft_split_jit = jax.jit(_irfft_split_impl, static_argnums=(2, 3, 4))


def _rfilter_tables(n: int):
    """Host tables c1..c4 (complex, h bins) for the fused real filter.

    Derivation: compose srfft's packed merge Y = Ze + w*Zo, the
    spectral multiply V = F*Y, and sirfft's un-merge Z' = (1+i*conj(w))V
    + (1-i*conj(w))*conj(V_mirror) into Z' = P*Z + Q*conj(Z_mirror)
    with P = c1*F + c3*conj(Fm), Q = c2*F + c4*conj(Fm) — the whole
    filter pipeline then needs NO packed (n/2+1)-bin spectrum at all.
    """
    h = n // 2
    k = np.arange(h)
    w = np.exp(-2j * np.pi * k / n)
    A = 1 + 1j * np.conj(w)
    B = 1 - 1j * np.conj(w)
    return (A * (1 - 1j * w) / 2, A * (1 + 1j * w) / 2,
            B * (1 + 1j * w) / 2, B * (1 - 1j * w) / 2)


def _rfilter_fused_xla(x, fr, fi, n: int):
    """Round-2 fused XLA filter body (even n): deinterleave -> one n/2
    complex FFT -> one half-spectrum FMA -> inverse FFT -> interleave."""
    from . import core
    h = n // 2
    zr = x[..., 0::2]
    zi = x[..., 1::2]
    Zr, Zi = core.sfft(zr, zi, h, inverse=False)
    # in-graph P, Q from the (traced) filter and host tables
    c1, c2, c3, c4 = _rfilter_tables(n)
    c1r, c1i = _t(c1.real, x.dtype), _t(c1.imag, x.dtype)
    c2r, c2i = _t(c2.real, x.dtype), _t(c2.imag, x.dtype)
    c3r, c3i = _t(c3.real, x.dtype), _t(c3.imag, x.dtype)
    c4r, c4i = _t(c4.real, x.dtype), _t(c4.imag, x.dtype)
    Fr, Fi = fr[..., :h], fi[..., :h]
    # conj(Fm): Fm_k = F_{h-k}, k = 0..h-1
    Fmr = fr[..., 1:][..., ::-1]
    Fmi = -fi[..., 1:][..., ::-1]
    Pr = c1r * Fr - c1i * Fi + c3r * Fmr - c3i * Fmi
    Pi = c1r * Fi + c1i * Fr + c3r * Fmi + c3i * Fmr
    Qr = c2r * Fr - c2i * Fi + c4r * Fmr - c4i * Fmi
    Qi = c2r * Fi + c2i * Fr + c4r * Fmi + c4i * Fmr
    # Z' = P*Z + Q*conj(Zm); mirror via slice+flip (fuses into FMA)
    def zmul(pr, pi, qr, qi, Ar, Ai, Br, Bi):
        # (pr+ipi)(Ar+iAi) + (qr+iqi)(Br-iBi)
        re = pr * Ar - pi * Ai + qr * Br + qi * Bi
        im = pr * Ai + pi * Ar + qi * Br - qr * Bi
        return re, im
    Z0r, Z0i = zmul(Pr[..., :1], Pi[..., :1], Qr[..., :1],
                    Qi[..., :1], Zr[..., :1], Zi[..., :1],
                    Zr[..., :1], Zi[..., :1])
    Zcr_, Zci_ = zmul(Pr[..., 1:], Pi[..., 1:], Qr[..., 1:],
                      Qi[..., 1:], Zr[..., 1:], Zi[..., 1:],
                      Zr[..., 1:][..., ::-1], Zi[..., 1:][..., ::-1])
    Zpr = jnp.concatenate([Z0r, Zcr_], axis=-1)
    Zpi = jnp.concatenate([Z0i, Zci_], axis=-1)
    wr_, wi_ = core.sfft(Zpr, Zpi, h, inverse=True)
    return core._interleave(wr_, wi_)


def _rfilter_split_impl(x, fr, fi, axis: int, norm: str):
    """Fused irfft(rfft(x) * F): deinterleave -> one n/2 complex FFT ->
    one half-spectrum FMA -> inverse FFT -> interleave.

    Skips the packed-spectrum merge AND un-merge (each a full memory
    pass) of the rfft -> multiply -> irfft composition — the
    hot path of every reference conv app (vargamma.c:42-106,
    blackscholes.cpp:30-80).
    """
    from . import core
    x = _as_real_plane(jnp.asarray(x), "rfilter_split")
    fr = _as_real_plane(jnp.asarray(fr), "rfilter_split").astype(x.dtype)
    fi = _as_real_plane(jnp.asarray(fi), "rfilter_split").astype(x.dtype)
    n = x.shape[axis]
    if fr.shape[-1] != n // 2 + 1 or fi.shape[-1] != n // 2 + 1:
        raise ValueError(
            f"rfilter_split: filter must have n//2+1 = {n // 2 + 1} "
            f"packed bins, got {fr.shape[-1]}")
    axis = axis % x.ndim
    move = axis != x.ndim - 1
    if move:
        x = jnp.moveaxis(x, axis, -1)
    s = fwd_scale(norm, n) * inv_scale(norm, n)
    if n % 2:
        # odd n: plain composition (no half-length packing to fuse)
        yr, yi = core.srfft(x, n)
        tr = yr * fr - yi * fi
        ti = yr * fi + yi * fr
        out = core.sirfft(tr, ti, n)
    elif (fr.ndim == 1
          and core._use_bodychunk(n, core._flat_batch(x.shape))):
        # huge batch: chunk the whole fused body (same gate as the
        # dct/rfft pipelines)
        out = core.map_body_chunks(
            lambda c: _rfilter_fused_xla(c, fr, fi, n), x, n)
    else:
        out = _rfilter_fused_xla(x, fr, fi, n)
    # the unscaled pipeline is sirfft(srfft(x)*F); the public
    # composition applies fwd_scale then inv_scale on top
    if s != 1.0:
        out = out * jnp.asarray(s, dtype=out.dtype)
    if move:
        out = jnp.moveaxis(out, -1, axis)
    return out


def _t(tab, dtype):
    return jnp.asarray(tab, dtype=dtype)


_rfilter_split_jit = jax.jit(_rfilter_split_impl, static_argnums=(3, 4))


def rfilter_split(x, fr, fi, axis: int = -1, norm: str = DEFAULT_NORM):
    """Fused real spectral filter: irfft(rfft(x) * (fr + i*fi)).

    ``(fr, fi)`` is the packed (n//2+1)-bin filter spectrum (the split
    form of a real filter's rfft).  Exactly equal to the composition
    ``irfft_split(*{rfft_split(x) complex-multiplied by F}, n)`` for
    every norm, but runs one half-length FFT + one fused FMA + one
    inverse — no packed-spectrum merge/un-merge passes.

    The filter's DC and (even n) Nyquist bins must be REAL
    (``fi[0] == fi[n//2] == 0``) — always true for the rfft of a real
    filter, which is this function's contract.
    """
    return _rfilter_split_jit(x, fr, fi, axis, check_norm(norm))


def rfft_split(x, axis: int = -1, norm: str = DEFAULT_NORM):
    """r2c FFT returning an (re, im) pair of real arrays."""
    return _rfft_split_jit(x, axis, check_norm(norm))


def irfft_split(yr, yi, n: int, axis: int = -1, norm: str = DEFAULT_NORM):
    """c2r inverse of an (re, im) packed-spectrum pair."""
    return _irfft_split_jit(yr, yi, int(n), axis, check_norm(norm))


def _pad_lanes(a, hp: int):
    pad = [(0, 0)] * (a.ndim - 1) + [(0, hp - a.shape[-1])]
    return jnp.pad(a, pad)


def _ragged_pad(shape, axes) -> int:
    """Pad target (a multiple of 128) for the packed n1//2+1 spectrum
    axis, or 0.

    The 2-D real transform's middle passes (complex FFT over axis a0 +
    its two transposes) otherwise run on a ragged (16k+1)-wide minor
    axis; padding around them and slicing after is bit-identical.  The
    pad was a win on the earlier backend and is unmeasured on the
    H100.  Only the trailing-two-axes layout keeps the ragged axis
    minor, so only that case pads; XLA:CPU does not pad."""
    import jax
    nd = len(shape)
    a0, a1 = (ax % nd for ax in axes)
    if (a0, a1) != (nd - 2, nd - 1) or jax.default_backend() == "cpu":
        return 0
    h = shape[a1]
    hp = -(-h // 128) * 128
    return hp if hp != h else 0


def _rfft2_split_core(x, axes, norm: str):
    from .cfft import _fft_split_impl
    a0, a1 = axes
    yr, yi = _rfft_split_impl(x, a1, norm)
    hp = _ragged_pad(yr.shape, (a0, a1))
    if hp:
        yr = _pad_lanes(yr, hp)
        yi = _pad_lanes(yi, hp)
    yr, yi = _fft_split_impl(yr, yi, a0, norm, inverse=False)
    if hp:
        h = x.shape[a1] // 2 + 1
        yr = yr[..., :h]
        yi = yi[..., :h]
    return yr, yi


def _irfft2_split_core(yr, yi, n0_n1, axes, norm: str):
    from .cfft import _fft_split_impl
    a0, a1 = axes
    n0, n1 = n0_n1
    if yr.shape[a0] != n0:
        raise ValueError(f"irfft2_split: axis {a0} has {yr.shape[a0]} "
                         f"bins, expected n0={n0}")
    # validate the packed axis BEFORE the pad: _ragged_pad would
    # otherwise zero-pad/slice a malformed axis to exactly n1//2+1 bins
    # and the length check downstream could never fire where the pad
    # applies (every backend must reject identically)
    if yr.shape[a1] != n1 // 2 + 1:
        raise ValueError(
            f"irfft2_split: axis {a1} has {yr.shape[a1]} bins, expected "
            f"n1//2+1 = {n1 // 2 + 1} for n1={n1}")
    hp = _ragged_pad(yr.shape, (a0, a1))
    if hp:
        yr = _pad_lanes(yr, hp)
        yi = _pad_lanes(yi, hp)
    zr, zi = _fft_split_impl(yr, yi, a0, norm, inverse=True)
    if hp:
        h = n1 // 2 + 1
        zr = zr[..., :h]
        zi = zi[..., :h]
    return _irfft_split_impl(zr, zi, n1, a1, norm)


_rfft2_split_jit = jax.jit(_rfft2_split_core, static_argnums=(1, 2))
_irfft2_split_jit = jax.jit(_irfft2_split_core, static_argnums=(2, 3, 4))


def rfft2_split(x, axes=(-2, -1), norm: str = DEFAULT_NORM):
    """2-D real FFT -> (re, im) pair with shape (..., n0, n1//2+1).
    Same row-column semantics as :func:`rfft2` (rfft2f_,
    cfftpack/fftpack.c:13282-13445).  Sharded variant:
    parallel/fft2d.rfft2_sharded_split."""
    return _rfft2_split_jit(x, tuple(int(a) for a in axes),
                            check_norm(norm))


def irfft2_split(yr, yi, s, axes=(-2, -1), norm: str = DEFAULT_NORM):
    """Inverse of :func:`rfft2_split`; ``s = (n0, n1)`` is the real
    output shape (packed spectra are parity-ambiguous)."""
    return _irfft2_split_jit(yr, yi, (int(s[0]), int(s[1])),
                             tuple(int(a) for a in axes),
                             check_norm(norm))
