"""Split-complex (re, im) transform engine.

The ENGINE works on pairs of real arrays (re, im); the complex-dtype
API in cfft.py/rfft.py is a thin boundary wrapper over it, and the
``*_split`` entry points (used by the bench, apps and sharded paths)
call it directly.  Whether split planes beat native complex dtypes on
the H100 is unmeasured.

Algorithms mirror the complex engine (see cfft.py's docstring for the
reference mapping to fftpack.c's c1fm1f_/radix kernels): Stockham
autosort mixed radix 2/3/4/5 + dense-matrix odd radices + Bluestein
for large primes.  All tables are host-precomputed float64, cast to
the working dtype at trace time.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import plan

__all__ = ["sfft", "srfft", "sirfft"]

_SQ3_2 = float(np.sqrt(3.0) / 2.0)
_C5_1, _S5_1 = float(np.cos(2 * np.pi / 5)), float(np.sin(2 * np.pi / 5))
_C5_2, _S5_2 = float(np.cos(4 * np.pi / 5)), float(np.sin(4 * np.pi / 5))


def _slice_axis(T, j: int, ax: int):
    idx = [slice(None)] * T.ndim
    idx[ax] = j
    return T[tuple(idx)]


def _butterfly(Tr, Ti, p: int, inverse: bool, axis: int = -2):
    """Length-p DFT over ``axis`` of an (re, im) pair."""
    sgn = 1.0 if inverse else -1.0
    ax = axis % Tr.ndim
    R = [_slice_axis(Tr, j, ax) for j in range(p)]
    I = [_slice_axis(Ti, j, ax) for j in range(p)]
    if p == 1:
        return Tr, Ti
    if p == 2:
        return (jnp.stack([R[0] + R[1], R[0] - R[1]], axis=ax),
                jnp.stack([I[0] + I[1], I[0] - I[1]], axis=ax))
    if p == 3:
        tr, ti = R[1] + R[2], I[1] + I[2]
        dr, di = R[1] - R[2], I[1] - I[2]
        m1r = R[0] - 0.5 * tr
        m1i = I[0] - 0.5 * ti
        # m2 = sgn*1j*sq32*d  ->  re: -sgn*sq32*di, im: sgn*sq32*dr
        m2r = -(sgn * _SQ3_2) * di
        m2i = (sgn * _SQ3_2) * dr
        return (jnp.stack([R[0] + tr, m1r + m2r, m1r - m2r], axis=ax),
                jnp.stack([I[0] + ti, m1i + m2i, m1i - m2i], axis=ax))
    if p == 4:
        ar, ai = R[0] + R[2], I[0] + I[2]
        br, bi = R[0] - R[2], I[0] - I[2]
        cr, ci = R[1] + R[3], I[1] + I[3]
        # d = sgn*1j*(T1-T3)
        dr = -sgn * (I[1] - I[3])
        di = sgn * (R[1] - R[3])
        return (jnp.stack([ar + cr, br + dr, ar - cr, br - dr], axis=ax),
                jnp.stack([ai + ci, bi + di, ai - ci, bi - di], axis=ax))
    if p == 5:
        t1r, t1i = R[1] + R[4], I[1] + I[4]
        t2r, t2i = R[2] + R[3], I[2] + I[3]
        t3r, t3i = R[1] - R[4], I[1] - I[4]
        t4r, t4i = R[2] - R[3], I[2] - I[3]
        u0r, u0i = R[0] + t1r + t2r, I[0] + t1i + t2i
        a1r = R[0] + _C5_1 * t1r + _C5_2 * t2r
        a1i = I[0] + _C5_1 * t1i + _C5_2 * t2i
        a2r = R[0] + _C5_2 * t1r + _C5_1 * t2r
        a2i = I[0] + _C5_2 * t1i + _C5_1 * t2i
        # b1 = sgn*1j*(s1*t3 + s2*t4); b2 = sgn*1j*(s2*t3 - s1*t4)
        b1r = -sgn * (_S5_1 * t3i + _S5_2 * t4i)
        b1i = sgn * (_S5_1 * t3r + _S5_2 * t4r)
        b2r = -sgn * (_S5_2 * t3i - _S5_1 * t4i)
        b2i = sgn * (_S5_2 * t3r - _S5_1 * t4r)
        return (jnp.stack([u0r, a1r + b1r, a2r + b2r, a2r - b2r,
                           a1r - b1r], axis=ax),
                jnp.stack([u0i, a1i + b1i, a2i + b2i, a2i - b2i,
                           a1i - b1i], axis=ax))
    # generic small prime: dense p x p DFT matrix.  precision=HIGHEST
    # keeps the f32 contraction in true f32 (on the GPU a lower setting
    # may run it in TF32, ~1e-3 relative error).
    D = plan.dft_matrix(p)
    if inverse:
        D = np.conj(D)
    Dr = jnp.asarray(D.real, dtype=Tr.dtype)
    Di = jnp.asarray(D.imag, dtype=Tr.dtype)
    if ax != Tr.ndim - 2:
        Tr = jnp.moveaxis(Tr, ax, -2)
        Ti = jnp.moveaxis(Ti, ax, -2)
    kw = dict(precision=jax.lax.Precision.HIGHEST,
              preferred_element_type=Tr.dtype)
    Yr = (jnp.einsum("kp,...pj->...kj", Dr, Tr, **kw)
          - jnp.einsum("kp,...pj->...kj", Di, Ti, **kw))
    Yi = (jnp.einsum("kp,...pj->...kj", Dr, Ti, **kw)
          + jnp.einsum("kp,...pj->...kj", Di, Tr, **kw))
    if ax != Yr.ndim - 2:
        Yr = jnp.moveaxis(Yr, -2, ax)
        Yi = jnp.moveaxis(Yi, -2, ax)
    return Yr, Yi


def _stockham(xr, xi, n: int, inverse: bool):
    if n == 1:
        return xr, xi
    shape = xr.shape
    Sr = xr.reshape(-1, 1, n)
    Si = xi.reshape(-1, 1, n)
    B = Sr.shape[0]
    L, m = 1, n
    for p, tw in zip(plan.factor(n), plan.stage_twiddles(n)):
        mn = m // p
        Ur, Ui = _butterfly(Sr.reshape(B, L, p, mn), Si.reshape(B, L, p, mn),
                            p, inverse)
        if mn > 1:
            twr = jnp.asarray(tw.real, dtype=xr.dtype)[None, None]
            twi_ = tw.imag if not inverse else -tw.imag
            twi = jnp.asarray(twi_, dtype=xr.dtype)[None, None]
            Vr = Ur * twr - Ui * twi
            Vi = Ur * twi + Ui * twr
            Ur, Ui = Vr, Vi
        Sr = jnp.swapaxes(Ur, 1, 2).reshape(B, L * p, mn)
        Si = jnp.swapaxes(Ui, 1, 2).reshape(B, L * p, mn)
        L *= p
        m = mn
    return Sr.reshape(shape), Si.reshape(shape)


def _cmul_tab(xr, xi, tr, ti):
    """(xr + i xi) * (tr + i ti) with host-table (tr, ti)."""
    return xr * tr - xi * ti, xr * ti + xi * tr


# --------------------------------------------- large-n four-step (local)
#
# The flat Stockham engine materializes every stage with the remaining
# transform length in the minor axis; at large n each stage becomes a
# full pass over device memory.  Large n at small batch therefore runs
# the four-step decomposition n = n1*n2 IN-CORE (the single-device
# analog of parallel/fourstep.py; ancestor cfft2f_'s row-column pass,
# cfftpack/fftpack.c:2363-2434):
#
#   x[j1*n2 + j2] as (n1, n2):  FFT over j1 (axis -2, n2 minor — no
#   transpose!), twiddle e^{sgn 2i pi k1 j2/n}, FFT over j2 (last axis),
#   one final (k1, k2) -> k2-major transpose for natural order.

# Dispatch thresholds.  They were tuned on the earlier backend and are
# unmeasured on the H100; each is re-measured against the unchunked
# program before it is kept (ROADMAP queue 1 item 3).
_FOURSTEP_MIN = 8192          # four-step from this n at small batch
_DENSE_N1_MAX = 64            # outer DFT as one dense einsum up to this
_LANE_BATCH = 128             # flat engine needs >= this batch; also
                              # the lax.map chunk size
_BIG_ELEMS = 1 << 24          # past this, chunk the batch (see _fft_any)
_MAPFOUR_MIN_N = 1 << 17      # chunked four-step from this n, chunked
                              # flat below it


def _dft_axis2_dense(xr, xi, n1: int, inverse: bool):
    """DFT over axis -2 of (..., n1, nl) as one dense contraction.

    For small n1 the (n1, n1) matrix contraction keeps the minor axis
    untouched, where a butterfly-stage formulation over axis -2 would
    relayout every pass.  precision=HIGHEST keeps it in true f32 (not
    TF32 on the GPU).
    """
    D = plan.dft_matrix(n1)
    if inverse:
        D = np.conj(D)
    Dr = jnp.asarray(D.real, dtype=xr.dtype)
    Di = jnp.asarray(D.imag, dtype=xr.dtype)
    kw = dict(precision=jax.lax.Precision.HIGHEST,
              preferred_element_type=xr.dtype)
    Yr = (jnp.einsum("kj,...jl->...kl", Dr, xr, **kw)
          - jnp.einsum("kj,...jl->...kl", Di, xi, **kw))
    Yi = (jnp.einsum("kj,...jl->...kl", Dr, xi, **kw)
          + jnp.einsum("kj,...jl->...kl", Di, xr, **kw))
    return Yr, Yi


def _fourstep_split_n(n: int) -> tuple[int, int] | None:
    """n1*n2 == n with n1 the divisor closest to 64 in [8, 256].

    The target n1 = 64 was tuned on the earlier backend and is
    unmeasured on the H100; overlong n2 recurses through _fft_any, so
    n2 is unbounded here.  None if no divisor of n lies in the window
    (then the flat engine runs)."""
    best = None
    for n1 in range(8, 257):
        if n % n1 == 0 and n // n1 >= 128:
            if best is None or abs(n1 - 64) < abs(best - 64):
                best = n1
    if best is None:
        return None
    return best, n // best


def _fourstep_local(xr, xi, n: int, inverse: bool):
    """In-core four-step: x[j1*n2+j2] as (n1, n2); outer DFT over j1
    (dense einsum for n1 <= 64, else transpose + recursive flat FFT),
    twiddle, flat FFT over j2, digit-reversal transpose to natural
    order."""
    n1, n2 = _fourstep_split_n(n)
    lead = xr.shape[:-1]
    x2r = xr.reshape(lead + (n1, n2))
    x2i = xi.reshape(lead + (n1, n2))
    if n1 <= _DENSE_N1_MAX:
        Ar, Ai = _dft_axis2_dense(x2r, x2i, n1, inverse)
    else:
        tr = jnp.swapaxes(x2r, -1, -2)
        ti = jnp.swapaxes(x2i, -1, -2)
        tr, ti = _fft_any(tr, ti, n1, inverse)
        Ar = jnp.swapaxes(tr, -1, -2)
        Ai = jnp.swapaxes(ti, -1, -2)
    # twiddle e^{sgn*2i pi k1 j2 / n}
    k1 = np.arange(n1)[:, None]
    j2 = np.arange(n2)[None, :]
    sgn = 2j * np.pi / n if inverse else -2j * np.pi / n
    tw = np.exp(sgn * (k1 * j2))
    Tr, Ti = _cmul_tab(Ar, Ai, jnp.asarray(tw.real, dtype=xr.dtype),
                       jnp.asarray(tw.imag, dtype=xr.dtype))
    # FFT over j2 (last axis); n1 joins the batch.  The leading dims are
    # flattened first so the stage chain runs on a 2-D (B*n1, n2) array.
    Yr, Yi = _stockham(Tr.reshape(-1, n2), Ti.reshape(-1, n2), n2, inverse)
    Yr = Yr.reshape(lead + (n1, n2))
    Yi = Yi.reshape(lead + (n1, n2))
    # natural order: X[k1 + n1*k2] -> k2-major flatten
    Yr = jnp.swapaxes(Yr, -1, -2).reshape(lead + (n,))
    Yi = jnp.swapaxes(Yi, -1, -2).reshape(lead + (n,))
    return Yr, Yi


def _map_chunks(fn, xr, xi, bc: int):
    """Apply ``fn`` over ``bc``-row batch chunks with a sequential
    lax.map, so each chunk's stage chain works on a bounded slice
    instead of one program over the whole working set."""
    lead = xr.shape[:-1]
    n = xr.shape[-1]
    cr = xr.reshape(-1, bc, n)
    ci = xi.reshape(-1, bc, n)
    yr, yi = jax.lax.map(lambda c: fn(c[0], c[1]), (cr, ci))
    return yr.reshape(lead + (n,)), yi.reshape(lead + (n,))


def _fft_any(xr, xi, n: int, inverse: bool):
    """Engine dispatch, batch-aware (thresholds above, unmeasured on
    the H100):

    * small batch (< _LANE_BATCH rows) at n >= _FOURSTEP_MIN: the
      in-core four-step.
    * huge working sets (>= _BIG_ELEMS elements): a sequential lax.map
      over batch chunks (chunked four-step for n >= _MAPFOUR_MIN_N,
      chunked flat otherwise).
    * everything else: the flat Stockham chain.
    """
    bp = 1
    for d in xr.shape[:-1]:
        bp *= int(d)
    split = _fourstep_split_n(n)
    if n >= _FOURSTEP_MIN and bp < _LANE_BATCH and split is not None:
        return _fourstep_local(xr, xi, n, inverse)
    if bp * n >= _BIG_ELEMS and bp % 32 == 0:
        if n >= _MAPFOUR_MIN_N and split is not None:
            return _map_chunks(
                lambda a, b: _fourstep_local(a, b, n, inverse), xr, xi, 32)
        if bp % _LANE_BATCH == 0 and bp >= 2 * _LANE_BATCH:
            return _map_chunks(
                lambda a, b: _stockham(a, b, n, inverse), xr, xi,
                _LANE_BATCH)
    return _stockham(xr, xi, n, inverse)


def _bluestein(xr, xi, n: int, inverse: bool):
    m, chirp, bq = plan.bluestein_tables(n)
    if inverse:
        chirp = np.conj(chirp)
        bq = np.conj(bq)
    cr = jnp.asarray(chirp.real, dtype=xr.dtype)
    ci = jnp.asarray(chirp.imag, dtype=xr.dtype)
    ar, ai = _cmul_tab(xr, xi, cr, ci)
    pad = [(0, 0)] * (xr.ndim - 1) + [(0, m - n)]
    ar = jnp.pad(ar, pad)
    ai = jnp.pad(ai, pad)
    Ar, Ai = _fft_any(ar, ai, m, inverse=False)
    br = jnp.asarray(bq.real, dtype=xr.dtype)
    bi = jnp.asarray(bq.imag, dtype=xr.dtype)
    Cr, Ci = _cmul_tab(Ar, Ai, br, bi)
    Er, Ei = _fft_any(Cr, Ci, m, inverse=True)
    s = 1.0 / m
    Er = Er[..., :n] * s
    Ei = Ei[..., :n] * s
    return _cmul_tab(Er, Ei, cr, ci)


def sfft(xr, xi, n: int, inverse: bool):
    """Unscaled mixed-radix DFT over the last axis of an (re, im) pair.

    Engine choice is batch-aware (flat Stockham / in-core four-step /
    batch-chunked lax.map); see _fft_any for the dispatch.
    """
    if plan.needs_bluestein(n):
        return _bluestein(xr, xi, n, inverse)
    return _fft_any(xr, xi, n, inverse)


# ------------------------------------------------------- real transforms
#
# Even-n r2c/c2r use the half-length complex trick with the split/merge
# stage FUSED into a single 4-term table FMA over (Z, Z-mirror) — no
# ragged (n/2+1)-wide intermediates, no scatter fix-ups.  Derivation:
# Y_k = Ze_k + w_k Zo_k with Ze = (Z + conj(Zm))/2, Zo = -i(Z -
# conj(Zm))/2, Zm_k = Z_{(h-k)%h}; expanding in (Zr, Zi, Zmr, Zmi)
# gives per-bin linear combinations with host-precomputed f64 tables.
# (The former formulation materialized several ragged (B, n/2+1)
# arrays plus two dynamic-update-slice passes.)


def _zmirror(Zr, Zi):
    """Z_{(h-k) mod h}: bin 0 fixed, others lane-reversed."""
    Zmr = jnp.concatenate([Zr[..., :1], Zr[..., 1:][..., ::-1]], axis=-1)
    Zmi = jnp.concatenate([Zi[..., :1], Zi[..., 1:][..., ::-1]], axis=-1)
    return Zmr, Zmi


def _rfft_merge_tables(n: int):
    """Coefficients of (Zr, Zi, Zmr, Zmi) for yr, yi at bins 0..h-1."""
    h = n // 2
    k = np.arange(h)
    w = np.exp(-2j * np.pi * k / n)
    wr, wi = w.real, w.imag
    return ((1 + wi) / 2, wr / 2, (1 - wi) / 2, wr / 2,
            -wr / 2, (1 + wi) / 2, wr / 2, (wi - 1) / 2)


def _irfft_merge_tables(n: int):
    """Coefficients of (ya, yb, ymr, ymi) for Zr, Zi at bins 0..h-1."""
    h = n // 2
    k = np.arange(h)
    w = np.exp(-2j * np.pi * k / n)
    wr, wi = w.real, w.imag
    # Zr = (ya+ymr) - wr*(yb+ymi) + wi*(ya-ymr)
    # Zi = (yb-ymi) + wr*(ya-ymr) + wi*(yb+ymi)
    return (1 + wi, -wr, 1 - wi, -wr,
            wr, 1 + wi, -wr, wi - 1)


def _t(tab, dtype):
    return jnp.asarray(tab, dtype=dtype)


# Real-engine formulation: "half" = half-length complex trick (even n
# only), "pair" = batch-pair packing (any n, needs even flat batch),
# "auto" = pair for odd n only.  The batch-pair trick packs ADJACENT
# BATCH ROWS z = x[2r] + i*x[2r+1] into one full-length complex FFT at
# half the batch, instead of the half-length trick's stride-2
# deinterleave of the minor axis.
# Classic two-for-one real-FFT identity; reference analog: the real
# kernels' r2c packing rfftf1_ (fftpack.c:13517-13610).
_RFFT_ENGINE = "auto"

# Interleave (riffle) idiom for y[..., s*t+j] = parts[j][..., t]
# — the final un-permutation of the real/DCT cores.  Two formulations:
# "stack" = jnp.stack(..., -1)+reshape; "select" = broadcast each
# stream across the pair dim and select.  auto = stack; the choice was
# made on the earlier backend and is unmeasured on the H100.
_RIFFLE_IDIOM = "auto"
_RIFFLE_SELECT_MIN = 1 << 62


def _interleave(*parts, idiom: str | None = None):
    """Riffle s equal-length streams: out[..., s*t+j] = parts[j][..., t].
    ``idiom`` overrides the module policy for call sites with their
    own crossover (dct4 at large n)."""
    s = len(parts)
    m = parts[0].shape[-1]
    n = s * m
    lead = parts[0].shape[:-1]
    idiom = idiom or _RIFFLE_IDIOM
    if idiom == "auto":
        idiom = "select" if n >= _RIFFLE_SELECT_MIN else "stack"
    if idiom == "select":
        lane = jnp.asarray(np.arange(n) % s, jnp.int32)
        reps = [jnp.broadcast_to(p[..., None], (*p.shape, s)
                                 ).reshape(*lead, n) for p in parts]
        out = reps[-1]
        for j in range(s - 2, -1, -1):
            out = jnp.where(lane == j, reps[j], out)
        return out
    return jnp.stack(parts, axis=-1).reshape(*lead, n)


def _flat_batch(shape) -> int:
    b = 1
    for d in shape[:-1]:
        b *= int(d)
    return b


def _srfft_batchpair(x, n: int):
    """r2c via batch pairing: one length-n complex FFT at batch/2.

    U = rfft(x[2r]), V = rfft(x[2r+1]) from Z = fft(x[2r] + i x[2r+1]):
    U = (Z + conj(Zm))/2, V = -i(Z - conj(Zm))/2, Zm_k = Z_{(n-k)%n}.
    imag(DC) and (even n) imag(Nyquist) are EXACT zeros by construction
    (a-a cancellation), preserving the packed contract.
    """
    lead = x.shape[:-1]
    B = _flat_batch(x.shape)
    h = n // 2
    xp = x.reshape(B // 2, 2, n)
    Zr, Zi = sfft(xp[:, 0], xp[:, 1], n, inverse=False)
    Z0r = Zr[..., : h + 1]
    Z0i = Zi[..., : h + 1]
    # Zm bins 0..h: bin 0 is Z_0; k>=1 reads Z_{n-k} = slice+flip
    Zmr = jnp.concatenate([Zr[..., :1], Zr[..., n - h:][..., ::-1]],
                          axis=-1)
    Zmi = jnp.concatenate([Zi[..., :1], Zi[..., n - h:][..., ::-1]],
                          axis=-1)
    Ur = 0.5 * (Z0r + Zmr)
    Ui = 0.5 * (Z0i - Zmi)
    Vr = 0.5 * (Z0i + Zmi)
    Vi = 0.5 * (Zmr - Z0r)
    yr = jnp.stack([Ur, Vr], axis=-2).reshape(lead + (h + 1,))
    yi = jnp.stack([Ui, Vi], axis=-2).reshape(lead + (h + 1,))
    return yr, yi


def _sirfft_batchpair(yr, yi, n: int):
    """c2r inverse via batch pairing: rebuild Z = U + iV for row pairs,
    one length-n inverse FFT at batch/2; u = Re, v = Im.  Returns n*x."""
    lead = yr.shape[:-1]
    B = _flat_batch(yr.shape)
    h = n // 2
    ar = yr.reshape(B // 2, 2, h + 1)
    ai = yi.reshape(B // 2, 2, h + 1)
    Ur, Vr = ar[:, 0], ar[:, 1]
    Ui, Vi = ai[:, 0], ai[:, 1]
    # bins 0..h: Z = U + iV; bins h+1..n-1: conj(U_{n-k}) + i conj(V_{n-k})
    Zr_low = Ur - Vi
    Zi_low = Ui + Vr
    Umr = Ur[..., 1: n - h][..., ::-1]
    Umi = Ui[..., 1: n - h][..., ::-1]
    Vmr = Vr[..., 1: n - h][..., ::-1]
    Vmi = Vi[..., 1: n - h][..., ::-1]
    Zr_hi = Umr + Vmi
    Zi_hi = Vmr - Umi
    Zr = jnp.concatenate([Zr_low, Zr_hi], axis=-1)
    Zi = jnp.concatenate([Zi_low, Zi_hi], axis=-1)
    zr, zi = sfft(Zr, Zi, n, inverse=True)
    out = jnp.stack([zr, zi], axis=-2).reshape(lead + (n,))
    return out


def _use_pair(n: int, B: int) -> bool:
    if _RFFT_ENGINE == "pair":
        return B % 2 == 0 and B >= 2 and n > 1
    if _RFFT_ENGINE != "auto":
        return False
    if B % 2 or B < 2 or n <= 1:
        return False
    # auto: odd n (the half-length trick does not apply there, so the
    # pair path halves the FFT work outright)
    return n % 2 == 1


def _use_bodychunk(n: int, B: int) -> bool:
    """Huge-batch real/DCT pipelines: chunk the WHOLE body (not just
    the inner FFT) through lax.map once the working set passes
    _BIG_ELEMS, with at least 16 chunks of _LANE_BATCH rows.  This is
    the 2-D row-pass shape, so dctn/rfft2 inherit it.  Results are
    bit-identical to the unchunked body.  The gate was tuned on the
    earlier backend and is unmeasured on the H100."""
    return (B * n >= _BIG_ELEMS and B % _LANE_BATCH == 0
            and B >= 16 * _LANE_BATCH)


def map_body_chunks(fn, x, n_out: int):
    """lax.map ``fn`` over _LANE_BATCH-row chunks of the flat batch.
    ``fn`` maps (bc, n) -> (bc, n_out) or a tuple of such."""
    lead = x.shape[:-1]
    xc = x.reshape(-1, _LANE_BATCH, x.shape[-1])
    out = jax.lax.map(fn, xc)
    return jax.tree_util.tree_map(
        lambda o: o.reshape(lead + (n_out,)), out)


def srfft(x, n: int):
    """Unscaled r2c DFT of real x -> (re, im) pair of n//2+1 bins.

    Even n: half-length complex trick with the fused merge stage above;
    odd n: full pair FFT of (x, 0), truncated.  imag(DC) and (even n)
    imag(Nyquist) are exact zeros by construction.
    """
    if n == 1:
        return x, jnp.zeros_like(x)
    if _use_pair(n, _flat_batch(x.shape)):
        return _srfft_batchpair(x, n)
    if _use_bodychunk(n, _flat_batch(x.shape)):
        return map_body_chunks(lambda c: srfft(c, n), x, n // 2 + 1)
    if n % 2 == 0:
        zr = x[..., 0::2]
        zi = x[..., 1::2]
        Zr, Zi = sfft(zr, zi, n // 2, inverse=False)
        # interior bins k = 1..h-1 read Z and its conjugate mirror as
        # SLICE+FLIP operands (no concat-mirror array: XLA fuses the
        # reversed read into the FMA; the concat formulation
        # materialized an extra pass)
        a1, a2, a3, a4, b1, b2, b3, b4 = (
            _t(t[1:], x.dtype) for t in _rfft_merge_tables(n))
        Zrc = Zr[..., 1:]
        Zic = Zi[..., 1:]
        Zrf = Zrc[..., ::-1]
        Zif = Zic[..., ::-1]
        yr_c = Zrc * a1 + Zic * a2 + Zrf * a3 + Zif * a4
        yi_c = Zrc * b1 + Zic * b2 + Zrf * b3 + Zif * b4
        # DC and Nyquist from bin 0; their imag parts are EXACT zeros
        # (reference contract, cfftpack.c:466-471)
        dc = Zr[..., :1] + Zi[..., :1]
        nyq = Zr[..., :1] - Zi[..., :1]
        z1 = jnp.zeros_like(dc)
        yr = jnp.concatenate([dc, yr_c, nyq], axis=-1)
        yi = jnp.concatenate([z1, yi_c, z1], axis=-1)
        return yr, yi
    Yr, Yi = sfft(x, jnp.zeros_like(x), n, inverse=False)
    yr = Yr[..., : n // 2 + 1]
    yi = Yi[..., : n // 2 + 1]
    yi = yi.at[..., 0].set(0.0)
    return yr, yi


def sirfft(yr, yi, n: int):
    """Unscaled c2r inverse of a packed pair: returns n * x (real)."""
    if n == 1:
        return yr[..., 0:1]
    if _use_pair(n, _flat_batch(yr.shape)):
        return _sirfft_batchpair(yr, yi, n)
    if _use_bodychunk(n, _flat_batch(yr.shape)):
        lead = yr.shape[:-1]
        h1 = yr.shape[-1]
        ac = yr.reshape(-1, _LANE_BATCH, h1)
        bc = yi.reshape(-1, _LANE_BATCH, h1)
        out = jax.lax.map(lambda c: sirfft(c[0], c[1], n), (ac, bc))
        return out.reshape(lead + (n,))
    if n % 2 == 0:
        h = n // 2
        ya = yr[..., :h]
        yb = yi[..., :h]
        # yr_{h-k}, k = 0..h-1: slice FIRST so the flip runs on the
        # h-wide slice, not the ragged (h+1)-wide array
        ymr = yr[..., 1:][..., ::-1]
        ymi = yi[..., 1:][..., ::-1]
        a1, a2, a3, a4, b1, b2, b3, b4 = (
            _t(t, yr.dtype) for t in _irfft_merge_tables(n))
        Zr = ya * a1 + yb * a2 + ymr * a3 + ymi * a4
        Zi = ya * b1 + yb * b2 + ymr * b3 + ymi * b4
        zr, zi = sfft(Zr, Zi, h, inverse=True)
        return _interleave(zr, zi)
    tr = yr[..., 1:][..., ::-1]
    ti = -yi[..., 1:][..., ::-1]
    fr = jnp.concatenate([yr, tr], axis=-1)
    fi = jnp.concatenate([yi, ti], axis=-1)
    zr, _ = sfft(fr, fi, n, inverse=True)
    return zr


# ----------------------------------------------- shifted DFT (split)

def s_shifted_dft_real(x, n: int, m: int, a: float, b: float, nout: int):
    """U[k] = sum_{j<n} x[j] e^{-2i pi (j+a)(k+b)/m} for REAL x,
    zero-padded to m, returned as an (re, im) pair of nout bins.

    Split-real version of gdft.shifted_dft_padded — the workhorse of
    DCT-IV and the odd types V-VIII.
    """
    j = np.arange(m)
    pre = np.exp(-2j * np.pi * (j + a) * b / m)
    k = np.arange(nout)
    post = np.exp(-2j * np.pi * k * a / m)
    pad = [(0, 0)] * (x.ndim - 1) + [(0, m - n)]
    xp = jnp.pad(x, pad)
    ar = xp * jnp.asarray(pre.real, dtype=x.dtype)
    ai = xp * jnp.asarray(pre.imag, dtype=x.dtype)
    Ar, Ai = sfft(ar, ai, m, inverse=False)
    Ar = Ar[..., :nout]
    Ai = Ai[..., :nout]
    pr = jnp.asarray(post.real, dtype=x.dtype)
    pi_ = jnp.asarray(post.imag, dtype=x.dtype)
    return Ar * pr - Ai * pi_, Ar * pi_ + Ai * pr
