"""Global configuration: normalization conventions and dtype policy.

The reference library (cfftpack, cfftpack/cfftpack.h:58-66)
uses FFTPACK scaling: the *forward* transform is scaled by 1/N and the
inverse is unscaled — the opposite of numpy/FFTW.  An orthonormal toggle
(`fft_ortho`, cfftpack.h:67) switches both directions to 1/sqrt(N).

We expose this as a ``norm`` parameter:

=============  ====================  ====================
norm           forward scale         inverse scale
=============  ====================  ====================
``"fftpack"``  1/N                   1       (reference default)
``"ortho"``    1/sqrt(N)             1/sqrt(N)
``"backward"`` 1                     1/N     (numpy/scipy default)
``"forward"``  1/N                   1       (alias of fftpack)
=============  ====================  ====================
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

VALID_NORMS = ("fftpack", "ortho", "backward", "forward")
DEFAULT_NORM = "fftpack"


def check_norm(norm: str | None) -> str:
    if norm is None:
        return DEFAULT_NORM
    if norm not in VALID_NORMS:
        raise ValueError(f"norm must be one of {VALID_NORMS}, got {norm!r}")
    return norm


def fwd_scale(norm: str, n: int) -> float:
    """Scalar applied to the forward transform output."""
    norm = check_norm(norm)
    if norm in ("fftpack", "forward"):
        return 1.0 / n
    if norm == "ortho":
        return float(1.0 / np.sqrt(n))  # Python float: no f64 promotion
    return 1.0  # backward


def inv_scale(norm: str, n: int) -> float:
    """Scalar applied to the inverse transform output."""
    norm = check_norm(norm)
    if norm in ("fftpack", "forward"):
        return 1.0
    if norm == "ortho":
        return float(1.0 / np.sqrt(n))  # Python float: no f64 promotion
    return 1.0 / n  # backward


# ---------------------------------------------------------- f64 policy
#
# The reference's precision contract is the C double everywhere
# (fft_real_t, cfftpack/fftpack.h:59-64).  By default double inputs run
# natively in f64.  The "hp" policy is an explicit opt-in that routes
# double-precision inputs of the MAIN dtype API to the double-float
# engine (ops/hp.py: f64-class accuracy from paired f32, ~5e-15 rel) on
# any backend.  Routed calls take host f64 arrays and RETURN host numpy
# f64 arrays (the hp engine splits/merges the df pairs at the host
# boundary).

_F64_POLICY = "native"      # "native" = f64 runs as f64;
                            # "hp" = route f64 to the df engine

_F64_DTYPES = (np.dtype(np.float64), np.dtype(np.complex128))


def set_f64_policy(policy: str) -> None:
    """Choose how double inputs run: ``"native"`` (default) computes in
    f64; ``"hp"`` routes them to the double-float engine (host numpy
    out)."""
    global _F64_POLICY
    if policy not in ("hp", "native"):
        raise ValueError(f"f64 policy must be 'hp' or 'native', got "
                         f"{policy!r}")
    _F64_POLICY = policy


def f64_policy() -> str:
    return _F64_POLICY


def hp_route(*arrays) -> bool:
    """True when these inputs should run on the double-float engine:
    the "hp" policy is set and any operand is f64/complex128.

    Checked BEFORE jnp.asarray in the public dtype-API wrappers —
    with x64 disabled jnp would silently truncate the doubles to f32
    long before the engine saw them."""
    if _F64_POLICY != "hp":
        return False
    for x in arrays:
        dt = getattr(x, "dtype", None)
        if dt is None:
            dt = np.asarray(x).dtype
        if np.dtype(dt) in _F64_DTYPES:
            return True
    return False


def real_dtype_of(dtype) -> jnp.dtype:
    """Real dtype underlying a complex (or real) dtype."""
    d = jnp.dtype(dtype)
    if d == jnp.complex64:
        return jnp.dtype(jnp.float32)
    if d == jnp.complex128:
        return jnp.dtype(jnp.float64)
    return d


def complex_dtype_of(dtype) -> jnp.dtype:
    """Complex dtype matching a real (or complex) dtype's precision."""
    d = jnp.dtype(dtype)
    if d in (jnp.dtype(jnp.float64), jnp.dtype(jnp.complex128)):
        return jnp.dtype(jnp.complex128)
    return jnp.dtype(jnp.complex64)
