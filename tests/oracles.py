"""Naive O(n^2) numpy oracles with FFTPACK scaling conventions.

Re-derived from the textbook definitions; semantics match the reference
test oracles (test/naivepack.c):

* naive_fft  — forward DFT scaled by 1/n ("would be 1.0 in most other
  libraries", naivepack.c:107); ortho => 1/sqrt(n).
* naive_ifft — unscaled inverse DFT; ortho => 1/sqrt(n).
* DCT/DST I-IV with the FFTPACK fwd/inv/ortho scalings
  (naivepack.c:12-228).
* DCT/DST V-VIII from the Martucci (1994) definitions with the
  reference's chosen scalings (cfftextra.c:481-958).

mode convention for the mode-based oracles: >0 = FFTPACK forward scaling,
<0 = unscaled inverse, 0 = orthonormal (matches naivepack.c).
"""
import numpy as np


def naive_fft(x, ortho=False):
    x = np.asarray(x, dtype=np.complex128)
    n = x.shape[-1]
    j = np.arange(n)
    W = np.exp(-2j * np.pi * np.outer(j, j) / n)
    m = 1.0 / np.sqrt(n) if ortho else 1.0 / n
    return (x @ W.T) * m


def naive_ifft(x, ortho=False):
    x = np.asarray(x, dtype=np.complex128)
    n = x.shape[-1]
    j = np.arange(n)
    W = np.exp(2j * np.pi * np.outer(j, j) / n)
    m = 1.0 / np.sqrt(n) if ortho else 1.0
    return (x @ W.T) * m


def naive_rfft(x, ortho=False):
    """Real-input forward FFT, packed (n//2+1) complex output."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    return naive_fft(x.astype(np.complex128), ortho)[..., : n // 2 + 1]


def naive_dct1(x, mode=1):
    x = np.asarray(x, dtype=np.float64)
    N = x.shape[-1]
    M = N - 1.0
    if mode == 0:
        m0, m = 1.0 / np.sqrt(2.0), np.sqrt(2.0 / M)
    elif mode > 0:
        m0, m = 0.5, 2.0 / M
    else:
        m0, m = 1.0, 1.0
    k = np.arange(N)
    n_ = np.arange(1, N - 1)
    C = np.cos(np.pi * np.outer(k, n_) / M)  # (k, n)
    y = x[..., 1:N - 1] @ C.T
    y = y + m0 * x[..., :1]
    sign = np.where(k % 2 == 0, 1.0, -1.0)
    y = y + m0 * x[..., N - 1:N] * sign
    y = y * m
    y[..., 0] *= m0
    y[..., -1] *= m0
    return y


def naive_dct2(x, ortho=False):
    x = np.asarray(x, dtype=np.float64)
    N = x.shape[-1]
    k = np.arange(N)
    n_ = np.arange(N)
    C = np.cos(np.pi * np.outer(k, n_ + 0.5) / N)
    y = x @ C.T
    if ortho:
        y[..., 0] *= np.sqrt(1.0 / N)
        y[..., 1:] *= 2 * np.sqrt(1.0 / (2.0 * N))
    return y


def naive_dct3(x, ortho=False):
    x = np.asarray(x, dtype=np.float64)
    N = x.shape[-1]
    m0, m = (1.0 / np.sqrt(N), np.sqrt(2.0 / N)) if ortho else (0.5, 1.0)
    k = np.arange(N)
    n_ = np.arange(1, N)
    C = np.cos(np.pi * np.outer(k + 0.5, n_) / N)
    y = m0 * x[..., :1] + m * (x[..., 1:] @ C.T)
    if not ortho:
        y *= 2.0 / N
    return y


def naive_dct4(x, mode=1):
    x = np.asarray(x, dtype=np.float64)
    N = x.shape[-1]
    k = np.arange(N)
    C = np.cos(np.pi * np.outer(k + 0.5, k + 0.5) / N)
    y = x @ C.T
    if mode == 0:
        y *= np.sqrt(2.0 / N)
    elif mode > 0:
        y *= 2.0 / N
    return y


def naive_dst1(x, mode=1):
    x = np.asarray(x, dtype=np.float64)
    N = x.shape[-1]
    if mode > 0:
        m = 2.0 / (N + 1)
    elif mode < 0:
        m = 1.0
    else:
        m = np.sqrt(2.0 / (N + 1))
    j = np.arange(1, N + 1)
    S = np.sin(np.pi * np.outer(j, j) / (N + 1))
    return (x @ S.T) * m


def naive_dst2(x, ortho=False):
    x = np.asarray(x, dtype=np.float64)
    N = x.shape[-1]
    k = np.arange(N)
    n_ = np.arange(N)
    S = np.sin(np.pi * np.outer(k + 1.0, n_ + 0.5) / N)
    y = x @ S.T
    if ortho:
        y[..., 0] *= np.sqrt(1.0 / N)
        y[..., 1:] *= 2 * np.sqrt(1.0 / (2.0 * N))
    return y


def naive_dst3(x, ortho=False):
    x = np.asarray(x, dtype=np.float64).copy()
    N = x.shape[-1]
    if ortho:
        x[..., 0] *= np.sqrt(1.0 / N)
        x[..., 1:] *= np.sqrt(0.5 / N)
        mul = 2.0
    else:
        mul = 2.0 / N
    k = np.arange(N)
    xn = x[..., N - 1:N] * 0.5
    sign = np.where(k % 2 == 0, 1.0, -1.0)
    n_ = np.arange(N - 1)
    S = np.sin(np.pi * np.outer(k + 0.5, n_ + 1.0) / N)
    y = xn * sign + x[..., : N - 1] @ S.T
    return y * mul


def naive_dst4(x, mode=1):
    x = np.asarray(x, dtype=np.float64)
    N = x.shape[-1]
    if mode > 0:
        m = 2.0 / N
    elif mode < 0:
        m = 1.0
    else:
        m = np.sqrt(2.0 / N)
    k = np.arange(N)
    S = np.sin(np.pi * np.outer(k + 0.5, k + 0.5) / N)
    return (x @ S.T) * m


# --- odd (Martucci) types V-VIII: pure definitions, unit scale ---------

def naive_dct5(x):
    x = np.asarray(x, dtype=np.float64)
    N = x.shape[-1]
    M = N - 0.5
    k = np.arange(N)
    C = np.cos(np.pi * np.outer(k, k) / M)
    return x @ C.T


def naive_dct6(x):
    x = np.asarray(x, dtype=np.float64)
    N = x.shape[-1]
    M = N - 0.5
    k = np.arange(N)
    C = np.cos(np.pi * np.outer(k, k + 0.5) / M)
    return x @ C.T


def naive_dct7(x):
    x = np.asarray(x, dtype=np.float64)
    N = x.shape[-1]
    M = N - 0.5
    k = np.arange(N)
    C = np.cos(np.pi * np.outer(k + 0.5, k) / M)
    return x @ C.T


def naive_dct8(x):
    x = np.asarray(x, dtype=np.float64)
    N = x.shape[-1]
    M = N + 0.5
    k = np.arange(N)
    C = np.cos(np.pi * np.outer(k + 0.5, k + 0.5) / M)
    return x @ C.T


def naive_dst5(x):
    x = np.asarray(x, dtype=np.float64)
    N = x.shape[-1]
    M = N + 0.5
    j = np.arange(1, N + 1)
    S = np.sin(np.pi * np.outer(j, j) / M)
    return x @ S.T


def naive_dst6(x):
    x = np.asarray(x, dtype=np.float64)
    N = x.shape[-1]
    M = N + 0.5
    k = np.arange(N)
    S = np.sin(np.pi * np.outer(k + 1.0, k + 0.5) / M)
    return x @ S.T


def naive_dst7(x):
    x = np.asarray(x, dtype=np.float64)
    N = x.shape[-1]
    M = N + 0.5
    k = np.arange(N)
    S = np.sin(np.pi * np.outer(k + 0.5, k + 1.0) / M)
    return x @ S.T


def naive_dst8(x):
    x = np.asarray(x, dtype=np.float64)
    N = x.shape[-1]
    M = N - 0.5
    k = np.arange(N)
    S = np.sin(np.pi * np.outer(k + 0.5, k + 0.5) / M)
    return x @ S.T


def naive_gdft(x, a=0.0, c=0.0):
    """Generalized DFT: y[k] = sum_j x[j] exp(-2i pi (j+a)(k+c)/n)."""
    x = np.asarray(x, dtype=np.complex128)
    n = x.shape[-1]
    j = np.arange(n)
    W = np.exp(-2j * np.pi * np.outer(j + c, j + a) / n)  # (k, j)
    return x @ W.T


def naive_igdft(x, a=0.0, c=0.0):
    x = np.asarray(x, dtype=np.complex128)
    n = x.shape[-1]
    j = np.arange(n)
    W = np.exp(2j * np.pi * np.outer(j + a, j + c) / n)  # (j, k)
    return x @ W.T
