"""cfftpack_jax — spectral-transform engine in JAX.

A from-scratch JAX/XLA re-design covering the full capability
surface of the cfftpack reference library (FFTPACK 5.1 wrapper): complex
and real FFTs (1-D/2-D/N-D, any length), DCT/DST families I-VIII, GDFT,
spectrum shifts, fast-size planning, FFTPACK/orthonormal scaling modes,
batched + sharded execution, and quant-finance spectral applications.
"""
from .config import (DEFAULT_NORM, VALID_NORMS,  # noqa: F401
                     set_f64_policy, f64_policy)
from .plan import (fft_next_fast_size, fft_next_fast_even_size,  # noqa: F401
                   fft_next_fast_size_2nm1, fft_next_fast_size_2np1)
from .ops import (fft, ifft, fft2, ifft2, fftn, ifftn,  # noqa: F401
                  rfft, irfft, rfft2, irfft2,
                  dct, idct, dst, idst, dctn, idctn, dstn, idstn,
                  gdft, igdft, fftshift, ifftshift,
                  fft_split, ifft_split, rfft_split, irfft_split,
                  rfilter_split, fft2_split, ifft2_split,
                  rfft2_split, irfft2_split,
                  gdft_split, igdft_split,
                  fftfreq, rfftfreq, circular_convolve,
                  fft_hp, ifft_hp, fft2_hp, ifft2_hp, sfft_hp,
                  rfft_hp, irfft_hp, rfft2_hp, irfft2_hp,
                  dct2_hp, idct2_hp, dst2_hp, idst2_hp,
                  dct4_hp, idct4_hp, dst4_hp, idst4_hp,
                  dct1_hp, idct1_hp, dst1_hp, idst1_hp,
                  dct_hp, idct_hp, dst_hp, idst_hp,
                  dctn_hp, idctn_hp, dstn_hp, idstn_hp,
                  gdft_hp, igdft_hp)

__version__ = "0.2.0"
