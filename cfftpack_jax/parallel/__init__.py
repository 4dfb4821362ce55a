"""Distribution layer: mesh helpers, batch sharding, distributed FFTs.

The reference is single-threaded C (SURVEY.md §2.8): its only batching
construct is the lot/jump/inc "m-routine" addressing (fftpack.c:2554).
Here batching is leading array axes, and scale-out is first-class:

* :mod:`batch` — embarrassingly-parallel batch sharding via shard_map
  (no cross-chip traffic for per-row transforms).
* :mod:`fourstep` — single long transform split N = N1*N2 across chips
  with one all-to-all at the transpose (the distributed analog of
  the reference's row-column decomposition, cfft2f_ fftpack.c:2363).
* :mod:`fft2d` — 2-D FFT with a sharded axis and all-to-all transpose.
"""
from .mesh import make_mesh, local_mesh, init_distributed  # noqa: F401
from .batch import shard_batch, pfft, pifft, prfft, pirfft, pdct  # noqa: F401
from .hp import pfft_hp, pifft_hp, prfft_hp  # noqa: F401
from .fourstep import fft_fourstep, ifft_fourstep  # noqa: F401
from .fourstep_split import (fft_fourstep_split,  # noqa: F401
                             ifft_fourstep_split)
from .fft2d import (fft2_sharded, ifft2_sharded,  # noqa: F401
                    fft2_sharded_split, ifft2_sharded_split,
                    rfft2_sharded, irfft2_sharded,
                    rfft2_sharded_split, irfft2_sharded_split)
from .rowcol import (rowcol2d_sharded, dctn2_sharded,  # noqa: F401
                     idctn2_sharded, dstn2_sharded, idstn2_sharded)
