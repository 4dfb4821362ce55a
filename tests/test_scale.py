"""Large-scale configs from BASELINE.json, shrunk to CI size where
needed but exercising the exact sharded code paths:

* configs[2]: len 2^20 four-step FFT with all-to-all transpose
* configs[3]: 2-D row-column FFT with sharded transpose (512x512 here;
  4096x4096 is the on-hardware bench shape)
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

import cfftpack_jax as ct
from cfftpack_jax.parallel import (local_mesh, fft_fourstep, ifft_fourstep,
                                   fft2_sharded, ifft2_sharded)


@pytest.mark.parametrize("dtype", [np.complex64])
def test_fourstep_2pow20(dtype):
    """configs[2]: one length-2^20 transform across the 8-device mesh."""
    n = 1 << 20
    mesh = local_mesh()
    r = np.random.default_rng(0)
    x = (r.standard_normal(n) + 1j * r.standard_normal(n)).astype(dtype)
    y = fft_fourstep(jnp.asarray(x), mesh, reorder=False)
    back = np.asarray(ifft_fourstep(y, mesh, reordered=False))
    np.testing.assert_allclose(back, x, atol=5e-4)
    # spot-check spectrum values against the direct DFT at a few bins
    n1 = y.shape[-2]
    got = np.asarray(y)
    j = np.arange(n)
    for k in (0, 1, 12345):
        want = np.exp(-2j * np.pi * j * k / n).dot(x) / n
        k1, k2 = k % n1, k // n1
        assert abs(got[k1, k2] - want) / max(1e-9, abs(want)) < 5e-2


def test_fft2_sharded_512():
    """configs[3] shape class: sharded row-column 2-D FFT."""
    mesh = local_mesh()
    r = np.random.default_rng(1)
    x = (r.standard_normal((512, 512))
         + 1j * r.standard_normal((512, 512))).astype(np.complex64)
    y = fft2_sharded(jnp.asarray(x), mesh)
    back = np.asarray(ifft2_sharded(y, mesh))
    np.testing.assert_allclose(back, x, atol=5e-4)
    # DC bin equals the mean (fftpack norm: fwd scaled by 1/(n0*n1))
    np.testing.assert_allclose(np.asarray(y)[0, 0], x.mean(), atol=1e-4)


def test_fourstep_batched_weak_scaling_shape():
    """Batch-sharded + length-sharded composition on a 2-D mesh."""
    from cfftpack_jax.parallel import make_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = make_mesh((2, 2), ("data", "model"))
    r = np.random.default_rng(2)
    x = jnp.asarray((r.standard_normal((8, 256))
                     + 1j * r.standard_normal((8, 256))).astype(np.complex64))
    xs = jax.device_put(x, NamedSharding(mesh, P("data", None)))
    y = fft_fourstep(xs, mesh, axis_name="model", batch_axis_name="data")
    want = np.asarray(ct.fft(x))
    np.testing.assert_allclose(np.asarray(y), want, atol=1e-4)


def test_config0_batched_f64_1024_roundtrip():
    """configs[0]: batched f64 1024-pt round-trip vs reference golden +
    near-bit-stable round-trip (batch shrunk from 4096 for CI time;
    bench.py runs the full-size config on hardware)."""
    g = np.load(__file__.rsplit("/", 1)[0] + "/golden/golden.npz")
    xg = g["fft_in_1024"]
    np.testing.assert_allclose(np.asarray(ct.fft(xg)), g["fft_fwd_1024"],
                               atol=1e-12 * 32)
    r = np.random.default_rng(4)
    x = (r.standard_normal((64, 1024))
         + 1j * r.standard_normal((64, 1024)))
    back = np.asarray(ct.ifft(ct.fft(x)))
    np.testing.assert_allclose(back, x, atol=1e-13 * 1024)
