"""Distribution-layer demo: every sharded API on one device mesh.

Runs on every device JAX finds.  On the CPU it re-executes itself onto
a virtual 8-device CPU mesh — the same trick the test suite uses — so
the full multi-device code path runs anywhere.  On GPUs it needs at
least two cards; with fewer it says so and exits.

Shows, with parity checks against the single-device answers:
  * zero-collective batch data parallelism          (parallel.pfft)
  * one-all-to-all four-step long-transform split   (fft_fourstep)
  * sharded 2-D row-column FFT, complex + real      (fft2/rfft2_sharded)
  * sharded 2-D DCT                                 (dctn2_sharded)
  * mesh-sharded strike-ladder pricer               (conv_option_price)
  * mesh-wide Monte-Carlo sampling                  (asian/vg mc, mesh=)

Run: python examples/sharded_demo.py
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

def main():
    import jax
    if jax.device_count() < 2:
        if jax.default_backend() != "cpu":
            print(f"sharded_demo: needs 2 or more devices, found "
                  f"{jax.device_count()} x {jax.devices()[0].device_kind}")
            sys.exit(1)
        # virtual CPU mesh (must be set before backends initialize in a
        # fresh process; here we re-exec with the flag if needed)
        if "--respawned" not in sys.argv:
            env = dict(os.environ,
                       XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
                       + " --xla_force_host_platform_device_count=8",
                       JAX_PLATFORMS="cpu")
            os.execve(sys.executable,
                      [sys.executable, os.path.abspath(__file__),
                       "--respawned"], env)
    import jax.numpy as jnp
    import cfftpack_jax as ct
    from cfftpack_jax.parallel import (local_mesh, shard_batch, pfft,
                                       fft_fourstep, fft2_sharded,
                                       rfft2_sharded, dctn2_sharded)
    from cfftpack_jax.models import (conv_option_price, bs_cf,
                                     asian_option_qmc_device,
                                     vg_mc_price_device)
    from cfftpack_jax.utils import black_scholes_option

    mesh = local_mesh()
    print(f"devices: {jax.device_count()} x "
          f"{jax.devices()[0].device_kind}; mesh {dict(mesh.shape)}")
    r = np.random.default_rng(0)

    x = r.standard_normal((16, 1024)) + 1j * r.standard_normal((16, 1024))
    got = np.asarray(pfft(shard_batch(x, mesh), mesh))
    print(f"batch-DP fft      err {np.abs(got - np.asarray(ct.fft(x))).max():.2e}"
          " (zero collectives)")

    v = r.standard_normal(4096) + 1j * r.standard_normal(4096)
    got = np.asarray(fft_fourstep(v, mesh))
    print(f"four-step 1-D     err {np.abs(got - np.asarray(ct.fft(v))).max():.2e}"
          " (one all-to-all)")

    img = r.standard_normal((64, 64)) + 1j * r.standard_normal((64, 64))
    got = np.asarray(fft2_sharded(img, mesh))
    print(f"sharded 2-D fft   err {np.abs(got - np.asarray(ct.fft2(img))).max():.2e}")

    real = r.standard_normal((64, 48))
    got = np.asarray(rfft2_sharded(real, mesh))
    print(f"sharded 2-D rfft  err {np.abs(got - np.asarray(ct.rfft2(real))).max():.2e}")

    got = np.asarray(dctn2_sharded(jnp.asarray(real), mesh))
    print(f"sharded 2-D dct   err {np.abs(got - np.asarray(ct.dctn(real, 3))).max():.2e}")

    strikes = np.arange(85.0, 115.0, 1.0)
    ladder = conv_option_price(100.0, strikes, 0.25, 0.03,
                               lambda u: bs_cf(u, 0.25, 0.2, 0.03),
                               n=4096, grid_sigma=0.2, mesh=mesh)
    bs = np.asarray(black_scholes_option(100.0, strikes, 0.2, 0.25, 0.03,
                                         True))
    print(f"sharded pricer    err {np.abs(np.asarray(ladder) - bs).max():.2e}"
          f" ({len(strikes)} strikes)")

    q1 = asian_option_qmc_device(samples=4096)
    qN = asian_option_qmc_device(samples=4096, mesh=mesh)
    print(f"mesh QMC asian    {qN:.6f} (single-chip {q1:.6f}, "
          f"same Halton set)")
    vN = vg_mc_price_device(samples=400000, mesh=mesh)
    print(f"mesh VG MC        {vN:.6f} (QuantLib anchor 9.342466)")


if __name__ == "__main__":
    main()
