"""Benchmark: batched 1-D FFT vs the HBM roofline across the target range.

Run on a GPU whose device kind is in PEAK_HBM: ``python bench.py``.
Any other device is refused.  Prints ONE JSON line:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

value       = transforms/s for batched split-complex f32 len-1024 FFT
              (BASELINE.json configs[0] shape: batch 4096).
vs_baseline = GEOMEAN of per-kernel roofline fractions over the family
              surface: complex fft at n = 1024/4096/16384/65536
              (2^22-elem working sets) PLUS rfft@1024, dct2@1024 and
              2-D fft2@1024^2.

                  frac = ideal_bytes / t / bw_hbm

              ideal_bytes is the roofline minimum: one read + one
              write of every plane (complex: 2*n*8 per transform;
              real/DCT: 2*n*4; 2-D: 2*n0*n1*8 — the row-column
              engine's structural 2nd pass counts AGAINST the frac,
              deliberately).  bw_hbm is the device's published peak
              (PEAK_HBM); the measured streaming bandwidth of an
              elementwise add is reported beside it.  Per-kernel
              fractions are in detail.roofline_frac.

Timing: each measurement is ONE jitted lax.fori_loop chaining `reps`
dependent applications of a SINGLE forward transform with the
magnitude-preserving ortho norm, output reduced to a host scalar;
per-iteration cost is the slope between two loop lengths, which
cancels dispatch and transfer overhead.
"""
from __future__ import annotations

import json
import time

import numpy as np

# (n, batch): BASELINE.json target range, ~2^22-element working sets
TARGET_RANGE = ((1024, 4096), (4096, 1024), (16384, 256), (65536, 256))


def _loop_time(body, state, reps: int) -> float:
    import jax
    import jax.numpy as jnp

    @jax.jit
    def prog(s):
        out = jax.lax.fori_loop(0, reps, lambda i, v: body(v), s)
        return sum(jnp.sum(o * 1e-6) for o in jax.tree.leaves(out))

    float(prog(state))  # compile + warm
    t_best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        float(prog(state))
        t_best = min(t_best, time.perf_counter() - t0)
    return t_best


def _per_iter(body, state, lo: int, hi: int) -> float:
    t_lo = _loop_time(body, state, lo)
    t_hi = _loop_time(body, state, hi)
    return max((t_hi - t_lo) / (hi - lo), 1e-9)


# Published peaks by device_kind (NVIDIA H100 Tensor Core GPU data sheet,
# SXM part, at its full 700 W power limit): HBM3 bandwidth in bytes/s.
# A card set to a lower power limit cannot hold its top clock.
PEAK_HBM = {"NVIDIA H100 80GB HBM3": 3.35e12}


def main():
    from cfftpack_jax.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    import cfftpack_jax as ct

    kind = jax.devices()[0].device_kind
    if kind not in PEAK_HBM:
        raise SystemExit(f"bench.py: no published peak for device kind "
                         f"{kind!r}; add it to PEAK_HBM with its source")
    bw_hbm = PEAK_HBM[kind]
    r = np.random.default_rng(0)

    # measured streaming bandwidth (elementwise add, read + write), for
    # reading the roofline fractions against what the card reaches
    big = jnp.asarray(r.standard_normal((65536, 1024)).astype(np.float32))
    bw_copy = 2 * big.size * 4 / _per_iter(lambda s: s + 1e-7, big,
                                           lo=4, hi=104)
    del big

    # forward-only ortho chains over the target range
    t_fwd = {}
    for n, batch in TARGET_RANGE:
        def _one(n=n, batch=batch):
            ar = jnp.asarray(
                r.standard_normal((batch, n)).astype(np.float32))
            ai = jnp.asarray(
                r.standard_normal((batch, n)).astype(np.float32))
            lo, hi = (4, 404) if n <= 1024 else (
                (4, 204) if n <= 4096 else ((4, 104) if n <= 16384
                                            else (2, 12)))
            return _per_iter(
                lambda s: ct.fft_split(s[0], s[1], norm="ortho"),
                (ar, ai), lo=lo, hi=hi)
        t_fwd[n] = _one()

    n0, b0 = TARGET_RANGE[0]
    transforms_per_s = b0 / t_fwd[n0]

    # one fwd chain step transforms the whole (b, n) batch: ideal
    # traffic = b transforms * 2*n*8 bytes each
    fracs = {f"fft_{n}": (b * 2 * n * 8) / t_fwd[n] / bw_hbm
             for n, b in TARGET_RANGE}

    # real / DCT / 2-D families (roundtrip chains; per_iter/2 is
    # per-transform).  Ideal bytes are the true per-family minimum, so
    # the real transforms' structural halving is demanded, not forgiven.
    v = jnp.asarray(r.standard_normal((b0, n0)).astype(np.float32))
    t_rfft = _per_iter(lambda s: ct.irfft_split(*ct.rfft_split(s), n0), v,
                       lo=4, hi=204) / 2.0
    t_dct2 = _per_iter(lambda s: ct.idct(ct.dct(s, 2), 2), v,
                       lo=4, hi=204) / 2.0

    # batched 2-D FFT (BASELINE.json configs[3] class, scaled to one
    # card): 1024x1024, batch 4 — fwd-only ortho chain
    def _fft2():
        n2, b2 = 1024, 4
        ar = jnp.asarray(
            r.standard_normal((b2, n2, n2)).astype(np.float32))
        ai = jnp.asarray(
            r.standard_normal((b2, n2, n2)).astype(np.float32))
        return _per_iter(
            lambda s: ct.fft2_split(s[0], s[1], norm="ortho"),
            (ar, ai), lo=2, hi=22)

    t_2d = _fft2()
    fracs["rfft_1024"] = (b0 * 2 * n0 * 4) / t_rfft / bw_hbm
    fracs["dct2_1024"] = (b0 * 2 * n0 * 4) / t_dct2 / bw_hbm
    fracs["fft2_1024x1024"] = (4 * 2 * 1024 * 1024 * 8) / t_2d / bw_hbm
    geomean = float(np.exp(np.mean(np.log(list(fracs.values())))))

    # double-float (f64-class accuracy) engine: one forward per iter.
    # Quad order is (re_hi, re_lo, im_hi, im_lo); the exact power-of-two
    # 1/sqrt(n) rescale keeps magnitudes constant across the chained
    # unscaled forwards (|fft| ~ sqrt(n)|x|) without touching the df
    # invariant.
    def _hp():
        from cfftpack_jax.ops.hp import sfft_hp
        dn = float(1.0 / np.sqrt(n0))
        assert dn == 2.0 ** round(np.log2(dn)), "need exact 2^-k rescale"

        def body(s):
            out = sfft_hp(s[0], s[1], s[2], s[3], n0, False)
            return tuple(a * np.float32(dn) for a in out)

        ar = jnp.asarray(r.standard_normal((b0, n0)).astype(np.float32))
        ai = jnp.asarray(r.standard_normal((b0, n0)).astype(np.float32))
        quad = (ar, jnp.zeros_like(ar), ai, jnp.zeros_like(ai))
        return _per_iter(body, quad, lo=4, hi=24)

    t_hp = _hp()

    result = {
        "metric": "batched split-c64 1024-pt FFT transforms/s/chip",
        "value": round(transforms_per_s, 1),
        "unit": "transforms/s",
        "vs_baseline": round(geomean, 4),
        "detail": {
            "backend": jax.devices()[0].platform,
            "device": kind,
            "device_count": len(jax.devices()),
            "vs_baseline_def": ("geomean of per-kernel roofline "
                                "fractions: complex fft n=1024/4096/"
                                "16384/65536 (2^22-elem working sets, "
                                "fwd ortho chains) + rfft@1024 + "
                                "dct2@1024 + fft2@1024^2b4 (real/DCT "
                                "ideal=2n*4 B, 2-D ideal=2*n0*n1*8 B "
                                "— one read+one write of every plane)"),
            "peak_hbm_GBps": bw_hbm / 1e9,
            "measured_copy_GBps": bw_copy / 1e9,
            "t_fwd_us": {str(n): t_fwd[n] * 1e6 for n, _ in TARGET_RANGE},
            "roofline_frac": fracs,
            "t_rfft_us": t_rfft * 1e6,
            "t_dct2_us": t_dct2 * 1e6,
            "t_fft_hp_us": t_hp * 1e6,
            "t_fft2_1024x1024_b4_us": t_2d * 1e6,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
