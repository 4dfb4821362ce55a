"""Smoke run of cfftpack_jax on an NVIDIA GPU, through the public API.

    python chip_smoke.py              # phases A-D on one card
    python chip_smoke.py --multichip  # phase E only, on four cards

A  the card: ``nvidia-smi`` name and power limit, JAX's device kind and
   count, the JAX version and the compile-cache directory.
B  golden parity of every transform family: f32 through the split and
   the complex64 API (relative L2 <= 1e-6), native f64 (max relative
   error <= 1e-12), the double-float engine against native f64
   (<= 5e-14) and the compat plan API.
C  the main path at real widths (2^22-2^24 elements per call): the f32
   split API against numpy f64, with each inverse round-tripping, the
   compile time, ``memory_analysis()`` and one warm wall time of the
   jitted call, beside ``jnp.fft`` (cuFFT) on the same shape.
D  the reference's applications at its own sizes, with the bars of
   tests/test_models.py.
E  (``--multichip`` only) __graft_entry__.multichip_legs on a (2, 2)
   data x model mesh of four cards.

It exits non-zero and prints no result when JAX finds no GPU, or when
any check misses its bar.  The last line of its output is one JSON
object naming the device JAX ran on; every check is also written to
chiprun_out/chip_smoke*.json.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

F32_L2 = 1e-6       # north-star f32 bar: relative L2 vs an f64 reference
F64_MAX = 1e-12     # native f64 vs the reference C's golden vectors
DF_MAX = 5e-14      # double-float engine vs native f64

ROOT = os.path.dirname(os.path.abspath(__file__))
SMI = ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"]

# one shape per removed kernel or dispatch regime (family, shape)
PHASE_C = (
    ("fft", (4096, 1024)), ("fft", (256, 65536)), ("fft", (4096, 4096)),
    ("fft", (4, 1 << 20)), ("fft", (4096, 1009)),
    ("rfft", (4096, 1024)), ("rfft", (64, 65536)), ("rfft", (256, 65536)),
    ("dct2", (4096, 1024)), ("dct2", (64, 65536)), ("dct4", (256, 65536)),
    ("rfilter", (64, 65536)),
    ("fft2", (4, 1024, 1024)), ("fft2", (4, 4096, 4096)),
    ("rfft2", (64, 1024, 1024)), ("dctn", (64, 1024, 1024)),
)


def rel_max(got, want) -> float:
    got = np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def check(phase: str, name: str, err: float, bar: float, **info) -> dict:
    rec = {"phase": phase, "check": name, "err": float(err), "bar": bar,
           "ok": bool(err <= bar), **info}
    print(f"{phase}  {name:<44} err {err:.3e} <= {bar:.0e}  "
          f"{'ok' if rec['ok'] else 'FAIL'}", flush=True)
    return rec


def _cplx(yr, yi):
    return np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)


# ------------------------------------------------------------------ A

def phase_a(smi=SMI) -> dict:
    """The card and the run's settings; ``smi`` runs in a child process
    that stays off JAX."""
    import jax
    from cfftpack_jax.utils.cache import compilation_cache_dir
    smi_out = subprocess.run(smi, check=True, capture_output=True,
                             text=True, timeout=60).stdout.strip()
    d = jax.devices()[0]
    info = {"nvidia_smi": smi_out.splitlines(), "platform": d.platform,
            "kind": d.device_kind, "count": len(jax.devices()),
            "jax": jax.__version__, "cache_dir": compilation_cache_dir()}
    for line in info["nvidia_smi"]:
        print(f"A  nvidia-smi name, power.limit: {line}")
    print(f"A  jax {info['jax']}: {info['count']} x {info['kind']} "
          f"({info['platform']}); compile cache {info['cache_dir']}",
          flush=True)
    return info


# ------------------------------------------------------------------ B

def phase_b(hp_shape=(64, 2048)) -> list[dict]:
    """Every family against the reference C's golden vectors."""
    import importlib.util
    import jax.numpy as jnp
    import cfftpack_jax as ct
    import cfftpack_jax.compat as cc
    from cfftpack_jax.utils.debug import rel_l2

    # the reference's packed rfft2 layout decoder, from its golden test
    # (loaded by path: an installed package may own the name "tests")
    spec = importlib.util.spec_from_file_location(
        "test_golden_rfft2", os.path.join(ROOT, "tests",
                                          "test_golden_rfft2.py"))
    golden_rfft2 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(golden_rfft2)
    gold = os.path.join(ROOT, "tests", "golden")
    g = np.load(os.path.join(gold, "golden.npz"))
    g2 = np.load(os.path.join(gold, "golden_rfft2.npz"))
    recs = []

    def three(name, want, split32, api32, api64):
        # real-to-real families have one API: its f32 result is split32
        f32 = "f32 split" if api32 is not None else "f32"
        recs.append(check("B", f"{name} {f32}", rel_l2(split32, want),
                          F32_L2))
        if api32 is not None:
            recs.append(check("B", f"{name} f32 complex64 API",
                              rel_l2(api32, want), F32_L2))
        recs.append(check("B", f"{name} f64 native", rel_max(api64, want),
                          F64_MAX))

    for n in (60, 101, 960, 1024, 1250):
        x = g[f"fft_in_{n}"]
        x32 = x.astype(np.complex64)
        three(f"fft n={n}", g[f"fft_fwd_{n}"],
              _cplx(*ct.fft_split(x32.real, x32.imag)), ct.fft(x32),
              ct.fft(x))

    for n in (60, 960, 1024):
        # reference packing: interior bins are 2*conj(X_k)
        x = g[f"rfft_in_{n}"]
        ref = g[f"rfft_fwd_{n}"]
        want = ref.astype(np.complex128)
        want[1:n // 2] = np.conj(ref[1:n // 2]) / 2
        x32 = x.astype(np.float32)
        three(f"rfft n={n}", want, _cplx(*ct.rfft_split(x32)),
              ct.rfft(x32), ct.rfft(x))

    fams = (("dct", 3, ct.dct), ("dct1", 1, ct.dct), ("dct4", 4, ct.dct),
            ("dst", 3, ct.dst), ("dst1", 1, ct.dst), ("dst4", 4, ct.dst),
            ("dct5", 5, ct.dct), ("dct8", 8, ct.dct),
            ("dst5", 5, ct.dst), ("dst8", 8, ct.dst))
    for fam, t, fn in fams:
        n = 60 if f"{fam}_in_60" in g else 13
        x = g[f"{fam}_in_{n}"]
        want = g[f"{fam}_fwd_{n}"]
        three(f"{fam} n={n}", want, fn(jnp.asarray(x, jnp.float32), t),
              None, fn(x, t))

    x = g["gdft_in_60_0.5_0.0"]
    x32 = x.astype(np.complex64)
    three("gdft n=60", g["gdft_fwd_60_0.5_0.0"],
          _cplx(*ct.gdft_split(x32.real, x32.imag, a=0.0, b=0.5)),
          ct.gdft(x32, a=0.0, b=0.5), ct.gdft(x, a=0.0, b=0.5))

    x = g["dct2d_in_8x6"]
    three("dct_2d 8x6", g["dct2d_fwd_8x6"],
          ct.dctn(jnp.asarray(x, jnp.float32), 3), None, ct.dctn(x, 3))

    x = g["fft2_in_6x10"]
    x32 = x.astype(np.complex64)
    three("fft2 6x10", g["fft2_fwd_6x10"],
          _cplx(*ct.fft2_split(x32.real, x32.imag)), ct.fft2(x32),
          ct.fft2(x))

    # rfft2_in is (l, m) with the stride-1 real axis first: feed x.T
    x = g2["rfft2_in_60x48"]
    want = golden_rfft2._decode_packed(g2["rfft2_fwd_60x48"], 60,
                                       48)[:31, :].T
    xt = np.ascontiguousarray(x.T)
    three("rfft2 48x60", want, _cplx(*ct.rfft2_split(xt.astype(np.float32))),
          ct.rfft2(xt.astype(np.float32)), ct.rfft2(xt))

    # the public double-float engine against native f64 on the card
    r = np.random.default_rng(1)
    xc = r.standard_normal(hp_shape) + 1j * r.standard_normal(hp_shape)
    recs.append(check("B", f"fft_hp {hp_shape} vs native f64",
                      rel_max(ct.fft_hp(xc), ct.fft(xc)), DF_MAX))
    xr = r.standard_normal(hp_shape)
    recs.append(check("B", f"dct_hp type 2 {hp_shape} vs native f64",
                      rel_max(ct.dct_hp(xr, type=2), ct.dct(xr, 2)), DF_MAX))

    # compat plan API (bit-compatible with the reference C's layout)
    n = 1024
    recs.append(check("B", "compat fft_create(1024)",
                      rel_max(cc.fft_create(n).forward(g[f"fft_in_{n}"]),
                              g[f"fft_fwd_{n}"]), F64_MAX))
    recs.append(check("B", "compat rfft_create(1024)",
                      rel_max(cc.rfft_create(n).forward(g[f"rfft_in_{n}"]),
                              g[f"rfft_fwd_{n}"]), F64_MAX))
    return recs


# ------------------------------------------------------------------ C

def _inputs(name: str, shape, r=None) -> tuple:
    """Host f32 inputs of a phase-C family drawn from ``r``, or their
    jax.ShapeDtypeStruct specs when ``r`` is None."""
    import jax

    def real(s):
        if r is None:
            return jax.ShapeDtypeStruct(s, np.float32)
        return r.standard_normal(s, dtype=np.float32)

    if name in ("fft", "fft2"):
        return real(shape), real(shape)
    if name == "rfilter":
        h = shape[-1] // 2 + 1
        if r is None:
            return real(shape), real((h,)), real((h,))
        f = np.fft.rfft(r.standard_normal(shape[-1]))  # a real filter
        fi = f.imag.astype(np.float32)
        fi[[0, -1]] = 0.0
        return real(shape), f.real.astype(np.float32), fi
    return (real(shape),)


def _family(name: str, shape):
    """(forward, inverse or None, numpy f64 reference of the forward,
    jnp.fft counterpart or None) of one phase-C family; each takes the
    family's inputs (the jnp.fft one of "fft"/"fft2" one complex64
    array)."""
    import jax
    import jax.numpy as jnp
    import jax.scipy.fft as jsf
    import scipy.fft as sf
    import cfftpack_jax as ct

    n = shape[-1]
    nn = shape[-2] * shape[-1]
    ax = (-2, -1)

    def f64(a):
        return np.asarray(a, np.float64)

    if name == "fft":
        return (ct.fft_split, ct.ifft_split,
                lambda a, b: np.fft.fft(_cplx(a, b)) / n, jnp.fft.fft)
    if name == "fft2":
        return (ct.fft2_split, ct.ifft2_split,
                lambda a, b: np.fft.fft2(_cplx(a, b)) / nn, jnp.fft.fft2)
    if name == "rfft":
        return (ct.rfft_split, lambda a, b: ct.irfft_split(a, b, n),
                lambda a: np.fft.rfft(f64(a)) / n, jnp.fft.rfft)
    if name == "rfft2":
        return (ct.rfft2_split,
                lambda a, b: ct.irfft2_split(a, b, shape[-2:]),
                lambda a: np.fft.rfft2(f64(a)) / nn, jnp.fft.rfft2)
    if name in ("dct2", "dct4"):
        t = int(name[-1])
        return (lambda a: ct.dct(a, t), lambda a: ct.idct(a, t),
                lambda a: sf.dct(f64(a), t) / n,
                (lambda a: jsf.dct(a, 2)) if t == 2 else None)
    if name == "dctn":
        return (lambda a: ct.dctn(a, 2, axes=ax),
                lambda a: ct.idctn(a, 2, axes=ax),
                lambda a: sf.dctn(f64(a), 2, axes=ax) / nn,
                lambda a: jsf.dctn(a, 2, axes=ax))
    if name == "rfilter":
        return (ct.rfilter_split, None,
                lambda a, fr, fi: np.fft.irfft(
                    np.fft.rfft(f64(a)) * _cplx(fr, fi), n),
                lambda a, fr, fi: jnp.fft.irfft(
                    jnp.fft.rfft(a) * jax.lax.complex(fr, fi), n))
    raise ValueError(f"unknown phase-C family {name!r}")


def _timed(fn, args):
    """jit ``fn`` and compile it for ``args``; run once warm and once
    timed (host clock around block_until_ready)."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    return out, compile_s, time.perf_counter() - t0, mem


def _mem_str(mem) -> str:
    if mem is None:
        return "memory_analysis n/a"
    mib = 1 << 20
    return (f"args {mem.argument_size_in_bytes / mib:.1f} MiB, out "
            f"{mem.output_size_in_bytes / mib:.1f} MiB, temp "
            f"{mem.temp_size_in_bytes / mib:.1f} MiB")


def phase_c(shapes=PHASE_C, card: str = "") -> list[dict]:
    """The f32 split API at real widths against numpy f64."""
    import jax
    import jax.numpy as jnp
    from cfftpack_jax.utils.debug import rel_l2
    recs = []
    r = np.random.default_rng(2)
    for name, shape in shapes:
        args = _inputs(name, shape, r)
        fwd, inv, ref, cufft = _family(name, shape)
        dev = tuple(jax.device_put(a) for a in args)
        out, comp_s, wall, mem = _timed(fwd, dev)
        tag = f"{name} {shape}"
        print(f"C  {tag}: compile {comp_s:.2f} s, {_mem_str(mem)}; warm "
              f"{wall * 1e3:.3f} ms on {card}", flush=True)
        outs = out if isinstance(out, tuple) else (out,)
        got = _cplx(*outs) if len(outs) == 2 else np.asarray(outs[0])
        info = {"shape": list(shape), "compile_s": comp_s, "wall_s": wall,
                "card": card}
        recs.append(check("C", f"{tag} fwd", rel_l2(got, ref(*args)),
                          F32_L2, **info))
        del got
        if inv is not None:
            back, comp_i, wall_i, _ = _timed(inv, outs)
            back = back if isinstance(back, tuple) else (back,)
            want = (_cplx(*args) if len(back) == 2
                    else args[0].astype(np.float64))
            got = _cplx(*back) if len(back) == 2 else np.asarray(back[0])
            recs.append(check("C", f"{tag} inverse roundtrip",
                              rel_l2(got, want), F32_L2,
                              compile_s=comp_i, wall_s=wall_i, card=card))
            print(f"C  {tag} inverse: compile {comp_i:.2f} s; warm "
                  f"{wall_i * 1e3:.3f} ms on {card}", flush=True)
        if cufft is not None:
            xin = ((jnp.asarray(_cplx(*args).astype(np.complex64)),)
                   if name in ("fft", "fft2") else dev)
            _, comp_j, wall_j, _ = _timed(cufft, xin)
            recs[-1 if inv is None else -2]["jnp_fft_wall_s"] = wall_j
            print(f"C  {tag} jnp.fft: compile {comp_j:.2f} s; warm "
                  f"{wall_j * 1e3:.3f} ms on {card}", flush=True)
        del out, outs, dev
    return recs


# ------------------------------------------------------------------ D

# reference benchmark parameters (vargamma.c:108-121), as in
# tests/test_models.py
S, K, SIGMA, THETA, KAPPA, R, T = 100.0, 98.0, 0.12, -0.14, 0.2, 0.05, 1.0
VG_TARGET = 9.3424659413582116       # QuantLib (vargammaql.cpp)
VG_CONV = 9.342473370823516          # reference conv pricer at N=2^18
QMC_WANT = (1.331389466495620, 1.330757038060973, 1.326960062625530)


def _dct3_matrix(n: int) -> np.ndarray:
    """ct.dct(x, 3) under the fftpack norm as an explicit f64 matrix."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    w = np.where(j == 0, 0.5, 1.0)
    return (2.0 / n) * w * np.cos(np.pi * j * (2 * k + 1) / (2 * n))


def phase_d(pricer_ns=tuple(1 << k for k in range(7, 21)),
            vg_ns=(1 << 16, 1 << 18), ladder_n=1 << 20,
            vg_samples=200000, dct_batch=1024, card: str = "") -> list[dict]:
    """The reference's applications at its own sizes."""
    import jax
    import jax.numpy as jnp
    import cfftpack_jax as ct
    import __graft_entry__
    from cfftpack_jax.models import (asian_option_qmc_device, bs_cf,
                                     conv_bsvg_option, conv_option_price,
                                     vg_mc_price, vg_mc_price_device)
    from cfftpack_jax.utils import black_scholes_option
    from cfftpack_jax.utils.debug import rel_l2
    recs = []

    fn, args = __graft_entry__.entry()
    out = np.asarray(jax.jit(fn)(*args))
    v, pr, pi = (np.asarray(a, np.float64) for a in args)
    want = np.fft.irfft(np.fft.rfft(v) * (pr + 1j * pi), v.shape[-1])
    recs.append(check("D", "flagship entry() step", rel_l2(out, want),
                      F32_L2))

    # vargamma.c: the conv pricer is within 2e-8 of the closed form from
    # N = 2^16 on (tests/test_models.py); coarser grids within a cent
    cbs = float(black_scholes_option(S, K, SIGMA, T, R, True))
    for n in pricer_ns:
        t0 = time.perf_counter()
        c = conv_bsvg_option(n, S, K, SIGMA, THETA, KAPPA, T, R,
                             is_call=True, is_bs=True)
        wall = time.perf_counter() - t0
        recs.append(check("D", f"BS conv pricer N=2^{n.bit_length() - 1}",
                          abs(c - cbs), 2e-8 if n >= 1 << 16 else 1e-2,
                          wall_s=wall, card=card))
    for n in vg_ns:
        c = conv_bsvg_option(n, S, K, SIGMA, THETA, KAPPA, T, R,
                             is_call=True, is_bs=False)
        tag = f"VG conv pricer N=2^{n.bit_length() - 1}"
        recs.append(check("D", f"{tag} vs reference", abs(c - VG_CONV),
                          1e-7))
        recs.append(check("D", f"{tag} vs QuantLib", abs(c - VG_TARGET),
                          1e-5))

    strikes = np.arange(80.0, 120.0, 0.5)           # 80 strikes
    t0 = time.perf_counter()
    got = conv_option_price(100.0, strikes, 0.25, 0.03,
                            lambda u: bs_cf(u, 0.25, 0.2, 0.03),
                            n=ladder_n, grid_sigma=0.2)
    wall = time.perf_counter() - t0
    bs = np.asarray(black_scholes_option(100.0, strikes, 0.2, 0.25, 0.03,
                                         True))
    recs.append(check("D", f"80-strike ladder N=2^{ladder_n.bit_length() - 1}"
                      " vs closed form", np.abs(got - bs).max(), 2e-4,
                      wall_s=wall, card=card))

    # montecarlo.c: reference binary's values (f64), f32 to grid accuracy
    for run, w in enumerate(QMC_WANT):
        for dt, bar in (("float64", 1e-12), ("float32", 2e-3)):
            q = asian_option_qmc_device(S=100.0, K=98.0, sigma=0.17,
                                        t=0.25, r=0.02, steps=128,
                                        samples=500, is_call=False,
                                        run_index=run, dtype=dt)
            recs.append(check("D", f"QMC Asian run {run} {dt}", abs(q - w),
                              bar))

    # vg_mc.cpp: device pipeline vs host-sampled path and QuantLib
    dev = vg_mc_price_device(S, K, SIGMA, THETA, KAPPA, R, T,
                             samples=vg_samples, seed=1)
    host = vg_mc_price(S, K, SIGMA, THETA, KAPPA, R, T, samples=vg_samples,
                       seed=1)
    recs.append(check("D", "VG Monte Carlo device vs host", abs(dev - host),
                      1e-3))
    recs.append(check("D", "VG Monte Carlo vs QuantLib",
                      abs(dev - VG_TARGET), 0.2))

    # test1.c: the 128x128 2-D DCT (dct_2d_forward), batched
    r = np.random.default_rng(3)
    x = r.standard_normal((dct_batch, 128, 128), dtype=np.float32)
    m = _dct3_matrix(128)
    xd = jnp.asarray(x)
    t0 = time.perf_counter()
    y = jax.block_until_ready(ct.dctn(xd, 3, axes=(-2, -1)))
    wall = time.perf_counter() - t0
    want = m @ x.astype(np.float64) @ m.T
    recs.append(check("D", f"2-D DCT 128x128 x{dct_batch}", rel_l2(y, want),
                      F32_L2, wall_s=wall, card=card))
    back = ct.idctn(y, 3, axes=(-2, -1))
    recs.append(check("D", f"2-D DCT 128x128 x{dct_batch} roundtrip",
                      rel_l2(back, x.astype(np.float64)), F32_L2))
    return recs


# ------------------------------------------------------------------ E

def phase_e(n_devices: int = 4, **sizes) -> list[dict]:
    """The distributed legs on a (2, n/2) data x model mesh of devices;
    ``sizes`` go to __graft_entry__.multichip_legs."""
    import jax
    import __graft_entry__
    from cfftpack_jax.parallel import make_mesh
    devs = jax.devices()
    if len(devs) < n_devices:
        raise RuntimeError(f"--multichip needs {n_devices} devices, JAX "
                           f"found {len(devs)}")
    mesh = make_mesh((2, n_devices // 2), ("data", "model"),
                     devices=devs[:n_devices])
    recs = []
    for leg in __graft_entry__.multichip_legs(mesh, **sizes):
        info = {k: v for k, v in leg.items()
                if k not in ("leg", "err", "bar", "ok")}
        rec = check("E", leg["leg"], leg["err"], leg["bar"], **info)
        rec["ok"] = leg["ok"]
        if info:
            print(f"E    all-to-all {info['a2a']} (budget "
                  f"{info['a2a_budget']}), other collectives "
                  f"{info['other_collectives'] or 'none'}")
        recs.append(rec)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-card sharded legs (phase E)")
    args = ap.parse_args(argv)

    import jax
    d = jax.devices()[0]
    if d.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {d.platform} "
              f"({d.device_kind})", file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    from cfftpack_jax.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    t0 = time.perf_counter()
    info = phase_a()
    card = f"{info['kind']} ({info['nvidia_smi'][0]})"
    if args.multichip:
        recs = phase_e()
    else:
        recs = phase_b() + phase_c(card=card) + phase_d(card=card)
    bad = [r["check"] for r in recs if not r["ok"]]
    print(f"{len(recs) - len(bad)}/{len(recs)} checks within their bars "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    name = "chip_smoke_multichip.json" if args.multichip else "chip_smoke.json"
    with open(os.path.join(out, name), "w") as f:
        json.dump({"card": info, "checks": recs}, f, indent=1)
    if bad:
        print(f"chip_smoke: FAILED {bad}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
