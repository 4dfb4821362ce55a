"""Coverage for the auxiliary subsystems: split APIs, cache, profiling,
apps alias, examples smoke."""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import cfftpack_jax as ct


def rng_complex(shape, seed=0):
    r = np.random.default_rng(seed)
    return r.standard_normal(shape) + 1j * r.standard_normal(shape)


@pytest.mark.parametrize("n", [16, 60, 101])
def test_fft_split_matches_complex(n):
    x = rng_complex((3, n), seed=n)
    yr, yi = ct.fft_split(jnp.asarray(x.real), jnp.asarray(x.imag))
    want = np.asarray(ct.fft(x))
    np.testing.assert_allclose(np.asarray(yr) + 1j * np.asarray(yi), want,
                               atol=1e-12)
    br, bi = ct.ifft_split(yr, yi)
    np.testing.assert_allclose(np.asarray(br) + 1j * np.asarray(bi), x,
                               atol=1e-12)


@pytest.mark.parametrize("n", [16, 61])
def test_rfft_split_matches_complex(n):
    v = np.random.default_rng(n).standard_normal((4, n))
    yr, yi = ct.rfft_split(jnp.asarray(v))
    want = np.asarray(ct.rfft(v))
    np.testing.assert_allclose(np.asarray(yr) + 1j * np.asarray(yi), want,
                               atol=1e-12)
    back = np.asarray(ct.irfft_split(yr, yi, n))
    np.testing.assert_allclose(back, v, atol=1e-12)


def test_split_axis_handling():
    x = rng_complex((3, 32, 5), seed=2)
    yr, yi = ct.fft_split(jnp.asarray(x.real), jnp.asarray(x.imag), axis=1)
    want = np.asarray(ct.fft(x, axis=1))
    np.testing.assert_allclose(np.asarray(yr) + 1j * np.asarray(yi), want,
                               atol=1e-12)
    with pytest.raises(ValueError):
        ct.fft_split(jnp.zeros((3, 4)), jnp.zeros((3, 5)))


def test_gdft_split_matches_complex():
    x = rng_complex((2, 24), seed=3)
    for a, b in ((0.0, 0.0), (0.5, 0.25)):
        zr, zi = ct.gdft_split(jnp.asarray(x.real), jnp.asarray(x.imag),
                               a=a, b=b)
        want = np.asarray(ct.gdft(x, a=a, b=b))
        np.testing.assert_allclose(np.asarray(zr) + 1j * np.asarray(zi),
                                   want, atol=1e-12)
        br, bi = ct.igdft_split(zr, zi, a=a, b=b)
        np.testing.assert_allclose(np.asarray(br) + 1j * np.asarray(bi), x,
                                   atol=1e-12)


def test_compilation_cache_helper(tmp_path, monkeypatch):
    from cfftpack_jax.utils.cache import enable_compilation_cache, warm_plans
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    old = jax.config.jax_compilation_cache_dir
    try:
        p = enable_compilation_cache()
        assert p == str(tmp_path / "xla") and os.path.isdir(p)
        assert jax.config.jax_compilation_cache_dir == p
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    warm_plans([60, 101, 1024])
    from cfftpack_jax import plan
    assert plan.factor(60) == (4, 3, 5)
    assert plan.needs_bluestein(101)


def test_profiling_timer():
    from cfftpack_jax.utils.profiling import Timer
    x = jnp.ones((8, 8))
    y = ct.fft(x)
    with Timer(sync=y) as t:
        pass
    assert t.seconds is not None and t.seconds >= 0


def test_apps_alias_surface():
    import cfftpack_jax.apps as apps
    for name in ("conv_bsvg_option", "vg_mc_price", "asian_option_qmc",
                 "ShortRateMesh", "black_scholes_option", "halton"):
        assert hasattr(apps, name), name


def test_examples_importable_and_strikes_run():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "pricing_demo",
        os.path.join(os.path.dirname(__file__), "..", "examples",
                     "pricing_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # cheap demo: one batched strike call
    mod.demo_vgmc.__wrapped__ if hasattr(mod.demo_vgmc, "__wrapped__") \
        else None
    # smoke: strikes demo math (small n to stay fast)
    from cfftpack_jax.models import conv_option_price, bs_cf
    from cfftpack_jax.utils import black_scholes_option
    got = conv_option_price(100.0, np.array([95.0, 105.0]), 0.1, 0.02,
                            lambda u: bs_cf(u, 0.1, 0.2, 0.02),
                            n=2048, grid_sigma=0.2)
    want = np.asarray(black_scholes_option(100.0, np.array([95.0, 105.0]),
                                           0.2, 0.1, 0.02, True))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_vmap_over_split_api():
    x = rng_complex((4, 32), seed=9)
    f = jax.vmap(lambda r, i: ct.fft_split(r, i))
    yr, yi = f(jnp.asarray(x.real), jnp.asarray(x.imag))
    want = np.asarray(ct.fft(x))
    np.testing.assert_allclose(np.asarray(yr) + 1j * np.asarray(yi), want,
                               atol=1e-12)


def test_grad_through_split_api():
    v = np.random.default_rng(1).standard_normal(16)

    def loss(a):
        yr, yi = ct.rfft_split(a)
        return jnp.sum(yr ** 2 + yi ** 2)

    g = jax.grad(loss)(jnp.asarray(v))
    assert np.all(np.isfinite(np.asarray(g)))


def test_fftfreq_helpers():
    for n in (8, 9, 60):
        np.testing.assert_allclose(np.asarray(ct.fftfreq(n, 0.5)),
                                   np.fft.fftfreq(n, 0.5))
        np.testing.assert_allclose(np.asarray(ct.rfftfreq(n, 2.0)),
                                   np.fft.rfftfreq(n, 2.0))


def test_circular_convolve():
    r = np.random.default_rng(17)
    n = 30
    a, b = r.standard_normal(n), r.standard_normal(n)
    direct = np.array([sum(a[j] * b[(k - j) % n] for j in range(n))
                       for k in range(n)])
    np.testing.assert_allclose(np.asarray(ct.circular_convolve(a, b)),
                               direct, atol=1e-12)
    ac = a + 1j * r.standard_normal(n)
    directc = np.array([sum(ac[j] * b[(k - j) % n] for j in range(n))
                        for k in range(n)])
    np.testing.assert_allclose(np.asarray(ct.circular_convolve(ac, b)),
                               directc, atol=1e-12)
    with pytest.raises(ValueError):
        ct.circular_convolve(np.ones(4), np.ones(5))


def test_edge_probes():
    with pytest.raises(ValueError):
        ct.fft(np.empty(0, dtype=np.complex128))
    with pytest.raises(ValueError):
        ct.fft(np.ones(8), axis=3)


def test_aot_precompile():
    from cfftpack_jax.utils.aot import precompile
    step = precompile(lambda v: ct.dct(v, 2, norm="ortho"),
                      jnp.zeros((4, 32), jnp.float32))
    x = np.random.default_rng(3).standard_normal((4, 32)).astype(np.float32)
    got = np.asarray(step(jnp.asarray(x)))
    want = np.asarray(ct.dct(x, 2, norm="ortho"))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_split_api_integer_input_coerced():
    yr, yi = ct.fft_split(np.arange(8), np.zeros(8, dtype=np.int64))
    assert jnp.issubdtype(yr.dtype, jnp.floating)
    want = np.fft.fft(np.arange(8.0)) / 8
    np.testing.assert_allclose(np.asarray(yr) + 1j * np.asarray(yi), want,
                               atol=1e-6)
    zr, _ = ct.rfft_split(np.arange(8))
    assert jnp.issubdtype(zr.dtype, jnp.floating)


def test_compat_batched_arrays():
    import cfftpack_jax.compat as cc
    f = cc.dct_create(16)
    x = np.random.default_rng(0).standard_normal((3, 16))
    got = np.asarray(f.forward(x))
    want = np.asarray(ct.dct(x, 3))
    np.testing.assert_allclose(got, want, atol=1e-12)
    rf = cc.rfft_create(12)
    xb = np.random.default_rng(1).standard_normal((2, 12))
    spec = rf.forward(xb)
    back = np.asarray(rf.inverse(spec))
    np.testing.assert_allclose(back, xb, atol=1e-12)


def test_profiler_trace_smoke(tmp_path):
    from cfftpack_jax.utils.profiling import trace
    with trace(str(tmp_path / "tr")) as logdir:
        jax.block_until_ready(ct.fft(jnp.ones(64, jnp.complex128)))
    assert os.path.isdir(logdir)


def test_split_api_bf16_promoted_to_f32():
    x = jnp.ones(16, jnp.bfloat16)
    yr, yi = ct.fft_split(x, jnp.zeros(16, jnp.bfloat16))
    assert yr.dtype == jnp.float32
    zr, _ = ct.rfft_split(x)
    assert zr.dtype == jnp.float32


def test_debug_hooks():
    """Failure-detection aux subsystem (SURVEY §5): check_finite is the
    host-side post-hoc assertion; enable_nan_checks toggles the
    jax_debug_nans/infs configs that make jitted code raise at the
    offending op."""
    import pytest
    from cfftpack_jax.utils import check_finite, enable_nan_checks

    check_finite(np.ones(4), jnp.zeros((2, 2)), name="ok")
    with pytest.raises(FloatingPointError, match=r"bad\[1\]: 2 non-finite"):
        check_finite(np.ones(3), np.array([np.nan, 1.0, np.inf]),
                     name="bad")
    try:
        enable_nan_checks(True)
        assert jax.config.jax_debug_nans and jax.config.jax_debug_infs
        with pytest.raises(FloatingPointError):
            jax.block_until_ready(jnp.log(jnp.zeros(4) - 1.0))
    finally:
        enable_nan_checks(False)
    assert not jax.config.jax_debug_nans


def test_halton_batch_int32_overflow_guard():
    """Advisor round-2: indices past 2**31 wrapped silently in int32."""
    import pytest
    from cfftpack_jax.utils.qmc import halton_batch
    with pytest.raises(ValueError, match="2\\*\\*31"):
        halton_batch(2**31 - 4, 8, 4)
    from cfftpack_jax.models.montecarlo import asian_option_qmc_device
    with pytest.raises(ValueError, match="2\\*\\*31"):
        asian_option_qmc_device(samples=2048, run_index=2**31 // 2048)
