"""Distribution layer on the virtual 8-device CPU mesh.

SURVEY.md §4 multi-chip strategy: sharded output == single-device
output == oracle, on a host-platform mesh
(xla_force_host_platform_device_count=4, set in conftest.py).
"""
import numpy as np
import pytest
import jax

import cfftpack_jax as ct
from cfftpack_jax.utils.debug import count_collectives
from cfftpack_jax.parallel import (make_mesh, local_mesh, shard_batch,
                                   pfft, pifft, prfft, pirfft, pdct,
                                   fft_fourstep, ifft_fourstep,
                                   fft2_sharded, ifft2_sharded)

TOL = 1e-12
NDEV = len(jax.devices())


def rng_complex(shape, seed=0):
    r = np.random.default_rng(seed)
    return r.standard_normal(shape) + 1j * r.standard_normal(shape)


def test_mesh_helpers():
    m = local_mesh()
    assert m.shape["data"] == NDEV
    m2 = make_mesh((2, 2), ("data", "model"))
    assert m2.shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError):
        make_mesh((64, 64))


def test_batch_sharded_fft_matches_single_device():
    mesh = local_mesh()
    x = rng_complex((16, 60), seed=1)
    xs = shard_batch(x, mesh)
    got = np.asarray(pfft(xs, mesh))
    want = np.asarray(ct.fft(x))
    np.testing.assert_allclose(got, want, atol=TOL)
    back = np.asarray(pifft(pfft(xs, mesh), mesh))
    np.testing.assert_allclose(back, x, atol=TOL)


def test_batch_sharded_is_local_only():
    """No collectives may appear in the compiled batch-parallel module."""
    mesh = local_mesh()
    x = shard_batch(rng_complex((8, 64), seed=2), mesh)
    from jax.sharding import NamedSharding, PartitionSpec as P
    spec = NamedSharding(mesh, P("data", None))
    f = jax.jit(lambda a: ct.fft(a), in_shardings=spec, out_shardings=spec)
    txt = f.lower(x).compile().as_text()
    for coll in ("all-reduce", "all-to-all", "collective-permute",
                 "all-gather"):
        assert coll not in txt, f"unexpected collective {coll} in HLO"


def test_batch_sharded_rfft_dct():
    mesh = local_mesh()
    xr = np.random.default_rng(3).standard_normal((8, 32))
    xs = shard_batch(xr, mesh)
    np.testing.assert_allclose(np.asarray(prfft(xs, mesh)),
                               np.asarray(ct.rfft(xr)), atol=TOL)
    np.testing.assert_allclose(
        np.asarray(pirfft(prfft(xs, mesh), 32, mesh)), xr, atol=TOL)
    np.testing.assert_allclose(np.asarray(pdct(xs, 2, mesh)),
                               np.asarray(ct.dct(xr, 2)), atol=TOL)


@pytest.mark.parametrize("n", [64, 128, 960])
def test_fourstep_matches_fft(n):
    mesh = local_mesh()
    x = rng_complex((n,), seed=n)
    got = np.asarray(fft_fourstep(x, mesh))
    want = np.asarray(ct.fft(x))
    np.testing.assert_allclose(got, want, atol=TOL * n ** 0.5)


@pytest.mark.parametrize("n", [64, 960])
def test_fourstep_roundtrip_natural(n):
    mesh = local_mesh()
    x = rng_complex((n,), seed=n + 1)
    y = fft_fourstep(x, mesh)
    back = np.asarray(ifft_fourstep(y, mesh))
    np.testing.assert_allclose(back, x, atol=TOL * n)


def test_fourstep_pipeline_no_reorder():
    """transform -> pointwise -> inverse without the reorder gather."""
    mesh = local_mesh()
    n = 128
    x = rng_complex((n,), seed=9)
    y2 = fft_fourstep(x, mesh, reorder=False)
    back = np.asarray(ifft_fourstep(y2, mesh, reordered=False))
    np.testing.assert_allclose(back, x, atol=TOL * n)


def test_fourstep_batched():
    mesh = local_mesh()
    x = rng_complex((3, 64), seed=11)
    got = np.asarray(fft_fourstep(x, mesh))
    np.testing.assert_allclose(got, np.asarray(ct.fft(x)), atol=TOL * 8)


def test_fourstep_ortho_norm():
    mesh = local_mesh()
    x = rng_complex((64,), seed=13)
    got = np.asarray(fft_fourstep(x, mesh, norm="ortho"))
    np.testing.assert_allclose(got, np.asarray(ct.fft(x, norm="ortho")),
                               atol=TOL * 8)


def test_fourstep_bad_length():
    mesh = local_mesh()
    with pytest.raises(ValueError):
        fft_fourstep(rng_complex((6,), seed=0), mesh)


@pytest.mark.parametrize("shape", [(16, 16), (8, 32), (64, 64)])
def test_fft2_sharded_matches_fft2(shape):
    mesh = local_mesh()
    x = rng_complex(shape, seed=shape[0])
    got = np.asarray(fft2_sharded(x, mesh))
    want = np.asarray(ct.fft2(x))
    np.testing.assert_allclose(got, want, atol=TOL * 8)
    back = np.asarray(ifft2_sharded(fft2_sharded(x, mesh), mesh))
    np.testing.assert_allclose(back, x, atol=TOL * 8)


def test_fft2_sharded_batched():
    mesh = local_mesh()
    x = rng_complex((2, 16, 16), seed=21)
    got = np.asarray(fft2_sharded(x, mesh))
    np.testing.assert_allclose(got, np.asarray(ct.fft2(x)), atol=TOL * 8)


def test_fft2_sharded_uses_one_mesh_dim_of_2d_mesh():
    m2 = make_mesh((2, 2), ("data", "model"))
    x = rng_complex((16, 16), seed=23)
    got = np.asarray(fft2_sharded(x, m2, axis_name="data"))
    np.testing.assert_allclose(got, np.asarray(ct.fft2(x)), atol=TOL * 8)


def test_dctn2_sharded_matches_dctn():
    from cfftpack_jax.parallel import dctn2_sharded, idctn2_sharded, \
        dstn2_sharded
    mesh = local_mesh()
    x = np.random.default_rng(31).standard_normal((32, 32))
    import jax.numpy as jnp
    got = np.asarray(dctn2_sharded(jnp.asarray(x), mesh))
    np.testing.assert_allclose(got, np.asarray(ct.dctn(x, 3)), atol=TOL * 8)
    back = np.asarray(idctn2_sharded(dctn2_sharded(jnp.asarray(x), mesh),
                                     mesh))
    np.testing.assert_allclose(back, x, atol=TOL * 32)
    got_s = np.asarray(dstn2_sharded(jnp.asarray(x), mesh))
    np.testing.assert_allclose(got_s, np.asarray(ct.dstn(x, 3)),
                               atol=TOL * 8)
    from cfftpack_jax.parallel import idstn2_sharded
    back_s = np.asarray(idstn2_sharded(dstn2_sharded(jnp.asarray(x), mesh),
                                       mesh))
    np.testing.assert_allclose(back_s, x, atol=TOL * 32)


def test_rowcol2d_sharded_batched_with_2d_mesh():
    from cfftpack_jax.parallel import dctn2_sharded
    m2 = make_mesh((2, 2), ("data", "model"))
    x = np.random.default_rng(33).standard_normal((4, 16, 16))
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    xs = jax.device_put(jnp.asarray(x), NamedSharding(m2, P("data", None,
                                                            None)))
    got = np.asarray(dctn2_sharded(xs, m2, axis_name="model",
                                   batch_axis_name="data"))
    np.testing.assert_allclose(got, np.asarray(ct.dctn(x, 3, axes=(1, 2))),
                               atol=TOL * 8)


def test_fourstep_split_matches_complex_path():
    from cfftpack_jax.parallel import fft_fourstep_split, ifft_fourstep_split
    import jax.numpy as jnp
    mesh = local_mesh()
    x = rng_complex((960,), seed=41)
    yr, yi = fft_fourstep_split(jnp.asarray(x.real), jnp.asarray(x.imag),
                                mesh)
    want = np.asarray(ct.fft(x))
    np.testing.assert_allclose(np.asarray(yr) + 1j * np.asarray(yi), want,
                               atol=TOL * 64)
    br, bi = ifft_fourstep_split(yr, yi, mesh)
    np.testing.assert_allclose(np.asarray(br) + 1j * np.asarray(bi), x,
                               atol=TOL * 960)
    # no-reorder pipeline mode
    yr2, yi2 = fft_fourstep_split(jnp.asarray(x.real), jnp.asarray(x.imag),
                                  mesh, reorder=False)
    br2, bi2 = ifft_fourstep_split(yr2, yi2, mesh, reordered=False)
    np.testing.assert_allclose(np.asarray(br2) + 1j * np.asarray(bi2), x,
                               atol=TOL * 960)


def test_fft2_sharded_split_matches_complex_path():
    from cfftpack_jax.parallel import fft2_sharded_split, ifft2_sharded_split
    import jax.numpy as jnp
    mesh = local_mesh()
    x = rng_complex((32, 32), seed=43)
    yr, yi = fft2_sharded_split(jnp.asarray(x.real), jnp.asarray(x.imag),
                                mesh)
    want = np.asarray(ct.fft2(x))
    np.testing.assert_allclose(np.asarray(yr) + 1j * np.asarray(yi), want,
                               atol=TOL * 32)
    br, bi = ifft2_sharded_split(yr, yi, mesh)
    np.testing.assert_allclose(np.asarray(br) + 1j * np.asarray(bi), x,
                               atol=TOL * 1024)


def test_sharded_strike_ladder_pricer():
    """configs[4]: the conv pricer end-to-end over a device mesh."""
    from cfftpack_jax.models import conv_option_price, bs_cf
    from cfftpack_jax.utils import black_scholes_option
    mesh = local_mesh()
    strikes = np.arange(85.0, 115.0, 1.0)   # 30 strikes (pads to 32)
    got = conv_option_price(100.0, strikes, 1 / 12, 0.03,
                            lambda u: bs_cf(u, 1 / 12, 0.15, 0.03),
                            n=4096, grid_sigma=0.15, mesh=mesh)
    want = np.asarray(black_scholes_option(100.0, strikes, 0.15, 1 / 12,
                                           0.03, True))
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_fourstep_compiles_to_single_all_to_all():
    """Communication minimality: the distributed four-step FFT must
    lower to exactly ONE all-to-all (the transpose) and no other
    collectives (SURVEY.md §2.8: collectives only at the transpose)."""
    import jax.numpy as jnp
    mesh = local_mesh()
    x = jnp.zeros(512, jnp.complex64)
    f = jax.jit(lambda a: fft_fourstep(a, mesh, reorder=False))
    txt = f.lower(x).compile().as_text()
    n_a2a = count_collectives(txt)["all-to-all"]
    assert n_a2a == 1, f"expected exactly 1 all-to-all, got {n_a2a}"
    for coll in ("all-reduce", "all-gather", "reduce-scatter"):
        assert not count_collectives(txt)[coll], \
            f"unexpected {coll} in four-step HLO"


def test_fft2_sharded_collective_budget():
    """Sharded 2-D FFT: two all-to-alls (transpose there and back),
    nothing else."""
    import jax.numpy as jnp
    mesh = local_mesh()
    x = jnp.zeros((64, 64), jnp.complex64)
    f = jax.jit(lambda a: fft2_sharded(a, mesh))
    txt = f.lower(x).compile().as_text()
    n_a2a = count_collectives(txt)["all-to-all"]
    assert n_a2a == 2, f"expected exactly 2 all-to-alls, got {n_a2a}"
    for coll in ("all-reduce", "all-gather", "reduce-scatter"):
        assert not count_collectives(txt)[coll], \
            f"unexpected {coll} in 2-D FFT HLO"


def test_fourstep_overlap_parity():
    """overlap_chunks tiles the transpose; results must be bit-identical
    to the unchunked schedule and round-trip with the chunked inverse."""
    import jax.numpy as jnp
    mesh = local_mesh()
    x = jnp.asarray(rng_complex((3, 1024), seed=7))
    base = np.asarray(fft_fourstep(x, mesh, reorder=False))
    for c in (2, 4):
        got = np.asarray(fft_fourstep(x, mesh, reorder=False,
                                      overlap_chunks=c))
        np.testing.assert_array_equal(got, base)
    spec = fft_fourstep(x, mesh, reorder=False, overlap_chunks=4)
    back = np.asarray(ifft_fourstep(spec, mesh, reordered=False,
                                    overlap_chunks=4))
    np.testing.assert_allclose(back, np.asarray(x), atol=1e-12)


def test_fourstep_overlap_collective_schedule():
    """The chunked schedule must lower to exactly C independent
    all-to-alls (one per chunk) and no other collectives — the HLO
    shape XLA's async scheduler needs to hide transpose behind
    butterflies."""
    import jax.numpy as jnp
    mesh = local_mesh()
    x = jnp.zeros(4096, jnp.complex64)
    f = jax.jit(lambda a: fft_fourstep(a, mesh, reorder=False,
                                       overlap_chunks=4))
    txt = f.lower(x).compile().as_text()
    n_a2a = count_collectives(txt)["all-to-all"]
    assert n_a2a == 4, f"expected 4 chunked all-to-alls, got {n_a2a}"
    for coll in ("all-reduce", "all-gather", "reduce-scatter"):
        assert not count_collectives(txt)[coll], \
            f"unexpected {coll} in overlap HLO"


def test_fourstep_overlap_bad_chunks():
    mesh = local_mesh()
    x = np.zeros(512, np.complex64)
    with pytest.raises(ValueError):
        fft_fourstep(x, mesh, overlap_chunks=3)   # N1=... not divisible
    with pytest.raises(ValueError):
        fft_fourstep(x, mesh, overlap_chunks=0)


def test_sharded_mc_models_match_single_device():
    """Sample-sharded MC pipelines (models/montecarlo, mesh=...):
    the asian QMC shard partition draws the SAME Halton index range as
    the single-chip call, so the sharded price must match to summation
    order; the VG MC shards use disjoint PRNG sub-streams, so
    agreement is at MC error."""
    from cfftpack_jax.models import (asian_option_qmc_device,
                                     vg_mc_price_device)
    a1 = asian_option_qmc_device(samples=4096)
    v1 = vg_mc_price_device(samples=200000, seed=2)
    # sharding spans ALL mesh axes: a 1-axis data mesh and a 2-D
    # (data, model) mesh must both work and agree
    for mesh in (local_mesh(), make_mesh((NDEV // 2, 2),
                                         ("data", "model"))):
        aN = asian_option_qmc_device(samples=4096, mesh=mesh)
        assert abs(a1 - aN) < 5e-5
        vN = vg_mc_price_device(samples=200000, seed=2, mesh=mesh)
        assert abs(v1 - vN) < 0.15
    with pytest.raises(ValueError):
        asian_option_qmc_device(samples=4097, mesh=local_mesh())
    with pytest.raises(ValueError):
        vg_mc_price_device(samples=200001, mesh=local_mesh())


def test_rfft2_sharded_matches_single_device():
    """Sharded 2-D real FFT (rows sharded; ragged n1//2+1 spectrum axis
    padded to tile the all-to-all): parity with ops.rfft2 incl. odd row
    length and ortho norm, plus the 2-all-to-all forward budget."""
    from cfftpack_jax.parallel import (rfft2_sharded, irfft2_sharded,
                                       rfft2_sharded_split,
                                       irfft2_sharded_split)
    import jax.numpy as jnp
    mesh = local_mesh()
    r = np.random.default_rng(5)
    for (n0, n1) in ((16, 24), (32, 15)):
        x = r.standard_normal((n0, n1))
        got = np.asarray(rfft2_sharded(x, mesh))
        np.testing.assert_allclose(got, np.asarray(ct.rfft2(x)),
                                   atol=TOL * 8)
        back = np.asarray(irfft2_sharded(jnp.asarray(got), n1, mesh))
        np.testing.assert_allclose(back, x, atol=TOL * 32)
        yr, yi = rfft2_sharded_split(x, mesh, norm="ortho")
        b2 = np.asarray(irfft2_sharded_split(yr, yi, n1, mesh,
                                             norm="ortho"))
        np.testing.assert_allclose(b2, x, atol=TOL * 32)
    with pytest.raises(ValueError):
        rfft2_sharded(np.ones((NDEV * 2 + 1, 8)), local_mesh())
    # collective budget: one transpose there + one back per direction
    from cfftpack_jax.parallel.fft2d import _rfft2_sharded_jit
    import jax
    x = jnp.zeros((16, 24))
    txt = _rfft2_sharded_jit.lower(x, local_mesh(), "data", "fftpack",
                                   None).compile().as_text()
    n_a2a = count_collectives(txt)["all-to-all"]
    # one transpose there + one back, times two split (re, im) planes
    assert n_a2a == 4, f"expected 4 all-to-all in forward, got {n_a2a}"


def test_sharded_hp_matches_single_device():
    """Batch-sharded double-float transforms (parallel/hp.py): the df
    quad planes shard over the mesh batch axis; results must be
    BIT-identical to the single-device hp engine (same programs, no
    collectives for per-row work) at f64-class accuracy vs numpy."""
    import numpy as np
    from cfftpack_jax.parallel import pfft_hp, pifft_hp, prfft_hp
    import cfftpack_jax as ct
    mesh = local_mesh()
    nd = mesh.shape["data"] if "data" in mesh.shape else None
    r = np.random.default_rng(4)
    b = 2 * mesh.devices.size
    x = r.standard_normal((b, 24)) + 1j * r.standard_normal((b, 24))
    y = pfft_hp(x, mesh)
    assert np.abs(y - np.fft.fft(x) / 24).max() < 1e-13
    np.testing.assert_array_equal(y, ct.fft_hp(x))
    back = pifft_hp(y, mesh)
    assert np.abs(back - x).max() < 1e-13
    v = r.standard_normal((b, 16))
    s = prfft_hp(v, mesh)
    assert np.abs(s - np.fft.rfft(v) / 16).max() < 1e-13
    np.testing.assert_array_equal(s, ct.rfft_hp(v))
    import pytest
    with pytest.raises(ValueError, match="divisible"):
        pfft_hp(x[: mesh.devices.size + 1], mesh)
