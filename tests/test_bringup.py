"""The GPU bring-up surface on the CPU: no Pallas in any traced family at
the chip_smoke.py phase-C shapes, every chip_smoke phase at tiny sizes,
its refusal to run without a GPU, the compile-cache placement rule and
the GPU-aware HLO collective counter.

chip_smoke.py itself runs these phases at full size on the card.
"""
import json
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from cfftpack_jax.utils.cache import compilation_cache_dir  # noqa: E402
from cfftpack_jax.utils.debug import count_collectives  # noqa: E402


@pytest.mark.parametrize("name,shape", chip_smoke.PHASE_C,
                         ids=[f"{n}-{'x'.join(map(str, s))}"
                              for n, s in chip_smoke.PHASE_C])
def test_traced_family_has_no_pallas(name, shape):
    """Tracing only (shape specs, no data, no compile): the forward and
    the inverse of every family at its real width are plain XLA."""
    fwd, inv, _, _ = chip_smoke._family(name, shape)
    specs = chip_smoke._inputs(name, shape)
    text = str(jax.make_jaxpr(fwd)(*specs))
    if inv is not None:
        outs = jax.eval_shape(fwd, *specs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        text += str(jax.make_jaxpr(inv)(*outs))
    assert "pallas" not in text


TINY_C = (("fft", (8, 64)), ("fft", (4, 101)), ("rfft", (8, 64)),
          ("dct2", (8, 64)), ("dct4", (8, 64)), ("rfilter", (8, 64)),
          ("fft2", (2, 16, 24)), ("rfft2", (2, 16, 24)),
          ("dctn", (2, 16, 24)))


def _phase(phase):
    if phase == "A":
        info = chip_smoke.phase_a(
            smi=[sys.executable, "-c", "print('Fake card, 1.00 W')"])
        assert info["nvidia_smi"] == ["Fake card, 1.00 W"]
        assert info["count"] == len(jax.devices())
        return [{"ok": info["cache_dir"] == compilation_cache_dir()}]
    if phase == "B":
        return chip_smoke.phase_b(hp_shape=(4, 64))
    if phase == "C":
        return chip_smoke.phase_c(TINY_C, card="cpu")
    if phase == "D":
        return chip_smoke.phase_d(pricer_ns=(1 << 7, 1 << 10),
                                  vg_ns=(1 << 16,), ladder_n=8192,
                                  vg_samples=50000, dct_batch=4)
    return chip_smoke.phase_e(4, n=1024, m2=64, m3=128, qmc_samples=256)


@pytest.mark.parametrize("phase", "ABCDE")
def test_chip_smoke_phase_on_cpu(phase):
    recs = _phase(phase)
    assert recs and all(r["ok"] for r in recs), \
        [r for r in recs if not r["ok"]]
    if phase == "C":
        # every family timed once, jnp.fft where it computes the same
        fwd = [r for r in recs if r["check"].endswith(" fwd")]
        assert len(fwd) == len(TINY_C)
        assert all(r["wall_s"] > 0 and r["compile_s"] > 0 for r in fwd)
        assert sum("jnp_fft_wall_s" in r for r in fwd) == len(TINY_C) - 1
    if phase == "E":
        budgets = [r for r in recs if "a2a_budget" in r]
        assert len(budgets) == 4
        assert all(r["a2a"] == r["a2a_budget"] for r in budgets)


@pytest.mark.parametrize("argv", [[], ["--multichip"]])
def test_chip_smoke_refuses_cpu(argv, capsys):
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


@pytest.mark.parametrize("env,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/srv/jaxcache"}, "/srv/jaxcache"),
    ({}, os.path.join(ROOT, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, os.path.join(ROOT, ".jax_cache")),
])
def test_compilation_cache_dir(env, want):
    assert compilation_cache_dir(env) == want


@pytest.mark.parametrize("from_env", [True, False])
def test_compiled_programs_land_in_cache_dir(from_env, tmp_path):
    """A fresh process compiles one program; it persists in the env
    directory when that is set, else in .jax_cache/ of the checkout."""
    tag = f"land_{os.getpid()}_{int(from_env)}"
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if from_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    code = (
        "import jax, jax.numpy as jnp\n"
        "from cfftpack_jax.utils.cache import enable_compilation_cache\n"
        "print(enable_compilation_cache())\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        f"def {tag}(x):\n    return jnp.cos(x) * 3\n"
        f"jax.jit({tag})(jnp.ones(8)).block_until_ready()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()[-1]
    want = str(tmp_path) if from_env else os.path.join(ROOT, ".jax_cache")
    assert out == want
    assert any(f.startswith(f"jit_{tag}-") for f in os.listdir(want))


HLO_SAMPLES = {
    # XLA:CPU: synchronous ops
    "cpu": ("  %a = c64[2,8]{1,0} all-to-all(c64[2,8]{1,0} %x), "
            "dimensions={1}\n  ROOT %b = c64[2,8]{1,0} all-to-all(%a)",
            {"all-to-all": 2}),
    # XLA:GPU: asynchronous start/done pairs count once
    "gpu-async": ("  %s = ((c64[4]), c64[4]) all-to-all-start(c64[4] %y)\n"
                  "  %d = c64[4] all-to-all-done(((c64[4]), c64[4]) %s)\n"
                  "  %r = f32[] all-reduce-start(f32[] %z), to_apply=%add\n"
                  "  %q = f32[] all-reduce-done(f32[] %r)",
                  {"all-to-all": 1, "all-reduce": 1}),
    # an async wrapper counts through its wrapped computation
    "gpu-wrapped": ("%wrapped (p: f32[8]) -> f32[8] {\n"
                    "  ROOT %w = f32[8] all-gather(f32[2] %p), "
                    "dimensions={0}\n"
                    "}\n  %st = ((f32[2]), f32[8]) async-start(f32[2] %v), "
                    "calls=%wrapped\n  %dn = f32[8] async-done(%st)",
                    {"all-gather": 1}),
    # instruction names and operands that mention a collective do not
    "names": ("  %all-to-all.3 = f32[2] add(f32[2] %all-to-all.1, "
              "f32[2] %reduce-scatter.2)", {}),
    "permute": ("  %cp = f32[4] collective-permute-start(f32[4] %u), "
                "source_target_pairs={{0,1}}", {"collective-permute": 1}),
}


@pytest.mark.parametrize("kind", list(HLO_SAMPLES))
def test_count_collectives(kind):
    text, want = HLO_SAMPLES[kind]
    got = count_collectives(text)
    assert {k: v for k, v in got.items() if v} == want


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu):
    """The whole smoke run (phases A-D at full size) on the card."""
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=gpu, capture_output=True, text=True,
                         timeout=1500)
    assert run.returncode == 0, run.stderr[-4000:]
    last = json.loads(run.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
