"""Numerical debugging hooks (SURVEY.md §5).

The reference's only failure handling is integer return codes; here
shape errors raise at trace time and numeric failures can be trapped
with JAX's NaN/Inf machinery.
"""
from __future__ import annotations

import re

__all__ = ["enable_nan_checks", "check_finite", "rel_l2",
           "count_collectives"]

COLLECTIVES = ("all-to-all", "all-reduce", "all-gather", "reduce-scatter",
               "collective-permute")
# an instruction's opcode follows its result type: "= f32[8] all-to-all("
# or, once the GPU scheduler made it asynchronous, "... all-to-all-start("
# (its "-done" half is not counted again)
_OPCODE = re.compile(r"\s(" + "|".join(COLLECTIVES) + r")(?:-start)?\(")


def enable_nan_checks(enable: bool = True):
    """Raise on NaN/Inf produced by any jitted computation
    (jax_debug_nans re-runs the offending op un-jitted to locate it)."""
    import jax
    jax.config.update("jax_debug_nans", bool(enable))
    jax.config.update("jax_debug_infs", bool(enable))


def check_finite(*arrays, name: str = "array"):
    """Host-side assertion that every array is finite (post-hoc check
    for pipelines that keep NaN-checking off in production)."""
    import numpy as np
    for i, a in enumerate(arrays):
        v = np.asarray(a)
        if not np.all(np.isfinite(v)):
            bad = int(np.sum(~np.isfinite(v)))
            raise FloatingPointError(
                f"{name}[{i}]: {bad} non-finite values "
                f"(shape {v.shape}, dtype {v.dtype})")


def rel_l2(got, want) -> float:
    """Relative L2 error ||got - want|| / ||want|| on the host."""
    import numpy as np
    got = np.asarray(got)
    want = np.asarray(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-300))


def count_collectives(hlo_text: str) -> dict[str, int]:
    """Collective instructions in compiled HLO text, by kind.

    Counts a synchronous op (``all-to-all(``, as XLA:CPU emits it) and
    an asynchronous pair (``all-to-all-start(`` / ``-done(``, as
    XLA:GPU may emit it) alike, once each."""
    counts = dict.fromkeys(COLLECTIVES, 0)
    for line in hlo_text.splitlines():
        m = _OPCODE.search(line)
        if m:
            counts[m.group(1)] += 1
    return counts
