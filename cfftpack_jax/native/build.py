"""Build the native planner: python -m cfftpack_jax.native.build

Compiles plancore.cpp into libplancore.so next to this file using the
ambient g++ (no cmake/pybind needed for a single TU).  The Python layer
auto-detects the library; everything has pure fallbacks, so this is an
optional accelerator, not a hard dependency.
"""
from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "plancore.cpp")
OUT = os.path.join(HERE, "libplancore.so")


def build(verbose: bool = True) -> str:
    cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", SRC, "-o", OUT,
           "-lm"]
    if verbose:
        print("+", " ".join(cmd))
    subprocess.run(cmd, check=True)
    return OUT


if __name__ == "__main__":
    path = build()
    print(f"built {path}")
    sys.exit(0)
