"""Model-level numerics gate wired into the suite.

Runs benchmarks/agreement_gate.py's gate in this process (one JAX
process per device).  On CPU the int8 and fp4 evaluators are bitwise
equal even unpinned; the pinned run is the bit-identity contract of
docs/NUMERICS.md.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))

from agreement_gate import run_gate  # noqa: E402


@pytest.mark.slow
def test_agreement_gate_pinned():
    """Pinned evaluators agree bitwise (prefix 1.0) on 8 prompts x 8
    steps."""
    out = run_gate(prompts=8, steps=8, pin=1)
    assert out["pass"], out
    assert out["prefix_agreement"] == 1.0, out


def test_agreement_gate_fast():
    """Small pinned gate in the default tier: a model-level int8-vs-fp4
    numerics regression surfaces in the fast run (4 prompts x 4
    steps)."""
    out = run_gate(prompts=4, steps=4, pin=1)
    assert out["pass"], out
    assert out["prefix_agreement"] == 1.0, out
