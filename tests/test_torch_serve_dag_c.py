"""Port parity of the serve engine over Stree, Sdag and Spar against
cpr_tpu's on the CPU (the schedule and its checks are
test_torch_serve_dag_a.py's): k = 2, in full mode and in a 40-slot ring.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_serve_dag_a import RING, check_family  # noqa: E402


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.mark.parametrize("name", ["stree", "sdag", "spar"])
@pytest.mark.parametrize("window", [0, RING], ids=["full", "ring"])
def test_schedule_matches_reference(name, window):
    check_family(name, window, 47 + len(name) + window)
