"""On the card: the control (the port's own int8 path: int8 weights, int8×int8
matmuls and int8 K/V, in the program's place) at each cell's own widths
and batch, over a short window, must come out as not correct under the
cell's limits on every seed (its encoder output lies several times farther
from the reference's than the program's; PERF.md), and the program, on the
first of them, as correct.  Run on the chip with ``python -m pytest
gpubench/tests -m card``; skips elsewhere."""

import time

import pytest

from gpubench.lib import cell as cell_mod, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEEDS = (2**31 + 4242, 2**31 + 4243, 2**31 + 4244)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_refused_and_the_program_is_not(name, card):
    c = spec.cell(name)
    seconds = 6.0 if c.traffic["driver"] == "serve" else 2.0
    refused = 0
    for seed in SEEDS:
        control = cell_mod.run_cell(c, seed, seconds, False, card, time.perf_counter(),
                                    control=True)
        refused += not control["correct"]
    assert refused == len(SEEDS), refused
    program = cell_mod.run_cell(c, SEEDS[0], seconds, False, card, time.perf_counter())
    assert program["correct"], program["checked"]
