"""On the card, at each cell's own size: the program as its
configuration states it passes the cell's limits and the control (the
program's bfloat16 path) fails them. Skips without a card; run with
`python3 -m pytest benchmark/tests/test_bench_card.py` on the machine
with the card."""

from __future__ import annotations

import pytest

from benchmark import calibrate, compare
from benchmark import run as bench_run

pytestmark = pytest.mark.card
SEED = 2 ** 31 + 31


@pytest.mark.parametrize("workload", ["panda_full.serve_b128",
                                      "baxter_full.train_b64"])
def test_program_passes_and_control_fails(card, workload):
    bench = bench_run.load_benchmark()
    limits = compare.load_limits(bench_run.HERE, workload)
    program = calibrate.one(bench, workload, SEED, "program", card)
    control = calibrate.one(bench, workload, SEED, "control", card)
    assert compare.verdict(program["numbers"], limits)[0], program
    assert not compare.verdict(control["numbers"], limits)[0], control
