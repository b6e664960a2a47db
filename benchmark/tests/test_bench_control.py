"""The control of ``correct``, on the card: each cell run with the
program's own int8 trunk in place of its bf16 one (``--control int8``),
the nearest precision below the configuration's, at the cell's own size
and load, on three seeds, has to come out not correct.

    python3 -m pytest benchmark/tests/test_bench_control.py

It needs as many CUDA cards as the cell asks for and skips elsewhere.
"""

import json
import subprocess
import sys

import pytest

from benchmark.lib import registry

SPEC = registry.load_spec()
SEEDS = (2147483659, 3000000019, 4000000007)


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("seed", SEEDS)
def test_int8_control_is_not_correct(card, cell, seed):
    import torch
    chips = registry.cell(SPEC, cell)["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} cards")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "10", "--trace", "0", "--control", "int8"],
        cwd=registry.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
