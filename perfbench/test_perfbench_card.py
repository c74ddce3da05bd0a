"""The benchmark's command on the card: each one-card cell's run, short,
through ``run.py`` as the check runs it, ends with a correct result line of
the contract's keys; and the f32 control of each comes out not correct at
the cell's own size. Skips without a CUDA device (decided inside the test).

    python -m pytest perfbench -m card
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from pbcore import spec

CELLS = ["hpcg-104.cg50", "poisson2d-512-chol.refactor"]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_a_short_run_on_the_card_is_correct(name, traced):
    _need_card()
    cmd = [sys.executable, os.path.join(spec.BENCH_DIR, "run.py"),
           "--workload", name, "--seed", str(2 ** 31 + 17), "--seconds", "2",
           "--trace", str(traced)]
    out = subprocess.run(cmd, cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
    want = spec.Cell(name).per_layer if traced else spec.Cell(name).end_to_end
    assert set(res["metrics"]) == {m["name"] for m in want}
    assert list(res)[-1] == "checks"


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_f32_control_on_the_card_is_not_correct(name):
    _need_card()
    from pbcore import main

    cell = spec.Cell(name)
    cell.config["dtype"] = "float32"
    rec = main.run_cell(cell, 2 ** 31 + 19, 2.0, False, 0.0)
    assert not rec.correct
