"""Each cell run once on the card through its command, as a check runs it."""
import json
import os
import subprocess
import sys

import pytest

from perfbench import common


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in common.load_json(
    os.path.join(common.ROOT, "BENCHMARK.json"))["workloads"]])
def test_cell_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", name, "--seed",
                          "2147483659", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=common.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
