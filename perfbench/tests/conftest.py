"""Tests of the benchmark harness: they run on the CPU at small sizes;
those marked ``cuda`` run a cell on the card and skip elsewhere."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def small_cell(name: str, **cut):
    """The cell ``name`` with its sizes cut so that the CPU can run it:
    interactive frames at ``res`` square, training crops of 32 on a
    corpus of 12 frames of 64x64, batch 2 of 3-frame windows."""
    from perfbench import common
    cell = copy.deepcopy(common.cell(name))
    if cell["traffic"]["loop"] == "interactive":
        cell["config"]["scene"]["resolution"] = [cut.get("res", 32)] * 2
        cell["traffic"]["check_frames"] = cut.get("check_frames", 1)
        cell["traffic"]["warmup_frames"] = cut.get("warmup_frames", 2)
        if cell["limits"].get("check_pixels"):
            cell["limits"]["check_pixels"] = cut.get("check_pixels", 64)
    else:
        cell["config"]["train"].update(crop=32, batch=2, sequence=3)
        cell["traffic"].update(frame_hw=[64, 64], corpus_frames=12, max_steps=50)
    return cell


@pytest.fixture
def cpu_run():
    """Run a cut cell on the CPU through the harness's own entry point."""
    import torch
    from perfbench import run as bench
    torch.set_num_threads(2)

    def go(name, seconds=0.5, trace=0, seed=2**31 + 7, extra=(), hook=None, **cut):
        argv = ["--workload", name, "--seed", str(seed), "--seconds", str(seconds),
                "--trace", str(trace), *extra]
        return bench.main(argv, device=torch.device("cpu"), program_hook=hook,
                          cell=small_cell(name, **cut))
    return go
