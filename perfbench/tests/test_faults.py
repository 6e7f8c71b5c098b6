"""A run with its timed path broken underneath must come out not correct:
each fault the cell can have, planted where the program produces it
(perfbench/faults.py).  The look for a card is skipped; the rest of the
run is the harness's own."""
import pytest

from perfbench import faults


@pytest.mark.parametrize("fault", faults.BY_LOOP["interactive"])
def test_interactive_faults_are_caught(cpu_run, fault):
    line = cpu_run("cornell-800-interactive", hook=getattr(faults, fault))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", faults.BY_LOOP["train"])
def test_train_faults_are_caught(cpu_run, fault):
    line = cpu_run("rdae-256-train", seconds=0.1, hook=getattr(faults, fault))
    assert not line["correct"], line["checks"]
