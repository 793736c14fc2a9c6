"""The control: the reference in the program's place, computed with TF32
on (the precision below the configuration's float32 with TF32 off), has to
come out as not correct. TF32 exists on the card only."""

import pytest

from portbench import control


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["imbe7200-hard.stream", "imbe7200-hard.batch",
                                      "ambe2450-soft.batch"])
def test_control_fails_the_limits(workload, cuda):
    rows = control.main(["--workload", workload, "--seeds", "2147483659", "--ticks", "40",
                         "--channels", "2048"])
    assert rows and all(not r["correct"] for r in rows), rows
