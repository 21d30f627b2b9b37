"""``chip_smoke.py`` on the CPU: it refuses to run without a GPU, and its
exactness checks pass at a small size (the card runs them at 640x480)."""

import numpy as np
import pytest

import chip_smoke
from visual_odometry_rs_tpu.dataset import synthetic


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out


@pytest.mark.parametrize("check", ["samplers", "extraction", "lane_moves"])
def test_exactness_checks_small(check):
    if check == "samplers":
        chip_smoke.check_samplers(48, 64, n=256)
    elif check == "extraction":
        seq = synthetic.generate_sequence(nb_frames=1, height=48, width=64, seed=2)
        chip_smoke.check_extraction(seq.depths[0], seq.grays[0], nb_levels=3, cap=1024)
    else:
        chip_smoke.check_lane_moves(n_lanes=8, k_sub=4, row_shape=(16, 7))


def test_failed_check_raises():
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.check(False, "deliberately false")
    chip_smoke.check(bool(np.isfinite(1.0)), "finite")
