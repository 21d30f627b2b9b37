"""Accuracy regression matrix (VERDICT round-4 item 6): pinned ATE bounds
over the tracker's full option surface, so perf work (warm start, iteration
budgets, selector variants) cannot silently trade accuracy.

The full matrix prints from ``tools/accuracy_matrix.py``; this test runs a
representative core on one scene with asserted bounds.  All combos share
one rendered sequence (module fixture) — the matrix is ~12 tracker runs.
"""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))

import accuracy_matrix  # noqa: E402


@pytest.fixture(scope="module")
def scene():
    return accuracy_matrix._scene()


# combo -> (tracked ATE bound, refined-vs-tracked degradation allowance)
CORE = {
    "c2f_l2_nobr_noref": 0.004,
    "c2f_huber_nobr_noref": 0.004,
    "c2f_l2_br_noref": 0.006,
    "c2f_huber_br_noref": 0.006,
    "dso_l2_nobr_noref": 0.008,       # a=0.2 scene-tuned (tools/accuracy_matrix.py)
    "dsofix_l2_nobr_noref": 0.008,
    "dsofix_huber_br_noref": 0.010,
    "c2f_l2_nobr_noref_cv": 0.004,    # warm start must not degrade
    "c2f_l2_nobr_noref_cvbudget": 0.004,
}
REFINE_CORE = ["c2f_l2_nobr_refine", "dsofix_l2_nobr_refine"]


@pytest.mark.parametrize("combo", sorted(CORE))
def test_tracked_ate_bound(scene, combo):
    overrides, refine = accuracy_matrix.COMBOS[combo]
    assert not refine
    tracked, _ = accuracy_matrix.run_combo(scene, overrides, False)
    assert tracked < CORE[combo], (combo, tracked)


@pytest.mark.parametrize("combo", REFINE_CORE)
def test_refined_ate_within_floor(scene, combo):
    overrides, refine = accuracy_matrix.COMBOS[combo]
    assert refine
    tracked, refined = accuracy_matrix.run_combo(scene, overrides, True)
    # refinement corrects gross drift; on an already-accurate trajectory it
    # must stay within the photometric floor of the tracked estimate
    assert refined < tracked + 0.005, (combo, tracked, refined)
    assert refined < 0.01, (combo, refined)
