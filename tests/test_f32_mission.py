"""f32 — the dtype that actually runs on the accelerator — asserted end-to-end.

The other ATE acceptance tests run f64; these bound whole-mission drift at
the deployment dtype on the CPU (same scenario family as
``test_examples.py``):

* the 1-minute ICRA'18 mission replay at f32 through the generic scan path
  must hold the same 10 cm north-star bound as the f64 test;
* an 8-instance bank mission of the steady-state schedule at f32 must stay
  within stated bounds of the same mission at f64 — per-call parity
  (``test_kernels.py``) cannot bound accumulated divergence.

``chip_smoke.py`` carries the on-GPU half: it replays both missions at f32
on the card against f64 on the CPU.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

import icra18_mission


def test_icra18_mission_ate_bound_f32():
    """North-star acceptance at the deployment dtype: f32 whole-trajectory
    drift stays inside the 10 cm bound (measured 0.027 m — ~2.7x the f64
    figure, dominated by covariance roundoff, still 3.7x inside the bound)."""
    ate, dist = icra18_mission.main(["--cpu", "--minutes", "1.0", "--dtype", "f32"])
    assert dist > 30.0
    assert ate < 0.10, f"f32 ATE {ate:.3f} m exceeds the 10 cm acceptance bound"


def test_bank_mission_f32_matches_f64():
    """The 8-instance, 200-tick steady-state mission of ``chip_smoke.py``
    (predict + IMU acceleration every tick, DVL, pressure, ADCP and body
    efforts on their ICRA'18 rates, per-instance sensor noise) at f32
    against f64 on the CPU, held to the bounds the card is held to
    (``chip_smoke.compare_reference``: 1e-3 m, 1e-4 m/s, 1e-4 relative
    covariance trace)."""
    import chip_smoke

    f64 = chip_smoke.reference_mission(jnp.float64)
    f32 = chip_smoke.reference_mission(jnp.float32)
    assert all(np.all(np.isfinite(a)) for a in f32)
    pos_err, vel_err, trace_err = chip_smoke.compare_reference(f32, f64, "f32 vs f64")
    # the gap is f32 roundoff, not zero: the two runs really differ in dtype
    assert pos_err > 0.0


@pytest.mark.parametrize("field", ["nan", "position", "velocity", "trace"])
def test_compare_reference_rejects_divergence(field):
    """``chip_smoke.compare_reference`` fails a mission that ended in NaN
    (what the filter does with its matmuls in TF32) and one that drifted
    past any of its three bounds."""
    import chip_smoke

    ref = (np.zeros((8, 3)), np.zeros((8, 3)), np.ones(8))
    got = [a.copy() for a in ref]
    if field == "nan":
        got[0][3, 1] = np.nan
    elif field == "position":
        got[0][0, 0] = 1.5e-3
    elif field == "velocity":
        got[1][0, 0] = 1.5e-4
    else:
        got[2][0] = 1.0 + 1.5e-4
    with pytest.raises(AssertionError):
        chip_smoke.compare_reference(tuple(got), ref, field)
    chip_smoke.compare_reference(ref, ref, "same")
