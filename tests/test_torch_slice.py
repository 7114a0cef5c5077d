"""The port's MPC-LTI closed loop as a whole, at float64 on the CPU: the
committed goldens (recorded by the JAX package) and fleet lanes against
single-lane rollouts."""

import numpy as np
import pytest
import torch

from car_racing_tpu_torch.models import controllers
from car_racing_tpu_torch.ops import dynamics, track
from car_racing_tpu_torch.racing import fused
from car_racing_tpu_torch.utils import params

F64 = torch.float64
KW = dict(device="cpu", dtype=F64)


def _setup(layout, width):
    return (
        track.load_track(layout, width=width, **KW),
        dynamics.BicycleParams.default(**KW),
        params.MPCParam.default(vt=0.8, **KW),
        params.SystemParam.default(**KW),
        controllers.target_state(0.8, 0.0, **KW),
    )


# the golden scenarios of car_racing_tpu/utils/golden_fixtures.py, at the
# tolerance of tests/test_reference_parity.py
@pytest.mark.parametrize("layout,width,n_steps", [
    ("l_shape", 0.8, 100), ("goggle", 1.0, 150), ("m_shape", 1.0, 150),
])
def test_mpc_lti_golden(layout, width, n_steps):
    golden = np.loadtxt(f"data/goldens/mpc_lti_{layout}.csv", delimiter=",")
    zeros = torch.zeros(6, dtype=F64)
    xc, us = fused.rollout_mpc_tracking(*_setup(layout, width), zeros, zeros, n_steps=n_steps)
    assert tuple(xc.shape) == golden.shape
    assert tuple(us.shape) == (n_steps, 2)
    np.testing.assert_allclose(xc.numpy(), golden, rtol=0, atol=1e-4)


def test_fleet_lanes_equal_single_lane_rollouts():
    setup = _setup("l_shape", 0.8)
    rng = np.random.default_rng(0)
    xc0 = torch.as_tensor(np.array([0.1, 0, 0, 0, 0, 0]) + 0.05 * rng.standard_normal((3, 6)))
    xg0 = torch.zeros(3, 6, dtype=F64)
    xc, us = fused.rollout_mpc_tracking_batch(*setup, xc0, xg0, n_steps=25)
    assert tuple(xc.shape) == (3, 26, 6) and tuple(us.shape) == (3, 25, 2)
    for b in range(3):
        xc_b, us_b = fused.rollout_mpc_tracking(*setup, xc0[b], xg0[b], n_steps=25)
        np.testing.assert_allclose(xc[b].numpy(), xc_b.numpy(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(us[b].numpy(), us_b.numpy(), rtol=0, atol=1e-10)
    assert (xc[:, -1, 4] > xc[:, 0, 4]).all()
