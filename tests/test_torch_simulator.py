"""The port's offboard simulator path against the JAX package, at float64 on
the CPU: ``const_velocity_prediction`` and ``process_noise``, the host PID,
MPC-LTI and LQR loops through ``CarRacingSim`` (against the ``pid_l_shape``
golden, the port's fused rollout and the JAX host loops), the prescribed
obstacle, the simulator's pickles and the ``control_test`` driver.

``jax.random`` cannot be reproduced in torch, so noisy runs are held by
their distribution only.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from car_racing_tpu.ops import dynamics as jdyn
from car_racing_tpu.ops import track as jtrack
from car_racing_tpu.racing import policies as jpolicies
from car_racing_tpu.racing import simulator as jsimulator
from car_racing_tpu.racing import vehicles as jvehicles
from car_racing_tpu.utils import params as jparams
from car_racing_tpu_torch.apps import common, control_test
from car_racing_tpu_torch.ops import dynamics, track
from car_racing_tpu_torch.racing import fused, policies, simulator, vehicles
from car_racing_tpu_torch.models import controllers
from car_racing_tpu_torch.utils import params, profiling

F64 = torch.float64
KW = dict(device="cpu", dtype=F64)


def cpu(a):
    return torch.as_tensor(np.array(a, np.float64))


def port_sim(policy, n_steps, layout="l_shape", width=0.8, zero_noise=True, seed=0):
    tr = common.build_track(layout, width=width, device="cpu")
    ego = common.build_ego(tr, zero_noise=zero_noise, seed=seed)
    sim = common.build_sim(tr)
    sim.add_vehicle(ego)
    common.attach_policy(ego, sim, policy)
    sim.sim(sim_time=n_steps * 0.1)
    return sim, ego


def jax_sim(policy, n_steps):
    """tests/test_sim_tracking.py's host loop in the JAX package."""
    tr = jtrack.load_track("l_shape", width=0.8)
    ego = jvehicles.DynamicBicycleModel(name="ego", system_param=jparams.SystemParam.default())
    ego.set_zero_noise()
    ego.set_state_curvilinear(np.zeros(6))
    ego.set_state_global(np.zeros(6))
    ego.start_logging()
    sim = jsimulator.CarRacingSim()
    sim.set_timestep(0.1)
    sim.set_track(tr)
    sim.add_vehicle(ego)
    policy.set_timestep(0.1)
    policy.set_track(tr)
    policy.set_racing_sim(sim)
    ego.set_ctrl_policy(policy)
    sim.sim(sim_time=n_steps * 0.1)
    return sim, ego


def test_const_velocity_prediction_matches_jax():
    """Several states at once, one of them carried across the lap wrap."""
    jtr = jtrack.load_track("l_shape", width=0.8)
    tr = track.load_track("l_shape", width=0.8, **KW)
    L = float(tr.lap_length)
    xc = np.array([[0.8, 0.02, 0.1, 0.05, 3.0, 0.1],
                   [1.2, -0.05, -0.2, -0.1, L - 0.3, -0.2],
                   [0.5, 0.0, 0.3, 0.2, 12.0, 0.3]])
    xg = np.random.default_rng(3).standard_normal((3, 6))
    got_c, got_g = dynamics.const_velocity_prediction(tr, cpu(xc), cpu(xg), 0.1, 11)
    assert got_c.shape == (3, 11, 6)
    assert (got_c[1, :, 4] < got_c[1, 0, 4]).any()  # wrapped onto the next lap
    for b in range(3):
        want_c, want_g = jdyn.const_velocity_prediction(jtr, jnp.asarray(xc[b]), jnp.asarray(xg[b]),
                                                        0.1, 11)
        np.testing.assert_allclose(got_c[b].numpy(), np.asarray(want_c), rtol=0, atol=1e-12)
        np.testing.assert_allclose(got_g[b].numpy(), np.asarray(want_g), rtol=0, atol=1e-12)
    ego = vehicles.DynamicBicycleModel(name="ego", device="cpu")
    ego.set_track(tr)
    ego.set_state_curvilinear(xc[1])
    ego.set_state_global(xg[1])
    xc_n, xg_n = ego.get_trajectory_nsteps(0.0, 0.1, 11)
    assert torch.equal(cpu(xc_n.T), got_c[1]) and torch.equal(cpu(xg_n.T), got_g[1])


def test_process_noise_clips_distribution_and_seed():
    n = 10_000
    x = torch.zeros(n, 6, dtype=F64)
    out = dynamics.process_noise(torch.Generator().manual_seed(0), x)
    inc = out[:, :3].numpy()
    half_clip = 0.5 * np.array(dynamics.NOISE_CLIP)
    assert (np.abs(inc) <= half_clip).all()
    assert torch.equal(out[:, 3:], x[:, 3:])
    # 0.5 * N(0, scale^2) clipped at 5 (vx) and 10 (vy, wz) standard deviations:
    # the clip moves the standard deviation by under 2e-5 of itself
    sd = 0.5 * np.array(dynamics.NOISE_SCALE)
    assert (np.abs(inc.mean(axis=0)) <= 4 * sd / np.sqrt(n)).all()
    assert (np.abs(inc.std(axis=0) - sd) <= 4 * sd / np.sqrt(2 * (n - 1))).all()
    again = dynamics.process_noise(torch.Generator().manual_seed(0), x)
    other = dynamics.process_noise(torch.Generator().manual_seed(1), x)
    assert torch.equal(again, out) and not torch.equal(other, out)
    # the JAX package's noise has the same clips
    jinc = np.stack([np.asarray(jdyn.process_noise(k, jnp.zeros(6)))[:3]
                     for k in jax_keys(200)])
    assert (np.abs(jinc) <= half_clip).all()


def jax_keys(n):
    import jax

    return jax.random.split(jax.random.PRNGKey(0), n)


def test_host_pid_loop_matches_golden():
    """golden_fixtures.py:38-54: 200 PID steps through the simulator."""
    _, ego = port_sim(policies.PIDTracking(vt=0.8), 200)
    golden = np.loadtxt("data/goldens/pid_l_shape.csv", delimiter=",")
    log = np.asarray(ego.xcurv_log)
    assert log.shape == golden.shape
    np.testing.assert_allclose(log, golden, rtol=0, atol=1e-8)
    assert len(ego.solver_time) == 200 and ego.local_trajs == [None] * 200


def test_host_mpc_loop_matches_fused_rollout_and_jax():
    """tests/test_fused.py:12-53 on the port, and the JAX host loop."""
    mp = params.MPCParam.default(vt=0.8, **KW)
    sp = params.SystemParam.default(**KW)
    _, ego = port_sim(policies.MPCTracking(mp, sp), 60)
    log = np.asarray(ego.xcurv_log)
    zeros = torch.zeros(6, **KW)
    xc, _ = fused.rollout_mpc_tracking(
        track.load_track("l_shape", width=0.8, **KW), dynamics.BicycleParams.default(**KW), mp, sp,
        controllers.target_state(0.8, 0.0, **KW), zeros, zeros, n_steps=60)
    np.testing.assert_allclose(log, xc[1:].numpy(), rtol=0, atol=1e-9)
    _, jego = jax_sim(jpolicies.MPCTracking(jparams.MPCParam.default(vt=0.8),
                                            jparams.SystemParam.default()), 60)
    np.testing.assert_allclose(log, np.asarray(jego.xcurv_log), rtol=0, atol=1e-9)


def test_host_lqr_loop_matches_jax_and_tracks():
    """200 steps against the JAX host loop, then tests/test_sim_tracking.py:
    77-85's gates."""
    sim, ego = port_sim(policies.LQRTracking(params.LQRParam.default(vt=0.8, **KW),
                                             params.SystemParam.default(**KW)), 200)
    _, jego = jax_sim(jpolicies.LQRTracking(jparams.LQRParam.default(vt=0.8),
                                            jparams.SystemParam.default()), 200)
    np.testing.assert_allclose(np.asarray(ego.xcurv_log), np.asarray(jego.xcurv_log), rtol=0,
                               atol=1e-9)
    traj = sim.full_trajectory("ego")
    tail = traj[len(traj) // 2:]
    assert abs(tail[:, 0].mean() - 0.8) < 0.15
    assert np.abs(tail[:, 5]).max() < 0.8


def test_no_dynamics_model_matches_jax():
    jtr = jtrack.load_track("l_shape", width=1.0)
    tr = track.load_track("l_shape", width=1.0, **KW)
    s_coef, ey_coef = [0.2, 4.0], [0.01, -0.1]
    got = vehicles.NoDynamicsModel(name="car1", device="cpu")
    want = jvehicles.NoDynamicsModel(name="car1")
    for v, t in ((got, tr), (want, jtr)):
        v.set_track(t)
        v.set_timestep(0.1)
        v.set_state_curvilinear_func(s_coef, ey_coef)
        for _ in range(7):
            v.forward_one_step()
    for a, b in zip(got.get_estimation(3.7), want.get_estimation(3.7)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12)
    for a, b in zip(got.get_trajectory_nsteps(0.0, 0.1, 12),
                    want.get_trajectory_nsteps(0.0, 0.1, 12)):
        assert a.shape == (6, 12)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.xglob_log), np.asarray(want.xglob_log), rtol=0,
                               atol=1e-12)


def test_simulator_save_load_round_trip(tmp_path):
    """A noisy run pickled and loaded: the same logs, and the two copies,
    stepped on, draw the same noise from the restored generator state."""
    sim, ego = port_sim(policies.PIDTracking(vt=0.8), 15, zero_noise=False, seed=3)
    path = tmp_path / "sim.obj"
    sim.save(path)
    back = simulator.CarRacingSim.load(path)
    bego = back.vehicles["ego"]
    np.testing.assert_array_equal(np.asarray(bego.xcurv_log), np.asarray(ego.xcurv_log))
    assert bego.ctrl_policy.racing_sim is back and bego.track.lap_length.device.type == "cpu"
    sim.sim(sim_time=0.5)
    back.sim(sim_time=0.5)
    np.testing.assert_array_equal(np.asarray(bego.xcurv_log), np.asarray(ego.xcurv_log))
    np.testing.assert_array_equal(back.full_trajectory("ego"), sim.full_trajectory("ego"))


def test_vehicle_refuses_a_track_on_another_device_or_dtype():
    ego = vehicles.DynamicBicycleModel(name="ego", device="cpu")
    with pytest.raises(ValueError, match="the track is torch.float32"):
        ego.set_track(track.load_track("l_shape", device="cpu", dtype=torch.float32))


@pytest.mark.parametrize("policy", ["pid", "lqr", "mpc-lti"])
def test_control_test_cli_runs(policy, repo_root):
    """tests/test_apps.py:56-77 for the port's driver: the flags, a short
    simulation on the CPU, the saved simulator loaded back."""
    code = (
        "import sys; sys.argv = ['x', '--ctrl-policy', %r, '--simulation', '--zero-noise',"
        " '--device', 'cpu'];"
        "import car_racing_tpu_torch.racing.simulator as s;"
        "orig = s.CarRacingSim.sim;"
        "s.CarRacingSim.sim = lambda self, sim_time=1.0, **kw: orig(self, sim_time=min(sim_time,"
        " 3.0), **kw);"
        "from car_racing_tpu_torch.apps.control_test import main, tracking; main();"
        "sim = tracking({'ctrl_policy': %r, 'simulation': False, 'track_layout': 'l_shape'});"
        "assert len(sim.vehicles['ego'].xcurv_log) == 30"
        % (policy, policy)
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=repo_root, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "solver latency" in res.stdout


def test_control_test_refuses_plotting():
    args = {"ctrl_policy": "pid", "simulation": True, "track_layout": "l_shape",
            "device": "cpu", "plotting": True, "animation": False}
    with pytest.raises(NotImplementedError, match="--plotting: plotting is not ported"):
        control_test.tracking(args)


def test_device_trace_yields_the_trace_and_writes_it(tmp_path):
    """utils/profiling.device_trace: the profiler's events hold the traced
    product; with a ``log_dir`` the trace is written there as well."""
    a = torch.ones(8, 8, dtype=torch.float64)
    with profiling.device_trace(log_dir=None) as prof:
        a @ a
    assert any(e.name == "aten::mm" for e in prof.events())
    with profiling.device_trace(log_dir=str(tmp_path)) as prof:
        a @ a
    assert any(e.name == "aten::mm" for e in prof.events())
    assert [p.suffix for p in tmp_path.iterdir()] == [".json"]
