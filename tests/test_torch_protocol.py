"""The port's learning protocol glue against the JAX package, at float64 on
the CPU: the Frenet-to-global conversion, the host lap-cut and column
construction, the PID closed loop, the in-loop promotion, and
``run_learning_protocol`` from a standing start.

The same numpy inputs go through both packages in each test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from car_racing_tpu.ops import dynamics as jdyn
from car_racing_tpu.ops import lmpc_learning as jlearn
from car_racing_tpu.ops import track as jtrack
from car_racing_tpu.racing import protocol as jprotocol
from car_racing_tpu_torch.models import controllers
from car_racing_tpu_torch.ops import dynamics, lmpc_learning, track
from car_racing_tpu_torch.racing import fused, protocol
from car_racing_tpu_torch.utils import fixtures

F64 = torch.float64
KW = dict(device="cpu", dtype=F64)


def golden(name):
    return np.loadtxt(f"data/goldens/{name}.csv", delimiter=",")


@pytest.mark.parametrize("layout", fixtures.LAYOUTS)
def test_frenet_to_global_matches_jax(layout):
    """Random states over three laps' worth of s (wrapped), and states on
    every segment boundary and its membership tolerance, where the first
    matching segment must win as in the JAX package."""
    jt = jtrack.load_track(layout, width=1.0)
    tt = track.load_track(layout, width=1.0, **KW)
    L = float(jt.lap_length)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, 6))
    x[:, 4] = rng.uniform(-L, 2 * L, 300)
    x[:, 5] = rng.uniform(-1.0, 1.0, 300)
    s0, seg = np.asarray(jt.s0), np.asarray(jt.seg_len)
    edges = np.concatenate([s0, s0 + seg, s0 + seg + 1e-3, s0 + seg + 1e-3 - 1e-12,
                            [L, 0.0, -1e-13, L - 1e-13]])
    xb = np.repeat(x[:1], len(edges), axis=0)
    xb[:, 4] = edges
    x = np.concatenate([x, xb])
    want = np.stack([np.asarray(jtrack.frenet_to_global_state(jt, jnp.asarray(r))) for r in x])
    got = track.frenet_to_global_state(tt, torch.as_tensor(x))
    assert tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # the batched form is the per-state form row by row
    np.testing.assert_array_equal(track.frenet_to_global_state(tt, torch.as_tensor(x[7])).numpy(),
                                  got[7].numpy())
    xy = track.frenet_to_global_xy(tt, torch.as_tensor(x[:, 4]), torch.as_tensor(x[:, 5]))
    psi = track.frenet_to_global_psi(tt, torch.as_tensor(x[:, 4]), torch.as_tensor(x[:, 5]))
    np.testing.assert_allclose(xy.numpy(), want[:, 4:], rtol=0, atol=1e-12)
    np.testing.assert_allclose(track.wrap_angle(psi + torch.as_tensor(x[:, 3])).numpy(),
                               np.asarray(jtrack.wrap_angle(jnp.asarray(want[:, 3]))),
                               rtol=0, atol=1e-12)


def test_compute_cost_host_matches_jax():
    g = golden("lmpc_lap_l_shape")
    L = float(jtrack.load_track("l_shape", width=1.0).lap_length)
    for lap in (L, 0.5 * L, g[-1, 4] + 1.0):  # a lap, one crossed early, one never crossed
        want = jlearn.compute_cost_host(g, lap)
        np.testing.assert_array_equal(lmpc_learning.compute_cost_host(g, lap), want)
        np.testing.assert_array_equal(lmpc_learning.compute_cost_host(g, lap),
                                      lmpc_learning.compute_cost(torch.as_tensor(g), lap).numpy())


def test_lap_cut_and_column_match_jax():
    g = golden("lmpc_lap_l_shape")
    u = np.random.default_rng(4).standard_normal((len(g) - 1, 2))
    L = float(jtrack.load_track("l_shape", width=1.0).lap_length)
    got, want = protocol.cut_first_lap(g, u, L), jprotocol.cut_first_lap(g, u, L)
    assert got[2] == want[2] == len(g) - 1
    for a, b in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        np.testing.assert_array_equal(a, b)
    for P in (len(g) + 1, 400):
        for a, b in zip(protocol.lap_column_from_traj(got[0], got[1], P),
                        jprotocol.lap_column_from_traj(want[0], want[1], P)):
            np.testing.assert_array_equal(a, b)
    for cut in (protocol.cut_first_lap, jprotocol.cut_first_lap):
        with pytest.raises(RuntimeError, match="never completed a lap"):
            cut(g[:-1], u[:-1], L)


def test_promote_matches_lap_column_from_traj():
    """The in-loop promotion of a lane's lap buffer against the host
    column construction of the same lap, for three lanes whose laps end at
    different steps; the last lap runs past the column's end, where the
    crossing row clips to P - 1 as in the JAX scan."""
    rng = np.random.default_rng(5)
    P, Ts = 200, [179, 120, 230]
    lap_ss = rng.standard_normal((3, P, 6))  # rows past a lap hold stale states
    lap_u = rng.standard_normal((3, P, 2))
    cross = rng.standard_normal((3, 6))
    ss, u, q = fused.promote(torch.as_tensor(lap_ss), torch.as_tensor(lap_u),
                             torch.as_tensor(Ts), torch.as_tensor(cross))
    for b, T in enumerate(Ts):
        pad = max(T - P, 0)
        lap_xc = np.concatenate([lap_ss[b, :T], np.zeros((pad, 6)), cross[b][None]])
        lap_uu = np.concatenate([lap_u[b, :T], np.zeros((pad, 2))])
        want = [a[:P] for a in jprotocol.lap_column_from_traj(lap_xc, lap_uu, max(P, T + 1))]
        want[0][min(T, P - 1)] = cross[b]
        for got_, want_ in zip((ss[b], u[b], q[b]), want):
            np.testing.assert_array_equal(got_.numpy(), want_)


def test_rollout_pid_matches_jax_and_golden():
    """The PID loop of the protocol's first stage, at the golden's scenario
    (l_shape, width 0.8, vt 0.8, standing start, 200 steps).  The golden
    holds each step's state after the step, so it is rows 1..200."""
    jt = jtrack.load_track("l_shape", width=0.8)
    tt = track.load_track("l_shape", width=0.8, **KW)
    jx, ju = jprotocol.rollout_pid(jt, jdyn.BicycleParams.default(),
                                   jnp.asarray([0.8, 0, 0, 0, 0, 0.0]), jnp.zeros(6),
                                   jnp.zeros(6), n_steps=200)
    zeros = torch.zeros(6, **KW)
    x, u = protocol.rollout_pid(tt, dynamics.BicycleParams.default(**KW),
                                controllers.target_state(0.8, 0.0, **KW), zeros, zeros,
                                n_steps=200)
    assert tuple(x.shape) == (201, 6) and tuple(u.shape) == (200, 2)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-10)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=1e-10)
    np.testing.assert_allclose(x.numpy()[1:], golden("pid_l_shape"), rtol=0, atol=1e-8)


def test_rollout_pid_batch_lanes_equal_single_runs():
    tt = track.load_track("l_shape", width=0.8, **KW)
    bike = dynamics.BicycleParams.default(**KW)
    xt = controllers.target_state(0.8, 0.0, **KW)
    xc0 = torch.as_tensor(0.05 * np.random.default_rng(6).standard_normal((3, 6)))
    xg0 = torch.zeros(3, 6, **KW)
    x, u = protocol.rollout_pid_batch(tt, bike, xt, xc0, xg0, n_steps=20)
    assert tuple(x.shape) == (3, 21, 6) and tuple(u.shape) == (3, 20, 2)
    for b in range(3):
        xb, ub = protocol.rollout_pid(tt, bike, xt, xc0[b], xg0[b], n_steps=20)
        assert torch.equal(x[b], xb) and torch.equal(u[b], ub)


def test_run_learning_protocol_one_lap_matches_jax(tmp_path):
    """The protocol from a standing start with one learning lap, l_shape at
    width 1.0, in both packages: the PID and MPC-LTI seed laps take the
    same steps, their columns agree, the learned lap beats the seed laps,
    and the raceline export writes the same files as the JAX package's
    export of the same result (into ``tmp_path`` only)."""
    jt = jtrack.load_track("l_shape", width=1.0)
    tt = track.load_track("l_shape", width=1.0, **KW)
    # the seed laps take 294 and 260 steps and the learned lap under 200:
    # shorter rollouts than the defaults' 494 and 270 steps cut the same laps
    steps = dict(n_steps_seed=300, n_steps_learn=200)
    want = jprotocol.run_learning_protocol(jt, n_laps=1, **steps)
    got = protocol.run_learning_protocol(tt, n_laps=1, **steps)
    assert len(got["lap_steps"]) == 3
    assert got["lap_steps"][:2] == want["lap_steps"][:2]
    assert all(a > b for a, b in zip(got["lap_steps"], got["lap_steps"][1:])), got["lap_steps"]
    for k in ("ss0", "q0", "ss1", "q1"):
        a, b = got["seed_columns"][k], want["seed_columns"][k]
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=k)
    T = got["lap_steps"][1]
    ss1 = got["seed_columns"]["ss1"]
    assert ss1[T, 4] >= float(tt.lap_length) and (ss1[T + 1:] == protocol.SENTINEL).all()
    assert got["xcurv"].shape == (201, 6)
    assert np.isfinite(got["xcurv"]).all() and np.abs(got["xcurv"][:, 5]).max() <= 1.0

    it = protocol.export_learned_raceline(got, tt, "l_shape", data_dir=str(tmp_path / "port"))
    jit_ = jprotocol.export_learned_raceline(got, jt, "l_shape", data_dir=str(tmp_path / "jax"))
    assert it == jit_ == 2
    for kind in ("xcurv", "xglob"):
        a = np.loadtxt(tmp_path / "port" / "optimal_traj" / f"{kind}_l_shape_learned.csv",
                       delimiter=",")
        b = np.loadtxt(tmp_path / "jax" / "optimal_traj" / f"{kind}_l_shape_learned.csv",
                       delimiter=",")
        assert a.shape == (got["lap_steps"][2] + 1, 6)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=kind)
