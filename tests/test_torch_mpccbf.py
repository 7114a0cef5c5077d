"""The port's MPC-CBF path against the JAX package, at float64 on the CPU:
``solve_qp_nl`` on seeded problems, the CBF rows and their Jacobian, the
gate mask and the warm shift, the controller per step at states injected
from the ``mpccbf_l_shape`` golden, the closed loop against the golden,
and a float32 closed loop held by its behaviour.

The same numpy inputs go through both packages.  Over half of the golden
run's warm solves stop at their 20-iteration cap, and the reference's own
loop leaves its golden by 6e-5 to 9e-4 when the target vx moves by a few
ulps (``data/goldens/controller_spread.json``, written by ``python -m
tools.controller_spread``); a capped solve is held by its flag and
objective, not by its iterate.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from car_racing_tpu.models import controllers as jctrl
from car_racing_tpu.ops import ipm as jipm
from car_racing_tpu.ops import track as jtrack
from car_racing_tpu.utils import params as jparams
from car_racing_tpu_torch.models import controllers
from car_racing_tpu_torch.ops import dynamics, ipm, track
from car_racing_tpu_torch.racing import fused
from car_racing_tpu_torch.utils import convert, params

F64 = torch.float64
KW = dict(device="cpu", dtype=F64)
N, N_OBS = 10, 4
XT = [0.8, 0, 0, 0, 0, 0.0]


def cpu(a, dtype=np.float64):
    return torch.as_tensor(np.array(a, dtype))


def scenario():
    """The golden's obstacles (golden_fixtures.py:64-83)."""
    s_coef, ey_coef = np.zeros((N_OBS, 2)), np.zeros((N_OBS, 2))
    act = np.zeros(N_OBS, bool)
    s_coef[0], ey_coef[0], act[0] = [0.2, 4.0], [0.0, 0.1], True
    s_coef[1], ey_coef[1], act[1] = [0.2, 10.0], [0.0, -0.1], True
    halfs = np.ones((N_OBS, 2))
    halfs[:2] = [0.2, 0.1]
    return s_coef, ey_coef, act, halfs, np.array([0.2, 0.1])


def golden():
    return np.loadtxt("data/goldens/mpccbf_l_shape.csv", delimiter=",")


def record():
    with open("data/goldens/controller_spread.json") as f:
        return json.load(f)["mpccbf_l_shape"]


def test_mpccbf_param_carries_across():
    jp = jparams.MPCCBFParam.default(vt=0.8, alpha=0.6)
    tp = params.MPCCBFParam.default(vt=0.8, alpha=0.6, **KW)
    moved = convert.to_port(params.MPCCBFParam, convert.numpy_fields(jp), **KW)
    for name, v in convert.numpy_fields(jp).items():
        for p in (tp, moved):
            got = getattr(p, name)
            if isinstance(v, int):
                assert got == v and isinstance(got, int), name
            else:
                np.testing.assert_array_equal(got.numpy(), v, err_msg=name)


# ---- solve_qp_nl on seeded problems ----------------------------------------


def nl_problem(seed, n=8, m1=6, m2=3):
    """A convex QP with linear rows and concave quadratic rows
    ``r2 - w |z - c|^2 >= 0``; z = 0 is strictly feasible.  H dominates the
    rows' curvature, which the Gauss-Newton Hessian leaves out, so the
    seeds used converge with nonlinear rows active."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    H = M @ M.T + 10.0 * np.eye(n)
    g = 10.0 * rng.standard_normal(n)
    C = rng.standard_normal((m1, n))
    d = -1.0 - rng.random(m1)
    centers = rng.standard_normal((m2, n))
    w = 0.5 + rng.random(m2)
    r2 = w * (centers**2).sum(1) + 0.5 + rng.random(m2)
    return H, g, C, d, centers, w, r2


def jax_c_nl(centers, w, r2):
    centers, w, r2 = map(jnp.asarray, (centers, w, r2))

    def c_nl(z):
        diff = z[None, :] - centers
        return r2 - w * jnp.sum(diff * diff, axis=1), (-2.0 * w)[:, None] * diff

    return c_nl


def port_c_nl(centers, w, r2):
    centers, w, r2 = cpu(centers), cpu(w), cpu(r2)  # (Bt, m2, n), (Bt, m2), (Bt, m2)

    def c_nl(z):
        diff = z[:, None, :] - centers
        return r2 - w * (diff * diff).sum(dim=-1), (-2.0 * w)[..., None] * diff

    return c_nl


def warm_triple(prob, seed):
    """(lam, s) of a cold JAX solve of the problem with g moved a little."""
    H, g, C, d, centers, w, r2 = prob
    g2 = g + 0.3 * np.random.default_rng(seed).standard_normal(g.shape)
    sol = jipm.solve_qp_nl(*map(jnp.asarray, (H, g2, C, d)), jax_c_nl(centers, w, r2),
                           jnp.zeros(len(g)), iters=40)
    return np.asarray(sol.z), np.asarray(sol.lam), np.asarray(sol.s)


CASES = {
    "cold": dict(warm=[False] * 3, warm_if=False, cap=None),
    "warm": dict(warm=[True] * 3, warm_if=False, cap=None),
    "warm_if": dict(warm=[True, False, True], warm_if=True, cap=None),
    "iters_cap": dict(warm=[False] * 3, warm_if=False, cap=[2, 40, 5]),
    "warm_if_cap": dict(warm=[True, False, True], warm_if=True, cap=[3, 6, 40]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_qp_nl_matches_jax(case):
    """Three seeded problems as one batch against JAX's solve of each: the
    same flags and iterations, z, lam and s within 1e-10; and the batch
    against each problem alone in the port, within 1e-12."""
    spec = CASES[case]
    probs = [nl_problem(s) for s in (0, 3, 5)]
    triples = [warm_triple(p, 10 + i) for i, p in enumerate(probs)]
    use_warm = np.array(spec["warm"])
    z0 = np.stack([t[0] if wi else np.zeros(8) for t, wi in zip(triples, use_warm)])
    kw_t, want = {}, []
    for b, (prob, trip) in enumerate(zip(probs, triples)):
        H, g, C, d, centers, w, r2 = prob
        kw = {}
        if use_warm[b] or spec["warm_if"]:
            kw.update(lam0=jnp.asarray(trip[1]), s0=jnp.asarray(trip[2]))
        if spec["warm_if"]:
            kw["warm_if"] = jnp.asarray(bool(use_warm[b]))
        if spec["cap"] is not None:
            kw["iters_cap"] = jnp.asarray(spec["cap"][b])
        want.append(jipm.solve_qp_nl(*map(jnp.asarray, (H, g, C, d)), jax_c_nl(centers, w, r2),
                                     jnp.asarray(z0[b]), iters=40, **kw))
    stack = lambda i: cpu(np.stack([p[i] for p in probs]))
    c_nl = port_c_nl(*(np.stack([p[i] for p in probs]) for i in (4, 5, 6)))
    if use_warm.any() or spec["warm_if"]:
        if not spec["warm_if"] and not use_warm.all():
            raise AssertionError("a static warm start is all or nothing")
        kw_t.update(lam0=cpu([t[1] for t in triples]), s0=cpu([t[2] for t in triples]))
    if spec["warm_if"]:
        kw_t["warm_if"] = torch.as_tensor(use_warm)
    if spec["cap"] is not None:
        kw_t["iters_cap"] = torch.as_tensor(spec["cap"])
    got = ipm.solve_qp_nl(stack(0), stack(1), stack(2), stack(3), c_nl, cpu(z0), iters=40,
                          **kw_t)
    for b, w in enumerate(want):
        assert bool(got.converged[b]) == bool(w.converged), b
        assert int(got.iterations[b]) == int(w.iterations), b
        for name in ("z", "lam", "s"):
            np.testing.assert_allclose(getattr(got, name)[b].numpy(), np.asarray(getattr(w, name)),
                                       rtol=0, atol=1e-10, err_msg=f"{name}[{b}]")
        # each problem alone, through the same port solver
        one = lambda a: a[b:b + 1]
        kw1 = {k: one(v) for k, v in kw_t.items()}
        alone = ipm.solve_qp_nl(*(one(stack(i)) for i in range(4)),
                                port_c_nl(*(p[None] for p in probs[b][4:])), one(cpu(z0)),
                                iters=40, **kw1)
        assert int(alone.iterations[0]) == int(got.iterations[b])
        assert bool(alone.converged[0]) == bool(got.converged[b])
        np.testing.assert_allclose(alone.z[0].numpy(), got.z[b].numpy(), rtol=0, atol=1e-12)
    if spec["cap"] is not None:
        assert got.iterations.tolist()[0] == spec["cap"][0]  # capped, not converged
    with pytest.raises(ValueError, match="requires lam0 and s0"):
        ipm.solve_qp_nl(stack(0), stack(1), stack(2), stack(3), c_nl, cpu(z0),
                        warm_if=torch.ones(3, dtype=torch.bool))


# ---- the CBF problem's parts ------------------------------------------------


def forecast(t):
    s_coef, ey_coef = scenario()[:2]
    ts = t + 0.1 * np.arange(N + 1)
    s = np.stack([np.polyval(c, ts) for c in s_coef])
    ey = np.stack([np.polyval(c, ts) for c in ey_coef])
    vs = np.stack([np.polyval(np.polyder(c), ts) for c in s_coef])
    vey = np.stack([np.polyval(np.polyder(c), ts) for c in ey_coef])
    zeros = np.zeros_like(s)
    return np.stack([vs, vey, zeros, zeros, s, ey], axis=2)  # (N_OBS, N+1, 6)


class _Captured(Exception):
    pass


def capture_problem(monkeypatch, module, fn, *args, **kwargs):
    """The arguments ``fn`` hands to ``module.solve_qp_nl``."""
    seen = {}

    def grab(*a, **kw):
        seen.update(args=a, kwargs=kw)
        raise _Captured

    monkeypatch.setattr(module, "solve_qp_nl", grab)
    with pytest.raises(_Captured):
        fn(*args, **kwargs)
    monkeypatch.undo()
    return seen["args"], seen["kwargs"]


def cbf_args(row, jax_side):
    """``_cbf_nlp``'s arguments at the golden's row ``row`` (t = row * 0.1)."""
    x = golden()[row]
    obs = forecast(0.1 * row)
    _, _, act, halfs, agent = scenario()
    L = float(jtrack.load_track("l_shape", width=1.0).lap_length)
    mask = np.asarray(jctrl.obstacle_gate_mask(jnp.asarray(x), jnp.asarray(obs[:, 0, 4]), L)) & act
    if jax_side:
        p, sp = jparams.MPCCBFParam.default(vt=0.8), jparams.SystemParam.default()
        a = jnp.asarray
        return (a(x), jnp.broadcast_to(a(XT), (N, 6)), p.A, p.B, p.Q, p.R, N, sp, a(1.0),
                a(obs), a(mask), a(agent), a(halfs), a(L), p.alpha, 0.2)
    p, sp = params.MPCCBFParam.default(vt=0.8, **KW), params.SystemParam.default(**KW)
    return (cpu(x)[None], cpu(XT)[None, None].expand(1, N, 6), p.A, p.B, p.Q, p.R, N, sp,
            cpu(1.0), cpu(obs)[None], torch.as_tensor(mask)[None], cpu(agent), cpu(halfs),
            cpu(L), p.alpha, 0.2)


@pytest.mark.parametrize("row", [0, 40, 91, 95])
def test_cbf_rows_and_jacobian_match_jax(row, monkeypatch):
    """The QP data within 1e-14 of each array's scale, and ``c_nl``'s values
    and Jacobian within 1e-14 relative to theirs, element by element, at
    the cold start and at perturbed iterates (rows 91 and 95 lie next to
    the first obstacle, where the degree-6 powers are sharpest)."""
    jargs, _ = capture_problem(monkeypatch, jctrl.ipm, jctrl._cbf_nlp, *cbf_args(row, True),
                               None, iters=40)
    targs, _ = capture_problem(monkeypatch, controllers.ipm, controllers._cbf_nlp,
                               *cbf_args(row, False), None, iters=40)
    for name, j, t in zip("HgCd", jargs[:4], targs[:4]):
        j, t = np.asarray(j), t[0].numpy()
        np.testing.assert_allclose(t, j, rtol=1e-14, atol=1e-14 * np.abs(j).max(), err_msg=name)
    j_c, t_c = jargs[4], targs[4]
    rng = np.random.default_rng(row)
    z0 = np.asarray(jargs[5])
    for z in [z0] + [z0 + np.r_[0.2 * rng.standard_normal(20), rng.random(44)] for _ in range(3)]:
        jv, jJ = map(np.asarray, j_c(jnp.asarray(z)))
        tv, tJ = (a[0].numpy() for a in t_c(cpu(z)[None]))
        np.testing.assert_allclose(tv, jv, rtol=1e-14, atol=1e-14 * np.abs(jv).max())
        np.testing.assert_allclose(tJ, jJ, rtol=1e-14, atol=1e-14 * np.abs(jJ).max())


def test_obstacle_gate_mask_matches_jax():
    """Exact, with s before the start line, past the lap and at the window's edges."""
    rng = np.random.default_rng(4)
    L = 19.2
    x = np.zeros((64, 6))
    x[:, 0] = rng.uniform(0, 1.5, 64)
    x[:, 4] = rng.uniform(-L, 2 * L, 64)
    obs_s = rng.uniform(-L, 2 * L, (64, N_OBS))
    obs_s[:4, 0] = np.mod(x[:4, 4], L) + 2.0 * x[:4, 0]  # on the edge
    got = controllers.obstacle_gate_mask(cpu(x), cpu(obs_s), cpu(L)).numpy()
    want = np.stack([np.asarray(jctrl.obstacle_gate_mask(jnp.asarray(xi), jnp.asarray(oi), L))
                     for xi, oi in zip(x, obs_s)])
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


def test_shift_cbf_warm_matches_jax():
    """Exact, over the row layout of ``_cbf_nlp``."""
    rng = np.random.default_rng(5)
    n_z, m = N * 2 + N_OBS * (N + 1), 4 * N + 4 * N + N_OBS * (N + 1) + N_OBS * N
    z, lam, s = rng.standard_normal((3, n_z)), rng.random((3, m)), rng.random((3, m))
    got = controllers.shift_cbf_warm(
        ipm.IPMSolution(cpu(z), cpu(lam), cpu(np.zeros((3, 0))), cpu(s), None, None, None),
        N, N_OBS)
    for b in range(3):
        sol = jipm.IPMSolution(jnp.asarray(z[b]), jnp.asarray(lam[b]), jnp.zeros(0),
                               jnp.asarray(s[b]), jnp.asarray(True), jnp.asarray(0.0),
                               jnp.asarray(0))
        for g, w in zip(got, jctrl.shift_cbf_warm(sol, N, N_OBS)):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


# ---- the controller and the closed loop ---------------------------------------


def mpccbf_call(row, warm, iters, jax_side):
    args = cbf_args(row, jax_side)
    x, xt, _, _, _, _, _, sp, width, obs, mask, agent, halfs, L = args[:14]
    if jax_side:
        return jctrl.mpccbf(x, jnp.asarray(XT), jparams.MPCCBFParam.default(vt=0.8), sp, width,
                            obs, mask, agent, halfs, L, warm=warm, return_traj=True, iters=iters)
    return controllers.mpccbf(x, cpu(XT), params.MPCCBFParam.default(vt=0.8, **KW), sp, width,
                              obs, mask, agent, halfs, L, warm=warm, return_traj=True,
                              iters=iters)


@pytest.mark.parametrize("row", [0, 10, 43, 60, 92, 150])
def test_mpccbf_step_matches_jax_at_injected_states(row, monkeypatch):
    """The controller at golden states: row 0 cold (40 iterations), the
    others warm (20 iterations) from the JAX solve of the row before,
    shifted.  A solve under the cap: the same flag and count and U within
    1e-9; a capped one: the same flag and the objective within 1e-3."""
    warm = None
    iters = 40
    if row:
        _, _, _, prev = mpccbf_call(row - 1, None, 40, True)
        warm = [np.asarray(a) for a in jctrl.shift_cbf_warm(prev, N, N_OBS)]
        iters = 20
    _, U, _, sol = mpccbf_call(row, None if warm is None else tuple(map(jnp.asarray, warm)),
                               iters, True)
    seen = {}
    solve = ipm.solve_qp_nl

    def keep(*a, **kw):
        seen["H"], seen["g"] = a[0], a[1]
        return solve(*a, **kw)

    monkeypatch.setattr(controllers.ipm, "solve_qp_nl", keep)
    _, tU, tX, tsol = mpccbf_call(row, None if warm is None else tuple(cpu(a)[None] for a in warm),
                                  iters, False)
    assert tU.shape == (1, N, 2) and tX.shape == (1, N + 1, 6)
    assert bool(tsol.converged[0]) == bool(sol.converged)
    if int(sol.iterations) < iters:
        assert int(tsol.iterations[0]) == int(sol.iterations)
        np.testing.assert_allclose(tU[0].numpy(), np.asarray(U), rtol=0, atol=1e-9)
    else:
        assert int(tsol.iterations[0]) == iters
        H, g = seen["H"][0], seen["g"][0]
        obj = lambda z: float(0.5 * z @ H @ z + g @ z)
        assert obj(tsol.z[0]) == pytest.approx(obj(cpu(np.asarray(sol.z))), rel=1e-3)


def test_cbf_warm_select_matches_jax(monkeypatch):
    """``_cbf_nlp``'s run-time cold/warm choice (the racing game's tracker
    protocol): three golden states in one batch, two warm from the JAX
    solve of the row before (capped at ``iters_warm`` = 20; row 61's solve
    reaches the cap), one cold (40), each against JAX's ``_cbf_nlp`` with the
    same choice: the same flag and count, U within 1e-9 under the cap, the
    objective within 1e-3 at it."""
    rows, use_warm = (11, 43, 61), np.array([True, False, True])
    triples = []
    for row in rows:
        _, _, _, prev = mpccbf_call(row - 1, None, 40, True)
        triples.append([np.asarray(a) for a in jctrl.shift_cbf_warm(prev, N, N_OBS)])
    want = []
    for row, w, trip in zip(rows, use_warm, triples):
        U, _, sol = jctrl._cbf_nlp(*cbf_args(row, True), None, iters=40, iters_warm=20,
                                   warm_select=(jnp.asarray(w), tuple(map(jnp.asarray, trip))))
        want.append((np.asarray(U), sol))
    t_args = [cbf_args(row, False) for row in rows]
    args = list(t_args[0])
    for i in (0, 1, 9, 10):  # the states, targets, obstacles and masks per lane
        args[i] = torch.cat([a[i] for a in t_args])
    triple = tuple(cpu(np.stack([t[i] for t in triples])) for i in range(3))
    seen = {}
    solve = ipm.solve_qp_nl

    def keep(*a, **kw):
        seen["H"], seen["g"] = a[0], a[1]
        return solve(*a, **kw)

    monkeypatch.setattr(controllers.ipm, "solve_qp_nl", keep)
    U, X, sol = controllers._cbf_nlp(*args, None, iters=40, iters_warm=20,
                                     warm_select=(torch.as_tensor(use_warm), triple))
    assert U.shape == (3, N, 2) and X.shape == (3, N + 1, 6)
    assert [int(sol.iterations[b]) for b in range(3)] == [11, 16, 20]
    for b, (jU, jsol) in enumerate(want):
        assert bool(sol.converged[b]) == bool(jsol.converged)
        assert int(sol.iterations[b]) == int(jsol.iterations)
        if int(jsol.iterations) < (20 if use_warm[b] else 40):
            np.testing.assert_allclose(U[b].numpy(), jU, rtol=0, atol=1e-9)
        else:
            H, g = seen["H"][b], seen["g"][b]
            obj = lambda z: float(0.5 * z @ H @ z + g @ z)
            assert obj(sol.z[b]) == pytest.approx(obj(cpu(np.asarray(jsol.z))), rel=1e-3)
    with pytest.raises(ValueError, match="not both"):
        controllers._cbf_nlp(*args, triple, iters=40,
                             warm_select=(torch.as_tensor(use_warm), triple))


def _rollout(n_steps, dtype, xcurv0=np.zeros(6), **kw):
    kwt = dict(device="cpu", dtype=dtype)
    s_coef, ey_coef, act, halfs, agent = scenario()
    t = lambda a: torch.as_tensor(np.array(a), **kwt)
    return fused.rollout_mpccbf(
        track.load_track("l_shape", width=1.0, **kwt), dynamics.BicycleParams.default(**kwt),
        params.MPCCBFParam.default(vt=0.8, **kwt), params.SystemParam.default(**kwt), t(XT),
        t(xcurv0), t(np.zeros(6)), t(s_coef), t(ey_coef), torch.as_tensor(act), t(halfs),
        t(agent), n_steps=n_steps, **kw)


def test_rollout_mpccbf_matches_golden():
    """The golden at 1e-2 (the reference's own nudged runs stay within 9e-4
    of it); each warm solve's Newton iterations equal the JAX run's recorded
    ones over the rows every nudged JAX run keeps within 1e-6 of the golden."""
    rec = record()
    solves = []
    xc, us, kkt, its = _rollout(200, F64, solves=solves)
    g = golden()
    assert xc.shape == g.shape and us.shape == (200, 2)
    assert kkt.shape == its.shape == (199,) and its.dtype == torch.int32
    assert len(solves) == 200 and int(solves[0].iterations[0]) == rec["cold_iterations"]
    np.testing.assert_allclose(xc.numpy(), g, rtol=0, atol=rec["golden_atol"])
    held = rec["nudged_target_vx"]["first_row_off_range"][0]
    assert its[:held - 1].tolist() == rec["warm_iterations"][:held - 1]
    np.testing.assert_allclose(xc[:held].numpy(), g[:held], rtol=0, atol=rec["off_atol"])
    assert bool(torch.equal(kkt, torch.stack([s.kkt_res[0] for s in solves[1:]])))


def test_rollout_mpccbf_f32_behaviour():
    """A float32 closed loop from the JAX bench's first start state over the
    bench's 100 steps, held by the gates of tests/test_fused.py:83-96:
    finite, on the track, no collision with the prescribed cars, real
    iteration counts, inputs within their bounds.  Its median KKT residual
    is not gated: in float32 over half the warm solves stop at the cap (JAX
    float32 from this start: 41 of 99, median 8.4e-4; over 120 steps 61 of
    119, median 3.8), so every solve that stopped under its cap is held to
    the converged band instead."""
    x0 = np.array([0.3, 0, 0, 0, 0, 0]) + 0.02 * np.random.default_rng(1).standard_normal((20, 6))[0]
    xc, us, kkt, its = _rollout(100, torch.float32, x0.astype(np.float32))
    assert xc.dtype == torch.float32
    xc, us, kkt, its = xc.numpy(), us.numpy(), kkt.numpy(), its.numpy()
    assert np.isfinite(xc).all() and np.isfinite(us).all()
    assert np.abs(xc[:, 5]).max() < 1.0
    L = float(jtrack.load_track("l_shape", width=1.0).lap_length)
    s_coef, ey_coef = scenario()[:2]
    t = np.arange(len(xc)) * 0.1
    for cs, ce in zip(s_coef[:2], ey_coef[:2]):
        ds = np.abs(np.mod(xc[:, 4] - np.polyval(cs, t) + L / 2, L) - L / 2)
        dey = np.abs(xc[:, 5] - np.polyval(ce, t))
        assert not ((ds < 0.85 * 0.4) & (dey < 0.85 * 0.2)).any()
    assert its.min() >= 0 and its.max() <= 20 and len(np.unique(its)) > 1
    assert (kkt[its < 20] < 1e-3).all() and (its < 20).sum() >= 30
    assert np.abs(us[:, 0]).max() <= 0.5 + 1e-6
    assert np.abs(us[:, 1]).max() <= 1.0 + 1e-6
