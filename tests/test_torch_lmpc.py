"""The port's LMPC path against the JAX package, at float64 on the CPU:
the learning ops, the TV condensation and input-rate cost, the LMPC
controller per step, and the l_shape learning lap against its golden.

The same numpy inputs (the committed seed laps and goldens, or arrays made
from a seed) go through both packages.  The lap is held to its golden as
far as the JAX lap itself holds it when its initial vx is nudged by a few
ulps (``data/goldens/lmpc_lap_spread.json``, written by
``python -m tools.lmpc_lap_spread``); beyond that, per-step parity at
states injected from the golden carries the comparison.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from car_racing_tpu.models import controllers as jctrl
from car_racing_tpu.ops import lmpc_learning as jlearn
from car_racing_tpu.ops import ocp as jocp
from car_racing_tpu.ops import track as jtrack
from car_racing_tpu.utils import params as jparams
from car_racing_tpu_torch.models import controllers
from car_racing_tpu_torch.ops import dynamics, lmpc_learning, ocp, track
from car_racing_tpu_torch.racing import fused
from car_racing_tpu_torch.utils import convert, fixtures, params

F64 = torch.float64
KW = dict(device="cpu", dtype=F64)
N, K_PER = 12, 22


def cpu(a):
    return torch.as_tensor(np.array(a), device="cpu")


def np_seed(layout="l_shape"):
    with np.load(fixtures.seed_path(layout)) as f:
        return {k: f[k] for k in f.files}


def golden(layout):
    return np.loadtxt(f"data/goldens/lmpc_lap_{layout}.csv", delimiter=",")


def test_lmpc_param_and_seed_loader():
    jp = jparams.LMPCParam.default()
    tp = params.LMPCParam.default(**KW)
    moved = convert.to_port(params.LMPCParam, convert.numpy_fields(jp), **KW)
    for name, v in convert.numpy_fields(jp).items():
        for p in (tp, moved):
            got = getattr(p, name)
            if isinstance(v, int):
                assert got == v and isinstance(got, int), name
            else:
                np.testing.assert_array_equal(got.numpy(), v, err_msg=name)
    sd, raw = fixtures.load_lmpc_seed("m_shape", **KW), np_seed("m_shape")
    assert sorted(sd) == sorted(raw)
    for k, v in raw.items():
        if v.dtype == np.bool_:
            assert sd[k].dtype == torch.bool
        if np.issubdtype(v.dtype, np.integer):
            assert sd[k] == int(v)
        else:
            np.testing.assert_array_equal(np.asarray(sd[k]), v, err_msg=k)


@pytest.mark.parametrize("layout", fixtures.LAYOUTS)
def test_compute_cost_matches(layout):
    g = golden(layout)
    L = float(jtrack.load_track(layout, width=1.0).lap_length)
    for lap in (L, 0.5 * L, g[-1, 4] + 1.0):
        want = np.asarray(jlearn.compute_cost(jnp.asarray(g), lap))
        np.testing.assert_array_equal(lmpc_learning.compute_cost(cpu(g), lap).numpy(), want)


@pytest.mark.parametrize("shift", [0, 3])
def test_select_points_matches(shift):
    sd, g = np_seed(), golden("l_shape")
    ss, q = sd["ss1"], sd["q1"]
    # states along the lap, one past the lap end (the window clips at the
    # array's end) and one equidistant from two safe-set rows (a tie)
    xs = np.concatenate([g[::20], [ss[-1] + 0.01, 0.5 * (ss[10] + ss[11])]])
    pts, qs = lmpc_learning.select_points(cpu(ss), cpu(q), cpu(xs), K_PER, shift)
    for b, x in enumerate(xs):
        jp, jq = jlearn.select_points(jnp.asarray(ss), jnp.asarray(q), jnp.asarray(x), K_PER, shift)
        np.testing.assert_array_equal(pts[b].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(qs[b].numpy(), np.asarray(jq))


def test_kernel_weights_ties_at_the_cut_keep_lower_index():
    """Rows with equal norms straddle the max_pts cut: the selection keeps
    the lower indices, as lax.top_k does; masked rows (norm inf) and
    sentinel rows (1e4) get weight 0."""
    rng = np.random.default_rng(7)
    P, max_pts = 90, 40
    data = 0.3 * rng.standard_normal((P, 5))
    data[30:80] = data[30]  # 48 valid tied rows; the cut falls inside them
    data[82:] = lmpc_learning.SENTINEL
    valid = np.ones(P, bool)
    valid[[5, 31, 44]] = False
    x = data[30] + np.array([0.3, 0.2, -0.1, 0.05, 0.0])
    jidx, jw = jlearn._kernel_weights(jnp.asarray(data), jnp.asarray(valid), jnp.asarray(x),
                                      max_pts)
    idx, w = lmpc_learning._kernel_weights(cpu(data), cpu(valid), cpu(x), max_pts)
    jidx = np.asarray(jidx)
    assert 0 < len(set(jidx.tolist()) & set(range(30, 80))) < 48  # the cut is inside the tie
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-15)
    # every stage of a horizon batch selects as the single call does
    xs = np.stack([x, data[3], data[75]])
    idx_b, w_b = lmpc_learning._kernel_weights(cpu(data), cpu(valid), cpu(xs), max_pts)
    for b in range(3):
        jb = jlearn._kernel_weights(jnp.asarray(data), jnp.asarray(valid), jnp.asarray(xs[b]),
                                    max_pts)
        np.testing.assert_array_equal(idx_b[b].numpy(), np.asarray(jb[0]))
        np.testing.assert_allclose(w_b[b].numpy(), np.asarray(jb[1]), rtol=0, atol=1e-15)


def test_weighted_fit_matches():
    rng = np.random.default_rng(8)
    Z = rng.standard_normal((6, 40, 4))
    w = rng.uniform(0.0, 0.75, (6, 40))
    y = rng.standard_normal((6, 40))
    want = np.stack([np.asarray(jlearn._weighted_fit(jnp.asarray(Z[b]), jnp.asarray(w[b]),
                                                     jnp.asarray(y[b]))) for b in range(6)])
    got = lmpc_learning._weighted_fit(cpu(Z), cpu(w), cpu(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_kinematic_rows_match():
    rng = np.random.default_rng(9)
    xs = np.array([0.9, 0.02, 0.1, 0.05, 3.0, 0.2]) + 0.2 * rng.standard_normal((8, 6))
    curv = rng.uniform(-1.0, 1.0, 8)
    A, C = lmpc_learning._kinematic_rows(cpu(curv), cpu(xs), 0.1)
    for b in range(8):
        jA, jC = jlearn._kinematic_rows(jnp.asarray(curv[b]), jnp.asarray(xs[b]), 0.1)
        np.testing.assert_allclose(A[b].numpy(), np.asarray(jA), rtol=0, atol=1e-14)
        np.testing.assert_allclose(C[b].numpy(), np.asarray(jC), rtol=0, atol=1e-14)


def _lap_data(sd):
    return (np.stack([sd["ss2"], sd["ss1"]]), np.stack([sd["u2"], sd["u1"]]),
            np.stack([sd["valid2"], sd["valid1"]]))


@pytest.mark.parametrize("layout,start", [("l_shape", None), ("l_shape", 100), ("goggle", 40)])
def test_estimate_abc_horizon_matches(layout, start):
    """Rows 3..5 (the kinematic Jacobian) at 1e-12; rows 0..2, the local
    regression, by the model they give: A x + B u + C at each stage's
    selected data rows and linearization point at 1e-9.  The coefficients
    themselves are not compared: the Gram matrix of nearly equal
    neighbours is singular but for its relative 1e-10 ridge, so its
    solution moves with the summation order of the Gram sums, and two
    LAPACKs' solves of the same matrix already differ."""
    sd = np_seed(layout)
    ss, ud, va = _lap_data(sd)
    jt = jtrack.load_track(layout, width=1.0)
    L = float(jt.lap_length)
    if start is None:
        lp, li = sd["lin_points0"][:N], sd["lin_input0"]
    else:
        lp, li = golden(layout)[start:start + N], np.tile(sd["lin_input0"][:1], (N, 1))
    curvs = np.asarray(jtrack.curvature_batch(jt, jnp.asarray(np.mod(lp[:, 4], L))))
    jA, jB, jC = map(np.asarray, jlearn.estimate_abc_horizon(
        jnp.asarray(lp), jnp.asarray(li), jnp.asarray(ss), jnp.asarray(ud), jnp.asarray(va),
        jnp.asarray(curvs), jnp.asarray(0.1)))
    A, B, C = (t.numpy() for t in lmpc_learning.estimate_abc_horizon(
        cpu(lp), cpu(li), cpu(ss), cpu(ud), cpu(va), cpu(curvs), torch.tensor(0.1, dtype=F64)))
    np.testing.assert_allclose(A[:, 3:], jA[:, 3:], rtol=0, atol=1e-12)
    np.testing.assert_allclose(C[:, 3:], jC[:, 3:], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(B[:, 3:], 0.0)

    fs, fu = ss.reshape(-1, 6), ud.reshape(-1, 2)
    x_lin = np.concatenate([lp[:, :3], li], axis=1)
    data_zu = np.concatenate([fs[:, :3], fu], axis=1)
    idx = np.asarray(jax.vmap(lambda x: jlearn._kernel_weights(
        jnp.asarray(data_zu), jnp.asarray(va.reshape(-1)), x, 40)[0])(jnp.asarray(x_lin)))
    rows_x = np.concatenate([fs[idx], lp[:, None]], axis=1)  # (N, 41, 6)
    rows_u = np.concatenate([fu[idx], li[:, None]], axis=1)
    model = lambda A, B, C: (np.einsum("nij,nkj->nki", A[:, :3], rows_x)
                             + np.einsum("nij,nkj->nki", B[:, :3], rows_u) + C[:, None, :3])
    np.testing.assert_allclose(model(A, B, C), model(jA, jB, jC), rtol=0, atol=1e-9)


def test_condense_tv_and_input_rate_cost_match():
    rng = np.random.default_rng(10)
    A = np.eye(6) + 0.1 * rng.standard_normal((N, 6, 6))
    B = rng.standard_normal((N, 6, 2))
    Cs = 0.1 * rng.standard_normal((N, 6))
    x0 = rng.standard_normal((3, 6))
    phi, G = ocp.condense(cpu(A), cpu(B), cpu(Cs), cpu(x0))
    assert tuple(phi.shape) == (3, N * 6) and tuple(G.shape) == (N * 6, N * 2)
    for b in range(3):
        jphi, jG = jocp.condense(jnp.asarray(A), jnp.asarray(B), jnp.asarray(Cs),
                                 jnp.asarray(x0[b]))
        np.testing.assert_allclose(phi[b].numpy(), np.asarray(jphi), rtol=0, atol=1e-12)
        np.testing.assert_allclose(G.numpy(), np.asarray(jG), rtol=0, atol=1e-12)
    dR = np.diag([4.0, 0.5])
    u_prev = rng.standard_normal((3, 2))
    H, g = ocp.input_rate_cost(cpu(dR), N, cpu(u_prev))
    for b in range(3):
        jH, jg = jocp.input_rate_cost(jnp.asarray(dR), N, jnp.asarray(u_prev[b]))
        np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=0, atol=1e-14)
        np.testing.assert_allclose(g[b].numpy(), np.asarray(jg), rtol=0, atol=1e-14)


def _injected_step(layout, k):
    """The inputs of the ``layout`` lap's step ``k`` rebuilt from the JAX lap's
    states (the golden): the state, lap iter-1's safe set with the states
    of steps 0..k-1 appended as the lap appends them, the linearization
    along the golden's next N + 1 states and the JAX regression there.
    Returns numpy arrays shared by both packages."""
    sd, g = np_seed(layout), golden(layout)
    jt = jtrack.load_track(layout, width=1.0)
    L = float(jt.lap_length)
    wrap = lambda x: np.concatenate([x[..., :4], np.mod(x[..., 4:5], L), x[..., 5:]], axis=-1)
    ss1 = sd["ss1"].copy()
    for j in range(k):
        ss1[min(int(sd["counter"]) + j + 1, len(ss1) - 1)] = wrap(g[j]) + [0, 0, 0, 0, L, 0]
    x = wrap(g[k])
    lp = g[k:k + N + 1]
    lp = np.concatenate([lp, np.repeat(lp[-1:], N + 1 - len(lp), axis=0)])
    li = np.tile(sd["lin_input0"][:1], (N, 1))
    ss, ud, va = _lap_data(sd)
    ss[1] = ss1
    curvs = jtrack.curvature_batch(jt, jnp.asarray(np.mod(lp[:N, 4], L)))
    abc = [np.asarray(a) for a in jlearn.estimate_abc_horizon(
        jnp.asarray(lp[:N]), jnp.asarray(li), jnp.asarray(ss), jnp.asarray(ud), jnp.asarray(va),
        curvs, jnp.asarray(0.1))]
    p1, q1 = jlearn.select_points(jnp.asarray(ss1), jnp.asarray(sd["q1"]), jnp.asarray(x), K_PER)
    p2, q2 = jlearn.select_points(jnp.asarray(sd["ss2"]), jnp.asarray(sd["q2"]), jnp.asarray(x),
                                  K_PER)
    pts = np.concatenate([np.asarray(p1), np.asarray(p2)], axis=1)
    qs = np.concatenate([np.asarray(q1), np.asarray(q2)])
    return x, abc, pts, qs, sd["lin_input0"][0], L


def _f32_step_matches_jax(x, A, B, C, pts, qs, u_prev, L):
    """The LMPC step in float32 in both packages, from the same inputs cast
    to float32 (JAX with x64 off, as the package runs in f32).

    Held: the same converged flag and iteration count (in f32 every one of
    these solves runs the 40 iterations), and U and X within 1e-2.  The
    tolerance is the f32 solve's own sensitivity, not a port allowance: at
    the end of 40 iterations the KKT matrix is ill-conditioned, and JAX's
    f32 step differs from its f64 step by 2e-3 to 7e-2 in U and 2e-3 to
    0.2 in X at these states, while the two packages' f32 steps differ by
    at most 3.3e-3 in U and 4.0e-3 in X."""
    with jax.enable_x64(False):
        f = lambda a: jnp.asarray(a, jnp.float32)
        cast = lambda tree: jax.tree.map(f, tree)
        jU, jX, jsol = jctrl.lmpc(f(x), cast(jparams.LMPCParam.default()),
                                  *map(f, (A, B, C, pts, qs, u_prev)),
                                  cast(jparams.SystemParam.default()), f(L), f(1.0), num_horizon=N)
        jU, jX = np.asarray(jU), np.asarray(jX)
        jconv, jits = bool(jsol.converged), int(jsol.iterations)
    kw = dict(device="cpu", dtype=torch.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    U, X, sol = controllers.lmpc(t(x)[None], params.LMPCParam.default(**kw), t(A), t(B), t(C),
                                 t(pts)[None], t(qs)[None], t(u_prev)[None],
                                 params.SystemParam.default(**kw), torch.tensor(1.0, **kw))
    assert U.dtype == torch.float32 and jU.dtype == np.float32
    assert jconv and bool(sol.converged[0])
    assert int(sol.iterations[0]) == jits
    np.testing.assert_allclose(U[0].numpy(), jU, rtol=0, atol=1e-2)
    np.testing.assert_allclose(X[0].numpy(), jX, rtol=0, atol=1e-2)


# the steps at which each lap's first solve stops at the iteration cap
# (l_shape 14, goggle 29, m_shape 22, ellipse 0; with the injected inputs
# only l_shape's stops there too), and l_shape steps before and after it;
# in f32 the same steps but l_shape's 14, whose f32 solve does not converge
@pytest.mark.parametrize("layout,k,dtype", [
    pytest.param(lo, k, "f64", id=f"{lo}-{k}")
    for lo, k in (("l_shape", 0), ("l_shape", 14), ("l_shape", 120), ("goggle", 29),
                  ("m_shape", 22), ("ellipse", 0), ("ellipse", 1))
] + [
    pytest.param(lo, k, "f32", id=f"{lo}-{k}-f32")
    for lo, k in (("l_shape", 0), ("l_shape", 120), ("goggle", 29), ("m_shape", 22),
                  ("ellipse", 0), ("ellipse", 1))
])
def test_lmpc_step_matches_jax_at_injected_states(layout, k, dtype):
    x, (A, B, C), pts, qs, u_prev, L = _injected_step(layout, k)
    if dtype == "f32":
        _f32_step_matches_jax(x, A, B, C, pts, qs, u_prev, L)
        return
    jp, js = jparams.LMPCParam.default(), jparams.SystemParam.default()
    jU, jX, jsol = jctrl.lmpc(jnp.asarray(x), jp, *map(jnp.asarray, (A, B, C, pts, qs, u_prev)),
                              js, L, 1.0, num_horizon=N)
    tp, ts = params.LMPCParam.default(**KW), params.SystemParam.default(**KW)
    U, X, sol = controllers.lmpc(cpu(x)[None], tp, cpu(A), cpu(B), cpu(C), cpu(pts)[None],
                                 cpu(qs)[None], cpu(u_prev)[None], ts, torch.tensor(1.0, dtype=F64))
    assert bool(sol.converged[0]) == bool(jsol.converged)
    assert tuple(U.shape) == (1, N, 2) and tuple(X.shape) == (1, N + 1, 6)
    if bool(jsol.converged):
        np.testing.assert_allclose(sol.z[0].numpy(), np.asarray(jsol.z), rtol=0, atol=1e-8)
        np.testing.assert_allclose(U[0].numpy(), np.asarray(jU), rtol=0, atol=1e-8)
        np.testing.assert_allclose(X[0].numpy(), np.asarray(jX), rtol=0, atol=1e-8)
        assert int(sol.iterations[0]) == int(jsol.iterations)
    else:  # stopped at the cap: the objective, as in test_torch_equality.py
        assert int(sol.iterations[0]) == int(jsol.iterations) == 40
        qp, _, _, _ = controllers.lmpc_qp(cpu(x)[None], tp, cpu(A), cpu(B), cpu(C),
                                          cpu(pts)[None], cpu(qs)[None], cpu(u_prev)[None], ts,
                                          torch.tensor(1.0, dtype=F64))
        obj = lambda z: float(0.5 * z @ qp.H[0] @ z + qp.g[0] @ z)
        np.testing.assert_allclose(obj(sol.z[0]), obj(cpu(jsol.z)), rtol=1e-3)


def _lap_start(layout):
    """Step 0 of the ``layout`` lap as the lap runs it: the seed's state,
    ``lin_points0``, ``lin_input0``, u_prev = 0 and the default warm start."""
    sd = np_seed(layout)
    jt = jtrack.load_track(layout, width=1.0)
    L = float(jt.lap_length)
    x = sd["xcurv0"].copy()
    x[4] = np.mod(x[4], L)
    lp, li = sd["lin_points0"][:N], sd["lin_input0"][:N]
    ss, ud, va = _lap_data(sd)
    abc = [np.asarray(a) for a in jlearn.estimate_abc_horizon(
        jnp.asarray(lp), jnp.asarray(li), jnp.asarray(ss), jnp.asarray(ud), jnp.asarray(va),
        jtrack.curvature_batch(jt, jnp.asarray(np.mod(lp[:, 4], L))), jnp.asarray(0.1))]
    sel = [jlearn.select_points(jnp.asarray(sd[s]), jnp.asarray(sd[q]), jnp.asarray(x), K_PER)
           for s, q in (("ss1", "q1"), ("ss2", "q2"))]
    pts = np.concatenate([np.asarray(p) for p, _ in sel], axis=1)
    qs = np.concatenate([np.asarray(q) for _, q in sel])
    return x, abc, pts, qs, np.zeros(2), L


@pytest.mark.parametrize("layout", fixtures.LAYOUTS)  # the ellipse's stops at the cap
def test_lmpc_lap_first_step_matches_jax(layout):
    """The lap's first LMPC solve, with the lap's own inputs, in both
    packages.  On the ellipse it is the lap's first solve that stops at the
    iteration cap, so the lap's golden (held from row 0) says nothing
    about it; this holds it by flag, iteration count and objective."""
    x, (A, B, C), pts, qs, u_prev, L = _lap_start(layout)
    jp, js = jparams.LMPCParam.default(), jparams.SystemParam.default()
    jU, _, jsol = jctrl.lmpc(jnp.asarray(x), jp, *map(jnp.asarray, (A, B, C, pts, qs, u_prev)),
                             js, L, 1.0, num_horizon=N)
    tp, ts = params.LMPCParam.default(**KW), params.SystemParam.default(**KW)
    args = (cpu(x)[None], tp, cpu(A), cpu(B), cpu(C), cpu(pts)[None], cpu(qs)[None],
            cpu(u_prev)[None], ts, torch.tensor(1.0, dtype=F64))
    U, _, sol = controllers.lmpc(*args)
    assert bool(sol.converged[0]) == bool(jsol.converged)
    assert int(sol.iterations[0]) == int(jsol.iterations)
    assert (layout == "ellipse") == (int(jsol.iterations) == 40)
    if bool(jsol.converged):
        np.testing.assert_allclose(sol.z[0].numpy(), np.asarray(jsol.z), rtol=0, atol=1e-8)
        np.testing.assert_allclose(U[0].numpy(), np.asarray(jU), rtol=0, atol=1e-8)
    else:
        qp = controllers.lmpc_qp(*args)[0]
        obj = lambda z: float(0.5 * z @ qp.H[0] @ z + qp.g[0] @ z)
        np.testing.assert_allclose(obj(sol.z[0]), obj(cpu(jsol.z)), rtol=1e-3)


def lmpc_lap(layout, n_steps, **kw):
    """The port's LMPC lap from the layout's seed, with every LMPC solve."""
    solves = []
    sd = fixtures.load_lmpc_seed(layout, **kw)
    out = fused.rollout_lmpc_lap(
        track.load_track(layout, width=1.0, **kw), dynamics.BicycleParams.default(**kw),
        params.LMPCParam.default(**kw), params.SystemParam.default(**kw),
        sd["xcurv0"], sd["xglob0"], sd["ss1"], sd["q1"], sd["ss2"], sd["q2"], sd["u1"],
        sd["u2"], sd["valid1"], sd["valid2"], sd["counter"], sd["lin_points0"],
        sd["lin_input0"], n_steps=n_steps, solves=solves)
    return out, [(bool(s.converged[0]), int(s.iterations[0])) for s in solves], sd


def test_lmpc_lap_l_shape_against_golden():
    """The port's l_shape lap against the JAX package's golden.

    Past the first solve that stops unconverged at the iteration cap the
    golden is reproduced only by the JAX package's own arithmetic: its lap
    with vx nudged by 1 to 6 ulps leaves the golden by more than 1e-2 from
    row 17 or 18 on and ends after 164 to 230 steps against the golden's
    179 (``data/goldens/lmpc_lap_spread.json``).  The port's lap is held to
    the same: on the golden at 1e-2 up to the earliest row a nudged JAX
    lap leaves it, its lap steps no further from the golden's than the
    furthest nudged JAX lap's, and the lap's own guarantees: it completes,
    on the track, faster than the lap before it, and its carry freezes
    once done."""
    (xc, us, dones, lap_steps), solves, sd = lmpc_lap("l_shape", 250, **KW)
    g = golden("l_shape")
    with open("data/goldens/lmpc_lap_spread.json") as f:
        spread = json.load(f)["l_shape/jax"]
    assert tuple(xc.shape) == (251, 6) and tuple(us.shape) == (250, 2) and len(solves) == 250
    xc = xc.numpy()
    assert np.isfinite(xc).all() and np.isfinite(us.numpy()).all()
    first_capped = next(k for k, (conv, _) in enumerate(solves) if not conv)
    assert solves[first_capped][1] == 40 and first_capped > 0
    held = min(spread["nudged_first_row_off"])
    assert held > first_capped + 1  # covers the state the first capped solve reaches
    np.testing.assert_allclose(xc[:held], g[:held], rtol=0, atol=spread["atol"])
    dev = max(abs(n - spread["golden_lap_steps"]) for n in spread["nudged_lap_steps"])
    assert abs(lap_steps - (len(g) - 1)) <= dev
    assert 0 < lap_steps < int(sd["counter"])
    L = float(track.load_track("l_shape", width=1.0, **KW).lap_length)
    assert xc[lap_steps - 1, 4] < L <= xc[lap_steps, 4]
    assert np.abs(xc[:, 5]).max() <= 1.0
    assert not dones[:lap_steps].any() and dones[lap_steps:].all()
    assert (xc[lap_steps + 1:] == xc[lap_steps + 1]).all()
