#!/usr/bin/env python3
"""How far the racing-game lap wanders from its goldens, and the reference's
short runs from states of those laps.

    python -m tools.racing_game_spread [--ulps 12] [--port] [--port-ulps 2]
                                       [--out data/goldens/racing_game_spread.json]
                                       [--f32-only | --replay-port | --more-l-shape HI
                                        | --passes HI | --replay-card FILE]

Run from the repository root.  Runs the JAX package's
``rollout_racing_game`` on the CPU:

- ``nudged``: the two goldens' laps (``racing_game_l_shape``, 300 steps;
  ``racing_game_m_shape``, 700 steps; inputs as ``golden_fixtures.py``
  records them) in float64, once as they are and once for each nudge of
  the initial vx by k = -ulps..-1, 1..ulps units in the last place.  Each
  lap is summarised by its lap steps, its overtake steps and the first of
  them, the first rows off the golden by more than 1e-6 and 1e-2, the
  least superellipse barrier ``(ds/0.4)^6 + (dey/0.2)^6`` over the cars
  (ds wrapped into half a lap) and the largest |ey|.
- ``injected``: short runs of three steps from states of those laps, in
  float64.  For step k of a lap: ``xcurv0`` is its row k (s wrapped),
  ``xglob0`` its ``frenet_to_global_state``; the traffic's time origin
  moves to t_k = 0.1 k (``s_coef[:, 1] += s_coef[:, 0] * t_k``, exact for
  the degree-1 schedules used here); ``lin_points0`` is rows k..k+12,
  ``lin_input0`` the run's inputs k..k+11, both padded with their last
  row; the seed's other inputs.  Every overtake step of both goldens, ten
  LMPC-branch steps of each, two steps each with one, two and three cars
  of interest of the three-car traffic of ``tests/test_fused.py:716-729``,
  and two overtake steps of the m_shape lap behind the l_shape traffic
  with ``corridor_hold=1.2`` (``tests/test_fused.py:680-712``).  Each run
  keeps its inputs and the JAX run's ``xcurv`` (4, 6), ``u`` (3, 2) and
  overtake flags.
- ``bench_f32``: the JAX bench's float32 lap (``bench.py:491-517``: 250
  steps from ``xcurv0 + 0.005 N(0, 1) [1, 1, 1, 1, 0, 1]``,
  ``default_rng(5)``) from its first three starts: lap steps, overtake
  steps, largest |ey| and least barrier.
- ``fleet_f32``: the bench's float32 fleet of 8 lanes, 100 steps, ey +
  N(0, 0.01) (``bench.py:527-547``, ``default_rng(6)``): per lane the
  largest |ey|, the least barrier and the overtake steps; and lanes 0 and
  1 run alone for 20 steps, each row's distance from the fleet's lane.

With ``--port`` the PyTorch port's laps run on the CPU from the same nudged
states too, for k = -port_ulps..port_ulps (``nudged_port``).  With
``--f32-only`` only the two float32 records are rerun into the ``--out``
file.  With ``--more-l-shape HI`` the l_shape golden lap runs nudged by
ulps+1..HI ulps either way, and its laps and their spread are added to the
``--out`` file as ``nudged_more``, every other entry as it was (with
``--port``, the port's laps for k = -port_ulps..port_ulps too, on the CPU).
With ``--passes HI`` the l_shape golden lap runs nudged by -HI..HI ulps and
each lap's encounters with the cars are printed as
``tools/racing_game_card_spread.py`` summarises the port's laps on the
card (where its least barrier is reached, how closely it passes each car
side by side), and written to ``--out`` if given; the spread file is not
touched (about 4 minutes for HI = 25).
With ``--replay-card FILE`` (the ``--out`` of
``tools/racing_game_card_spread.py``) the unnudged l_shape lap the port ran
on the GPU is replayed in JAX: short runs from its rows r - d (as the
``injected`` runs start, with vx nudged by -3..3 ulps, and once in the port
on the CPU) up to row r + 5, r the lap's closest row, each run's least
barrier and its least |dey| beside the car it comes closest to.  Whether
the reference, from the states the card reached, passes that car as close
as the card did (about 3 minutes).
With ``--replay-port`` nothing is rerun in JAX: the port replays
every injected run of the ``--out`` file on the CPU in float64 and prints
its distance from the JAX run (rows reached through overtake steps only,
and rows at or after an LMPC step) over the runs in which no solve
stopped at its iteration cap, as ``chip_smoke.py`` holds them on the card
(about 4 minutes).

The JSON it writes (``--out``) is what ``chip_smoke.py`` (phase 14) and
``tests/test_torch_racing_game.py`` read: the nudged spread bounds the
port's golden laps (rows held to 1e-2 before the earliest 1e-2 row of a
nudged lap, lap steps inside the spread, no collision, |ey| below the
largest plus 0.05), the injected runs hold the port per step, and the f32
records bound the card's bench-shaped runs.  Rerun it when the JAX racing
game or its goldens change.  It takes about 5 minutes (the JAX laps take 2
to 5 s each after a compile of 6 to 10 s); ``--port`` adds about a minute
a port lap.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from car_racing_tpu.ops import dynamics as jdyn  # noqa: E402
from car_racing_tpu.ops import track as jtrack  # noqa: E402
from car_racing_tpu.racing import fused as jfused  # noqa: E402
from car_racing_tpu.utils import params as jparams  # noqa: E402

# the goldens' traffic (golden_fixtures.py:111-126, 171-190), sorted by ey desc
L_TRAFFIC = ([[0.72, 7.5], [0.7, 5.5]], [[0.0, -0.2], [0.0, -0.5]])
M_TRAFFIC = ([[0.5, 10.0], [0.48, 6.5]], [[0.0, -0.3], [0.0, -0.55]])
THREE_CARS = ([[0.70, 7.0], [0.72, 6.2], [0.68, 5.4]], [[0.0, 0.15], [0.0, -0.15], [0.0, -0.45]])
SCENARIOS = {
    # name: (layout, traffic, corridor_hold, n_steps)
    "l_shape": ("l_shape", L_TRAFFIC, 0.15, 300),
    "m_shape": ("m_shape", M_TRAFFIC, 0.15, 700),
    "three_cars": ("l_shape", THREE_CARS, 0.15, 300),
    "m_shape_hold": ("m_shape", L_TRAFFIC, 1.2, 700),
}
INJECTED_STEPS = 3
LMPC_STATES = 10
OFF_ATOLS = (1e-6, 1e-2)
BENCH_STEPS, BENCH_STARTS, FLEET_B, FLEET_STEPS, SELF_STEPS = 250, 3, 8, 100, 20


def nudge(x, k):
    """``x`` moved by ``k`` units in the last place of its dtype."""
    x = np.asarray(x).copy()
    for _ in range(abs(k)):
        x = np.nextafter(x, np.inf if k > 0 else -np.inf)
    return x


def cast_tree(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def seed_inputs(layout):
    with np.load(f"data/bench/lmpc_seed_{layout}.npz") as f:
        return {k: f[k] for k in f.files}


def opti(layout):
    return np.genfromtxt(f"data/optimal_traj/xcurv_{layout}.csv", delimiter=",")


def rollout_args(layout, xcurv0, xglob0, s_coef, ey_coef, lin_points0=None, lin_input0=None):
    """The positional arguments of ``rollout_racing_game`` after the
    params, as numpy arrays (``counter`` an int)."""
    sd = seed_inputs(layout)
    return [np.asarray(xcurv0, np.float64), np.asarray(xglob0, np.float64), sd["ss1"], sd["q1"],
            sd["ss2"], sd["q2"], sd["u1"], sd["u2"], sd["valid1"], sd["valid2"],
            int(sd["counter"]), sd["lin_points0"] if lin_points0 is None else lin_points0,
            sd["lin_input0"] if lin_input0 is None else lin_input0,
            np.asarray(s_coef, np.float64), np.asarray(ey_coef, np.float64), opti(layout)]


def run_jax(layout, args, n_steps, hold=0.15, dtype=jnp.float64):
    rg = jparams.RacingGameParam.default(alpha=0.8)
    if hold != 0.15:
        rg = dataclasses.replace(rg, corridor_hold=hold)
    ja = [jnp.asarray(a, jnp.int32) if isinstance(a, int)
          else jnp.asarray(a) if np.asarray(a).dtype == bool else jnp.asarray(a, dtype)
          for a in args]
    xc, us, ot, lap_steps = jfused.rollout_racing_game(
        cast_tree(jtrack.load_track(layout, width=1.0), dtype),
        cast_tree(jdyn.BicycleParams.default(), dtype),
        cast_tree(jparams.LMPCParam.default(), dtype), cast_tree(rg, dtype),
        cast_tree(jparams.SystemParam.default(), dtype), *ja, n_steps=n_steps)
    return np.asarray(xc), np.asarray(us), np.asarray(ot), int(lap_steps)


def lap_length(layout):
    return float(jtrack.load_track(layout, width=1.0).lap_length)


def least_barrier(xc, s_coef, ey_coef, L):
    """The least superellipse barrier over the cars and the rows of ``xc``
    (row k at t = 0.1 k); below 1 the footprints overlap."""
    t = np.arange(len(xc)) * 0.1
    bars = []
    for cs, ce in zip(s_coef, ey_coef):
        ds = np.abs(np.mod(xc[:, 4] - np.polyval(cs, t) + L / 2, L) - L / 2)
        dey = np.abs(xc[:, 5] - np.polyval(ce, t))
        bars.append(((ds / 0.4) ** 6 + (dey / 0.2) ** 6).min())
    return float(min(bars))


def summarise(xc, ot, lap_steps, golden, s_coef, ey_coef, L):
    rows = xc[: lap_steps + 1]
    m = min(len(rows), len(golden))
    err = np.abs(rows[:m] - golden[:m]).max(axis=1)
    out = {"lap_steps": lap_steps, "overtake_steps": int(ot[:lap_steps].sum()),
           "first_overtake": int(np.argmax(ot)) if ot.any() else None,
           "max_abs_err": float(err.max()),
           "least_barrier": least_barrier(rows, s_coef, ey_coef, L),
           "max_abs_ey": float(np.abs(rows[:, 5]).max())}
    for atol, key in zip(OFF_ATOLS, ("first_row_off_1e-6", "first_row_off_1e-2")):
        off = np.nonzero(err > atol)[0]
        out[key] = int(off[0]) if len(off) else None
    return out


def spread_of(laps):
    """Ranges over the nudged laps, for the gates."""
    get = lambda key: [lap[key] for lap in laps]
    off = lambda key: [v for v in get(key) if v is not None]
    return {"lap_steps_range": [min(get("lap_steps")), max(get("lap_steps"))],
            "overtake_steps_range": [min(get("overtake_steps")), max(get("overtake_steps"))],
            "first_row_off_1e-6_min": min(off("first_row_off_1e-6"), default=None),
            "first_row_off_1e-2_min": min(off("first_row_off_1e-2"), default=None),
            "least_barrier_min": min(get("least_barrier")),
            "max_abs_ey_max": max(get("max_abs_ey"))}


def nudged(layout, ulps, port_ulps=0):
    _, (s_coef, ey_coef), _, n_steps = SCENARIOS[layout]
    golden = np.loadtxt(f"data/goldens/racing_game_{layout}.csv", delimiter=",")
    sd = seed_inputs(layout)
    L = lap_length(layout)
    laps, port_laps = [], []
    for k in [0] + [k for k in range(-ulps, ulps + 1) if k]:
        x0 = sd["xcurv0"].copy()
        x0[0] = nudge(x0[0], k)
        args = rollout_args(layout, x0, sd["xglob0"], s_coef, ey_coef)
        xc, us, ot, ls = run_jax(layout, args, n_steps)
        lap = {"k": k, **summarise(xc, ot, ls, golden, s_coef, ey_coef, L)}
        laps.append(lap)
        print(json.dumps({"layout": layout, "package": "jax", **lap}), flush=True)
        if abs(k) <= port_ulps and port_ulps:
            xc, ot, ls = run_port(layout, args, n_steps)
            lap = {"k": k, **summarise(xc, ot, ls, golden, s_coef, ey_coef, L)}
            port_laps.append(lap)
            print(json.dumps({"layout": layout, "package": "port", **lap}), flush=True)
    out = {"golden_lap_steps": len(golden) - 1, "unnudged": laps[0], "laps": laps,
           **spread_of(laps)}
    return out, ({"laps": port_laps, **spread_of(port_laps)} if port_laps else None)


def nudged_more(layout, lo, hi, port_ulps=0):
    """The golden lap of ``layout`` nudged by k = +-lo..+-hi ulps, beyond
    the ``nudged`` record's: its laps and their spread; with ``port_ulps``
    also the port's laps (on the CPU) for k = -port_ulps..port_ulps."""
    _, (s_coef, ey_coef), _, n_steps = SCENARIOS[layout]
    golden = np.loadtxt(f"data/goldens/racing_game_{layout}.csv", delimiter=",")
    sd = seed_inputs(layout)
    L = lap_length(layout)
    laps, port_laps = [], []
    for k in range(-max(hi, port_ulps), max(hi, port_ulps) + 1):
        x0 = sd["xcurv0"].copy()
        x0[0] = nudge(x0[0], k)
        args = rollout_args(layout, x0, sd["xglob0"], s_coef, ey_coef)
        if lo <= abs(k) <= hi:
            xc, us, ot, ls = run_jax(layout, args, n_steps)
            laps.append({"k": k, **summarise(xc, ot, ls, golden, s_coef, ey_coef, L)})
            print(json.dumps({"layout": layout, "package": "jax", **laps[-1]}), flush=True)
        if abs(k) <= port_ulps:
            xc, ot, ls = run_port(layout, args, n_steps)
            port_laps.append({"k": k, **summarise(xc, ot, ls, golden, s_coef, ey_coef, L)})
            print(json.dumps({"layout": layout, "package": "port", **port_laps[-1]}), flush=True)
    out = {"vx_ulps": [lo, hi], "laps": laps, **spread_of(laps)}
    if port_laps:
        out["port"] = {"vx_ulps": port_ulps, "laps": port_laps, **spread_of(port_laps)}
    return out


def passes(hi):
    """The l_shape golden lap nudged by k = -hi..hi ulps in JAX: per lap its
    lap steps, overtake steps and least barrier, where that is reached,
    and how closely the lap passes each car side by side."""
    from tools.racing_game_card_spread import alongside, closest

    layout = "l_shape"
    _, (s_coef, ey_coef), _, n_steps = SCENARIOS[layout]
    sd = seed_inputs(layout)
    L = lap_length(layout)
    laps = []
    for k in range(-hi, hi + 1):
        x0 = sd["xcurv0"].copy()
        x0[0] = nudge(x0[0], k)
        xc, _, ot, ls = run_jax(layout, rollout_args(layout, x0, sd["xglob0"], s_coef, ey_coef),
                                n_steps)
        rows = xc[: ls + 1]
        laps.append({"k": k, "lap_steps": ls, "overtake_steps": int(ot[:ls].sum()),
                     "least_barrier": least_barrier(rows, s_coef, ey_coef, L),
                     "closest": closest(rows, s_coef, ey_coef, L),
                     "alongside": alongside(rows, s_coef, ey_coef, L)})
        print(json.dumps({"layout": layout, "package": "jax", **laps[-1]}), flush=True)
    return {"vx_ulps": hi, "laps": laps}


REPLAY_LEADS, REPLAY_ULPS, REPLAY_AFTER = (1, 2, 4, 7, 10, 15, 20), 3, 5


def replay_card(path):
    """JAX runs from the rows of the card's unnudged l_shape lap before its
    closest row (module docstring)."""
    from tools.racing_game_card_spread import alongside, closest

    layout = "l_shape"
    _, (s_coef, ey_coef), _, _ = SCENARIOS[layout]
    L = lap_length(layout)
    with open(path) as f:
        card = json.load(f)["unnudged"]
    rows, us = np.array(card["xcurv"])[: card["lap_steps"] + 1], np.array(card["u"])
    near = closest(rows, s_coef, ey_coef, L)
    r, car = near["row"], near["car"]
    gap = lambda run_rows, sc: alongside(run_rows, sc, ey_coef, L)[car]["min_dey"]
    out = {"card": {**near, "min_dey_alongside": gap(rows, s_coef)}, "replays": []}
    for d in REPLAY_LEADS:
        k = r - d
        x0, xg0, sc, lp0, li0 = injected_inputs(layout, rows, us, k, s_coef)
        runs = []
        for nudge_k in range(-REPLAY_ULPS, REPLAY_ULPS + 1):
            x = x0.copy()
            x[0] = nudge(x[0], nudge_k)
            xc, _, ot, _ = run_jax(layout, rollout_args(layout, x, xg0, sc, ey_coef, lp0, li0),
                                   d + REPLAY_AFTER)
            runs.append({"k": nudge_k, "least_barrier": least_barrier(xc, sc, ey_coef, L),
                         "min_dey_alongside": gap(xc, sc), "overtake_steps": int(ot.sum())})
        pxc, _, _ = run_port(layout, rollout_args(layout, x0, xg0, sc, ey_coef, lp0, li0),
                             d + REPLAY_AFTER)
        rec = {"from_row": k, "lead": d, "jax": runs,
               "port_cpu": {"least_barrier": least_barrier(pxc, sc, ey_coef, L),
                            "min_dey_alongside": gap(pxc, sc)}}
        out["replays"].append(rec)
        print(json.dumps(rec), flush=True)
    return out


def run_port(layout, args, n_steps, hold=0.15):
    import torch

    from car_racing_tpu_torch.ops import dynamics, track
    from car_racing_tpu_torch.racing import fused
    from car_racing_tpu_torch.utils import params

    kw = dict(device="cpu", dtype=torch.float64)
    rg = dataclasses.replace(params.RacingGameParam.default(alpha=0.8, **kw), corridor_hold=hold)
    t = lambda a: a if isinstance(a, int) else torch.as_tensor(np.array(a), device="cpu")
    xc, us, ot, ls = fused.rollout_racing_game(
        track.load_track(layout, width=1.0, **kw), dynamics.BicycleParams.default(**kw),
        params.LMPCParam.default(**kw), rg, params.SystemParam.default(**kw),
        *[t(a) for a in args], n_steps=n_steps)
    return xc.numpy(), ot.numpy(), ls


def replay_port(record):
    """The port's replay of every injected run of ``record`` on the CPU:
    per kind of run, how many held runs (no solve stopped at its cap) and
    their largest distance from the JAX run, apart for rows reached through
    overtake steps only and rows at or after an LMPC step."""
    import torch

    from car_racing_tpu_torch.ops import dynamics, track
    from car_racing_tpu_torch.racing import fused
    from car_racing_tpu_torch.utils import params

    kw = dict(device="cpu", dtype=torch.float64)
    t = lambda a: a if isinstance(a, int) else torch.as_tensor(np.array(a), device="cpu")
    out = {}
    for r in record["injected"]:
        args = rollout_args(r["layout"], r["xcurv0"], r["xglob0"], r["s_coef"], r["ey_coef"],
                            np.array(r["lin_points0"]), np.array(r["lin_input0"]))
        rg = dataclasses.replace(params.RacingGameParam.default(alpha=0.8, **kw),
                                 corridor_hold=r["corridor_hold"])
        solves = []
        xc, us, ot, _ = fused.rollout_racing_game(
            track.load_track(r["layout"], width=1.0, **kw), dynamics.BicycleParams.default(**kw),
            params.LMPCParam.default(**kw), rg, params.SystemParam.default(**kw),
            *[t(a) for a in args], n_steps=INJECTED_STEPS, solves=solves)
        err = np.maximum(np.abs(xc[1:].numpy() - np.array(r["xcurv"])[1:]).max(axis=1),
                         np.abs(us.numpy() - np.array(r["u"])).max(axis=1))
        after = np.cumsum([len(s.lmpc_lanes) > 0 for s in solves]) > 0
        key = f"{r['scenario']}/{r['kind']}"
        w = out.setdefault(key, {"runs": 0, "flags_equal": 0, "held": 0,
                                 "overtake_rows_max_abs_err": None,
                                 "after_lmpc_rows_max_abs_err": None})
        w["runs"] += 1
        w["flags_equal"] += ot.numpy().astype(int).tolist() == r["flags"]
        if not any(bool(s.capped[0]) for s in solves):
            w["held"] += 1
            for name, rows in (("overtake", ~after), ("after_lmpc", after)):
                if rows.any():
                    k = f"{name}_rows_max_abs_err"
                    w[k] = max(w[k] or 0.0, float(err[rows].max()))
    return out


def injected_inputs(layout, rows, us, k, s_coef):
    """The inputs of a short run from row ``k`` of a lap ``rows`` with
    inputs ``us`` (module docstring)."""
    jt = jtrack.load_track(layout, width=1.0)
    L = float(jt.lap_length)
    x0 = rows[k].copy()
    x0[4] = np.mod(x0[4], L)
    xg0 = np.asarray(jtrack.frenet_to_global_state(jt, jnp.asarray(x0)))
    pad = lambda a, n: np.concatenate([a, np.repeat(a[-1:], n - len(a), axis=0)])[:n]
    sc = np.array(s_coef, np.float64)
    sc[:, 1] += sc[:, 0] * (0.1 * k)
    return x0, xg0, sc, pad(rows[k : k + 13], 13), pad(us[k : k + 12], 12)


def interest_sizes(xc, ot, s_coef, L, rg=None):
    """Cars of interest at each overtake step, by the trigger formula of
    tests/test_fused.py:760-776."""
    sizes = np.zeros(len(ot), int)
    for k in np.nonzero(ot)[0]:
        t, s_e = k * 0.1, xc[k, 4] % L
        for cs in s_coef:
            s_a = np.polyval(cs, t) % L
            front = 4.5 * 0.4 + 0.5 * abs(xc[k, 0] - cs[0])
            w = lambda d, lim: 0 <= d <= lim
            if (w(s_a - s_e, front) or w(s_a + L - s_e, front) or w(s_e - s_a, 0.4)
                    or w(s_e + L - s_a, 0.4)):
                sizes[k] += 1
    return sizes


def injected(name):
    layout, (s_coef, ey_coef), hold, n_steps = SCENARIOS[name]
    sd = seed_inputs(layout)
    L = lap_length(layout)
    xc, us, ot, ls = run_jax(layout, rollout_args(layout, sd["xcurv0"], sd["xglob0"], s_coef,
                                                  ey_coef), n_steps, hold)
    rows, ot = xc[: ls + 1], ot[:ls]
    if name in ("l_shape", "m_shape"):
        golden = np.loadtxt(f"data/goldens/racing_game_{name}.csv", delimiter=",")
        assert rows.shape == golden.shape and np.abs(rows - golden).max() == 0.0, name
        lmpc_steps = np.nonzero(~ot)[0]
        pick = lmpc_steps[np.linspace(0, len(lmpc_steps) - 1, LMPC_STATES).astype(int)]
        states = [(int(k), "overtake") for k in np.nonzero(ot)[0]]
        states += [(int(k), "lmpc") for k in pick]
    elif name == "three_cars":
        sizes = interest_sizes(rows, ot, s_coef, L)
        states = []
        for m in (1, 2, 3):
            ks = np.nonzero(sizes == m)[0]
            states += [(int(k), f"interest_{m}") for k in ks[[0, len(ks) // 2]]]
    else:
        ks = np.nonzero(ot)[0]
        states = [(int(k), "overtake") for k in ks[[0, len(ks) // 2]]]
    runs = []
    for k, kind in states:
        x0, xg0, sc, lp0, li0 = injected_inputs(layout, rows, us, k, s_coef)
        args = rollout_args(layout, x0, xg0, sc, ey_coef, lp0, li0)
        jx, ju, jot, _ = run_jax(layout, args, INJECTED_STEPS, hold)
        runs.append({"scenario": name, "layout": layout, "corridor_hold": hold, "k": k,
                     "kind": kind, "xcurv0": x0.tolist(), "xglob0": xg0.tolist(),
                     "s_coef": sc.tolist(), "ey_coef": np.asarray(ey_coef, float).tolist(),
                     "lin_points0": lp0.tolist(), "lin_input0": li0.tolist(),
                     "xcurv": jx.tolist(), "u": ju.tolist(), "flags": jot.astype(int).tolist()})
    print(json.dumps({"scenario": name, "runs": len(runs),
                      "kinds": sorted({r["kind"] for r in runs})}), flush=True)
    return runs


def bench_f32():
    """The JAX bench's f32 lap from its first starts and its 8-lane fleet,
    with x64 off as the package runs in f32 (with it on, literals would
    promote to f64)."""
    jax.config.update("jax_enable_x64", False)
    layout = "l_shape"
    s_coef, ey_coef = L_TRAFFIC
    sd = seed_inputs(layout)
    L = lap_length(layout)
    rng = np.random.default_rng(5)
    starts = []
    for i in range(BENCH_STARTS):
        x0 = (sd["xcurv0"].astype(np.float32) + np.asarray(
            0.005 * rng.standard_normal(6) * np.array([1, 1, 1, 1, 0, 1]), np.float32))
        args = rollout_args(layout, x0, sd["xglob0"], s_coef, ey_coef)
        xc, us, ot, ls = run_jax(layout, args, BENCH_STEPS, dtype=jnp.float32)
        rows = xc[: ls + 1].astype(np.float64)
        starts.append({"start": i, "xcurv0": x0.astype(np.float64).tolist(), "lap_steps": ls,
                       "overtake_steps": int(ot[:ls].sum()),
                       "max_abs_ey": float(np.abs(rows[:, 5]).max()),
                       "least_barrier": least_barrier(rows, s_coef, ey_coef, L)})
        print(json.dumps({"bench_f32": starts[-1]}), flush=True)

    pert = np.zeros((FLEET_B, 6))
    pert[:, 5] = np.random.default_rng(6).normal(0, 0.01, FLEET_B)
    xc0 = jnp.asarray(sd["xcurv0"], jnp.float32) + jnp.asarray(pert, jnp.float32)
    xg0 = jnp.broadcast_to(jnp.asarray(sd["xglob0"], jnp.float32), (FLEET_B, 6))
    args = rollout_args(layout, sd["xcurv0"], sd["xglob0"], s_coef, ey_coef)
    f32 = lambda a: jnp.asarray(a, jnp.int32) if isinstance(a, int) else (
        jnp.asarray(a) if np.asarray(a).dtype == bool else jnp.asarray(a, jnp.float32))
    c = lambda tree: cast_tree(tree, jnp.float32)
    xc, us, ot, ls = jfused.rollout_racing_game_batch(
        c(jtrack.load_track(layout, width=1.0)), c(jdyn.BicycleParams.default()),
        c(jparams.LMPCParam.default()), c(jparams.RacingGameParam.default(alpha=0.8)),
        c(jparams.SystemParam.default()), xc0, xg0, *[f32(a) for a in args[2:]],
        n_steps=FLEET_STEPS, dynamics_unroll=10)
    xc, ot = np.asarray(xc).astype(np.float64), np.asarray(ot)
    lanes = [{"lane": b, "max_abs_ey": float(np.abs(xc[b, :, 5]).max()),
              "least_barrier": least_barrier(xc[b], s_coef, ey_coef, L),
              "overtake_steps": int(ot[b].sum())} for b in range(FLEET_B)]
    # lanes 0 and 1 alone: how far a fleet lane moves from its own run
    # (the LMPC step's rank-deficient regression in f32)
    alone = {}
    for b in (0, 1):
        xs, _, _, _ = jfused.rollout_racing_game(
            c(jtrack.load_track(layout, width=1.0)), c(jdyn.BicycleParams.default()),
            c(jparams.LMPCParam.default()), c(jparams.RacingGameParam.default(alpha=0.8)),
            c(jparams.SystemParam.default()), xc0[b], xg0[b], *[f32(a) for a in args[2:]],
            n_steps=SELF_STEPS, dynamics_unroll=10)
        alone[str(b)] = np.abs(xc[b, : SELF_STEPS + 1] - np.asarray(xs)).max(axis=1).tolist()
    fleet = {"B": FLEET_B, "n_steps": FLEET_STEPS, "ey_perturbation": pert[:, 5].tolist(),
             "lanes": lanes, "collisions": sum(lane["least_barrier"] <= 1.0 for lane in lanes),
             "max_abs_ey": max(lane["max_abs_ey"] for lane in lanes),
             "finite": bool(np.isfinite(xc).all()), "lane_vs_alone_by_row": alone}
    print(json.dumps({"fleet_f32": fleet}), flush=True)
    jax.config.update("jax_enable_x64", True)
    return {"n_steps": BENCH_STEPS, "starts": starts,
            "max_abs_ey_max": max(s["max_abs_ey"] for s in starts),
            "least_barrier_min": min(s["least_barrier"] for s in starts)}, fleet


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ulps", type=int, default=12, help="nudge vx by -ulps..ulps")
    ap.add_argument("--port", action="store_true", help="also run the port's nudged laps")
    ap.add_argument("--port-ulps", type=int, default=2)
    ap.add_argument("--out", help="write the record to this JSON file")
    ap.add_argument("--f32-only", action="store_true",
                    help="rerun only bench_f32 and fleet_f32 into the --out file")
    ap.add_argument("--replay-port", action="store_true",
                    help="replay the --out file's injected runs in the port and print the "
                         "distances")
    ap.add_argument("--more-l-shape", type=int, metavar="HI",
                    help="add the l_shape laps nudged by ulps+1..HI either way to the --out "
                         "file as nudged_more, its other entries unchanged")
    ap.add_argument("--passes", type=int, metavar="HI",
                    help="print how the l_shape laps nudged by -HI..HI pass the cars; the "
                         "spread file is not touched")
    ap.add_argument("--replay-card", metavar="FILE",
                    help="replay in JAX the card's unnudged l_shape lap from FILE (the --out "
                         "of tools.racing_game_card_spread) before its closest row")
    a = ap.parse_args()
    if a.replay_card:
        out = replay_card(a.replay_card)
        if a.out:
            with open(a.out, "w") as f:
                json.dump(out, f)
                f.write("\n")
        print(json.dumps(out["card"]))
        return
    if a.passes:
        out = passes(a.passes)
        if a.out:
            with open(a.out, "w") as f:
                json.dump(out, f)
                f.write("\n")
        return
    if a.more_l_shape:
        with open(a.out) as f:
            out = json.load(f)
        out.setdefault("nudged_more", {})["l_shape"] = nudged_more(
            "l_shape", out["ulps"] + 1, a.more_l_shape, a.port_ulps if a.port else 0)
        with open(a.out, "w") as f:
            json.dump(out, f)
            f.write("\n")
        return
    if a.replay_port:
        with open(a.out) as f:
            print(json.dumps({"replay_port": replay_port(json.load(f))}))
        return
    if a.f32_only:
        with open(a.out) as f:
            out = json.load(f)
        out["bench_f32"], out["fleet_f32"] = bench_f32()
        with open(a.out, "w") as f:
            json.dump(out, f)
            f.write("\n")
        return
    out = {"ulps": a.ulps, "off_atols": list(OFF_ATOLS), "nudged": {}, "injected": []}
    for layout in ("l_shape", "m_shape"):
        jax_spread, port_spread = nudged(layout, a.ulps, a.port_ulps if a.port else 0)
        out["nudged"][layout] = jax_spread
        if port_spread:
            out.setdefault("nudged_port", {})[layout] = port_spread
    for name in SCENARIOS:
        out["injected"] += injected(name)
    out["bench_f32"], out["fleet_f32"] = bench_f32()
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f)
            f.write("\n")
    print(json.dumps({k: v for k, v in out["nudged"]["l_shape"].items() if k != "laps"}))
    print(json.dumps({k: v for k, v in out["nudged"]["m_shape"].items() if k != "laps"}))


if __name__ == "__main__":
    main()
