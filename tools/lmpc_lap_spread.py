#!/usr/bin/env python3
"""How far the LMPC learning lap can wander from its golden.

    python -m tools.lmpc_lap_spread [--ulps 12] [--layouts l_shape,goggle] [--port]
                                    [--dtype f64|f32] [--learning] [--out F]

Run from the repository root.

Runs the JAX package's ``rollout_lmpc_lap`` on the CPU in float64 from each
layout's committed seed lap, once as it is and once for each nudge of the
initial vx by k = -ulps..ulps units in the last place, and prints one JSON
line per lap: its step count, the largest distance from the golden
(``data/goldens/lmpc_lap_<layout>.csv``) on the rows they share, the first
row off the golden by more than 1e-2, and the first LMPC solve that stops
unconverged at the iteration cap.  With ``--port`` the PyTorch port's lap
runs from the same nudged states on the CPU too.  With ``--dtype f32``
every lap runs in float32, vx is nudged by float32 ulps, and the laps are
compared with the unnudged JAX float32 lap instead of the float64 golden
(f32 and f64 learn different laps).  With ``--learning`` it runs, instead
of single laps, the JAX package's multi-lap ``rollout_lmpc_learning``
(``LEARNING_LAPS`` laps) from the l_shape seed with the same nudges, and
``run_learning_protocol`` on l_shape once as it is, and the 64-lane
learning fleet of ``chip_smoke.py`` (one lap from the seed's start with ey
+ N(0, 0.01)) for numpy seeds 0, 1 and 2; it summarises them as
``l_shape/jax_learning`` (the per-lap step counts of every run, whether its
learning curve, seed lap first, decreases, and its largest |ey|),
``l_shape/jax_protocol`` (the protocol's lap steps) and
``l_shape/jax_learning_fleet`` (per fleet: lap steps, lanes that did not
finish, lanes off the track (|ey| > 1) and the largest |ey|), and
``l_shape/jax_self_distance``: how far the JAX learning rollout moves from
itself over its first ``SELF_STEPS`` steps, row by row, when vx is one ulp
off, and when a lane runs in a 3-lane fleet (``vmap``) instead of alone.  The last line summarises each layout
and package (keys ``<layout>/<package>``, with ``_f32`` appended in
float32): the lap steps and the first rows off of the nudged laps;
``--out`` merges that summary into a JSON file as well.  With
``--fleet-lane LANE`` it only runs that fleet for numpy seed 0 in JAX and in
the port (on the CPU, f64) and compares lane ``LANE`` row by row
(``l_shape/fleet_lane_<LANE>``: the first row apart by more than 1e-4 and
whether a capped solve of the port's lane comes before it).

``data/goldens/lmpc_lap_spread.json`` is the summary of ``--ulps 12``
(24 nudged laps a layout), with ``--port`` and, for l_shape, ``--dtype f32``.
``chip_smoke.py`` and ``tests/test_torch_lmpc.py`` hold the port's laps to
its ``*/jax`` entries: on the golden up to the earliest row a nudged JAX
lap leaves it, and no further from the golden's lap steps than the furthest
nudged JAX lap; ``chip_smoke.py`` holds the f32 l_shape lap's steps to
``l_shape/jax_f32`` alike, and the port's learning laps 2 and 3 to
``l_shape/jax_learning``.  Rerun this script with ``--out`` when the JAX lap
or its goldens change.  On the CPU a JAX lap takes a few seconds, a lap of
the port 10 to 60 s.
"""

from __future__ import annotations

import argparse
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

LAP_STEPS = {"l_shape": 250, "goggle": 350, "m_shape": 700, "ellipse": 400}
ATOL = 1e-2
LEARNING_LAPS, LEARNING_STEPS = 3, 600
FLEET_B, FLEET_STEPS, FLEET_SEEDS = 64, 250, (0, 1, 2)
SELF_STEPS = 14


def nudge(x0, k):
    """``x0`` with its vx moved by ``k`` units in the last place of its dtype."""
    x = x0.copy()
    for _ in range(abs(k)):
        x[0] = np.nextafter(x[0], np.inf if k > 0 else -np.inf)
    return x


def jax_lap(layout, sd, x0):
    """The JAX lap from ``x0``, in ``x0``'s dtype."""
    ft = jnp.float32 if x0.dtype == np.float32 else jnp.float64
    if ft == jnp.float32:
        cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    else:
        cast = lambda tree: tree
    j = lambda k: jnp.asarray(sd[k], ft)
    xc, _, _, lap_steps = jfused.rollout_lmpc_lap(
        cast(jtrack.load_track(layout, width=1.0)), cast(jdyn.BicycleParams.default()),
        cast(jparams.LMPCParam.default()), cast(jparams.SystemParam.default()),
        jnp.asarray(x0), j("xglob0"), j("ss1"), j("q1"), j("ss2"), j("q2"), j("u1"), j("u2"),
        jnp.asarray(sd["valid1"]), jnp.asarray(sd["valid2"]),
        jnp.asarray(sd["counter"], jnp.int32), j("lin_points0"), j("lin_input0"),
        n_steps=LAP_STEPS[layout])
    return np.asarray(xc), int(lap_steps), None  # the scan does not expose its solves


def port_lap(layout, x0):
    """The port's lap from ``x0``, in ``x0``'s dtype, on the CPU."""
    import torch

    from car_racing_tpu_torch.ops import dynamics, track
    from car_racing_tpu_torch.racing import fused
    from car_racing_tpu_torch.utils import fixtures, params

    kw = dict(device="cpu", dtype=torch.float32 if x0.dtype == np.float32 else torch.float64)
    sd = fixtures.load_lmpc_seed(layout, **kw)
    solves = []
    xc, _, _, lap_steps = fused.rollout_lmpc_lap(
        track.load_track(layout, width=1.0, **kw), dynamics.BicycleParams.default(**kw),
        params.LMPCParam.default(**kw), params.SystemParam.default(**kw),
        torch.as_tensor(x0, **kw), sd["xglob0"], sd["ss1"], sd["q1"], sd["ss2"], sd["q2"],
        sd["u1"], sd["u2"], sd["valid1"], sd["valid2"], sd["counter"], sd["lin_points0"],
        sd["lin_input0"], n_steps=LAP_STEPS[layout], solves=solves)
    conv = [bool(s.converged[0]) for s in solves]
    return xc.numpy(), lap_steps, (conv.index(False) if False in conv else None)


def jax_learning(sd, x0):
    """Lap steps and largest |ey| of the JAX multi-lap learning rollout
    from ``x0`` (f64)."""
    j = lambda k: jnp.asarray(sd[k])
    i32 = lambda k: jnp.asarray(sd[k], jnp.int32)
    xc, _, lap_steps, laps_done = jfused.rollout_lmpc_learning(
        jtrack.load_track("l_shape", width=1.0), jdyn.BicycleParams.default(),
        jparams.LMPCParam.default(), jparams.SystemParam.default(),
        jnp.asarray(x0), j("xglob0"), j("ss1"), j("q1"), j("u1"), i32("counter"),
        j("ss2"), j("q2"), j("u2"), i32("pid_lap_steps"), j("lin_points0"), j("lin_input0"),
        n_laps=LEARNING_LAPS, n_steps=LEARNING_STEPS)
    if int(laps_done) < LEARNING_LAPS:
        raise RuntimeError(f"vx {x0[0]!r}: {int(laps_done)} laps in {LEARNING_STEPS} steps")
    return [int(n) for n in np.asarray(lap_steps)], float(np.abs(np.asarray(xc)[:, 5]).max())


def jax_learning_fleet(sd, seed, B=FLEET_B, n_steps=FLEET_STEPS):
    """The one-lap JAX learning fleet of ``B`` lanes from the seed's start
    with ey + N(0, 0.01) (numpy ``seed``): its starts, trajectories (B,
    n_steps+1, 6) and lap steps (B,)."""
    pert = np.zeros((B, 6))
    pert[:, 5] = np.random.default_rng(seed).normal(0, 0.01, B)
    j = lambda k: jnp.asarray(sd[k])
    i32 = lambda k: jnp.asarray(sd[k], jnp.int32)
    xc, _, lap_steps, _ = jfused.rollout_lmpc_learning_batch(
        jtrack.load_track("l_shape", width=1.0), jdyn.BicycleParams.default(),
        jparams.LMPCParam.default(), jparams.SystemParam.default(),
        jnp.asarray(sd["xcurv0"] + pert), jnp.broadcast_to(j("xglob0"), (B, 6)),
        j("ss1"), j("q1"), j("u1"), i32("counter"), j("ss2"), j("q2"), j("u2"),
        i32("pid_lap_steps"), j("lin_points0"), j("lin_input0"), n_laps=1, n_steps=n_steps)
    return sd["xcurv0"] + pert, np.asarray(xc), np.asarray(lap_steps)[:, 0]


def jax_learning_rows(sd, x0, n_steps):
    """The JAX one-lap learning rollout of one car from ``x0``: (n_steps+1, 6)."""
    j = lambda k: jnp.asarray(sd[k])
    i32 = lambda k: jnp.asarray(sd[k], jnp.int32)
    xc, _, _, _ = jfused.rollout_lmpc_learning(
        jtrack.load_track("l_shape", width=1.0), jdyn.BicycleParams.default(),
        jparams.LMPCParam.default(), jparams.SystemParam.default(),
        jnp.asarray(x0), j("xglob0"), j("ss1"), j("q1"), j("u1"), i32("counter"), j("ss2"),
        j("q2"), j("u2"), i32("pid_lap_steps"), j("lin_points0"), j("lin_input0"), n_laps=1,
        n_steps=n_steps)
    return np.asarray(xc)


def self_distance(sd):
    """``l_shape/jax_self_distance``: row-wise largest distances of the JAX
    rollout from itself (vx one ulp up; the lanes of the 3-lane fleet of
    ``tests/test_torch_learning.py`` against the same lanes alone)."""
    base = jax_learning_rows(sd, sd["xcurv0"], SELF_STEPS)
    ulp = np.abs(jax_learning_rows(sd, nudge(sd["xcurv0"], 1), SELF_STEPS) - base).max(axis=1)
    x0, fleet, _ = jax_learning_fleet(sd, 0, B=3, n_steps=SELF_STEPS)
    lanes = np.stack([np.abs(fleet[b] - jax_learning_rows(sd, x0[b], SELF_STEPS)).max(axis=1)
                      for b in range(3)])
    return {"n_steps": SELF_STEPS, "vx_one_ulp_row_max_abs": ulp.tolist(),
            "fleet_lane_vs_alone_row_max_abs": lanes.max(axis=0).tolist()}


def learning_summary(ulps):
    """``l_shape/jax_learning`` and ``l_shape/jax_protocol``."""
    from car_racing_tpu.racing import protocol as jprotocol

    with np.load("data/bench/lmpc_seed_l_shape.npz") as f:
        sd = {k: f[k] for k in f.files}
    runs, eys = {}, {}
    for k in range(-ulps, ulps + 1):
        runs[k], eys[k] = jax_learning(sd, nudge(sd["xcurv0"], k))
        curve = [int(sd["counter"])] + runs[k]
        print(json.dumps({"layout": "l_shape", "package": "jax", "learning": True,
                          "vx_ulps": k, "lap_steps": runs[k], "max_abs_ey": eys[k],
                          "monotone": all(a > b for a, b in zip(curve, curve[1:]))}), flush=True)
    nudged = [runs[k] for k in sorted(runs) if k]
    curves = [[int(sd["counter"])] + r for r in nudged]
    out = jprotocol.run_learning_protocol(jtrack.load_track("l_shape", width=1.0),
                                          n_laps=LEARNING_LAPS)
    fleets = []
    for seed in FLEET_SEEDS:
        _, xc, steps = jax_learning_fleet(sd, seed)
        ey = np.abs(xc[..., 5]).max(axis=1)
        fleets.append({"seed": seed, "lap_steps_min": int(steps.min()),
                       "lap_steps_median": float(np.median(steps)),
                       "lap_steps_max": int(steps.max()),
                       "unfinished_lanes": int((steps >= FLEET_STEPS).sum()),
                       "off_track_lanes": int((ey > 1.0).sum()), "max_abs_ey": float(ey.max())})
        print(json.dumps({"layout": "l_shape", "package": "jax", "learning_fleet": True,
                          **fleets[-1]}), flush=True)
    return {
        "l_shape/jax_learning": {
            "n_laps": LEARNING_LAPS, "n_steps": LEARNING_STEPS, "vx_ulps": ulps,
            "seed_lap_steps": int(sd["counter"]), "unnudged_lap_steps": runs[0],
            "nudged_lap_steps": nudged,
            "nudged_monotone": [all(a > b for a, b in zip(c, c[1:])) for c in curves],
            "nudged_max_abs_ey": [eys[k] for k in sorted(eys) if k]},
        "l_shape/jax_protocol": {"width": 1.0, "n_laps": LEARNING_LAPS,
                                 "lap_steps": out["lap_steps"]},
        "l_shape/jax_learning_fleet": {"B": FLEET_B, "n_steps": FLEET_STEPS, "n_laps": 1,
                                       "ey_sigma": 0.01, "fleets": fleets},
        "l_shape/jax_self_distance": self_distance(sd),
    }


def fleet_lane(lane, seed=0, atol=1e-4):
    """``l_shape/fleet_lane_<lane>``: lane ``lane`` of the 64-lane learning
    fleet of ``chip_smoke.py`` (numpy ``seed``), the JAX fleet's and the
    port's (on the CPU, f64) row by row: the first row apart by more than
    ``atol``, the port lane's first solve stopped at the 40-iteration cap,
    and each fleet's largest |ey| on that lane and over all lanes."""
    import torch

    from car_racing_tpu_torch.ops import dynamics, track
    from car_racing_tpu_torch.racing import fused
    from car_racing_tpu_torch.utils import fixtures, params

    with np.load("data/bench/lmpc_seed_l_shape.npz") as f:
        sd = {k: f[k] for k in f.files}
    x0, jxc, jsteps = jax_learning_fleet(sd, seed)
    kw = dict(device="cpu", dtype=torch.float64)
    ps = fixtures.load_lmpc_seed("l_shape", **kw)
    solves = []
    pxc, _, psteps, _ = fused.rollout_lmpc_learning_batch(
        track.load_track("l_shape", width=1.0, **kw), dynamics.BicycleParams.default(**kw),
        params.LMPCParam.default(**kw), params.SystemParam.default(**kw),
        torch.as_tensor(x0, **kw), ps["xglob0"].expand(FLEET_B, 6).contiguous(), ps["ss1"],
        ps["q1"], ps["u1"], ps["counter"], ps["ss2"], ps["q2"], ps["u2"], ps["pid_lap_steps"],
        ps["lin_points0"], ps["lin_input0"], n_laps=1, n_steps=FLEET_STEPS, solves=solves)
    pxc = pxc.numpy()
    its = np.stack([s.iterations.numpy() for s in solves], axis=1)  # (B, n_steps)
    row_err = np.abs(pxc[lane] - jxc[lane]).max(axis=1)
    off = np.nonzero(row_err > atol)[0]
    capped = np.nonzero(its[lane] >= 40)[0]
    first_off = int(off[0]) if len(off) else None
    first_capped = int(capped[0]) if len(capped) else None
    return {"seed": seed, "lane": lane, "atol": atol, "first_row_off": first_off,
            "first_capped_step": first_capped,
            "capped_before_first_row_off": (first_capped is not None and first_off is not None
                                            and first_capped < first_off),
            "lap_steps": {"jax": int(jsteps[lane]), "port": int(psteps[lane, 0])},
            "max_abs_ey_lane": {"jax": float(np.abs(jxc[lane, :, 5]).max()),
                                "port": float(np.abs(pxc[lane, :, 5]).max())},
            "max_abs_ey_fleet": {"jax": float(np.abs(jxc[..., 5]).max()),
                                 "port": float(np.abs(pxc[..., 5]).max())},
            "lanes_off_track": {"jax": np.nonzero(np.abs(jxc[..., 5]).max(axis=1) > 1.0)[0]
                                .tolist(),
                                "port": np.nonzero(np.abs(pxc[..., 5]).max(axis=1) > 1.0)[0]
                                .tolist()},
            "row_max_abs_to_first_off": row_err[: (first_off or len(row_err)) + 1].max().item()}


def compare(xc, lap_steps, ref):
    """Lap steps, and distance from the reference lap ``ref`` on the rows
    the two share."""
    xc = xc[: lap_steps + 1]
    m = min(len(xc), len(ref))
    err = np.abs(xc[:m] - ref[:m]).max(axis=1)
    off = np.nonzero(err > ATOL)[0]
    return {"lap_steps": lap_steps, "max_abs_err": float(err.max()),
            "first_row_off": int(off[0]) if len(off) else None}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ulps", type=int, default=12, help="nudge vx by -ulps..ulps")
    ap.add_argument("--layouts", default=",".join(LAP_STEPS))
    ap.add_argument("--port", action="store_true", help="also run the port's lap")
    ap.add_argument("--dtype", choices=("f64", "f32"), default="f64",
                    help="run the laps in this dtype (f32: against the unnudged JAX f32 lap)")
    ap.add_argument("--learning", action="store_true",
                    help="the multi-lap learning rollout and the protocol (l_shape, f64 only)")
    ap.add_argument("--fleet-lane", type=int,
                    help="only compare this lane of the seed-0 64-lane learning fleet, JAX "
                         "against the port on the CPU (about 10 min)")
    ap.add_argument("--out", help="also merge the summary into this JSON file")
    args = ap.parse_args()
    if args.fleet_lane is not None:
        summary = {f"l_shape/fleet_lane_{args.fleet_lane}": fleet_lane(args.fleet_lane)}
        print(json.dumps({"summary": summary}), flush=True)
        if args.out:
            with open(args.out) as f:
                merged = json.load(f)
            merged.update(summary)
            with open(args.out, "w") as f:
                json.dump(merged, f, indent=1)
                f.write("\n")
        return
    f32 = args.dtype == "f32"
    if f32:  # as the package runs in f32: with x64 on, literals would promote to f64
        jax.config.update("jax_enable_x64", False)
    summary = learning_summary(args.ulps) if args.learning else {}
    for layout in ([] if args.learning else args.layouts.split(",")):
        with np.load(f"data/bench/lmpc_seed_{layout}.npz") as f:
            sd = {k: f[k] for k in f.files}
        x0 = sd["xcurv0"].astype(np.float32 if f32 else np.float64)
        if f32:
            xc, lap_steps, _ = jax_lap(layout, sd, x0)
            ref = xc[: lap_steps + 1]
            where = {"reference": "the unnudged JAX f32 lap", "reference_lap_steps": lap_steps}
        else:
            ref = np.loadtxt(f"data/goldens/lmpc_lap_{layout}.csv", delimiter=",")
            where = {"golden_lap_steps": len(ref) - 1}
        runs = [("jax", jax_lap)] + ([("port", lambda lo, _, x: port_lap(lo, x))]
                                     if args.port else [])
        for pkg, lap in runs:
            rows = []
            for k in range(-args.ulps, args.ulps + 1):
                xc, lap_steps, first_capped = lap(layout, sd, nudge(x0, k))
                row = {"layout": layout, "package": pkg, "dtype": args.dtype, "vx_ulps": k,
                       **compare(xc, lap_steps, ref), "first_capped_step": first_capped}
                print(json.dumps(row), flush=True)
                rows.append(row)
            nudged = [r for r in rows if r["vx_ulps"] != 0]
            offs = [r["first_row_off"] for r in nudged if r["first_row_off"] is not None]
            summary[f"{layout}/{pkg}" + ("_f32" if f32 else "")] = {
                **where, "atol": ATOL, "vx_ulps": args.ulps,
                "unnudged_lap_steps": next(r["lap_steps"] for r in rows if r["vx_ulps"] == 0),
                "unnudged_max_abs_err": next(r["max_abs_err"] for r in rows
                                             if r["vx_ulps"] == 0),
                "nudged_lap_steps": sorted(r["lap_steps"] for r in nudged),
                "nudged_first_row_off": sorted(offs),
                "nudged_on_golden": len(nudged) - len(offs)}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        merged = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                merged = json.load(f)
        merged.update(summary)
        with open(args.out, "w") as f:
            json.dump(merged, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main()
