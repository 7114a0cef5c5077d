"""Guards on the PyTorch port: it imports no JAX, its entry points refuse to
fall back to the CPU unasked, and its kernel wrappers run their plain
versions (and launch nothing) for CPU tensors."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from car_racing_tpu_torch.kernels import cholesky as k2, propagate as k1
from car_racing_tpu_torch.models import controllers
from car_racing_tpu_torch.ops import dynamics, track
from car_racing_tpu_torch.planning import overtake
from car_racing_tpu_torch.racing import fused
from car_racing_tpu_torch.utils import convert, fixtures, params

ROOT = Path(__file__).resolve().parent.parent
F64 = torch.float64


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "car_racing_tpu")


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "car_racing_tpu_torch").rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_anywhere(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'car_racing_tpu', 'triton'):\n"
        "    sys.modules[m] = None\n"
        "import car_racing_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not [k for k in sys.modules if k.startswith(('jax.', 'car_racing_tpu.'))]\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


ENTRY_POINTS = {
    "load_track": lambda: track.load_track("l_shape"),
    "build_track": lambda: track.build_track(np.array([[1.0, 0.0], [3.0, 1.0]])),
    "BicycleParams.default": lambda: dynamics.BicycleParams.default(),
    "MPCParam.default": lambda: params.MPCParam.default(),
    "SystemParam.default": lambda: params.SystemParam.default(),
    "LMPCParam.default": lambda: params.LMPCParam.default(),
    "MPCCBFParam.default": lambda: params.MPCCBFParam.default(),
    "ILQRParam.default": lambda: params.ILQRParam.default(),
    "load_lmpc_seed": lambda: fixtures.load_lmpc_seed("l_shape"),
    "CarParam.default": lambda: params.CarParam.default(),
    "load_lti": lambda: params.load_lti(),
    "target_state": lambda: controllers.target_state(0.8, 0.0),
    "corridor_sweep_inputs": lambda: overtake.corridor_sweep_inputs(2, 10),
    "convert.to_port": lambda: convert.to_port(
        params.SystemParam, {"delta_max": 0.5, "a_max": 1.0, "v_max": 10.0, "v_min": 0.0}),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_refuse_without_gpu(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        ENTRY_POINTS[name]()


def _period_inputs():
    kw = dict(device="cpu", dtype=F64)
    tr = track.load_track("goggle", width=1.0, **kw)
    bike = dynamics.BicycleParams.default(**kw)
    rng = np.random.default_rng(1)
    xc = torch.as_tensor(np.array([0.8, 0, 0, 0, 3.0, 0.1]) + 0.1 * rng.standard_normal((4, 6)))
    xg = torch.as_tensor(rng.standard_normal((4, 6)))
    u = torch.as_tensor(0.1 * rng.standard_normal((4, 2)))
    return tr, bike, xg, xc, u


def test_propagate_wrapper_takes_plain_path_on_cpu():
    k1.launches = 0
    args = _period_inputs()
    got = k1.propagate(*args)
    want = k1.plain(*args)
    auto = dynamics.propagate(*args)
    for g, w, a in zip(got, want, auto):
        assert torch.equal(g, w) and torch.equal(a, w)
    assert k1.launches == 0
    with pytest.raises(ValueError, match="backend='cuda' needs CUDA tensors"):
        dynamics.propagate(*args, backend="cuda")


def test_propagate_ignores_input_global_velocities():
    tr, bike, xg, xc, u = _period_inputs()
    xg2 = xg.clone()
    xg2[:, :3] = 123.0
    a, b = k1.plain(tr, bike, xg, xc, u), k1.plain(tr, bike, xg2, xc, u)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[0][:, :3], a[1][:, :3])


def test_cholesky_wrapper_takes_plain_path_on_cpu():
    k2.launches = 0
    rng = np.random.default_rng(2)
    L = rng.standard_normal((5, 20, 20))
    A = torch.as_tensor(L @ np.transpose(L, (0, 2, 1)) + 20 * np.eye(20))
    b = torch.as_tensor(rng.standard_normal((5, 20)))
    assert torch.equal(k2.solve(A, b), k2.plain(A, b))
    np.testing.assert_allclose(k2.solve(A, b).numpy(),
                               np.linalg.solve(A.numpy(), b.numpy()[..., None])[..., 0],
                               rtol=1e-10, atol=1e-12)
    sweep = overtake.corridor_sweep(*overtake.corridor_sweep_inputs(
        2, 10, seed=1, dtype=F64, device="cpu"), num_horizon=10)
    assert k2.launches == 0
    assert sweep[3].all()


class _OnCard:
    """Stands in for a CUDA tensor on a machine without one: it reports a
    CUDA device and answers the wrappers' shape, type and layout checks."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape = t.dtype, t.shape

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return True

    def element_size(self):
        return self._t.element_size()


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_cuda_tensor_launches_kernel_or_raises_never_plain(kernel, monkeypatch):
    """A CUDA tensor reaching a solve wrapper goes to the kernel's build and
    launch or raises; it never falls back to the plain version."""
    from car_racing_tpu_torch.kernels import build, cholesky_multi as k3

    mod, fn, rhs = {"K2": (k2, k2.solve, (3, 5)), "K3": (k3, k3.solve_multi, (3, 5, 4))}[kernel]
    A = _OnCard(torch.eye(5, dtype=F64).expand(3, 5, 5))
    b = _OnCard(torch.ones(rhs, dtype=F64))

    def refuse(name):
        raise RuntimeError(f"building {name} refused")

    def no_plain(*args):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(mod, "plain", no_plain)
    mod.launches = 0
    with pytest.raises(RuntimeError, match="building cholesky_solve refused"):
        fn(A, b)
    assert mod.launches == 0
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fn(torch.empty(3, 5, 5, device="meta"), torch.empty(rhs, device="meta"))


def _obstacle_rollout(name):
    kw = dict(device="cpu", dtype=F64)
    t = lambda a: torch.tensor(a, **kw)
    zeros, half = torch.zeros(6, **kw), t([0.2, 0.1])
    if name == "mpccbf":
        return fused.rollout_mpccbf(
            track.load_track("l_shape", width=1.0, **kw), dynamics.BicycleParams.default(**kw),
            params.MPCCBFParam.default(vt=0.8, **kw), params.SystemParam.default(**kw),
            t([0.8, 0, 0, 0, 0, 0]), zeros, zeros, t([[0.2, 4.0]]), t([[0.0, 0.1]]),
            torch.tensor([True]), half[None], half, n_steps=2)
    return fused.rollout_ilqr(
        track.load_track("ellipse", width=1.0, **kw), dynamics.BicycleParams.default(**kw),
        params.ILQRParam.default(vt=0.8, **kw), t([0.8, 0, 0, 0, 0, 0]), zeros, zeros,
        t([0.2, 5.0]), t([0.0, 0.1]), half, half, n_steps=2)


@pytest.mark.parametrize("name", ["mpccbf", "ilqr"])
def test_obstacle_rollouts_send_card_states_to_k1(name, monkeypatch):
    """The MPC-CBF and iLQR rollouts step their vehicle through K1's
    wrapper; a state on the card reaches the kernel's checks and launch (here
    refused: the track stayed on the CPU), never the plain loop."""
    real, calls = k1.propagate, []

    def on_card(tr, bike, xglob, xcurv, u, *args):
        calls.append(tuple(xcurv.shape))
        return real(tr, bike, _OnCard(xglob), _OnCard(xcurv), _OnCard(u), *args)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain loop ran for a CUDA tensor")

    monkeypatch.setattr(k1, "propagate", on_card)
    monkeypatch.setattr(k1, "plain", no_plain)
    k1.launches = 0
    with pytest.raises(ValueError, match="track is torch.float64 on cpu; K1 needs"):
        _obstacle_rollout(name)
    assert calls == [(1, 6)] and k1.launches == 0
