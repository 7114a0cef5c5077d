"""K1: one control period of the bicycle integrator (``csrc/propagate.cu``).

Replaces ``propagate_fused`` of car_racing_tpu/ops/pallas_kernels.py:402
(``pl.pallas_call`` at :436).  :func:`propagate` launches the kernel for
CUDA tensors and runs :func:`plain` for CPU tensors; ``launches`` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import dynamics, track as track_ops
from . import build

launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_void_p,
]


def _n_sub(control_dt: float, sub_dt: float) -> int:
    n_sub = int(round(control_dt / sub_dt))
    if n_sub < 1:
        raise ValueError(f"control_dt={control_dt} holds no substep of sub_dt={sub_dt}")
    return n_sub


def plain(track, params, xglob, xcurv, u, control_dt=0.1, sub_dt=0.001):
    """The plain PyTorch version: ``step`` and ``curvature`` per substep."""
    for _ in range(_n_sub(control_dt, sub_dt)):
        curv = track_ops.curvature(track, xcurv[..., 4])
        xglob, xcurv = dynamics.step(params, curv, xglob, xcurv, sub_dt, u)
    return xglob, xcurv


def propagate(track, params, xglob, xcurv, u, control_dt=0.1, sub_dt=0.001):
    """One control period for a ``(B, 6)`` batch; returns (xglob, xcurv)."""
    if xcurv.device.type == "cpu":
        return plain(track, params, xglob, xcurv, u, control_dt, sub_dt)
    if xcurv.device.type != "cuda":
        raise ValueError(f"no kernel for device {xcurv.device}")
    return _launch(track, params, xglob, xcurv, u, _n_sub(control_dt, sub_dt), sub_dt)


def _launch(track, params, xglob, xcurv, u, n_sub, sub_dt):
    global launches
    dtype, dev = xcurv.dtype, xcurv.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K1 takes float32 or float64, got {dtype}")
    B = xcurv.shape[0]
    table = track_ops.segment_table(track)
    par = torch.stack([
        params.m, params.lf, params.lr, params.Iz, params.Df, params.Cf, params.Bf,
        params.Dr, params.Cr, params.Br, track.lap_length,
    ])
    for name, t, shape in (("xglob", xglob, (B, 6)), ("xcurv", xcurv, (B, 6)),
                           ("u", u, (B, 2)), ("track", table, table.shape),
                           ("params", par, (11,))):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; K1 needs {dtype} on {dev}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous with shape {shape}, got {tuple(t.shape)}")
    xglob_out = torch.empty_like(xglob)
    xcurv_out = torch.empty_like(xcurv)
    lib = build.load("propagate")
    fn = lib.propagate_f32 if dtype == torch.float32 else lib.propagate_f64
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        code = fn(
            table.data_ptr(), table.shape[1], par.data_ptr(), xglob.data_ptr(),
            xcurv.data_ptr(), u.data_ptr(), xglob_out.data_ptr(), xcurv_out.data_ptr(),
            B, n_sub, float(sub_dt), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "propagate")
    launches += 1
    return xglob_out, xcurv_out
