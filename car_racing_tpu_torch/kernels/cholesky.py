"""K2: batched SPD solve ``A x = b`` (``csrc/cholesky_solve.cu``).

Replaces ``cholesky_solve_batched`` of car_racing_tpu/ops/pallas_kernels.py:121
(``pl.pallas_call`` at :108, dispatched by ``solve_batched`` at :156).
:func:`solve` launches the kernel for CUDA tensors and runs :func:`plain`
for CPU tensors; ``launches`` counts the kernel launches.

K2 and K3 (:mod:`.cholesky_multi`) are one CUDA kernel, K2 with one
right-hand side.  :func:`plan` chooses its launch for a problem size; the
C entry points take that plan as it is, so what the CPU tests check of it
is what launches on the card.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import build

launches = 0

# The H100's dynamic shared memory a block may opt in to, and the part a
# block gets without opting in.
MAX_SHARED_BYTES = 232_448
DEFAULT_SHARED_BYTES = 48 * 1024
# A warp owns one problem up to this n, a block of BLOCK_TEAM threads above.
WARP_TEAM_MAX_N = 32
BLOCK_TEAM = 256
MAX_WARPS_PER_BLOCK = 4

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@dataclass(frozen=True)
class Plan:
    """How the kernel runs a batch of (n, n) problems with r right-hand sides."""

    team: int  # threads that share one problem: 32 (a warp) or BLOCK_TEAM (a block)
    per_block: int  # problems per block
    shared_bytes: int  # dynamic shared memory per block; 0 in device memory
    scratch_elems: int  # elements of device memory per problem; 0 in shared memory

    @property
    def shared(self) -> bool:
        return self.scratch_elems == 0


def problem_elems(n: int, r: int) -> int:
    """Elements one problem holds while it is solved: the matrix at row
    stride ``n | 1`` and its right-hand sides."""
    return n * (n | 1) + n * r


def plan(n: int, r: int, itemsize: int) -> Plan:
    """The launch for ``n x n`` problems with ``r`` right-hand sides of
    ``itemsize`` bytes.  Every size gets one: in shared memory when a
    problem fits a block's 232,448 bytes, else in device memory."""
    if n < 1 or r < 1 or itemsize not in (4, 8):
        raise ValueError(f"no plan for n = {n}, r = {r}, itemsize = {itemsize}")
    elems = problem_elems(n, r)
    nbytes = elems * itemsize
    if nbytes > MAX_SHARED_BYTES:
        return Plan(team=BLOCK_TEAM, per_block=1, shared_bytes=0, scratch_elems=elems)
    if n > WARP_TEAM_MAX_N:
        return Plan(team=BLOCK_TEAM, per_block=1, shared_bytes=nbytes, scratch_elems=0)
    per_block = MAX_WARPS_PER_BLOCK
    while per_block > 1 and per_block * nbytes > DEFAULT_SHARED_BYTES:
        per_block //= 2
    return Plan(team=32, per_block=per_block, shared_bytes=per_block * nbytes, scratch_elems=0)


def plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """What the JAX package runs off the TPU (``jnp.linalg.cholesky`` +
    ``cho_solve``): a problem whose matrix is not positive definite comes
    back as NaN, as ``jnp.linalg.cholesky`` makes it."""
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)
    return torch.where((info == 0).unsqueeze(-1), x, torch.nan)


def solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A[i] x[i] = b[i]`` for ``A (B, n, n)`` SPD, ``b (B, n)``."""
    global launches
    if A.device.type == "cpu":
        return plain(A, b)
    if A.device.type != "cuda":
        raise ValueError(f"no kernel for device {A.device}")
    if A.dim() != 3 or A.shape[1] != A.shape[2] or tuple(b.shape) != tuple(A.shape[:2]):
        raise ValueError(
            f"K2 takes A (B, n, n) and b (B, n), got {tuple(A.shape)}, {tuple(b.shape)}")
    x = launch(A, b, 1, "K2")
    if A.shape[0]:
        launches += 1
    return x


def launch(A, rhs, r, what, p: Plan | None = None):
    """Check ``A (B, n, n)`` and its right-hand sides ``rhs`` (``B * n * r``
    elements, row-major (B, n, r)), launch the kernel (none for an empty
    batch) and return the solution shaped like ``rhs``.  ``p`` replaces
    :func:`plan`'s launch, to time another team size; the kernel refuses a
    plan that does not fit the problem."""
    dtype, dev = A.dtype, A.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} takes float32 or float64, got {dtype}")
    if rhs.device != dev or rhs.dtype != dtype:
        raise ValueError(f"the right-hand side is {rhs.dtype} on {rhs.device}; "
                         f"{what} needs {dtype} on {dev}")
    if not (A.is_contiguous() and rhs.is_contiguous()):
        raise ValueError(f"{what} takes contiguous tensors")
    Bn, n = A.shape[0], A.shape[1]
    p = p or plan(n, r, A.element_size())
    lib = build.load("cholesky_solve")
    X = torch.empty_like(rhs)
    if Bn == 0:
        return X
    scratch = None if p.shared else torch.empty(Bn, p.scratch_elems, dtype=dtype, device=dev)
    fn = lib.cholesky_solve_f32 if dtype == torch.float32 else lib.cholesky_solve_f64
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        code = fn(A.data_ptr(), rhs.data_ptr(), X.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), Bn, n, r, p.team,
                  p.per_block, p.shared_bytes, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, f"{what} cholesky_solve")
    return X
