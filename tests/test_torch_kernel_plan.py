"""The launch plan of K2/K3 (``kernels/cholesky.py::plan``), which the CUDA
entry points take as it is, and the build's ptxas report.

The plan is pure Python, so its rules are held here on the CPU: every
problem size gets a launch, in shared memory whenever one problem fits a
block's 232,448 bytes and in device memory otherwise, and the paths' shapes
get the teams that ``csrc/cholesky_solve.cu`` is designed around.
"""

import numpy as np
import pytest
import torch

from car_racing_tpu_torch.kernels import build, cholesky as k2, propagate as k1
from car_racing_tpu_torch.ops import dynamics, track


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
def test_plan_takes_every_size(itemsize):
    """n in 1..400 and r in 1..16: no size is refused, shared memory stays
    within the H100's 232,448 bytes a block, and it is chosen whenever one
    problem fits it."""
    for n in range(1, 401):
        for r in range(1, 17):
            p = k2.plan(n, r, itemsize)
            nbytes = k2.problem_elems(n, r) * itemsize
            assert 0 <= p.shared_bytes <= k2.MAX_SHARED_BYTES, (n, r)
            assert p.shared == (nbytes <= k2.MAX_SHARED_BYTES), (n, r)
            if p.shared:
                assert p.shared_bytes >= p.per_block * nbytes and p.scratch_elems == 0
            else:
                assert p.shared_bytes == 0 and p.scratch_elems == k2.problem_elems(n, r)
            assert p.team == (32 if p.shared and n <= k2.WARP_TEAM_MAX_N else k2.BLOCK_TEAM)
            assert p.per_block == 1 or p.team == 32
            assert p.team * p.per_block % 32 == 0 and p.team * p.per_block <= 1024


def test_plan_of_the_paths_shapes():
    # the LMPC QP's Newton systems (K3): a block of 256 threads a problem,
    # 41,888 bytes, under the 48 KB a block has without opting in
    assert k2.plan(68, 8, 8) == k2.Plan(team=256, per_block=1, shared_bytes=41_888,
                                        scratch_elems=0)
    # the corridor sweep's (K2): a warp a problem, four a block
    assert k2.plan(20, 1, 4) == k2.Plan(team=32, per_block=4, shared_bytes=4 * 1_760,
                                        scratch_elems=0)
    # past the old one-warp caps: opted-in shared memory, then device memory
    assert k2.plan(100, 1, 8).shared_bytes == 81_600
    assert k2.plan(130, 1, 4).shared_bytes == 68_640
    assert k2.plan(166, 8, 8).shared_bytes == 232_400
    for n, r in ((167, 8), (180, 1), (180, 8)):
        p = k2.plan(n, r, 8)
        assert not p.shared and p.team == 256 and p.scratch_elems == n * (n | 1) + n * r


@pytest.mark.parametrize("n,r,itemsize", [(0, 1, 8), (5, 0, 8), (5, 1, 2)])
def test_plan_refuses_what_is_not_a_problem(n, r, itemsize):
    with pytest.raises(ValueError, match="no plan"):
        k2.plan(n, r, itemsize)


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121cholesky_solve_kernelIdLb1ELb0EEEvPKT_S3_PS1_S4_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121cholesky_solve_kernelIdLb1ELb0EEEvPKT_S3_PS1_S4_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN58_GLOBAL__N__f61d85_12_propagate_cu_d68a922316propagate_kernelIfEEvPKT_iS3_S3_S3_S3_PS1_S4_iiS1_' for 'sm_90a'
ptxas info    : Function properties for _ZN58_GLOBAL__N__f61d85_12_propagate_cu_d68a922316propagate_kernelIfEEvPKT_iS3_S3_S3_S3_PS1_S4_iiS1_
    40 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 80 registers, 16 bytes smem, 420 bytes cmem[0]
"""


def test_ptxas_summary_reads_each_kernel():
    assert build.ptxas_summary(PTXAS) == [
        {"kernel": "cholesky_solve_kernel<double, true, false>", "stack": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 40, "smem": 0},
        {"kernel": "propagate_kernel<float>", "stack": 40, "spill_stores": 8, "spill_loads": 4,
         "registers": 80, "smem": 16},
    ]


class _OnCard:
    """Reports a CUDA device for a CPU tensor, as a tensor on the card would."""

    def __init__(self, t):
        self._t, self.device = t, torch.device("cuda", 0)
        self.dtype, self.shape = t.dtype, t.shape

    def is_contiguous(self):
        return True


def test_propagate_cuda_tensor_raises_never_plain(monkeypatch):
    """K1's wrapper sends a CUDA state to the kernel's checks and launch; a
    track left on the CPU is refused there, and the plain loop never runs."""
    kw = dict(device="cpu", dtype=torch.float64)
    tr = track.load_track("l_shape", width=1.0, **kw)
    bike = dynamics.BicycleParams.default(**kw)
    x = torch.as_tensor(np.tile([0.8, 0, 0, 0, 1.0, 0], (3, 1)))

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain loop ran for a CUDA tensor")

    monkeypatch.setattr(k1, "plain", no_plain)
    k1.launches = 0
    with pytest.raises(ValueError, match="track is torch.float64 on cpu; K1 needs"):
        k1.propagate(tr, bike, _OnCard(x), _OnCard(x), _OnCard(x[:, :2]))
    assert k1.launches == 0
