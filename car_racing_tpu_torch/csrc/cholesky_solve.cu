// K2 and K3: batched SPD solves, one team of threads per problem.
//
// K2 (cholesky_solve_batched / _cholesky_solve_kernel of
// car_racing_tpu/ops/pallas_kernels.py) solved the interior point's Newton
// systems for a whole batch on the TPU: A (B, n, n), b (B, n) -> x (B, n).
// K3 (cholesky_solve_multi_batched / _cholesky_solve_multi_kernel of the
// same file) is one factorization, then r right-hand sides:
// A (B, n, n), Brhs (B, n, r) -> X (B, n, r); the JAX package reaches it
// from ipm.solve_qp_batch when the QPs have p equality rows (r = 1 + p).
// Both are one kernel here: K2 is K3 with r = 1 (kernels/cholesky.py).
//
// The algorithm is the TPU kernels': a column-by-column Cholesky with
// rank-1 downdates, the diagonal floored at 1e-30 before the reciprocal
// square root, then forward and back substitution dividing by
// max(L_ii, 1e-30).  The TPU's lane-major layout, lane blocks and identity
// padding are not carried over.
//
// What bounds it on an H100: on paper the bytes.  K3 at the LMPC QP's
// (256, 68, 68) with r = 8 in f64 moves 11.7 MB (3.5 us at 3.35 TB/s) and
// does about 47 MFLOP (1.4 us at 34 TFLOP/s of f64 outside the tensor
// cores).  In fact it is the latency of one problem's 3n dependent steps
// (n factorization steps, then n forward and n back substitution steps),
// each ended by a barrier: one problem alone takes about as long as 256
// (the card holds them all at once).  One warp a problem with whole rows a
// lane, as an earlier version of this kernel had it, makes the busiest
// lane run a serial loop of up to n read-modify-writes a step, and fits
// one warp a block under 48 KB.
//
// This design:
// - A team of threads owns one problem: a warp for n <= 32 (several
//   problems a block, __syncwarp between steps), a whole block of 256
//   threads above (one problem a block, __syncthreads).  More threads
//   shorten each thread's share of a step, the latency that bounds it,
//   but lengthen the barrier and, at 256 problems, share the SM with the
//   other block.  The block team is 256: on an H100, 128 and 512 threads
//   take 13-19 % longer at (256, n, n), r = 8, f64, n = 68 and 100
//   (chip_smoke.py, phase k3_team; PERF.md).  kernels/cholesky.py::plan
//   chooses.
// - Column step j downdates the (n-j-1)(n-j)/2 elements of the trailing
//   lower triangle, spread over the team: thread (ty, tx) takes rows
//   j + 1 + ty (mod rows of threads) and in them columns j + 1 + tx (mod
//   threads along a row), a warp along a row in a block team.  Every load
//   comes from column j, which the step never writes, or from the
//   thread's own elements; so nothing races and one barrier ends the step.
//   L[i,j] = a[i,j] * rsqrt(max(a[j,j], 1e-30)) is formed where it is
//   used; the scaled column is stored one step later, when nobody reads
//   it.  A thread loads kRows rows' elements before it stores any of them.
// - The substitutions spread each step's (row, right-hand side) pairs over
//   the team, walked without integer division; the thread that updates
//   the next pivot row divides it at once, so again one barrier a step.
// - Each element sees the same operations in the same order as in the
//   row-per-lane design (downdates in column order, no fused multiply-add
//   under --fmad=false), so the results are bit-identical to it.
// - Memory: the problem lives in shared memory with a row stride of n | 1
//   (odd, so a column's entries fall in distinct banks), its right-hand
//   sides (n, r) beside it.  Above 48 KB a block opts in to dynamic
//   shared memory, up to the H100's 232,448 bytes.  A problem larger than
//   that (f64, r = 8: n >= 167) runs the same kernel, with a block team,
//   on a per-problem copy in device memory (scratch from the wrapper), with
//   64-bit indices.
//   There is no size limit.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float k_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double k_rsqrt(double x) { return rsqrt(x); }
// max(x, lo) that keeps a NaN x, like jnp.maximum in the TPU kernel
template <typename T>
__device__ __forceinline__ T floor_at(T x, T lo) { return x < lo ? lo : x; }

template <bool kBlockTeam>
__device__ __forceinline__ void team_sync() {
  if constexpr (kBlockTeam) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

// Keeps the compiler from moving memory accesses across this point: the
// loads above it are all issued before the stores below it.
__device__ __forceinline__ void loads_before_stores() { asm volatile("" ::: "memory"); }

// A: (B, n, n), Brhs: (B, n, r), X: (B, n, r); all contiguous.  scratch:
// (B, n * (n | 1) + n * r) when the problems live in device memory (block
// teams only), else unused.  Only the lower triangle of A is used.  Index
// is int for offsets inside one problem in shared memory; a problem's
// offset into A, Brhs, X and scratch is always 64-bit.
template <typename T, bool kBlockTeam, bool kShared>
__global__ void cholesky_solve_kernel(const T* __restrict__ A, const T* __restrict__ Brhs,
                                      T* __restrict__ X, T* scratch, int B, int n, int r) {
  using Index = std::conditional_t<kShared, int, long long>;
  // threads along a row of the matrix: a warp in a block team, so that a
  // warp's accesses to a row are contiguous; 8 in a warp team (4 rows)
  constexpr int kRowLanes = kBlockTeam ? 32 : 8;
  constexpr int kRows = 4;   // rows of a thread downdated together
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rank = kBlockTeam ? threadIdx.x : (threadIdx.x & 31);
  const int size = kBlockTeam ? blockDim.x : 32;
  const int slot = kBlockTeam ? 0 : (threadIdx.x >> 5);
  const int prob = kBlockTeam ? blockIdx.x : blockIdx.x * (blockDim.x >> 5) + slot;
  if (prob >= B) return;  // a whole warp team; a block team never leaves (grid = B)
  const int tx = rank % kRowLanes, ty = rank / kRowLanes, row_groups = size / kRowLanes;
  static_assert(kBlockTeam || kShared, "a warp team works in shared memory");
  const Index nn = n, rr = r, ld = n | 1;
  const Index per = nn * ld + nn * rr;
  const long long g = prob;  // the problem's offsets into global memory
  T* a;
  if constexpr (kShared) {
    a = reinterpret_cast<T*>(smem_raw) + slot * per;
  } else {
    a = scratch + g * per;
  }
  T* v = a + nn * ld;  // v[i * r + c]: row i of right-hand side c

  const T* Ap = A + g * n * n;
  const T* Bp = Brhs + g * n * r;
#pragma unroll 4
  for (Index e = rank; e < nn * nn; e += size) a[(e / nn) * ld + e % nn] = Ap[e];
#pragma unroll 4
  for (Index e = rank; e < nn * rr; e += size) v[e] = Bp[e];
  team_sync<kBlockTeam>();

  const T lo = T(1e-30);
  // factorization: column j of L overwrites column j of the lower triangle.
  // Step j downdates a[i][k], j < k <= i, by L[i][j] L[k][j]: thread (ty,
  // tx) takes rows i = j + 1 + ty (mod row_groups), kRows of them at a
  // time, and in them columns k = j + 1 + tx (mod kRowLanes).  The loads
  // of a batch all precede its stores (loads_before_stores), so they can
  // be in flight together; the compiler keeps a load that follows a store
  // to the same array behind it, as it cannot tell the addresses apart.
  T inv_prev = T(0);
  for (Index j = 0; j < nn; ++j) {
    const T inv = k_rsqrt(floor_at(a[j * ld + j], lo));
    if (j > 0) {  // store column j - 1 of L; no step reads it any more
      for (Index i = j - 1 + rank; i < nn; i += size) a[i * ld + j - 1] *= inv_prev;
    }
    for (Index i0 = j + 1 + ty; i0 < nn; i0 += kRows * row_groups) {
      const Index i_max = min(i0 + (kRows - 1) * row_groups, nn - 1);
      T lij[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const Index i = i0 + u * row_groups;
        lij[u] = i < nn ? a[i * ld + j] * inv : T(0);
      }
      for (Index k = j + 1 + tx; k <= i_max; k += kRowLanes) {
        const T akj = a[k * ld + j];
        T old[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const Index i = i0 + u * row_groups;
          old[u] = k <= i && i < nn ? a[i * ld + k] : T(0);
        }
        loads_before_stores();
        const T lkj = akj * inv;
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const Index i = i0 + u * row_groups;
          if (k <= i && i < nn) a[i * ld + k] = old[u] - lij[u] * lkj;
        }
      }
    }
    inv_prev = inv;
    team_sync<kBlockTeam>();
  }
  if (rank == 0) a[(nn - 1) * ld + nn - 1] *= inv_prev;
  team_sync<kBlockTeam>();

  // substitutions: thread rank takes the (row, right-hand side) pairs
  // q * r + c = rank (mod size) of each step, walked without division
  const Index q0 = rank / rr, c0 = rank % rr, q_step = size / rr, c_step = size % rr;
  // forward substitution L Y = Brhs (Y overwrites v), row 0 first
  for (Index c = rank; c < rr; c += size) v[c] /= floor_at(a[0], lo);
  team_sync<kBlockTeam>();
  for (Index j = 0; j + 1 < nn; ++j) {
    const T d_next = floor_at(a[(j + 1) * ld + j + 1], lo);
    for (Index q = q0, c = c0; q < nn - 1 - j;) {
      const Index i = j + 1 + q;
      T w = v[i * rr + c] - a[i * ld + j] * v[j * rr + c];
      if (q == 0) w = w / d_next;
      v[i * rr + c] = w;
      q += q_step;
      c += c_step;
      if (c >= rr) c -= rr, ++q;
    }
    team_sync<kBlockTeam>();
  }
  // back substitution L^T X = Y (X overwrites v), row n - 1 first
  for (Index c = rank; c < rr; c += size) {
    v[(nn - 1) * rr + c] /= floor_at(a[(nn - 1) * ld + nn - 1], lo);
  }
  team_sync<kBlockTeam>();
  for (Index i = nn - 1; i > 0; --i) {
    const T d_next = floor_at(a[(i - 1) * ld + i - 1], lo);
    for (Index k = q0, c = c0; k < i;) {
      T w = v[k * rr + c] - a[i * ld + k] * v[i * rr + c];
      if (k == i - 1) w = w / d_next;
      v[k * rr + c] = w;
      k += q_step;
      c += c_step;
      if (c >= rr) c -= rr, ++k;
    }
    team_sync<kBlockTeam>();
  }
  T* Xp = X + g * n * r;
  for (Index e = rank; e < nn * rr; e += size) Xp[e] = v[e];
}

template <typename T, bool kBlockTeam, bool kShared>
cudaError_t launch_as(const T* A, const T* Brhs, T* X, T* scratch, int B, int n, int r,
                      int threads, int blocks, int smem_bytes, cudaStream_t stream) {
  auto* kernel = cholesky_solve_kernel<T, kBlockTeam, kShared>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem_bytes, stream>>>(A, Brhs, X, scratch, B, n, r);
  return cudaGetLastError();
}

// The launch plan comes from kernels/cholesky.py::plan: team is 32 (a warp
// a problem, per_block problems a block, in shared memory) or the threads
// of a block (one problem a block); smem_bytes is the block's dynamic
// shared memory, 0 when the problems live in scratch.  A plan that does
// not fit its problem is refused with cudaErrorInvalidValue.
template <typename T>
int launch(const T* A, const T* Brhs, T* X, T* scratch, int B, int n, int r, int team,
           int per_block, int smem_bytes, void* stream) {
  const bool block_team = team != 32;
  const long long per_bytes =
      (static_cast<long long>(n) * (n | 1) + static_cast<long long>(n) * r) * sizeof(T);
  const bool shared = scratch == nullptr;
  const bool valid =
      B >= 1 && n >= 1 && r >= 1 && team >= 32 && team % 32 == 0 && team <= 1024 &&
      per_block >= 1 && (!block_team || per_block == 1) && 32 * per_block <= 1024 &&
      (shared ? smem_bytes >= per_block * per_bytes : block_team && smem_bytes == 0);
  if (!valid) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = block_team ? team : 32 * per_block;
  const int blocks = block_team ? B : (B + per_block - 1) / per_block;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (block_team) {
    err = shared ? launch_as<T, true, true>(A, Brhs, X, scratch, B, n, r, threads, blocks,
                                            smem_bytes, st)
                 : launch_as<T, true, false>(A, Brhs, X, scratch, B, n, r, threads, blocks,
                                             smem_bytes, st);
  } else {
    err = launch_as<T, false, true>(A, Brhs, X, scratch, B, n, r, threads, blocks, smem_bytes,
                                    st);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int cholesky_solve_f32(const float* A, const float* Brhs, float* X, float* scratch, int B,
                       int n, int r, int team, int per_block, int smem_bytes, void* stream) {
  return launch<float>(A, Brhs, X, scratch, B, n, r, team, per_block, smem_bytes, stream);
}

int cholesky_solve_f64(const double* A, const double* Brhs, double* X, double* scratch, int B,
                       int n, int r, int team, int per_block, int smem_bytes, void* stream) {
  return launch<double>(A, Brhs, X, scratch, B, n, r, team, per_block, smem_bytes, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
