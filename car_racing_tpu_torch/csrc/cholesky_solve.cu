// K2 and K3: batched SPD solves, one warp per problem.
//
// K2 (cholesky_solve_kernel) replaces cholesky_solve_batched /
// _cholesky_solve_kernel of car_racing_tpu/ops/pallas_kernels.py, the
// lane-major Pallas kernel that solved the interior point's Newton systems
// for a whole batch on the TPU: A (B, n, n), b (B, n) -> x (B, n).
//
// K3 (cholesky_solve_multi_kernel) replaces cholesky_solve_multi_batched /
// _cholesky_solve_multi_kernel of the same file: one factorization, then r
// right-hand sides, A (B, n, n), Brhs (B, n, r) -> X (B, n, r).  The JAX
// package reaches it from ipm.solve_qp_batch when the QPs have p equality
// rows (r = 1 + p, the block-eliminated KKT step).
//
// The algorithm of both is the TPU kernels': a column-by-column Cholesky
// with rank-1 downdates, the diagonal floored at 1e-30 before the
// reciprocal square root, then forward and back substitution dividing by
// max(L_ii, 1e-30).  The TPU's lane-major layout, lane blocks and identity
// padding are not carried over.  Both kernels share the factorization
// (factor below), so K3 factors exactly as K2 does.
//
// Layout: each warp copies its (n, n) matrix into shared memory with a row
// stride of n | 1 (odd, so the 32 lanes of a column access fall in distinct
// banks) and its right-hand sides beside it, one contiguous vector of n per
// right-hand side.  Lane i owns rows i, i + 32, ... of the factorization;
// only the lower triangle of A is read.  K3's substitutions spread the
// (row, right-hand side) pairs of each column step over the lanes, so the r
// right-hand sides take the 2n dependent steps of one, not 2nr.
//
// What bounds them on an H100: on paper the bytes.  K2 at the corridor
// sweep's (256, 20, 20) in f32 moves 0.45 MB (0.13 us at 3.35 TB/s) and
// does about 1 MFLOP.  K3 at the LMPC QP's (256, 68, 68) with r = 8 in f64
// moves 11.7 MB (3.5 us) and does about 47 MFLOP (1.4 us at 34 TFLOP/s of
// f64 outside the tensor cores).  In practice the time is the latency of
// the 3n dependent column steps, each a shared-memory round trip and a
// warp barrier, with about n^2 / 64 downdates per lane in the early
// columns.  The design keeps every step inside one warp (no block-wide
// barriers, no global memory between steps) and runs the problems side by
// side: up to 4 warps a block under the 48 KB of static-size shared memory.
// K3's f64 LMPC shape needs (68 * 69 + 8 * 68) * 8 = 41,888 bytes a warp,
// so it runs one warp a block; a size that does not fit 48 KB in one warp
// is refused (the wrapper raises before the launch).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float k_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double k_rsqrt(double x) { return rsqrt(x); }
// max(x, lo) that keeps a NaN x, like jnp.maximum in the TPU kernel
template <typename T>
__device__ __forceinline__ T floor_at(T x, T lo) { return x < lo ? lo : x; }

constexpr int kMaxWarps = 4;
constexpr size_t kMaxSmem = 48 * 1024;

__host__ __device__ inline int row_stride(int n) { return n | 1; }

template <typename T>
__host__ __device__ inline size_t smem_per_warp(int n, int r) {
  return (static_cast<size_t>(n) * row_stride(n) + static_cast<size_t>(r) * n) * sizeof(T);
}

// Cholesky factorization of the warp's matrix in shared memory (row stride
// ld): column j of L overwrites column j of the lower triangle.
template <typename T>
__device__ void factor(T* a, int n, int ld, int lane) {
  const T floor_ = T(1e-30);
  for (int j = 0; j < n; ++j) {
    const T inv = k_rsqrt(floor_at(a[j * ld + j], floor_));
    __syncwarp();
    for (int i = j + lane; i < n; i += 32) a[i * ld + j] *= inv;
    __syncwarp();
    for (int i = j + 1 + lane; i < n; i += 32) {
      const T lij = a[i * ld + j];
      for (int k = j + 1; k <= i; ++k) a[i * ld + k] -= lij * a[k * ld + j];
    }
    __syncwarp();
  }
}

// A: (B, n, n), b: (B, n), x: (B, n); all contiguous.
template <typename T>
__global__ void cholesky_solve_kernel(const T* __restrict__ A, const T* __restrict__ b,
                                      T* __restrict__ x, int B, int n) {
  extern __shared__ unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int prob = blockIdx.x * (blockDim.x >> 5) + warp;
  if (prob >= B) return;  // only warp-level barriers below
  const int ld = row_stride(n);
  T* a = reinterpret_cast<T*>(smem_raw + warp * smem_per_warp<T>(n, 1));
  T* v = a + static_cast<size_t>(n) * ld;

  const T* Ap = A + static_cast<size_t>(prob) * n * n;
  for (int i = lane; i < n * n; i += 32) a[(i / n) * ld + i % n] = Ap[i];
  for (int i = lane; i < n; i += 32) v[i] = b[static_cast<size_t>(prob) * n + i];
  __syncwarp();

  const T floor_ = T(1e-30);
  factor(a, n, ld, lane);
  // forward substitution L y = b (y overwrites v)
  for (int j = 0; j < n; ++j) {
    const T yj = v[j] / floor_at(a[j * ld + j], floor_);
    __syncwarp();
    for (int i = j + 1 + lane; i < n; i += 32) v[i] -= a[i * ld + j] * yj;
    if (lane == 0) v[j] = yj;
    __syncwarp();
  }
  // back substitution L^T x = y (x overwrites v)
  for (int i = n - 1; i >= 0; --i) {
    const T xi = v[i] / floor_at(a[i * ld + i], floor_);
    __syncwarp();
    for (int k = lane; k < i; k += 32) v[k] -= a[i * ld + k] * xi;
    if (lane == 0) v[i] = xi;
    __syncwarp();
  }
  for (int i = lane; i < n; i += 32) x[static_cast<size_t>(prob) * n + i] = v[i];
}

// A: (B, n, n), Brhs: (B, n, r), X: (B, n, r); all contiguous.
template <typename T>
__global__ void cholesky_solve_multi_kernel(const T* __restrict__ A, const T* __restrict__ Brhs,
                                            T* __restrict__ X, int B, int n, int r) {
  extern __shared__ unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int prob = blockIdx.x * (blockDim.x >> 5) + warp;
  if (prob >= B) return;  // only warp-level barriers below
  const int ld = row_stride(n);
  T* a = reinterpret_cast<T*>(smem_raw + warp * smem_per_warp<T>(n, r));
  T* v = a + static_cast<size_t>(n) * ld;  // v[c * n + i]: row i of right-hand side c

  const T* Ap = A + static_cast<size_t>(prob) * n * n;
  const T* Bp = Brhs + static_cast<size_t>(prob) * n * r;
  for (int i = lane; i < n * n; i += 32) a[(i / n) * ld + i % n] = Ap[i];
  for (int i = lane; i < n * r; i += 32) v[(i % r) * n + i / r] = Bp[i];
  __syncwarp();

  const T floor_ = T(1e-30);
  factor(a, n, ld, lane);
  // forward substitution L Y = Brhs (Y overwrites v)
  for (int j = 0; j < n; ++j) {
    const T d = floor_at(a[j * ld + j], floor_);
    for (int c = lane; c < r; c += 32) v[c * n + j] /= d;
    __syncwarp();
    for (int t = lane; t < (n - 1 - j) * r; t += 32) {
      const int i = j + 1 + t / r, c = t % r;
      v[c * n + i] -= a[i * ld + j] * v[c * n + j];
    }
    __syncwarp();
  }
  // back substitution L^T X = Y (X overwrites v)
  for (int i = n - 1; i >= 0; --i) {
    const T d = floor_at(a[i * ld + i], floor_);
    for (int c = lane; c < r; c += 32) v[c * n + i] /= d;
    __syncwarp();
    for (int t = lane; t < i * r; t += 32) {
      const int k = t / r, c = t % r;
      v[c * n + k] -= a[i * ld + k] * v[c * n + i];
    }
    __syncwarp();
  }
  T* Xp = X + static_cast<size_t>(prob) * n * r;
  for (int i = lane; i < n * r; i += 32) Xp[i] = v[(i % r) * n + i / r];
}

// Warps per block: as many as the shared memory takes, at most kMaxWarps.
int warps_for(size_t per_warp) {
  int warps = kMaxWarps;
  while (warps > 1 && warps * per_warp > kMaxSmem) warps >>= 1;
  return warps;
}

template <typename T>
int launch(const T* A, const T* b, T* x, int B, int n, void* stream) {
  const size_t per_warp = smem_per_warp<T>(n, 1);
  if (n < 1 || B < 1 || per_warp > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = warps_for(per_warp);
  const int blocks = (B + warps - 1) / warps;
  cholesky_solve_kernel<T><<<blocks, warps * 32, warps * per_warp,
                             static_cast<cudaStream_t>(stream)>>>(A, b, x, B, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_multi(const T* A, const T* Brhs, T* X, int B, int n, int r, void* stream) {
  const size_t per_warp = smem_per_warp<T>(n, r);
  if (n < 1 || r < 1 || B < 1 || per_warp > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int warps = warps_for(per_warp);
  const int blocks = (B + warps - 1) / warps;
  cholesky_solve_multi_kernel<T><<<blocks, warps * 32, warps * per_warp,
                                   static_cast<cudaStream_t>(stream)>>>(A, Brhs, X, B, n, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest n one warp's shared memory takes, for K2's wrapper.
int cholesky_solve_max_n(int itemsize) {
  int n = 1;
  while ((static_cast<size_t>(n + 1) * row_stride(n + 1) + n + 1) * itemsize <= kMaxSmem) ++n;
  return n;
}

// Whether one warp's shared memory takes an (n, n) matrix and r right-hand
// sides, for K3's wrapper.
int cholesky_solve_multi_fits(int n, int r, int itemsize) {
  return n >= 1 && r >= 1 &&
         (static_cast<size_t>(n) * row_stride(n) + static_cast<size_t>(r) * n) * itemsize <=
             kMaxSmem;
}

int cholesky_solve_f32(const float* A, const float* b, float* x, int B, int n, void* stream) {
  return launch<float>(A, b, x, B, n, stream);
}

int cholesky_solve_f64(const double* A, const double* b, double* x, int B, int n,
                       void* stream) {
  return launch<double>(A, b, x, B, n, stream);
}

int cholesky_solve_multi_f32(const float* A, const float* Brhs, float* X, int B, int n, int r,
                             void* stream) {
  return launch_multi<float>(A, Brhs, X, B, n, r, stream);
}

int cholesky_solve_multi_f64(const double* A, const double* Brhs, double* X, int B, int n,
                             int r, void* stream) {
  return launch_multi<double>(A, Brhs, X, B, n, r, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
