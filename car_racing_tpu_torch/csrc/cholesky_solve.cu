// K2: batched SPD solve A x = b, one warp per problem.
//
// Replaces cholesky_solve_batched / _cholesky_solve_kernel of
// car_racing_tpu/ops/pallas_kernels.py, the lane-major Pallas kernel that
// solved the interior point's Newton systems for a whole batch on the TPU.
// The algorithm is the same: a column-by-column Cholesky with rank-1
// downdates, the diagonal floored at 1e-30 before the reciprocal square
// root, then forward and back substitution dividing by max(L_ii, 1e-30).
// The TPU's lane-major layout, lane blocks and identity padding are not
// carried over.
//
// Layout: each warp copies its (n, n) matrix into shared memory with a row
// stride of n | 1 (odd, so the 32 lanes of a column access fall in distinct
// banks) and its right-hand side beside it.  Lane i owns rows i, i + 32, ...
// of the factorization and the substitutions; only the lower triangle of A
// is read.
//
// What bounds it on an H100: at the corridor sweep's (256, 20, 20) in f32
// it moves 0.45 MB (0.13 us at 3.35 TB/s) and does about 1.6 MFLOP (under
// 0.03 us at 67 TFLOP/s), so the bytes bound it on paper; in practice the
// time is the latency of the 3n dependent column steps, each a
// shared-memory round trip and a warp barrier.  The design keeps every
// step inside one warp (no block-wide barriers, no global memory between
// steps) and runs the 256 problems side by side in 64 blocks of 4 warps.

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
__host__ __device__ inline size_t smem_per_warp(int n) {
  return (static_cast<size_t>(n) * row_stride(n) + n) * sizeof(T);
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
  T* a = reinterpret_cast<T*>(smem_raw + warp * smem_per_warp<T>(n));
  T* v = a + static_cast<size_t>(n) * ld;

  const T* Ap = A + static_cast<size_t>(prob) * n * n;
  for (int i = lane; i < n * n; i += 32) a[(i / n) * ld + i % n] = Ap[i];
  for (int i = lane; i < n; i += 32) v[i] = b[static_cast<size_t>(prob) * n + i];
  __syncwarp();

  const T floor_ = T(1e-30);
  // factorization: column j of L overwrites column j of the lower triangle
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

template <typename T>
int launch(const T* A, const T* b, T* x, int B, int n, void* stream) {
  const size_t per_warp = smem_per_warp<T>(n);
  if (n < 1 || B < 1 || per_warp > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int warps = kMaxWarps;
  while (warps > 1 && warps * per_warp > kMaxSmem) warps >>= 1;
  const int blocks = (B + warps - 1) / warps;
  cholesky_solve_kernel<T><<<blocks, warps * 32, warps * per_warp,
                             static_cast<cudaStream_t>(stream)>>>(A, b, x, B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest n one warp's shared memory takes, for the wrapper's checks.
int cholesky_solve_max_n(int itemsize) {
  int n = 1;
  while ((static_cast<size_t>(n + 1) * row_stride(n + 1) + n + 1) * itemsize <= kMaxSmem) ++n;
  return n;
}

int cholesky_solve_f32(const float* A, const float* b, float* x, int B, int n, void* stream) {
  return launch<float>(A, b, x, B, n, stream);
}

int cholesky_solve_f64(const double* A, const double* b, double* x, int B, int n,
                       void* stream) {
  return launch<double>(A, b, x, B, n, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
