// K1: one control period of the dynamic bicycle model, two lanes per vehicle.
//
// Replaces propagate_fused / _prop_kernel_body of
// car_racing_tpu/ops/pallas_kernels.py (the Pallas kernel that ran one
// vehicle per call on the TPU, with fleets vmapped over it).  This kernel
// takes a (B,) batch of vehicles and runs the n_sub explicit-Euler substeps
// of each in registers, looking its curvature up again at every substep in
// the segment table, which sits in shared memory.
//
// What bounds it on an H100: neither bytes nor operations.  At B = 256 it
// reads and writes about 27 KB (f32) and does about 2 MFLOP, under 0.1 us
// of either; the time is the latency of a chain of n_sub = 100 dependent
// substeps.  With one thread per vehicle, that thread ran a whole substep:
// the wrap, a segment search that stopped at the first match, two tire
// chains (atan2, atan, sin), sin and cos of epsi and of psi, and four
// divisions, one after another.  The libm calls branch (range reduction), so the scheduler could
// not interleave the independent parts, and a substep cost the sum of them
// all (about 1.5 us in f32).
//
// This design runs those independent parts side by side:
// - Two neighbouring lanes own a vehicle.  Lane 0 runs the front tire chain
//   and sin/cos of epsi, lane 1 the rear tire chain and sin/cos of psi.
//   Both run the same instructions on their own data, so the warp does not
//   diverge, and a substep's critical path is one tire chain and one
//   sin/cos pair instead of two of each.  Three __shfl_xor_sync calls
//   exchange the results; both lanes then make the same state update, so
//   both hold the whole state and no further exchange is needed.
// - The segment search has no early exit: it looks at every segment from
//   the last to the first and keeps the lowest match, loads and compares
//   with no branch between them.
// - A block is one warp (16 vehicles), so B = 256 spreads over 16 SMs, one
//   warp to a scheduler; B = 1 is one block with one working lane pair.
// Every value is computed by the same operations, in the same order and
// with the same libm calls as in the plain loop (kernels/propagate.py::plain
// with --fmad=false), so the kernel still matches it bit for bit.
//
// Semantics match the plain loop and the JAX scan: s wraps by floor-mod,
// the first segment with s0 <= s_w < hi wins and segment 0 when none does,
// and one velocity set is shared by xcurv and xglob (the input xglob's vx,
// vy, wz are never read).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float k_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double k_atan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float k_atan(float x) { return atanf(x); }
__device__ __forceinline__ double k_atan(double x) { return atan(x); }
__device__ __forceinline__ float k_sin(float x) { return sinf(x); }
__device__ __forceinline__ double k_sin(double x) { return sin(x); }
__device__ __forceinline__ float k_cos(float x) { return cosf(x); }
__device__ __forceinline__ double k_cos(double x) { return cos(x); }
__device__ __forceinline__ float k_fmod(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double k_fmod(double a, double b) { return fmod(a, b); }

constexpr int kLanes = 2;     // per vehicle: front tire + epsi, rear tire + psi
constexpr int kThreads = 32;  // one warp a block
constexpr unsigned kFull = 0xffffffffu;

// table: (3, n_seg) rows [s0, s0 + seg_len + S_TOL, curv]
// par:   (11,) [m, lf, lr, Iz, Df, Cf, Bf, Dr, Cr, Br, lap_length]
// xglob, xcurv, xglob_out, xcurv_out: (B, 6); u: (B, 2); all contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads) propagate_kernel(
    const T* __restrict__ table, int n_seg, const T* __restrict__ par,
    const T* __restrict__ xglob, const T* __restrict__ xcurv, const T* __restrict__ u,
    T* __restrict__ xglob_out, T* __restrict__ xcurv_out, int B, int n_sub, T dt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tbl = reinterpret_cast<T*>(smem_raw);
  for (int i = threadIdx.x; i < 3 * n_seg; i += blockDim.x) tbl[i] = table[i];
  __syncthreads();
  const T* seg_lo = tbl;
  const T* seg_hi = tbl + n_seg;
  const T* seg_curv = tbl + 2 * n_seg;

  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const bool front = gid % kLanes == 0;
  // every lane stays for the shuffles: a pair past the batch runs the last
  // vehicle again and stores nothing
  const int b = min(gid / kLanes, B - 1);

  const T m = par[0], lf = par[1], lr = par[2], Iz = par[3];
  const T Df = par[4], Cf = par[5], Bf = par[6];
  const T Dr = par[7], Cr = par[8], Br = par[9];
  const T lap = par[10];
  const T D = front ? Df : Dr, C = front ? Cf : Cr, Bt = front ? Bf : Br;

  T vx = xcurv[6 * b + 0], vy = xcurv[6 * b + 1], wz = xcurv[6 * b + 2];
  T epsi = xcurv[6 * b + 3], s = xcurv[6 * b + 4], ey = xcurv[6 * b + 5];
  T psi = xglob[6 * b + 3], X = xglob[6 * b + 4], Y = xglob[6 * b + 5];
  const T delta = u[2 * b + 0], a = u[2 * b + 1];
  const T sin_d = k_sin(delta), cos_d = k_cos(delta);

  for (int k = 0; k < n_sub; ++k) {
    // floor-mod wrap (torch.remainder / jnp.mod), then first-match lookup
    T s_w = k_fmod(s, lap);
    if (s_w != T(0) && ((s_w < T(0)) != (lap < T(0)))) s_w += lap;
    T curv = seg_curv[0];
    for (int i = n_seg - 1; i >= 0; --i) {
      const T c_i = seg_curv[i];
      if ((s_w >= seg_lo[i]) & (s_w < seg_hi[i])) curv = c_i;
    }

    // this lane's tire: alpha_f = delta - atan2(vy + lf wz, vx) on lane 0,
    // alpha_r = -atan2(vy - lr wz, vx) on lane 1
    const T ang = k_atan2(front ? vy + lf * wz : vy - lr * wz, vx);
    const T alpha = front ? delta - ang : -ang;
    const T F = T(2) * D * k_sin(C * k_atan(Bt * alpha));
    // this lane's angle: epsi on lane 0, psi on lane 1
    const T th = front ? epsi : psi;
    const T sin_th = k_sin(th), cos_th = k_cos(th);
    const T F_o = __shfl_xor_sync(kFull, F, 1);
    const T sin_o = __shfl_xor_sync(kFull, sin_th, 1);
    const T cos_o = __shfl_xor_sync(kFull, cos_th, 1);
    const T Fyf = front ? F : F_o, Fyr = front ? F_o : F;
    const T sin_e = front ? sin_th : sin_o, cos_e = front ? cos_th : cos_o;
    const T sin_p = front ? sin_o : sin_th, cos_p = front ? cos_o : cos_th;

    const T dvx = a - Fyf * sin_d / m + wz * vy;
    const T dvy = (Fyf * cos_d + Fyr) / m - wz * vx;
    const T dwz = (lf * Fyf * cos_d - lr * Fyr) / Iz;

    const T den = T(1) - curv * ey;
    const T s_dot = (vx * cos_e - vy * sin_e) / den;

    const T vx_n = vx + dt * dvx;
    const T vy_n = vy + dt * dvy;
    const T wz_n = wz + dt * dwz;
    epsi = epsi + dt * (wz - s_dot * curv);
    s = s + dt * s_dot;
    ey = ey + dt * (vx * sin_e + vy * cos_e);
    const T psi_n = psi + dt * wz;
    X = X + dt * (vx * cos_p - vy * sin_p);
    Y = Y + dt * (vx * sin_p + vy * cos_p);
    psi = psi_n;
    vx = vx_n;
    vy = vy_n;
    wz = wz_n;
  }

  if (gid / kLanes >= B) return;
  if (front) {
    T* xc = xcurv_out + 6 * b;
    xc[0] = vx; xc[1] = vy; xc[2] = wz; xc[3] = epsi; xc[4] = s; xc[5] = ey;
  } else {
    T* xg = xglob_out + 6 * b;
    xg[0] = vx; xg[1] = vy; xg[2] = wz; xg[3] = psi; xg[4] = X; xg[5] = Y;
  }
}

template <typename T>
int launch(const T* table, int n_seg, const T* par, const T* xglob, const T* xcurv,
           const T* u, T* xglob_out, T* xcurv_out, int B, int n_sub, double dt,
           void* stream) {
  if (B < 1 || n_seg < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (kLanes * B + kThreads - 1) / kThreads;
  const size_t smem = 3 * static_cast<size_t>(n_seg) * sizeof(T);
  propagate_kernel<T><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      table, n_seg, par, xglob, xcurv, u, xglob_out, xcurv_out, B, n_sub, static_cast<T>(dt));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int propagate_f32(const float* table, int n_seg, const float* par, const float* xglob,
                  const float* xcurv, const float* u, float* xglob_out, float* xcurv_out,
                  int B, int n_sub, double dt, void* stream) {
  return launch<float>(table, n_seg, par, xglob, xcurv, u, xglob_out, xcurv_out, B, n_sub,
                       dt, stream);
}

int propagate_f64(const double* table, int n_seg, const double* par, const double* xglob,
                  const double* xcurv, const double* u, double* xglob_out, double* xcurv_out,
                  int B, int n_sub, double dt, void* stream) {
  return launch<double>(table, n_seg, par, xglob, xcurv, u, xglob_out, xcurv_out, B, n_sub,
                        dt, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
