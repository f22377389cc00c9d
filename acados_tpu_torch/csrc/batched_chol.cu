// Batched Cholesky factor and solve of small SPD matrices, for NVIDIA
// Hopper (sm_90a).
//
// Replaces three TPU kernels of acados_tpu/ops/batched_chol.py:
//   chol_factor        <- _chol_kernel          (K2, chol_factor_batched)
//   chol_solve         <- _solve_kernel         (K3, chol_solve_batched)
//   chol_factor_solve  <- _factor_solve_kernel  (K4, chol_factor_solve_batched)
// and computes what they compute, in their order:
//   factor: for each column j, s = H[i][j] - sum_{k<j} L[i][k] L[j][k]
//           (k ascending), L[j][j] = sqrt(s_jj), L[i][j] = s_ij * (1/L[j][j]);
//           the upper triangle of L is written as 0;
//   solve:  forward L y = b, then back L' x = y, each entry's sum
//           subtracted in ascending k.
// A matrix whose pivot s_jj is <= 0 or not finite comes back NaN in every
// entry (and so does its x). Products and differences are rounded one by
// one (__fmul_rn / __fsub_rn, never contracted into an FMA), and sqrt and
// division are the IEEE ones, so the kernels repeat the arithmetic of the
// plain PyTorch versions in acados_tpu_torch/ops/batched_chol.py
// operation for operation.
//
// Layout: the natural row-major (batch, n, n) and (batch, n) tensors,
// read once and written once. On the TPU the batch sat on the 128 lanes
// ((n, n, B) after a transpose); here a matrix maps onto one warp.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32), at the
// dense IPM's shape (4096, 24, 24) float32, counting the 300 entries of a
// lower triangle read (the input's upper triangle is never read) and
// every entry written:
//   factor bytes: 4096 * (300 + 576) * 4 B = 14.4 MB -> 4.3 us;
//          flops: n^3/3 + n^2/2 + 2n ~ 4.9 kFLOP a matrix, 20 MFLOP -> 0.3 us;
//   solve  bytes: 4096 * (300 + 2 * 24) * 4 B = 5.7 MB -> 1.7 us;
//   fused  bytes: 4096 * (300 + 576 + 2 * 24) * 4 B = 15.1 MB -> 4.5 us;
// so every launch is bound by bytes (a few microseconds), and by the
// latency of its n-step dependent recurrence at this batch.
//
// Design against that: each matrix stays in shared memory for the whole
// recurrence, so device memory sees one coalesced read of the lower
// triangle and one coalesced write. One warp per matrix:
//   - factor: column by column, lanes own the rows i >= j (a second row
//     when n > 32) and run their sums serially in k; the pivot is
//     broadcast with __shfl_sync and its test is warp-uniform, so a bad
//     pivot stops the warp and the store writes NaN;
//   - forward substitution: lanes own rows, column i updates every row
//     below it (ascending k per entry, as in the plain version);
//   - back substitution: one lane, entry by entry, since each entry's
//     ascending sum starts with the entry solved just before it;
//   - the row stride in shared memory is odd, so lanes reading a column
//     hit 32 different banks.
// Making it fast (several matrices per warp at small n, a parallel back
// substitution, keeping Hb on chip across the IPM's predictor and
// corrector) is later work.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 64;
constexpr int kMaxWarps = 4;
constexpr size_t kSmemCap = 48 * 1024;  // no opt-in above the default

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() { return __int_as_float(0x7fc00000); }
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// largest finite value: a pivot above it is infinite
__device__ __forceinline__ bool pivot_ok(float p) { return p > 0.0f && p <= 3.40282347e+38f; }
__device__ __forceinline__ bool pivot_ok(double p) {
  return p > 0.0 && p <= 1.7976931348623157e+308;
}

__host__ __device__ __forceinline__ int row_stride(int n) { return n | 1; }

// Shared memory of one warp: the n x n matrix (odd row stride) and an
// n-vector.
template <typename T>
__host__ __device__ __forceinline__ size_t warp_smem(int n) {
  return static_cast<size_t>(n * row_stride(n) + n) * sizeof(T);
}

template <typename T>
__device__ __forceinline__ void load_lower(const T* __restrict__ g, T* S,
                                           int n, int ld, int lane) {
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e - (e / n) * n;
    if (j <= i) S[i * ld + j] = g[e];
  }
}

// Factor the matrix in S in place (lower triangle). Returns false, the
// same in every lane, if a pivot is <= 0 or not finite.
template <typename T>
__device__ bool factor_warp(T* S, int n, int ld, int lane) {
  for (int j = 0; j < n; ++j) {
    // rows i0 = j + lane and i1 = j + lane + 32 of column j
    const int i0 = j + lane, i1 = i0 + 32;
    T s0 = T(0), s1 = T(0);
    if (i0 < n) {
      s0 = S[i0 * ld + j];
      for (int k = 0; k < j; ++k) s0 = sub(s0, mul(S[i0 * ld + k], S[j * ld + k]));
    }
    if (i1 < n) {
      s1 = S[i1 * ld + j];
      for (int k = 0; k < j; ++k) s1 = sub(s1, mul(S[i1 * ld + k], S[j * ld + k]));
    }
    const T piv = __shfl_sync(kFull, s0, 0);  // lane 0 holds row j
    if (!pivot_ok(piv)) return false;  // also false for NaN
    const T d = sqrt_rn(piv);
    const T inv = dvd(T(1), d);
    if (i0 < n) S[i0 * ld + j] = (lane == 0) ? d : mul(s0, inv);
    if (i1 < n) S[i1 * ld + j] = mul(s1, inv);
    __syncwarp();
  }
  return true;
}

// Solve L L' x = b with L in S and b in v; x overwrites v.
template <typename T>
__device__ void solve_warp(const T* S, T* v, int n, int ld, int lane) {
  // forward: lane owns rows lane and lane + 32
  T r0 = lane < n ? v[lane] : T(0);
  T r1 = lane + 32 < n ? v[lane + 32] : T(0);
  __syncwarp();
  for (int i = 0; i < n; ++i) {
    const int owner = i & 31;
    const T yi = __shfl_sync(kFull, dvd(i < 32 ? r0 : r1, S[i * ld + i]),
                             owner);
    if (lane == owner) v[i] = yi;
    if (lane > i && lane < n) r0 = sub(r0, mul(S[lane * ld + i], yi));
    if (lane + 32 > i && lane + 32 < n) {
      r1 = sub(r1, mul(S[(lane + 32) * ld + i], yi));
    }
  }
  __syncwarp();
  // back: x_i = (y_i - sum_{k>i} L[k][i] x_k) / L[i][i], k ascending
  if (lane == 0) {
    for (int i = n - 1; i >= 0; --i) {
      T s = v[i];
      for (int k = i + 1; k < n; ++k) s = sub(s, mul(S[k * ld + i], v[k]));
      v[i] = dvd(s, S[i * ld + i]);
    }
  }
  __syncwarp();
}

template <typename T>
__device__ void store_lower(T* __restrict__ g, const T* S, int n, int ld,
                            int lane, bool ok) {
  const T nan = quiet_nan<T>();
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e - (e / n) * n;
    g[e] = !ok ? nan : (j <= i ? S[i * ld + j] : T(0));
  }
}

enum class Op { kFactor, kSolve, kFactorSolve };

// One warp per matrix; `wpb` warps a block, each with its own slice of
// the dynamic shared memory.
template <typename T, Op OP>
__global__ void chol_kernel(const T* __restrict__ M, const T* __restrict__ b,
                            T* __restrict__ x, T* __restrict__ L,
                            long long batch, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long m = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + w;
  if (m >= batch) return;  // the ragged edge: the whole warp leaves
  const int ld = row_stride(n);
  T* S = reinterpret_cast<T*>(smem_raw + w * warp_smem<T>(n));
  T* v = S + n * ld;
  const long long nn = static_cast<long long>(n) * n;

  load_lower(M + m * nn, S, n, ld, lane);
  if (OP != Op::kFactor) {
    for (int i = lane; i < n; i += 32) v[i] = b[m * n + i];
  }
  __syncwarp();
  bool ok = true;
  if (OP != Op::kSolve) ok = factor_warp(S, n, ld, lane);
  __syncwarp();
  if (OP != Op::kFactor) {
    if (ok) solve_warp(S, v, n, ld, lane);
    const T nan = quiet_nan<T>();
    for (int i = lane; i < n; i += 32) x[m * n + i] = ok ? v[i] : nan;
  }
  if (OP != Op::kSolve) store_lower(L + m * nn, S, n, ld, lane, ok);
}

template <typename T, Op OP>
int launch(const T* M, const T* b, T* x, T* L, long long batch, int n,
           void* stream_ptr) {
  if (n < 1 || n > kMaxN || batch < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const size_t per_warp = warp_smem<T>(n);
  int wpb = static_cast<int>(kSmemCap / per_warp);
  wpb = wpb < 1 ? 1 : (wpb > kMaxWarps ? kMaxWarps : wpb);
  const long long blocks = (batch + wpb - 1) / wpb;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  chol_kernel<T, OP><<<static_cast<unsigned>(blocks), 32 * wpb,
                       per_warp * wpb, stream>>>(M, b, x, L, batch, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int chol_factor_f32(const float* H, float* L, long long batch,
                               int n, void* stream) {
  return launch<float, Op::kFactor>(H, nullptr, nullptr, L, batch, n, stream);
}

extern "C" int chol_factor_f64(const double* H, double* L, long long batch,
                               int n, void* stream) {
  return launch<double, Op::kFactor>(H, nullptr, nullptr, L, batch, n, stream);
}

extern "C" int chol_solve_f32(const float* L, const float* b, float* x,
                              long long batch, int n, void* stream) {
  return launch<float, Op::kSolve>(L, b, x, nullptr, batch, n, stream);
}

extern "C" int chol_solve_f64(const double* L, const double* b, double* x,
                              long long batch, int n, void* stream) {
  return launch<double, Op::kSolve>(L, b, x, nullptr, batch, n, stream);
}

extern "C" int chol_factor_solve_f32(const float* H, const float* b, float* x,
                                     float* L, long long batch, int n,
                                     void* stream) {
  return launch<float, Op::kFactorSolve>(H, b, x, L, batch, n, stream);
}

extern "C" int chol_factor_solve_f64(const double* H, const double* b,
                                     double* x, double* L, long long batch,
                                     int n, void* stream) {
  return launch<double, Op::kFactorSolve>(H, b, x, L, batch, n, stream);
}
