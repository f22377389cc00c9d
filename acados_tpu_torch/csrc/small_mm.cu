// Batched product of small square matrices, out[m] = X[m] @ Y[m], for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel scratch/bench_smallmm39.py:_mm_kernel (launched
// by pallas_mm), which was written to find the best form of the chain
// model's n = 39 products. It computes the same function in the same
// order: out[i][j] = sum_k X[i][k] * Y[k][j], the sum taken from 0 in
// ascending k, every product and every sum rounded on its own
// (__fmul_rn / __fadd_rn, never contracted into an FMA). The plain
// PyTorch version, acados_tpu_torch/ops/small_mm.py:small_mm_plain, runs
// the same recurrence one eager multiply and one eager add per k, so the
// two agree bit for bit, NaN and infinity included.
//
// Layout: the natural row-major (batch, n, n) tensors, read once and
// written once. On the TPU the batch sat on the 128 lanes ((n, n, B) after
// a transpose, padded to a multiple of 128); here a block takes whole
// matrix pairs and masks the ragged end of the batch itself.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the
// tensor cores), at the chain's shape (10240, 39, 39) float32:
//   bytes: 3 * 10240 * 1521 * 4 B = 186.9 MB -> 55.8 us
//   flops: 2 n^3 = 118.6 kFLOP a pair, 1.215 GFLOP -> 18 us (and twice
//          that for separate multiply and add instructions: 36 us)
// so a launch is bound by bytes, with the arithmetic close behind.
//
// Design against that: each pair is staged in shared memory (row stride
// n | 1), so device memory sees one coalesced read of X and Y and one
// coalesced write of the product. The threads of a block own output
// entries (e = tid, tid + blockDim, ...), consecutive threads on
// consecutive columns, so a warp reads one X entry as a broadcast and a
// row of Y across the banks. At small n a block holds several pairs
// (kThreads / n^2 of them) so that its threads have work. No tensor
// cores: the product is float32 with TF32 off, and float64. Register
// blocking, wgmma and TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

__host__ __device__ __forceinline__ int row_stride(int n) { return n | 1; }

// shared memory of one pair: X and Y, each n rows of row_stride(n)
template <typename T>
__host__ __device__ __forceinline__ size_t pair_smem(int n) {
  return static_cast<size_t>(2 * n * row_stride(n)) * sizeof(T);
}

template <typename T>
__global__ void small_mm_kernel(const T* __restrict__ X,
                                const T* __restrict__ Y, T* __restrict__ out,
                                long long batch, int n, int ppb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);
  const int ld = row_stride(n);
  const int nn = n * n;
  const long long first = static_cast<long long>(blockIdx.x) * ppb;
  const long long left = batch - first;
  const int pairs = left < ppb ? static_cast<int>(left) : ppb;
  const int total = pairs * nn;
  const long long base = first * nn;

  // stage X and Y: pair p at S + p * 2 n ld, X rows then Y rows
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int p = e / nn, r = e - p * nn;
    const int i = r / n, j = r - i * n;
    T* Sp = S + p * 2 * n * ld;
    Sp[i * ld + j] = X[base + e];
    Sp[(n + i) * ld + j] = Y[base + e];
  }
  __syncthreads();

  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int p = e / nn, r = e - p * nn;
    const int i = r / n, j = r - i * n;
    const T* xs = S + p * 2 * n * ld + i * ld;
    const T* ys = S + (p * 2 + 1) * n * ld + j;
    T acc = T(0);
    for (int k = 0; k < n; ++k) acc = add(acc, mul(xs[k], ys[k * ld]));
    out[base + e] = acc;
  }
}

template <typename T>
int launch(const T* X, const T* Y, T* out, long long batch, int n,
           void* stream_ptr) {
  if (n < 1 || n > kMaxN || batch < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  int ppb = kThreads / (n * n);
  if (ppb < 1) ppb = 1;
  const size_t smem = pair_smem<T>(n) * ppb;
  if (smem > kDefaultSmem) {
    // past the default 48 KB only with one pair a block: float64 at
    // n >= 56
    const cudaError_t err = cudaFuncSetAttribute(
        small_mm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (batch + ppb - 1) / ppb;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  small_mm_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                       stream>>>(X, Y, out, batch, n, ppb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int small_mm_f32(const float* X, const float* Y, float* out,
                            long long batch, int n, void* stream) {
  return launch<float>(X, Y, out, batch, n, stream);
}

extern "C" int small_mm_f64(const double* X, const double* Y, double* out,
                            long long batch, int n, void* stream) {
  return launch<double>(X, Y, out, batch, n, stream);
}
