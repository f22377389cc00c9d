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
// two agree bit for bit, NaN and infinity included. No tensor cores: the
// product is float32 with TF32 off, or float64, and the separate rounding
// is the contract.
//
// What bounds it on an H100 SXM at the chain's shape (10240, 39, 39)
// float32, counted for this design:
//   bytes: 3 * 10240 * 1521 * 4 B = 186.9 MB at 3.35 TB/s -> 55.8 us
//   FP instructions: a multiply and an add a step, 2 B n NP^2 = 1.278 G
//          lane instructions with the padding (2 B n^3 = 1.215 G without);
//          132 SMs issue 128 lanes a clock: ~38 us at 1.98 GHz
//   shared-memory loads: 2 16-byte loads a thread a step, 2 n (NP/4)^2 =
//          7,800 a pair, 80 M over the batch; a warp's Y load spans 10
//          tiles (2 wavefronts) and its X load at most 4 broadcast
//          addresses (1), ~3.8 M wavefronts: ~14 us. The copies' 4-byte
//          shared stores add ~2.4 M (X's transposed ones 4-way).
// No one of these reaches the bytes' 55.8 us: the copies and the products
// share each SM's issue slots and load/store path.
//
// Design against that:
// - Register tiles. n is padded to NP: 4 for n <= 4, the next multiple of
//   8 above (one template per band, so every divisor but n is a
//   constant). Each thread owns a 4 x 4 tile of one product (at n = 39,
//   NP = 40: 100 threads a pair). X is staged transposed, so for each k
//   the thread reads its 4 entries of X's column k and its 4 entries of
//   Y's row k as one 16-byte load each (two for float64) and updates its
//   16 sums in ascending k: 2 vector loads feed 32 FP instructions. The
//   threads of a warp that share a tile row read the same X address. The
//   padded rows and columns hold whatever shared memory held; they feed
//   only outputs that are never stored.
// - Copies. A block takes a group of P consecutive pairs (P = 256 /
//   threads a pair, fewer where 32 KB of float32 or 64 KB of float64
//   would not hold them, or where a small batch would leave resident
//   blocks without a group), so its span of X, Y and out is contiguous.
//   Consecutive threads take consecutive elements, each with one 4-byte
//   (8-byte) cp.async straight into its place: transposed for X, in rows
//   of NP for Y. A 16-byte copy could not: the rows of an odd n start off
//   16-byte boundaries, and cp.async does not transpose. The element's
//   row and column come from a multiply by a reciprocal (exact below 2^17
//   elements, and a group holds at most 2^12 of each operand), not a
//   division. X^T's row stride is 4 times an odd number (NP or NP + 4),
//   so the 8 transposed stores of 8 consecutive k fall into 8 different
//   quads of banks, not into one bank (32 ways at NP = 64).
// - One stage, persistent blocks. As many blocks as fit on the card walk
//   over the groups; the copies of one block overlap with the products of
//   the other blocks on its SM (several at every n). A block has no second
//   stage of its own: its copies and products would compete for the same
//   issue slots and load/store path, and the stage would cost resident
//   blocks (the variants that measured slower are in PERF.md section 6).
// - Stores. Outputs go from registers straight to device memory: 16-byte
//   stores when n is a multiple of 4 (every row then starts 16-byte
//   aligned), single elements otherwise; the threads of a warp write
//   neighbouring columns, so the sectors are filled.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kTile = 4;         // a thread's tile: kTile x kTile outputs
constexpr int kBlockThreads = 256;  // at most

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// shape of a band: NP = padded n
template <typename T, int NP>
struct Band {
  static constexpr int kTiles = NP / kTile;           // tiles a row
  static constexpr int kTpp = kTiles * kTiles;        // threads a pair
  static constexpr int kLDT = kTiles % 2 ? NP : NP + 4;  // X^T's row stride
  static constexpr int kXElems = NP * kLDT;           // X^T of one pair
  static constexpr int kYElems = NP * NP;             // Y of one pair
  static constexpr int kGroupBytes = sizeof(T) == 4 ? 32 * 1024 : 64 * 1024;
  static constexpr int kPairs = cmin(
      cmax(1, kBlockThreads / kTpp),
      cmax(1, kGroupBytes / ((kXElems + kYElems) *
                             static_cast<int>(sizeof(T)))));
  static constexpr int kThreads = kPairs * kTpp;
  static constexpr size_t kSmem = (kXElems + kYElems) * kPairs * sizeof(T);
};

// e / d for e < 2^17 and 1 <= d <= 64, with m = ceil(2^31 / d)
__device__ __forceinline__ int div_by(int e, unsigned m) {
  return static_cast<int>(
      (static_cast<unsigned long long>(static_cast<unsigned>(e)) * m) >> 31);
}

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T)));
}
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void load4(const float* s, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(s);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* s, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(s);
  const double2 b = *reinterpret_cast<const double2*>(s + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* d, const float (&v)[4]) {
  *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* d, const double (&v)[4]) {
  reinterpret_cast<double2*>(d)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(d)[1] = make_double2(v[2], v[3]);
}

// copy `pairs` pairs from element `base` into shared memory: X transposed
// (Xs[p][k][i], row stride kLDT), then Y in rows of NP (Ys[p][k][j])
template <typename T, int NP>
__device__ __forceinline__ void stage_group(T* Xs, const T* __restrict__ X,
                                            const T* __restrict__ Y,
                                            long long base, int pairs, int n,
                                            unsigned m) {
  using Bd = Band<T, NP>;
  T* Ys = Xs + Bd::kPairs * Bd::kXElems;
  const int count = pairs * n * n;
  for (int e = threadIdx.x; e < count; e += Bd::kThreads) {
    const int row = div_by(e, m);       // p * n + r over the group
    const int c = e - row * n;
    const int p = div_by(row, m);
    const int r = row - p * n;
    copy_async(Xs + p * Bd::kXElems + c * Bd::kLDT + r, X + base + e);
    copy_async(Ys + p * Bd::kYElems + r * NP + c, Y + base + e);
  }
  copy_wait_all();
}

// this thread's tile of pair slot p, from (i0, j0), into o (row stride n):
// acc[u][v] = sum over ascending k of X[i0+u][k] Y[k][j0+v]
template <typename T, int NP>
__device__ __forceinline__ void multiply(const T* S, int p, int i0, int j0,
                                         int n, T* __restrict__ o) {
  using Bd = Band<T, NP>;
  const T* xs = S + p * Bd::kXElems + i0;
  const T* ys = S + Bd::kPairs * Bd::kXElems + p * Bd::kYElems + j0;
  T acc[kTile][kTile];
#pragma unroll
  for (int u = 0; u < kTile; ++u)
#pragma unroll
    for (int v = 0; v < kTile; ++v) acc[u][v] = T(0);
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    T a[kTile], b[kTile];
    load4(xs + k * Bd::kLDT, a);
    load4(ys + k * NP, b);
#pragma unroll
    for (int u = 0; u < kTile; ++u)
#pragma unroll
      for (int v = 0; v < kTile; ++v) acc[u][v] = add(acc[u][v], mul(a[u], b[v]));
  }
  if ((n & 3) == 0) {  // rows 16-byte aligned, and j0 + 3 < n
#pragma unroll
    for (int u = 0; u < kTile; ++u)
      if (i0 + u < n) store4(o + u * n, acc[u]);
  } else {
#pragma unroll
    for (int u = 0; u < kTile; ++u)
#pragma unroll
      for (int v = 0; v < kTile; ++v)
        if (i0 + u < n && j0 + v < n) o[u * n + v] = acc[u][v];
  }
}

template <typename T, int NP>
__global__ void __launch_bounds__(Band<T, NP>::kThreads)
small_mm_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                T* __restrict__ out, long long batch, int n, unsigned m,
                int group) {
  using Bd = Band<T, NP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const S = reinterpret_cast<T*>(smem_raw);
  const int nn = n * n;
  const long long groups = (batch + group - 1) / group;

  // this thread's tile: pair slot p, rows i0.., columns j0..
  const int p = threadIdx.x / Bd::kTpp;
  const int q = threadIdx.x - p * Bd::kTpp;
  const int ti = q / Bd::kTiles;
  const int i0 = kTile * ti, j0 = kTile * (q - ti * Bd::kTiles);

  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long left = batch - g * group;
    const int pairs = left < group ? static_cast<int>(left) : group;
    const long long base = g * group * nn;
    stage_group<T, NP>(S, X, Y, base, pairs, n, m);
    __syncthreads();  // every thread's copies have landed
    if (p < pairs && i0 < n && j0 < n) {
      multiply<T, NP>(S, p, i0, j0, n, out + base + p * nn + i0 * n + j0);
    }
    __syncthreads();  // the stage is refilled in the next round
  }
}

template <typename T, int NP>
int launch_band(const T* X, const T* Y, T* out, long long batch, int n,
                cudaStream_t stream) {
  using Bd = Band<T, NP>;
  const auto kernel = small_mm_kernel<T, NP>;
  cudaError_t err;
  if (Bd::kSmem > kDefaultSmem) {  // float64 at NP >= 56
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Bd::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int fit = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                      Bd::kThreads, Bd::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // pairs a group: kPairs, or fewer where the batch would not give every
  // resident block a group
  const long long resident = static_cast<long long>(fit > 0 ? fit : 1) * sms;
  const long long fill = (batch + resident - 1) / resident;
  const int group = fill < Bd::kPairs ? static_cast<int>(fill) : Bd::kPairs;
  const long long groups = (batch + group - 1) / group;
  const long long blocks = groups < resident ? groups : resident;
  const unsigned m = static_cast<unsigned>(((1ULL << 31) + n - 1) / n);
  kernel<<<static_cast<unsigned>(blocks), Bd::kThreads, Bd::kSmem, stream>>>(
      X, Y, out, batch, n, m, group);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* X, const T* Y, T* out, long long batch, int n,
           void* stream_ptr) {
  if (n < 1 || n > kMaxN || batch < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (n <= 4 ? 4 : (n + 7) / 8 * 8) {
    case 4: return launch_band<T, 4>(X, Y, out, batch, n, stream);
    case 8: return launch_band<T, 8>(X, Y, out, batch, n, stream);
    case 16: return launch_band<T, 16>(X, Y, out, batch, n, stream);
    case 24: return launch_band<T, 24>(X, Y, out, batch, n, stream);
    case 32: return launch_band<T, 32>(X, Y, out, batch, n, stream);
    case 40: return launch_band<T, 40>(X, Y, out, batch, n, stream);
    case 48: return launch_band<T, 48>(X, Y, out, batch, n, stream);
    case 56: return launch_band<T, 56>(X, Y, out, batch, n, stream);
    default: return launch_band<T, 64>(X, Y, out, batch, n, stream);
  }
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
