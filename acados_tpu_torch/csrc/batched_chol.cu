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
// operation for operation. That rules out tensor cores too, which a
// 4.9 kFLOP factor would leave idle anyway.
//
// Layout: the natural row-major (batch, n, n) and (batch, n) tensors,
// read once and written once. On the TPU the batch sat on the 128 lanes
// ((n, n, B) after a transpose); here a matrix maps onto a group of lanes.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32), at the
// dense IPM's shape (4096, 24, 24) float32, counting the 300 entries of a
// lower triangle read (the input's upper triangle is never needed) and
// every entry written:
//   factor bytes: 4096 * (300 + 576) * 4 B = 14.4 MB -> 4.3 us;
//          flops: n^3/3 + n^2/2 + 2n ~ 4.9 kFLOP a matrix, 20 MFLOP -> 0.3 us;
//   solve  bytes: 4096 * (300 + 2 * 24) * 4 B = 5.7 MB -> 1.7 us;
//   fused  bytes: 4096 * (300 + 576 + 2 * 24) * 4 B = 15.1 MB -> 4.5 us;
// so every launch is bound by bytes (a few microseconds), and by the
// latency of its n-step dependent recurrence at this batch.
//
// Every op at n <= 32 (the dense IPM's barrier Hessians, nv = 24 on the
// pendulum, the Riccati P_0 at nx = 16, the chain's condensed Huu at
// cond_N = 8, n = 15; K3 and K4 at the same n) runs the row branch
// chol_rows<T, NP, OP> (K2 through the block branch below is no faster at
// the chain's (256, 15, 15): 0.0092 against 0.0092 ms float32, 0.0099
// against 0.0089 float64; it wins only at n = 15 float32 below 256
// matrices, by 0.0007 ms, and loses more at every larger batch, H100 SXM
// at 700 W: k2_compare.py --sweep --ablate, build "allblock"): one body
// for the three ops, whose factor steps (factor_rows) and substitutions
// (solve_rows) work on the same rows in registers.
//   - Bands NP = 4, 8, 16, 24, 32 (a template each); n is padded to its
//     band with the identity ([[H, 0], [0, I]]), which adds pivots of 1
//     and leaves every entry of the factor's n x n block as it was, so
//     n = 24 runs no padding step. A group of W = 4, 8, 16, 32, 32 lanes
//     holds one matrix, a warp 32 / W of them (8, 4, 2, 1, 1).
//   - Lane i of a group owns row i as NP registers with compile-time
//     indices (H's for K2 and K4, L's for K3), and b[i] (0 past n); the
//     step loops and every loop inside them unroll fully.
//   - Factor, right-looking: at step j the group's diagonal s_jj comes
//     from lane j by one __shfl_sync; every lane takes d = sqrt(s_jj) and
//     1 / d itself (IEEE results, the same in every lane), scales its
//     entry j to L[i][j] (lane j keeps d), and writes it to the group's
//     column slot in shared memory (two slots, used in turn, so one
//     __syncwarp a step orders both the writes and the next step's
//     overwrite). Lanes read the column back as 16-byte broadcast loads
//     and update S[i][c] -= L[i][j] L[c][j] for every c > j. Entry (i, c)
//     so receives the plain version's products in the plain version's
//     order (ascending j), one rounding each, and the updates of a step
//     are independent: the chain a step is the pivot alone.
//   - Forward substitution, right-looking (the plain version's order): at
//     step i two shuffles bring r_i and L[i][i] from lane i, every lane of
//     the group divides (the same operands, so no lane diverges into the
//     division's slow path alone), lanes c > i subtract L[c][i] y_i and
//     lane i keeps y_i. A chain of NP steps.
//   - Back substitution: x_i's terms are subtracted in ascending k, as the
//     plain version does, so x_i's first term needs x_{i+1}, the value
//     solved just before, and the subtractions form one chain of
//     n (n - 1) / 2 whatever the layout (a descending, right-looking
//     order would cut the chain to n steps but round differently). The
//     products come off the chain instead: at step i every lane k forms
//     L[k][i] x_k from its own row and writes it to the group's slot (+0
//     for a row past n, which leaves any difference as it was, so padded
//     rows never enter x even where a zero, inf or NaN diagonal of a K3
//     input makes their x NaN), and after one __syncwarp every lane of
//     the group reads the slot back as 16-byte broadcast loads, subtracts
//     from y_i (shuffled from lane i) in ascending k and divides by
//     L[i][i] (shuffled too). Lane i keeps x_i for the products of the
//     steps below. Only the subtractions and the division stay serial.
//   - Only entries at or below the diagonal of a row reach a result: the
//     substitutions read S[c] for c <= i alone, and the products of lanes
//     k <= i land in slot entries no lane reads. So a K3 input's upper
//     triangle is never used, and K4 solves on the factor's registers as
//     they stand, garbage above the diagonal included.
//   - Entries above the diagonal, the padding lanes (NP = 24) and a
//     group past the batch (which works on the identity and stores
//     nothing) compute values that are never read; no lane leaves early,
//     so every lane takes part in every shuffle and __syncwarp.
//   - The pivot test sets the lane's failure flag and does not return; a
//     failed group stores NaN in every entry of L and of x.
//   - Float32 bands up to NP = 24 are held to 64 registers (K2's NP = 24
//     takes 76 otherwise, and NP = 32 would spill), so 32 warps fit on an
//     SM and the dense IPM's 4096 matrices, a warp each, run in one wave
//     on 132 SMs.
//   - Loads and stores: where a row is a whole number of 16-byte vectors
//     (n % 4 == 0 in float32, n % 2 == 0 in float64) and both matrices
//     are 16-byte aligned, lane i reads row i as 16-byte vectors, only
//     those that start at or below the diagonal, and writes L's the same
//     way (zeros above the diagonal). Otherwise the warp's matrices, which
//     are contiguous, pass through shared memory in one coalesced copy
//     each way (n = 13, or an input one element off its allocation).
//     b and x move as one element a lane: a warp's lanes cover its
//     matrices' G n contiguous entries, so that is coalesced whatever the
//     alignment. No index is split by an integer division.
//   Counts at (4096, 24, 24) float32, one matrix a warp. A factor step j:
//   one shuffle, the pivot test, sqrt and the division 1 / d with their
//   range checks and slow-path branches (about 25 instructions), a
//   multiply, one shared store, a __syncwarp, (24 - j) / 4 broadcast
//   loads and 23 - j multiply-subtract pairs (unfused): 64 warp
//   instructions a step in the SASS, about 1.6 k a matrix with the
//   staging; measured (k2_compare.py, H100 SXM at 700 W) 0.0154-0.0160 ms
//   back to back for K2, issue-bound in the steady state (about 8.4 us a
//   wave of 4224 matrices at B = 65536), and one wave adds about 5 us for
//   the launch, its first loads and its last stores, which n = 4 alone
//   takes. A forward step: two shuffles, the division (about 10 issued
//   with its check and branch), a multiply, a subtraction and the lane
//   tests: 15 issued. A back step i: two shuffles, a multiply, a select,
//   the slot store, (23 - i) / 4 + 1 broadcast loads, 23 - i
//   subtractions, the division and a select: about 35 at i = 11. The
//   solve alone (K3) is 1,872 warp instructions in the SASS, at most
//   1.73 k issued a matrix, against a chain of about 5 k cycles a warp;
//   at 31 warps an SM (8 a scheduler) issue takes more (about 13 k
//   cycles). Measured (k2_compare.py, H100 SXM at 700 W): K3 0.0128 ms,
//   K4 0.0213 ms back to back, K4 being K2's factor plus the same solve.
//
// K2 at n = 33..64 and batch <= kBlockMaxBatch = 512 (the chain's free-x0
// P_0 at nx = 39, B = 256; the condensed Huu of blocks of more than 32
// controls) runs the block branch chol_block<T>, made for small batches,
// where one warp a matrix left most of the card idle (256 warps on 132
// SMs, each running a serial sum of j products a lane at each step j,
// about n^2 / 2 dependent steps):
//   - A thread block a matrix: 8 general warps and a pivot warp. The lower
//     triangle goes into shared memory (odd row stride) with one coalesced
//     read, a row a warp at a time, every load of a thread in flight at
//     once: 64 x 65 x 8 B = 33 KB at most, under the 48 KB default. At
//     most 113 registers, so two blocks share an SM and 256 matrices run
//     in one wave.
//   - Right-looking, two columns j, j + 1 a step, one barrier a step.
//     Column j holds its raw values (every product of the columns left of
//     it subtracted); column j + 1 those of the columns left of j, and it
//     is never written again: whoever needs L[i][j+1] = (S[i][j+1] -
//     L[i][j] L[j+1][j]) * (1 / d_j+1) takes it from there, with
//     L[i][j] = S[i][j] * (1 / d_j), the plain version's roundings. Each
//     general entry (i, k) of rows and columns >= j + 2 subtracts
//     L[i][j] L[k][j], then L[i][j+1] L[k][j+1]: every entry receives the
//     plain version's products in ascending column order, one rounding
//     each, so the factor is bit for bit the plain version's. The store
//     gives an odd column its column c - 1 product on the way out.
//   - The entries of a step's triangle are counted from its bottom-right
//     corner, column by column, so every step's triangle is a prefix of
//     the count and general thread t owns q = t + 256 e, the same entries
//     every step: the load stays balanced to one entry as the triangle
//     shrinks, and no entry has two writers. A thread takes its entries
//     in pairs whose shared loads are issued together.
//   - The three entries at the triangle's top-left corner, (j+2, j+2),
//     (j+3, j+2) and (j+3, j+3), belong to lane 0 of the pivot warp: while
//     the general warps update, it gives them the step's products, takes
//     pivot j + 2's sqrt and reciprocal (the IEEE intrinsics of the row
//     branch), gives (j+3, j+2) and (j+3, j+3) column j + 2's product and
//     takes pivot j + 3's, so the next step finds both in place. Only
//     columns >= j + 2 are written in a step and only columns j, j + 1
//     read, so one barrier a step orders everything. The chain of a step
//     is the barrier, the corner's loads, two pivots' products, sqrt and
//     reciprocal; the ablations of k2_compare.py (--ablate) time it
//     without the sqrt and reciprocals, without the general updates, and
//     without both.
//   - What bounds it: at (256, 39, 39) float32 the bytes, 256 x (780 +
//     1521) x 4 B = 2.4 MB, take 0.7 us; the branch takes 0.0140 ms back
//     to back (the one-warp kernel 0.0294, torch.linalg.cholesky_ex
//     0.0471 timed the same way; H100 SXM at 700 W, k2_compare.py). Its
//     latency does: without the general updates 0.0118, without the
//     sqrt and reciprocals 0.0119, without both 0.0097, against 0.0056
//     for a launch of the row branch at n = 4, so the steps' barriers,
//     loads and products, the load and the store take about 4 us, the
//     pivots' sqrt and reciprocals 2 and the updates 2.
//   - The pivot thread keeps a failure flag; the steps run on through a
//     failed pivot's NaN, and after the last barrier every thread reads
//     the flag, so the test is uniform over the block and the store
//     writes NaN over the whole matrix.
//   - One coalesced store: d_j on the diagonal, L below, 0 above.
//   - Above 512 matrices K2 at n = 33..64 runs chol_kernel (below), whose
//     many matrices an SM, a warp each, mostly outrun one block a matrix
//     there: at n = 39, 0.0308 against 0.0407 ms float32 and 0.0415
//     against 0.0496 float64 at B = 1024 (H100 SXM, 700 W; k2_compare.py
//     --sweep --ablate, build "allblock"). At n = 64 float64 the block
//     branch would still win (0.0993 against 0.1896 ms at B = 1024); no
//     solver runs such a batch.
//
// K3 and K4 at n = 33..64 (no solver caller), and K2 there above 512
// matrices, run chol_kernel, the one-warp kernel of the first port, the
// matrix in shared memory for the whole recurrence:
//   - factor (K2, K4): column by column, lanes own the rows i >= j (a second
//     row when n > 32) and run their sums serially in k; the pivot is
//     broadcast with __shfl_sync and its test is warp-uniform, so a bad
//     pivot stops the warp and the store writes NaN;
//   - forward substitution: lanes own rows, column i updates every row
//     below it (ascending k per entry, as in the plain version);
//   - back substitution: one lane, entry by entry, since each entry's
//     ascending sum starts with the entry solved just before it;
//   - the row stride in shared memory is odd, so lanes reading a column
//     hit 32 different banks.

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

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


// ---- the row branch: every op at n <= 32 ------------------------------------

// Band NP: W lanes a matrix (the power of two at or above NP), G matrices
// a warp, V elements a 16-byte vector, 4 warps a block. Per warp in
// shared memory: two slots of 32 entries (group g's at g W), and on the
// staged route the warp's G matrices as they lie in memory.
template <typename T, int NP>
struct RowCfg {
  static constexpr int kLanes = NP <= 4 ? 4 : NP <= 8 ? 8 : NP <= 16 ? 16 : 32;
  static constexpr int kMats = 32 / kLanes;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kWarps = 4;
  // float32 up to NP = 24: at most 64 registers, so 32 warps fit on an SM
  // and the dense IPM's 4096 matrices (a warp each) run in one wave on 132
  // SMs (NP = 32 would spill)
  static constexpr int kMinBlocks = sizeof(T) == 4 && NP <= 24 ? 8 : 1;
  static_assert(NP % kVec == 0 && NP <= kLanes, "band");
  __host__ __device__ static size_t warp_bytes(int n, bool vec) {
    const size_t tile = vec ? 0 : (kMats * n * n * sizeof(T) + 15) / 16 * 16;
    return 2 * 32 * sizeof(T) + tile;
  }
};

// R[q V .. q V + V - 1] <-> 16 bytes at p (aligned)
template <typename T, int NP>
__device__ __forceinline__ void load16(T (&R)[NP], int q, const T* p) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    R[4 * q] = v.x;
    R[4 * q + 1] = v.y;
    R[4 * q + 2] = v.z;
    R[4 * q + 3] = v.w;
  } else {
    const double2 v = *reinterpret_cast<const double2*>(p);
    R[2 * q] = v.x;
    R[2 * q + 1] = v.y;
  }
}
template <typename T, int NP>
__device__ __forceinline__ void store16(T* p, int q, const T (&R)[NP]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) =
        make_float4(R[4 * q], R[4 * q + 1], R[4 * q + 2], R[4 * q + 3]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(R[2 * q], R[2 * q + 1]);
  }
}

// Factor the padded rows in place: lane gl of group g owns row gl in S,
// col is the warp's two slots. Returns false, the same in every lane of
// the group, if a pivot is <= 0 or not finite.
template <typename T, int NP>
__device__ __forceinline__ bool factor_rows(T (&S)[NP], T* col, int g,
                                            int gl) {
  constexpr int W = RowCfg<T, NP>::kLanes, V = RowCfg<T, NP>::kVec;
  bool ok = true;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const T piv = __shfl_sync(kFull, S[j], j, W);  // s_jj, from lane j
    ok = ok && pivot_ok(piv);  // false for NaN too
    const T d = sqrt_rn(piv);
    const T inv = dvd(T(1), d);
    S[j] = gl == j ? d : mul(S[j], inv);
    T* slot = col + (j & 1) * 32 + g * W;
    slot[gl] = S[j];
    __syncwarp();
    T Lc[NP];  // L[c][j] for c > j
#pragma unroll
    for (int q = (j + 1) / V; q < NP / V; ++q) load16(Lc, q, slot + q * V);
#pragma unroll
    for (int c = j + 1; c < NP; ++c) S[c] = sub(S[c], mul(S[j], Lc[c]));
  }
  return ok;
}

// f(std::integral_constant<int, I>()) for I = 0, 1, ..., N - 1: a loop
// whose index is a compile-time constant in every step whatever the
// unroller decides, so the register arrays it indexes stay registers
template <typename F, int... I>
__device__ __forceinline__ void each(F&& f,
                                     std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>()), ...);
}
template <int N, typename F>
__device__ __forceinline__ void each(F&& f) {
  each(f, std::make_integer_sequence<int, N>());
}

// Solve L L' x = b on the padded rows of L in S (lane gl owns row gl and
// r = b[gl], 0 from n on); returns x[gl]. Reads S[c] for c <= gl only.
template <typename T, int NP>
__device__ __forceinline__ T solve_rows(const T (&S)[NP], T r, T* col,
                                        int g, int gl, int n) {
  constexpr int W = RowCfg<T, NP>::kLanes, V = RowCfg<T, NP>::kVec;
  each<NP>([&](auto step) {  // forward: L y = b, y in lane i's r
    constexpr int i = decltype(step)::value;
    const T y = dvd(__shfl_sync(kFull, r, i, W),
                    __shfl_sync(kFull, S[i], i, W));
    if (gl > i) r = sub(r, mul(S[i], y));
    if (gl == i) r = y;
  });
  __syncwarp();  // a factor's last reads of the slots, before the stores
  const bool real = gl < n;
  T x = T(0);
  each<NP>([&](auto step) {  // back: L' x = y, i = NP - 1 down to 0
    constexpr int i = NP - 1 - decltype(step)::value;
    T* slot = col + (i & 1) * 32 + g * W;
    slot[gl] = real ? mul(S[i], x) : T(0);  // L[k][i] x_k from lanes k > i
    const T y = __shfl_sync(kFull, r, i, W);
    const T d = __shfl_sync(kFull, S[i], i, W);
    __syncwarp();
    T P[NP];  // the slot's vectors from the one holding k = i + 1
    constexpr int q0 = (i + 1) / V;
    each<NP / V - q0>([&](auto q) {
      load16(P, q0 + decltype(q)::value, slot + (q0 + decltype(q)::value) * V);
    });
    T s = y;
    each<NP - 1 - i>([&](auto k) {
      s = sub(s, P[i + 1 + decltype(k)::value]);
    });
    const T xi = dvd(s, d);
    if (gl == i) x = xi;
  });
  return x;
}

// K2 (OP = kFactor: M = H -> L), K3 (kSolve: M = L, b -> x) and K4
// (kFactorSolve: M = H, b -> x, L) at n <= NP.
template <typename T, int NP, Op OP>
__global__ void __launch_bounds__(RowCfg<T, NP>::kWarps * 32,
                                  RowCfg<T, NP>::kMinBlocks)
    chol_rows(const T* __restrict__ M, const T* __restrict__ b,
              T* __restrict__ x, T* __restrict__ L, long long batch, int n,
              bool vec) {
  using C = RowCfg<T, NP>;
  constexpr int W = C::kLanes, G = C::kMats, V = C::kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int gl = lane & (W - 1);  // the row this lane owns
  const int g = lane / W;         // its group (matrix) in the warp
  const long long m0 =
      (static_cast<long long>(blockIdx.x) * C::kWarps + wid) * G;
  if (m0 >= batch) return;  // warp-uniform
  const bool live = m0 + g < batch;  // a group past the batch: unstored
  const int nn = n * n;
  const long long left = (batch - m0) * nn;
  const int span = left < G * nn ? static_cast<int>(left) : G * nn;
  T* col = reinterpret_cast<T*>(smem_raw + wid * C::warp_bytes(n, vec));
  T* tile = col + 64;               // staged route only
  T* row = tile + g * nn + gl * n;  // staged route: this lane's row

  // row gl of the padded matrix: the identity's, then M's lower part
  T S[NP];
#pragma unroll
  for (int c = 0; c < NP; ++c) S[c] = T(c == gl);
  const bool mine = live && gl < n;
  if (vec) {
    const T* src = M + (m0 + g) * nn + gl * n;
#pragma unroll
    for (int q = 0; q < NP / V; ++q) {
      if (mine && q * V < n && q * V <= gl) load16(S, q, src + q * V);
    }
  } else {
    const T* src = M + m0 * nn;
    for (int e = lane; e < span; e += 32) tile[e] = src[e];
    __syncwarp();
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      if (mine && c < n && c <= gl) S[c] = row[c];
    }
  }

  const T nan = quiet_nan<T>();
  T r = T(0);  // b[gl], 0 from n on
  if constexpr (OP != Op::kFactor) {
    if (mine) r = b[(m0 + g) * n + gl];
  }
  bool ok = true;
  if constexpr (OP != Op::kSolve) ok = factor_rows<T, NP>(S, col, g, gl);
  if constexpr (OP != Op::kFactor) {
    const T xs = solve_rows<T, NP>(S, r, col, g, gl, n);
    if (mine) x[(m0 + g) * n + gl] = ok ? xs : nan;
  }
  if constexpr (OP != Op::kSolve) {
    // row gl of L: the lower triangle, 0 above; NaN throughout if a pivot
    // failed
#pragma unroll
    for (int c = 0; c < NP; ++c) S[c] = !ok ? nan : (c <= gl ? S[c] : T(0));
    if (vec) {
      T* dst = L + (m0 + g) * nn + gl * n;
#pragma unroll
      for (int q = 0; q < NP / V; ++q) {
        if (mine && q * V < n) store16(dst + q * V, q, S);
      }
    } else {
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        if (mine && c < n) row[c] = S[c];
      }
      __syncwarp();
      T* dst = L + m0 * nn;
      for (int e = lane; e < span; e += 32) dst[e] = tile[e];
    }
  }
}

template <typename T, int NP, Op OP>
int launch_rows(const T* M, const T* b, T* x, T* L, long long batch, int n,
                cudaStream_t stream) {
  using C = RowCfg<T, NP>;
  const long long warps = (batch + C::kMats - 1) / C::kMats;
  const long long blocks = (warps + C::kWarps - 1) / C::kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // rows move as 16-byte vectors where they are whole vectors and both
  // matrices are aligned to them (fresh tensors are; K3 has no L)
  const bool vec = n * sizeof(T) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(M) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(L) % 16 == 0;
  chol_rows<T, NP, OP>
      <<<static_cast<unsigned>(blocks), C::kWarps * 32,
         C::kWarps * C::warp_bytes(n, vec), stream>>>(M, b, x, L, batch, n,
                                                      vec);
  return static_cast<int>(cudaGetLastError());
}

// ---- the block branch: K2 at n = 33..64 -------------------------------------

// A block a matrix: kBlockGeneral threads update the trailing triangle in
// groups of kBlockGroup entries, and one more warp, whose lane 0 takes the
// pivots, owns no entry of it. K2 takes this branch at n = 33..64 up to
// kBlockMaxBatch matrices (dispatch()).
constexpr int kBlockGeneral = 256;
constexpr int kBlockThreads = kBlockGeneral + 32;
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kBlockPivot = kBlockGeneral;  // its thread index
constexpr int kBlockGroup = 2;
// blocks an SM holds at least: 256 matrices on 132 SMs in one wave
constexpr int kBlockMinBlocks = 2;
// entries of a trailing triangle a general thread owns at most (fewer than
// the 64 * 63 / 2 - 1 = 2015 below the first pivot at n = 64), in whole
// groups
constexpr int kBlockEntries =
    ((kMaxN * (kMaxN - 1) / 2 - 1 + kBlockGeneral - 1) / kBlockGeneral +
     kBlockGroup - 1) / kBlockGroup * kBlockGroup;
// rows of the matrix a warp moves in and out at most
constexpr int kBlockRows = (kMaxN + kBlockWarps - 1) / kBlockWarps;
constexpr long long kBlockMaxBatch = 512;

template <typename T>
__host__ __device__ __forceinline__ size_t block_smem(int n) {
  return static_cast<size_t>(n * row_stride(n) + 2 * n) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads, kBlockMinBlocks)
    chol_block(const T* __restrict__ H, T* __restrict__ L, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int failed;  // a pivot was <= 0 or not finite
  const int ld = row_stride(n);
  T* S = reinterpret_cast<T*>(smem_raw);  // the lower triangle, raw
  T* dg = S + n * ld;                     // d_j = L[j][j]
  T* iv = dg + n;                         // 1 / d_j
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long nn = static_cast<long long>(n) * n;
  const T* g = H + blockIdx.x * nn;

  // the lower triangle, row warp + r kBlockWarps in warp `warp`, all the
  // loads in flight at once, then into shared memory
  {
    T v[kBlockRows][2];
#pragma unroll
    for (int r = 0; r < kBlockRows; ++r) {
      const int i = warp + r * kBlockWarps;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        if (i < n && c <= i) v[r][h] = g[i * n + c];
      }
    }
#pragma unroll
    for (int r = 0; r < kBlockRows; ++r) {
      const int i = warp + r * kBlockWarps;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        if (i < n && c <= i) S[i * ld + c] = v[r][h];
      }
    }
  }

  // This thread's entries of the trailing triangles: entry q of a step's
  // triangle, counted from the bottom-right corner column by column
  // (k' = n-1-k, i' = n-1-i, q = k'(k'+1)/2 + i'), so that the triangle
  // of rows and columns j+2..n-1 is q < P = m(m+1)/2 with m = n-2-j, and
  // its three entries at the top-left corner, (j+2, j+2), (j+3, j+2) and
  // (j+3, j+3), are q = P-1, P-2 and P-m-1. General thread t owns
  // q = t + e kBlockGeneral: the same entries every step.
  // k' = floor((sqrt(8q + 1) - 1) / 2), the estimate put right by one
  // step either way.
  int own[kBlockEntries], ri[kBlockEntries], rk[kBlockEntries];
#pragma unroll
  for (int e = 0; e < kBlockEntries; ++e) {
    const int q = tid + e * kBlockGeneral;
    const float x = 8.0f * q + 1.0f;
    int kp = static_cast<int>((x * rsqrtf(x) - 1.0f) * 0.5f);
    kp += (kp + 1) * (kp + 2) / 2 <= q;
    kp -= kp * (kp + 1) / 2 > q;
    const int i = n - 1 - (q - kp * (kp + 1) / 2), k = n - 1 - kp;
    own[e] = i * ld + k;
    ri[e] = i * ld;
    rk[e] = k * ld;
  }

  // pivots 0 and 1 from the matrix as loaded
  T inv0 = T(0), inv1 = T(0);  // the pivot thread's 1 / d of the step
  bool ok = true;
  if (tid == kBlockPivot) {
    const T p0 = g[0];
    ok = pivot_ok(p0);  // false for NaN too
    const T d0 = sqrt_rn(p0);
    inv0 = dvd(T(1), d0);
    dg[0] = d0;
    iv[0] = inv0;
    if (n > 1) {
      const T l = mul(g[n], inv0);
      const T p1 = sub(g[n + 1], mul(l, l));
      ok = ok && pivot_ok(p1);
      const T d1 = sqrt_rn(p1);
      inv1 = dvd(T(1), d1);
      dg[1] = d1;
      iv[1] = inv1;
    }
  }
  __syncthreads();

  // Right-looking, two columns j, j + 1 a step. Column j holds its raw
  // values (all products of the columns left of it subtracted), column
  // j + 1 those of the columns left of j: it is never written again, and
  // whoever needs L[i][j+1] = (S[i][j+1] - L[i][j] L[j+1][j]) * (1 / d_j+1)
  // takes it from there (the store too). Each general entry (i, k) of
  // rows and columns >= j + 2 subtracts L[i][j] L[k][j], then
  // L[i][j+1] L[k][j+1], so each entry receives the plain version's
  // products in ascending column order, one rounding each. Only columns
  // >= j + 2 are written and only columns j, j + 1 read, each entry by its
  // one owner, so one barrier a step orders everything. Meanwhile the
  // pivot thread gives the next step's corner, (j+2, j+2), (j+3, j+2) and
  // (j+3, j+3), both columns' products, takes pivot j + 2's sqrt and
  // reciprocal, gives (j+3, j+2) and (j+3, j+3) column j + 2's product
  // and takes pivot j + 3's: the next step finds both in place. A failed
  // pivot's NaN runs on to the end; the store writes NaN.
  for (int j = 0; j + 2 < n; j += 2) {
    const int m = n - 2 - j;
    const int P = m * (m + 1) / 2;
    if (tid == kBlockPivot) {
      const int r1 = (j + 1) * ld, r2 = (j + 2) * ld;
      const T lc = mul(S[r1 + j], inv0);           // L[j+1][j]
      const T l20 = mul(S[r2 + j], inv0);
      const T l21 = mul(sub(S[r2 + j + 1], mul(l20, lc)), inv1);
      const T p2 = sub(sub(S[r2 + j + 2], mul(l20, l20)), mul(l21, l21));
      ok = ok && pivot_ok(p2);
      const T d2 = sqrt_rn(p2);
      const T inv2 = dvd(T(1), d2);
      dg[j + 2] = d2;
      iv[j + 2] = inv2;
      T inv3 = T(0);
      if (m > 1) {
        const int r3 = (j + 3) * ld;
        const T l30 = mul(S[r3 + j], inv0);
        const T l31 = mul(sub(S[r3 + j + 1], mul(l30, lc)), inv1);
        const T s32 = sub(sub(S[r3 + j + 2], mul(l30, l20)), mul(l31, l21));
        S[r3 + j + 2] = s32;                       // column j + 2's raw
        const T l32 = mul(s32, inv2);
        const T p3 = sub(sub(sub(S[r3 + j + 3], mul(l30, l30)),
                             mul(l31, l31)), mul(l32, l32));
        ok = ok && pivot_ok(p3);
        const T d3 = sqrt_rn(p3);
        inv3 = dvd(T(1), d3);
        dg[j + 3] = d3;
        iv[j + 3] = inv3;
      }
      inv0 = inv2;
      inv1 = inv3;
    } else if (tid < kBlockGeneral) {
      const T i0 = iv[j], i1 = iv[j + 1];
      const T lc = mul(S[(j + 1) * ld + j], i0);  // L[j+1][j]
      const int corner = P - m - 1;                // (j+3, j+3)
#pragma unroll
      for (int e0 = 0; e0 < kBlockEntries; e0 += kBlockGroup) {
        if (tid + e0 * kBlockGeneral >= P - 2) break;
        T a0[kBlockGroup], b0[kBlockGroup], a1[kBlockGroup],
            b1[kBlockGroup], c[kBlockGroup];
        bool on[kBlockGroup];
#pragma unroll
        for (int u = 0; u < kBlockGroup; ++u) {  // the group's loads at once
          const int q = tid + (e0 + u) * kBlockGeneral;
          on[u] = q < P - 2 && q != corner;
          if (on[u]) {
            a0[u] = S[ri[e0 + u] + j];
            b0[u] = S[rk[e0 + u] + j];
            a1[u] = S[ri[e0 + u] + j + 1];
            b1[u] = S[rk[e0 + u] + j + 1];
            c[u] = S[own[e0 + u]];
          }
        }
#pragma unroll
        for (int u = 0; u < kBlockGroup; ++u) {
          if (on[u]) {
            const T li0 = mul(a0[u], i0), lk0 = mul(b0[u], i0);
            const T li1 = mul(sub(a1[u], mul(li0, lc)), i1);
            const T lk1 = mul(sub(b1[u], mul(lk0, lc)), i1);
            S[own[e0 + u]] = sub(sub(c[u], mul(li0, lk0)), mul(li1, lk1));
          }
        }
      }
    }
    __syncthreads();
  }
  if (tid == kBlockPivot) failed = !ok;
  __syncthreads();

  // L: d_j on the diagonal, S[i][c] * (1 / d_c) below (an odd column c
  // first takes column c - 1's product), 0 above; NaN in every entry if a
  // pivot failed
  const T nan = quiet_nan<T>();
  const bool bad = failed;
  T* out = L + blockIdx.x * nn;
#pragma unroll
  for (int r = 0; r < kBlockRows; ++r) {
    const int i = warp + r * kBlockWarps;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      if (i < n && c < n) {
        T x = c == i ? dg[i] : T(0);
        if (c < i) {
          T s = S[i * ld + c];
          if (c & 1) {
            const T ip = iv[c - 1];
            s = sub(s, mul(mul(S[i * ld + c - 1], ip),
                           mul(S[c * ld + c - 1], ip)));
          }
          x = mul(s, iv[c]);
        }
        out[i * n + c] = bad ? nan : x;
      }
    }
  }
}

template <typename T>
int launch_block(const T* H, T* L, long long batch, int n,
                 cudaStream_t stream) {
  if (batch > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  chol_block<T><<<static_cast<unsigned>(batch), kBlockThreads,
                  block_smem<T>(n), stream>>>(H, L, n);
  return static_cast<int>(cudaGetLastError());
}

// Which kernel runs an op at (batch, n): K2 at n = 33..64 and batch <=
// kBlockMaxBatch the block branch, every op at n <= 32 the row branch, and
// every other op chol_kernel (K2 there at batches whose many matrices an
// SM, a warp each, outrun one block a matrix).
enum class Branch { kRows = 0, kBlock = 1, kWarp = 2 };

template <Op OP>
Branch branch_of(long long batch, int n) {
  if (n <= 32) return Branch::kRows;
  return OP == Op::kFactor && batch <= kBlockMaxBatch ? Branch::kBlock
                                                      : Branch::kWarp;
}

template <typename T, Op OP>
int dispatch(const T* M, const T* b, T* x, T* L, long long batch, int n,
             void* stream_ptr) {
  if (n < 1 || n > kMaxN || batch < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (branch_of<OP>(batch, n)) {
    case Branch::kBlock:
      return launch_block<T>(M, L, batch, n, stream);
    case Branch::kWarp:
      return launch<T, OP>(M, b, x, L, batch, n, stream_ptr);
    default:
      break;
  }
  if (n <= 4) return launch_rows<T, 4, OP>(M, b, x, L, batch, n, stream);
  if (n <= 8) return launch_rows<T, 8, OP>(M, b, x, L, batch, n, stream);
  if (n <= 16) return launch_rows<T, 16, OP>(M, b, x, L, batch, n, stream);
  if (n <= 24) return launch_rows<T, 24, OP>(M, b, x, L, batch, n, stream);
  return launch_rows<T, 32, OP>(M, b, x, L, batch, n, stream);
}

}  // namespace

extern "C" int chol_factor_f32(const float* H, float* L, long long batch,
                               int n, void* stream) {
  return dispatch<float, Op::kFactor>(H, nullptr, nullptr, L, batch, n,
                                      stream);
}

extern "C" int chol_factor_f64(const double* H, double* L, long long batch,
                               int n, void* stream) {
  return dispatch<double, Op::kFactor>(H, nullptr, nullptr, L, batch, n,
                                       stream);
}

extern "C" int chol_solve_f32(const float* L, const float* b, float* x,
                              long long batch, int n, void* stream) {
  return dispatch<float, Op::kSolve>(L, b, x, nullptr, batch, n, stream);
}

extern "C" int chol_solve_f64(const double* L, const double* b, double* x,
                              long long batch, int n, void* stream) {
  return dispatch<double, Op::kSolve>(L, b, x, nullptr, batch, n, stream);
}

extern "C" int chol_factor_solve_f32(const float* H, const float* b, float* x,
                                     float* L, long long batch, int n,
                                     void* stream) {
  return dispatch<float, Op::kFactorSolve>(H, b, x, L, batch, n, stream);
}

extern "C" int chol_factor_solve_f64(const double* H, const double* b,
                                     double* x, double* L, long long batch,
                                     int n, void* stream) {
  return dispatch<double, Op::kFactorSolve>(H, b, x, L, batch, n, stream);
}

// The branch an op takes at (batch, n): 0 the row branch, 1 the block
// branch, 2 chol_kernel; op 0 K2, 1 K3, 2 K4.
extern "C" int chol_branch(int op, long long batch, int n) {
  const Branch b = op == 0   ? branch_of<Op::kFactor>(batch, n)
                   : op == 1 ? branch_of<Op::kSolve>(batch, n)
                             : branch_of<Op::kFactorSolve>(batch, n);
  return static_cast<int>(b);
}
