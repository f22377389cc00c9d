// Batched explicit inverse of small general matrices by Gauss-Jordan
// elimination with partial pivoting, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel acados_tpu/ops/batched_inv.py:_gj_inv_kernel
// (launched by _gj_inverse_pallas, public entry gj_inverse_any). It
// computes the same function: for each matrix, Gauss-Jordan on [A | I];
// at step k the pivot is the row at position >= k of largest |M[.][k]|,
// the lowest position among equal magnitudes (what jnp.argmax picks); it
// moves to position k, is divided by the pivot, and column k is
// eliminated from every other row. The plain PyTorch version of the same
// loop is acados_tpu_torch/ops/batched_inv.py:gj_inverse_plain. Both
// branches below divide as it does (IEEE division) and differ from it
// only by fused multiply-adds in the elimination.
//
// Layout: the output is the natural row-major (batch, n, n) tensor. The
// input is either that, or a batch of matrices each stored as its
// transpose (strides (n^2, 1, n)): the layout in which torch.func's
// jacfwd under vmap hands over the IRK's stage Jacobians, which the
// wrapper would otherwise copy first. Either is read once and the result
// written once; only the loads differ (below), never the arithmetic, so
// a transposed view inverts bit for bit as its row-major copy does.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside
// the tensor cores): 2 n^2 x 4 bytes and about 2 n^3 flops a matrix.
//   (81,920, 16, 16) float32: 168 MB -> 50 us; 0.67 GFLOP -> 10 us
//   (10240, 39, 39) float32:  125 MB -> 37 us; 1.22 GFLOP -> 18 us
//   (81,920, 9, 9) float32:    53 MB -> 16 us; 0.12 GFLOP -> 2 us
// so every shape the solvers launch is bound by bytes.
//
// Routes (gj_inverse_route reports the one an n takes):
//   n = 2, 4, 8, 16        group branch, band n (RL 1, 2, 2, 1)
//   n = 3, 5-7, 9-15       group branch padded to the band 4, 8 or 16
//                          (RL 2, 2, 1)
//   n = 1, 17-48           warp branch, band the next multiple of 8
//
// n in {2, 4, 8, 16}: the group branch gj_inv_group (a template per n,
// type and RL, the rows a lane owns: RL = 1 at n = 2 and 16, 2 at n = 4
// and 8, the faster of the two on the H100). It runs the warp branch's
// schedule (below) on a group of n / RL lanes, so a warp holds 32 RL / n
// matrices:
//   - Lane l of a group owns rows l RL .. l RL + RL - 1 as n registers
//     each (compile-time indices; rows of consecutive lanes are
//     contiguous, so each lane loads its rows as 16-byte vectors, 8-byte
//     at n = 2 in float32). Rows never move, slots are in place, and the
//     k loop unrolls fully (n <= 16): no group rotation, no padding.
//   - Pivot search on (magnitude key, position), the lowest position
//     winning ties: where a warp holds 2 groups (n = 16), the warp
//     branch's warp_argmax once a group, each lane's values masked out of
//     the other group's reduction (4 redux.sync a step in float32); with
//     more groups, log2(n / RL) butterfly rounds of __shfl_xor_sync on a
//     64-bit (key, ~position) pair. The row at the winning position owns
//     the pivot; the row that pivoted at step j holds position j from
//     then on, which gives the inverse's column order at the end.
//   - Broadcast through the group's slice of shared memory as in the
//     warp branch: the owner's predicated vector stores, lane l dividing
//     slots l + t n / RL, the quotients read back as vector broadcasts.
//     The owner's row takes them as the warp branch's does; in float32
//     ptxas then predicates the update's multiply-adds off for the owner,
//     which keeps the loaded quotients, so taking them costs nothing.
//   - Transposed input: lane l's row is memory column l. At RL = 1 the
//     lanes of a group read consecutive addresses j n + l at register j:
//     scalar loads, each warp load covering whole 32-byte sectors, at any
//     base alignment (at n = 16 faster than the row-major vector loads).
//     At RL = 2 (j n + 2 l and j n + 2 l + 1, half of each sector a load)
//     the warp instead stages its contiguous matrices through the tile
//     below, with 16-byte loads where the base is aligned to them
//     (kStageTransposed; k1_compare.py times the two).
//   - Staging out through a per-matrix tile of row stride n + 1, then one
//     coalesced store of the warp's matrices. A group past the batch
//     inverts the identity and stores nothing: every lane of a warp takes
//     part in every reduction; only a whole warp past the batch returns.
// At (81,920, 16, 16) float32 (two matrices a warp) a step is 96 warp
// instructions (16 FFMA for the update and 5 in the division, 4 redux, 14
// shared accesses, 11 selects, 31 integer and moves; `python3
// k1_compare.py --sass` prints these counts from the SASS), 1,656 a warp
// with the staging, 68 M over the batch: 0.065 ms of issue on 132 SMs x
// 4 schedulers at 1.98 GHz, 1.3x the 0.050 ms byte bound. PERF.md gives
// what the card reaches.
//
// The padded orders n = 3, 5-7, 9-15 run the same kernel in the band N the
// next power of two (a template per n and type, NV = n): the matrix is
// [[A, 0], [0, I]], its rows n..N-1 the identity's.
//   - The identity's rows are held in registers, never loaded or stored;
//     their key is 0, so they never pivot and keep their positions, and
//     only n steps run (steps n..N-1 would change nothing). A row holds n
//     slots rounded up to whole vectors (NS: 12 at n = 9 in float32).
//   - Loads are direct scalar loads in either layout (rows of n elements
//     are not aligned to vectors); staging them through shared memory,
//     timed against them, was slower at every padded n.
//   - Every element of A goes through the same operations in the same
//     order as in the warp branch, which pads the same matrix to its band
//     and runs every step: the results are bit for bit the warp branch's
//     on finite input (its identity rows stay e_i while every quotient is
//     finite, and lose every tie to the rows at lower positions).
// At (81,920, 9, 9) float32 (band 16, one row a lane, two matrices a
// warp) a step is 109 warp instructions with the loads and the store
// spread over the 9 steps (17 FFMA, 12 selects, 12 shared accesses, 4
// redux, 43 integer and moves; `python3 k1_compare.py --sass`), 981 a
// warp, 40 M over the batch: 0.038 ms of issue, 2.4x the 0.016 ms byte
// bound (the warp branch it replaced ran all 16 steps of its band on a
// warp a matrix, 0.129 ms on the card).
//
// n = 1 and 17..48: the warp branch gj_inv_warp, one warp a matrix, n
// padded to a band NP of 8, 24, 32, 40, 48 (a template per band and
// type):
//   - Rows never move. Lane i owns row i, and row i + 32 above n = 32,
//     as NP registers each, and every row carries its logical position;
//     a pivot swap exchanges two positions. Storage is in place: slot
//     j < k of a row holds the inverse's column p_j (p_j the row that
//     pivoted at step j), slot j >= k the matrix's column j. A step costs
//     NP multiply-adds a row, where [A | I] takes 2n, and moves nothing.
//     At the end out[pos_i][p_j] = slot j of row i. Rows n..NP-1 are an
//     identity block, each its own pivot at 1 from step n on, so the
//     steps up to the band's end change nothing and run unguarded.
//   - Pivot search: redux.sync max over (|x| bits + 1, 0 for rows at
//     positions < k), then min over (position << 6 | row) among the
//     lanes that hold it: two warp reductions (three in float64), the
//     lowest position winning ties.
//   - Broadcast through shared memory: the owner stores its raw row as
//     NP / 4 predicated 16-byte stores; lane c divides slot c (and c + 32)
//     by the pivot, slot k becoming 1 / pivot (a zero over a finite
//     nonzero pivot is multiplied instead, the same signed zero off the
//     division's slow path); every lane reads the NP quotients back as
//     16-byte broadcasts. 36 shared-access instructions a step at n = 39
//     (the owner's stores are issued for both row sets), about 1,800 a
//     matrix with the staging.
//   - Registers: every register index is a compile-time constant. The k
//     loop runs in groups of 8 steps, unrolled inside a
//     group, and the rows' registers rotate by a group between groups,
//     where unrolling the whole k loop would multiply the code several
//     times over. Occupancy is set by registers (about 165 a thread at
//     NP = 40 in float32, 12 warps an SM); float64 spills at NP = 40 and
//     48 (ptxas reports them in chip_smoke.py's build phase).
//   - Staging: the warp copies its n^2 contiguous elements with
//     consecutive lanes on consecutive addresses into a per-warp tile of
//     row stride NP + 1 (odd: a walk down a column hits 32 banks; a
//     transposed input is written down the tile's columns, which the odd
//     stride keeps on distinct banks too), reads its rows from there,
//     writes the result back through the tile to [pos_i][p_j], and stores
//     it coalesced. Up to 4 warps a block, as
//     many as fit in 48 KB of static shared memory.
// At (10240, 39, 39) float32 (NP = 40) that is 224 warp instructions a
// step (86 FFMA, 44 selects, 36 shared accesses, 2 redux, 34 integer and
// moves, 8 branch; `python3 k1_compare.py --sass` prints these counts
// from the SASS), 40 steps and the staging: about 9,500 a matrix, 97 M
// over the batch, 0.093 ms of issue on 132 SMs x 4 schedulers at
// 1.98 GHz, above the 0.037 ms byte bound. PERF.md gives what the card
// reaches.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 48;
// How a launch reads its input: row-major with the group branch's vector
// loads (the base aligned to them), row-major by scalar loads, or each
// matrix stored as its transpose.
enum Load : int { kRowsVec = 0, kRows = 1, kTransposed = 2 };
// The group branch's transposed loads at RL rows a lane: direct scalar
// loads of each lane's rows (RL = 1: n = 2, 16), or the warp's matrices
// staged through shared memory (RL = 2: n = 4, 8), the faster of the two
// at each n on the H100 (k1_compare.py holds this choice against the
// other by a copy that flips it). A padded order (n below its band) loads
// directly in either layout: its rows are not aligned to vectors, and
// staging them cost more than the scalar loads at every padded n.
template <int RL>
constexpr bool kStageTransposed = RL == 2;

// ---- shared by both branches ----------------------------------------------

// |x| as an unsigned ordinal plus one, so that 0 marks a row that cannot
// pivot and a zero magnitude still beats it.
__device__ __forceinline__ unsigned mag_key(float x) {
  return __float_as_uint(fabsf(x)) + 1u;
}
__device__ __forceinline__ unsigned long long mag_key(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(fabs(x))) +
         1ull;
}

// A pivot whose zero quotients x * pivot gives exactly (finite, not 0).
__device__ __forceinline__ bool finite_nonzero(float x) {
  return __float_as_uint(fabsf(x)) - 1u < 0x7f7fffffu;
}
__device__ __forceinline__ bool finite_nonzero(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(fabs(x))) -
             1ull <
         0x7fefffffffffffffull;
}

// x, its value hidden from the compiler. A zero numerator is divided as
// 1 (and its quotient dropped for x * piv) because FCHK sends a zero
// dividend to the division's slow path, a subroutine call a lane; seeing
// that the quotient of 1 is dropped, the compiler would divide x itself
// where the select gives x, and so every zero (57.8 % of the main path's
// stage Jacobians) took the slow path: 0.1082 ms against 0.0897 on
// N(0, 1) + 16 I at (81,920, 16, 16) float32 on the H100, the same
// arithmetic (k1_compare.py --stage --variants).
__device__ __forceinline__ float opaque(float x) {
  asm("mov.b32 %0, %0;" : "+f"(x));
  return x;
}
__device__ __forceinline__ double opaque(double x) {
  asm("mov.b64 %0, %0;" : "+d"(x));
  return x;
}

// A 16-byte shared store made only where p holds, predicated rather than
// branched: one lane of the warp (the pivot row's owner) stores.
__device__ __forceinline__ void st_shared_if(bool p, float* dst, float a,
                                             float b, float c, float d) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %0, 0;\n"
      " @q st.shared.v4.f32 [%1], {%2, %3, %4, %5};\n}\n" ::"r"(
          static_cast<unsigned>(p)),
      "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "f"(a),
      "f"(b), "f"(c), "f"(d)
      : "memory");
#endif
}
__device__ __forceinline__ void st_shared_if(bool p, double* dst, double a,
                                             double b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %0, 0;\n"
      " @q st.shared.v2.f64 [%1], {%2, %3};\n}\n" ::"r"(
          static_cast<unsigned>(p)),
      "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "d"(a),
      "d"(b)
      : "memory");
#endif
}
__device__ __forceinline__ void st_shared_if(bool p, float* dst, float a,
                                             float b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %0, 0;\n"
      " @q st.shared.v2.f32 [%1], {%2, %3};\n}\n" ::"r"(
          static_cast<unsigned>(p)),
      "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "f"(a),
      "f"(b)
      : "memory");
#endif
}

// Elements a vector access of a row of NP takes: 16 bytes, or the whole
// row where it is shorter (8 bytes at NP = 2 in float32).
template <typename T, int NP>
__host__ __device__ constexpr int vec_len() {
  return 16 / static_cast<int>(sizeof(T)) < NP
             ? 16 / static_cast<int>(sizeof(T))
             : NP;
}

// Vector accesses of a row: the owner's predicated shared store, and a
// load (shared or global; src aligned to the vector).
template <typename T, int NP>
__device__ __forceinline__ void store_row(bool p, T* dst, const T (&R)[NP]) {
  constexpr int VK = vec_len<T, NP>();
#pragma unroll
  for (int q = 0; q < NP / VK; ++q) {
    if constexpr (VK == 4) {
      st_shared_if(p, dst + 4 * q, R[4 * q], R[4 * q + 1], R[4 * q + 2],
                   R[4 * q + 3]);
    } else {
      st_shared_if(p, dst + 2 * q, R[2 * q], R[2 * q + 1]);
    }
  }
}
template <typename T, int NP>
__device__ __forceinline__ void load_vec(T (&R)[NP], const T* src) {
  constexpr int VK = vec_len<T, NP>();
#pragma unroll
  for (int q = 0; q < NP / VK; ++q) {
    if constexpr (VK == 4) {
      const float4 v = reinterpret_cast<const float4*>(src)[q];
      R[4 * q] = v.x;
      R[4 * q + 1] = v.y;
      R[4 * q + 2] = v.z;
      R[4 * q + 3] = v.w;
    } else if constexpr (sizeof(T) == 4) {
      const float2 v = reinterpret_cast<const float2*>(src)[q];
      R[2 * q] = v.x;
      R[2 * q + 1] = v.y;
    } else {
      const double2 v = reinterpret_cast<const double2*>(src)[q];
      R[2 * q] = v.x;
      R[2 * q + 1] = v.y;
    }
  }
}
// ---- the warp branch: n = 1 and 17..48 -------------------------------------

// The smallest tag among the lanes that hold the largest key.
__device__ __forceinline__ unsigned warp_argmax(unsigned key, unsigned tag) {
  const unsigned best = __reduce_max_sync(kFull, key);
  return __reduce_min_sync(kFull, key == best ? tag : ~0u);
}
__device__ __forceinline__ unsigned warp_argmax(unsigned long long key,
                                                unsigned tag) {
  const unsigned hi = static_cast<unsigned>(key >> 32);
  const unsigned lo = static_cast<unsigned>(key);
  const unsigned bhi = __reduce_max_sync(kFull, hi);
  const unsigned blo = __reduce_max_sync(kFull, hi == bhi ? lo : 0u);
  return __reduce_min_sync(kFull, hi == bhi && lo == blo ? tag : ~0u);
}

// Per-warp shared layout and block size of a band NP: a tile of NP rows
// at stride NP + 1, the raw pivot row, its quotients, and the row that
// pivoted at each step. As many warps a block as fit in 48 KB of static
// shared memory, at most 4.
template <typename T, int NP>
struct WarpCfg {
  static constexpr int kRows = NP > 32 ? 2 : 1;  // rows a lane owns
  static constexpr int kLd = NP + 1;
  static constexpr int kTile = NP * kLd;
  static constexpr int kBytes =
      (kTile + 2 * NP) * static_cast<int>(sizeof(T)) + NP * 4;
  static constexpr int kWarps =
      (48 * 1024 / kBytes) < 4 ? (48 * 1024 / kBytes) : 4;
  static constexpr int kGroup = 8;  // steps a group
  static_assert(NP % 8 == 0 && NP <= kMaxN && NP % kGroup == 0, "band");
  static_assert(kWarps >= 1 && kBytes % 16 == 0, "layout");
};

// At least two blocks an SM: with that bound ptxas keeps every float32
// band free of spills.
template <typename T, int NP>
__global__ void __launch_bounds__((WarpCfg<T, NP>::kWarps * 32), 2)
    gj_inv_warp(const T* __restrict__ A, T* __restrict__ out,
                long long batch, int n, bool transposed) {
  using C = WarpCfg<T, NP>;
  constexpr int RL = C::kRows, LD = C::kLd, G = C::kGroup;
  __shared__ __align__(16) unsigned char smem[C::kWarps * C::kBytes];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const long long m = static_cast<long long>(blockIdx.x) * C::kWarps + wid;
  if (m >= batch) return;  // warp-uniform; only __syncwarp below
  T* tile = reinterpret_cast<T*>(smem + wid * C::kBytes);
  T* raw = tile + C::kTile;
  T* quot = raw + NP;
  int* pk = reinterpret_cast<int*>(quot + NP);
  const int nn = n * n;
  // e / n == (e * magic) >> 20 exactly for e < 48 * 48
  const unsigned magic = ((1u << 20) + n - 1) / n;

  // stage: n^2 contiguous elements, consecutive lanes on consecutive
  // addresses, 8 loads in flight a lane; memory row r, column c is
  // A[r][c], or A[c][r] where the input is transposed
  const T* a = A + m * nn;
  const int ld_r = transposed ? 1 : LD, ld_c = transposed ? LD : 1;
  for (int e0 = 0; e0 < nn; e0 += 8 * 32) {
    T v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * 32 + lane;
      if (e < nn) v[u] = a[e];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * 32 + lane;
      if (e < nn) {
        const int r = static_cast<int>((static_cast<unsigned>(e) * magic) >> 20);
        tile[r * ld_r + (e - r * n) * ld_c] = v[u];
      }
    }
  }
  __syncwarp();

  // lane owns row lane (R0) and, above n = 32, row lane + 32 (R1). Rows
  // n..NP-1 are an identity block whose positions are their indices; a
  // row past NP is zero, position -1. Register j holds slot
  // (j + rot) mod NP.
  T R0[NP], R1[RL == 2 ? NP : 1];
  auto load_row = [&](T(&R)[NP], int i) {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      R[j] = T(i == j);
      if (i < n && j < n) R[j] = tile[i * LD + j];
    }
    return i < NP ? i : -1;
  };
  int pos0 = load_row(R0, lane);
  int pos1 = -1;
  if constexpr (RL == 2) pos1 = load_row(R1, lane + 32);

  const int groups = (n + G - 1) / G;
#pragma unroll 1
  for (int g = 0; g < groups; ++g) {
#pragma unroll
    for (int kk = 0; kk < G; ++kk) {
      const int k = g * G + kk;  // the step; its slot is register kk
      // pivot: the largest |slot k| over rows at positions >= k, the
      // lowest position among equal magnitudes; tag = position, row
      using Key = decltype(mag_key(T(0)));
      Key lk = pos0 >= k ? mag_key(R0[kk]) : 0;
      unsigned lt = (static_cast<unsigned>(pos0) << 6) | lane;
      if constexpr (RL == 2) {
        const Key key = pos1 >= k ? mag_key(R1[kk]) : 0;
        const unsigned tag = (static_cast<unsigned>(pos1) << 6) | (lane + 32);
        if (key > lk || (key == lk && tag < lt)) {
          lk = key;
          lt = tag;
        }
      }
      const unsigned w = warp_argmax(lk, lt);
      const int wpos = static_cast<int>(w >> 6);
      const int wrow = static_cast<int>(w & 63);
      // its owner broadcasts the raw row through shared memory
      store_row(wrow == lane, raw, R0);
      if constexpr (RL == 2) store_row(wrow == lane + 32, raw, R1);
      if (lane == 0) pk[k] = wrow;
      __syncwarp();
      // lane c divides slot c by the pivot; slot kk becomes 1 / piv. A
      // zero over a finite nonzero pivot is x * piv (the same signed
      // zero), which keeps zeros off the division's slow path.
      const T piv = raw[kk];
      const bool plain_zero = finite_nonzero(piv);
#pragma unroll
      for (int c0 = 0; c0 < NP; c0 += 32) {
        // every lane divides (past NP it repeats slot NP - 1): no branch
        const int c = c0 + lane < NP ? c0 + lane : NP - 1;
        const T x = c == kk ? T(1) : raw[c];
        const bool z = plain_zero && x == T(0);
        const T q = opaque(z ? T(1) : x) / piv;
        quot[c] = z ? x * piv : q;
      }
      __syncwarp();
      T nk[NP];
      load_vec(nk, quot);
      // every row eliminates slot kk and receives the inverse's column
      // in it; the pivot row then takes the quotients
      auto update = [&](T(&R)[NP], int& pos) {
        const T f = R[kk];
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          R[j] = (j == kk ? T(0) : R[j]) - f * nk[j];
        }
        pos = pos == wpos ? k : (pos == k ? wpos : pos);
      };
      update(R0, pos0);
      if (wrow == lane) load_vec(R0, quot);
      if constexpr (RL == 2) {
        update(R1, pos1);
        if (wrow == lane + 32) load_vec(R1, quot);
      }
    }
    if constexpr (G < NP) {  // next group's slots into registers 0..G-1
      auto rotate = [](T(&R)[NP]) {
        T t[G];
#pragma unroll
        for (int j = 0; j < G; ++j) t[j] = R[j];
#pragma unroll
        for (int j = 0; j < NP - G; ++j) R[j] = R[j + G];
#pragma unroll
        for (int j = 0; j < G; ++j) R[NP - G + j] = t[j];
      };
      rotate(R0);
      if constexpr (RL == 2) rotate(R1);
    }
  }

  // out[pos][p_s] = slot s, through the tile, then a coalesced store
  const int rot = (G * groups) % NP;
  auto place_row = [&](const T(&R)[NP], int pos) {
    if (pos < 0 || pos >= n) return;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      int s = j + rot;
      if (s >= NP) s -= NP;
      if (s < n) tile[pos * LD + pk[s]] = R[j];
    }
  };
  place_row(R0, pos0);
  if constexpr (RL == 2) place_row(R1, pos1);
  __syncwarp();
  T* o = out + m * nn;
  for (int e = lane; e < nn; e += 32) {
    const int r = static_cast<int>((static_cast<unsigned>(e) * magic) >> 20);
    o[e] = tile[r * LD + e - r * n];
  }
}

// ---- the group branch: n = 2..16 -------------------------------------------

// The lowest position among the rows of largest key over a group of W
// lanes (W a power of two), by log2(W) butterfly rounds of
// __shfl_xor_sync, so every lane of the group ends with it. key, pos: the
// lane's best row (positions are distinct, and a row that can pivot has a
// key above 0). A float32 key rides with ~pos as one 64-bit pair; a
// float64 key takes a shuffle of its own.
template <int W>
__device__ __forceinline__ int group_argmax(unsigned key, int pos) {
  unsigned long long v = (static_cast<unsigned long long>(key) << 32) |
                         ~static_cast<unsigned>(pos);
#pragma unroll
  for (int s = 1; s < W; s <<= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, s, W);
    v = o > v ? o : v;
  }
  return static_cast<int>(~static_cast<unsigned>(v));
}
template <int W>
__device__ __forceinline__ int group_argmax(unsigned long long key,
                                            int pos) {
  unsigned np = ~static_cast<unsigned>(pos);
#pragma unroll
  for (int s = 1; s < W; s <<= 1) {
    const unsigned long long ok = __shfl_xor_sync(kFull, key, s, W);
    const unsigned ot = __shfl_xor_sync(kFull, np, s, W);
    if (ok > key || (ok == key && ot > np)) {
      key = ok;
      np = ot;
    }
  }
  return static_cast<int>(~np);
}

// The same by the warp branch's warp_argmax once a group: each lane's key
// and position enter its own group's full-warp reduction only (the other
// groups' lanes give key 0 and tag ~0u), 2 redux.sync a group (3 in
// float64). Cheaper than the butterfly where a warp holds 2 groups.
template <int W, typename Key>
__device__ __forceinline__ int group_argmax_redux(Key key, int pos) {
  const int g = (threadIdx.x & 31) / W;
  int p = 0;
#pragma unroll
  for (int h = 0; h < 32 / W; ++h) {
    const unsigned w = warp_argmax(g == h ? key : Key(0),
                                   g == h ? static_cast<unsigned>(pos) : ~0u);
    if (g == h) p = static_cast<int>(w);
  }
  return p;
}

// A group of N / RL lanes holds one matrix, each lane RL consecutive rows;
// per matrix in shared memory: the raw pivot row, its quotients, and a
// tile of N rows at stride N + 1 for the result. 4 warps a block.
template <typename T, int N, int RL>
struct GroupCfg {
  static constexpr int kLanes = N / RL;       // lanes a matrix
  static constexpr int kMats = 32 / kLanes;   // matrices a warp
  static constexpr int kLd = N + 1;
  static constexpr int kBytes =
      ((2 * N + N * kLd) * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
  static constexpr int kWarps = 4;
  static_assert((N & (N - 1)) == 0 && N <= 16 && (RL == 1 || RL == 2) &&
                    kLanes >= 1 && kLanes <= 32,
                "group");
};

// The slots a row of a matrix of order NV holds in the band N: NV
// rounded up to whole vectors (4 floats, 2 doubles; at most N). Slots NV
// and up are never read into the result.
template <typename T, int N, int NV>
__host__ __device__ constexpr int row_slots() {
  return (NV + vec_len<T, N>() - 1) / vec_len<T, N>() * vec_len<T, N>();
}

// The group branch's transposed input staged through shared memory (where
// kStageTransposed, at n = N only): the warp's matrices m0 .. m0 + G - 1
// are contiguous, so its lanes load them with consecutive lanes on
// consecutive 16-byte vectors (scalars where the base is not aligned to
// them), write each element into its matrix's tile at (column, row), and
// each lane then reads its rows from the tile. A matrix past the batch is
// the identity.
template <typename T, int N, int RL>
__device__ __forceinline__ void stage_transposed(
    const T* __restrict__ A, long long batch, long long m0,
    unsigned char* base, T (&R)[RL][N], int (&pos)[RL]) {
  using C = GroupCfg<T, N, RL>;
  constexpr int L = C::kLanes, G = C::kMats, LD = C::kLd;
  constexpr int VK = 16 / static_cast<int>(sizeof(T));
  const int lane = threadIdx.x & 31;
  const int gl = lane % L;
  unsigned char* wbase = base - (lane / L) * C::kBytes;
  const long long left =
      (batch - m0 < G ? batch - m0 : G) * static_cast<long long>(N * N);
  const T* a = A + m0 * (N * N);
  auto put = [&](int e, T v) {
    const int g = e / (N * N), r = (e / N) % N, c = e % N;
    reinterpret_cast<T*>(wbase + g * C::kBytes)[2 * N + c * LD + r] = v;
  };
  const bool vec = reinterpret_cast<unsigned long long>(a) % 16 == 0 &&
                   left == G * N * N && (N * N) % VK == 0;
  if (vec) {
#pragma unroll
    for (int e0 = 0; e0 < G * N * N; e0 += 32 * VK) {
      const int e = e0 + lane * VK;
      if (e < G * N * N) {
        if constexpr (sizeof(T) == 4) {
          const float4 v = *reinterpret_cast<const float4*>(a + e);
          put(e, v.x);
          put(e + 1, v.y);
          put(e + 2, v.z);
          put(e + 3, v.w);
        } else {
          const double2 v = *reinterpret_cast<const double2*>(a + e);
          put(e, v.x);
          put(e + 1, v.y);
        }
      }
    }
  } else {
#pragma unroll
    for (int e0 = 0; e0 < G * N * N; e0 += 32) {
      const int e = e0 + lane;
      if (e < G * N * N) {
        put(e, e < left ? a[e] : T((e / N) % N == e % N));
      }
    }
  }
  __syncwarp();
  const T* tile = reinterpret_cast<const T*>(base) + 2 * N;
#pragma unroll
  for (int t = 0; t < RL; ++t) {
    const int r = gl * RL + t;
    pos[t] = r;
#pragma unroll
    for (int j = 0; j < N; ++j) R[t][j] = tile[r * LD + j];
  }
  __syncwarp();
}

// N: the band, RL: rows a lane, NV: the matrices' order. NV = N at n = 2,
// 4, 8, 16; padded (NV < N: n = 3, 5-7, 9-15 in the bands 4, 8, 16) rows
// NV..N-1 are the identity's, held in registers, never loaded, stored or
// pivoting, every row holds NS = row_slots slots, and the k loop runs NV
// steps.
template <typename T, int N, int RL, int NV>
__global__ void __launch_bounds__(GroupCfg<T, N, RL>::kWarps * 32)
    gj_inv_group(const T* __restrict__ A, T* __restrict__ out,
                 long long batch, Load load) {
  using C = GroupCfg<T, N, RL>;
  constexpr int L = C::kLanes, G = C::kMats, LD = C::kLd, NN = NV * NV;
  constexpr int NS = row_slots<T, N, NV>();
  constexpr bool PAD = NV < N;
  static_assert(NV >= 2 && NV <= N && NS <= N, "order");
  __shared__ __align__(16) unsigned char smem[C::kWarps * G * C::kBytes];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int gl = lane % L;  // lane in the group
  const long long m0 = (static_cast<long long>(blockIdx.x) * C::kWarps +
                        wid) * G;  // the warp's first matrix
  // warp-uniform; a group past the batch inverts the identity, unstored,
  // so that every lane of a warp takes part in every reduction
  if (m0 >= batch) return;
  const long long m = m0 + lane / L;
  unsigned char* base = smem + (wid * G + lane / L) * C::kBytes;
  T* raw = reinterpret_cast<T*>(base);
  T* quot = raw + N;
  T* tile = quot + N;

  // rows gl * RL + t of the matrix; position = row. Row-major, a row is
  // contiguous in A; transposed, it is column r of the stored block, so
  // the group's lanes read consecutive addresses at each register j.
  T R[RL][NS];
  int pos[RL];
  bool real[RL];  // a row of the matrix, not of the identity's padding
#pragma unroll
  for (int t = 0; t < RL; ++t) real[t] = !PAD || gl * RL + t < NV;
  const bool tr = load == kTransposed;
  bool staged = false;
  if constexpr (!PAD && kStageTransposed<RL>) {
    if (tr) {
      stage_transposed<T, N, RL>(A, batch, m0, base, R, pos);
      staged = true;
    }
  }
  if (!staged) {
#pragma unroll
    for (int t = 0; t < RL; ++t) {
      const int r = gl * RL + t;
      pos[t] = r;
      const T* a = A + m * NN;
      const bool in = m < batch && real[t];
      if (tr) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          R[t][j] = in && j < NV ? a[j * NV + r] : T(r == j);
        }
      } else if (!PAD && in && load == kRowsVec) {
        load_vec(R[t], a + r * N);
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          R[t][j] = in && j < NV ? a[r * NV + j] : T(r == j);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < NV; ++k) {
    // pivot: the largest |slot k| over rows at positions >= k, the lowest
    // position among equal magnitudes; the identity's padding rows never
    // pivot (nor move: their positions stay NV..N-1)
    using Key = decltype(mag_key(T(0)));
    Key lk = 0;
    int lp = N;
#pragma unroll
    for (int t = 0; t < RL; ++t) {
      const Key key = real[t] && pos[t] >= k ? mag_key(R[t][k]) : 0;
      if (key > lk || (key == lk && pos[t] < lp)) {
        lk = key;
        lp = pos[t];
      }
    }
    int wpos;
    if constexpr (G <= 2) {
      wpos = group_argmax_redux<L>(lk, lp);
    } else {
      wpos = group_argmax<L>(lk, lp);
    }
    bool own[RL];
#pragma unroll
    for (int t = 0; t < RL; ++t) own[t] = pos[t] == wpos;
    // its owner broadcasts the raw row through shared memory
#pragma unroll
    for (int t = 0; t < RL; ++t) store_row(own[t], raw, R[t]);
    __syncwarp();
    // lane gl divides slots gl + t L by the pivot (past NS it repeats slot
    // NS - 1: no branch); slot k becomes 1 / piv. A zero over a finite
    // nonzero pivot is x * piv (the same signed zero), which keeps zeros
    // off the division's slow path.
    const T piv = raw[k];
    const bool plain_zero = finite_nonzero(piv);
#pragma unroll
    for (int t = 0; t < RL; ++t) {
      int c = gl + t * L;
      if constexpr (NS < N) c = c < NS ? c : NS - 1;
      const T x = c == k ? T(1) : raw[c];
      const bool z = plain_zero && x == T(0);
      const T q = opaque(z ? T(1) : x) / piv;
      quot[c] = z ? x * piv : q;
    }
    __syncwarp();
    T nk[NS];
    load_vec(nk, quot);
    // every row eliminates slot k and receives the inverse's column in
    // it; the pivot row then takes the quotients
#pragma unroll
    for (int t = 0; t < RL; ++t) {
      const T f = R[t][k];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        R[t][j] = (j == k ? T(0) : R[t][j]) - f * nk[j];
      }
      pos[t] = own[t] ? k : (pos[t] == k ? wpos : pos[t]);
      if (own[t]) load_vec(R[t], quot);
    }
  }

  // the row that pivoted at step j holds position j from then on:
  // out[pos][row at j] = slot j, through the tile, then the warp's
  // matrices stored coalesced
  int* row_at = reinterpret_cast<int*>(raw);
#pragma unroll
  for (int t = 0; t < RL; ++t) {
    if (real[t]) row_at[pos[t]] = gl * RL + t;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = row_at[j];
#pragma unroll
    for (int t = 0; t < RL; ++t) {
      if (real[t]) tile[pos[t] * LD + col] = R[t][j];
    }
  }
  __syncwarp();
  // the warp's matrices in the batch, at most G: where 32 does not divide
  // G n^2 (a padded n), the last step's lanes run past the warp's tiles
  const long long left = (batch - m0 < G ? batch - m0 : G) * NN;
  const unsigned char* wbase = smem + wid * G * C::kBytes;
  T* o = out + m0 * NN;
#pragma unroll
  for (int e0 = 0; e0 < G * NN; e0 += 32) {
    const int e = e0 + lane;
    if (e < left) {
      const int g = e / NN, r = (e / NV) % NV, c = e % NV;
      o[e] = reinterpret_cast<const T*>(wbase + g * C::kBytes)[2 * N +
                                                               r * LD + c];
    }
  }
}

template <typename T, int N, int RL, int NV = N>
void launch_group(const T* A, T* out, long long batch, bool transposed,
                  cudaStream_t stream) {
  using C = GroupCfg<T, N, RL>;
  const long long warps = (batch + C::kMats - 1) / C::kMats;
  const long long blocks = (warps + C::kWarps - 1) / C::kWarps;
  // row-major rows load as vectors where A is aligned to them (a fresh
  // tensor is; padded rows are not)
  constexpr int kVecBytes = vec_len<T, N>() * static_cast<int>(sizeof(T));
  const Load load =
      transposed ? kTransposed
                 : (NV == N && reinterpret_cast<unsigned long long>(A) %
                                       kVecBytes == 0
                        ? kRowsVec
                        : kRows);
  gj_inv_group<T, N, RL, NV>
      <<<static_cast<unsigned>(blocks), C::kWarps * 32, 0, stream>>>(
          A, out, batch, load);
}

template <typename T, int NP>
void launch_warp(const T* A, T* out, long long batch, int n,
                 bool transposed, cudaStream_t stream) {
  constexpr int W = WarpCfg<T, NP>::kWarps;
  const long long blocks = (batch + W - 1) / W;
  gj_inv_warp<T, NP><<<static_cast<unsigned>(blocks), W * 32, 0, stream>>>(
      A, out, batch, n, transposed);
}

// The group branch's band at order n: n itself at n = 2, 4, 8, 16, the
// next power of two at every other n <= 16 but 1 (the warp branch's n = 1
// and 17..48: 0); its rows a lane: 1 at n = 2 and 16, 2 at n = 4 and 8,
// and at the padded orders kPadRL4 (n = 3), kPadRL8 (5-7), kPadRL16
// (9-15), the faster choice on the H100 (k1_compare.py times the other).
constexpr int kPadRL4 = 2, kPadRL8 = 2, kPadRL16 = 1;
__host__ __device__ constexpr int group_band(int n) {
  return n < 2 || n > 16 ? 0 : n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : 16;
}
__host__ __device__ constexpr int group_rows(int n) {
  return n == 2 || n == 16 ? 1 : n == 4 || n == 8 ? 2
         : group_band(n) == 4 ? kPadRL4 : group_band(n) == 8 ? kPadRL8
                                                             : kPadRL16;
}

template <typename T, int NV>
void launch_group_at(const T* A, T* out, long long batch, bool tr,
                     cudaStream_t stream) {
  launch_group<T, group_band(NV), group_rows(NV), NV>(A, out, batch, tr,
                                                      stream);
}

template <typename T>
int launch(const T* A, T* out, long long batch, int n, bool tr,
           void* stream_ptr) {
  if (n < 1 || n > kMaxN || batch < 0 || batch > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (n) {
    case 2: launch_group_at<T, 2>(A, out, batch, tr, stream); break;
    case 3: launch_group_at<T, 3>(A, out, batch, tr, stream); break;
    case 4: launch_group_at<T, 4>(A, out, batch, tr, stream); break;
    case 5: launch_group_at<T, 5>(A, out, batch, tr, stream); break;
    case 6: launch_group_at<T, 6>(A, out, batch, tr, stream); break;
    case 7: launch_group_at<T, 7>(A, out, batch, tr, stream); break;
    case 8: launch_group_at<T, 8>(A, out, batch, tr, stream); break;
    case 9: launch_group_at<T, 9>(A, out, batch, tr, stream); break;
    case 10: launch_group_at<T, 10>(A, out, batch, tr, stream); break;
    case 11: launch_group_at<T, 11>(A, out, batch, tr, stream); break;
    case 12: launch_group_at<T, 12>(A, out, batch, tr, stream); break;
    case 13: launch_group_at<T, 13>(A, out, batch, tr, stream); break;
    case 14: launch_group_at<T, 14>(A, out, batch, tr, stream); break;
    case 15: launch_group_at<T, 15>(A, out, batch, tr, stream); break;
    case 16: launch_group_at<T, 16>(A, out, batch, tr, stream); break;
    default:
      switch ((n + 7) / 8) {
        case 1: launch_warp<T, 8>(A, out, batch, n, tr, stream); break;
        case 3: launch_warp<T, 24>(A, out, batch, n, tr, stream); break;
        case 4: launch_warp<T, 32>(A, out, batch, n, tr, stream); break;
        case 5: launch_warp<T, 40>(A, out, batch, n, tr, stream); break;
        default: launch_warp<T, 48>(A, out, batch, n, tr, stream); break;
      }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A: the (batch, n, n) input, row-major; the _tr entries take each matrix
// stored as its transpose (strides (n^2, 1, n)). out: row-major.
extern "C" int gj_inverse_f32(const float* A, float* out, long long batch,
                              int n, void* stream) {
  return launch<float>(A, out, batch, n, false, stream);
}

extern "C" int gj_inverse_f64(const double* A, double* out, long long batch,
                              int n, void* stream) {
  return launch<double>(A, out, batch, n, false, stream);
}

extern "C" int gj_inverse_tr_f32(const float* A, float* out,
                                 long long batch, int n, void* stream) {
  return launch<float>(A, out, batch, n, true, stream);
}

extern "C" int gj_inverse_tr_f64(const double* A, double* out,
                                 long long batch, int n, void* stream) {
  return launch<double>(A, out, batch, n, true, stream);
}

// Which branch launch() takes at order n: 16 x band + rows a lane for the
// group branch (band n, or the next power of two where it pads n), 16 x
// band for the warp branch (one warp a matrix, band the next multiple of
// 8), -1 for an n the kernel does not take.
extern "C" int gj_inverse_route(int n) {
  if (n < 1 || n > kMaxN) return -1;
  return group_band(n) ? 16 * group_band(n) + group_rows(n)
                       : 16 * ((n + 7) / 8 * 8);
}
