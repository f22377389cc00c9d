// Batched explicit inverse of small general matrices by Gauss-Jordan
// elimination with partial pivoting, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel acados_tpu/ops/batched_inv.py:_gj_inv_kernel
// (launched by _gj_inverse_pallas, public entry gj_inverse_any). It
// computes the same function: for each matrix, Gauss-Jordan on [A | I];
// at step k the pivot is the row i >= k of largest |M[i][k]|, the lowest
// row index among equal magnitudes (what jnp.argmax picks); rows k and p
// are swapped, the pivot row is divided by the pivot, and column k is
// eliminated from every other row. The plain PyTorch version of the same
// loop is acados_tpu_torch/ops/batched_inv.py:gj_inverse_plain.
//
// Layout: the natural row-major (batch, n, n) tensor, read once and
// written once. No batch-minor relayout and no identity padding of the
// batch: lanes past the end of the batch compute on an identity and do
// not store.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside
// the tensor cores), at the main path's shape (81,920, 16, 16) float32:
//   bytes: 2 * 81,920 * 256 * 4 B = 168 MB  -> 50 us
//   flops: n steps * (n - 1) rows * 2n columns multiply-subtracts
//          ~ 4 n^3 = 16.4 kFLOP a matrix = 1.34 GFLOP -> 20 us
// so a launch is memory-bound, with a bound of about 50 us.
//
// Design against that bound: every matrix stays on chip for all n
// elimination steps, so device memory sees exactly one read of A and one
// write of A^-1.
//   - n in {2, 4, 8, 16} (template instances): a group of 2n lanes holds
//     one matrix in registers, lane j owning column j of [A | I]; a warp
//     holds 32 / (2n) matrices. The pivot search runs in lane k of the
//     group, and __shfl_sync broadcasts the pivot row index, the pivot
//     and the column-k elimination factors. Row swaps are unrolled
//     selects, so no register array is indexed at run time.
//   - any other n <= 48: one warp per matrix with [A | I] in shared
//     memory, a warp-shuffle argmax for the pivot, and each lane owning
//     the columns j = lane, lane + 32, ...
// Making it fast (coalesced loads through shared memory, more matrices
// per warp, keeping the stage matrices resident across the Newton
// iterations) is later work.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 48;

__device__ __forceinline__ float abs_val(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_val(double x) { return fabs(x); }

template <typename T, int N>
__global__ void gj_inv_reg(const T* __restrict__ A, T* __restrict__ out,
                           long long batch) {
  constexpr int W = 2 * N;       // lanes per matrix, a power of two
  constexpr int G = 32 / W;      // matrices per warp
  const int lane = threadIdx.x & 31;
  const int j = lane % W;        // owned column of [A | I]
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long m = warp * G + lane / W;
  const bool valid = m < batch;
  const T* a = A + m * N * N;

  T c[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (j < N) {
      c[i] = valid ? a[i * N + j] : T(i == j);
    } else {
      c[i] = T(i == j - N);
    }
  }

#pragma unroll
  for (int k = 0; k < N; ++k) {
    // pivot search (meaningful in lane k of the group)
    int p = k;
    T best = abs_val(c[k]);
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const T v = abs_val(c[i]);
      if (v > best) {
        best = v;
        p = i;
      }
    }
    p = __shfl_sync(kFull, p, k, W);
    // swap rows k and p
    const T ck = c[k];
    T cp = ck;
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      if (i == p) {
        cp = c[i];
        c[i] = ck;
      }
    }
    c[k] = cp;
    // normalise the pivot row, eliminate column k from every other row
    const T piv = __shfl_sync(kFull, c[k], k, W);
    const T nk = c[k] / piv;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T f = __shfl_sync(kFull, c[i], k, W);
      if (i != k) c[i] = c[i] - f * nk;
    }
    c[k] = nk;
  }

  if (valid && j >= N) {
    T* o = out + m * N * N;
#pragma unroll
    for (int i = 0; i < N; ++i) o[i * N + (j - N)] = c[i];
  }
}

template <typename T>
__global__ void gj_inv_smem(const T* __restrict__ A, T* __restrict__ out,
                            int n) {
  extern __shared__ unsigned char smem_raw[];
  T* M = reinterpret_cast<T*>(smem_raw);  // [A | I], n x 2n row-major
  T* fcol = M + 2 * n * n;                 // column-k factors
  const int nc = 2 * n;
  const int lane = threadIdx.x;
  const long long m = blockIdx.x;
  const T* a = A + m * n * n;

  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e % n;
    M[i * nc + j] = a[e];
    M[i * nc + n + j] = T(i == j);
  }
  __syncwarp();

  for (int k = 0; k < n; ++k) {
    // warp argmax of |M[i][k]| over i >= k, lowest index on ties
    T best = T(-1);
    int p = n;
    for (int i = k + lane; i < n; i += 32) {
      const T v = abs_val(M[i * nc + k]);
      if (v > best) {
        best = v;
        p = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const T ob = __shfl_down_sync(kFull, best, off);
      const int op = __shfl_down_sync(kFull, p, off);
      if (ob > best || (ob == best && op < p)) {
        best = ob;
        p = op;
      }
    }
    p = __shfl_sync(kFull, p, 0);
    if (p != k) {
      for (int j = lane; j < nc; j += 32) {
        const T t = M[k * nc + j];
        M[k * nc + j] = M[p * nc + j];
        M[p * nc + j] = t;
      }
    }
    __syncwarp();
    const T piv = M[k * nc + k];
    for (int i = lane; i < n; i += 32) fcol[i] = M[i * nc + k];
    __syncwarp();
    for (int j = lane; j < nc; j += 32) {
      const T nk = M[k * nc + j] / piv;
      for (int i = 0; i < n; ++i) {
        if (i != k) M[i * nc + j] = M[i * nc + j] - fcol[i] * nk;
      }
      M[k * nc + j] = nk;
    }
    __syncwarp();
  }

  T* o = out + m * n * n;
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e % n;
    o[e] = M[i * nc + n + j];
  }
}

template <typename T, int N>
void launch_reg(const T* A, T* out, long long batch, cudaStream_t stream) {
  constexpr int kThreads = 128;
  constexpr long long kPerBlock = (kThreads / 32) * (32 / (2 * N));
  const long long blocks = (batch + kPerBlock - 1) / kPerBlock;
  gj_inv_reg<T, N><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      A, out, batch);
}

template <typename T>
int launch(const T* A, T* out, long long batch, int n, void* stream_ptr) {
  if (n < 1 || n > kMaxN || batch < 0 || batch > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (n) {
    case 2: launch_reg<T, 2>(A, out, batch, stream); break;
    case 4: launch_reg<T, 4>(A, out, batch, stream); break;
    case 8: launch_reg<T, 8>(A, out, batch, stream); break;
    case 16: launch_reg<T, 16>(A, out, batch, stream); break;
    default: {
      const size_t smem = static_cast<size_t>(2 * n * n + n) * sizeof(T);
      gj_inv_smem<T><<<static_cast<unsigned>(batch), 32, smem, stream>>>(
          A, out, n);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gj_inverse_f32(const float* A, float* out, long long batch,
                              int n, void* stream) {
  return launch<float>(A, out, batch, n, stream);
}

extern "C" int gj_inverse_f64(const double* A, double* out, long long batch,
                              int n, void* stream) {
  return launch<double>(A, out, batch, n, stream);
}
