// Batched inverse Cholesky factor for small SPD blocks, one CTA per matrix.
//
//   out[b] = L_b^{-1},  L_b L_b^T = A_b + diag(w_b) + jitter I   (w given)
//                       L_b L_b^T = A_b + jitter I               (w == NULL)
//
// Twin of the TPU kernels `_chol_inv_kernel_small_diag` (w given) and
// `_chol_inv_kernel_small` (w == NULL) in pmpc_tpu/ops/pallas_chol.py. Only
// the lower triangle of A is read. The output is the full n x n block with
// explicit zeros above the diagonal: callers use it as a dense GEMM operand.
// A non-positive (or NaN) pivot makes the WHOLE block NaN; the other blocks
// of the batch are untouched (each CTA owns one matrix).
//
// Layout: the block lives in shared memory with a padded row stride n + 1
// (conflict-free column walks in f32). The factor overwrites the lower
// triangle column by column (right-looking, 2 barriers per column); the
// inverse factor is then built in place by right-looking forward
// substitution, its strictly-lower entries X[i][j] stored TRANSPOSED in the
// (unused) upper triangle at a[j][i], so L and X never share a slot.
// sqrt and divisions are exact (no fast-math): an approximate rsqrt
// measurably degrades the factor (see pallas_chol.py:84-87).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libchol_inv.so chol_inv.cu

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kTx = 32;  // threads over columns
constexpr int kTy = 4;   // threads over rows
constexpr int kThreads = kTx * kTy;

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

template <typename T, bool HAS_DIAG>
__global__ void __launch_bounds__(kThreads)
    chol_inv_kernel(const T* __restrict__ A, const T* __restrict__ w, T jitter,
                    T* __restrict__ out, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a = reinterpret_cast<T*>(smem_raw);  // n x ld
  T* ldiag = a + n * (n + 1);             // L[k][k]
  T* xdiag = ldiag + n;                   // X[k][k] = 1 / L[k][k]
  const int ld = n + 1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTx + tx;
  const long long b = blockIdx.x;
  const T* Ab = A + b * n * n;

  // load the lower triangle (+ diagonal shift); zero the upper triangle,
  // which later holds X transposed
  for (int e = tid; e < n * n; e += kThreads) {
    const int i = e / n, j = e - i * n;
    T v = T(0);
    if (i > j) {
      v = Ab[e];
    } else if (i == j) {
      v = HAS_DIAG ? Ab[e] + (w[b * n + i] + jitter) : Ab[e] + jitter;
    }
    a[i * ld + j] = v;
  }
  __syncthreads();

  // right-looking Cholesky: column j scaled by its pivot, then the rank-1
  // downdate of the trailing lower triangle. Every thread reads the same
  // pivot, so `spd` is uniform across the CTA.
  bool spd = true;
  for (int j = 0; j < n; ++j) {
    const T piv = a[j * ld + j];
    spd = spd && (piv > T(0));
    const T d = sqrt(piv > T(0) ? piv : quiet_nan<T>());
    if (tid == 0) ldiag[j] = d;
    for (int i = j + 1 + tid; i < n; i += kThreads) a[i * ld + j] /= d;
    __syncthreads();
    for (int i = j + 1 + ty; i < n; i += kTy) {
      const T lij = a[i * ld + j];
      for (int k = j + 1 + tx; k <= i; k += kTx) a[i * ld + k] -= lij * a[k * ld + j];
    }
    __syncthreads();
  }

  // X = L^{-1} by right-looking forward substitution. Step k finalises row k
  // of X (divide by L[k][k]), then removes L[i][k] X[k][:] from rows i > k.
  // X[i][j] (i > j) lives at a[j * ld + i]; reads of L touch only the lower
  // triangle and writes only the upper one.
  for (int k = 0; k < n; ++k) {
    const T lkk = ldiag[k];
    for (int j = tid; j < k; j += kThreads) a[j * ld + k] = a[j * ld + k] / lkk;
    if (tid == 0) xdiag[k] = T(1) / lkk;
    __syncthreads();
    for (int i = k + 1 + ty; i < n; i += kTy) {
      const T lik = a[i * ld + k];
      for (int j = tx; j <= k; j += kTx) {
        const T xkj = (j == k) ? xdiag[k] : a[j * ld + k];
        a[j * ld + i] -= lik * xkj;
      }
    }
    __syncthreads();
  }

  T* ob = out + b * n * n;
  const T nan = quiet_nan<T>();
  for (int e = tid; e < n * n; e += kThreads) {
    const int i = e / n, j = e - i * n;
    T v = (i > j) ? a[j * ld + i] : (i == j ? xdiag[i] : T(0));
    ob[e] = spd ? v : nan;
  }
}

template <typename T>
int launch(const void* A, const void* w, double jitter, void* out,
           long long batch, int n, void* stream) {
  if (n < 1 || n > kMaxN || batch < 0 || batch > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const size_t smem = (static_cast<size_t>(n) * (n + 1) + 2 * n) * sizeof(T);
  const dim3 grid(static_cast<unsigned>(batch));
  const dim3 block(kTx, kTy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != nullptr) {
    chol_inv_kernel<T, true><<<grid, block, smem, s>>>(
        static_cast<const T*>(A), static_cast<const T*>(w), static_cast<T>(jitter),
        static_cast<T*>(out), n);
  } else {
    chol_inv_kernel<T, false><<<grid, block, smem, s>>>(
        static_cast<const T*>(A), nullptr, static_cast<T>(jitter),
        static_cast<T*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (ctypes). `w` may be NULL (no diagonal term). Returns the
// cudaError_t of the launch; 0 on success.
extern "C" int pmpc_chol_inv_f32(const void* A, const void* w, double jitter,
                                 void* out, long long batch, int n, void* stream) {
  return launch<float>(A, w, jitter, out, batch, n, stream);
}

extern "C" int pmpc_chol_inv_f64(const void* A, const void* w, double jitter,
                                 void* out, long long batch, int n, void* stream) {
  return launch<double>(A, w, jitter, out, batch, n, stream);
}
