// Batched inverse Cholesky factor for small SPD blocks (n <= 96), one CTA per
// matrix.
//
//   out[b] = L_b^{-1},  L_b L_b^T = A_b + diag(w_b) + jitter I   (w given)
//                       L_b L_b^T = A_b + jitter I               (w == NULL)
//
// Twin of the four TPU kernels of pmpc_tpu/ops/pallas_chol.py:
// `_chol_inv_kernel_small_diag` / `_chol_inv_kernel_big_diag` (w given) and
// `_chol_inv_kernel_small` / `_chol_inv_kernel_big` (w == NULL). The TPU pair
// "big" exists because three VMEM buffers stop fitting past n ~ 66; here one
// body serves every n and what changes with the size is the CTA's thread
// count (a template parameter: 128 or 256, chosen by the caller) and, above
// 48 KB of shared memory (f64 from n = 77), the dynamic shared memory opt-in.
// Any n is taken as it is: no padding to a multiple of 8. Only the lower
// triangle of A is read. The output is the full n x n block with explicit
// zeros above the diagonal: callers use it as a dense GEMM operand.
// A non-positive (or NaN) pivot makes the WHOLE block NaN; the other blocks
// of the batch are untouched (each CTA owns one matrix).
//
// Layout: the block lives in shared memory with an odd row stride n | 1
// (conflict-free column walks; results do not depend on the stride). The
// factor overwrites the lower triangle column by column (right-looking, 2
// barriers per column); the inverse factor is then built in place by
// right-looking forward substitution, its strictly-lower entries X[i][j]
// stored TRANSPOSED in the (unused) upper triangle at a[j][i], so L and X
// never share a slot. At n = 96 that is 37,632 B in f32 and 75,264 B in f64.
// sqrt and divisions are exact (no fast-math): an approximate rsqrt
// measurably degrades the factor (see pallas_chol.py:84-87).
//
// What bounds it: by the roofline, bytes (each block read and written once;
// the flops are a third of that time), but the kernel runs far from that
// floor: every FMA of the two triangular sweeps reads and writes shared
// memory, and each of the 2n column steps waits on two barriers. Several
// CTAs per SM overlap those waits (6 at n = 90 in f32).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libchol_inv.so chol_inv.cu

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 96;
constexpr int kTx = 32;  // threads over columns; TY (template) threads over rows
constexpr size_t kStaticSmemLimit = 48 * 1024;  // above it: opt-in per kernel

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

__host__ __device__ __forceinline__ int row_stride(int n) { return n | 1; }

template <typename T>
size_t smem_bytes(int n) {
  return (static_cast<size_t>(n) * row_stride(n) + 2 * n) * sizeof(T);
}

template <typename T, bool HAS_DIAG, int TY>
__global__ void __launch_bounds__(kTx * TY)
    chol_inv_kernel(const T* __restrict__ A, const T* __restrict__ w, T jitter,
                    T* __restrict__ out, int n) {
  constexpr int kTy = TY;
  constexpr int kThreads = kTx * TY;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = row_stride(n);
  T* a = reinterpret_cast<T*>(smem_raw);  // n x ld
  T* ldiag = a + n * ld;                  // L[k][k]
  T* xdiag = ldiag + n;                   // X[k][k] = 1 / L[k][k]
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

// One instantiation: opt in to more than 48 KB of dynamic shared memory (once
// per instantiation and device is enough; the attribute call is cheap and its
// error is returned like the launch's), then launch.
template <typename T, bool HAS_DIAG, int TY>
int launch_one(const T* A, const T* w, T jitter, T* out, long long batch, int n,
               cudaStream_t s) {
  const size_t smem = smem_bytes<T>(n);
  if (smem > kStaticSmemLimit) {
    const cudaError_t e = cudaFuncSetAttribute(
        chol_inv_kernel<T, HAS_DIAG, TY>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  chol_inv_kernel<T, HAS_DIAG, TY>
      <<<dim3(static_cast<unsigned>(batch)), dim3(kTx, TY), smem, s>>>(
          A, w, jitter, out, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* A_, const void* w_, double jitter_, void* out_,
           long long batch, int n, int threads, void* stream) {
  if (n < 1 || n > kMaxN || batch < 0 || batch > 2147483647LL ||
      (threads != 128 && threads != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const T* A = static_cast<const T*>(A_);
  const T* w = static_cast<const T*>(w_);
  T* out = static_cast<T*>(out_);
  const T jitter = static_cast<T>(jitter_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != nullptr) {
    return threads == 128 ? launch_one<T, true, 4>(A, w, jitter, out, batch, n, s)
                          : launch_one<T, true, 8>(A, w, jitter, out, batch, n, s);
  }
  return threads == 128 ? launch_one<T, false, 4>(A, w, jitter, out, batch, n, s)
                        : launch_one<T, false, 8>(A, w, jitter, out, batch, n, s);
}

}  // namespace

// C entry points (ctypes). `w` may be NULL (no diagonal term); `threads` is
// the CTA size, 128 or 256. Returns the cudaError_t of the shared-memory
// opt-in or of the launch; 0 on success.
extern "C" int pmpc_chol_inv_f32(const void* A, const void* w, double jitter,
                                 void* out, long long batch, int n, int threads,
                                 void* stream) {
  return launch<float>(A, w, jitter, out, batch, n, threads, stream);
}

extern "C" int pmpc_chol_inv_f64(const void* A, const void* w, double jitter,
                                 void* out, long long batch, int n, int threads,
                                 void* stream) {
  return launch<double>(A, w, jitter, out, batch, n, threads, stream);
}
