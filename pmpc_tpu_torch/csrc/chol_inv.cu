// Batched inverse Cholesky factor for small SPD blocks (n <= 96), one CTA per
// matrix, panel-blocked and register-tiled.
//
//   out[b] = L_b^{-1},  L_b L_b^T = A_b + diag(w_b) + jitter I   (w given)
//                       L_b L_b^T = A_b + jitter I               (w == NULL)
//
// Replaces the four TPU kernels of pmpc_tpu/ops/pallas_chol.py:
// `_chol_inv_kernel_small_diag` / `_chol_inv_kernel_big_diag` (w given) and
// `_chol_inv_kernel_small` / `_chol_inv_kernel_big` (w == NULL). The TPU pair
// "big" exists because three VMEM buffers stop fitting past n ~ 66; here one
// body serves every n and the two routes differ in the CTA's thread count
// only (kThreadsSmall up to n = 64, kThreadsBig above). Any n is taken as
// it is: nothing is padded in global memory. Only the lower triangle of A is
// read. The output is the full n x n block with explicit zeros above the diagonal: callers use
// it as a dense GEMM operand. A non-positive (or NaN) pivot makes the WHOLE
// block NaN; the other blocks of the batch are untouched (each CTA owns one
// matrix).
//
// Algorithm: one right-looking sweep over panels of NB = 8 columns builds the
// factor and its inverse together. With k the panel, D its diagonal block:
//   F1  warp 0 factors D in registers, lane r holding row r, values passed
//       with __shfl_sync, as D = M diag(p) M^T (M unit lower triangular, p the
//       pivots; L_kk = M diag(sqrt p)). A warp runs its instructions in
//       order, so the loop from one pivot to the next holds one division and
//       no square root;
//       the NB values 1 / sqrt(p) are taken afterwards, a lane each. Every
//       lane sees every pivot; `piv > 0` failing anywhere sets a flag in
//       shared memory that every thread reads before the final write;
//   -- barrier --
//   I1  row block k of the inverse is finished, one thread a column:
//       X[k, :] = L_kk^{-1} W[k, :] by forward substitution against M, then
//       the scaling by 1 / sqrt(p). W is the running sum -sum_j L_kj X_j,:
//       and W[k, k] = I, so X_kk = L_kk^{-1} comes out of the same step;
//   F2  panel solve, one thread a row below D: L_ik L_kk^T = A_ik by the
//       same substitution, written TRANSPOSED into a staging panel P (NB x n);
//   -- barrier --
//   F3  trailing update A22 -= L21 L21^T on the lower triangle, and
//   I2  W[i, :k] -= L_ik X[k, :k],  W[i, k] = -L_ik X_kk  for the rows below,
//       both as 4 x 4 register tiles a thread: per step of the panel's depth
//       two 16-byte shared loads (from P; from P or from row k of X) feed 16
//       FMAs, and the tile of A22 / W is read and written once a panel;
//   -- barrier --
// W takes the place of L below the diagonal (L_ik is dead once it is in P)
// and X_kk the place of D. Three barriers a panel: 36 at n = 96 where the
// column-by-column body this replaces had 386, and ~0.4 shared-memory
// instructions per FMA where it had 3.
//
// Layout in shared memory: only the lower triangle, in groups of four rows
// (see row_off), rows padded to a multiple of 4, so every tile is four
// 16-byte row pieces and tiles on the ragged edge (n = 90 is no multiple of
// 4 or 8) compute into padding and need no masks: 22,560 B at n = 96 in f32,
// 45,120 B in f64. Nothing is zeroed; no value of the result depends on the
// padding. The block comes in by cp.async, every copy of a CTA in flight at
// once. A second buffer to prefetch the next matrix was not taken: shared
// memory per CTA is what limits the matrices in flight on an SM (10 at
// n = 90, 29 at n = 50, in f32), and more matrices in flight measured as the
// larger lever (PERF.md), so other CTAs' work hides a CTA's load instead.
//
// Arithmetic: IEEE throughout, no fast-math and no approximate unit: an
// approximate rsqrt measurably degrades the factor (pallas_chol.py:84-87).
// The factor's entries M[r][j] = u_rj / p_j are true divisions (a product
// with 1 / p_j is 15% faster and rounds once more; on the solver's paths the
// slowest lane's iteration count moves with such a choice, PERF.md). The
// scalings by 1 / sqrt(p) in I1 and F2 are products with that reciprocal,
// NB of them a thread and panel: true divisions there make the kernel 18%
// slower, leave the residual of the conditioning checks (weights over twelve
// orders of magnitude, held to the library factor's) unchanged to four
// digits, and moved the solver's iteration counts up on as many paths as
// down (PERF.md).
// No tensor cores: the solver's cores run IEEE f32 (TF32 is off everywhere
// and would need an accuracy A/B), a block is at most 96 wide, and the sweep
// is a chain of dependent panels; f64 runs from the same template on the FMA
// units too.
//
// What bounds it: by the roofline, bytes (the lower triangle of A and w read
// once, the full block written once; the flops take half that time). It runs
// at about a sixth of that floor. What it waits on is latency, not a unit: a
// matrix is a chain of ceil(n / 8) dependent panels, each a serial stretch on
// one warp (F1) and three barriers, with few warps an SM to fill the gaps
// (shared memory and registers allow 10 CTAs at n = 90). Small CTAs win for
// that reason: 64 threads above n = 64 and 32 up to it, the fastest measured
// at each route's main shape (pmpc_tpu_torch/tune_chol_inv.py times copies of
// this source with other constants; PERF.md has the readings).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libchol_inv.so chol_inv.cu

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 96;
constexpr int kSmallN = 64;  // K1/K2 up to here, K3/K4 above
constexpr int kThreadsSmall = 32;  // threads of a CTA up to n = kSmallN
constexpr int kThreadsBig = 64;    // and above it
constexpr int kNB = 8;  // 4 or 8: tiles are 4 wide, a warp row-maps NB lanes
constexpr unsigned kFullWarp = 0xffffffffu;

static_assert(kNB == 4 || kNB == 8, "panel width");
static_assert(kThreadsSmall % 32 == 0 && kThreadsBig % 32 == 0, "whole warps");

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

// four consecutive values, moved as 16-byte shared-memory accesses
template <typename T>
struct alignas(16) Vec4 {
  T v[4];
};
template <typename T>
__device__ __forceinline__ Vec4<T> ld4(const T* p) {
  return *reinterpret_cast<const Vec4<T>*>(p);
}
template <typename T>
__device__ __forceinline__ void st4(T* p, const Vec4<T>& x) {
  *reinterpret_cast<Vec4<T>*>(p) = x;
}

// The block is kept as its lower triangle in groups of four rows: row i
// holds columns 0 .. row_len(i) - 1, the whole 4 x 4 tile on the diagonal
// included, so every tile is four 16-byte row pieces and a block takes half
// the shared memory of the square.
__host__ __device__ __forceinline__ int padded_rows(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ int row_len(int i) { return 4 * (i / 4 + 1); }
__host__ __device__ __forceinline__ int row_off(int i) {
  return (i / 4 + 1) * (8 * (i / 4) + 4 * (i % 4));
}

template <typename T, int NB>
size_t smem_bytes(int n) {
  const int nr = padded_rows(n);
  return static_cast<size_t>(row_off(nr) + NB * nr + NB * NB + NB) * sizeof(T);
}

// acc[r][c] += sum_d x[d * xs + r] * y[d * ys + c], r, c < 4, d < DEPTH
template <typename T, int DEPTH>
__device__ __forceinline__ void tile_product(const T* x, int xs, const T* y, int ys,
                                             T (&acc)[4][4]) {
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    const Vec4<T> xv = ld4(x + d * xs), yv = ld4(y + d * ys);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += xv.v[r] * yv.v[c];
  }
}

// COUNT (1 or 2) elements, global -> shared, asynchronously; both addresses
// aligned to COUNT * sizeof(T)
template <int COUNT, typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  constexpr int kBytes = COUNT * sizeof(T);
  static_assert(kBytes == 4 || kBytes == 8 || kBytes == 16, "cp.async.ca sizes");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(kBytes)
               : "memory");
}
__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// F1's loop over the columns of the diagonal block, lane row lr holding
// d = D[lr][:]: on return d holds M[lr][:] below the diagonal and `mine` the
// pivot p[lr]; true if every pivot is > 0. RAGGED stops after the kb real
// columns of a last block (the rest are identity rows); the full block's
// loop carries no such test from one pivot to the next.
template <typename T, int NB, bool RAGGED>
__device__ __forceinline__ bool factor_block(T (&d)[NB], T& mine, int lr, int kb) {
  bool spd = true;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (RAGGED && j >= kb) break;
    T piv = __shfl_sync(kFullWarp, d[j], j);
    spd = spd && (piv > T(0));
    piv = piv > T(0) ? piv : quiet_nan<T>();
    if (lr == j) mine = piv;
    const T u = d[j];
    d[j] = u / piv;  // M[lr][j]
#pragma unroll
    for (int c = j + 1; c < NB; ++c) {
      const T ucj = __shfl_sync(kFullWarp, u, c);
      if (lr >= c) d[c] -= d[j] * ucj;
    }
  }
  return spd;
}

template <typename T, bool HAS_DIAG, int THREADS, int NB>
__global__ void __launch_bounds__(THREADS)
    chol_inv_kernel(const T* __restrict__ A, const T* __restrict__ w, T jitter,
                    T* __restrict__ out, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int not_spd;
  const int nr = padded_rows(n), np = (n + NB - 1) / NB;
  T* a = reinterpret_cast<T*>(smem_raw);  // the triangle: A, then L, then W / X
  T* P = a + row_off(nr);                    // NB x nr: the panel L[:, k]^T
  T* Mk = P + NB * nr;                    // NB x NB: M of the panel's diagonal block
  T* rk = Mk + NB * NB;                   // NB: 1 / diag(L_kk)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kWarps = THREADS / 32;
  const long long b = blockIdx.x;
  const T* Ab = A + b * n * n;

  // load the lower triangle, a warp a row, every copy in flight at once,
  // two elements a copy where n is even and the batch is aligned for it (the
  // odd element past the diagonal is never used); then the diagonal shift.
  // Nothing is zeroed: the upper triangle and the padding are written and
  // read by edge tiles, but no value of the result depends on them.
  if (n % 2 == 0 && reinterpret_cast<unsigned long long>(A) % (2 * sizeof(T)) == 0) {
    for (int i = warp; i < n; i += kWarps)
      for (int j = 2 * lane; j <= i; j += 64)
        copy_async<2>(a + row_off(i) + j, Ab + i * n + j);
  } else {
    for (int i = warp; i < n; i += kWarps)
      for (int j = lane; j <= i; j += 32)
        copy_async<1>(a + row_off(i) + j, Ab + i * n + j);
  }
  T shift[(kMaxN + THREADS - 1) / THREADS];
#pragma unroll
  for (int q = 0; q < (kMaxN + THREADS - 1) / THREADS; ++q) {
    const int i = tid + q * THREADS;
    shift[q] = (HAS_DIAG && i < n) ? w[b * n + i] + jitter : jitter;
  }
  if (tid == 0) not_spd = 0;
  copy_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int q = 0; q < (kMaxN + THREADS - 1) / THREADS; ++q) {
    const int i = tid + q * THREADS;
    if (i < n) a[row_off(i) + i] += shift[q];
  }
  __syncthreads();

  for (int p = 0; p < np; ++p) {
    const int k0 = p * NB;

    // F1, warp 0: D = M diag(p) M^T in registers, M unit lower triangular, p
    // the pivots, so L_kk = M diag(sqrt p): lane row lr = lane % NB, every lane
    // sees every pivot, a ragged last block is completed by identity rows.
    // A warp runs its instructions in order, so whatever it does between two
    // pivots delays the whole CTA: the loop holds one division a column and
    // no square root; the NB values 1 / sqrt(p) are taken afterwards, a lane
    // each.
    if (warp == 0) {
      const int lr = lane & (NB - 1);
      T d[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c)
        d[c] = (k0 + lr < n && c <= lr) ? a[row_off(k0 + lr) + k0 + c]
                                        : (c == lr ? T(1) : T(0));
      T mine = T(1);  // p[lr]
      const bool spd = (k0 + NB <= n) ? factor_block<T, NB, false>(d, mine, lr, NB)
                                      : factor_block<T, NB, true>(d, mine, lr, n - k0);
      if (!spd && lane == 0) not_spd = 1;
      if (lane < NB) {
#pragma unroll
        for (int c = 0; c < NB; ++c) Mk[lr * NB + c] = d[c];
        rk[lr] = T(1) / sqrt(mine);
      }
    }
    __syncthreads();

    // I1 (a column a thread, from the last thread down) and F2 (a row a
    // thread, from the first up): forward substitutions against M, then the
    // scaling by 1 / diag(L_kk)
    const int nI1 = min(k0 + NB, n), nF2 = n - k0 - NB;
    if (THREADS - 1 - tid < nI1 || tid < nF2) {
      T m[NB][NB], rs[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
#pragma unroll
        for (int q = 0; q < (i + 3) / 4; ++q) {
          const Vec4<T> t = ld4(Mk + i * NB + 4 * q);
#pragma unroll
          for (int c = 0; c < 4; ++c) m[i][4 * q + c] = t.v[c];
        }
        rs[i] = rk[i];
      }
      // I1: X[k, :] = L_kk^{-1} W[k, :], where W[k, k] = I gives X_kk itself,
      // written over the diagonal block (which F1 has consumed) as far as
      // the rows reach (what they do not hold of X_kk is zero)
      for (int j = THREADS - 1 - tid; j < nI1; j += THREADS) {
        T x[NB];
#pragma unroll
        for (int i = 0; i < NB; ++i)
          x[i] = (j >= k0) ? (j - k0 == i ? T(1) : T(0))
                           : (k0 + i < n ? a[row_off(k0 + i) + j] : T(0));
#pragma unroll
        for (int i = 0; i < NB; ++i) {
#pragma unroll
          for (int c = 0; c < i; ++c) x[i] -= m[i][c] * x[c];
          if (k0 + i < n && j < row_len(k0 + i)) a[row_off(k0 + i) + j] = x[i] * rs[i];
        }
      }
      // F2: L_ik L_kk^T = A_ik, into P transposed
      for (int i = k0 + NB + tid; i < n; i += THREADS) {
        T x[NB];
#pragma unroll
        for (int q = 0; q < NB / 4; ++q) {
          const Vec4<T> t = ld4(a + row_off(i) + k0 + 4 * q);
#pragma unroll
          for (int c = 0; c < 4; ++c) x[4 * q + c] = t.v[c];
        }
#pragma unroll
        for (int c = 0; c < NB; ++c) {
#pragma unroll
          for (int k = 0; k < c; ++k) x[c] -= x[k] * m[c][k];
          P[c * nr + i] = x[c] * rs[c];
        }
      }
    }
    if (k0 + NB >= n) break;  // the last panel has nothing below it
    __syncthreads();

    // F3 (the first nTri tiles: lower triangle of A22) and I2 (tr x ct tiles:
    // the rows below against the columns up to and including panel k)
    const int base = k0 + NB, tr = (nr - base) / 4, ct = base / 4;
    const int nTri = tr * (tr + 1) / 2, nTiles = nTri + tr * ct;
    for (int idx = tid; idx < nTiles; idx += THREADS) {
      T acc[4][4] = {};
      int i0, j0;
      bool fresh = false;  // I2 into panel k's own columns: W = -L_ik X_kk
      if (idx < nTri) {
        int ti = static_cast<int>((sqrtf(8.0f * idx + 1.0f) - 1.0f) * 0.5f);
        if (ti * (ti + 1) / 2 > idx) --ti;
        else if ((ti + 1) * (ti + 2) / 2 <= idx) ++ti;
        i0 = base + 4 * ti;
        j0 = base + 4 * (idx - ti * (ti + 1) / 2);
        tile_product<T, NB>(P + i0, nr, P + j0, nr, acc);
      } else {
        const int q = idx - nTri, ti = q / ct;
        i0 = base + 4 * ti;
        j0 = 4 * (q - ti * ct);
        fresh = j0 >= k0;
        // four rows of X at a time: they share a length, and those that end
        // before column j0 hold zeros of X_kk there
#pragma unroll
        for (int h = 0; h < NB; h += 4)
          if (j0 < row_len(k0 + h))
            tile_product<T, 4>(P + h * nr + i0, nr, a + row_off(k0 + h) + j0,
                               row_len(k0 + h), acc);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        T* row = a + row_off(i0 + r) + j0;
        Vec4<T> t;
        if (fresh) {
#pragma unroll
          for (int c = 0; c < 4; ++c) t.v[c] = -acc[r][c];
        } else {
          t = ld4(row);
#pragma unroll
          for (int c = 0; c < 4; ++c) t.v[c] -= acc[r][c];
        }
        st4(row, t);
      }
    }
    __syncthreads();
  }
  __syncthreads();  // the last I1 and the flag, before they are read

  T* ob = out + b * n * n;
  const bool spd = not_spd == 0;
  const T nan = quiet_nan<T>();
  for (int i = warp; i < n; i += kWarps) {
#pragma unroll
    for (int q = 0; q < kMaxN / 32; ++q) {
      const int j = lane + 32 * q;
      if (j < n) ob[i * n + j] = !spd ? nan : (i >= j ? a[row_off(i) + j] : T(0));
    }
  }
}

// launched alone, it measures what a launch costs when the kernel does nothing
__global__ void empty_kernel() {}

// One instantiation. A block takes at most 45,120 B of shared memory (f64 at
// n = 96), under the 48 KB a kernel may use without opting in.
template <typename T, bool HAS_DIAG, int THREADS>
int launch_one(const T* A, const T* w, T jitter, T* out, long long batch, int n,
               cudaStream_t s) {
  chol_inv_kernel<T, HAS_DIAG, THREADS, kNB>
      <<<static_cast<unsigned>(batch), THREADS, smem_bytes<T, kNB>(n), s>>>(
          A, w, jitter, out, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* A_, const void* w_, double jitter_, void* out_,
           long long batch, int n, void* stream) {
  if (n < 1 || n > kMaxN || batch < 0 || batch > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const T* A = static_cast<const T*>(A_);
  const T* w = static_cast<const T*>(w_);
  T* out = static_cast<T*>(out_);
  const T jitter = static_cast<T>(jitter_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = n <= kSmallN;
  if (w != nullptr) {
    return small ? launch_one<T, true, kThreadsSmall>(A, w, jitter, out, batch, n, s)
                 : launch_one<T, true, kThreadsBig>(A, w, jitter, out, batch, n, s);
  }
  return small ? launch_one<T, false, kThreadsSmall>(A, w, jitter, out, batch, n, s)
               : launch_one<T, false, kThreadsBig>(A, w, jitter, out, batch, n, s);
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

// One launch of a kernel that does nothing: the floor under any launch-bound
// call such as (64, 10, 10).
extern "C" int pmpc_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
