// K5: the box IPM's factored Hessian apply, one pass over each particle's
// condensed dynamics map.
//
//   Hw_p = Ft_p^T (Qt_p (Ft_p w_p)) + Rt_p w_p + sl_p (T (x) I) w_p + sl0_p E00 w_p,
//   w_p  = [uc_b; uf_p]                       (particle p of scenario b)
//
// with Ft_p (N xdim x N udim) block lower-triangular: Ft[j, l] = 0 for l > j
// (`dynamics.condense`), Qt_p and Rt_p block diagonal (N blocks of xdim x xdim
// and udim x udim), T the slew's time-coupling matrix (`reduced._slew_T`).
//
// Replaces no TPU kernel: the JAX package computes
// pmpc_tpu/solvers/reduced.py::H_apply_factored with XLA dots. It was added
// because on the card the same arithmetic in PyTorch, two batched gemvs over
// the dense Ft (cuBLAS gemvx), two small batched products and ~10 elementwise
// kernels, was the largest device cost of the box IPM: Ft read twice, whole,
// every iteration, upper zero blocks included.
//
// Bound: the bytes of Ft's N (N + 1) / 2 lower blocks, read once, at the
// memory rate; everything else a particle reads (Qt, Rt, w) or writes (Hw) is
// ~N / 2 times smaller, and the work is 4 flops a byte-pair of Ft in f32, far
// below the card's ratio. At the flagship width (N 30, xdim 4, udim 2, f32)
// that is 14.9 KB a particle; at B M = 32,768 0.49 GB, 0.146 ms at 3.35 TB/s.
//
// Design, per particle: one walk over the row blocks j = 0..N-1. Row block j
// is xdim rows of (j + 1) udim contiguous lower columns; the particle's threads
// (TPP, a power of two up to a warp) own its columns in 16-byte chunks,
// neighbouring threads on neighbouring chunks, so a row is read with coalesced
// vector copies and no upper block is read (the last chunk of a row may reach
// past column (j + 1) udim: the copy takes the lower entries alone and fills
// the rest with zeros). Each thread
//   1. takes its chunks of the row block;
//   2. forms its partial dot products with w, one a row, and a butterfly of
//      warp shuffles over the TPP threads gives every thread y_j = Ft[j, :] w;
//   3. forms v_j = Qt_j y_j (xdim^2 FMAs, repeated by every thread);
//   4. adds Ft[j, :]^T v_j into the column sums z of its own chunks, from the
//      same registers.
// z needs no reduction across threads: a column's sum stays with the thread
// that owns its chunk. The epilogue adds Rt w and the slew terms, reading w
// (uc and uf directly, no concatenated copy) from shared memory, and writes
// Hw (B, M, NU) once. No atomics: the result is deterministic.
//
// What bounds the walk is the memory's latency, not its rate: the row blocks
// of a particle are read one after the other, ~0.5-1.6 KB each, so the card
// is fed only by many particles' row blocks in flight at once. Two paths.
// Where a row block fits one register tile (xdim <= kRows and its chunks <=
// kChunks x TPP: every configuration of the benchmark), row block j + 1 (and
// Q_{j+1}) is copied by cp.async into a ring of kStages stages in shared
// memory while row block j is reduced, each thread into slots of its own,
// and w and z sit in registers. The stages and the register cap set how many
// particles an SM holds: measured on the H100 at the three cells' shapes,
// two stages and five CTAs of 128 threads an SM beat three to six stages,
// 64 or 256 threads and 4 or 6 CTAs (PERF.md §6). Larger row blocks
// walk in tiles of kRows rows by kChunks x TPP chunks, z and y in shared
// memory, and read each tile a second time for step 4: that read hits L1 /
// L2, device memory still reads Ft once. Nothing of Ft is staged whole in
// shared memory, so one design serves every N.
//
// Arithmetic: FP32 FMAs in f32 (no tensor cores, no TF32: the IPM's residual
// needs full f32), FP64 in f64. The sums run in another order than cuBLAS's,
// so the result is not bit-identical to the PyTorch formula. A non-finite
// lower entry of Ft (a non-finite fx) or of w makes that particle's Hw
// non-finite, as the formula's does.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // a CTA: 128 / TPP particles
constexpr int kRows = 4;       // rows of a row block a thread holds at once
constexpr int kChunks = 2;     // chunks of a row a thread holds at once
constexpr int kStages = 2;     // row blocks in flight a particle (one-tile path)
constexpr int kMinCtas = 5;    // CTAs an SM holds: caps the registers at 102
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(T (&dst)[VEC], const T* p) {
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else if constexpr (VEC == 2) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p));
    dst[0] = v.x; dst[1] = v.y;
  } else {
    dst[0] = __ldg(p);
  }
}

// One tile of row block j into f: rows r0 + r (< xdim), chunks
// q = q0 + c * tpp + t (< Cj), entries of column < L; zeros elsewhere.
template <typename T, int VEC>
__device__ __forceinline__ void load_tile(T (&f)[kRows][kChunks][VEC], const T* Fj, int NU,
                                          int xdim, int r0, int q0, int tpp, int t, int Cj,
                                          int L, bool live) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int q = q0 + c * tpp + t;
      if (live && r0 + r < xdim && q < Cj) {
        load_chunk<T, VEC>(f[r][c], Fj + static_cast<long long>(r0 + r) * NU + q * VEC);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (q * VEC + e >= L) f[r][c][e] = T(0);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[r][c][e] = T(0);
      }
    }
  }
}

// Values of the one-tile path's ring of kStages row blocks: each thread's
// kRows x kChunks chunks, then Q_j (kRows^2) for each of the CTA's particles.
template <int VEC>
__host__ __device__ constexpr int ring_size(int ppc) {
  return kStages * (kRows * kChunks * kThreads * VEC + ppc * kRows * kRows);
}

// cp.async of n <= VEC values from global to shared memory, the rest of the
// VEC zero-filled (n = 0 reads nothing)
template <typename T, int VEC>
__device__ __forceinline__ void cp_async(T* dst, const T* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = n * static_cast<int>(sizeof(T));
  if constexpr (VEC * sizeof(T) == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(VEC * sizeof(T)), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int VEC>
__device__ __forceinline__ void load_smem(T (&dst)[VEC], const T* p) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else if constexpr (VEC == 2) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    dst[0] = v.x; dst[1] = v.y;
  } else {
    dst[0] = *p;
  }
}

// The sum of x over the tpp threads of a particle, in every one of them.
template <typename T>
__device__ __forceinline__ T particle_sum(T x, int tpp) {
  for (int off = tpp >> 1; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Rt w + the slew terms at column c, added to z in the formula's order.
template <typename T>
__device__ __forceinline__ T epilogue(T z, const T* w, const T* Rp, T sl, T sl0, int c,
                                      int N, int udim) {
  const int l = c / udim;
  const int b = c - l * udim;
  const T* R = Rp + (static_cast<long long>(l) * udim + b) * udim;
  T rw = T(0);
  for (int k = 0; k < udim; ++k) rw += R[k] * w[l * udim + k];
  T s = T(0);  // ((T (x) I) w)_c, as the formula builds it
  if (l < N - 1) s -= w[c + udim] - w[c];
  if (l > 0) s += w[c] - w[c - udim];
  T h = z + rw;
  h = h + sl * s;
  if (l == 0) h = h + sl0 * w[c];
  return h;
}

template <typename T, int VEC, bool ONE_TILE>
__global__ void __launch_bounds__(kThreads, kMinCtas)
hessian_apply_kernel(const T* __restrict__ Ft, const T* __restrict__ Qt,
                     const T* __restrict__ Rt, const T* __restrict__ sl,
                     const T* __restrict__ sl0, const T* __restrict__ uc,
                     const T* __restrict__ uf, T* __restrict__ out, long long P, int M,
                     int N, int xdim, int udim, int nc, int tpp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NU = N * udim, NX = N * xdim, nf = NU - nc;
  const int slot = threadIdx.x / tpp;  // the CTA's particle
  const int t = threadIdx.x - slot * tpp;  // the thread within it
  const int ppc = kThreads / tpp;
  const long long p = static_cast<long long>(blockIdx.x) * ppc + slot;
  const bool live = p < P;
  // shared memory: on the one-tile path the ring (`ring_size`) and then w
  // (NU a particle); on the tiled path w, z (NU) and y (xdim) a particle
  T* w = reinterpret_cast<T*>(smem_raw) +
         (ONE_TILE ? ring_size<VEC>(ppc) + slot * NU : slot * (2 * NU + xdim));
  if (live) {
    const long long b = p / M;
    for (int c = t; c < NU; c += tpp)
      w[c] = c < nc ? uc[b * nc + c] : uf[p * nf + (c - nc)];
  }
  __syncwarp();
  const long long pc = live ? p : 0;  // no pointer past the arrays
  const T* F = Ft + pc * NX * NU;
  const T* Q = Qt + pc * N * xdim * xdim;
  const T* Rp = Rt + pc * N * udim * udim;
  const int C = (NU + VEC - 1) / VEC;  // chunks of a row
  T* o = out + pc * NU;

  if constexpr (ONE_TILE) {
    // the stages of the ring, then Q_j a particle a stage, then w: each
    // thread's chunks of row block j sit in its own slots, (stage, r, c, tid)
    T* Fs = reinterpret_cast<T*>(smem_raw);
    T* Qs = Fs + kStages * kRows * kChunks * kThreads * VEC;
    // w and z of the thread's chunks q = c * tpp + t in registers
    T wr[kChunks][VEC], z[kChunks][VEC];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int q = c * tpp + t;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        wr[c][e] = q < C ? w[q * VEC + e] : T(0);
        z[c][e] = T(0);
      }
    }
    const int xx = xdim * xdim;
    // row block j into stage j % kStages: the thread's chunks, the lower
    // entries copied and the rest zero-filled; Q_j shared by the particle
    auto issue = [&](int j) {
      const int st = j % kStages;
      const T* Fj = F + static_cast<long long>(j) * xdim * NU;
      const int L = (j + 1) * udim;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int q = c * tpp + t;
          const int n = live && r < xdim && q < C ? min(max(L - q * VEC, 0), VEC) : 0;
          cp_async<T, VEC>(Fs + (((st * kRows + r) * kChunks + c) * kThreads + threadIdx.x) * VEC,
                           n ? Fj + static_cast<long long>(r) * NU + q * VEC : F, n);
        }
      }
      if (live) {
        const T* Qj = Q + static_cast<long long>(j) * xx;
        for (int k = t; k < xx; k += tpp)
          cp_async<T, 1>(Qs + (st * ppc + slot) * kRows * kRows + k, Qj + k, 1);
      }
    };
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
      if (j < N) issue(j);
      cp_async_commit();
    }
    for (int j = 0; j < N; ++j) {
      __syncwarp();  // the stage refilled next was read by every thread
      if (j + kStages - 1 < N) issue(j + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();  // row block j has landed
      __syncwarp();  // and Q_j, copied by other threads, is seen
      const int st = j % kStages;
      T f[kRows][kChunks][VEC];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          load_smem<T, VEC>(f[r][c],
                            Fs + (((st * kRows + r) * kChunks + c) * kThreads + threadIdx.x) * VEC);
      T y[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc += f[r][c][e] * wr[c][e];
        y[r] = particle_sum(acc, tpp);
      }
      const T* Qj = Qs + (st * ppc + slot) * kRows * kRows;
      T v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        T acc = T(0);
        if (r < xdim) {
#pragma unroll
          for (int k = 0; k < kRows; ++k)
            if (k < xdim) acc += Qj[r * xdim + k] * y[k];
        }
        v[r] = acc;
      }
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          T acc = z[c][e];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc += f[r][c][e] * v[r];
          z[c][e] = acc;
        }
    }
    if (live) {
      const T s = sl[p], s0 = sl0[p];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int q = c * tpp + t;
        if (q < C) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            o[q * VEC + e] = epilogue(z[c][e], w, Rp, s, s0, q * VEC + e, N, udim);
        }
      }
    }
  } else {
    T* z = w + NU;
    T* y = z + NU;
    if (live)
      for (int c = t; c < NU; c += tpp) z[c] = T(0);
    __syncwarp();
    const int tile = kChunks * tpp;  // chunks a tile spans
    const int groups = (xdim + kRows - 1) / kRows;
    T f[kRows][kChunks][VEC];
    for (int j = 0; j < N; ++j) {
      const int L = (j + 1) * udim;
      const int Cj = (L + VEC - 1) / VEC;
      const T* Fj = F + static_cast<long long>(j) * xdim * NU;
      const T* Qj = Q + static_cast<long long>(j) * xdim * xdim;
      // y = Ft[j, :] w, a group of kRows rows at a time
      for (int g = 0; g < groups; ++g) {
        T part[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) part[r] = T(0);
        for (int q0 = 0; q0 < Cj; q0 += tile) {
          load_tile<T, VEC>(f, Fj, NU, xdim, g * kRows, q0, tpp, t, Cj, L, live);
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const int q = q0 + c * tpp + t;
            if (q < Cj) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) {
                const T wc = w[q * VEC + e];
#pragma unroll
                for (int r = 0; r < kRows; ++r) part[r] += f[r][c][e] * wc;
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const T s = particle_sum(part[r], tpp);
          if (live && t == 0 && g * kRows + r < xdim) y[g * kRows + r] = s;
        }
      }
      __syncwarp();
      // z += Ft[j, :]^T (Qt_j y), the tiles read again
      for (int g = 0; g < groups; ++g) {
        T v[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int a = g * kRows + r;
          T acc = T(0);
          if (live && a < xdim)
            for (int k = 0; k < xdim; ++k) acc += __ldg(Qj + a * xdim + k) * y[k];
          v[r] = acc;
        }
        for (int q0 = 0; q0 < Cj; q0 += tile) {
          load_tile<T, VEC>(f, Fj, NU, xdim, g * kRows, q0, tpp, t, Cj, L, live);
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const int q = q0 + c * tpp + t;
            if (live && q < Cj) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) {
                T acc = z[q * VEC + e];
#pragma unroll
                for (int r = 0; r < kRows; ++r) acc += f[r][c][e] * v[r];
                z[q * VEC + e] = acc;
              }
            }
          }
        }
      }
      __syncwarp();  // y is written again by the next row block
    }
    if (live) {
      const T s = sl[p], s0 = sl0[p];
      for (int c = t; c < NU; c += tpp) o[c] = epilogue(z[c], w, Rp, s, s0, c, N, udim);
    }
  }
}

// One instantiation. Above 48 KB of shared memory (the one-tile path's ring
// takes 35-39 KB, w up to 16 KB more; the tiled path's NU past ~1,500 in f64)
// the kernel opts in to more.
template <typename T, int VEC, bool ONE_TILE>
int launch_one(const T* Ft, const T* Qt, const T* Rt, const T* sl, const T* sl0,
               const T* uc, const T* uf, T* out, long long P, int M, int N, int xdim,
               int udim, int nc, int tpp, cudaStream_t s) {
  const int NU = N * udim;
  const int ppc = kThreads / tpp;
  const size_t smem = (ONE_TILE ? static_cast<size_t>(ring_size<VEC>(ppc)) + ppc * NU
                                : static_cast<size_t>(ppc) * (2 * NU + xdim)) * sizeof(T);
  auto kernel = hessian_apply_kernel<T, VEC, ONE_TILE>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long grid = (P + ppc - 1) / ppc;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(Ft, Qt, Rt, sl, sl0, uc, uf,
                                                             out, P, M, N, xdim, udim, nc, tpp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* Ft_, const void* Qt_, const void* Rt_, const void* sl_,
           const void* sl0_, const void* uc_, const void* uf_, void* out_, long long P,
           int M, int N, int xdim, int udim, int nc, void* stream) {
  if (P < 0 || M < 1 || N < 1 || xdim < 1 || udim < 1 || nc < 0 || nc > N * udim)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return 0;
  constexpr int kVec = 16 / sizeof(T);
  const int NU = N * udim;
  // 16-byte loads where every row starts on a 16-byte boundary
  const bool vec = NU % kVec == 0 && reinterpret_cast<uintptr_t>(Ft_) % 16 == 0;
  const int C = vec ? NU / kVec : NU;  // chunks of a row
  int tpp = 1;  // threads a particle: the fewest powers of two that cover
  while (tpp < 32 && tpp * kChunks < C) tpp *= 2;  // a row in one tile
  const bool one = xdim <= kRows && C <= kChunks * tpp;
  const long long ppc = kThreads / tpp;
  if ((P + ppc - 1) / ppc > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* Ft = static_cast<const T*>(Ft_);
  const auto* Qt = static_cast<const T*>(Qt_);
  const auto* Rt = static_cast<const T*>(Rt_);
  const auto* sl = static_cast<const T*>(sl_);
  const auto* sl0 = static_cast<const T*>(sl0_);
  const auto* uc = static_cast<const T*>(uc_);
  const auto* uf = static_cast<const T*>(uf_);
  auto* out = static_cast<T*>(out_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    return one ? launch_one<T, kVec, true>(Ft, Qt, Rt, sl, sl0, uc, uf, out, P, M, N, xdim,
                                           udim, nc, tpp, s)
               : launch_one<T, kVec, false>(Ft, Qt, Rt, sl, sl0, uc, uf, out, P, M, N, xdim,
                                            udim, nc, tpp, s);
  return one ? launch_one<T, 1, true>(Ft, Qt, Rt, sl, sl0, uc, uf, out, P, M, N, xdim, udim,
                                      nc, tpp, s)
             : launch_one<T, 1, false>(Ft, Qt, Rt, sl, sl0, uc, uf, out, P, M, N, xdim, udim,
                                       nc, tpp, s);
}

}  // namespace

// C entry points (ctypes). Every array is contiguous: Ft (P, N xdim, N udim),
// Qt (P, N, xdim, xdim), Rt (P, N, udim, udim), sl and sl0 (P), uc (P / M, nc),
// uf (P, N udim - nc), out (P, N udim); P = B M particles, M a scenario.
// Returns the cudaError_t of the launch; 0 on success.
extern "C" int pmpc_hessian_apply_f32(const void* Ft, const void* Qt, const void* Rt,
                                      const void* sl, const void* sl0, const void* uc,
                                      const void* uf, void* out, long long P, int M, int N,
                                      int xdim, int udim, int nc, void* stream) {
  return launch<float>(Ft, Qt, Rt, sl, sl0, uc, uf, out, P, M, N, xdim, udim, nc, stream);
}

extern "C" int pmpc_hessian_apply_f64(const void* Ft, const void* Qt, const void* Rt,
                                      const void* sl, const void* sl0, const void* uc,
                                      const void* uf, void* out, long long P, int M, int N,
                                      int xdim, int udim, int nc, void* stream) {
  return launch<double>(Ft, Qt, Rt, sl, sl0, uc, uf, out, P, M, N, xdim, udim, nc, stream);
}
