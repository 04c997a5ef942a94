// Shared device and launch code of the structured kernels of step 1
// (pose1.cu) and step 2 (pose2.cu), and of the per-camera sums of the
// camera-table kernels (cam.cu).
//
// Every kernel is one pass over the observations, one thread per
// observation in a grid-stride loop (the fused terms: per slot row of a
// tile), on observation-last arrays ([k, O] rows: neighbouring threads
// read neighbouring addresses). Most kernels read the [12, N] camera
// table(s) they gather from in place, where L1 and L2 hold them (657 KB
// in f32 at N = 13,682): staging a table in shared memory once per block
// (the earlier version) was within noise at N = 89 and 1.02-2.2x slower
// at N = 1,024 (tools/route_ab.py).
// The fused terms, whose tables share a block with a per-camera
// accumulator, stage theirs where both fit (stage_table).
// Per-camera sums go into shared-memory accumulators (through
// warp_scatter in the moment and Schur-Jacobi kernels and the fused
// terms) and leave the block as one global atomicAdd per non-zero entry;
// scalar sums leave as one partial per block, which the caller adds up.
//
// The arithmetic follows the Pallas bodies of povar_tpu/ops/pallas_pose.py
// term for term (same products, same summation order), so a kernel and
// its plain PyTorch version (ops/pose_ref.py) differ only by FMA
// contraction and, for per-camera sums, by the order of the atomics
// (the moment and Schur-Jacobi kernels also regroup their products into
// moments).

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace povar {

constexpr int kThreads = 256;

// grid-stride loop over the observation axis, in 64 bits: o + stride
// never wraps, and with the kernels' `const long O` every k * O + o is a
// 64-bit offset (an [R, O] operand passes 2^31 entries at R >= 94 on
// final-13682's 22.9M slot rows)
#define POVAR_OBS_LOOP(o, n_obs)                                          \
  for (long o = (long)blockIdx.x * blockDim.x + threadIdx.x; o < (n_obs); \
       o += (long)gridDim.x * blockDim.x)

template <typename T>
__device__ __forceinline__ void smem_copy(T* dst, const T* __restrict__ src,
                                          int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

template <typename T>
__device__ __forceinline__ void smem_zero(T* dst, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = T(0);
}

// The [rows, N] camera table(s) a kernel gathers from (its "table
// route"): with kStaged, copied into the kernel's shared memory at `smem`
// once per block (then a barrier) and read there by index; otherwise read
// in place from device memory, where the 50 MB L2 holds it (657 KB in
// f32 at N = 13,682, past the 227 KB a block may opt in to). The
// launcher picks kStaged where the bytes fit a block. All of the block's
// threads must call it.
template <bool kStaged, typename T>
__device__ __forceinline__ const T* stage_table(T* smem,
                                                const T* __restrict__ src,
                                                int count) {
  if (!kStaged) return src;
  smem_copy(smem, src, count);
  __syncthreads();
  return smem;
}

// The kernel's dynamic shared memory as an array of V (float or double:
// the camera-table kernels of csrc/cam.cu come in both)
template <typename V>
__device__ __forceinline__ V* dyn_smem();

template <>
__device__ __forceinline__ float* dyn_smem<float>() {
  extern __shared__ float dyn_smem_f32[];
  return dyn_smem_f32;
}

template <>
__device__ __forceinline__ double* dyn_smem<double>() {
  extern __shared__ double dyn_smem_f64[];
  return dyn_smem_f64;
}

// one global atomic per non-zero accumulator entry (adding an exact
// zero changes nothing, so the entries no observation touched stay home);
// T = double sums the blocks' partials in f64 (a native global atomic);
// the accumulator is of type A (f32, or f64 in the f64 instantiations)
template <typename T, typename A>
__device__ __forceinline__ void flush_acc(T* __restrict__ dst,
                                          const A* acc, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const A v = acc[i];
    if (v != A(0)) atomicAdd(dst + i, (T)v);
  }
}

// a parameter of type T whose T is not deduced from it (a null argument)
template <typename T>
struct NoDeduce {
  using type = T;
};

constexpr unsigned kFullMask = 0xffffffffu;

// Add v[0..K) to rows 0..K-1 of the [K, n] accumulator `acc` at column
// c, for every live lane of a converged warp (dead lanes pass zeros and
// any c). The lanes on one camera first sum their values into their
// lowest lane, which alone adds them: no two lanes of the warp then add
// to one address, so a shared-memory float atomic (a compare-and-swap
// loop on this card) never retries against its own warp, and with
// kAtomic false (an accumulator the warp owns) a plain add is safe. The
// lowest lane adds its peers' values one by one in lane order. A pairwise
// (butterfly) sum where a whole warp shares a camera is faster on the
// camera-sorted lane orders (71-75 us against 115-125 for the moment
// kernels on the mesh's window order), but in hpp_b_structured it put
// POWER_SCHUR_COMPLEMENT's step-1 final cost past chip_smoke.py's band
// more often on the 1-device mesh: 2 of 32 runs against 0 of 32 with the
// f64 cross-block sums (6-11 of 16 per call against 0 of 32 with f32
// ones) (tools/step2_spread.py and PERF.md; NVIDIA H100 80GB HBM3,
// 700 W).
//
// It comes in two halves, for a row whose values are scattered in
// several calls (csrc/cam.cu's hpp_b adds 90 values a row): warp_peers
// matches the lanes on one camera once, and warp_scatter_rows then sums
// K values over those peers and adds them into rows 0..K-1 of `acc` at
// column c (the caller offsets acc to its first row). The values are of
// type V (f32, or f64 in the f64 camera-table kernels), the accumulator
// of type T.
struct WarpPeers {
  unsigned rest;  // a lead's peers above it, in lane order; 0 elsewhere
  bool lead;      // the lowest live lane of its camera
};

__device__ __forceinline__ WarpPeers warp_peers(int c, bool live) {
  const int lane = threadIdx.x & 31;
  const unsigned live_mask = __ballot_sync(kFullMask, live);
  const unsigned peers =
      __match_any_sync(kFullMask, live ? c : -1) & live_mask;
  const bool lead = live && lane == __ffs(peers) - 1;
  return {lead ? peers & (peers - 1u) : 0u, lead};
}

template <int K, bool kAtomic = true, typename T = float, typename V = float>
__device__ __forceinline__ void warp_scatter_rows(T* acc, int n, int c,
                                                  const WarpPeers& p,
                                                  V (&v)[K]) {
  const int lane = threadIdx.x & 31;
  unsigned rest = p.rest;
  while (__any_sync(kFullMask, rest != 0u)) {
    const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const V t = __shfl_sync(kFullMask, v[k], src);
      if (rest) v[k] += t;
    }
    rest &= rest - 1u;
  }
  // a warp-owned accumulator: this call's leads may read what another
  // lane of the warp added in an earlier call
  if (!kAtomic) __syncwarp();
  if (p.lead) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (kAtomic)
        atomicAdd(&acc[k * n + c], (T)v[k]);
      else
        acc[k * n + c] += v[k];
    }
  }
}

template <int K, bool kAtomic = true, typename T = float, typename V = float>
__device__ __forceinline__ void warp_scatter(T* acc, int n, int c, bool live,
                                             V (&v)[K]) {
  if (!__any_sync(kFullMask, live)) return;
  warp_scatter_rows<K, kAtomic, T>(acc, n, c, warp_peers(c, live), v);
}

// True in every thread of the last block to take a ticket from `ticket`
// (which the caller zeroed or the previous call's last block reset); all
// of the block's threads must call it. Every block's writes before its
// call are then visible to the last block (read them with __ldcg: they
// never passed this SM's L1); `thread0_only`: only thread 0 wrote.
__device__ __forceinline__ bool last_block(unsigned* ticket,
                                           bool thread0_only = false) {
  __shared__ bool last;
  if (!thread0_only || threadIdx.x == 0) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// ------------------------------------------------- per-camera sum routes
// Where a block's per-camera accumulators live (csrc/cam.cu's e0_scatter
// and hpp_b, the Schur-Jacobi kernels and the composed-term scatters
// below):
//   kPrivate  one f32 copy per warp in shared memory, which the warp adds
//             to with plain adds;
//   kShared   `copies` f32 copies per block, copy w mod copies shared by
//             warp w's group with shared atomics (a compare-and-swap loop
//             on this card);
//   kGlobal   none: every value goes to a global atomic in acc_g.
// The copies are of the values' type: f32, or f64 in the f64 camera-table
// kernels of csrc/cam.cu (whose values, copies and sums are all f64).
// The lanes of a warp on one camera first sum their values in lane order
// (warp_peers / warp_scatter_rows), so no two lanes of a warp ever add to
// one address. A block then adds its copies per entry and sends the
// non-zero sums to global atomics in acc_g (f64 or f32, as each kernel
// says), and the last block to take a ticket writes the output in f32
// from acc_g and leaves acc_g and the ticket zeroed for the next call
// (ops/pose_kernels.py keeps one such buffer per device and stream,
// zeroed once).
enum class Route { kPrivate, kShared, kGlobal };

// this warp's accumulator copy of `n_acc` entries, zeroed; null on the
// global route (all of the block's threads must call it)
template <Route R, typename A>
__device__ __forceinline__ A* warp_copy(A* smem, int copies, int n_acc) {
  if (R == Route::kGlobal) return nullptr;
  smem_zero(smem, copies * n_acc);
  __syncthreads();
  return smem + ((threadIdx.x >> 5) % copies) * n_acc;
}

// the K values v of this lane's row into rows row0 .. row0 + K - 1 of
// this warp's accumulator (on the global route: the sums, of type T, in
// acc_g) at column c
template <int K, Route R, typename T, typename A>
__device__ __forceinline__ void add_rows(A* acc, double* acc_g, int row0,
                                         int n, int c, const WarpPeers& p,
                                         A (&v)[K]) {
  if (R == Route::kGlobal)
    warp_scatter_rows<K, true, T>(reinterpret_cast<T*>(acc_g) + row0 * n, n,
                                  c, p, v);
  else
    warp_scatter_rows<K, R == Route::kShared>(acc + row0 * n, n, c, p, v);
}

__device__ __forceinline__ unsigned* ticket_of(double* acc_g, int count) {
  return reinterpret_cast<unsigned*>(acc_g + count);
}

// Once the block's warps have added every row: the block's copies, in
// groups of kGroup summed per entry (in the copies' type A), go to global
// atomics into the [count] sums of type T at acc_g (all of the block's
// threads must call it; nothing on the global route, whose values went
// there directly).
template <Route R, typename T, int kGroup, typename A>
__device__ __forceinline__ void flush_copies(double* acc_g, const A* smem,
                                             int copies, int n_acc,
                                             int count) {
  if (R == Route::kGlobal) return;
  T* sums = reinterpret_cast<T*>(acc_g);
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    for (int k0 = 0; k0 < copies; k0 += kGroup) {
      A s = smem[k0 * n_acc + i];
#pragma unroll
      for (int k = 1; k < kGroup; ++k)
        if (k0 + k < copies) s += smem[(k0 + k) * n_acc + i];
      if (s != 0.0f) atomicAdd(sums + i, (T)s);
    }
  }
}

// flush_copies, then true in the last block to take the ticket behind
// the sums (at acc_g + count doubles), which then holds every block's
// sums (all of the block's threads must call it)
template <Route R, typename T, int kGroup, typename A>
__device__ __forceinline__ bool block_sums_done(double* acc_g, const A* smem,
                                                int copies, int n_acc,
                                                int count) {
  flush_copies<R, T, kGroup>(acc_g, smem, copies, n_acc, count);
  return last_block(ticket_of(acc_g, count));
}

// The last block: write(i, sum) for every entry i of the [count] sums of
// type T at acc_g (kB L2 reads in flight per thread), then the sums and
// the ticket zeroed again.
constexpr int kBatch = 16;  // independent L2 reads in flight per thread

template <typename T, int kB = kBatch, typename Write>
__device__ __forceinline__ void drain_sums(double* acc_g, int count,
                                           Write write) {
  T* sums = reinterpret_cast<T*>(acc_g);
  for (int i0 = threadIdx.x; i0 < count; i0 += kB * blockDim.x) {
    T s[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int i = i0 + u * blockDim.x;
      s[u] = i < count ? __ldcg(sums + i) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < count) {
        write(i, s[u]);
        sums[i] = T(0);
      }
    }
  }
  if (threadIdx.x == 0) *ticket_of(acc_g, count) = 0u;
}

// ------------------------------------------------------ per-camera moments
// Hpp of both steps is sum w K (x) xh xh^T with
//   K = [[1, 0, -k1], [0, 1, -k2], [-k1, -k2, k3]]
// (step 1: k = (sp2 u, sp2 v, sp2 (u^2 + v^2)); step 2: (mx, my,
// mx^2 + my^2)), so every 4x4 block of it is +-1 times one of the four
// moment matrices sum w k_t xh xh^T (k_0 = 1), or exactly 0 (blocks
// (0,1) and (1,0)). A moment kernel accumulates, per camera, kMomentRows
// values: b (rows 0-11), then moment 10 t + p in row 12 + 10 t + p for
// weight t and upper-triangle entry p of xh xh^T in row-major order
// ((0,0) (0,1) (0,2) (0,3) (1,1) (1,2) (1,3) (2,2) (2,3) (3,3)); the last
// block expands them through ops/pose_kernels.moment_expand_table.
constexpr int kMoments = 40;
constexpr int kMomentRows = 12 + kMoments;
constexpr int kExpandChunk = 256;  // cameras per staged chunk (global route)

// v[12 + 10 t + p] = kw[t] xh_i xh_j for every upper-triangle entry p
// (V: float, or double in the f64 instantiations)
template <typename V>
__device__ __forceinline__ void moments(const V kw[4], const V xh[4],
                                        V (&v)[kMomentRows]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = i; j < 4; ++j) {
      const int p = i * (7 - i) / 2 + j;  // upper-triangle entry (i, j)
      const V xx = xh[i] * xh[j];
#pragma unroll
      for (int t = 0; t < 4; ++t) v[12 + 10 * t + p] = kw[t] * xx;
    }
  }
}

// The tail of a moment kernel: once every block's sums are in `acc_g`
// [(kLead + kMom) N + 1] of T (kLead rows of other sums, kMom moment rows,
// then a ticket, zero on entry), the last block to take the ticket writes
// every entry of hpp [144, N]: row r is sign * moment |e| - 1 for e =
// expand[r] (ops/pose_kernels.moment_expand_table, schur_expand_table),
// or 0 where e is 0; and, where `b` is given, b [kLead, N] from acc_g's
// first rows. With kReset it leaves the moments and the ticket zeroed
// for the next call. `smem` holds at least kMom x `chunk` values of the
// outputs' type Out (f32, or f64 in the f64 instantiations: the moments
// of a chunk of cameras are staged there); all of the block's threads
// must call it.
template <int kMom = kMoments, int kLead = 12, bool kReset = false,
          typename T, typename Out>
__device__ __forceinline__ void expand_moments(
    const int* __restrict__ expand, Out* __restrict__ hpp,
    typename NoDeduce<Out>::type* __restrict__ b, T* acc_g, int n_cams,
    int chunk, Out* smem) {
  __shared__ int ex[144];
  unsigned* ticket =
      reinterpret_cast<unsigned*>(acc_g + (kLead + kMom) * n_cams);
  if (!last_block(ticket)) return;
  for (int i = threadIdx.x; i < 144; i += blockDim.x) ex[i] = expand[i];
  if (b != nullptr) {
    for (int i = threadIdx.x; i < kLead * n_cams; i += blockDim.x)
      b[i] = (Out)__ldcg(acc_g + i);
  }
  T* mom = acc_g + kLead * n_cams;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int c0 = 0; c0 < n_cams; c0 += chunk) {
    const int nc = min(chunk, n_cams - c0);
    __syncthreads();
    // kBatch independent L2 reads per thread in flight (the other blocks'
    // atomics never passed this SM's L1): with kReset and one chunk (the
    // moments contiguous, as smem is) over every entry, read before any
    // of them is zeroed; otherwise a warp per moment row
    if (kReset && nc == n_cams) {
      const int count = kMom * nc;
      for (int i0 = threadIdx.x; i0 < count; i0 += kBatch * blockDim.x) {
        Out m[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * blockDim.x;
          m[u] = i < count ? (Out)__ldcg(mom + i) : Out(0);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * blockDim.x;
          if (i < count) {
            smem[i] = m[u];
            mom[i] = T(0);
          }
        }
      }
    } else {
      for (int k = warp; k < kMom; k += n_warps) {
        for (int cc0 = lane; cc0 < nc; cc0 += 32 * kBatch) {
          Out m[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int cc = cc0 + 32 * u;
            m[u] = cc < nc ? (Out)__ldcg(mom + k * n_cams + c0 + cc)
                           : Out(0);
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int cc = cc0 + 32 * u;
            if (cc < nc) {
              smem[k * nc + cc] = m[u];
              if (kReset) mom[k * n_cams + c0 + cc] = T(0);
            }
          }
        }
      }
    }
    __syncthreads();
    for (int row = warp; row < 144; row += n_warps) {
      const int e = ex[row];
      const Out* src = smem + (e == 0 ? 0 : abs(e) - 1) * nc;
      Out* dst = hpp + row * n_cams + c0;
      for (int cc = lane; cc < nc; cc += 32)
        dst[cc] = e == 0 ? Out(0) : e > 0 ? src[cc] : -src[cc];
    }
  }
  if (kReset && threadIdx.x == 0) *ticket = 0u;
}

// ------------------------------------------------- Schur-Jacobi moments
// Both steps' Schur-Jacobi corrections are, per camera, [144, N] rows
// (4a+i)*12 + 4b+j = sum H[a][b] xh_i xh_j over the camera's live rows,
// with H a symmetric 3x3 per row (step 1: h^T h, xh = [x, 1]; step 2:
// (sw/p2)^2 C^T B B^T C, xh = x4). Only 6 x 10 = 60 of those sums are
// distinct: moment 10 s + p = sum H_s xx_p for the upper-triangle entry
// s = (a, b), a <= b, of H (row-major: (0,0) (0,1) (0,2) (1,1) (1,2)
// (2,2)) and the upper-triangle entry p of xh xh^T (as kMoments'). A live
// row adds those 60 values through warp_peers / warp_scatter_rows (the
// lanes of a warp on one camera sum first) on the route sums_plan picks:
// kSchurWarps per-warp private copies with plain adds while kSchurMinWarps
// copies of 60 N floats fit a block (N up to 241), else shared copies in
// 512-thread blocks (up to N = 964), else f64 global atomics. The blocks'
// sums meet in f64 in `acc_g` [60 N + 1] doubles (the moments, then a
// ticket), zero on entry; the last block writes all 144 rows through
// ops/pose_kernels.schur_expand_table (expand_moments: a row and its
// mirror from one moment, so the output is symmetric bit for bit) and
// leaves acc_g zeroed.
constexpr int kSchurMoments = 60;
constexpr int kSchurWarps = 10;
constexpr int kSchurMinWarps = 4;
constexpr int kSchurSharedThreads = 512;
// static shared memory a Schur-Jacobi kernel declares: expand_moments'
// table of 144 ints and last_block's flag, rounded up
constexpr size_t kSchurStaticSmem = 1024;

__host__ __device__ constexpr int schur_threads(Route r) {
  return r == Route::kPrivate ? 32 * kSchurWarps : kSchurSharedThreads;
}

// v[10 s + p] = H[s] (xh_i xh_j) for every upper-triangle entry s of H
// and p = (i, j) of xh xh^T
template <typename V>
__device__ __forceinline__ void schur_moments(const V H[6], const V xh[4],
                                              V (&v)[kSchurMoments]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = i; j < 4; ++j) {
      const int p = i * (7 - i) / 2 + j;
      const V xx = xh[i] * xh[j];
#pragma unroll
      for (int s = 0; s < 6; ++s) v[10 * s + p] = H[s] * xx;
    }
  }
}

// One exchange of warp_reduce_scatter: w[0..2 W) to w[0..W), the half
// this lane's bit W / 2 selects, plus its partner's other half
template <int W, typename V>
__device__ __forceinline__ void reduce_scatter_step(V (&w)[32], int lane) {
  const bool hi = lane & (W / 2);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const V a = w[k], b = w[k + W];
    w[k] = (hi ? b : a) + __shfl_xor_sync(kFullMask, hi ? a : b, W / 2);
  }
}

// v[0..K) (K <= 64) of every lane of a warp summed over the warp as a
// reduce-scatter tree: in five shuffle-exchange steps (lane offsets 16,
// 8, 4, 2, 1) each lane keeps the half of its own and its partner's
// values that its lane bit selects, so lane l ends with the sums of
// values 2 l and 2 l + 1 (62 shuffles a lane, not a walk's (peers - 1)
// K). All lanes of the warp must call it. V: float, or double in the
// f64 instantiations.
template <int K, typename V>
__device__ __forceinline__ void warp_reduce_scatter(const V (&v)[K],
                                                    V (&sum)[2]) {
  static_assert(K <= 64, "two sums a lane");
  const int lane = threadIdx.x & 31;
  V w[32];
  const bool top = lane & 16;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const V a = k < K ? v[k] : V(0);
    const V b = k + 32 < K ? v[k + 32] : V(0);
    w[k] = (top ? b : a) + __shfl_xor_sync(kFullMask, top ? a : b, 16);
  }
  reduce_scatter_step<16>(w, lane);
  reduce_scatter_step<8>(w, lane);
  reduce_scatter_step<4>(w, lane);
  reduce_scatter_step<2>(w, lane);
  sum[0] = w[0];
  sum[1] = w[1];
}

// v[0..K) (K <= 16) of every lane of a warp summed over the warp: three
// reduce-scatter exchanges within each group of 8 lanes (offsets 4, 2,
// 1; 14 shuffles) leave lane l with its group's sums of values
// 2 (l mod 8) and 2 (l mod 8) + 1, and two butterfly steps (offsets 8,
// 16) add the four groups' (18 shuffles a lane, not a walk's 31 K). All
// lanes of the warp must call it. V: float, or double in the f64
// camera-table kernels.
template <int K, typename V>
__device__ __forceinline__ void warp_reduce_scatter16(const V (&v)[K],
                                                      V (&sum)[2]) {
  static_assert(K <= 16, "16 values a warp");
  const int lane = threadIdx.x & 31;
  V w[32];
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = k < K ? v[k] : V(0);
  reduce_scatter_step<8>(w, lane);
  reduce_scatter_step<4>(w, lane);
  reduce_scatter_step<2>(w, lane);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    w[j] += __shfl_xor_sync(kFullMask, w[j], 8);
    w[j] += __shfl_xor_sync(kFullMask, w[j], 16);
    sum[j] = w[j];
  }
}

// One Schur-Jacobi kernel on route R: `load(o)` reads row o's operands (a
// Row, whatever o; o is a long), `form(row, H, xh)` returns whether the
// row is live and then fills H's upper triangle and xh; row.c is its
// camera. On the private route the next row's loads are issued before this
// row's sums. A warp whose live lanes (four or more) all sit on one
// camera, as in the camera-sorted orders, sums its values in a
// reduce-scatter tree and every lane adds two of them (a walk would take
// 31 steps of 60 shuffles with every lane on one camera); any other warp
// walks its peers. All of the block's threads must call it; `smem` is the
// kernel's dynamic shared memory (the plan's copies, or kSchurMoments x
// kExpandChunk values on the global route). The values, copies and
// outputs are of type V (f32, or f64 in the f64 instantiations, whose
// copies hold half as many cameras); the blocks' sums are f64 in both.
template <Route R, typename Row, typename Load, typename Form, typename V>
__device__ __forceinline__ void schur_pass(Load load, Form form,
                                           const int* __restrict__ expand,
                                           V* __restrict__ out,
                                           double* __restrict__ acc_g,
                                           long n_obs, int n_cams, int copies,
                                           V* smem) {
  constexpr bool kPrefetch = R == Route::kPrivate;
  const int n_acc = kSchurMoments * n_cams;
  V* acc = warp_copy<R>(smem, copies, n_acc);
  const int lane = threadIdx.x & 31;
  const long stride = (long)gridDim.x * blockDim.x;
  // warp-uniform trips: every lane reaches the warp's scatter
  long base = (long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
  Row next;
  if (kPrefetch) next = load(base + lane);
  for (; base < n_obs; base += stride) {
    Row row;
    if (kPrefetch) {
      row = next;
      next = load(base + stride + lane);
    } else {
      row = load(base + lane);
    }
    V H[6], xh[4];
    const bool live = form(row, H, xh);
    if (!__any_sync(kFullMask, live)) continue;
    V v[kSchurMoments];
    if (live) {
      schur_moments(H, xh, v);
    } else {
#pragma unroll
      for (int k = 0; k < kSchurMoments; ++k) v[k] = V(0);
    }
    const int c = live ? row.c : 0;
    const WarpPeers peers = warp_peers(c, live);
    const unsigned leads = __ballot_sync(kFullMask, peers.lead);
    if (__popc(leads) == 1 &&
        __popc(__ballot_sync(kFullMask, live)) >= 4) {
      V sum[2];
      warp_reduce_scatter(v, sum);
      const int cu = __shfl_sync(kFullMask, c, __ffs(leads) - 1);
      if (R == Route::kPrivate) __syncwarp();  // after the last walk's adds
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = 2 * lane + j;
        if (k >= kSchurMoments) continue;
        if (R == Route::kGlobal)
          atomicAdd(acc_g + k * n_cams + cu, (double)sum[j]);
        else if (R == Route::kShared)
          atomicAdd(acc + k * n_cams + cu, sum[j]);
        else
          acc[k * n_cams + cu] += sum[j];
      }
    } else {
      add_rows<kSchurMoments, R, double>(acc, acc_g, 0, n_cams, c, peers,
                                         v);
    }
  }
  flush_copies<R, double, 32>(acc_g, smem, copies, n_acc, n_acc);
  expand_moments<kSchurMoments, 0, true>(
      expand, out, nullptr, acc_g, n_cams,
      R == Route::kGlobal ? kExpandChunk : n_cams, smem);
}

// ------------------------------------------------ composed-term scatters
// The composed power terms' per-camera scatter of both steps (pose1.cu
// K5, pose2.cu S4): a live row adds kScatterValues = 12 values to its
// camera's column of out [12, N]. The route sums_plan picks: kScatterWarps
// per-warp private copies of 12 N floats with plain adds (N up to 302),
// else shared copies in kScatterSharedThreads-thread blocks (up to
// N = 4842), else f64 global atomics. The blocks' sums meet in f64 in
// `acc_g` [12 N + 1] doubles (the sums, then a ticket), zero on entry;
// the last block writes out in f32 and leaves acc_g zeroed, so a call is
// one device operation. At venice-89 (18.6-19.2 us against 32.4-33.0 for
// the earlier per-lane shared atomics) the tail, the f64 flush of 132
// blocks x 1,068 sums and the last block, takes ~6 us, the loads ~12;
// one shared copy per 1024-thread block took 25.9-26.9, 8 / 32 private
// copies 27.7-29.6 / 19.4-20.6, f64 global atomics 191-198, the copies'
// flush as red.add.f64 18.0-18.3 (not kept: the Schur pair and
// csrc/cam.cu share it) (tools/pose1_ab.py, tools/pose2_ab.py and
// PERF.md; NVIDIA H100 80GB HBM3, 700 W).
constexpr int kScatterValues = 12;
constexpr int kScatterWarps = 16;
constexpr int kScatterSharedThreads = 1024;
// static shared memory a scatter kernel declares (last_block's flag),
// rounded up
constexpr size_t kScatterStaticSmem = 128;

__host__ __device__ constexpr int scatter_threads(Route r) {
  return r == Route::kPrivate ? 32 * kScatterWarps : kScatterSharedThreads;
}

// One composed-term scatter on route R: `load(o)` reads row o's operands
// (a Row, whatever o; o is a long), `form(row, v)` returns whether the row
// is live and then fills its 12 values; row.c is its camera. Warp-uniform
// trips, so that every lane reaches the warp's sums; a warp with no live
// lane skips them. On the private route the next row's loads are issued
// before this row's sums (19.8-19.9 us at venice-89 without). A warp whose
// live lanes (four or more) all sit on one camera, as on the mesh's window
// order, sums its values in a reduce-scatter tree (warp_reduce_scatter16)
// and six lanes add two sums each (17.9-18.6 us there, the walk alone
// 25.9-26.8); any other warp walks its peers in lane order. The tree is
// another order of the sums: 48 POWER_SCHUR_COMPLEMENT step-1 solves on
// the 1-device mesh with it, and 48 with the earlier kernels, all ended
// within chip_smoke.py's band (tools/pose1_ab.py spread). All of the
// block's threads must call it; `smem` is the kernel's dynamic shared
// memory (the plan's copies). Values, copies and outputs of type V (f32,
// or f64 in the f64 instantiations), f64 block sums in both.
template <Route R, typename Row, typename Load, typename Form, typename V>
__device__ __forceinline__ void scatter_pass(Load load, Form form,
                                             V* __restrict__ out,
                                             double* __restrict__ acc_g,
                                             long n_obs, int n_cams,
                                             int copies, V* smem) {
  constexpr bool kPrefetch = R == Route::kPrivate;
  constexpr int K = kScatterValues;
  const int n_acc = K * n_cams;
  V* acc = warp_copy<R>(smem, copies, n_acc);
  const int lane = threadIdx.x & 31;
  const long stride = (long)gridDim.x * blockDim.x;
  long base = (long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
  Row next;
  if (kPrefetch) next = load(base + lane);
  for (; base < n_obs; base += stride) {
    Row row;
    if (kPrefetch) {
      row = next;
      next = load(base + stride + lane);
    } else {
      row = load(base + lane);
    }
    V v[K];
    const bool live = form(row, v);
    if (!__any_sync(kFullMask, live)) continue;
    if (!live) {
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = V(0);
    }
    const int c = live ? row.c : 0;
    const WarpPeers peers = warp_peers(c, live);
    const unsigned leads = __ballot_sync(kFullMask, peers.lead);
    if (__popc(leads) == 1 &&
        __popc(__ballot_sync(kFullMask, live)) >= 4) {
      V sum[2];
      warp_reduce_scatter16(v, sum);
      const int cu = __shfl_sync(kFullMask, c, __ffs(leads) - 1);
      if (R == Route::kPrivate) __syncwarp();  // after the last walk's adds
      if (lane < K / 2) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = 2 * lane + j;
          if (R == Route::kGlobal)
            atomicAdd(acc_g + k * n_cams + cu, (double)sum[j]);
          else if (R == Route::kShared)
            atomicAdd(acc + k * n_cams + cu, sum[j]);
          else
            acc[k * n_cams + cu] += sum[j];
        }
      }
    } else {
      add_rows<K, R, double>(acc, acc_g, 0, n_cams, c, peers, v);
    }
  }
  if (!block_sums_done<R, double, 32>(acc_g, smem, copies, n_acc, n_acc))
    return;
  drain_sums<double>(acc_g, n_acc,
                     [&](int i, double s) { out[i] = (V)s; });
}

// ------------------------------------------------------------ slot tiles
// The fused power terms run one thread per slot row: a block takes tiles
// of t = kE0Threads / w landmarks x all w rows of one slot part (thread
// j t + l holds row j of landmark l), walking an int32 (part, tile) table
// of kTileFields per part (ops/pose_kernels.e0_tile_table: ofs, g, w, t
// and the tiles before the part). Slot row j of landmark l of part
// (ofs, g, w) is observation ofs + j g + l, so for a fixed j neighbouring
// landmarks are neighbouring rows.
constexpr int kE0Threads = 512;
constexpr int kE0Warps = kE0Threads / 32;
constexpr int kTileFields = 5;  // ofs, g, w, t, tile0

struct TileRow {
  int o;    // the observation (valid where `in`)
  int l;    // the landmark's column in the tile: th % t
  int t;    // landmarks per tile
  int w;    // slot rows per landmark
  bool in;  // a row of the part (the last tile may be ragged)
};

// thread th's slot row in `tile` of the table staged in `part`
__device__ __forceinline__ TileRow tile_row(const int* part, int n_parts,
                                            int tile, int th) {
  int p = 0, hi = n_parts - 1;  // the last part with tile0 <= tile
  while (p < hi) {
    const int mid = (p + hi + 1) / 2;
    if (part[mid * kTileFields + 4] <= tile) p = mid; else hi = mid - 1;
  }
  const int* e = part + p * kTileFields;
  const int g = e[1], w = e[2], t = e[3];
  const int l = th % t, j = th / t;
  const int lm = (tile - e[4]) * t + l;
  return {e[0] + j * g + lm, l, t, w, j < w && lm < g};
}

// The tile kernels' accumulators into `out` [n_acc]: with kPrivate the
// kE0Warps per-warp copies summed per entry, else the block's one; one
// global atomic per non-zero entry.
template <bool kPrivate>
__device__ __forceinline__ void flush_tiles(float* __restrict__ out,
                                            const float* acc, int n_acc) {
  if (kPrivate) {
    for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
      float s = acc[i];
      for (int k = 1; k < kE0Warps; ++k) s += acc[k * n_acc + i];
      if (s != 0.0f) atomicAdd(out + i, s);
    }
  } else {
    flush_acc(out, acc, n_acc);
  }
}

// A~ [4][4] of the camera in column c of a [12, n] table (row-major
// vec(P): P[r][col] is row 4 r + col):
//   A0 = sp (P0 - u P2), A1 = sp (P1 - v P2), A2 = sa P0, A3 = sa P1
template <typename T>
__device__ __forceinline__ void a_tilde(const T* tbl, int n, int c, T u,
                                        T v, T sp, T sa, T A[4][4]) {
#pragma unroll
  for (int col = 0; col < 4; ++col) {
    const T p0 = tbl[col * n + c];
    const T p1 = tbl[(4 + col) * n + c];
    const T p2 = tbl[(8 + col) * n + c];
    A[0][col] = sp * (p0 - u * p2);
    A[1][col] = sp * (p1 - v * p2);
    A[2][col] = sa * p0;
    A[3][col] = sa * p1;
  }
}

// pOSE residual r = A~ xh - [0, 0, sa u, sa v]
template <typename T>
__device__ __forceinline__ void residual(const T A[4][4], const T xh[4], T u,
                                         T v, T sa, T r[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    T acc = A[k][0] * xh[0];
    acc += A[k][1] * xh[1];
    acc += A[k][2] * xh[2];
    acc += A[k][3] * xh[3];
    r[k] = acc;
  }
  r[2] = r[2] - sa * u;
  r[3] = r[3] - sa * v;
}

// y[a] = sum_j xh_j t[4a+j] of a 12-vector t against xh = [x, 1]
template <typename T>
__device__ __forceinline__ void xh_contract(const T t[12], const T xh[4],
                                            T y[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    T acc = t[4 * a + 3];
    acc += xh[0] * t[4 * a + 0];
    acc += xh[1] * t[4 * a + 1];
    acc += xh[2] * t[4 * a + 2];
    y[a] = acc;
  }
}

// sum of v over the warp (a fixed shuffle tree), valid in lane 0
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(kFullMask, v, off);
  return v;
}

// sum of v over the block, valid in thread 0; red holds >= 32 entries
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  if (lane == 0) red[wid] = v;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  v = (int)threadIdx.x < n_warps ? red[threadIdx.x] : T(0);
  if (wid == 0) v = warp_sum(v);
  __syncthreads();
  return v;
}

// ------------------------------------------------------------- launching
//
// Every launch sizes its grid from the SM count and the kernel's resident
// blocks per SM, and opts the kernel in to its dynamic shared memory.
// Those CUDA runtime queries are made once per kernel, device and shape
// and kept (`launch_cache`): the attribute is set again only when a
// larger `smem` is asked for.

struct DeviceLimits {
  int sms = 0;        // streaming multiprocessors
  int max_optin = 0;  // dynamic shared memory a block may opt in to
};

struct LaunchCache {
  std::mutex mu;
  std::map<int, DeviceLimits> devices;
  std::map<std::pair<const void*, int>, size_t> opted;  // kernel, device
  // kernel, device, block threads, smem -> resident blocks per SM
  std::map<std::tuple<const void*, int, int, size_t>, int> resident;
};

inline LaunchCache& launch_cache() {
  static LaunchCache cache;
  return cache;
}

// the current device's limits (cache.mu held by the caller)
inline cudaError_t device_limits(LaunchCache& cache, int dev,
                                 DeviceLimits* out) {
  auto it = cache.devices.find(dev);
  if (it == cache.devices.end()) {
    DeviceLimits d;
    cudaError_t err =
        cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&d.max_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    it = cache.devices.emplace(dev, d).first;
  }
  *out = it->second;
  return cudaSuccess;
}

inline int max_optin_smem() {
  LaunchCache& cache = launch_cache();
  int dev = 0;
  DeviceLimits lim;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(cache.mu);
  return device_limits(cache, dev, &lim) == cudaSuccess ? lim.max_optin : 0;
}

// Opt `kernel` in to `smem` bytes of dynamic shared memory and size a
// grid-stride grid of `block`-thread blocks to what is resident at once:
// min(ceil(n_items / block), SMs x resident blocks per SM).
inline cudaError_t grid_for_block(const void* kernel, int block,
                                  long n_items, size_t smem, int* grid) {
  LaunchCache& cache = launch_cache();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(cache.mu);
  DeviceLimits lim;
  if ((err = device_limits(cache, dev, &lim)) != cudaSuccess) return err;
  size_t& opted = cache.opted[{kernel, dev}];
  if (smem > opted) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  const auto key = std::make_tuple(kernel, dev, block, smem);
  auto it = cache.resident.find(key);
  if (it == cache.resident.end()) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        block, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    it = cache.resident.emplace(key, per_sm).first;
  }
  const long want = (n_items + block - 1) / block;
  const long cap = (long)lim.sms * it->second;
  *grid = (int)std::max(1L, std::min(want, cap));
  return cudaSuccess;
}

template <int kBlock = kThreads, typename Kernel>
cudaError_t grid_for(Kernel kernel, long n_items, size_t smem, int* grid) {
  return grid_for_block(reinterpret_cast<const void*>(kernel), kBlock,
                        n_items, smem, grid);
}

// launch `kernel` in `block`-thread blocks over n_items work items (one
// per thread) on `stream`; returns the cudaError_t of the configuration
// or of the launch (0 on success)
template <typename Kernel, typename... Args>
int launch_block(Kernel kernel, int block, long n_items, size_t smem,
                 void* stream, Args... args) {
  int grid = 0;
  cudaError_t err = grid_for_block(reinterpret_cast<const void*>(kernel),
                                   block, n_items, smem, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int kBlock = kThreads, typename Kernel, typename... Args>
int launch(Kernel kernel, long n_items, size_t smem, void* stream,
           Args... args) {
  return launch_block(kernel, kBlock, n_items, smem, stream, args...);
}

// Launch a tile kernel over `n_tiles` tiles cut for blocks of
// `tile_threads` threads (which must be kE0Threads) on the first of its
// routes whose shared memory fits a block: its [12, N] z table (`tbl`
// bytes) staged beside kE0Warps private copies of its [n_acc] float
// accumulators (`staged_private`), or beside one shared copy
// (`staged_shared`); else the table read in place beside one shared copy
// (`direct_shared`), or beside none (`direct_global`: every value a
// global atomic into the zeroed output). `base` bytes (the tile's u and
// its part table) are staged on every route. Returns the cudaError_t.
// direct_shared against direct_global, e0_term_parts on ~2^20 slot rows:
// 141.4 against 214.9 us at N = 3000, 203.1 against 237.9 at N = 4500
// (tools/route_ab.py; NVIDIA H100 80GB HBM3, 700 W).
template <typename KSP, typename KSS, typename KDS, typename KDG,
          typename... Args>
int launch_tiles(KSP staged_private, KSS staged_shared, KDS direct_shared,
                 KDG direct_global, int n_parts, int n_tiles,
                 int tile_threads, size_t base, size_t tbl, size_t n_acc,
                 void* stream, Args... args) {
  if (tile_threads != kE0Threads || n_parts < 1 || n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  const size_t acc = sizeof(float) * n_acc;
  const size_t room = (size_t)max_optin_smem();
  const long items = (long)n_tiles * kE0Threads;
  if (base + tbl + kE0Warps * acc <= room)
    return launch<kE0Threads>(staged_private, items,
                              base + tbl + kE0Warps * acc, stream, args...);
  if (base + tbl + acc <= room)
    return launch<kE0Threads>(staged_shared, items, base + tbl + acc, stream,
                              args...);
  if (base + acc <= room)
    return launch<kE0Threads>(direct_shared, items, base + acc, stream,
                              args...);
  return launch<kE0Threads>(direct_global, items, base, stream, args...);
}

// A per-camera sum kernel's route and block shape for `rows` accumulator
// rows per camera of `elem` bytes each (f32 by default; f64 in the f64
// camera-table kernels): `warps` warps (at least `min_warps`) on private
// copies where that many fit a block, else `shared_threads`-thread blocks
// on as many shared copies as fit (at most one per warp), else the global
// route; `reserve` bytes of a block's shared memory are left to the
// kernel's static shared memory.
struct SumsPlan {
  Route route;
  int threads;
  int copies;
  size_t smem;
};

inline SumsPlan sums_plan(int rows, int n_cams, int warps, int min_warps,
                          int shared_threads, size_t reserve = 0,
                          size_t elem = sizeof(float)) {
  const size_t copy = elem * (size_t)rows * n_cams;
  const size_t room = std::max<size_t>(max_optin_smem(), reserve) - reserve;
  const int fit = (int)std::min<size_t>(room / copy, 32);
  if (fit >= min_warps) {
    const int w = std::min(warps, fit);
    return {Route::kPrivate, 32 * w, w, w * copy};
  }
  if (fit >= 1) {
    const int k = std::min(fit, shared_threads / 32);
    return {Route::kShared, shared_threads, k, k * copy};
  }
  return {Route::kGlobal, shared_threads, 1, 0};
}

// launch the route's instantiation of a per-camera sum kernel over n_obs
// rows with the plan's shared memory; the kernel takes `args` and then
// the plan's copies
template <typename KP, typename KS, typename KG, typename... Args>
int launch_sums(const SumsPlan& p, KP private_kernel, KS shared_kernel,
                KG global_kernel, long n_obs, void* stream, Args... args) {
  switch (p.route) {
    case Route::kPrivate:
      return launch_block(private_kernel, p.threads, n_obs, p.smem, stream,
                          args..., p.copies);
    case Route::kShared:
      return launch_block(shared_kernel, p.threads, n_obs, p.smem, stream,
                          args..., p.copies);
    default:
      return launch_block(global_kernel, p.threads, n_obs, p.smem, stream,
                          args..., p.copies);
  }
}

// launch a Schur-Jacobi kernel (its private, shared and global route
// instantiations) over n_obs rows and n_cams cameras, its copies of
// values of type V (f32, or f64 in the f64 instantiations)
template <typename V = float, typename KP, typename KS, typename KG,
          typename... Args>
int launch_schur(KP private_kernel, KS shared_kernel, KG global_kernel,
                 int n_obs, int n_cams, void* stream, Args... args) {
  if (n_obs <= 0 || n_cams <= 0) return (int)cudaErrorInvalidValue;
  // the last block's staged expansion table
  SumsPlan p = sums_plan(kSchurMoments, n_cams, kSchurWarps, kSchurMinWarps,
                         kSchurSharedThreads, kSchurStaticSmem, sizeof(V));
  // the last block stages the moments of kExpandChunk cameras at a time
  if (p.route == Route::kGlobal)
    p.smem = sizeof(V) * kSchurMoments * kExpandChunk;
  return launch_sums(p, private_kernel, shared_kernel, global_kernel, n_obs,
                     stream, args...);
}

// launch a composed-term scatter (its private, shared and global route
// instantiations) over n_obs rows and n_cams cameras, its copies of
// values of type V (f32, or f64 in the f64 instantiations)
template <typename V = float, typename KP, typename KS, typename KG,
          typename... Args>
int launch_scatter(KP private_kernel, KS shared_kernel, KG global_kernel,
                   int n_obs, int n_cams, void* stream, Args... args) {
  if (n_obs < 0 || n_cams <= 0) return (int)cudaErrorInvalidValue;
  return launch_sums(sums_plan(kScatterValues, n_cams, kScatterWarps,
                               kScatterWarps, kScatterSharedThreads,
                               kScatterStaticSmem, sizeof(V)),
                     private_kernel, shared_kernel, global_kernel, n_obs,
                     stream, args...);
}

}  // namespace povar
