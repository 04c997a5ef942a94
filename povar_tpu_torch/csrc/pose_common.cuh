// Shared device and launch code of the structured kernels of step 1
// (pose1.cu) and step 2 (pose2.cu).
//
// Every kernel is one pass over the observations, one thread per
// observation in a grid-stride loop (the fused step-2 term: per slot
// row of a tile), on observation-last arrays ([k, O] rows: neighbouring
// threads read neighbouring addresses). The
// [12, N] camera table(s) a kernel gathers from are staged in shared
// memory once per block (12 * N * 4 B: 4.3 KB at N = 89); a camera row
// is then a shared-memory read by index. Per-camera sums go into
// shared-memory accumulators (through warp_scatter in the step-2 hppb2
// and fused term) and leave the block as one global atomicAdd per
// non-zero entry; scalar sums leave as one partial per block, which the
// caller adds up.
//
// The arithmetic follows the Pallas bodies of povar_tpu/ops/pallas_pose.py
// term for term (same products, same summation order), so a kernel and
// its plain PyTorch version (ops/pose_ref.py) differ only by FMA
// contraction and, for per-camera sums, by the order of the atomics
// (the step-2 hppb2 also regroups its Hpp products into moments).

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace povar {

constexpr int kThreads = 256;

// grid-stride loop over the observation axis
#define POVAR_OBS_LOOP(o, n_obs)                                     \
  for (int o = blockIdx.x * blockDim.x + threadIdx.x; o < (n_obs); \
       o += gridDim.x * blockDim.x)

template <typename T>
__device__ __forceinline__ void smem_copy(T* dst, const T* __restrict__ src,
                                          int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

__device__ __forceinline__ void smem_zero(float* dst, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = 0.0f;
}

// one global atomic per non-zero accumulator entry (adding an exact
// zero changes nothing, so the entries no observation touched stay home)
__device__ __forceinline__ void flush_acc(float* __restrict__ dst,
                                          const float* acc, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.0f) atomicAdd(dst + i, v);
  }
}

constexpr unsigned kFullMask = 0xffffffffu;

// Add v[0..K) to rows 0..K-1 of the [K, n] accumulator `acc` at column
// c, for every live lane of a converged warp (dead lanes pass zeros and
// any c). The lanes on one camera first sum their values into their
// lowest lane, which alone adds them: no two lanes of the warp then add
// to one address, so a shared-memory float atomic (a compare-and-swap
// loop on this card) never retries against its own warp, and with
// kAtomic false (an accumulator the warp owns) a plain add is safe.
// Where every live lane is on one camera, as on the camera-sorted lane
// orders, the sums take a shuffle butterfly (5 steps) instead of a walk
// over the peers (31).
template <int K, bool kAtomic = true>
__device__ __forceinline__ void warp_scatter(float* acc, int n, int c,
                                             bool live, float (&v)[K]) {
  const unsigned live_mask = __ballot_sync(kFullMask, live);
  if (live_mask == 0u) return;
  const int lane = threadIdx.x & 31;
  const unsigned peers =
      __match_any_sync(kFullMask, live ? c : -1) & live_mask;
  const bool lead = live && lane == __ffs(peers) - 1;
  if (__popc(live_mask) > 1 &&
      __all_sync(kFullMask, !live || peers == live_mask)) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v[k] += __shfl_xor_sync(kFullMask, v[k], off);
  } else {
    unsigned rest = lead ? peers & (peers - 1u) : 0u;
    while (__any_sync(kFullMask, rest != 0u)) {
      const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float t = __shfl_sync(kFullMask, v[k], src);
        if (rest) v[k] += t;
      }
      rest &= rest - 1u;
    }
  }
  if (lead) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (kAtomic)
        atomicAdd(&acc[k * n + c], v[k]);
      else
        acc[k * n + c] += v[k];
    }
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

// sum of v over the block, valid in thread 0; red holds >= 32 entries
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  if (lane == 0) red[wid] = v;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  v = (int)threadIdx.x < n_warps ? red[threadIdx.x] : T(0);
  if (wid == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  __syncthreads();
  return v;
}

// ------------------------------------------------------------- launching

inline int max_optin_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// Opt the kernel in to `smem` bytes of dynamic shared memory and size a
// grid-stride grid of kBlock-thread blocks to what is resident at once:
// min(ceil(n_items / kBlock), SMs x resident blocks per SM).
template <int kBlock = kThreads, typename Kernel>
cudaError_t grid_for(Kernel kernel, long n_items, size_t smem, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kBlock, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long want = (n_items + kBlock - 1) / kBlock;
  const long cap = (long)sms * per_sm;
  *grid = (int)std::max(1L, std::min(want, cap));
  return cudaSuccess;
}

// launch `kernel` in kBlock-thread blocks over n_items work items (one
// per thread) on `stream`; returns the cudaError_t of the configuration
// or of the launch (0 on success)
template <int kBlock = kThreads, typename Kernel, typename... Args>
int launch(Kernel kernel, long n_items, size_t smem, void* stream,
           Args... args) {
  int grid = 0;
  cudaError_t err = grid_for<kBlock>(kernel, n_items, smem, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace povar
