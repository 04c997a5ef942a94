// Slot reduce/expand kernels of the SPMD window layout for Hopper
// (sm_90a): the hand-written CUDA counterparts of
// povar_tpu/ops/pallas_spmd.py.
//
//   P1 class_part_sums        <- pallas_spmd.py:79  (_part_sums_kernel :69)
//   P2 class_expand_rows      <- pallas_spmd.py:109 (_expand_kernel :97)
//   P3 class_reduce_reexpand  <- pallas_spmd.py:144
//                                (_reduce_reexpand_kernel :129)
//
// A device's lanes [K, o_dev] hold its windows class by class; part i of
// a window is a slab of cap * w lanes, slot element s of row r at
// s * cap + r, and the lanes after the last part are the window's tail.
// Its slot rows [K, n_rows_dev] are numbered class, part, window, row
// (ops/spmd_ref.py). The TPU kernels walk one class's windows on a
// sequential grid, a whole window block in VMEM, because a reshape of
// the lane axis is layout-hostile there. Here nothing is staged: one
// launch covers every class and part through an int32 table of entries
// (ops/spmd_kernels.layout_table: lane0, stride, cap, w, n, row0,
// work0), one thread per (window, row) of an entry, rows along the
// threads (cap is a multiple of 128, so a warp reads and writes 128
// contiguous bytes per slot element), the leading K on the grid's
// second axis. P1 reads the row's w lanes and writes its sum; P2 reads
// the row and writes its w lanes; P3 does both in one pass; P2 and P3
// also zero the tail lanes (table entries with w = 0). Each input byte
// is read once and each output byte written once, so the bound is the
// bytes: (o_dev + n_rows_dev) * 4 B per leading row for P1 and P2,
// 2 o_dev * 4 B for P3. Sums add s = 0 .. w-1 from left to right, as
// the Pallas kernels and the plain versions do (bit-equal, no FMA is
// involved). Each kernel is templated on its element type T and has an
// f64 instantiation (the entry point's name with `_f64` appended) for
// the mesh's pure f64, where the JAX package falls back per class to
// its XLA sums (pallas_spmd.py:48-60, `_class_eligible`): the same walk
// on 8-byte elements, 8 B a lane and slot row in the bound.
//
// C interface as in pose1.cu: device pointers, sizes and the CUDA stream;
// one launch; the cudaError_t of the launch is returned.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 7;  // lane0, stride, cap, w, n, row0, work0
constexpr int kMaxEntries = 256;  // 7 KB of shared memory

enum Mode { kPartSums = 0, kExpand = 1, kReduceReexpand = 2 };

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
    spmd_kernel(const T* __restrict__ src, T* __restrict__ dst,
                const int* __restrict__ table, int n_entries, int work,
                int src_len, int dst_len) {
  __shared__ int tbl[kMaxEntries * kFields];
  for (int i = threadIdx.x; i < n_entries * kFields; i += blockDim.x)
    tbl[i] = table[i];
  __syncthreads();
  const T* in = src + (size_t)blockIdx.y * src_len;
  T* out = dst + (size_t)blockIdx.y * dst_len;
  // 64-bit walk: item + stride never wraps
  for (long item = (long)blockIdx.x * blockDim.x + threadIdx.x; item < work;
       item += (long)gridDim.x * blockDim.x) {
    int e = 0, hi = n_entries - 1;  // the last entry with work0 <= item
    while (e < hi) {
      const int mid = (e + hi + 1) / 2;
      if (tbl[mid * kFields + 6] <= item) e = mid; else hi = mid - 1;
    }
    const int* t = tbl + e * kFields;
    const int cap = t[2], w = t[3];
    const int idx = (int)(item - t[6]);
    const int win = idx / cap;
    const int r = idx - win * cap;
    const int lane = t[0] + win * t[1] + r;
    if (kMode == kPartSums) {
      T acc = in[lane];
      for (int s = 1; s < w; ++s) acc += in[lane + s * cap];
      out[t[5] + win * cap + r] = acc;
    } else if (w == 0) {  // a tail entry
      out[lane] = T(0);
    } else {
      T v;
      if (kMode == kExpand) {
        v = in[t[5] + win * cap + r];
      } else {
        v = in[lane];
        for (int s = 1; s < w; ++s) v += in[lane + s * cap];
      }
      for (int s = 0; s < w; ++s) out[lane + s * cap] = v;
    }
  }
}

template <int kMode, typename T>
int launch(const T* src, T* dst, const int* table, int n_entries, int work,
           int k, int src_len, int dst_len, void* stream) {
  if (n_entries < 1 || n_entries > kMaxEntries || k < 1 || k > 65535)
    return (int)cudaErrorInvalidValue;
  const long blocks = ((long)work + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)std::max(1L, std::min(blocks, 65535L)),
                  (unsigned)k);
  spmd_kernel<T, kMode><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      src, dst, table, n_entries, work, src_len, dst_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int povar_spmd_part_sums(const float* x, float* rows, const int* table,
                         int n_entries, int work, int k, int o_dev,
                         int n_rows, void* stream) {
  return launch<kPartSums>(x, rows, table, n_entries, work, k, o_dev, n_rows,
                           stream);
}

int povar_spmd_expand_rows(const float* rows, float* x, const int* table,
                           int n_entries, int work, int k, int n_rows,
                           int o_dev, void* stream) {
  return launch<kExpand>(rows, x, table, n_entries, work, k, n_rows, o_dev,
                         stream);
}

int povar_spmd_reduce_reexpand(const float* x, float* out, const int* table,
                               int n_entries, int work, int k, int o_dev,
                               int o_dev2, void* stream) {
  return launch<kReduceReexpand>(x, out, table, n_entries, work, k, o_dev,
                                 o_dev2, stream);
}

int povar_spmd_part_sums_f64(const double* x, double* rows, const int* table,
                             int n_entries, int work, int k, int o_dev,
                             int n_rows, void* stream) {
  return launch<kPartSums>(x, rows, table, n_entries, work, k, o_dev, n_rows,
                           stream);
}

int povar_spmd_expand_rows_f64(const double* rows, double* x,
                               const int* table, int n_entries, int work,
                               int k, int n_rows, int o_dev, void* stream) {
  return launch<kExpand>(rows, x, table, n_entries, work, k, n_rows, o_dev,
                         stream);
}

int povar_spmd_reduce_reexpand_f64(const double* x, double* out,
                                   const int* table, int n_entries, int work,
                                   int k, int o_dev, int o_dev2,
                                   void* stream) {
  return launch<kReduceReexpand>(x, out, table, n_entries, work, k, o_dev,
                                 o_dev2, stream);
}

}  // extern "C"
