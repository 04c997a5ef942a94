// Camera-table kernels for Hopper (sm_90a): the hand-written CUDA
// counterparts of povar_tpu/ops/pallas_cam.py.
//
//   C1 cam_gather       <- pallas_cam.py:176 (_gather_kernel :171)
//   C2 cam_scatter_add  <- pallas_cam.py:207 (_scatter_kernel :198)
//   C3 e0_u             <- pallas_cam.py:242 (_e0_u_kernel :235)
//   C4 e0_scatter       <- pallas_cam.py:278 (_e0_scatter_kernel :267)
//   C5 hpp_b            <- pallas_cam.py:333 (_hpp_b_kernel :311)
//
// The TPU kernels turn every camera gather and scatter into an MXU matmul
// against a one-hot incidence built per tile, with an exact bf16 3-way
// split of the f32 operand so that the products stay exact. None of that
// is needed here: a camera row is a shared-memory read by index, and a
// per-camera sum is a shared-memory atomicAdd by index. C1 copies table
// entries, bit for bit; C3 sums its terms in the order of its plain
// version (ops/cam_ref.py), so with --fmad=false it matches it bit for
// bit; C2, C4 and C5 accumulate per camera in shared memory (global
// memory where the accumulators do not fit a block) and leave the block
// with one global atomicAdd per non-zero entry, so they differ from their
// plain versions by the order of the atomics only.
//
// Every per-observation operand of C2, C4 and C5 must be zero on the
// slot pad rows: unlike the TPU's incidence (stage1.make_obs folds the
// pad mask into it), the camera index of a pad row is a real camera.
//
// C interface as in pose1.cu: device pointers, sizes and the CUDA stream;
// one launch; the cudaError_t of the launch is returned.

#include "pose_common.cuh"

using povar::kThreads;

namespace {

// ------------------------------------------------------------------ C1
// out[r][o] = table[r][cam[o]] for the rows [r0, r0 + rows) of row block
// blockIdx.y: the block stages those rows of the [R, N] table in shared
// memory, then each thread of a grid-stride loop over the observations
// reads its camera index once and writes its column of the row block.
// Bound: 4 B read and 4 R B written per observation (52 B at R = 12);
// the table is read once per block.
__global__ void __launch_bounds__(kThreads)
    cam_gather_kernel(const int32_t* __restrict__ cam,
                      const float* __restrict__ table, float* __restrict__ out,
                      int n_obs, int n_cams, int n_rows, int rows_per_block) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.y * rows_per_block;
  const int rows = min(rows_per_block, n_rows - r0);
  povar::smem_copy(smem, table + (size_t)r0 * n_cams, rows * n_cams);
  __syncthreads();
  const int O = n_obs;
  POVAR_OBS_LOOP(o, O) {
    const int c = cam[o];
    for (int r = 0; r < rows; ++r)
      out[(size_t)(r0 + r) * O + o] = smem[r * n_cams + c];
  }
}

// ------------------------------------------------------------------ C2
// out[r][c] += sum over o with cam[o] = c of v[r][o], for the rows
// [r0, r0 + rows) of row block blockIdx.y: the block zeroes [rows, N]
// accumulators in shared memory, each thread of a grid-stride loop reads
// cam[o] once and adds its column with shared atomics, and the block
// flushes with global atomics into the zeroed output.
// Bound: (4 + 4 R) B per observation.
__global__ void __launch_bounds__(kThreads)
    cam_scatter_add_kernel(const int32_t* __restrict__ cam,
                           const float* __restrict__ v, float* __restrict__ out,
                           int n_obs, int n_cams, int n_rows,
                           int rows_per_block) {
  extern __shared__ float acc[];
  const int r0 = blockIdx.y * rows_per_block;
  const int rows = min(rows_per_block, n_rows - r0);
  povar::smem_zero(acc, rows * n_cams);
  __syncthreads();
  const int O = n_obs;
  POVAR_OBS_LOOP(o, O) {
    const int c = cam[o];
    for (int r = 0; r < rows; ++r) {
      const float x = v[(size_t)(r0 + r) * O + o];
      if (x != 0.0f) atomicAdd(acc + r * n_cams + c, x);
    }
  }
  __syncthreads();
  povar::flush_acc(out + (size_t)r0 * n_cams, acc, rows * n_cams);
}

// ------------------------------------------------------------------ C3
// u[i][o] = sum_j W[i dc + j][o] x[j][cam[o]], j in order, with the
// [dc, N] table x staged in shared memory once per block.
// Bound: (4 + 4 dl dc + 4 dl) B per observation.
__global__ void __launch_bounds__(kThreads)
    e0_u_kernel(const int32_t* __restrict__ cam, const float* __restrict__ w,
                const float* __restrict__ x, float* __restrict__ u, int n_obs,
                int n_cams, int dl, int dc) {
  extern __shared__ float xs[];
  povar::smem_copy(xs, x, dc * n_cams);
  __syncthreads();
  const int O = n_obs;
  POVAR_OBS_LOOP(o, O) {
    const int c = cam[o];
    for (int i = 0; i < dl; ++i) {
      const float* wi = w + (size_t)i * dc * O + o;
      float acc = wi[0] * xs[c];
      for (int j = 1; j < dc; ++j) acc += wi[(size_t)j * O] * xs[j * n_cams + c];
      u[(size_t)i * O + o] = acc;
    }
  }
}

// per-camera accumulators: a block's shared memory, or, where they do
// not fit, the zeroed global output itself
template <bool kShared>
__device__ __forceinline__ float* accumulators(float* smem, float* global) {
  return kShared ? smem : global;
}

// ------------------------------------------------------------------ C4
// out[j][c] += sum over o with cam[o] = c of
// v_j = sum_i W[i dc + j][o] sb[i][o], i in order, into [dc, N]
// accumulators. Bound as C3.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    e0_scatter_kernel(const int32_t* __restrict__ cam,
                      const float* __restrict__ w,
                      const float* __restrict__ sb, float* __restrict__ out,
                      int n_obs, int n_cams, int dl, int dc) {
  extern __shared__ float smem[];
  float* acc = accumulators<kShared>(smem, out);
  if (kShared) {
    povar::smem_zero(acc, dc * n_cams);
    __syncthreads();
  }
  const int O = n_obs;
  POVAR_OBS_LOOP(o, O) {
    const int c = cam[o];
    for (int j = 0; j < dc; ++j) {
      float v = w[(size_t)j * O + o] * sb[o];
      for (int i = 1; i < dl; ++i)
        v += w[(size_t)(i * dc + j) * O + o] * sb[(size_t)i * O + o];
      if (v != 0.0f) atomicAdd(acc + j * n_cams + c, v);
    }
  }
  if (kShared) {
    __syncthreads();
    povar::flush_acc(out, acc, dc * n_cams);
  }
}

// ------------------------------------------------------------------ C5
// Per observation, the K x D block Jp (rows k d + a) and r~ [K]:
// hpp[a D + b][c] += sum_k Jp[k][a] Jp[k][b] and b[a][c] += sum_k Jp[k][a]
// r~[k], k in order, into [D D + D, N] accumulators. Each product sum of
// the upper triangle is added to both of its entries (the same value, as
// the plain version's outer product computes it twice).
// Bound: (4 + 4 K D + 4 K) B per observation, 8 (D D + D) B per camera.
template <int K, int D, bool kShared>
__global__ void __launch_bounds__(kThreads)
    hpp_b_kernel(const int32_t* __restrict__ cam, const float* __restrict__ jp,
                 const float* __restrict__ rt, float* __restrict__ hpp,
                 float* __restrict__ b, int n_obs, int n_cams) {
  extern __shared__ float smem[];
  float* acc_h = accumulators<kShared>(smem, hpp);
  float* acc_b = accumulators<kShared>(smem + D * D * n_cams, b);
  if (kShared) {
    povar::smem_zero(smem, (D * D + D) * n_cams);
    __syncthreads();
  }
  const int O = n_obs;
  POVAR_OBS_LOOP(o, O) {
    const int c = cam[o];
    float j[K][D], r[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      r[k] = rt[(size_t)k * O + o];
#pragma unroll
      for (int a = 0; a < D; ++a) j[k][a] = jp[(size_t)(k * D + a) * O + o];
    }
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float jr = j[0][a] * r[0];
#pragma unroll
      for (int k = 1; k < K; ++k) jr += j[k][a] * r[k];
      if (jr != 0.0f) atomicAdd(acc_b + a * n_cams + c, jr);
#pragma unroll
      for (int bb = a; bb < D; ++bb) {
        float s = j[0][a] * j[0][bb];
#pragma unroll
        for (int k = 1; k < K; ++k) s += j[k][a] * j[k][bb];
        if (s == 0.0f) continue;
        atomicAdd(acc_h + (a * D + bb) * n_cams + c, s);
        if (bb != a) atomicAdd(acc_h + (bb * D + a) * n_cams + c, s);
      }
    }
  }
  if (kShared) {
    __syncthreads();
    povar::flush_acc(hpp, acc_h, D * D * n_cams);
    povar::flush_acc(b, acc_b, D * n_cams);
  }
}

template <int K, int D>
int launch_hpp_b(const int32_t* cam, const float* jp, const float* rt,
                 float* hpp, float* b, int n_obs, int n_cams, void* stream) {
  const size_t shared = sizeof(float) * (D * D + D) * (size_t)n_cams;
  if (shared <= (size_t)povar::max_optin_smem())
    return povar::launch(hpp_b_kernel<K, D, true>, n_obs, shared, stream, cam,
                         jp, rt, hpp, b, n_obs, n_cams);
  return povar::launch(hpp_b_kernel<K, D, false>, n_obs, 0, stream, cam, jp,
                       rt, hpp, b, n_obs, n_cams);
}

}  // namespace

extern "C" {

// rows_per_block: how many table rows one block stages (the caller picks
// it so that rows_per_block * n_cams floats fit a block's shared memory)
int povar_cam_gather(const int32_t* cam, const float* table, float* out,
                     int n_obs, int n_cams, int n_rows, int rows_per_block,
                     void* stream) {
  if (n_obs <= 0 || n_cams <= 0 || n_rows <= 0 || rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)rows_per_block * n_cams;
  int grid = 0;
  cudaError_t err = povar::grid_for(cam_gather_kernel, n_obs, smem, &grid);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks(grid, (n_rows + rows_per_block - 1) / rows_per_block);
  cam_gather_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      cam, table, out, n_obs, n_cams, n_rows, rows_per_block);
  return (int)cudaGetLastError();
}

// out: [n_rows, n_cams], zeroed by the caller; rows_per_block as above
int povar_cam_scatter_add(const int32_t* cam, const float* v, float* out,
                          int n_obs, int n_cams, int n_rows,
                          int rows_per_block, void* stream) {
  if (n_obs <= 0 || n_cams <= 0 || n_rows <= 0 || rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)rows_per_block * n_cams;
  int grid = 0;
  cudaError_t err =
      povar::grid_for(cam_scatter_add_kernel, n_obs, smem, &grid);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks(grid, (n_rows + rows_per_block - 1) / rows_per_block);
  cam_scatter_add_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      cam, v, out, n_obs, n_cams, n_rows, rows_per_block);
  return (int)cudaGetLastError();
}

int povar_cam_e0_u(const int32_t* cam, const float* w, const float* x,
                   float* u, int n_obs, int n_cams, int dl, int dc,
                   void* stream) {
  if (dl <= 0 || dc <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)dc * n_cams;
  return povar::launch(e0_u_kernel, n_obs, smem, stream, cam, w, x, u, n_obs,
                       n_cams, dl, dc);
}

// out: [dc, n_cams], zeroed by the caller
int povar_cam_e0_scatter(const int32_t* cam, const float* w, const float* sb,
                         float* out, int n_obs, int n_cams, int dl, int dc,
                         void* stream) {
  if (dl <= 0 || dc <= 0) return (int)cudaErrorInvalidValue;
  const size_t shared = sizeof(float) * (size_t)dc * n_cams;
  if (shared <= (size_t)povar::max_optin_smem())
    return povar::launch(e0_scatter_kernel<true>, n_obs, shared, stream, cam,
                         w, sb, out, n_obs, n_cams, dl, dc);
  return povar::launch(e0_scatter_kernel<false>, n_obs, 0, stream, cam, w, sb,
                       out, n_obs, n_cams, dl, dc);
}

// hpp: [d d, n_cams], b: [d, n_cams], zeroed by the caller; (k, d) is
// (4, 12) (step 1) or (2, 11) (step 2)
int povar_cam_hpp_b(const int32_t* cam, const float* jp, const float* rt,
                    float* hpp, float* b, int n_obs, int n_cams, int k, int d,
                    void* stream) {
  if (k == 4 && d == 12)
    return launch_hpp_b<4, 12>(cam, jp, rt, hpp, b, n_obs, n_cams, stream);
  if (k == 2 && d == 11)
    return launch_hpp_b<2, 11>(cam, jp, rt, hpp, b, n_obs, n_cams, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
