// Camera-table kernels for Hopper (sm_90a): the hand-written CUDA
// counterparts of povar_tpu/ops/pallas_cam.py on the paths this package
// runs.
//
//   C1 cam_gather  <- pallas_cam.py:176 (_gather_kernel :172)
//
// The TPU kernel turns the gather into an MXU matmul against a one-hot
// incidence built per tile, with an exact bf16 3-way split of the table
// so that the product stays exact. None of that is needed here: a camera
// row is a shared-memory read by index, so the result is the table entry
// itself, bit for bit.
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

}  // extern "C"
