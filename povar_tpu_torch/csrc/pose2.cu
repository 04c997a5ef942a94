// Step-2 structured homogeneous-projective kernels for Hopper (sm_90a):
// the hand-written CUDA counterparts of the Pallas kernels on the RIPOBA
// and RIPCG step-2 paths of povar_tpu/ops/pallas_pose2.py (fused and
// composed power terms).
//
//   S1 prepare2        <- pallas_pose2.py:157 (_prepare2_kernel :77)
//   S2 hppb2           <- pallas_pose2.py:267 (_hppb2_kernel :218)
//   S3 mat_dot2        <- pallas_pose2.py:347 (_mat_dot_kernel :311)
//   S4 scatter2        <- pallas_pose2.py:412 (_scatter2_kernel :383)
//   S5 ldiff2          <- pallas_pose2.py:667 (_ldiff2_kernel :634)
//   S6 pose_error2     <- pallas_pose2.py:822 (error2_df32, _error2_kernel
//                         :734), in native f64
//   S7 e0_term2_parts  <- pallas_pose2.py:512 (_e0_term2_kernel :455)
//   S8 schur_diag2     <- pallas_pose2.py:601 (_schur2_kernel :563)
//
// Every quantity derives from the camera row P (or a per-camera zt
// table), the homogeneous landmark x4 and the projection cache
// mm = (mx, my, 1/p2):
//   p = P x4, m = (p0/p2, p1/p2), r = m - uv
//   Jp = (1/p2) C (x) x4^T, C = [[1, 0, -mx], [0, 1, -my]]
// The tangent lifts (Kps) are per-camera [12, 11] folds the caller
// applies around the kernels, so every kernel works in the unprojected
// 12-dof camera frame.
//
// What the TPU kernels needed and these do not: the one-hot incidence
// matmuls with the bf16 3-way split (a camera row is a shared-memory read
// by index here), the 128-lane padding and tile caps (a grid-stride loop
// covers any O), and the double-float arithmetic with its refined
// division in the cost (the H100 has native f64).
//
// What bounds them on the card, per observation (O = 557,056 at
// venice-89): S1 reads 40 B and writes 64 B and adds 8 values per live
// row through warp_scatter into per-warp accumulators;
// S2 reads 80 B and does 52 shared atomics (its per-camera moments); S3
// reads 60 B (68 with r_w) and writes 12 B; S4 reads 72 B and adds its
// 12 values through warp_scatter into per-warp accumulators; S5 reads
// 92 B; S6 reads 60 B (f64 state) with ~45 f64 flops; S7 reads 60 B once
// per slot row plus 12 shared atomics; S8 reads 60 B and adds its 60
// moments through warp_scatter into per-warp accumulators.
// Per-camera sums leave a block through one global atomic per non-zero
// entry; scalar sums leave as one partial per block.
//
// f64: S1-S5 and S8 are templated on their value type V and have f64
// instantiations (entry points with `_f64` appended), as pose1.cu's, for
// the SPMD window layout's pure f64: f64 loads, arithmetic, accumulators
// and outputs, routes chosen by the bytes of 8-byte values. S6 is native
// f64 already; S7 (the fused term) runs in no f64 path.
//
// C interface as in pose1.cu: device pointers, sizes, scalar constants
// and the stream; each entry point launches one kernel and returns the
// cudaError_t of the launch. Outputs that accumulate must be zeroed by
// the caller.

#include "pose_common.cuh"

using povar::dyn_smem;
using povar::kThreads;
using povar::launch;
using povar::warp_sum;
using povar::max_optin_smem;
using povar::Route;

namespace {

// projection validity |p2| >= eps_sqrt (Sophus epsilonSqrt of the f64
// solve, bal_camera.hpp:147); |p2| below tiny divides by +-tiny; each in
// the working type, as the plain versions round them
constexpr float kEpsSqrt = 1e-5f;
constexpr float kTiny = 1e-30f;

template <typename V>
__device__ __forceinline__ V eps_sqrt() {
  return sizeof(V) == sizeof(float) ? V(kEpsSqrt) : V(1e-5);
}

template <typename V>
__device__ __forceinline__ V tiny() {
  return sizeof(V) == sizeof(float) ? V(kTiny) : V(1e-30);
}

template <typename V>
__device__ __forceinline__ V huber_floor() {
  return sizeof(V) == sizeof(float) ? V(1e-30f) : V(1e-30);
}

// p_r = sum_c P[r][c] x4_c of the camera in column c of a [12, n] table
template <typename T>
__device__ __forceinline__ void project(const T* tbl, int n, int c,
                                        const T x4[4], T p[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    T acc = tbl[(4 * r) * n + c] * x4[0];
    acc += tbl[(4 * r + 1) * n + c] * x4[1];
    acc += tbl[(4 * r + 2) * n + c] * x4[2];
    acc += tbl[(4 * r + 3) * n + c] * x4[3];
    p[r] = acc;
  }
}

// jp = sw/p2 [q~0 - mx q~2, q~1 - my q~2], q~a = sum_c x4_c zt[4a+c]
template <typename V>
__device__ __forceinline__ void jp_of_zt(const V* tbl, int n, int c,
                                         const V x4[4], V mx, V my, V swz,
                                         V jp[2]) {
  V q[3];
  project(tbl, n, c, x4, q);
  jp[0] = swz * (q[0] - mx * q[2]);
  jp[1] = swz * (q[1] - my * q[2]);
}

// ------------------------------------------------------------------ S1
// Linearization-point pass: projection, residual, robust weight, the
// projection cache mm (0 on dead rows), weighted unscaled Jl rows jlw
// [8, O] (r*4+c), their column norms^2 jlsq [4, O], and the per-camera
// Jp column norms^2 jpsq[4a+c] = sum w/p2^2 K3diag_a x4_c^2 with
// K3diag = [1, 1, mx^2 + my^2]. A dead row (mask 0, or projection-
// invalid under use_valid) gets weight 0 and adds nothing.
// Rows 0-3 and 4-7 of jpsq are the same sums, so a live row adds 8
// values per camera (wz2 x4_c^2 and wz2 kd2 x4_c^2, wz2 = w/p2^2,
// kd2 = mx^2 + my^2) the way the composed scatters add theirs
// (pose_common.cuh scatter_pass): the lanes of a warp on one camera sum
// first (a reduce-scatter tree where the warp's live lanes all sit on one
// camera, as on the mesh's window order; a walk over the peers
// otherwise), into the route sums_plan picks by the bytes of V:
// kPrep2Warps per-warp private copies of [8, N] with plain adds in
// 512-thread blocks (N up to 453 in f32, 226 in f64), else one shared
// copy in 1024-thread blocks (512 in f64) with shared atomics (up to
// N = 7,260 / 3,630), else f64 global atomics. The blocks' sums meet in
// f64 in `acc_g` [8 N + 1] doubles (the sums, then a ticket), zero on
// entry; the last block writes jpsq [12, N] in V from them, rows 4-7 the
// same values as rows 0-3, and leaves acc_g zeroed, so a call is one
// device operation. The camera table is read in place through __ldg, and the
// next row's operands are loaded ahead.
// Replaces pallas_pose2.py:157 prepare2. Bound: 104 B of device memory
// per observation (40 read, 64 written; 17.3 us at venice-89). Here 28.1
// us there (26.5 without the sums), 30.7 on the mesh's window order (the
// walk alone 37.2), 52.6 in f64 on the mesh's operands, 42.4 at
// N = 1024 and 229.0 at N = 13,682 on ~2^20 rows (126.0 without the
// sums), where the earlier version's 12 per-lane shared atomics per live
// row (each a compare-and-swap loop on this card) into one [12, N]
// accumulator a 256-thread block took 32.8, 91.8, 133.3, 66.1 and 237.7.
// Three 512-thread blocks an SM (40 registers) spill and took 63.4 us at
// venice-89; as many shared copies as fit (seven at N = 1024) took 88.5
// there: they fill the SM's shared memory, which the table's reads
// through L1 need; without the loads ahead 29.1 at venice-89 (tools/
// pose2_ab.py and PERF.md; NVIDIA H100 80GB HBM3, 700 W).
constexpr int kJp2Rows = 8;
constexpr int kPrep2Warps = 16;             // private copies a block
constexpr int kPrep2SharedThreads = 1024;   // shared and global, f32
constexpr int kPrep2SharedCopies = 1;       // shared copies a block
constexpr int kPrep2SmThreads = 1024;       // resident per SM: the registers
constexpr bool kPrep2Prefetch = true;       // the next row's operands
// static shared memory of the kernel (last_block's flag), rounded up
constexpr size_t kPrep2StaticSmem = 128;

// threads a block on route r, for values of type V: the f64 shared and
// global routes take half as many, so that a thread may hold 128
// registers (at 64 they spill: 182 against 98 us at N = 300, 315 against
// 237 at N = 5000, tools/route_ab.py)
template <typename V>
__host__ __device__ constexpr int prep2_threads(Route r) {
  return r == Route::kPrivate ? 32 * kPrep2Warps
                              : kPrep2SharedThreads / (sizeof(V) / 4);
}

// a row's operands but its camera's table column (zero past O)
template <typename V>
struct Prep2Row {
  V u, v, x4[4];
  float m;
  int c;
};

template <typename V, Route R>
__global__ void __launch_bounds__(
    prep2_threads<V>(R),
    sizeof(V) == sizeof(float) ? kPrep2SmThreads / prep2_threads<V>(R) : 1)
    prepare2_kernel(const int32_t* __restrict__ cam, const V* __restrict__ ct,
                    const V* __restrict__ x4_in, const V* __restrict__ uv,
                    const float* __restrict__ mask, V* __restrict__ rw,
                    V* __restrict__ sw_out, V* __restrict__ mm,
                    V* __restrict__ jlw, V* __restrict__ jlsq,
                    V* __restrict__ jpsq, double* __restrict__ acc_g,
                    int n_obs, int n_cams, int use_valid, int huber_on,
                    V huber, V huber2, int copies) {
  constexpr bool kPrivate = R == Route::kPrivate;
  const int n_acc = kJp2Rows * n_cams;
  V* smem = dyn_smem<V>();
  V* acc = povar::warp_copy<R>(smem, copies, n_acc);
  const long O = n_obs;
  const int lane = threadIdx.x & 31;
  const long stride = (long)gridDim.x * blockDim.x;
  auto load = [&](long o) {
    Prep2Row<V> r;
    const bool in = o < O;
    r.c = in ? cam[o] : 0;
    r.u = in ? uv[o] : V(0);
    r.v = in ? uv[O + o] : V(0);
#pragma unroll
    for (int k = 0; k < 4; ++k) r.x4[k] = in ? x4_in[k * O + o] : V(0);
    r.m = in ? mask[o] : 0.0f;
    return r;
  };
  // warp-uniform trips: every lane reaches the warp's sums
  long base = (long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
  Prep2Row<V> next;
  if (kPrep2Prefetch) next = load(base + lane);
  for (; base < O; base += stride) {
    Prep2Row<V> row;
    if (kPrep2Prefetch) {
      row = next;
      next = load(base + stride + lane);
    } else {
      row = load(base + lane);
    }
    const long o = base + lane;
    V val[kJp2Rows];
#pragma unroll
    for (int k = 0; k < kJp2Rows; ++k) val[k] = V(0);
    const int c = row.c;
    bool live = false;
    if (o < O) {
      V P[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) P[k] = __ldg(ct + k * n_cams + c);
      const V u = row.u, v = row.v;
      const V(&x4)[4] = row.x4;
      V p[3];
      project(P, 1, 0, x4, p);
      const V eps = eps_sqrt<V>(), tn = tiny<V>();
      const bool valid = fabs(p[2]) >= eps;
      const V den = fabs(p[2]) < tn ? (p[2] < V(0) ? -tn : tn) : p[2];
      const V zinv = V(1) / den;
      const V mx = p[0] * zinv, my = p[1] * zinv;
      const V r0 = mx - u, r1 = my - v;
      const bool unmasked = row.m > 0.0f && (!use_valid || valid);
      const V livef = unmasked ? V(1) : V(0);
      const V res_sq = r0 * r0 + r1 * r1;
      V w = V(1);
      if (huber_on && !(res_sq < huber2)) {
        // max(res_sq, 1e-30) that keeps a NaN a NaN, as jnp.maximum does
        const V floor = huber_floor<V>();
        w = huber / sqrt(res_sq < floor ? floor : res_sq);
      }
      w = w * livef;
      const V s = sqrt(w);
      rw[o] = r0 * s;
      rw[O + o] = r1 * s;
      sw_out[o] = s;
      mm[o] = mx * livef;
      mm[O + o] = my * livef;
      mm[2 * O + o] = zinv * livef;
      const V sz = s * zinv;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const V j0 = sz * (P[k] - mx * P[8 + k]);
        const V j1 = sz * (P[4 + k] - my * P[8 + k]);
        jlw[k * O + o] = j0;
        jlw[(4 + k) * O + o] = j1;
        jlsq[k * O + o] = j0 * j0 + j1 * j1;
      }
      live = w != V(0);
      if (live) {
        const V wz2 = w * zinv * zinv;
        const V wk[2] = {wz2, wz2 * (mx * mx + my * my)};
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int k = 0; k < 4; ++k) val[4 * t + k] = wk[t] * x4[k] * x4[k];
      }
    }
    if (!__any_sync(povar::kFullMask, live)) continue;
    const povar::WarpPeers peers = povar::warp_peers(c, live);
    const unsigned leads = __ballot_sync(povar::kFullMask, peers.lead);
    if (__popc(leads) == 1 &&
        __popc(__ballot_sync(povar::kFullMask, live)) >= 4) {
      // every live lane on one camera: lanes 0-3 add two sums each
      V sum[2];
      povar::warp_reduce_scatter16(val, sum);
      const int cu = __shfl_sync(povar::kFullMask, c, __ffs(leads) - 1);
      if (kPrivate) __syncwarp();  // after the last walk's adds
      if (lane < kJp2Rows / 2) {
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
      povar::add_rows<kJp2Rows, R, double>(acc, acc_g, 0, n_cams, c, peers,
                                           val);
    }
  }
  if (!povar::block_sums_done<R, double, 32>(acc_g, smem, copies, n_acc,
                                             n_acc))
    return;
  // acc row k < 4: jpsq rows k and 4 + k; acc row 4 + k: jpsq row 8 + k
  povar::drain_sums<double>(acc_g, n_acc, [&](int i, double s) {
    const V x = (V)s;
    jpsq[i + (i < 4 * n_cams ? 0 : 4 * n_cams)] = x;
    if (i < 4 * n_cams) jpsq[i + 4 * n_cams] = x;
  });
}

// ------------------------------------------------------------------ S2
// Per-camera raw Hpp12 [144, N] (rows (4a+i)*12 + 4b+j) = sum w/p2^2 K3
// (x) x4 x4^T and b12 [12, N] = sum sw/p2 (C^T rt) (x) x4 of the
// landmark-corrected residual rt = r_w - Jl_ns hib, in moment form
// (pose_common.cuh: K3 = [[1, 0, -mx], [0, 1, -my], [-mx, -my,
// mx^2 + my^2]], weights wz2 (1, mx, my, mx^2 + my^2)). So a live row
// adds 52 values per camera: its b12 and the 40 moments of x4.
// `acc_g` [52 N + 1] is zeroed by the caller: b12, then the moments, then
// a ticket. kShared: a block accumulates in shared memory (52 N floats,
// 18.5 KB at N = 89, up to N = 1117) and flushes once into acc_g;
// otherwise every value goes straight to a global atomic. The lanes of a
// warp on one camera sum first (warp_scatter). The last block to take a
// ticket expands the moments into hpp (povar::expand_moments through
// ops/pose_kernels.moment_expand_table), which writes every entry of hpp,
// so hpp needs no zeroing. Dead rows (sw == 0) add nothing.
// Replaces pallas_pose2.py:267 hppb2 (_hppb2_kernel :218). Bound: the
// shared float atomics (compare-and-swap loops on this card), 52 per
// live row where the Pallas form's 124 would go, and the loads and
// arithmetic beside them: 71-72 us at venice-89 (124 atomics: 193), 43
// with the adds made dead stores, 13.3 for the 80 B a row reads
// (tools/pose2_ab.py and PERF.md; NVIDIA H100 80GB HBM3, 700 W).
using povar::kMomentRows;
using povar::kMoments;

// In f64 (hppb2_f64) the accumulators, the global sums and the outputs
// are f64; the shared route reaches N = 558.
template <typename V, bool kShared>
__global__ void __launch_bounds__(kThreads)
    hppb2_kernel(const int32_t* __restrict__ cam, const V* __restrict__ x4_in,
                 const V* __restrict__ mm, const V* __restrict__ sw_in,
                 const V* __restrict__ rw, const V* __restrict__ jlns,
                 const V* __restrict__ hib, const int* __restrict__ expand,
                 V* __restrict__ hpp, V* __restrict__ acc_g, int n_obs,
                 int n_cams) {
  V* smem = dyn_smem<V>();
  V* acc = kShared ? smem : acc_g;
  if (kShared) {
    povar::smem_zero(acc, kMomentRows * n_cams);
    __syncthreads();
  }
  const long O = n_obs;
  const int lane = threadIdx.x & 31;
  // warp-uniform trips: every lane reaches warp_scatter
  for (long base = (long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < O; base += (long)gridDim.x * blockDim.x) {
    const long o = base + lane;
    const V sw = o < O ? sw_in[o] : V(0);
    const bool live = sw != V(0);
    if (!__any_sync(povar::kFullMask, live)) continue;
    V v[kMomentRows];
    int c = 0;
#pragma unroll
    for (int k = 0; k < kMomentRows; ++k) v[k] = V(0);
    if (live) {
      c = cam[o];
      const V mx = mm[o], my = mm[O + o], zinv = mm[2 * O + o];
      const V x4[4] = {x4_in[o], x4_in[O + o], x4_in[2 * O + o],
                       x4_in[3 * O + o]};
      const V h0 = hib[o], h1 = hib[O + o], h2 = hib[2 * O + o];
      V rt[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        V corr = jlns[(r * 3) * O + o] * h0;
        corr += jlns[(r * 3 + 1) * O + o] * h1;
        corr += jlns[(r * 3 + 2) * O + o] * h2;
        rt[r] = rw[r * O + o] - corr;
      }
      const V swz = sw * zinv;
      const V ctr[3] = {rt[0], rt[1], -(mx * rt[0] + my * rt[1])};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const V t = swz * ctr[a];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[4 * a + k] = t * x4[k];
      }
      const V wz2 = swz * swz;
      const V kw[4] = {wz2, wz2 * mx, wz2 * my, wz2 * (mx * mx + my * my)};
      povar::moments(kw, x4, v);
    }
    povar::warp_scatter<kMomentRows>(acc, n_cams, c, live, v);
  }
  if (kShared) {
    __syncthreads();
    povar::flush_acc(acc_g, acc, kMomentRows * n_cams);
  }
  povar::expand_moments(expand, hpp, nullptr, acc_g, n_cams,
                        kShared ? n_cams : povar::kExpandChunk, smem);
}

// ------------------------------------------------------------------ S3
// out[i] = M[0][i] jx0 + M[1][i] jx1 with M [2, 3] per observation (mat6
// rows r*3+i), jx = sw/p2 [q~0 - mx q~2, q~1 - my q~2] (+ r_w when
// add_r; r_w is not read otherwise), q~a = sum_c x4_c zt[4a+c][cam].
// Replaces pallas_pose2.py:347 mat_dot2. Bound: 72 B of device memory per
// observation (60 read, 12 written; 80 B with r_w); no atomics. The z
// table is read in place.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    mat_dot2_kernel(const int32_t* __restrict__ cam, const V* __restrict__ x4_in,
                    const V* __restrict__ mm, const V* __restrict__ sw_in,
                    const V* __restrict__ mat6, const V* __restrict__ rw,
                    const V* __restrict__ zt, V* __restrict__ out,
                    int n_obs, int n_cams, int add_r) {
  const V* tbl = zt;
  const long O = n_obs;
  POVAR_OBS_LOOP(o, O) {
    const int c = cam[o];
    const V x4[4] = {x4_in[o], x4_in[O + o], x4_in[2 * O + o],
                     x4_in[3 * O + o]};
    const V swz = sw_in[o] * mm[2 * O + o];
    V jx[2];
    jp_of_zt(tbl, n_cams, c, x4, mm[o], mm[O + o], swz, jx);
    if (add_r) {
      jx[0] = jx[0] + rw[o];
      jx[1] = jx[1] + rw[O + o];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
      out[i * O + o] = mat6[i * O + o] * jx[0] + mat6[(3 + i) * O + o] * jx[1];
  }
}

// ------------------------------------------------------------------ S4
// out12[4a+c][cam] += ctv_a x4_c, ctv = sw/p2 [v0, v1, -(mx v0 + my v1)],
// v = M sb (v_r = sum_i M[r][i] sb_i), through pose_common.cuh's
// scatter_pass (the lanes of a warp on one camera sum first, into
// per-warp private copies; f64 block sums, one last block). Dead and pad
// rows (sw == 0) add nothing and are not read past sw; a NaN propagates.
// Replaces pallas_pose2.py:412 scatter2 (_scatter2_kernel :383). Bound:
// 72 B read per live observation (11.9 us at venice-89). The earlier
// version, as step 1's K5's: 33.0 us at venice-89, 136 on the mesh's
// window order, 37 at N = 1024. Here 19.2 us (the loads and the row's
// arithmetic ~13, the tail ~6.4), 18.6 on the window order (the walk
// alone 26.8), 44.5-44.8 at N = 1024, bound as K5 (tools/pose2_ab.py and
// PERF.md; NVIDIA H100 80GB HBM3, 700 W).
template <typename V>
struct ScatterRow2 {
  V sw, m[6], s[3], mx, my, zinv, x4[4];
  int c;
};

template <typename V, Route R>
__global__ void __launch_bounds__(povar::scatter_threads(R))
    scatter2_kernel(const int32_t* __restrict__ cam,
                    const V* __restrict__ x4_in,
                    const V* __restrict__ mm,
                    const V* __restrict__ sw_in,
                    const V* __restrict__ mat6,
                    const V* __restrict__ sb, V* __restrict__ out,
                    double* __restrict__ acc_g, int n_obs, int n_cams,
                    int copies) {
  V* smem = dyn_smem<V>();
  const long O = n_obs;
  auto load = [&](long o) {
    ScatterRow2<V> r;
    r.sw = o < O ? sw_in[o] : V(0);
    const bool live = r.sw != V(0);
#pragma unroll
    for (int k = 0; k < 6; ++k) r.m[k] = live ? mat6[k * O + o] : V(0);
#pragma unroll
    for (int k = 0; k < 3; ++k) r.s[k] = live ? sb[k * O + o] : V(0);
    r.mx = live ? mm[o] : V(0);
    r.my = live ? mm[O + o] : V(0);
    r.zinv = live ? mm[2 * O + o] : V(0);
#pragma unroll
    for (int k = 0; k < 4; ++k) r.x4[k] = live ? x4_in[k * O + o] : V(0);
    r.c = live ? cam[o] : 0;
    return r;
  };
  auto form = [](const ScatterRow2<V>& r, V (&out12)[povar::kScatterValues]) {
    V v[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      V t = r.m[3 * k] * r.s[0];
      t += r.m[3 * k + 1] * r.s[1];
      t += r.m[3 * k + 2] * r.s[2];
      v[k] = t;
    }
    const V swz = r.sw * r.zinv;
    const V ctv[3] = {swz * v[0], swz * v[1],
                      -swz * (r.mx * v[0] + r.my * v[1])};
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) out12[4 * a + k] = ctv[a] * r.x4[k];
    return r.sw != V(0);
  };
  povar::scatter_pass<R, ScatterRow2<V>>(load, form, out, acc_g, n_obs,
                                         n_cams, copies, smem);
}

// ------------------------------------------------------------------ S7
// The fused tangent power-series term over every narrow slot part in one
// launch:
//   pass A  jx = sw/p2 [q~0 - mx q~2, q~1 - my q~2] through the zt table,
//           u3 = M^T jx (M = mat6 rows r*3+i), sb = sum_j u3 over the w
//           rows of the landmark
//   pass B  v = M sb, ctv = sw/p2 [v0, v1, -(mx v0 + my v1)],
//           out[4a+c][cam] += ctv_a x4_c
// i.e. mat_dot2, the per-landmark slot sum, its re-expansion and scatter2
// in one pass. Slot row j of landmark l of part (ofs, g, w) is
// ofs + j g + l, so for a fixed j neighbouring landmarks are neighbouring
// rows. One thread per slot row: a tile of t = kE0Threads / w landmarks x
// all w rows (thread j t + l), so neighbouring threads read neighbouring
// addresses and every row of the call is in flight at once. Pass A puts
// the row's u3 in shared memory; after one barrier each thread sums its
// landmark's u3 over j = 0 .. w-1 in that order (the plain version's)
// and runs pass B on its row's operands, kept in registers across the
// barrier: each row is read from device memory once. Persistent blocks
// walk the tiles of an int32 table (pose_common.cuh tile_row,
// ops/pose_kernels.e0_tile_table), so the staging of zt, the
// zeroing and the 12 N global flush are paid once per resident block;
// parts of any w share the launch. kPrivate (16 x 12 N floats fit: N up
// to 277): each warp owns a [12, N] accumulator and its lanes on one
// camera sum first (warp_scatter), so the adds need no atomics; the
// copies are summed at the flush. Otherwise one shared accumulator with
// atomics; past N ~ 2,357 the zt table is read in place beside it, and
// past N ~ 4,800 every value goes to a global f32 atomic into `out`
// (pose_common.cuh launch_tiles). Dead and pad rows (sw == 0) add
// nothing, scatter2's guard: a near-plane 1/p2 never meets a zero weight.
// Replaces pallas_pose2.py:512 e0_term2_parts (_e0_term2_kernel :455).
// Bound: 60 B read per slot row (cam 4, x4 16, mm 12, sw 4, mat6 24), 9.9
// us at venice-89. One thread per landmark with 12 shared atomics per
// row takes 32 us there, 13.7 with the atomics made dead stores: the
// atomics bound it. This kernel takes 20.6 us, 20.2 with its adds made
// dead stores (the tile walk's barriers and occupancy are what is
// left), 24.0 on one shared-atomic accumulator; 512 threads per block
// against 23.4 us at 256 and 24.4 at 1024 (tools/pose2_ab.py and
// PERF.md; NVIDIA H100 80GB HBM3, 700 W).
using povar::kE0Threads;
using povar::kE0Warps;
using povar::kTileFields;

template <bool kStaged, Route R>
__global__ void __launch_bounds__(kE0Threads)
    e0_term2_kernel(const int32_t* __restrict__ cam, const float* __restrict__ x4_in,
                    const float* __restrict__ mm, const float* __restrict__ sw_in,
                    const float* __restrict__ mat6, const float* __restrict__ zt,
                    const int32_t* __restrict__ table, float* __restrict__ out,
                    int n_parts, int n_tiles, int n_obs, int n_cams) {
  constexpr bool kPrivate = R == Route::kPrivate;
  extern __shared__ float smem[];
  float* su = smem + (kStaged ? 12 * n_cams : 0);  // u3 [3, kE0Threads]
  int* part = reinterpret_cast<int*>(su + 3 * kE0Threads);
  // kPrivate: one [12, N] accumulator per warp; kShared: one per block;
  // kGlobal: none (the adds go to `out`, zeroed by the caller)
  float* acc = reinterpret_cast<float*>(part + kTileFields * n_parts);
  const int n_acc = 12 * n_cams;
  if (R != Route::kGlobal)
    povar::smem_zero(acc, (kPrivate ? kE0Warps : 1) * n_acc);
  povar::smem_copy(part, table, kTileFields * n_parts);
  const float* tbl = povar::stage_table<kStaged>(smem, zt, 12 * n_cams);
  __syncthreads();
  const long O = n_obs;
  const int th = threadIdx.x;
  float* wacc = R == Route::kGlobal ? out
                : kPrivate         ? acc + (th >> 5) * n_acc
                                   : acc;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const povar::TileRow row = povar::tile_row(part, n_parts, tile, th);
    const int o = row.o, t = row.t, w = row.w;
    const float sw = row.in ? sw_in[o] : 0.0f;
    const bool live = sw != 0.0f;
    int c = 0;
    float x4[4] = {0.0f, 0.0f, 0.0f, 0.0f}, m6[6] = {0.0f, 0.0f, 0.0f,
                                                     0.0f, 0.0f, 0.0f};
    float mx = 0.0f, my = 0.0f, swz = 0.0f;
    float u[3] = {0.0f, 0.0f, 0.0f};
    if (live) {
      c = cam[o];
#pragma unroll
      for (int k = 0; k < 4; ++k) x4[k] = x4_in[k * O + o];
#pragma unroll
      for (int k = 0; k < 6; ++k) m6[k] = mat6[k * O + o];
      mx = mm[o];
      my = mm[O + o];
      swz = sw * mm[2 * O + o];
      float jx[2];
      jp_of_zt(tbl, n_cams, c, x4, mx, my, swz, jx);
#pragma unroll
      for (int i = 0; i < 3; ++i) u[i] = m6[i] * jx[0] + m6[3 + i] * jx[1];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) su[i * kE0Threads + th] = u[i];
    __syncthreads();
    float sb[3] = {0.0f, 0.0f, 0.0f};
    if (live) {
      const int l = row.l;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float a = su[i * kE0Threads + l];
        for (int jj = 1; jj < w; ++jj) a += su[i * kE0Threads + jj * t + l];
        sb[i] = a;
      }
    }
    __syncthreads();  // the next tile rewrites su
    float v[12];
    const float v0 = m6[0] * sb[0] + m6[1] * sb[1] + m6[2] * sb[2];
    const float v1 = m6[3] * sb[0] + m6[4] * sb[1] + m6[5] * sb[2];
    const float ctv[3] = {swz * v0, swz * v1, -swz * (mx * v0 + my * v1)};
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) v[4 * a + k] = ctv[a] * x4[k];
    povar::warp_scatter<12, !kPrivate>(wacc, n_cams, c, live, v);
  }
  if (R == Route::kGlobal) return;
  __syncthreads();
  povar::flush_tiles<kPrivate>(out, acc, n_acc);
}

// ------------------------------------------------------------------ S8
// Per-camera tangent Schur-Jacobi corrections [144, N], rows
// ((a*4+i)*3+b)*4+j: sum H[a][b] x4_i x4_j with
//   G = B B^T (2x2, B = mat6 rows r*3+i),  H = (sw/p2)^2 C^T G C,
//   C = [[1, 0, -mx], [0, 1, -my]]
// in moment form (pose_common.cuh, schur_pass): a live row adds the 60
// values H_s (x4_i x4_j), a <= b and i <= j, per camera; the blocks' sums
// meet in f64 and the last block writes every row, a row and its mirror
// from one sum. Dead rows (sw == 0) add nothing. The caller folds
// Kps^T . Kps.
// Replaces pallas_pose2.py:601 schur_diag2 (_schur2_kernel :563). Bound:
// 60 B read per observation (10.0 us at venice-89). The earlier version
// added all 144 terms of a live row with per-lane f32 atomics (compare-
// and-swap loops on this card), into 144 N shared accumulators flushed
// with 144 N f32 global atomics a block: 211-215 us at venice-89, ~1000
// on the mesh's window order (the mesh's PSC + RIPCG runs it there) and
// 1046-1068 at N = 1024. Here 58.4 us, 62.4 on the window order and 565
// at N = 1024, bound as step 1's K9 (tools/pose2_ab.py and PERF.md;
// NVIDIA H100 80GB HBM3, 700 W).
template <typename V>
struct SchurRow2 {
  V sw, m[6], mx, my, zinv, x4[4];
  int c;
};

template <typename V, Route R>
__global__ void __launch_bounds__(povar::schur_threads(R))
    schur_diag2_kernel(const int32_t* __restrict__ cam,
                       const V* __restrict__ x4_in,
                       const V* __restrict__ mm,
                       const V* __restrict__ sw_in,
                       const V* __restrict__ mat6,
                       const int* __restrict__ expand,
                       V* __restrict__ out, double* __restrict__ acc_g,
                       int n_obs, int n_cams, int copies) {
  V* smem = dyn_smem<V>();
  const long O = n_obs;
  auto load = [&](long o) {
    SchurRow2<V> r;
    const bool in = o < O;
    r.sw = in ? sw_in[o] : V(0);
#pragma unroll
    for (int k = 0; k < 6; ++k) r.m[k] = in ? mat6[k * O + o] : V(0);
    r.mx = in ? mm[o] : V(0);
    r.my = in ? mm[O + o] : V(0);
    r.zinv = in ? mm[2 * O + o] : V(0);
#pragma unroll
    for (int k = 0; k < 4; ++k) r.x4[k] = in ? x4_in[k * O + o] : V(0);
    r.c = in ? cam[o] : 0;
    return r;
  };
  auto form = [](const SchurRow2<V>& r, V H[6], V xh[4]) {
    const V* m = r.m;
    const V g00 = m[0] * m[0] + m[1] * m[1] + m[2] * m[2];
    const V g11 = m[3] * m[3] + m[4] * m[4] + m[5] * m[5];
    const V g01 = m[0] * m[3] + m[1] * m[4] + m[2] * m[5];
    const V mx = r.mx, my = r.my;
    const V swz = r.sw * r.zinv;
    const V wz2 = swz * swz;
    const V cg[3][2] = {{g00, g01},
                        {g01, g11},
                        {-(mx * g00 + my * g01), -(mx * g01 + my * g11)}};
    const V cc[3][2] = {{V(1), V(0)}, {V(0), V(1)}, {-mx, -my}};
    int s = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = a; b < 3; ++b, ++s)
        H[s] = wz2 * (cg[a][0] * cc[b][0] + cg[a][1] * cc[b][1]);
#pragma unroll
    for (int k = 0; k < 4; ++k) xh[k] = r.x4[k];
    return r.sw != V(0);
  };
  povar::schur_pass<R, SchurRow2<V>>(load, form, expand, out, acc_g, n_obs,
                                     n_cams, copies, smem);
}

// ------------------------------------------------------------------ S5
// Per-block partials of -l_diff = sum_r j_inc_r (0.5 j_inc_r + r_w_r),
//   j_inc = jp(zt) + Jl_s ilm4,  Jl_s row r = jls8[r*4 .. r*4+3]
// (zt = Kps inc per camera, ilm4 the lifted landmark increment expanded
// to observations).
// Replaces pallas_pose2.py:667 ldiff2. Bound: 92 B read per observation;
// no atomics. The zt table is read in place.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    ldiff2_kernel(const int32_t* __restrict__ cam, const V* __restrict__ x4_in,
                  const V* __restrict__ mm, const V* __restrict__ sw_in,
                  const V* __restrict__ rw, const V* __restrict__ jls8,
                  const V* __restrict__ ilm4, const V* __restrict__ zt,
                  V* __restrict__ partials, int n_obs, int n_cams) {
  __shared__ V red[32];
  const V* tbl = zt;
  const long O = n_obs;
  V total = V(0);
  POVAR_OBS_LOOP(o, O) {
    const int c = cam[o];
    const V x4[4] = {x4_in[o], x4_in[O + o], x4_in[2 * O + o],
                     x4_in[3 * O + o]};
    const V swz = sw_in[o] * mm[2 * O + o];
    V jp[2];
    jp_of_zt(tbl, n_cams, c, x4, mm[o], mm[O + o], swz, jp);
    const V i0 = ilm4[o], i1 = ilm4[O + o], i2 = ilm4[2 * O + o],
            i3 = ilm4[3 * O + o];
    V ld = V(0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      V jl = jls8[(r * 4) * O + o] * i0;
      jl += jls8[(r * 4 + 1) * O + o] * i1;
      jl += jls8[(r * 4 + 2) * O + o] * i2;
      jl += jls8[(r * 4 + 3) * O + o] * i3;
      const V j_inc = jp[r] + jl;
      ld += j_inc * (V(0.5) * j_inc + rw[r * O + o]);
    }
    total += ld;
  }
  total = povar::block_sum(total, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// ------------------------------------------------------------------ S6
// Homogeneous cost in native f64 over live rows (mask > 0): the sums
//   0 sum rho(|r|^2) (robust 0 NONE: 0.5 r^2, 1 HUBER: 0.5 (2 - w) w
//     r^2, 2 CAUCHY: log1p(r^2)),  1 sum |r|,
//   2, 3 the same over projection-valid rows (|p2| >= 1e-5),
// and the counts 0 of valid rows, 1 of rows with a non-finite residual,
// 2 of live rows, as integers. Each thread sums its rows of the grid-
// stride loop; a block's seven values meet in one shuffle pass and one
// barrier (block_reduce), and each block writes them to `part` (f64
// [4, n_part], then the counts as Count [3, n_part]). The last block to
// take a ticket adds the partials up in a fixed order (warp k takes
// value k of every block, sum_blocks) into sums [4], counts [2] (live,
// valid) as int64 and ok (no non-
// finite residual), and resets the ticket for the next call: no
// floating-point atomics, so two calls on one input give the same bits,
// and the caller zeroes nothing. The camera table (8.5 KB at N = 89) is
// read through the read-only path (__ldg), not staged.
// Replaces pallas_pose2.py:822 error2_df32 (double-float with a refined
// division on the TPU). Bound: 60 B read per observation (f64 state) and
// ~45 f64 operations per row, far below the card's f64 rate: 13.7 us
// against 9.3 at venice-89, ~3 of them the last block's tail (a fence
// and a ticket per block, two rounds of L2 loads). An earlier version
// (seven serial block sums, the table staged in shared memory, f64
// counts, and five device operations around the launch: a zeroed
// partials buffer, their sum, two casts and a compare) took 19.5
// (tools/pose2_ab.py and PERF.md; NVIDIA H100 80GB HBM3, 700 W).
constexpr int kErrSums = 4;
constexpr int kErrCounts = 3;
constexpr int kWarps = kThreads / 32;
using Count = unsigned;

// a block's sums and counts, valid in thread 0: one shuffle pass, one
// barrier, then warp 0 over the warps' values
__device__ __forceinline__ void block_reduce(double (&s)[kErrSums],
                                             Count (&n)[kErrCounts]) {
  __shared__ double red_s[kErrSums][kWarps];
  __shared__ Count red_n[kErrCounts][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kErrSums; ++k) s[k] = warp_sum(s[k]);
#pragma unroll
  for (int k = 0; k < kErrCounts; ++k) n[k] = warp_sum(n[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kErrSums; ++k) red_s[k][warp] = s[k];
#pragma unroll
    for (int k = 0; k < kErrCounts; ++k) red_n[k][warp] = n[k];
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int k = 0; k < kErrSums; ++k)
    s[k] = warp_sum(lane < kWarps ? red_s[k][lane] : 0.0);
#pragma unroll
  for (int k = 0; k < kErrCounts; ++k)
    n[k] = warp_sum(lane < kWarps ? red_n[k][lane] : Count(0));
}

// value k of every block's partials in `part` (row k of n_part entries
// of T), valid in lane 0: lane l adds blocks l + 32 u + 32 kBatch i in
// turn into kBatch sums (u), which it adds in order; then the shuffle
// tree. kBatch loads per lane are in flight at once (the last block
// runs alone, so their latency is the kernel's tail).
template <typename T>
__device__ __forceinline__ T sum_blocks(const T* part, int n_part, int k) {
  using povar::kBatch;
  const int lane = threadIdx.x & 31;
  const int n = gridDim.x;
  T t[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) t[u] = T(0);
  for (int b0 = lane; b0 < n; b0 += 32 * kBatch) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int b = b0 + 32 * u;
      if (b < n) t[u] += __ldcg(part + k * n_part + b);
    }
  }
  T sum = t[0];
#pragma unroll
  for (int u = 1; u < kBatch; ++u) sum += t[u];
  return warp_sum(sum);
}

__global__ void __launch_bounds__(kThreads)
    pose_error2_kernel(const int32_t* __restrict__ cam, const double* __restrict__ ct,
                       const double* __restrict__ x4_in, const double* __restrict__ uv,
                       const float* __restrict__ mask, double* __restrict__ part,
                       unsigned* __restrict__ ticket, double* __restrict__ sums,
                       int64_t* __restrict__ counts, bool* __restrict__ ok,
                       int n_part, int n_obs, int n_cams, int robust,
                       double huber) {
  const long O = n_obs;
  double s[kErrSums] = {0.0, 0.0, 0.0, 0.0};
  Count n[kErrCounts] = {0, 0, 0};
  POVAR_OBS_LOOP(o, O) {
    if (!(mask[o] > 0.0f)) continue;
    const int c = cam[o];
    const double x4[4] = {x4_in[o], x4_in[O + o], x4_in[2 * O + o],
                          x4_in[3 * O + o]};
    double P[12], p[3];
#pragma unroll
    for (int k = 0; k < 12; ++k) P[k] = __ldg(ct + k * n_cams + c);
    project(P, 1, 0, x4, p);
    const double r0 = p[0] / p[2] - uv[o];
    const double r1 = p[1] / p[2] - uv[O + o];
    const bool valid = fabs(p[2]) >= 1e-5;
    const double validf = valid ? 1.0 : 0.0;
    const bool finite = isfinite(r0) && isfinite(r1);
    const double res_sq = r0 * r0 + r1 * r1;
    double e;
    if (robust == 1) {
      const double w = res_sq < huber * huber ? 1.0 : huber / sqrt(res_sq);
      e = 0.5 * (2.0 - w) * w * res_sq;
    } else if (robust == 2) {
      e = log1p(res_sq);
    } else {
      e = 0.5 * res_sq;
    }
    const double rn = sqrt(res_sq);
    s[0] += e;
    s[1] += rn;
    s[2] += e * validf;
    s[3] += rn * validf;
    n[0] += valid ? 1 : 0;
    n[1] += finite ? 0 : 1;
    n[2] += 1;
  }
  block_reduce(s, n);
  Count* part_n = reinterpret_cast<Count*>(part + kErrSums * n_part);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kErrSums; ++k) part[k * n_part + blockIdx.x] = s[k];
#pragma unroll
    for (int k = 0; k < kErrCounts; ++k)
      part_n[k * n_part + blockIdx.x] = n[k];
  }
  if (!povar::last_block(ticket, true)) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < kErrSums) {
    const double t = sum_blocks(part, n_part, warp);
    if (lane == 0) sums[warp] = t;
  } else if (warp < kErrSums + kErrCounts) {
    const Count t = sum_blocks<Count>(part_n, n_part, warp - kErrSums);
    if (lane == 0) {
      const int k = warp - kErrSums;
      if (k == 0) counts[1] = (int64_t)t;  // valid
      if (k == 1) *ok = t == Count(0);     // no non-finite residual
      if (k == 2) counts[0] = (int64_t)t;  // live
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// ----------------------------------------------------------- launchers
// One per templated kernel, for both value types: the route by shared-
// memory bytes of V (the f32 instantiations' routes as before).

template <typename V>
int prepare2_launch(const int32_t* cam, const V* ct, const V* x4, const V* uv,
                    const float* mask, V* rw, V* sw, V* mm, V* jlw, V* jlsq,
                    V* jpsq, double* acc, int n_obs, int n_cams,
                    int use_valid, int huber_on, V huber, V huber2,
                    void* stream) {
  if (n_obs <= 0 || n_cams <= 0) return (int)cudaErrorInvalidValue;
  povar::SumsPlan plan =
      povar::sums_plan(kJp2Rows, n_cams, kPrep2Warps, kPrep2Warps,
                       prep2_threads<V>(Route::kShared), kPrep2StaticSmem,
                       sizeof(V));
  if (plan.route == Route::kShared) {
    // fewer copies than fit: the table's reads through L1 keep the rest
    const int copies = std::min(plan.copies, kPrep2SharedCopies);
    plan.smem = plan.smem / plan.copies * copies;
    plan.copies = copies;
  }
  return povar::launch_sums(
      plan, prepare2_kernel<V, Route::kPrivate>,
      prepare2_kernel<V, Route::kShared>, prepare2_kernel<V, Route::kGlobal>,
      n_obs, stream, cam, ct, x4, uv, mask, rw, sw, mm, jlw, jlsq, jpsq, acc,
      n_obs, n_cams, use_valid, huber_on, huber, huber2);
}

template <typename V>
int hppb2_launch(const int32_t* cam, const V* x4, const V* mm, const V* sw,
                 const V* rw, const V* jlns, const V* hib, const int* expand,
                 V* hpp, V* acc, int n_obs, int n_cams, void* stream) {
  const size_t shared = sizeof(V) * kMomentRows * (size_t)n_cams;
  if (shared <= (size_t)max_optin_smem()) {
    return launch(hppb2_kernel<V, true>, n_obs, shared, stream, cam, x4, mm,
                  sw, rw, jlns, hib, expand, hpp, acc, n_obs, n_cams);
  }
  return launch(hppb2_kernel<V, false>, n_obs,
                sizeof(V) * kMoments * povar::kExpandChunk, stream, cam, x4,
                mm, sw, rw, jlns, hib, expand, hpp, acc, n_obs, n_cams);
}

template <typename V>
int scatter2_launch(const int32_t* cam, const V* x4, const V* mm, const V* sw,
                    const V* mat6, const V* sb, V* out, double* acc,
                    int n_obs, int n_cams, void* stream) {
  return povar::launch_scatter<V>(
      scatter2_kernel<V, Route::kPrivate>, scatter2_kernel<V, Route::kShared>,
      scatter2_kernel<V, Route::kGlobal>, n_obs, n_cams, stream, cam, x4, mm,
      sw, mat6, sb, out, acc, n_obs, n_cams);
}

template <typename V>
int schur_diag2_launch(const int32_t* cam, const V* x4, const V* mm,
                       const V* sw, const V* mat6, const int* expand, V* out,
                       double* acc, int n_obs, int n_cams, void* stream) {
  return povar::launch_schur<V>(
      schur_diag2_kernel<V, Route::kPrivate>,
      schur_diag2_kernel<V, Route::kShared>,
      schur_diag2_kernel<V, Route::kGlobal>, n_obs, n_cams, stream, cam, x4,
      mm, sw, mat6, expand, out, acc, n_obs, n_cams);
}

}  // namespace

extern "C" {

// jpsq: [12, n_cams]; acc: 8 n_cams + 1 doubles, zero (every call leaves
// them zero)
int povar_prepare2(const int32_t* cam, const float* ct, const float* x4,
                   const float* uv, const float* mask, float* rw, float* sw,
                   float* mm, float* jlw, float* jlsq, float* jpsq,
                   double* acc, int n_obs, int n_cams, int use_valid,
                   int huber_on, float huber, float huber2, void* stream) {
  return prepare2_launch<float>(cam, ct, x4, uv, mask, rw, sw, mm, jlw, jlsq,
                                jpsq, acc, n_obs, n_cams, use_valid, huber_on,
                                huber, huber2, stream);
}

int povar_prepare2_f64(const int32_t* cam, const double* ct,
                       const double* x4, const double* uv, const float* mask,
                       double* rw, double* sw, double* mm, double* jlw,
                       double* jlsq, double* jpsq, double* acc, int n_obs,
                       int n_cams, int use_valid, int huber_on, double huber,
                       double huber2, void* stream) {
  return prepare2_launch<double>(cam, ct, x4, uv, mask, rw, sw, mm, jlw, jlsq,
                                 jpsq, acc, n_obs, n_cams, use_valid, huber_on,
                                 huber, huber2, stream);
}

int povar_hppb2(const int32_t* cam, const float* x4, const float* mm,
                const float* sw, const float* rw, const float* jlns,
                const float* hib, const int* expand, float* hpp, float* acc,
                int n_obs, int n_cams, void* stream) {
  return hppb2_launch<float>(cam, x4, mm, sw, rw, jlns, hib, expand, hpp, acc,
                             n_obs, n_cams, stream);
}

int povar_hppb2_f64(const int32_t* cam, const double* x4, const double* mm,
                    const double* sw, const double* rw, const double* jlns,
                    const double* hib, const int* expand, double* hpp,
                    double* acc, int n_obs, int n_cams, void* stream) {
  return hppb2_launch<double>(cam, x4, mm, sw, rw, jlns, hib, expand, hpp,
                              acc, n_obs, n_cams, stream);
}

int povar_mat_dot2(const int32_t* cam, const float* x4, const float* mm,
                   const float* sw, const float* mat6, const float* rw,
                   const float* zt, float* out, int n_obs, int n_cams,
                   int add_r, void* stream) {
  return launch(mat_dot2_kernel<float>, n_obs, 0, stream, cam, x4, mm, sw,
                mat6, rw, zt, out, n_obs, n_cams, add_r);
}

int povar_mat_dot2_f64(const int32_t* cam, const double* x4, const double* mm,
                       const double* sw, const double* mat6, const double* rw,
                       const double* zt, double* out, int n_obs, int n_cams,
                       int add_r, void* stream) {
  return launch(mat_dot2_kernel<double>, n_obs, 0, stream, cam, x4, mm, sw,
                mat6, rw, zt, out, n_obs, n_cams, add_r);
}

// out: [12, n_cams]; acc: 12 n_cams + 1 doubles, zero (every call
// leaves them zero)
int povar_scatter2(const int32_t* cam, const float* x4, const float* mm,
                   const float* sw, const float* mat6, const float* sb,
                   float* out, double* acc, int n_obs, int n_cams,
                   void* stream) {
  return scatter2_launch<float>(cam, x4, mm, sw, mat6, sb, out, acc, n_obs,
                                n_cams, stream);
}

int povar_scatter2_f64(const int32_t* cam, const double* x4, const double* mm,
                       const double* sw, const double* mat6, const double* sb,
                       double* out, double* acc, int n_obs, int n_cams,
                       void* stream) {
  return scatter2_launch<double>(cam, x4, mm, sw, mat6, sb, out, acc, n_obs,
                                 n_cams, stream);
}

int povar_e0_term2(const int32_t* cam, const float* x4, const float* mm,
                   const float* sw, const float* mat6, const float* zt,
                   const int32_t* table, float* out, int n_parts, int n_tiles,
                   int n_obs, int n_cams, int tile_threads, void* stream) {
  // the table's tiles were cut for blocks of tile_threads threads; out is
  // zeroed by the caller
  const size_t base = sizeof(float) * 3 * kE0Threads +
                      sizeof(int) * kTileFields * (size_t)n_parts;
  return povar::launch_tiles(
      e0_term2_kernel<true, Route::kPrivate>,
      e0_term2_kernel<true, Route::kShared>,
      e0_term2_kernel<false, Route::kShared>,
      e0_term2_kernel<false, Route::kGlobal>, n_parts, n_tiles, tile_threads,
      base, sizeof(float) * 12 * (size_t)n_cams, 12 * (size_t)n_cams, stream,
      cam, x4, mm, sw, mat6, zt, table, out, n_parts, n_tiles, n_obs, n_cams);
}

// out: [144, n_cams]; acc: 60 n_cams + 1 doubles, zero (every call
// leaves them zero)
int povar_schur_diag2(const int32_t* cam, const float* x4, const float* mm,
                      const float* sw, const float* mat6, const int* expand,
                      float* out, double* acc, int n_obs, int n_cams,
                      void* stream) {
  return schur_diag2_launch<float>(cam, x4, mm, sw, mat6, expand, out, acc,
                                   n_obs, n_cams, stream);
}

int povar_schur_diag2_f64(const int32_t* cam, const double* x4,
                          const double* mm, const double* sw,
                          const double* mat6, const int* expand, double* out,
                          double* acc, int n_obs, int n_cams, void* stream) {
  return schur_diag2_launch<double>(cam, x4, mm, sw, mat6, expand, out, acc,
                                    n_obs, n_cams, stream);
}

int povar_ldiff2(const int32_t* cam, const float* x4, const float* mm,
                 const float* sw, const float* rw, const float* jls8,
                 const float* ilm4, const float* zt, float* partials,
                 int n_obs, int n_cams, void* stream) {
  return launch(ldiff2_kernel<float>, n_obs, 0, stream, cam, x4, mm, sw, rw,
                jls8, ilm4, zt, partials, n_obs, n_cams);
}

int povar_ldiff2_f64(const int32_t* cam, const double* x4, const double* mm,
                     const double* sw, const double* rw, const double* jls8,
                     const double* ilm4, const double* zt, double* partials,
                     int n_obs, int n_cams, void* stream) {
  return launch(ldiff2_kernel<double>, n_obs, 0, stream, cam, x4, mm, sw, rw,
                jls8, ilm4, zt, partials, n_obs, n_cams);
}

// part [7, n_part] f64 scratch (n_part >= the grid: ceil(O / 256)
// does); ticket zero before the first call, reset by every call
int povar_pose_error2(const int32_t* cam, const double* ct, const double* x4,
                      const double* uv, const float* mask, double* part,
                      unsigned* ticket, double* sums, int64_t* counts,
                      bool* ok, int n_part, int n_obs, int n_cams,
                      int robust, double huber, void* stream) {
  static_assert(sizeof(Count) <= sizeof(double), "counts fit a partial");
  if ((long)n_part * kThreads < n_obs) return (int)cudaErrorInvalidValue;
  return launch(pose_error2_kernel, n_obs, 0, stream, cam, ct, x4, uv, mask,
                part, ticket, sums, counts, ok, n_part, n_obs, n_cams,
                robust, huber);
}

}  // extern "C"
