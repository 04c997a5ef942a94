// Step-1 structured pOSE kernels for Hopper (sm_90a): the hand-written
// CUDA counterparts of the Pallas kernels on the POWER_VARPROJ,
// POWER_SCHUR_COMPLEMENT and PCG step-1 paths of
// povar_tpu/ops/pallas_pose.py.
//
//   K1 prepare                  <- pallas_pose.py:285 (_prepare_kernel :227)
//   K2 e0_factor                <- pallas_pose.py:385 (_h_kernel :362)
//   K3 hpp_b_structured         <- pallas_pose.py:489 (_hpp_b_kernel :431)
//   K4 e0_u_structured          <- pallas_pose.py:568 (_e0_u_kernel :552)
//   K5 e0_scatter_structured    <- pallas_pose.py:623 (_e0_scatter_kernel :599)
//   K6 apply_ldiff              <- pallas_pose.py:846 (_ldiff_kernel :794)
//   K7 pose_error               <- pallas_pose.py:1319 (pose_error_df32,
//                                  _error_kernel :1217), in native f64
//   K8 e0_term_parts            <- pallas_pose.py:748 (_e0_term_kernel :673)
//   K9 schur_diag_structured    <- pallas_pose.py:1020 (_schur_diag_kernel
//                                  :987)
//   K10 poba_t3                 <- pallas_pose.py:938 (_poba_t3_kernel :905)
//   K11 apply_ldiff_stored      <- pallas_pose.py:1096 (_ldiff_stored_kernel
//                                  :1055)
//
// What the TPU kernels needed and these do not: the one-hot incidence
// matmuls with the exact bf16 3-way split (a camera row is a shared-
// memory read by index here), the 128-lane padding and VMEM tile caps
// (a grid-stride loop covers any O), the per-width launches and VMEM
// budget of the fused term (one launch walks every part through a
// (part, tile) table), and the double-float arithmetic of the cost (the
// H100 has native f64).
//
// What bounds them on the card: all eleven stream O observations with a
// few dozen flops each, so each is bound by device-memory bytes per
// observation (K1 reads 28 B and writes 68 B, 48 without its sums; K2
// 64/36; K3 68/0; K4 52/12; K5 64/0; K6 68/0; K7 48/0 at f64 state; K8
// 52/0; K9 52/0; K10 56/12; K11 68/0) until its per-camera adds cost
// more than the bytes (a shared f32 atomicAdd is a compare-and-swap loop
// on this card): K1 adds 8, K5 12 and K9 its 60 moments through
// warp_scatter into per-warp accumulators, and K5's blocks' f64 sums and
// last block (its tail) take a third of its time. K3
// adds its 52 moment-form values through warp_scatter, and those adds
// (~40 of its 76 us at venice-89) and its arithmetic bind it; K8 adds
// 12 per row into per-warp accumulators at no measurable cost, and its
// tile walk (two barriers per tile, two blocks per SM) binds it at 2.3x
// its bytes. A block's shared accumulators leave through one global
// atomic per entry, so the grid is sized to what is resident at once
// (grid-stride), not to O.
//
// C interface: every entry point takes device pointers, sizes, scalar
// constants and the CUDA stream to launch on, launches one kernel, and
// returns the cudaError_t of the launch (0 on success). Nothing here
// allocates or synchronises; outputs that accumulate must be zeroed by
// the caller.

#include "pose_common.cuh"

using povar::kE0Threads;
using povar::kE0Warps;
using povar::kMomentRows;
using povar::kThreads;
using povar::kTileFields;
using povar::launch;
using povar::max_optin_smem;
using povar::Route;

namespace {

// ------------------------------------------------------------------ K1
// Linearization-point pass: residual, robust weight, landmark normal-
// equation terms ata = w A~^T A~ [9, O] (rows i*3+j) and atr = w A~^T r
// [3, O], and the per-camera Jp column norms^2 jpsq[4a+j] =
// sum w K[a][a] xh_j^2 with diag K = [1, 1, sp^2 (u^2 + v^2)].
// Rows 0-3 and 4-7 of jpsq are the same sums, so a live row adds 8
// values per camera (w xh_j^2 and w kd2 xh_j^2, xh_3 = 1) through
// warp_scatter (the lanes of a warp on one camera sum first).
// kPrivate (16 warps x 8 N floats fit: N up to 454): blocks of 512
// threads, each warp owning an [8, N] shared accumulator, so its adds
// need no atomics; otherwise blocks of 1024 threads on one [8, N]
// accumulator with shared atomics (up to N = 7264; fewer, larger blocks
// flush fewer partials: 41 against 50-53 us at N = 1024); past that, the
// global route: blocks of 1024 threads whose lanes on one camera sum
// first and then add straight to the f64 sums in `acc_g` (no shared
// memory; final-13682's N = 13,682). A block
// flushes its sums (the warps' copies summed) as f64 global atomics into
// `acc_g` [8 N + 1] doubles (the sums, then a ticket), zeroed by the
// caller; the last block to take a ticket writes jpsq [12, N] in f32
// from them, rows 4-7 equal to rows 0-3. The camera table is read
// through __ldg (4.3 KB at N = 89; staging it in shared memory cost 2 us
// there and 13 at N = 1024). kSums false (the back-substitution and the
// landmark initialization, which read ata and atr alone) skips the sums
// and the r_w / sw stores.
// Replaces pallas_pose.py:285 prepare. Bound: 96 B of device memory per
// observation (28 read, 68 written), 76 B without the sums (28 read,
// 48 written). An earlier version's 12 per-lane shared atomics per live
// row (each a compare-and-swap loop on this card) took 32 us against
// 16.0 at venice-89 and 91 on the mesh's window order; here the r_w /
// sw stores cost ~4.6 us of 28.2, the adds ~2.3 and the f64 atomics
// ~2.4. The blocks' partials added in f32 straight into both rows of a
// zeroed jpsq (no last block) took 24.2 us but sent 1 of 64
// POWER_SCHUR_COMPLEMENT step-1 solves past chip_smoke.py's band, the
// earlier version 0 of 64 in the same call (tools/pose1_ab.py, tools/
// step2_spread.py and PERF.md; NVIDIA H100 80GB HBM3, 700 W).
constexpr int kJpRows = 8;
constexpr int kPrepThreads = 512;
constexpr int kPrepSharedThreads = 1024;
constexpr int kPrepSmThreads = 1536;  // resident per SM: the registers

template <bool kSums, Route R, int kBlock>
__global__ void __launch_bounds__(kBlock, kPrepSmThreads / kBlock)
    prepare_kernel(const int32_t* __restrict__ cam, const float* __restrict__ ct,
                   const float* __restrict__ x, const float* __restrict__ uv,
                   const float* __restrict__ mask, float* __restrict__ rw,
                   float* __restrict__ sw_out, float* __restrict__ ata,
                   float* __restrict__ atr, float* __restrict__ jpsq,
                   double* __restrict__ acc_g, int n_obs, int n_cams,
                   float sp, float sa, float sp2, int huber_on, float huber,
                   float huber2) {
  constexpr int kWarps = kBlock / 32;
  constexpr bool kPrivate = R == Route::kPrivate;
  constexpr bool kGlobal = R == Route::kGlobal;
  // kSums: [8, N] per warp or per block; none on the global route
  extern __shared__ float acc[];
  const int n_acc = kJpRows * n_cams;
  if (kSums && !kGlobal) {
    povar::smem_zero(acc, (kPrivate ? kWarps : 1) * n_acc);
    __syncthreads();
  }
  float* wacc = kPrivate ? acc + (threadIdx.x >> 5) * n_acc : acc;
  const long O = n_obs;
  const int lane = threadIdx.x & 31;
  // warp-uniform trips: every lane reaches warp_scatter
  for (long base = (long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < O; base += (long)gridDim.x * blockDim.x) {
    const long o = base + lane;
    float sums[kJpRows];
#pragma unroll
    for (int k = 0; k < kJpRows; ++k) sums[k] = 0.0f;
    int c = 0;
    bool live = false;
    if (o < O) {
      c = cam[o];
      const float u = uv[o], v = uv[O + o];
      const float xh[4] = {x[o], x[O + o], x[2 * O + o], 1.0f};
      const bool unmasked = mask[o] > 0.0f;
      float P[12], A[4][4], r[4];
#pragma unroll
      for (int k = 0; k < 12; ++k) P[k] = __ldg(ct + k * n_cams + c);
      povar::a_tilde(P, 1, 0, u, v, sp, sa, A);
      povar::residual(A, xh, u, v, sa, r);
#pragma unroll
      for (int k = 0; k < 4; ++k) r[k] = unmasked ? r[k] : 0.0f;
      const float res_sq =
          r[0] * r[0] + r[1] * r[1] + r[2] * r[2] + r[3] * r[3];
      float w = 1.0f;
      if (huber_on && !(res_sq < huber2)) {
        // max(res_sq, 1e-30) that keeps a NaN a NaN, as jnp.maximum does
        w = huber / sqrtf(res_sq < 1e-30f ? 1e-30f : res_sq);
      }
      w = unmasked ? w : 0.0f;
      if (kSums) {
        const float s = sqrtf(w);
#pragma unroll
        for (int k = 0; k < 4; ++k) rw[k * O + o] = r[k] * s;
        sw_out[o] = s;
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float a = A[0][i] * A[0][j];
          a += A[1][i] * A[1][j];
          a += A[2][i] * A[2][j];
          a += A[3][i] * A[3][j];
          ata[(i * 3 + j) * O + o] = w * a;
        }
        float b = A[0][i] * r[0];
        b += A[1][i] * r[1];
        b += A[2][i] * r[2];
        b += A[3][i] * r[3];
        atr[i * O + o] = w * b;
      }
      if (kSums) {
        live = w != 0.0f;
        const float wk[2] = {w, w * (sp2 * (u * u + v * v))};
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int j = 0; j < 4; ++j) sums[4 * t + j] = wk[t] * xh[j] * xh[j];
      }
    }
    if (kSums && kGlobal)
      povar::warp_scatter<kJpRows, true, double>(acc_g, n_cams, c, live, sums);
    else if (kSums)
      povar::warp_scatter<kJpRows, !kPrivate>(wacc, n_cams, c, live, sums);
  }
  if (!kSums) return;
  if (!kGlobal) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
      float s = acc[i];
      if (kPrivate) {
        for (int w = 1; w < kWarps; ++w) s += acc[w * n_acc + i];
      }
      if (s != 0.0f) atomicAdd(acc_g + i, (double)s);
    }
  }
  if (!povar::last_block(reinterpret_cast<unsigned*>(acc_g + n_acc)))
    return;
  // jpsq row 4a + j: sum row j for a = 0, 1 and row 4 + j for a = 2
  for (int i = threadIdx.x; i < 12 * n_cams; i += blockDim.x) {
    const int row = i / n_cams;
    const int src = (row < 8 ? row & 3 : row - 4) * n_cams + i - row * n_cams;
    jpsq[i] = (float)__ldcg(acc_g + src);
  }
}

// ------------------------------------------------------------------ K2
// E0 factor h[c*3+a] = w sum_i jls_i L[i][c] g[i][a], with
//   g[i][0] = P0i - sp2 u P2i,  g[i][1] = P1i - sp2 v P2i,
//   g[i][2] = sp2 ((u^2 + v^2) P2i - u P0i - v P1i),  sp2 = 1 - alpha
// Replaces pallas_pose.py:385 e0_factor. Bound: 100 B of device memory
// per observation (64 read, 36 written); no atomics. The camera table
// is read in place (L1 / L2), at any N.
__global__ void __launch_bounds__(kThreads)
    e0_factor_kernel(const int32_t* __restrict__ cam, const float* __restrict__ ct,
                     const float* __restrict__ uv, const float* __restrict__ w_in,
                     const float* __restrict__ jls, const float* __restrict__ lh,
                     float* __restrict__ h, int n_obs, int n_cams, float sp2) {
  const float* tbl = ct;
  const long O = n_obs;
  POVAR_OBS_LOOP(o, O) {
    const int c = cam[o];
    const float u = uv[o], v = uv[O + o];
    const float w = w_in[o];
    float g[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float p0 = tbl[i * n_cams + c];
      const float p1 = tbl[(4 + i) * n_cams + c];
      const float p2 = tbl[(8 + i) * n_cams + c];
      g[i][0] = p0 - sp2 * u * p2;
      g[i][1] = p1 - sp2 * v * p2;
      g[i][2] = sp2 * ((u * u + v * v) * p2 - u * p0 - v * p1);
    }
    const float j0 = jls[o], j1 = jls[O + o], j2 = jls[2 * O + o];
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) {
      const float l0 = lh[cc * O + o];
      const float l1 = lh[(3 + cc) * O + o];
      const float l2 = lh[(6 + cc) * O + o];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float acc = j0 * l0 * g[0][a];
        acc += j1 * l1 * g[1][a];
        acc += j2 * l2 * g[2][a];
        h[(cc * 3 + a) * O + o] = w * acc;
      }
    }
  }
}

// ------------------------------------------------------------------ K3
// Per-camera raw Hpp [144, N] (rows (4a+i)*12 + 4b+j) = sum w K (x)
// xh xh^T and b [12, N] = sum rho (x) xh of the VarProj-corrected
// residual r~ = r_w - sw A~[:, :3] (jls . hib), in moment form
// (pose_common.cuh): K = [[1, 0, -sp2 u], [0, 1, -sp2 v], [-sp2 u,
// -sp2 v, sp2 (u^2 + v^2)]] has the positions and signs of step 2's K3,
// with weights w (1, sp2 u, sp2 v, sp2 (u^2 + v^2)). A live row (sw != 0)
// adds 52 values per camera, its b and the 40 moments of xh = [x, 1],
// through warp_scatter (the lanes of a warp on one camera sum first).
// The blocks' sums meet in f64: `acc_g` [52 N + 1] doubles, zeroed by the
// caller (b, the moments, a ticket), takes native global f64 atomics, and
// the last block to take a ticket writes b and every entry of hpp from it
// in f32 (povar::expand_moments). In f32 the cross-block sum of ~500
// partials per entry was the largest error and moved the POWER_SCHUR_
// COMPLEMENT step-1 trajectory (PERF.md). The camera table is read
// through the read-only path (__ldg; 4.3 KB at N = 89, it stays in L1).
// kShared: the accumulators (52 N floats, up to N = 1117) in shared
// memory, flushed once per block; otherwise every value goes straight to
// a global f64 atomic.
// Replaces pallas_pose.py:489 hpp_b_structured (_hpp_b_kernel :431).
// Bound: the 52 shared float atomics per live row and the arithmetic
// beside them: 76 us at venice-89 (124 per-row atomics: 222), 36 with the
// adds made dead stores, 11.3 for the 68 B a row reads (70 with the
// cross-block sums in f32, an earlier call); the table staged in shared
// memory instead 75.7. 123 us on the mesh's window order (one camera per warp: a 31-step
// walk), 320 at N = 1024, where the global route takes 477 (the table in
// shared memory leaves no room for the accumulators), and 578 at N = 2048
// on the global route (tools/pose1_ab.py and PERF.md; NVIDIA H100 80GB
// HBM3, 700 W).
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    hpp_b_kernel(const int32_t* __restrict__ cam, const float* __restrict__ ct,
                 const float* __restrict__ x, const float* __restrict__ uv,
                 const float* __restrict__ sw_in, const float* __restrict__ rw,
                 const float* __restrict__ jls, const float* __restrict__ hib,
                 const int* __restrict__ expand, float* __restrict__ hpp,
                 float* __restrict__ b, double* __restrict__ acc_g, int n_obs,
                 int n_cams, float sp, float sa, float sp2) {
  extern __shared__ float smem[];
  float* acc = smem;  // kShared: the block's accumulators
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
    const float sw = o < O ? sw_in[o] : 0.0f;
    const bool live = sw != 0.0f;
    if (!__any_sync(povar::kFullMask, live)) continue;
    float v[kMomentRows];
    int c = 0;
#pragma unroll
    for (int k = 0; k < kMomentRows; ++k) v[k] = 0.0f;
    if (live) {
      c = cam[o];
      const float u = uv[o], vv = uv[O + o];
      const float xh[4] = {x[o], x[O + o], x[2 * O + o], 1.0f};
      float P[12], A[4][4];
#pragma unroll
      for (int k = 0; k < 12; ++k) P[k] = __ldg(ct + k * n_cams + c);
      povar::a_tilde(P, 1, 0, u, vv, sp, sa, A);
      const float d0 = jls[o], d1 = jls[O + o], d2 = jls[2 * O + o];
      const float h0 = hib[o], h1 = hib[O + o], h2 = hib[2 * O + o];
      float rt[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float corr = A[k][0] * d0 * h0;
        corr += A[k][1] * d1 * h1;
        corr += A[k][2] * d2 * h2;
        rt[k] = rw[k * O + o] - sw * corr;
      }
      const float rho[3] = {
          sw * (sp * rt[0] + sa * rt[2]),
          sw * (sp * rt[1] + sa * rt[3]),
          sw * (-sp * (u * rt[0] + vv * rt[1])),
      };
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[4 * a + j] = rho[a] * xh[j];
      const float w = sw * sw;
      const float kw[4] = {w, w * (sp2 * u), w * (sp2 * vv),
                           w * (sp2 * (u * u + vv * vv))};
      povar::moments(kw, xh, v);
    }
    if (kShared)
      povar::warp_scatter<kMomentRows>(acc, n_cams, c, live, v);
    else
      povar::warp_scatter<kMomentRows>(acc_g, n_cams, c, live, v);
  }
  if (kShared) {
    __syncthreads();
    povar::flush_acc(acc_g, acc, kMomentRows * n_cams);
  }
  povar::expand_moments(expand, hpp, b, acc_g, n_cams,
                        kShared ? n_cams : povar::kExpandChunk, smem);
}

// ------------------------------------------------------------------ K4
// u[c] = sum_a h[c*3+a] y[a],  y[a] = sum_j xh_j z[4a+j][cam]
// Replaces pallas_pose.py:568 e0_u_structured. Bound: 64 B of device
// memory per observation (52 read, 12 written); no atomics. The z table
// is read in place.
__global__ void __launch_bounds__(kThreads)
    e0_u_kernel(const int32_t* __restrict__ cam, const float* __restrict__ x,
                const float* __restrict__ h, const float* __restrict__ zt,
                float* __restrict__ u_out, int n_obs, int n_cams) {
  const float* tbl = zt;
  const long O = n_obs;
  POVAR_OBS_LOOP(o, O) {
    const int c = cam[o];
    const float xh[4] = {x[o], x[O + o], x[2 * O + o], 1.0f};
    float z[12], y[3];
#pragma unroll
    for (int k = 0; k < 12; ++k) z[k] = tbl[k * n_cams + c];
    povar::xh_contract(z, xh, y);
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) {
      u_out[cc * O + o] = h[(cc * 3 + 0) * O + o] * y[0] +
                          h[(cc * 3 + 1) * O + o] * y[1] +
                          h[(cc * 3 + 2) * O + o] * y[2];
    }
  }
}

// ------------------------------------------------------------------ K5
// out[4a+j][cam] += t[a] xh_j,  t[a] = sum_c h[c*3+a] sb[c]  (xh_3 = 1),
// through pose_common.cuh's scatter_pass (the lanes of a warp on one
// camera sum first, into per-warp private copies; f64 block sums, one
// last block). A row whose t is exactly zero (h == 0 on dead and pad
// rows) adds nothing; a NaN propagates.
// Replaces pallas_pose.py:623 e0_scatter_structured (_e0_scatter_kernel
// :599). Bound: 64 B read per observation (10.6 us at venice-89). The
// earlier version added a row's 12 values with per-lane shared f32
// atomics (compare-and-swap loops; the lanes of a warp on one camera
// retrying against each other) and flushed each block with 12 N f32
// global atomics into an out the caller zeroed: 32.4 us at venice-89,
// 136 on the mesh's window order, 34 at N = 1024. Here 18.6-19.0 us (the
// loads and the row's arithmetic ~11.6, the walk and adds ~1, the tail
// ~6: the f64 flush ~4, the last block ~2.4), 17.9 on the window order
// (the lane-order walk alone 25.9), 45.7-46.1 at N = 1024 on 4 shared
// copies a 1024-thread block (the f64 flush of 132 blocks x 12,288 sums
// ~13) (tools/pose1_ab.py and PERF.md; NVIDIA H100 80GB HBM3, 700 W).
struct ScatterRow1 {
  float x[3], h[9], s[3];
  int c;
  bool in;
};

template <Route R>
__global__ void __launch_bounds__(povar::scatter_threads(R))
    e0_scatter_kernel(const int32_t* __restrict__ cam,
                      const float* __restrict__ x, const float* __restrict__ h,
                      const float* __restrict__ sb, float* __restrict__ out,
                      double* __restrict__ acc_g, int n_obs, int n_cams,
                      int copies) {
  extern __shared__ float smem[];
  const long O = n_obs;
  auto load = [&](long o) {
    ScatterRow1 r;
    r.in = o < O;
#pragma unroll
    for (int k = 0; k < 9; ++k) r.h[k] = r.in ? h[k * O + o] : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r.s[k] = r.in ? sb[k * O + o] : 0.0f;
      r.x[k] = r.in ? x[k * O + o] : 0.0f;
    }
    r.c = r.in ? cam[o] : 0;
    return r;
  };
  auto form = [](const ScatterRow1& r, float (&v)[povar::kScatterValues]) {
    float t[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float acc_t = r.h[a] * r.s[0];
      acc_t += r.h[3 + a] * r.s[1];
      acc_t += r.h[6 + a] * r.s[2];
      t[a] = acc_t;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int j = 0; j < 3; ++j) v[4 * a + j] = t[a] * r.x[j];
      v[4 * a + 3] = t[a];
    }
    return r.in && !(t[0] == 0.0f && t[1] == 0.0f && t[2] == 0.0f);
  };
  povar::scatter_pass<R, ScatterRow1>(load, form, out, acc_g, n_obs, n_cams,
                                      copies, smem);
}

// ------------------------------------------------------------------ K8
// The fused power-series term over every narrow slot part in one launch:
//   pass A  y = xh . z[:, cam], u[c] = sum_a h[c*3+a] y[a],
//           sb = sum_j u over the w rows of the landmark
//   pass B  tt[a] = sum_c h[c*3+a] sb[c],  out[4a+i][cam] += tt[a] xh_i
//           (xh_3 = 1)
// i.e. e0_u, the per-landmark slot sum, its re-expansion and e0_scatter
// in one pass. One thread per slot row in tiles of kE0Threads / w
// landmarks x all w rows (pose_common.cuh tile_row), persistent blocks
// walking the (part, tile) table. Pass A puts the row's u in shared
// memory; after one barrier each thread sums its landmark's u over
// j = 0 .. w-1 in that order (the plain version's) and runs pass B on its
// row's x and h, kept in registers across the barrier: each row is read
// from device memory once. kPrivate (16 x 12 N floats fit: N up to 277):
// each warp owns a [12, N] accumulator and its lanes on one camera sum
// first (warp_scatter), so the adds need no atomics; the copies are
// summed at the flush. Otherwise one shared accumulator with atomics. A
// row whose tt is exactly zero adds nothing (dead and pad rows have
// h = 0); a NaN still propagates. Where the z table and one accumulator
// do not fit a block (N past ~2,357), the table is read in place
// (stage_table) beside one shared accumulator, and past N ~ 4,800 every
// value goes to a global f32 atomic into `out` (pose_common.cuh
// launch_tiles).
// Replaces pallas_pose.py:748 e0_term_parts (_e0_term_kernel :673).
// Bound: 52 B read per slot row (cam 4, x 12, h 36), 8.6 us at venice-89.
// One thread per landmark with 12 shared atomics per row takes 31.3 us
// there, 14.0 with the atomics made dead stores. This kernel takes 19.8
// us, 19.4 with its adds made dead stores (the tile walk binds it), 24.5
// on one shared-atomic accumulator; 512 threads per block against 21.8
// at 256 and 23.6 at 1024; 28.8 with each part's landmarks sorted by
// first camera, 42.3 at N = 1024 (tools/pose1_ab.py and PERF.md; NVIDIA
// H100 80GB HBM3, 700 W).
template <bool kStaged, Route R>
__global__ void __launch_bounds__(kE0Threads)
    e0_term_kernel(const int32_t* __restrict__ cam, const float* __restrict__ x,
                   const float* __restrict__ h, const float* __restrict__ zt,
                   const int32_t* __restrict__ table, float* __restrict__ out,
                   int n_parts, int n_tiles, int n_obs, int n_cams) {
  constexpr bool kPrivate = R == Route::kPrivate;
  extern __shared__ float smem[];
  float* su = smem + (kStaged ? 12 * n_cams : 0);  // u [3, kE0Threads]
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
    const int o = row.o;
    int c = 0;
    float xh[4] = {0.0f, 0.0f, 0.0f, 1.0f};
    float hv[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float u[3] = {0.0f, 0.0f, 0.0f};
    if (row.in) {
      c = cam[o];
#pragma unroll
      for (int k = 0; k < 3; ++k) xh[k] = x[k * O + o];
#pragma unroll
      for (int k = 0; k < 9; ++k) hv[k] = h[k * O + o];
      float z[12], y[3];
#pragma unroll
      for (int k = 0; k < 12; ++k) z[k] = tbl[k * n_cams + c];
      povar::xh_contract(z, xh, y);
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
        u[cc] = hv[cc * 3] * y[0] + hv[cc * 3 + 1] * y[1] + hv[cc * 3 + 2] * y[2];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) su[i * kE0Threads + th] = u[i];
    __syncthreads();
    float sb[3] = {0.0f, 0.0f, 0.0f};
    if (row.in) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float a = su[i * kE0Threads + row.l];
        for (int jj = 1; jj < row.w; ++jj)
          a += su[i * kE0Threads + jj * row.t + row.l];
        sb[i] = a;
      }
    }
    __syncthreads();  // the next tile rewrites su
    float tt[3], v[12];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float acc_t = hv[a] * sb[0];
      acc_t += hv[3 + a] * sb[1];
      acc_t += hv[6 + a] * sb[2];
      tt[a] = acc_t;
    }
    const bool live =
        row.in && !(tt[0] == 0.0f && tt[1] == 0.0f && tt[2] == 0.0f);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) v[4 * a + i] = tt[a] * xh[i];
    povar::warp_scatter<12, !kPrivate>(wacc, n_cams, c, live, v);
  }
  if (R == Route::kGlobal) return;
  __syncthreads();
  povar::flush_tiles<kPrivate>(out, acc, n_acc);
}

// ------------------------------------------------------------------ K9
// Per-camera Schur-Jacobi corrections [144, N], rows ((a*4+i)*3+b)*4+j:
//   sum hth[a][b] xh_i xh_j,  hth = h^T h (3x3, symmetric), xh = [x, 1]
// in moment form (pose_common.cuh, schur_pass): a live row adds the 60
// values hth_s (xh_i xh_j), a <= b and i <= j, per camera; the blocks'
// sums meet in f64 and the last block writes every row, a row and its
// mirror from one sum. Dead rows (hth == 0, which h == 0 gives) add
// nothing.
// Replaces pallas_pose.py:1020 schur_diag_structured (_schur_diag_kernel
// :987). Bound: 52 B read per observation (8.7 us at venice-89). The
// earlier version added all 144 terms of a live row with per-lane f32
// atomics (compare-and-swap loops on this card; the lanes of a warp on
// one camera retrying against each other), into 144 N shared
// accumulators flushed with 144 N f32 global atomics a block, and past
// N ~ 400 straight to global memory: 214 us at venice-89, 1010-1040 on
// the mesh's window order and at N = 1024. Here 57.3 us at venice-89:
// the row loop ~43 (the loads and H ~7, the 60 products ~16, the walk
// ~12, the adds ~7), the copies' f64 flush ~9 and the last block ~5 (10
// private copies; 8: 66.8, one shared copy a 512-thread block: 98.5).
// 60.9 on the window order (the reduce-scatter tree; the lane-order walk
// 99), 559-573 at N = 1024 (global f64 atomics; 54 with the adds made
// dead stores) (tools/pose1_ab.py and PERF.md; NVIDIA H100 80GB HBM3,
// 700 W).
struct SchurRow1 {
  float h[9], x[3];
  int c;
  bool in;
};

template <Route R>
__global__ void __launch_bounds__(povar::schur_threads(R))
    schur_diag_kernel(const int32_t* __restrict__ cam,
                      const float* __restrict__ x, const float* __restrict__ h,
                      const int* __restrict__ expand, float* __restrict__ out,
                      double* __restrict__ acc_g, int n_obs, int n_cams,
                      int copies) {
  extern __shared__ float smem[];
  const long O = n_obs;
  auto load = [&](long o) {
    SchurRow1 r;
    r.in = o < O;
#pragma unroll
    for (int k = 0; k < 9; ++k) r.h[k] = r.in ? h[k * O + o] : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) r.x[k] = r.in ? x[k * O + o] : 0.0f;
    r.c = r.in ? cam[o] : 0;
    return r;
  };
  auto form = [](const SchurRow1& r, float H[6], float xh[4]) {
    bool zero = true;
    int s = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = a; b < 3; ++b, ++s) {
        float t = r.h[a] * r.h[b];
        t += r.h[3 + a] * r.h[3 + b];
        t += r.h[6 + a] * r.h[6 + b];
        H[s] = t;
        zero = zero && t == 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) xh[k] = r.x[k];
    xh[3] = 1.0f;
    return r.in && !zero;
  };
  povar::schur_pass<R, SchurRow1>(load, form, expand, out, acc_g, n_obs,
                                  n_cams, copies, smem);
}

// ------------------------------------------------------------------ K6
// Per-block partials of -l_diff = sum j_inc . (0.5 j_inc + r_w), with
//   j_inc = Jp(new) inc[cam] + sw A~_old[:, :3] (jls . inc_lm)
// and Jp q = [sp (q~0 - u q~2), sp (q~1 - v q~2), sa q~0, sa q~1],
// q~a = sum_j q[4a+j] xh_j; dead rows (sw == 0) contribute zero.
// Replaces pallas_pose.py:846 apply_ldiff. Bound: 68 B read per
// observation; its two camera tables are read in place.
__global__ void __launch_bounds__(kThreads)
    ldiff_kernel(const int32_t* __restrict__ cam, const float* __restrict__ x,
                 const float* __restrict__ uv, const float* __restrict__ sw_in,
                 const float* __restrict__ rw, const float* __restrict__ jls,
                 const float* __restrict__ ilm, const float* __restrict__ ct_old,
                 const float* __restrict__ inc_t, float* __restrict__ partials,
                 int n_obs, int n_cams, float sp, float sa) {
  __shared__ float red[32];
  const float* tbl_old = ct_old;
  const float* tbl_inc = inc_t;
  const long O = n_obs;
  float total = 0.0f;
  POVAR_OBS_LOOP(o, O) {
    const float sw = sw_in[o];
    if (!(sw > 0.0f)) continue;
    const int c = cam[o];
    const float u = uv[o], v = uv[O + o];
    const float xh[4] = {x[o], x[O + o], x[2 * O + o], 1.0f};
    float q[12], qt[3];
#pragma unroll
    for (int k = 0; k < 12; ++k) q[k] = tbl_inc[k * n_cams + c];
    povar::xh_contract(q, xh, qt);
    const float jp_inc[4] = {sp * (qt[0] - u * qt[2]), sp * (qt[1] - v * qt[2]),
                             sa * qt[0], sa * qt[1]};
    float A[4][4];
    povar::a_tilde(tbl_old, n_cams, c, u, v, sp, sa, A);
    const float d0 = jls[o], d1 = jls[O + o], d2 = jls[2 * O + o];
    const float i0 = ilm[o], i1 = ilm[O + o], i2 = ilm[2 * O + o];
    float ld = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float jl_inc =
          (A[k][0] * d0 * i0 + A[k][1] * d1 * i1 + A[k][2] * d2 * i2) * sw;
      const float j_inc = jp_inc[k] + jl_inc;
      ld += j_inc * (0.5f * j_inc + rw[k * O + o]);
    }
    total += ld;
  }
  total = povar::block_sum(total, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// Jp_s inc of the STORED scaled Jacobians for K10 and K11: q = (ps . inc)
// of the observation's camera, qt[a] = sum_j q[4a+j] xh_j,
//   jp = sw [sp (qt0 - u qt2), sp (qt1 - v qt2), sa qt0, sa qt1]
__device__ __forceinline__ void jp_inc_stored(const float* tbl_z, int n_cams,
                                              int c, const float xh[4],
                                              float u, float v, float sw,
                                              float sp, float sa,
                                              float jp[4]) {
  float q[12], qt[3];
#pragma unroll
  for (int k = 0; k < 12; ++k) q[k] = tbl_z[k * n_cams + c];
  povar::xh_contract(q, xh, qt);
  jp[0] = sw * sp * (qt[0] - u * qt[2]);
  jp[1] = sw * sp * (qt[1] - v * qt[2]);
  jp[2] = sw * sa * qt[0];
  jp[3] = sw * sa * qt[1];
}

// ------------------------------------------------------------------ K10
// Right-hand side of the POWER_SCHUR_COMPLEMENT landmark system per
// observation, t3[i] = (sum_k A~[k][i] (r_w[k] + jp[k])) sw jls_i with
// jp = Jp_s inc from the z table (ps . inc). Every row is written, dead
// ones (sw == 0) as the zero their operands give, as the Pallas kernel
// does. Replaces pallas_pose.py:938 poba_t3 (_poba_t3_kernel :905).
// Bound: 68 B of device memory per observation (56 read, 12 written);
// the camera table and the z table are read in place; no atomics.
__global__ void __launch_bounds__(kThreads)
    poba_t3_kernel(const int32_t* __restrict__ cam, const float* __restrict__ ct,
                   const float* __restrict__ x, const float* __restrict__ uv,
                   const float* __restrict__ sw_in, const float* __restrict__ rw,
                   const float* __restrict__ jls, const float* __restrict__ zt,
                   float* __restrict__ t3, int n_obs, int n_cams, float sp,
                   float sa) {
  const float* tbl = ct;
  const float* tbl_z = zt;
  const long O = n_obs;
  POVAR_OBS_LOOP(o, O) {
    const float sw = sw_in[o];
    const int c = cam[o];
    const float u = uv[o], v = uv[O + o];
    const float xh[4] = {x[o], x[O + o], x[2 * O + o], 1.0f};
    float jp[4], A[4][4], rt[4];
    jp_inc_stored(tbl_z, n_cams, c, xh, u, v, sw, sp, sa, jp);
    povar::a_tilde(tbl, n_cams, c, u, v, sp, sa, A);
#pragma unroll
    for (int k = 0; k < 4; ++k) rt[k] = rw[k * O + o] + jp[k];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float acc = A[0][i] * rt[0];
      acc += A[1][i] * rt[1];
      acc += A[2][i] * rt[2];
      acc += A[3][i] * rt[3];
      t3[i * O + o] = acc * sw * jls[i * O + o];
    }
  }
}

// ------------------------------------------------------------------ K11
// Per-block partials of -l_diff of the POWER_SCHUR_COMPLEMENT apply,
// sum j_inc . (0.5 j_inc + r_w) with
//   j_inc = Jp_s inc + sw A~_old[:, :3] (jls . inc_lm_scaled)
// from the stored scaled Jacobians. No live mask (unlike K6): a dead
// row's zero sw zeroes its Jacobians, as in the Pallas kernel.
// Replaces pallas_pose.py:1096 apply_ldiff_stored (_ldiff_stored_kernel
// :1055). Bound: 68 B read per observation; the camera and z tables
// are read in place.
__global__ void __launch_bounds__(kThreads)
    ldiff_stored_kernel(const int32_t* __restrict__ cam,
                        const float* __restrict__ x, const float* __restrict__ uv,
                        const float* __restrict__ sw_in,
                        const float* __restrict__ rw, const float* __restrict__ jls,
                        const float* __restrict__ ilm,
                        const float* __restrict__ ct_old,
                        const float* __restrict__ zt, float* __restrict__ partials,
                        int n_obs, int n_cams, float sp, float sa) {
  __shared__ float red[32];
  const float* tbl_old = ct_old;
  const float* tbl_z = zt;
  const long O = n_obs;
  float total = 0.0f;
  POVAR_OBS_LOOP(o, O) {
    const float sw = sw_in[o];
    const int c = cam[o];
    const float u = uv[o], v = uv[O + o];
    const float xh[4] = {x[o], x[O + o], x[2 * O + o], 1.0f};
    float jp[4], A[4][4];
    jp_inc_stored(tbl_z, n_cams, c, xh, u, v, sw, sp, sa, jp);
    povar::a_tilde(tbl_old, n_cams, c, u, v, sp, sa, A);
    const float d0 = jls[o], d1 = jls[O + o], d2 = jls[2 * O + o];
    const float i0 = ilm[o], i1 = ilm[O + o], i2 = ilm[2 * O + o];
    float ld = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float jl_inc =
          (A[k][0] * d0 * i0 + A[k][1] * d1 * i1 + A[k][2] * d2 * i2) * sw;
      const float j_inc = jp[k] + jl_inc;
      ld += j_inc * (0.5f * j_inc + rw[k * O + o]);
    }
    total += ld;
  }
  total = povar::block_sum(total, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// ------------------------------------------------------------------ K7
// pOSE cost in native f64: per-block partials of sum rho(|r|^2) (robust
// 0 NONE: 0.5 r^2, 1 HUBER: 0.5 (2 - w) w r^2, 2 CAUCHY: log1p(r^2)),
// sum |r| and the count of live rows with a non-finite residual,
// written to partials[0 * n_part + block], [1 * n_part + block] and
// [2 * n_part + block].
// Replaces pallas_pose.py:1319 pose_error_df32 (double-float on the
// TPU). Bound: 48 B read per observation and f64 arithmetic (~40 flops
// per row, far below the card's f64 rate). The f64 camera table is read
// in place.
__global__ void __launch_bounds__(kThreads)
    pose_error_kernel(const int32_t* __restrict__ cam, const double* __restrict__ ct,
                      const double* __restrict__ x, const double* __restrict__ uv,
                      const float* __restrict__ mask, double* __restrict__ partials,
                      int n_part, int n_obs, int n_cams, double sp, double sa,
                      int robust, double huber) {
  __shared__ double red[32];
  const double* tbl = ct;
  const long O = n_obs;
  double err = 0.0, rn = 0.0, bad = 0.0;
  POVAR_OBS_LOOP(o, O) {
    if (!(mask[o] > 0.0f)) continue;
    const int c = cam[o];
    const double u = uv[o], v = uv[O + o];
    const double xh[4] = {x[o], x[O + o], x[2 * O + o], 1.0};
    double A[4][4], r[4];
    povar::a_tilde(tbl, n_cams, c, u, v, sp, sa, A);
    povar::residual(A, xh, u, v, sa, r);
    const bool finite = isfinite(r[0]) && isfinite(r[1]) && isfinite(r[2]) &&
                        isfinite(r[3]);
    const double res_sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2] + r[3] * r[3];
    double e;
    if (robust == 1) {
      const double w = res_sq < huber * huber ? 1.0 : huber / sqrt(res_sq);
      e = 0.5 * (2.0 - w) * w * res_sq;
    } else if (robust == 2) {
      e = log1p(res_sq);
    } else {
      e = 0.5 * res_sq;
    }
    err += e;
    rn += sqrt(res_sq);
    bad += finite ? 0.0 : 1.0;
  }
  err = povar::block_sum(err, red);
  rn = povar::block_sum(rn, red);
  bad = povar::block_sum(bad, red);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = err;
    partials[n_part + blockIdx.x] = rn;
    partials[2 * n_part + blockIdx.x] = bad;
  }
}

}  // namespace

extern "C" {

const char* povar_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// sums = 0: rw, sw, jpsq and acc are not touched (may be null); acc
// holds 8 * n_cams + 1 doubles, zeroed
int povar_prepare(const int32_t* cam, const float* ct, const float* x,
                  const float* uv, const float* mask, float* rw, float* sw,
                  float* ata, float* atr, float* jpsq, double* acc,
                  int n_obs, int n_cams, float sp, float sa, float sp2,
                  int huber_on, float huber, float huber2, int sums,
                  void* stream) {
  const size_t block = sizeof(float) * kJpRows * (size_t)n_cams;
  const size_t room = (size_t)max_optin_smem();
  if (!sums) {
    return launch<kPrepThreads>(
        prepare_kernel<false, Route::kPrivate, kPrepThreads>, n_obs, 0,
        stream, cam, ct, x, uv, mask, rw, sw, ata, atr, jpsq, acc, n_obs,
        n_cams, sp, sa, sp2, huber_on, huber, huber2);
  }
  if (kPrepThreads / 32 * block <= room) {
    return launch<kPrepThreads>(
        prepare_kernel<true, Route::kPrivate, kPrepThreads>, n_obs,
        kPrepThreads / 32 * block, stream, cam, ct, x, uv, mask, rw, sw, ata,
        atr, jpsq, acc, n_obs, n_cams, sp, sa, sp2, huber_on, huber, huber2);
  }
  if (block <= room) {
    return launch<kPrepSharedThreads>(
        prepare_kernel<true, Route::kShared, kPrepSharedThreads>, n_obs,
        block, stream, cam, ct, x, uv, mask, rw, sw, ata, atr, jpsq, acc,
        n_obs, n_cams, sp, sa, sp2, huber_on, huber, huber2);
  }
  return launch<kPrepSharedThreads>(
      prepare_kernel<true, Route::kGlobal, kPrepSharedThreads>, n_obs, 0,
      stream, cam, ct, x, uv, mask, rw, sw, ata, atr, jpsq, acc, n_obs, n_cams,
      sp, sa, sp2, huber_on, huber, huber2);
}

int povar_e0_factor(const int32_t* cam, const float* ct, const float* uv,
                    const float* w, const float* jls, const float* lh,
                    float* h, int n_obs, int n_cams, float sp2,
                    void* stream) {
  return launch(e0_factor_kernel, n_obs, 0, stream, cam, ct, uv, w, jls, lh,
                h, n_obs, n_cams, sp2);
}

int povar_hpp_b(const int32_t* cam, const float* ct, const float* x,
                const float* uv, const float* sw, const float* rw,
                const float* jls, const float* hib, const int* expand,
                float* hpp, float* b, double* acc, int n_obs, int n_cams,
                float sp, float sa, float sp2, void* stream) {
  const size_t moments = sizeof(float) * kMomentRows * (size_t)n_cams;
  if (moments <= (size_t)max_optin_smem()) {
    return launch(hpp_b_kernel<true>, n_obs, moments, stream, cam, ct, x, uv,
                  sw, rw, jls, hib, expand, hpp, b, acc, n_obs, n_cams, sp,
                  sa, sp2);
  }
  return launch(hpp_b_kernel<false>, n_obs,
                sizeof(float) * povar::kMoments * povar::kExpandChunk, stream,
                cam, ct, x, uv, sw, rw, jls, hib, expand, hpp, b, acc, n_obs,
                n_cams, sp, sa, sp2);
}

int povar_e0_u(const int32_t* cam, const float* x, const float* h,
               const float* zt, float* u, int n_obs, int n_cams,
               void* stream) {
  return launch(e0_u_kernel, n_obs, 0, stream, cam, x, h, zt, u, n_obs,
                n_cams);
}

// out: [12, n_cams]; acc: 12 n_cams + 1 doubles, zero (every call
// leaves them zero)
int povar_e0_scatter(const int32_t* cam, const float* x, const float* h,
                     const float* sb, float* out, double* acc, int n_obs,
                     int n_cams, void* stream) {
  return povar::launch_scatter(
      e0_scatter_kernel<Route::kPrivate>, e0_scatter_kernel<Route::kShared>,
      e0_scatter_kernel<Route::kGlobal>, n_obs, n_cams, stream, cam, x, h, sb,
      out, acc, n_obs, n_cams);
}

int povar_e0_term(const int32_t* cam, const float* x, const float* h,
                  const float* zt, const int32_t* table, float* out,
                  int n_parts, int n_tiles, int n_obs, int n_cams,
                  int tile_threads, void* stream) {
  // the table's tiles were cut for blocks of tile_threads threads; out is
  // zeroed by the caller
  const size_t base = sizeof(float) * 3 * kE0Threads +
                      sizeof(int) * kTileFields * (size_t)n_parts;
  return povar::launch_tiles(
      e0_term_kernel<true, Route::kPrivate>,
      e0_term_kernel<true, Route::kShared>,
      e0_term_kernel<false, Route::kShared>,
      e0_term_kernel<false, Route::kGlobal>, n_parts, n_tiles, tile_threads,
      base, sizeof(float) * 12 * (size_t)n_cams, 12 * (size_t)n_cams, stream,
      cam, x, h, zt, table, out, n_parts, n_tiles, n_obs, n_cams);
}

// out: [144, n_cams]; acc: 60 n_cams + 1 doubles, zero (every call
// leaves them zero)
int povar_schur_diag(const int32_t* cam, const float* x, const float* h,
                     const int* expand, float* out, double* acc, int n_obs,
                     int n_cams, void* stream) {
  return povar::launch_schur(
      schur_diag_kernel<Route::kPrivate>, schur_diag_kernel<Route::kShared>,
      schur_diag_kernel<Route::kGlobal>, n_obs, n_cams, stream, cam, x, h,
      expand, out, acc, n_obs, n_cams);
}

int povar_apply_ldiff(const int32_t* cam, const float* x, const float* uv,
                      const float* sw, const float* rw, const float* jls,
                      const float* ilm, const float* ct_old,
                      const float* inc_t, float* partials, int n_obs,
                      int n_cams, float sp, float sa, void* stream) {
  return launch(ldiff_kernel, n_obs, 0, stream, cam, x, uv, sw, rw, jls, ilm,
                ct_old, inc_t, partials, n_obs, n_cams, sp, sa);
}

int povar_poba_t3(const int32_t* cam, const float* ct, const float* x,
                  const float* uv, const float* sw, const float* rw,
                  const float* jls, const float* zt, float* t3, int n_obs,
                  int n_cams, float sp, float sa, void* stream) {
  return launch(poba_t3_kernel, n_obs, 0, stream, cam, ct, x, uv, sw, rw, jls,
                zt, t3, n_obs, n_cams, sp, sa);
}

int povar_apply_ldiff_stored(const int32_t* cam, const float* x,
                             const float* uv, const float* sw, const float* rw,
                             const float* jls, const float* ilm,
                             const float* ct_old, const float* zt,
                             float* partials, int n_obs, int n_cams, float sp,
                             float sa, void* stream) {
  return launch(ldiff_stored_kernel, n_obs, 0, stream, cam, x, uv, sw, rw,
                jls, ilm, ct_old, zt, partials, n_obs, n_cams, sp, sa);
}

int povar_pose_error(const int32_t* cam, const double* ct, const double* x,
                     const double* uv, const float* mask, double* partials,
                     int n_part, int n_obs, int n_cams, double sp, double sa,
                     int robust, double huber, void* stream) {
  return launch(pose_error_kernel, n_obs, 0, stream, cam, ct, x, uv, mask,
                partials, n_part, n_obs, n_cams, sp, sa, robust, huber);
}

}  // extern "C"
