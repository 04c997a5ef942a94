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
// per-camera sum is a shared-memory add by index. C1 copies table
// entries, bit for bit; C3 sums its terms in the order of its plain
// version (ops/cam_ref.py), so with --fmad=false it matches it bit for
// bit. C2, C4 and C5 sum a warp's lanes per camera first, into per-warp
// or shared accumulators, and meet across blocks in global atomics
// (below). The per-camera sums differ from their plain versions by the
// order of the additions only.
//
// Every per-observation operand of C2, C4 and C5 must be zero on the
// slot pad rows: unlike the TPU's incidence (stage1.make_obs folds the
// pad mask into it), the camera index of a pad row is a real camera.
//
// Every kernel comes in two instantiations of its value type V: f32 (the
// mixed-precision solves) and f64 (the pure-f64 ones, `mixed_precision_
// solves=False`, where the JAX package runs these sums and gathers as f64
// XLA ops). The f64 one computes in doubles what the f32 one computes in
// floats: its operands, shared-memory copies, block sums and outputs are
// f64. Where an f32 design choice does not carry over to doubles
// (registers, shared memory) the f64 instantiation takes the simpler
// route, or, for C5's shared copies, a route of its own (value groups),
// as each kernel says.
//
// C interface as in pose1.cu: device pointers, sizes and the CUDA stream;
// one launch; the cudaError_t of the launch is returned. The f64 entry
// points are the f32 ones' names with `_f64` appended.

#include "pose_common.cuh"

using povar::add_rows;
using povar::block_sums_done;
using povar::drain_sums;
using povar::dyn_smem;
using povar::kThreads;
using povar::launch_sums;
using povar::Route;
using povar::SumsPlan;
using povar::sums_plan;
using povar::warp_copy;

namespace {

// ------------------------------------------------------------------ C1
// out[r][o] = table[r][cam[o]] for the rows [r0, r0 + rows) of row block
// blockIdx.y: the block stages those rows of the [R, N] table in shared
// memory once, then its threads take kVec neighbouring observations at a
// time (16 bytes of a row of out: 4 floats or 2 doubles; kVec = 1 where O
// or the pointers do not allow it) from the block's contiguous share of
// them, read their cameras in one load and write them in every row of
// the row block, one 16-byte store a row, four rows unrolled. The caller
// splits the rows into the fewest row blocks whose table rows fit 96 KB
// (ops/cam_kernels._rows_per_block: one at venice-89, step 2's R = 132
// tangent bases in f64 too), and the launch fills one whole wave of
// 1024-thread blocks (two an SM) over all row blocks, every block with a
// share of the same size, so a block stages its rows once and each row
// block reads cam once.
// Replaces pallas_cam.py:176 cam_gather (_gather_kernel :171).
// Bound: 4 B read and 4 R B written per observation (52 B at R = 12;
// 100 B in f64, 1060 B at R = 132); the table is read once per block.
// The earlier version (256-thread blocks of one 4- or 8-byte store a row
// and observation, at most 48 KB of table rows a block, a grid sized to
// the observations per row block) took, in events around 50 back-to-back
// calls, 25.5 us in f64 at R = 12, 214 at R = 132, 385 at R = 132 over
// N = 1024 (22 row blocks, each reading cam and staging its rows), 10.7
// in f32 at R = 12; here 23.6-23.9, 196, 230-231 and 9.6-10.9 (device
// time 21.6, 194, 227, 8.4; index_select 24.9, 212, 222, 20.4). At
// N = 1024, R = 12 in f64 it trails index_select, 28.0 against 26.7:
// every block stages the 96 KB table, 25 MB of L2 reads beside 53 MB
// written. Not kept: 512-thread blocks (33.5 against 28.0 there), 4-byte
// stores in f32 (14.1 against 10.9 at R = 12, 243 against 120 at
// R = 132, N = 1024), 8-byte stores in f64 (342 against 196 at R = 132),
// the table read through L1 past 64 or 16 KB (245 against 196 at
// R = 132 on venice-89; 27.0 at N = 1024, R = 12), 48 KB row blocks (262
// against 196 at R = 132) (tools/cam_ab.py and PERF.md; NVIDIA H100 80GB
// HBM3, 700 W).
constexpr int kGatherThreads = 1024;
// observations a thread takes, by value type
template <typename V>
constexpr int kGatherVec = sizeof(V) == sizeof(float) ? 4 : 2;

// kVec camera indices from cam[kVec i ...] in one load
template <int kVec>
__device__ __forceinline__ void load_cams(const int32_t* __restrict__ cam,
                                          int i, int (&c)[kVec]) {
  if constexpr (kVec == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(cam) + i);
    c[0] = q.x, c[1] = q.y, c[2] = q.z, c[3] = q.w;
  } else if constexpr (kVec == 2) {
    const int2 q = __ldg(reinterpret_cast<const int2*>(cam) + i);
    c[0] = q.x, c[1] = q.y;
  } else {
    c[0] = __ldg(cam + i);
  }
}

// row[c[0 .. kVec)] to dst[0 .. kVec), one store
template <int kVec, typename V>
__device__ __forceinline__ void store_row(V* dst, const V* row,
                                          const int (&c)[kVec]) {
  if constexpr (kVec == 1) {
    dst[0] = row[c[0]];
  } else if constexpr (sizeof(V) == sizeof(float)) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(row[c[0]], row[c[1]], row[c[2]], row[c[3]]);
  } else {
    *reinterpret_cast<double2*>(dst) = make_double2(row[c[0]], row[c[1]]);
  }
}

template <typename V, int kVec>
__global__ void __launch_bounds__(kGatherThreads)
    cam_gather_kernel(const int32_t* __restrict__ cam,
                      const V* __restrict__ table, V* __restrict__ out,
                      int n_obs, int n_cams, int n_rows, int rows_per_block) {
  V* smem = dyn_smem<V>();
  const int r0 = blockIdx.y * rows_per_block;
  const int rows = min(rows_per_block, n_rows - r0);
  povar::smem_copy(smem, table + (size_t)r0 * n_cams, rows * n_cams);
  __syncthreads();
  const size_t O = n_obs;
  V* rows0 = out + r0 * O;
  // the block's share of the observations, contiguous, all of one size
  const int n_vec = n_obs / kVec;
  const int share = (n_vec + gridDim.x - 1) / gridDim.x;
  const int end = min(n_vec, (blockIdx.x + 1) * share);
  for (int i = blockIdx.x * share + threadIdx.x; i < end; i += blockDim.x) {
    int c[kVec];
    load_cams<kVec>(cam, i, c);
    V* dst = rows0 + (size_t)i * kVec;
#pragma unroll 4
    for (int r = 0; r < rows; ++r)
      store_row<kVec>(dst + r * O, smem + r * n_cams, c);
  }
}

// ------------------------------------------------------------------ C3
// u[i][o] = sum_j W[i dc + j][o] x[j][cam[o]], j in order, with the
// [dc, N] table x staged in shared memory once per block (in f64 96 KB
// at dc = 12, N = 1024: past the 48 KB default, so the launch opts in).
// Bound: (4 + 4 dl dc + 4 dl) B per observation (twice the 4 in f64).
template <typename V>
__global__ void __launch_bounds__(kThreads)
    e0_u_kernel(const int32_t* __restrict__ cam, const V* __restrict__ w,
                const V* __restrict__ x, V* __restrict__ u, int n_obs,
                int n_cams, int dl, int dc) {
  V* xs = dyn_smem<V>();
  povar::smem_copy(xs, x, dc * n_cams);
  __syncthreads();
  const int O = n_obs;
  POVAR_OBS_LOOP(o, O) {
    const int c = cam[o];
    for (int i = 0; i < dl; ++i) {
      const V* wi = w + (size_t)i * dc * O + o;
      V acc = wi[0] * xs[c];
      for (int j = 1; j < dc; ++j) acc += wi[(size_t)j * O] * xs[j * n_cams + c];
      u[(size_t)i * O + o] = acc;
    }
  }
}

// -------------------------------------------- per-camera sums (C2, C4, C5)
// The routes, the block sums, the last block's drain and the launch plan
// are pose_common.cuh's.
//
// Block shapes: C4 in 512-thread blocks of private copies (16 x 12 N
// floats fit up to N = 302, doubles up to N = 151), else 1024-thread
// blocks on shared copies (up to N = 4842 / 2421), else the global route;
// C5 in blocks of at most 8 warps with private copies while 4 fit (90 N
// floats each at (k, d) = (4, 12): up to N = 161; 7 warps at N = 89; in
// f64 while 8 fit, up to N = 40), else 512-thread blocks on shared copies
// (up to N = 645; in f64 one copy and a tile of rows a block of six
// warps, each warp adding one group of the values, up to N = 303), else
// the global route.
constexpr int kE0sWarps = 16;
constexpr int kE0sSharedThreads = 1024;
constexpr int kHppWarps = 8;
constexpr int kHppSharedThreads = 512;
// f64 global route: a row's 52 operands take 104 registers, which
// 512-thread blocks (128 registers a thread) would spill
constexpr int kHppSharedThreads64 = 256;

__host__ __device__ constexpr int e0s_threads(Route r) {
  return r == Route::kPrivate ? 32 * kE0sWarps : kE0sSharedThreads;
}

template <typename V>
__host__ __device__ constexpr int hpp_threads(Route r) {
  return r == Route::kPrivate ? 32 * kHppWarps
         : sizeof(V) == sizeof(float) ? kHppSharedThreads
                                      : kHppSharedThreads64;
}

// one observation's Jp block [K][D], r~ [K] and camera (zeros and
// camera 0 past the last row)
template <typename V, int K, int D>
struct JpRow {
  V j[K][D], r[K];
  int c;
  bool live;
};

template <typename V, int K, int D>
__device__ __forceinline__ JpRow<V, K, D> load_row(const int32_t* cam,
                                                   const V* jp, const V* rt,
                                                   int o, int n_obs) {
  JpRow<V, K, D> x;
  x.live = o < n_obs;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x.r[k] = x.live ? __ldg(rt + (size_t)k * n_obs + o) : V(0);
#pragma unroll
    for (int a = 0; a < D; ++a)
      x.j[k][a] = x.live ? __ldg(jp + (size_t)(k * D + a) * n_obs + o) : V(0);
  }
  x.c = x.live ? cam[o] : 0;
  return x;
}

// ------------------------------------------------------------------ C4
// out[j][c] = sum over o with cam[o] = c of
// v_j = sum_i W[i dc + j][o] sb[i][o], i in order, through the block's
// accumulators (above); the blocks' sums meet in f64. dc = kDc (12 or 11:
// a row's dc values in one pass), or dc at run time for kDc = 0 (one
// value a pass); dl at run time.
// Replaces pallas_cam.py:278 e0_scatter (_e0_scatter_kernel :267).
// Bound: (4 + 4 dl dc + 4 dl) B per observation, 160 B at (3, 12): 26.6
// us at venice-89. The earlier version added every value of a row with a
// per-lane shared atomic, lanes of one warp on one camera retrying
// against each other, and flushed each block with 12 N contended f32
// global atomics: 82.4 us, 222 on camera-sorted rows, 104 at N = 1024.
// Here 39.8 us at (3, 12) and 37.1 at (3, 11) (the adds, the walk and
// the flush about 1 us each; the loads and the row's arithmetic the
// rest), 55 on camera-sorted rows, 59 at N = 1024 (4 shared copies);
// one shared copy per block 45, f32 cross-block sums 39.2, and the
// blocks' f32 partials added by the last block in block order
// (bit-reproducible) 75 (tools/cam_ab.py and PERF.md; NVIDIA H100 80GB
// HBM3, 700 W). The f64 instantiation is the same pass in doubles.
template <typename V, int kDc, Route R>
__global__ void __launch_bounds__(e0s_threads(R))
    e0_scatter_kernel(const int32_t* __restrict__ cam,
                      const V* __restrict__ w,
                      const V* __restrict__ sb, V* __restrict__ out,
                      double* __restrict__ acc_g, int n_obs, int n_cams,
                      int dl, int dc_run, int copies) {
  constexpr int kV = kDc > 0 ? kDc : 1;  // values a pass
  const int dc = kDc > 0 ? kDc : dc_run;
  V* smem = dyn_smem<V>();
  const int n_acc = dc * n_cams;
  V* acc = warp_copy<R>(smem, copies, n_acc);
  const int O = n_obs;
  const int lane = threadIdx.x & 31;
  // warp-uniform trips: every lane reaches the warp's scatter
  for (int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < O;
       base += gridDim.x * blockDim.x) {
    const int o = base + lane;
    const bool live = o < O;
    const int c = live ? cam[o] : 0;
    for (int j0 = 0; j0 < dc; j0 += kV) {
      V v[kV];
      if (live) {
        const V s0 = sb[o];
#pragma unroll
        for (int j = 0; j < kV; ++j) v[j] = w[(size_t)(j0 + j) * O + o] * s0;
        for (int i = 1; i < dl; ++i) {
          const V si = sb[(size_t)i * O + o];
#pragma unroll
          for (int j = 0; j < kV; ++j)
            v[j] += w[(size_t)(i * dc + j0 + j) * O + o] * si;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kV; ++j) v[j] = V(0);
      }
      add_rows<kV, R, double>(acc, acc_g, j0, n_cams, c,
                              povar::warp_peers(c, live), v);
    }
  }
  if (!block_sums_done<R, double, 32>(acc_g, smem, copies, n_acc, n_acc))
    return;
  drain_sums<double>(acc_g, n_acc,
                     [&](int i, double s) { out[i] = (V)s; });
}

// the largest divisor of n not above cap
__host__ __device__ constexpr int divisor_below(int n, int cap) {
  int d = cap;
  while (n % d != 0) --d;
  return d;
}

// v added to the global *p as a reduction: no value returned (an f64
// atomicAdd compiles to ATOMG, which does return one)
__device__ __forceinline__ void c2_red(double* p, double v) {
  const size_t g = __cvta_generic_to_global(p);
  asm volatile("red.global.add.f64 [%0], %1;" ::"l"(g), "d"(v) : "memory");
}

__device__ __forceinline__ void c2_red(float* p, float v) { atomicAdd(p, v); }

// ------------------------------------------------------------------ C5
// Per observation, the K x D block Jp (rows k D + a) and r~ [K]:
// b[a][c] = sum_k Jp[k][a] r~[k] and hpp[a D + bb][c] = sum_k Jp[k][a]
// Jp[k][bb], k in order, summed per camera. A row adds D + D (D + 1) / 2
// values (90 at (4, 12), 77 at (2, 11)): b, then the upper triangle row
// by row, in chunks of kChunk values through one match of the warp's
// cameras: the whole row on the private route (with the next row's 52
// operands loaded ahead; at most 8 warps an SM leave 255 registers a
// thread), 15 / 11 values elsewhere (a 512-thread block leaves 128); the
// last block writes each triangle entry to both of its places, so hpp is
// symmetric bit for bit, as the plain version's outer products are.
// A block's copies go to the blocks' f32 sums two by two (one atomic per
// pair of copies and entry). CHOLESKY's step 1 (the dense reduced camera
// system in f32, ill-conditioned at lambda 2e-4) goes to one of several
// final costs by that order alone. venice-89 solves end, as a multiple
// of the JAX run's cost: with copies in pairs at 0.594x-0.598x (0 of 16
// below chip_smoke.py's CHOL_BAND (0.59, 0.60)), as the earlier kernel
// (0.594x-0.597x); with f64 sums at 0.589x (16 of 16 below, in each of
// three calls), where the solve evaluated in f64 throughout ends as well
// (0.5885x, on the card and on the CPU); with f32 ones and a block's 7
// copies summed first 0.589x-0.592x (4 of 48 below); with each copy its
// own atomic 0.584x-0.590x (16 of 16). So the band holds the earlier
// kernel's f32 family, not the f64 one; pairs are kept for it, and are
// the fastest: 120 us against 123 summed first, 129 in f64
// (tools/cam_ab.py, tools/step2_spread.py --chol-f64 and PERF.md; NVIDIA
// H100 80GB HBM3, 700 W).
// Replaces pallas_cam.py:333 hpp_b (_hpp_b_kernel :311).
// Bound: (4 + 4 K D + 4 K) B per observation, 212 B at (4, 12), 100 at
// (2, 11), 8 (D D + D) B per camera: 35.3 / 16.6 us at venice-89. The
// earlier version added both triangles per row (156 / 132 values) with
// per-lane shared atomics: 263 / 213 us, 1607 / 1371 on camera-sorted
// rows, 1231 / 1061 at N = 1024. Here 120 / 86 us (the sums over a
// warp's peers ~18, the adds and the flush ~3 each: the row's 630
// products and the loads take the rest at 7 warps an SM), 352 / 253 on
// camera-sorted rows (a 31-step walk; a pairwise tree of the peers 153,
// not kept: another order of the sums, above), 881 / 774 at N = 1024
// (the global route's f32 atomics, 90 / 77 a live row, bind it). One
// shared copy per 512-thread block (shared atomics) took 184, the values
// in chunks of 15 (15 live, not 90) 160, without the next row's loads
// 135, 4 or 3 warps' private copies a block 163 / 153 (tools/cam_ab.py
// and PERF.md; NVIDIA H100 80GB HBM3, 700 W).
// The f64 instantiation holds a row in 104 registers, so it takes the
// chunks of 15 / 11 values on its private and global routes (256-thread
// blocks), loads no row ahead and sums all of a block's copies before one
// f64 atomic an entry, into f64 sums; in place of shared copies (whose
// f64 shared atomics are compare-and-swap loops) it takes value groups
// (hpp_b_groups_kernel, below).
template <typename V>
struct HppSums {  // the blocks' sums' type, and copies summed a flush
  using type = float;
  static constexpr int kGroup = 2;
};

template <>
struct HppSums<double> {
  using type = double;
  static constexpr int kGroup = 32;
};

// The last block's write of sum i (row i / N of the sums: b, then the
// upper triangle row by row) to b or to both places of its triangle entry
// in hpp, so hpp is symmetric bit for bit
template <typename V, int D, typename S>
struct HppWrite {
  V* hpp;
  V* b;
  int n_cams;
  __device__ __forceinline__ void operator()(int i, S s) const {
    const int row = i / n_cams, c = i - row * n_cams;
    const V x = (V)s;
    if (row < D) {
      b[row * n_cams + c] = x;
      return;
    }
    int a = 0, e = row - D;  // upper-triangle entry e is (a, a + e)
    while (e >= D - a) {
      e -= D - a;
      ++a;
    }
    hpp[(a * D + a + e) * n_cams + c] = x;
    hpp[((a + e) * D + a) * n_cams + c] = x;
  }
};

template <typename V, int K, int D, Route R>
__global__ void __launch_bounds__(hpp_threads<V>(R))
    hpp_b_kernel(const int32_t* __restrict__ cam, const V* __restrict__ jp,
                 const V* __restrict__ rt, V* __restrict__ hpp,
                 V* __restrict__ b, double* __restrict__ acc_g,
                 int n_obs, int n_cams, int copies) {
  using S = typename HppSums<V>::type;
  constexpr bool kF32 = sizeof(V) == sizeof(float);
  constexpr int kValues = D + D * (D + 1) / 2;
  constexpr int kChunk = R == Route::kPrivate && kF32
                             ? kValues
                             : divisor_below(kValues, 16);
  constexpr bool kPrefetch = R == Route::kPrivate && kF32;
  V* smem = dyn_smem<V>();
  const int n_acc = kValues * n_cams;
  V* acc = warp_copy<R>(smem, copies, n_acc);
  const int O = n_obs;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * blockDim.x;
  // warp-uniform trips: every lane reaches the warp's scatter
  int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31);
  JpRow<V, K, D> next;
  if (kPrefetch) next = load_row<V, K, D>(cam, jp, rt, base + lane, O);
  for (; base < O; base += stride) {
    JpRow<V, K, D> x;
    if (kPrefetch) {
      x = next;
      next = load_row<V, K, D>(cam, jp, rt, base + stride + lane, O);
    } else {
      x = load_row<V, K, D>(cam, jp, rt, base + lane, O);
    }
    const povar::WarpPeers peers = povar::warp_peers(x.c, x.live);
    // value t of the row goes to v[t % kChunk]; a full chunk is added
    V v[kChunk];
    int t = 0;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      V s = x.j[0][a] * x.r[0];
#pragma unroll
      for (int k = 1; k < K; ++k) s += x.j[k][a] * x.r[k];
      v[t % kChunk] = s;
      if (++t % kChunk == 0)
        add_rows<kChunk, R, S>(acc, acc_g, t - kChunk, n_cams, x.c, peers,
                               v);
    }
#pragma unroll
    for (int a = 0; a < D; ++a) {
#pragma unroll
      for (int bb = a; bb < D; ++bb) {
        V s = x.j[0][a] * x.j[0][bb];
#pragma unroll
        for (int k = 1; k < K; ++k) s += x.j[k][a] * x.j[k][bb];
        v[t % kChunk] = s;
        if (++t % kChunk == 0)
          add_rows<kChunk, R, S>(acc, acc_g, t - kChunk, n_cams, x.c,
                                 peers, v);
      }
    }
  }
  if (!block_sums_done<R, S, HppSums<V>::kGroup>(acc_g, smem, copies, n_acc,
                                                 n_acc))
    return;
  drain_sums<S>(acc_g, n_acc, HppWrite<V, D, S>{hpp, b, n_cams});
}

// ------------------------------------------------- C5 in f64: value groups
// The f64 instantiation's route where 8 private copies of the 90 N
// doubles do not fit a block but one copy and a tile of rows do (N = 41
// to 303 at (k, d) = (4, 12), 48 to 366 at (2, 11); venice-89 at both):
// one copy a block of kHppGroups = 6 warps, each warp adding one group of
// a row's values to it, so that no two warps add to one entry and every
// add is a plain one (no f64 shared atomic: a compare-and-swap loop on
// this card). The D columns are cut into three blocks (4, 4, 4 at
// D = 12; 4, 4, 3 at D = 11); for each block j one group holds its b and
// its diagonal tile of the upper triangle (14 values at D = 12), another
// its tile with block j + 1 mod 3 (16). The block takes tiles of 32 rows:
// its warps stage a tile's K D + K operand rows (13 KB at (4, 12)) and
// cameras in shared memory, each warp loading a sixth of them, each
// value once from device memory, and load the next tile's into registers
// while they sum this one; each warp reads its group's columns from the
// tile. Warp 0 matches the tile's cameras once for all six
// (warp_peers: __match_any_sync, whose cost grows with the distinct
// cameras of a warp, 23 on average at venice-89) after its own sums of
// the tile before, and stages the lanes' peers with the cameras; each
// warp then sums its lanes per camera as hpp_b_kernel does
// (warp_scatter_rows; where the live lanes all sit on one camera in a
// reduce-scatter tree, warp_reduce_scatter16). The copy
// holds the groups one after another (group g's value t in row
// group_offset(g) + t); the block flushes it to the blocks' f64 sums in
// the rows of the other routes (b, then the upper triangle row by row:
// hpp_group_row), and the last block writes hpp and b as hpp_b_kernel's
// does.
constexpr int kHppGroups = 6;

// the operand rows of a tile: Jp's K D, then r~'s K
__host__ __device__ constexpr int tile_cols(int K, int D) { return K * D + K; }

// the shared memory a tile takes: its operands, then its 32 cameras, the
// lanes' peers and the one camera (HppTile)
__host__ __device__ constexpr size_t tile_bytes(int K, int D) {
  return sizeof(double) * tile_cols(K, D) * 32 + sizeof(int) * (2 * 32 + 1);
}

// blocks an SM the registers are bounded for: (4, 12) at N = 89 fits two
// (64 KB copies), (2, 11) three
__host__ __device__ constexpr int hpp_group_blocks(int K, int D) {
  return K * D > 24 ? 2 : 3;
}

// the first column of block j (0 .. 3) of D columns cut in three
__host__ __device__ constexpr int col_lo(int D, int j) {
  return j * ((D + 2) / 3) < D ? j * ((D + 2) / 3) : D;
}

__host__ __device__ constexpr int col_n(int D, int j) {
  return col_lo(D, j + 1) - col_lo(D, j);
}

// whether group g holds b and the diagonal tile of block g (g < 3) or the
// tile of blocks g mod 3 and g + 1 mod 3
__host__ __device__ constexpr bool has_diag(int g) { return g < 3; }

__host__ __device__ constexpr int group_values(int D, int g) {
  return has_diag(g) ? col_n(D, g) * (col_n(D, g) + 3) / 2
                     : col_n(D, g % 3) * col_n(D, (g + 1) % 3);
}

__host__ __device__ constexpr int group_offset(int D, int g) {
  return g == 0 ? 0 : group_offset(D, g - 1) + group_values(D, g - 1);
}

// the sums' row of upper-triangle entry (a, bb), a <= bb
__host__ __device__ constexpr int tri_row(int D, int a, int bb) {
  return D + a * D - a * (a - 1) / 2 + bb - a;
}

// the sums' row of row p of the groups' copy
__device__ __forceinline__ int hpp_group_row(int D, int p) {
  int g = 0;
  while (p >= group_values(D, g)) p -= group_values(D, g++);
  const int j = g % 3, lo = col_lo(D, j), n = col_n(D, j);
  if (has_diag(g)) {
    if (p < n) return lo + p;  // b
    p -= n;
    for (int a = 0; a < n; p -= n - a, ++a)  // the diagonal tile, by rows
      if (p < n - a) return tri_row(D, lo + a, lo + a + p);
  }
  const int i = min(j, (j + 1) % 3), h = max(j, (j + 1) % 3);
  return tri_row(D, col_lo(D, i) + p / col_n(D, h),
                 col_lo(D, h) + p % col_n(D, h));
}

// The staged tile of 32 rows: operand row q of lane l at rows[32 q + l];
// each lane's camera (-1 past the last row) and peers (WarpPeers::rest,
// with the lane's own bit set where it leads its camera), and the one
// camera of a tile whose live lanes (four or more) all sit on it, else -1
struct HppTile {
  double* rows;
  int* cam;
  unsigned* peers;
  int* one;
};

// Warp G of a block: group G's values of this lane's row of the staged
// tile, summed per camera into its rows `acc` of the block's copy
template <int K, int D, int G>
__device__ __forceinline__ void hpp_group_tile(const HppTile& tile,
                                               double* acc, int n_cams) {
  constexpr int kJ = G % 3, kH = (kJ + 1) % 3;
  constexpr int kNg = col_n(D, kJ);
  constexpr int kNh = has_diag(G) ? 0 : col_n(D, kH);
  constexpr int kV = group_values(D, G);
  constexpr bool kLow = kJ < kH;  // block G mod 3 holds the tile's rows
  const int lane = threadIdx.x & 31;
  const int c0 = tile.cam[lane];
  const int c = c0 >= 0 ? c0 : 0;
  // the group's columns of Jp (those of block G mod 3, then of the next
  // block for the off tile) and r~
  double j[K][kNg + kNh], r[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    r[k] = has_diag(G) ? tile.rows[32 * (K * D + k) + lane] : 0.0;
#pragma unroll
    for (int a = 0; a < kNg + kNh; ++a) {
      const int col = a < kNg ? col_lo(D, kJ) + a : col_lo(D, kH) + a - kNg;
      j[k][a] = tile.rows[32 * (k * D + col) + lane];
    }
  }
  // sum_k Jp[k][a] y[k], k in order
  const auto dot = [&](int a, const double(&y)[K]) {
    double s = j[0][a] * y[0];
#pragma unroll
    for (int k = 1; k < K; ++k) s += j[k][a] * y[k];
    return s;
  };
  double v[kV], col[K];
  int t = 0;
  if constexpr (has_diag(G)) {
#pragma unroll
    for (int a = 0; a < kNg; ++a) v[t++] = dot(a, r);
#pragma unroll
    for (int a = 0; a < kNg; ++a) {
#pragma unroll
      for (int bb = a; bb < kNg; ++bb) {
#pragma unroll
        for (int k = 0; k < K; ++k) col[k] = j[k][bb];
        v[t++] = dot(a, col);
      }
    }
  } else {
#pragma unroll
    for (int a = 0; a < (kLow ? kNg : kNh); ++a) {
#pragma unroll
      for (int bb = 0; bb < (kLow ? kNh : kNg); ++bb) {
#pragma unroll
        for (int k = 0; k < K; ++k) col[k] = j[k][kLow ? kNg + bb : bb];
        v[t++] = dot(kLow ? a : kNg + a, col);
      }
    }
  }
  const int cu = *tile.one;
  if (cu >= 0) {
    // every live lane on one camera: 16 values at a time in a
    // reduce-scatter tree, 8 lanes adding two sums each
    __syncwarp();  // after the last walk's adds
#pragma unroll
    for (int k0 = 0; k0 < kV; k0 += 16) {
      double w[16], s[2];
#pragma unroll
      for (int k = 0; k < 16; ++k) w[k] = k0 + k < kV ? v[k0 + k] : 0.0;
      povar::warp_reduce_scatter16(w, s);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = k0 + 2 * lane + i;
        if (lane < 8 && k < kV) acc[k * n_cams + cu] += s[i];
      }
    }
  } else {
    const unsigned own = 1u << lane, word = tile.peers[lane];
    const povar::WarpPeers peers{word & ~own, (word & own) != 0};
    povar::warp_scatter_rows<kV, false>(acc, n_cams, c, peers, v);
  }
}

// warp g's group (G = 0 .. kHppGroups - 1 tried in turn)
template <int K, int D, int G = 0>
__device__ __forceinline__ void hpp_group_warp(int g, const HppTile& tile,
                                               double* acc, int n_cams) {
  if constexpr (G < kHppGroups) {
    if (g == G)
      hpp_group_tile<K, D, G>(tile, acc + group_offset(D, G) * n_cams,
                              n_cams);
    else
      hpp_group_warp<K, D, G + 1>(g, tile, acc, n_cams);
  }
}

// Replaces pallas_cam.py:333 hpp_b (_hpp_b_kernel :311) in f64 on this
// route; bound and outputs as hpp_b_kernel's. Shared memory: the copy of
// (d + d (d + 1) / 2) N doubles, then the tile (tile_bytes).
template <int K, int D>
__global__ void __launch_bounds__(32 * kHppGroups, hpp_group_blocks(K, D))
    hpp_b_groups_kernel(const int32_t* __restrict__ cam,
                        const double* __restrict__ jp,
                        const double* __restrict__ rt,
                        double* __restrict__ hpp, double* __restrict__ b,
                        double* __restrict__ acc_g, int n_obs, int n_cams) {
  constexpr int kValues = D + D * (D + 1) / 2;
  static_assert(group_offset(D, kHppGroups) == kValues,
                "every value in one group");
  constexpr int kCols = tile_cols(K, D);
  constexpr int kPer = (kCols + kHppGroups - 1) / kHppGroups;
  const int n_acc = kValues * n_cams;
  double* smem = dyn_smem<double>();
  double* acc = warp_copy<Route::kShared>(smem, 1, n_acc);
  HppTile tile;
  tile.rows = smem + n_acc;
  tile.cam = reinterpret_cast<int*>(tile.rows + 32 * kCols);
  tile.peers = reinterpret_cast<unsigned*>(tile.cam + 32);
  tile.one = reinterpret_cast<int*>(tile.peers + 32);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = gridDim.x * 32;
  // this warp's operand rows (warp, warp + kHppGroups, ...) of the tile
  // at `base`; warp 0's cameras, and, once they have arrived (after this
  // tile's sums), their match: one for all of the block's warps
  double next[kPer];
  int next_cam = -1;
  unsigned next_peers = 0u;
  int next_one = -1;
  const auto match = [&] {
    const bool live = next_cam >= 0;
    const int c = live ? next_cam : 0;
    const povar::WarpPeers p = povar::warp_peers(c, live);
    next_peers = p.rest | (p.lead ? 1u << lane : 0u);
    const unsigned leads = __ballot_sync(povar::kFullMask, p.lead);
    const bool one = __popc(leads) == 1 &&
                     __popc(__ballot_sync(povar::kFullMask, live)) >= 4;
    next_one =
        one ? __shfl_sync(povar::kFullMask, c, __ffs(leads) - 1) : -1;
  };
  const auto fetch = [&](int base) {
    const int o = base + lane;
    const bool in = o < n_obs;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int q = warp + i * kHppGroups;
      const double* row = q < K * D ? jp + (size_t)q * n_obs
                                    : rt + (size_t)(q - K * D) * n_obs;
      next[i] = in && q < kCols ? __ldg(row + o) : 0.0;
    }
    next_cam = in && warp == 0 ? __ldg(cam + o) : -1;
  };
  fetch(blockIdx.x * 32);
  if (warp == 0) match();
  for (int base = blockIdx.x * 32; base < n_obs; base += stride) {
    __syncthreads();  // every warp done with the last tile
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int q = warp + i * kHppGroups;
      if (q < kCols) tile.rows[32 * q + lane] = next[i];
    }
    if (warp == 0) {
      tile.cam[lane] = next_cam;
      tile.peers[lane] = next_peers;
      if (lane == 0) *tile.one = next_one;
    }
    __syncthreads();
    fetch(base + stride);
    hpp_group_warp<K, D>(warp, tile, acc, n_cams);
    if (warp == 0) match();
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
    const double s = smem[i];
    if (s == 0.0) continue;
    const int p = i / n_cams;
    c2_red(acc_g + hpp_group_row(D, p) * n_cams + (i - p * n_cams), s);
  }
  if (!povar::last_block(povar::ticket_of(acc_g, n_acc))) return;
  drain_sums<double>(acc_g, n_acc,
                     HppWrite<double, D, double>{hpp, b, n_cams});
}

// ------------------------------------------------------------------ C2
// out[r][c] = sum over o with cam[o] = c of v[r][o]: the R rows in
// groups of `group` rows (12 or 11, one chunk of K = group values a row;
// any other R: its largest divisor up to 12, in chunks of one value),
// one group per blockIdx.y, each group a one-pass sum over the
// observations into the route's copies of [group, N] values (warp_peers,
// add_rows; a warp whose live lanes all sit on one camera sums in a
// reduce-scatter tree, warp_reduce_scatter16, and six lanes add two sums
// each). The blocks of a group meet in their own `group` N sums of type
// T and ticket in acc_g; the group's last block writes its rows of out
// and leaves its sums and ticket zeroed.
constexpr int kC2Warps = 16;
constexpr int kC2MinWarps = 16;
constexpr int kC2SharedThreads = 1024;
// static shared memory the kernel declares (last_block's flag), rounded up
constexpr size_t kC2StaticSmem = 128;
// the type the blocks' sums meet in
using C2Sum = double;
// resident blocks an SM the private route's registers are bounded for
// (f32; the f64 instantiation's 16 copies of 12 N doubles leave room for
// one)
constexpr int kC2MinBlocks = 2;
// L2 reads in flight per thread in the last block's drain
constexpr int kC2Drain = 8;

__host__ __device__ constexpr int c2_threads(Route r) {
  return r == Route::kPrivate ? 32 * kC2Warps : kC2SharedThreads;
}

// Replaces pallas_cam.py:207 cam_scatter_add (_scatter_kernel :198).
// Bound: (4 + 4 R) B per observation, 52 B at R = 12: 8.6 us at
// venice-89; 580 B at R = 144, 96.5 us. Routes: 16 private copies in
// 512-thread blocks up to N = 302 (12 rows) / 330 (11), shared copies in
// 1024-thread blocks up to N = 4840 / 5280, else global atomics. The
// earlier version staged [rows, N] accumulators per block, added every
// value with a per-lane shared atomic (a compare-and-swap loop, lanes of
// one camera retrying against each other) and flushed each block with
// contended f32 global atomics into an output zeroed beforehand: 30.9 us
// at R = 12, 445 at 144, 334 at 121; 177 / 1620 on camera-sorted rows;
// 39.6 / 475 at N = 1024. Here 16.7 / 118.5 / 103.0 us, 13.6 / 111.7
// sorted, 35.3 / 225 at N = 1024, one device operation a call. What
// binds R = 12: the loads (11.2 us alone, with the tail), the peers'
// match and walk ~2, the copies' flush ~2. Not kept: the whole row
// through one match on shared copies (214 us at R = 144, 1383 at
// N = 1024, where no [144, N] copy fits and it goes global), the
// next row's loads issued ahead (72 registers: one block an SM, 198 us at
// R = 144; bounded to 64: 18.8 at R = 12), registers bounded for three
// blocks an SM (spills: 20.0), f32 block sums (16.3 at R = 12, the
// others within 1 us: not needed, below), returning f64 atomics in the
// flush (17.0), thread-block clusters of 2 / 4 / 8 adding their copies
// through distributed shared memory before the flush (19.7 / 33.8 / 33.9
// at R = 12 against 19.1: 4 or 8 no longer fit one wave), groups
// of 3 rows on private copies at N = 1024 (35.3 against 35.1 on shared
// copies), 4 private copies a block there (89.7), global atomics at
// every N (197 at R = 12) (tools/cam_ab.py and PERF.md; NVIDIA H100
// 80GB HBM3, 700 W). The blocks' sums meet in f64: 32 venice-89
// CHOLESKY step-1 solves with them, 32 with f32 sums and 32 with the
// earlier kernel all ended inside chip_smoke.py's CHOL_BAND, and 16
// "off" step-1 solves of each within 1e-3 of the JAX run's cost
// (tools/cam_ab.py spread). The f64 instantiation is the same pass in
// doubles (its shared copies' adds: f64 shared atomics, a compare-and-
// swap loop).
template <typename V, int K, Route R, typename T>
__global__ void __launch_bounds__(c2_threads(R),
                                  R == Route::kPrivate &&
                                          sizeof(V) == sizeof(float)
                                      ? kC2MinBlocks
                                      : 1)
    cam_scatter_add_kernel(const int32_t* __restrict__ cam,
                           const V* __restrict__ v, V* __restrict__ out,
                           double* __restrict__ acc_g, int n_obs,
                           int n_cams, int group, int copies) {
  V* smem = dyn_smem<V>();
  const int O = n_obs;
  const int n_acc = group * n_cams;
  const int r0 = blockIdx.y * group;
  const V* vg = v + (size_t)r0 * O;
  double* sums = acc_g + (size_t)blockIdx.y * (n_acc + 1);  // then a ticket
  V* acc = warp_copy<R>(smem, copies, n_acc);
  const int lane = threadIdx.x & 31;
  // warp-uniform trips: every lane reaches the warp's sums
  for (int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < O;
       base += gridDim.x * blockDim.x) {
    const int o = base + lane;
    const bool live = o < O;
    const int c = live ? __ldg(cam + o) : 0;
    V x[K];
    const auto load = [&](int j0) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        x[k] = live ? __ldg(vg + (size_t)(j0 + k) * O + o) : V(0);
    };
    load(0);
    const povar::WarpPeers peers = povar::warp_peers(c, live);
    const unsigned leads = __ballot_sync(povar::kFullMask, peers.lead);
    const bool tree = __popc(leads) == 1 &&
                      __popc(__ballot_sync(povar::kFullMask, live)) >= 4;
    const int cu = __shfl_sync(povar::kFullMask, c, __ffs(leads) - 1);
    for (int j0 = 0;;) {
      if (tree) {
        V s[2];
        povar::warp_reduce_scatter16(x, s);
        if (R == Route::kPrivate) __syncwarp();  // after the last walk's adds
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = 2 * lane + j;
          if (k >= K) continue;
          const int at = (j0 + k) * n_cams + cu;
          if (R == Route::kGlobal)
            atomicAdd(reinterpret_cast<T*>(sums) + at, (T)s[j]);
          else if (R == Route::kShared)
            atomicAdd(acc + at, s[j]);
          else
            acc[at] += s[j];
        }
      } else {
        add_rows<K, R, T>(acc, sums, j0, n_cams, c, peers, x);
      }
      if ((j0 += K) >= group) break;
      load(j0);
    }
  }
  if (R != Route::kGlobal) {
    // the block's copies summed per entry, then to the group's sums
    __syncthreads();
    for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
      V s = smem[i];
      for (int k = 1; k < copies; ++k) s += smem[k * n_acc + i];
      if (s != 0.0f) c2_red(reinterpret_cast<T*>(sums) + i, (T)s);
    }
  }
  if (!povar::last_block(povar::ticket_of(sums, n_acc))) return;
  V* rows = out + (size_t)r0 * n_cams;
  drain_sums<T, kC2Drain>(sums, n_acc,
                          [&](int i, T s) { rows[i] = (V)s; });
}

// Launch C2 with the K-value chunks of `group` rows: the route for one
// group's [group, N] copies (sums_plan), one wave of blocks over all
// groups
template <typename V, int K>
int launch_cam_scatter_add(const int32_t* cam, const V* v, V* out,
                           double* acc, int n_obs, int n_cams, int n_rows,
                           int group, void* stream) {
  const SumsPlan p =
      sums_plan(group, n_cams, kC2Warps, kC2MinWarps, kC2SharedThreads,
                kC2StaticSmem, sizeof(V));
  void (*kernel)(const int32_t*, const V*, V*, double*, int, int, int,
                 int) =
      p.route == Route::kPrivate
          ? &cam_scatter_add_kernel<V, K, Route::kPrivate, C2Sum>
      : p.route == Route::kShared
          ? &cam_scatter_add_kernel<V, K, Route::kShared, C2Sum>
          : &cam_scatter_add_kernel<V, K, Route::kGlobal, C2Sum>;
  const int groups = n_rows / group;
  int grid = 0;
  const cudaError_t err = povar::grid_for_block(
      reinterpret_cast<const void*>(kernel), p.threads,
      (long)n_obs * groups, p.smem, &grid);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks(std::max(1, grid / groups), groups);
  kernel<<<blocks, p.threads, p.smem, (cudaStream_t)stream>>>(
      cam, v, out, acc, n_obs, n_cams, group, p.copies);
  return (int)cudaGetLastError();
}

template <typename V, int kDc>
int launch_e0_scatter(const int32_t* cam, const V* w, const V* sb, V* out,
                      double* acc, int n_obs, int n_cams, int dl, int dc,
                      void* stream) {
  return launch_sums(
      sums_plan(dc, n_cams, kE0sWarps, kE0sWarps, kE0sSharedThreads, 0,
                sizeof(V)),
      e0_scatter_kernel<V, kDc, Route::kPrivate>,
      e0_scatter_kernel<V, kDc, Route::kShared>,
      e0_scatter_kernel<V, kDc, Route::kGlobal>, n_obs, stream, cam, w, sb,
      out, acc, n_obs, n_cams, dl, dc);
}

template <typename V, int K, int D>
int launch_hpp_b(const int32_t* cam, const V* jp, const V* rt, V* hpp, V* b,
                 double* acc, int n_obs, int n_cams, void* stream) {
  constexpr int kValues = D + D * (D + 1) / 2;
  constexpr bool kF64 = sizeof(V) == sizeof(double);
  const SumsPlan p =
      sums_plan(kValues, n_cams, kHppWarps, kF64 ? kHppWarps : 4,
                hpp_threads<V>(Route::kShared), 0, sizeof(V));
  if constexpr (kF64) {
    // in place of shared copies, value groups on one copy while it fits
    // with a tile (and 128 bytes of static shared memory): a tile of 32
    // rows a block and a time, each row's groups on its warps
    const size_t groups =
        sizeof(double) * kValues * n_cams + tile_bytes(K, D);
    if (p.route != Route::kPrivate &&
        groups + 128 <= (size_t)povar::max_optin_smem())
      return povar::launch_block(hpp_b_groups_kernel<K, D>, 32 * kHppGroups,
                                 (long)n_obs * kHppGroups, groups, stream,
                                 cam, jp, rt, hpp, b, acc, n_obs, n_cams);
    const auto kernel = p.route == Route::kPrivate
                            ? hpp_b_kernel<V, K, D, Route::kPrivate>
                            : hpp_b_kernel<V, K, D, Route::kGlobal>;
    return povar::launch_block(kernel, p.threads, n_obs, p.smem, stream, cam,
                               jp, rt, hpp, b, acc, n_obs, n_cams, p.copies);
  } else {
    return launch_sums(p, hpp_b_kernel<V, K, D, Route::kPrivate>,
                       hpp_b_kernel<V, K, D, Route::kShared>,
                       hpp_b_kernel<V, K, D, Route::kGlobal>, n_obs, stream,
                       cam, jp, rt, hpp, b, acc, n_obs, n_cams);
  }
}

// Launch C1 over kVec observations a thread: one whole wave of blocks
// (every SM its resident blocks) over all row blocks (blockIdx.y)
template <typename V, int kVec>
int launch_cam_gather(const int32_t* cam, const V* table, V* out, int n_obs,
                      int n_cams, int n_rows, int rows_per_block,
                      void* stream) {
  const size_t smem = sizeof(V) * (size_t)rows_per_block * n_cams;
  const int row_blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  int grid = 0;
  const cudaError_t err = povar::grid_for<kGatherThreads>(
      cam_gather_kernel<V, kVec>, 1L << 40, smem, &grid);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks(std::max(1, grid / row_blocks), row_blocks);
  cam_gather_kernel<V, kVec>
      <<<blocks, kGatherThreads, smem, (cudaStream_t)stream>>>(
          cam, table, out, n_obs, n_cams, n_rows, rows_per_block);
  return (int)cudaGetLastError();
}

// ------------------------------------- the entry points' bodies, f32 or f64
// rows_per_block: how many table rows one block stages (the caller picks
// it so that rows_per_block * n_cams values fit a block's shared memory)
template <typename V>
int cam_gather(const int32_t* cam, const V* table, V* out, int n_obs,
               int n_cams, int n_rows, int rows_per_block, void* stream) {
  if (n_obs <= 0 || n_cams <= 0 || n_rows <= 0 || rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  // kVec observations a thread (16-byte stores of out's rows and kVec-
  // index loads of cam) need O a multiple of kVec and both pointers
  // aligned to them
  constexpr int kVec = kGatherVec<V>;
  const bool vec = kVec > 1 && n_obs % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(cam) % (4 * kVec) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    return launch_cam_gather<V, kVec>(cam, table, out, n_obs, n_cams, n_rows,
                                      rows_per_block, stream);
  return launch_cam_gather<V, 1>(cam, table, out, n_obs, n_cams, n_rows,
                                 rows_per_block, stream);
}

// out: [n_rows, n_cams]; acc: n_rows * (n_cams + 1) doubles, zero (every
// call leaves them zero): each row group's sums, then its ticket
template <typename V>
int cam_scatter_add(const int32_t* cam, const V* v, V* out, double* acc,
                    int n_obs, int n_cams, int n_rows, void* stream) {
  if (n_obs <= 0 || n_cams <= 0 || n_rows <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows % 12 == 0)
    return launch_cam_scatter_add<V, 12>(cam, v, out, acc, n_obs, n_cams,
                                         n_rows, 12, stream);
  if (n_rows % 11 == 0)
    return launch_cam_scatter_add<V, 11>(cam, v, out, acc, n_obs, n_cams,
                                         n_rows, 11, stream);
  return launch_cam_scatter_add<V, 1>(cam, v, out, acc, n_obs, n_cams,
                                      n_rows, divisor_below(n_rows, 12),
                                      stream);
}

template <typename V>
int e0_u(const int32_t* cam, const V* w, const V* x, V* u, int n_obs,
         int n_cams, int dl, int dc, void* stream) {
  if (dl <= 0 || dc <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(V) * (size_t)dc * n_cams;
  return povar::launch(e0_u_kernel<V>, n_obs, smem, stream, cam, w, x, u,
                       n_obs, n_cams, dl, dc);
}

// out: [dc, n_cams] (dc 12 and 11, both steps' camera dimensions, in one
// pass a row; any other dc a value at a time); acc: dc * n_cams + 1
// doubles, zero (every call leaves them zero)
template <typename V>
int e0_scatter(const int32_t* cam, const V* w, const V* sb, V* out,
               double* acc, int n_obs, int n_cams, int dl, int dc,
               void* stream) {
  if (n_obs <= 0 || n_cams <= 0 || dl <= 0 || dc <= 0)
    return (int)cudaErrorInvalidValue;
  if (dc == 12)
    return launch_e0_scatter<V, 12>(cam, w, sb, out, acc, n_obs, n_cams, dl,
                                    dc, stream);
  if (dc == 11)
    return launch_e0_scatter<V, 11>(cam, w, sb, out, acc, n_obs, n_cams, dl,
                                    dc, stream);
  return launch_e0_scatter<V, 0>(cam, w, sb, out, acc, n_obs, n_cams, dl, dc,
                                 stream);
}

// hpp: [d d, n_cams], b: [d, n_cams]; (k, d) is (4, 12) (step 1) or
// (2, 11) (step 2); acc: (d + d (d + 1) / 2) n_cams + 1 doubles, zero
// (every call leaves them zero)
template <typename V>
int hpp_b(const int32_t* cam, const V* jp, const V* rt, V* hpp, V* b,
          double* acc, int n_obs, int n_cams, int k, int d, void* stream) {
  if (n_obs <= 0 || n_cams <= 0) return (int)cudaErrorInvalidValue;
  if (k == 4 && d == 12)
    return launch_hpp_b<V, 4, 12>(cam, jp, rt, hpp, b, acc, n_obs, n_cams,
                                  stream);
  if (k == 2 && d == 11)
    return launch_hpp_b<V, 2, 11>(cam, jp, rt, hpp, b, acc, n_obs, n_cams,
                                  stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// the f32 entry points, then the f64 ones (`_f64`), with the same
// arguments in the other type
#define POVAR_CAM_ENTRIES(V, SUFFIX)                                        \
  int povar_cam_gather##SUFFIX(const int32_t* cam, const V* table, V* out,  \
                               int n_obs, int n_cams, int n_rows,           \
                               int rows_per_block, void* stream) {          \
    return cam_gather(cam, table, out, n_obs, n_cams, n_rows,               \
                      rows_per_block, stream);                              \
  }                                                                         \
  int povar_cam_scatter_add##SUFFIX(const int32_t* cam, const V* v, V* out, \
                                    double* acc, int n_obs, int n_cams,     \
                                    int n_rows, void* stream) {             \
    return cam_scatter_add(cam, v, out, acc, n_obs, n_cams, n_rows,         \
                           stream);                                         \
  }                                                                         \
  int povar_cam_e0_u##SUFFIX(const int32_t* cam, const V* w, const V* x,    \
                             V* u, int n_obs, int n_cams, int dl, int dc,   \
                             void* stream) {                                \
    return e0_u(cam, w, x, u, n_obs, n_cams, dl, dc, stream);               \
  }                                                                         \
  int povar_cam_e0_scatter##SUFFIX(const int32_t* cam, const V* w,          \
                                   const V* sb, V* out, double* acc,        \
                                   int n_obs, int n_cams, int dl, int dc,   \
                                   void* stream) {                          \
    return e0_scatter(cam, w, sb, out, acc, n_obs, n_cams, dl, dc, stream); \
  }                                                                         \
  int povar_cam_hpp_b##SUFFIX(const int32_t* cam, const V* jp, const V* rt, \
                              V* hpp, V* b, double* acc, int n_obs,         \
                              int n_cams, int k, int d, void* stream) {     \
    return hpp_b(cam, jp, rt, hpp, b, acc, n_obs, n_cams, k, d, stream);    \
  }

extern "C" {
POVAR_CAM_ENTRIES(float, )
POVAR_CAM_ENTRIES(double, _f64)
}  // extern "C"
