// The device LM loop's bookkeeping kernel and its CUDA graph plumbing for
// Hopper (sm_90a).
//
//   L1 lm_step       replaces no TPU kernel. The JAX package keeps its
//                    whole trust-region loop on the TPU as one
//                    `lax.while_loop`, whose body ends in a few scalar
//                    XLA operations (povar_tpu/solver/device_loop.py
//                    :213-325): the cost channel, the step quality, the
//                    step-1 or step-2 accept rule, the damping factor and
//                    lambda, vee, the ftol / max-lambda / max-iteration
//                    termination, the relinearization predicate and one
//                    trace row. On the card the loop is a CUDA graph with
//                    conditional nodes (solver/device_loop.py), and a
//                    conditional node's condition can only be set from
//                    device code (cudaGraphSetConditional), so one
//                    single-thread kernel does all of it and sets the LM
//                    loop's condition. Bound: its launch (~2 us of a graph
//                    node); it moves ~200 bytes. Built with the package's
//                    --fmad=false, its f64 arithmetic rounds every product
//                    and sum on its own, as the host loop's Python floats
//                    do (solver/lm.py), so the two loops' lambda
//                    schedules are equal bit for bit.
//   L2 lm_condition  replaces no TPU kernel: sets a conditional node's
//                    condition from a device flag (the inner loops' stop
//                    tests, an IF node's predicate) and counts the
//                    executions of a graph region. One thread.
//
// Graph plumbing (host functions, no kernel of their own): stream capture
// into a graph, a conditional node (IF or WHILE) added to the graph being
// captured with its body captured from the same stream, instantiation,
// launch and release. PyTorch's own capture (torch.cuda.graph) offers IF
// nodes only, each body from a stream of its own; the LM loop and the CG
// iterations need WHILE nodes.
//
// C interface as in pose1.cu: device pointers, sizes and the CUDA stream;
// the cudaError_t of the call is returned.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// the state vector st [kStateLen] (f64): it, term, lam, vee, the current
// state's cost row (4 sums, 2 counts) and the previous recorded trial's
constexpr int kIt = 0, kTerm = 1, kLam = 2, kVee = 3, kCur = 4, kPrev = 10;
// the trial row [kTrialLen] (f64): 4 cost sums (error_all,
// residual_sum_all, error_valid, residual_sum_valid), 2 counts
// (num_obs_all, num_obs_valid), ok (finite increment), nv (numerically
// valid cost), l_diff, the inner iterations
constexpr int kOk = 6, kNv = 7, kLdiff = 8, kIters = 9;
// trace columns: err_f (4), err_n (2), has_cost, nv, valid, accept,
// lin_iters, radius, rel_dec, f_diff, l_diff, relin, lam
constexpr int kCols = 17;
// flags (bool): accept, relin, continue
constexpr int kAccept = 0, kRelin = 1, kCont = 2;

enum Cost { kError = 0, kErrorValid = 1, kErrorValidAvg = 2 };

struct LmParams {
  double min_lambda, max_lambda, ftol, min_rel_dec, vee_factor, initial_vee;
  int T, oc, step1;
};

// Python's max(a, b): b where b > a, else a (a NaN b gives a), as the
// host loop's `max(1.0 / 3, ...)` and `max(min_lambda, lam)`
__device__ __forceinline__ double py_max(double a, double b) {
  return b > a ? b : a;
}

// _compute_cost_decrease's channel (bal_bundle_adjustment.cpp:163-176);
// error_avg is 0 without valid observations, as ResidualItem.error_avg
__device__ __forceinline__ double cost_channel(const double* f, int oc) {
  if (oc == kError) return f[0];
  if (oc == kErrorValid) return f[2];
  return f[5] > 0.0 ? f[2] / f[5] : 0.0;
}

__global__ void lm_step_kernel(const double* __restrict__ trial,
                               double* __restrict__ st,
                               double* __restrict__ trace,
                               bool* __restrict__ flags, LmParams p,
                               cudaGraphConditionalHandle handle,
                               int set_handle) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  const double it = st[kIt];
  const double lam = st[kLam], vee = st[kVee];
  const double* cur = st + kCur;
  const double* prev = st + kPrev;
  const bool ok = trial[kOk] != 0.0, nv = trial[kNv] != 0.0;

  const double f_diff = cost_channel(cur, p.oc) - cost_channel(trial, p.oc);
  double l_eff = trial[kLdiff];
  if (p.oc == kErrorValidAvg) l_eff = l_eff / py_max(cur[5], 1.0);
  const double quality = l_eff != 0.0 ? f_diff / l_eff : __longlong_as_double(
      0x7ff0000000000000LL);  // +inf

  bool valid, accept;
  if (p.step1) {  // cpp:445-448
    valid = ok && nv;
    accept = valid && f_diff > 0.0;
  } else {  // cpp:741-747
    valid = ok && nv && l_eff > 0.0;
    accept = valid && quality > p.min_rel_dec;
  }
  // lambda schedule: max(1/3, 1 - (2 rho - 1)^3) on accept, clamped to
  // min_lambda (cpp:452-455); vee backtracking on reject
  const double t = 2.0 * quality - 1.0;
  const double factor = py_max(1.0 / 3, 1.0 - t * t * t);
  const double lam2 = accept ? py_max(p.min_lambda, lam * factor) : vee * lam;
  const double vee2 = accept ? p.initial_vee : vee * p.vee_factor;

  // ftol on accept against the previous RECORDED trial (cpp:476/776,
  // 179-205); max-lambda on reject
  const double c_new = p.oc == kError ? trial[0] : trial[2];
  const double change = fabs((p.oc == kError ? prev[0] : prev[2]) - c_new);
  const bool ftol = accept && change <= p.ftol * c_new;
  const bool overflow = !accept && lam2 > p.max_lambda;
  const double term = ftol ? 1.0 : (overflow ? 2.0 : 0.0);
  const bool relin = accept && term == 0.0 && it < (double)p.T;

  double* row = trace + (long)(it - 1.0) * kCols;
  for (int j = 0; j < 6; ++j) row[j] = trial[j];
  row[6] = ok;
  row[7] = nv;
  row[8] = valid;
  row[9] = accept;
  row[10] = trial[kIters];
  row[11] = 1.0 / lam2;
  row[12] = ok && nv ? quality : 0.0;
  row[13] = ok && nv ? f_diff : 0.0;
  row[14] = ok ? l_eff : 0.0;
  row[15] = relin;
  row[16] = lam2;

  if (accept)
    for (int j = 0; j < 6; ++j) st[kCur + j] = trial[j];
  // a NaN-increment trial records no cost (the host loop's None)
  for (int j = 0; j < 6; ++j) st[kPrev + j] = ok ? trial[j] : 0.0;
  st[kIt] = it + 1.0;
  st[kTerm] = term;
  st[kLam] = lam2;
  st[kVee] = vee2;
  const bool cont = it + 1.0 <= (double)p.T && term == 0.0;
  flags[kAccept] = accept;
  flags[kRelin] = relin;
  flags[kCont] = cont;
  if (set_handle) cudaGraphSetConditional(handle, cont ? 1u : 0u);
}

__global__ void lm_condition_kernel(const bool* __restrict__ flag,
                                    cudaGraphConditionalHandle handle,
                                    int set_handle,
                                    long long* __restrict__ counts,
                                    int region) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  if (set_handle) cudaGraphSetConditional(handle, *flag ? 1u : 0u);
  if (counts != nullptr) counts[region] += 1;
}

cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, nullptr, n_deps);
#else
  cudaError_t err =
      cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, n_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess
             : cudaErrorStreamCaptureInvalidated;
}

}  // namespace

extern "C" {

int povar_lm_step(const double* trial, double* st, double* trace,
                  bool* flags, double min_lambda, double max_lambda,
                  double ftol, double min_rel_dec, double vee_factor,
                  double initial_vee, int T, int oc, int step1,
                  unsigned long long handle, int set_handle, void* stream) {
  LmParams p{min_lambda, max_lambda, ftol, min_rel_dec, vee_factor,
             initial_vee, T, oc, step1};
  lm_step_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      trial, st, trace, flags, p, (cudaGraphConditionalHandle)handle,
      set_handle);
  return (int)cudaGetLastError();
}

// counts may be null (no region count)
int povar_lm_condition(const bool* flag, unsigned long long handle,
                       int set_handle, long long* counts, int region,
                       void* stream) {
  lm_condition_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      flag, (cudaGraphConditionalHandle)handle, set_handle, counts, region);
  return (int)cudaGetLastError();
}

// Capture from `stream` into a new graph (*graph), until
// povar_graph_end(stream).
int povar_graph_begin(void* stream, void** graph) {
  cudaGraph_t g;
  cudaError_t err = cudaGraphCreate(&g, 0);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamBeginCaptureToGraph((cudaStream_t)stream, g, nullptr,
                                      nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) {
    cudaGraphDestroy(g);
    return (int)err;
  }
  *graph = (void*)g;
  return 0;
}

int povar_graph_end(void* stream) {
  cudaGraph_t g;
  return (int)cudaStreamEndCapture((cudaStream_t)stream, &g);
}

// A conditional node (is_while: WHILE, else IF) in the graph `stream` is
// capturing, after the work captured so far: its condition is set from
// the device flag `pred` by an lm_condition launch captured just before
// it. The capture of that graph then pauses, and `stream` captures the
// node's body until povar_cond_end, which resumes it after the node. One
// stream captures every level, so the caching allocator, which keeps a
// free block for reuse on its own stream only, reuses the blocks of
// every level in the others (the graph runs them in capture order).
int povar_cond_begin(void* stream, const bool* pred, int is_while,
                     unsigned long long* handle_out, void** parent_out,
                     void** node_out) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  lm_condition_kernel<<<1, 32, 0, s>>>(pred, handle, 1, nullptr, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = capture_info(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t paused;
  err = cudaStreamEndCapture(s, &paused);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamBeginCaptureToGraph(
      s, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return (int)err;
  *handle_out = (unsigned long long)handle;
  *parent_out = (void*)graph;
  *node_out = (void*)node;
  return 0;
}

// End the capture of a conditional node's body on `stream` and resume
// capturing its graph `parent` after the node.
int povar_cond_end(void* stream, void* parent, void* node) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaGraph_t body;
  cudaError_t err = cudaStreamEndCapture(s, &body);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNode_t after = (cudaGraphNode_t)node;
  return (int)cudaStreamBeginCaptureToGraph(
      s, (cudaGraph_t)parent, &after, nullptr, 1,
      cudaStreamCaptureModeThreadLocal);
}

// End whatever capture `stream` is in (the error path); its status is
// returned and the error state cleared.
int povar_capture_abort(void* stream) {
  cudaGraph_t g;
  cudaError_t err = cudaStreamEndCapture((cudaStream_t)stream, &g);
  cudaGetLastError();
  return (int)err;
}

int povar_graph_instantiate(void* graph, void** exec) {
  return (int)cudaGraphInstantiate((cudaGraphExec_t*)exec,
                                   (cudaGraph_t)graph, 0);
}

int povar_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

// the top-level nodes of `graph` (conditional bodies not counted)
int povar_graph_nodes(void* graph, unsigned long long* n) {
  size_t count = 0;
  cudaError_t err = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &count);
  *n = count;
  return (int)err;
}

int povar_graph_free(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec != nullptr) err = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph != nullptr) {
    cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
    if (err == cudaSuccess) err = e2;
  }
  return (int)err;
}

}  // extern "C"
