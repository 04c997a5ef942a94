"""The device LM loop's bookkeeping kernel, its condition kernel, and the
CUDA graph plumbing of csrc/lm.cu.

`lm_step` is the end of one LM iteration of the device loop
(solver/device_loop.py), the arithmetic of the while-body of
povar_tpu/solver/device_loop.py after the trial: from the trial's row
(cost sums and counts, finite increment, numerically valid cost, l_diff,
inner iterations) and the loop state `st` it decides accept / reject and
validity, updates lambda, vee, the iteration and the termination code,
the current and previous-recorded cost rows, writes the iteration's
trace row, and sets the flags accept, relin (relinearize: an accepted
step the loop continues from) and continue. It replaces no TPU kernel
(csrc/lm.cu says why it exists). `lm_condition` sets a CUDA graph
conditional node's condition from a device flag and counts a graph
region's executions.

As in ops/pose_kernels.py, a wrapper calls the plain PyTorch version
(`lm_step_ref`, `lm_condition_ref`) when its tensors lie on the CPU, and
only then; otherwise it checks the operands, launches the kernel on the
current stream, raises on a CUDA error and adds one to its launch count
(`LAUNCHES`). The plain version is written with tensor operations only,
so that it runs on the card too, where it is the kernel's yardstick;
its f64 arithmetic is the host loop's (solver/lm.py), operation for
operation, and the kernel is built without FMA contraction: the
loops' lambda schedules agree bit for bit.

The graph functions (`Graph`, `cond_begin`, `cond_end`, `capture_abort`)
wrap the C interface's capture, conditional-node, instantiate and launch
calls; they raise on any CUDA error. There is no fallback.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional

import torch

from povar_tpu_torch.ops import _build
from povar_tpu_torch.ops.pose_kernels import _launch, _on_cpu, _ptr, _stream
from povar_tpu_torch.options import OptimizedCost, SolverOptions

KERNELS = ("lm_step", "lm_condition")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

# the state vector st (f64): it, term, lam, vee, the current state's cost
# row and the previous recorded trial's (each: error_all,
# residual_sum_all, error_valid, residual_sum_valid, num_obs_all,
# num_obs_valid)
IT, TERM, LAM, VEE, CUR, PREV = 0, 1, 2, 3, 4, 10
STATE_LEN = 16
ROW_LEN = 6
# the trial row (f64): the cost row, then ok, nv, l_diff, inner iterations
OK, NV, LDIFF, ITERS = 6, 7, 8, 9
TRIAL_LEN = 10
# the trace columns (JAX's trace arrays: err_f 4, err_n 2, then one each)
TRACE_COLS = ("err_f0", "err_f1", "err_f2", "err_f3", "err_n0", "err_n1",
              "has_cost", "nv", "valid", "accept", "lin_iters", "radius",
              "rel_dec", "f_diff", "l_diff", "relin", "lam")
# the flags (bool)
ACCEPT, RELIN, CONT = 0, 1, 2

_COST_CODE = {
    OptimizedCost.ERROR: 0,
    OptimizedCost.ERROR_VALID: 1,
    OptimizedCost.ERROR_VALID_AVG: 2,
}


class LmParams(NamedTuple):
    """The constants of one LM loop (csrc/lm.cu LmParams)."""

    min_lambda: float
    max_lambda: float
    ftol: float
    min_rel_dec: float
    vee_factor: float
    initial_vee: float
    T: int  # max_lm_iter
    oc: int  # optimized_cost: 0 ERROR, 1 ERROR_VALID, 2 ERROR_VALID_AVG
    step1: int  # the accept rule: 1 step 1 (f_diff > 0), 0 step 2

    @staticmethod
    def of(options: SolverOptions, accept_rule: str, max_lm_iter: int):
        return LmParams(
            min_lambda=1.0 / options.max_trust_region_radius,
            max_lambda=1.0 / options.min_trust_region_radius,
            ftol=float(options.function_tolerance),
            min_rel_dec=float(options.min_relative_decrease),
            vee_factor=float(options.vee_factor),
            initial_vee=float(options.initial_vee),
            T=int(max_lm_iter),
            oc=_COST_CODE[options.optimized_cost],
            step1=int(accept_rule == "step1"),
        )


def _py_max(a, b: torch.Tensor) -> torch.Tensor:
    """Python's max(a, b) elementwise: b where b > a, else a (so a NaN b
    gives a), as the host loop's max(1.0 / 3, ...) and max(min_lambda,
    lam)."""
    return torch.where(b > a, b, a)


def _channel(row: torch.Tensor, oc: int) -> torch.Tensor:
    """_compute_cost_decrease's channel of a cost row
    (bal_bundle_adjustment.cpp:163-176)."""
    if oc == 0:
        return row[0]
    if oc == 1:
        return row[2]
    return torch.where(row[5] > 0, row[2] / row[5], torch.zeros_like(row[2]))


def lm_step_ref(trial: torch.Tensor, st: torch.Tensor, trace: torch.Tensor,
                flags: torch.Tensor, p: LmParams) -> None:
    """The plain version of lm_step: reads trial [TRIAL_LEN] and st
    [STATE_LEN], writes st, trace row st[IT] - 1 and flags [3] in
    place."""
    it, lam, vee = st[IT], st[LAM], st[VEE]
    cur, prev = st[CUR:CUR + ROW_LEN], st[PREV:PREV + ROW_LEN]
    ok, nv = trial[OK] != 0, trial[NV] != 0
    f_diff = _channel(cur, p.oc) - _channel(trial, p.oc)
    l_eff = trial[LDIFF]
    if p.oc == 2:
        l_eff = l_eff / _py_max(1.0, cur[5])
    quality = torch.where(l_eff != 0, f_diff / l_eff,
                          torch.full_like(l_eff, math.inf))
    if p.step1:  # cpp:445-448
        valid = ok & nv
        accept = valid & (f_diff > 0)
    else:  # cpp:741-747
        valid = ok & nv & (l_eff > 0)
        accept = valid & (quality > p.min_rel_dec)
    t = 2.0 * quality - 1.0
    factor = _py_max(1.0 / 3, 1.0 - t * t * t)
    lam2 = torch.where(accept, _py_max(p.min_lambda, lam * factor),
                       vee * lam)
    vee2 = torch.where(accept, torch.full_like(vee, p.initial_vee),
                       vee * p.vee_factor)
    c_new = trial[0] if p.oc == 0 else trial[2]
    change = torch.abs((prev[0] if p.oc == 0 else prev[2]) - c_new)
    ftol = accept & (change <= p.ftol * c_new)
    overflow = ~accept & (lam2 > p.max_lambda)
    zero = torch.zeros_like(lam)
    term = torch.where(ftol, zero + 1.0, torch.where(overflow, zero + 2.0,
                                                     zero))
    relin = accept & (term == 0) & (it < p.T)
    okn = ok & nv
    row = torch.stack([
        *trial[:ROW_LEN], ok.double(), nv.double(), valid.double(),
        accept.double(), trial[ITERS], 1.0 / lam2,
        torch.where(okn, quality, zero), torch.where(okn, f_diff, zero),
        torch.where(ok, l_eff, zero), relin.double(), lam2,
    ])
    k = (it - 1).long().reshape(1)
    trace.index_copy_(0, k, row.unsqueeze(0))
    cur2 = torch.where(accept, trial[:ROW_LEN], cur)
    prev2 = torch.where(ok, trial[:ROW_LEN], torch.zeros_like(prev))
    cont = (it + 1 <= p.T) & (term == 0)
    st.copy_(torch.cat([torch.stack([it + 1, term, lam2, vee2]), cur2,
                        prev2]))
    flags.copy_(torch.stack([accept, relin, cont]))


def _check(name: str, t: torch.Tensor, dtype, n: Optional[int]) -> None:
    if t.dtype != dtype or not t.is_contiguous() or (
            n is not None and t.numel() != n):
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor"
                         + ("" if n is None else f" of {n} entries")
                         + f", got {t.dtype} {tuple(t.shape)}")


def lm_step(trial: torch.Tensor, st: torch.Tensor, trace: torch.Tensor,
            flags: torch.Tensor, p: LmParams,
            handle: Optional[int] = None) -> None:
    """One LM iteration's bookkeeping (module docstring), in place. On the
    card with `handle` (a conditional node's, while its graph is being
    captured) the kernel also sets that node's condition to `continue`."""
    if _on_cpu(trial, st, trace, flags):
        lm_step_ref(trial, st, trace, flags, p)
        return
    _check("trial", trial, torch.float64, TRIAL_LEN)
    _check("st", st, torch.float64, STATE_LEN)
    _check("trace", trace, torch.float64, p.T * len(TRACE_COLS))
    _check("flags", flags, torch.bool, 3)
    _launch("lm_step", _build.library().povar_lm_step,
            _ptr(trial), _ptr(st), _ptr(trace), _ptr(flags),
            p.min_lambda, p.max_lambda, p.ftol, p.min_rel_dec, p.vee_factor,
            p.initial_vee, p.T, p.oc, p.step1, handle or 0,
            int(handle is not None), _stream(trial), counts=LAUNCHES)


def lm_condition_ref(counts: torch.Tensor, region: int) -> None:
    """The plain version of lm_condition's count (the condition has no
    counterpart off a graph: the host reads the flag)."""
    counts[region] += 1


def lm_condition(flag: Optional[torch.Tensor], handle: Optional[int],
                 counts: Optional[torch.Tensor] = None,
                 region: int = 0) -> None:
    """Set conditional node `handle`'s condition from the 0-d bool `flag`
    (both or neither given) and add one to counts[region] (int64) where
    `counts` is given; on the card only."""
    dev = (flag if flag is not None else counts)
    if _on_cpu(dev):
        if counts is not None:
            lm_condition_ref(counts, region)
        return
    if flag is not None:
        _check("flag", flag, torch.bool, 1)
    if counts is not None:
        _check("counts", counts, torch.int64, None)
    _launch("lm_condition", _build.library().povar_lm_condition,
            ctypes.c_void_p(None) if flag is None else _ptr(flag),
            handle or 0, int(handle is not None),
            ctypes.c_void_p(None) if counts is None else _ptr(counts),
            region, _stream(dev), counts=LAUNCHES)


def _call(name: str, *args) -> None:
    lib = _build.library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.povar_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error: {msg} ({rc})")


def cond_begin(stream: torch.cuda.Stream, pred: torch.Tensor,
               is_while: bool) -> tuple:
    """Add a conditional node (WHILE or IF) to the graph `stream` is
    capturing, its condition set from the 0-d bool `pred` by an
    lm_condition launch captured just before it (counted), and capture
    its body from `stream` until `cond_end`. Returns (the node's handle,
    the graph to resume, the node)."""
    _check("pred", pred, torch.bool, 1)
    handle = ctypes.c_ulonglong(0)
    parent, node = ctypes.c_void_p(None), ctypes.c_void_p(None)
    _call("povar_cond_begin", ctypes.c_void_p(stream.cuda_stream),
          _ptr(pred), int(is_while),
          ctypes.c_void_p(ctypes.addressof(handle)),
          ctypes.c_void_p(ctypes.addressof(parent)),
          ctypes.c_void_p(ctypes.addressof(node)))
    LAUNCHES["lm_condition"] += 1
    return handle.value, parent, node


def cond_end(stream: torch.cuda.Stream, parent, node) -> None:
    """End the capture of a conditional node's body on `stream` and resume
    capturing its graph after the node (`cond_begin`'s parent, node)."""
    _call("povar_cond_end", ctypes.c_void_p(stream.cuda_stream), parent,
          node)


def capture_abort(stream: torch.cuda.Stream) -> None:
    """End whatever capture `stream` is in, ignoring its status (the error
    path of a capture)."""
    _build.library().povar_capture_abort(ctypes.c_void_p(stream.cuda_stream))


class Graph:
    """A CUDA graph captured from a stream (`begin`, the work, `end`),
    instantiated (`instantiate`) and launched on the current stream
    (`launch`); `free` releases it."""

    def __init__(self):
        self.graph = ctypes.c_void_p(None)
        self.exec = ctypes.c_void_p(None)

    def begin(self, stream: torch.cuda.Stream) -> None:
        _call("povar_graph_begin", ctypes.c_void_p(stream.cuda_stream),
              ctypes.c_void_p(ctypes.addressof(self.graph)))

    def end(self, stream: torch.cuda.Stream) -> None:
        _call("povar_graph_end", ctypes.c_void_p(stream.cuda_stream))

    def instantiate(self) -> None:
        _call("povar_graph_instantiate", self.graph,
              ctypes.c_void_p(ctypes.addressof(self.exec)))

    def nodes(self) -> int:
        """The graph's top-level nodes (conditional bodies apart)."""
        n = ctypes.c_ulonglong(0)
        _call("povar_graph_nodes", self.graph,
              ctypes.c_void_p(ctypes.addressof(n)))
        return n.value

    def launch(self) -> None:
        _call("povar_graph_launch", self.exec,
              ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))

    def free(self) -> None:
        if self.graph.value or self.exec.value:
            _call("povar_graph_free", self.graph, self.exec)
        self.graph = ctypes.c_void_p(None)
        self.exec = ctypes.c_void_p(None)
