"""The device LM loop: both steps' whole trust-region loop decided on the
device, with no host synchronisation inside a step.

The counterpart of povar_tpu/solver/device_loop.py. The host loop
(solver/lm.py `_optimize_lm_loop`) reads every trial's decision scalars
back to the host, and its inner solves read their stop flags (one
synchronisation per trial, per power term and per CG iteration). Here
every decision stays on the device: the inner solves' stops (the device
forms of solver/pcg.py), the accept / reject rule, the lambda and vee
schedule, the ftol, max-lambda and max-iteration termination, and
relinearizing only after an accepted step that the loop continues from
(`ops/lm_kernels.lm_step`, one kernel at the end of each iteration). The
loop carries the state (cameras, landmarks, linearization, the state
vector of lambda, vee, the iteration, the termination code and the two
cost rows) in tensors written in place, and writes one trace row per
iteration (JAX's trace columns, ops/lm_kernels.TRACE_COLS). The host
learns the outcome from the traces, fetched with the initial cost in one
device-to-host transfer per step, and rebuilds the host loop's
SolverSummary records and log lines from them (`drive_device_loop`;
per-iteration times are the uniform mean, as in the JAX package).

One body serves both devices through a control object with the JAX
pair's shape, `while_loop(pred, body)` and `cond(pred, fn)`:
  - `EagerControl` (the CPU) runs the loops in Python, reading each flag:
    on the CPU that is no synchronisation and wastes no work;
  - `GraphControl` (the card) captures the whole step into one CUDA
    graph, each loop into a WHILE node and each `cond` into an IF node
    (ops/lm_kernels.cond_begin: PyTorch's own capture offers IF nodes
    only), their conditions set on the device by lm_step and
    lm_condition. Every level is captured from one stream, so the
    graph's temporaries reuse each other's memory as the host loop's do;
    they live in a memory pool of their own (torch.cuda.MemPool) as long
    as the graph. The graph is captured once per solver and loop
    (`DeviceLmRun`), after one run of every region on the capture stream
    that makes the lazily built state (the kernel library, the per-stream
    scratch buffers of ops/pose_kernels.py and ops/pose2_kernels.py,
    cuBLAS's workspace) before the capture.
    Launching it is one host call; its launch counts are rebuilt from
    device counts of each region's executions, since the
    wrappers' counters only see the capture.

Exactness: the loop runs the host loop's arithmetic operation for
operation (the device forms of the inner solves, lm_step's f64 schedule
without FMA contraction), so on one device the two loops are decision-
and count-identical and their costs equal; the tests hold them to that in
pure f64 (tests/test_torch_device_loop.py). Unlike the JAX package's
device loop, a NaN or Inf initial cost raises before the caller's state is
touched, as the host loop does.
"""

from __future__ import annotations

import gc
import time
import weakref
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from povar_tpu_torch.ops import launches, lm_kernels, pose_kernels
from povar_tpu_torch.ops.lm_kernels import (
    ACCEPT, CONT, CUR, IT, LAM, PREV, RELIN, ROW_LEN, STATE_LEN, TERM,
    TRACE_COLS, VEE, LmParams,
)
from povar_tpu_torch.options import SolverOptions
from povar_tpu_torch.solver.common import (
    ResidualInfo,
    ResidualItem,
    error_summary_oneline,
)
from povar_tpu_torch.solver.slots import LmState
from povar_tpu_torch.utils.summary import (
    CONVERGENCE,
    NO_CONVERGENCE,
    IterationSummary,
    SolverSummary,
    finish_iteration,
)
from povar_tpu_torch.utils.timer import Timer

# the cost row's entries (ops/lm_kernels ROW_LEN), in the order of the
# trace's err_f / err_n columns
_ROW_KEYS = ("error_all", "residual_sum_all", "error_valid",
             "residual_sum_valid", "num_obs_all", "num_obs_valid")
_COL = {name: j for j, name in enumerate(TRACE_COLS)}
# most graph regions (conditional bodies) one step's graph holds: the LM
# body, the relinearization, the inner loop and the CG refresh
MAX_REGIONS = 8


def err_row(err: Dict, device) -> torch.Tensor:
    """A cost dict as the f64 cost row [ROW_LEN] on `device` (a count the
    solver keeps as a Python int becomes a fill, not a copy)."""
    return torch.stack([
        v.to(torch.float64).reshape(()) if isinstance(v, torch.Tensor)
        else torch.full((), float(v), dtype=torch.float64, device=device)
        for v in (err[k] for k in _ROW_KEYS)
    ])


class EagerControl:
    """The loops of the device LM loop on the host (the CPU's tensors:
    reading a flag is no synchronisation). `while_loop` runs `body` while
    `pred` (and then each flag `body` returns) is true; `cond` runs `fn`
    where `pred` is true."""

    def while_loop(self, pred: torch.Tensor, body: Callable,
                   sets_condition: bool = False) -> None:
        while bool(pred):
            pred = body(None) if sets_condition else body()

    def cond(self, pred: torch.Tensor, fn: Callable) -> None:
        if bool(pred):
            fn()


# device -> the stream graphs are captured from (every level of a graph:
# lm.cu's povar_cond_begin), one for the process, so the per-stream
# scratch buffers of the kernel wrappers are made for it once
_STREAMS: Dict = {}


def _stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device=device)
    return _STREAMS[device]


class GraphControl:
    """The loops of the device LM loop as a CUDA graph's conditional
    nodes. With `capture` (the graph is being captured from the capture
    stream) each `while_loop` becomes a WHILE node and each `cond` an IF
    node, whose body is captured from the same stream; its last kernel
    (lm_condition, or lm_step for the LM loop, which gets the node's
    handle) sets the WHILE condition and adds one to the region's device
    count `counts[r]`. Without it (the warm-up before a capture) each
    body runs once, whatever its predicate, to make the lazily built
    state.

    `regions` lists, per region in capture order, the launches its body
    makes itself (its nested regions' apart); `root` those of the graph
    outside every region."""

    def __init__(self, device, capture: bool, counts: torch.Tensor):
        self.device = torch.device(device)
        self.capture = capture
        self.counts = counts
        self.regions: List[Dict[str, int]] = []
        self._nested: List[Dict[str, int]] = [{}]
        self.root: Dict[str, int] = {}

    def while_loop(self, pred, body, sets_condition=False) -> None:
        self._region(pred, body, True, sets_condition)

    def cond(self, pred, fn) -> None:
        self._region(pred, fn, False, False)

    def _region(self, pred, body, is_while, sets_condition) -> None:
        stream = torch.cuda.current_stream(self.device)
        r = len(self.regions)
        if r >= MAX_REGIONS:
            raise RuntimeError(f"device LM loop: more than {MAX_REGIONS} "
                               "graph regions")
        self.regions.append({})
        handle = None
        if self.capture:
            handle, parent, node = lm_kernels.cond_begin(stream, pred,
                                                         is_while)
        before = launches.launch_counts()
        self._nested.append({})
        try:
            out = body(handle) if sets_condition else body()
            # the WHILE condition (in the capture) and the region count
            sets = self.capture and is_while and not sets_condition
            lm_kernels.lm_condition(out if sets else None,
                                    handle if sets else None,
                                    self.counts, r)
        except BaseException:
            if self.capture:
                lm_kernels.capture_abort(stream)
            raise
        total = _delta(launches.launch_counts(), before)
        nested = self._nested.pop()
        self.regions[r] = _delta(total, nested)
        outer = self._nested[-1]
        for k, v in total.items():
            outer[k] = outer.get(k, 0) + v
        if self.capture:
            lm_kernels.cond_end(stream, parent, node)


def _own(t: torch.Tensor, *carries: torch.Tensor) -> bool:
    """Whether `t` can be written in place on its own: contiguous and
    sharing no storage with the carries."""
    ptr = t.untyped_storage().data_ptr()
    return t.is_contiguous() and all(
        ptr != c.untyped_storage().data_ptr() for c in carries)


def wrapper_token() -> tuple:
    """The kernel wrappers the solvers call through their modules, by
    identity: a graph captured with some calls these only (a tool that
    swaps a module's wrappers for their plain versions gets a graph of
    its own)."""
    from povar_tpu_torch.ops import cam_kernels, pose2_kernels

    return tuple(id(getattr(m, n))
                 for m in (pose_kernels, pose2_kernels, cam_kernels)
                 for n in m.KERNELS)


def _delta(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    return {k: a[k] - b.get(k, 0) for k in a if a[k] - b.get(k, 0)}


class CapturedGraph:
    """A program captured into a CUDA graph by `capture`: `launch()`
    replays it on the current stream, `count_launches(counts)` adds a
    replay's launches to the wrappers' counters from the host copy of
    its region counts. It holds the graph, the memory pool of the
    graph's temporaries and what the program returned, and frees the
    graph when it goes."""

    def __init__(self, graph, pool, keep, control, capture_s,
                 instantiate_s):
        self.graph, self.pool, self.keep = graph, pool, keep
        self.control = control
        self.capture_s, self.instantiate_s = capture_s, instantiate_s

    def launch(self) -> None:
        self.graph.launch()

    def count_launches(self, counts) -> None:
        """The graph's own launches once, each region's times its
        executions (counts[r])."""
        launches.add_launch_counts(self.control.root, 1)
        for r, own in enumerate(self.control.regions):
            launches.add_launch_counts(own, int(counts[r]))

    def __del__(self):
        self.graph.free()


# the host synchronisations of a capture (`_free_cached`, before its
# warm-up and before the capture itself)
CAPTURE_SYNCS = 2


def _free_cached(device) -> None:
    """As torch.cuda.graph does before a capture: collect garbage (a graph
    or pool freed during a capture is an error; a graph dropped before
    frees its pool here) and give the allocator's cached blocks back,
    which it cannot do while a capture is under way, so that the warm-up
    and the graph's pool can grow into them."""
    torch.cuda.synchronize(device)
    gc.collect()
    torch.cuda.empty_cache()


def capture(device, program: Callable, counts: torch.Tensor
            ) -> CapturedGraph:
    """Capture `program(ctl)` into a CUDA graph on `device`: first one run
    of it with a warm-up GraphControl (every region once, on the capture
    stream), then, after a synchronisation, its capture from that stream
    with a capturing one whose regions count their executions in
    `counts` (int64 [MAX_REGIONS], on the device), its allocations in a
    memory pool of its own; then the graph's instantiation. Capturing
    launches nothing: the wrappers' counts it made are taken back. A
    capture or instantiation error raises."""
    dev = torch.device(device)
    s0 = _stream(dev)
    cur = torch.cuda.current_stream(dev)
    _free_cached(dev)
    s0.wait_stream(cur)
    with torch.cuda.stream(s0):
        program(GraphControl(dev, False, counts))
    cur.wait_stream(s0)
    _free_cached(dev)
    t0 = time.perf_counter()
    before = launches.launch_counts()
    ctl = GraphControl(dev, True, counts)
    pool = torch.cuda.MemPool()
    graph = lm_kernels.Graph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.use_mem_pool(pool), torch.cuda.stream(s0):
            graph.begin(s0)
            try:
                keep = program(ctl)
            except BaseException:
                lm_kernels.capture_abort(s0)
                graph.free()
                raise
            graph.end(s0)
    finally:
        if collecting:
            gc.enable()
    t1 = time.perf_counter()
    graph.instantiate()
    t2 = time.perf_counter()
    total = _delta(launches.launch_counts(), before)
    ctl.root = _delta(total, ctl._nested[0])
    launches.add_launch_counts(total, -1)
    # the per-stream scratch buffers the graph's kernels were captured
    # with: a later, larger call on a capture stream replaces its buffer,
    # and the graph must keep the one it points to
    scratch = list(pose_kernels._SUMS.values())
    return CapturedGraph(graph, pool, (keep, scratch), ctl, t1 - t0,
                         t2 - t1)


class DeviceLmRun:
    """The device LM loop of one solver, accept rule and iteration limit.
    `run(cams, lms, err0)` runs it from the state (cams, lms) whose cost
    dict is `err0` and returns (cams, lms, host): the final state and the
    numpy f64 vector `host` of the state vector, the trace [T,
    len(TRACE_COLS)], the initial cost row and validity and the region
    counts, fetched in one device-to-host transfer (`split` names its
    parts). On the card the first run captures the graph and each run
    replays it (`capture_s`, `instantiate_s`: the capture's seconds;
    `nodes`: the graph's top-level nodes), and adds the launches the
    replay made to the wrappers' counters."""

    def __init__(self, solver, options: SolverOptions, accept_rule: str,
                 max_lm_iter: int):
        # weakly: the solver keeps its runs (lm.py), and a cycle would
        # leave a graph to the cyclic collector, which may run while
        # another graph is being captured, when freeing one is not allowed
        self._solver = weakref.ref(solver)
        self.p = LmParams.of(options, accept_rule, max_lm_iter)
        self.T = int(max_lm_iter)
        self.device = solver.device
        self.lam0 = 1.0 / options.initial_trust_region_radius
        self.vee0 = float(options.initial_vee)
        self.packed = False
        self.capture_s = self.instantiate_s = self.nodes = None
        # the graphs captured so far (each synchronises the host with the
        # device CAPTURE_SYNCS times)
        self.captures = 0
        self._graph: Optional[CapturedGraph] = None
        self._bufs = None
        self.region_counts = None

    def _wrap(self, lms: torch.Tensor):
        return LmState(rows=lms) if self.packed else lms

    def _program(self, ctl, cams, lms, st, trace, flags):
        """The whole step from the carries: linearize, then the LM loop
        (the JAX while-body). Returns the linearization buffers (a
        graph's own: they must live as long as it)."""
        solver, p, dev = self._solver(), self.p, self.device
        # the linearization buffers, written in place on relinearization:
        # a field that is not a tensor of its own (a view of the carried
        # state, or expanded) is copied out
        lin0 = solver.linearize(cams, self._wrap(lms))
        lin = type(lin0)(*(t if _own(t, cams, lms) else t.clone()
                           for t in lin0))
        del lin0

        def relinearize():
            for buf, t in zip(lin, solver.linearize(cams, self._wrap(lms))):
                buf.copy_(t)

        def body(handle):
            new_cams, new_lms, ok, iters, l_diff, err2 = solver.trial(
                cams, self._wrap(lms), lin, st[LAM], ctl)
            if isinstance(new_lms, LmState):
                new_lms = new_lms.rows
            trial_row = torch.cat([err_row(err2, dev), torch.stack([
                ok.to(torch.float64),
                err2["is_numerically_valid"].to(torch.float64).reshape(()),
                l_diff.to(torch.float64).reshape(()),
                iters.to(torch.float64).reshape(()),
            ])])
            lm_kernels.lm_step(trial_row, st, trace, flags, p, handle)
            accept = flags[ACCEPT]
            cams.copy_(torch.where(accept, new_cams, cams))
            lms.copy_(torch.where(accept, new_lms, lms))
            ctl.cond(flags[RELIN], relinearize)
            return flags[CONT]

        ctl.while_loop((st[IT] <= p.T) & (st[TERM] == 0), body,
                       sets_condition=True)
        return lin

    def _buffers(self, cams, lms):
        dev = self.device
        return (
            torch.empty_like(cams), torch.empty_like(lms),
            torch.zeros(STATE_LEN, dtype=torch.float64, device=dev),
            torch.zeros((self.T, len(TRACE_COLS)), dtype=torch.float64,
                        device=dev),
            torch.zeros(3, dtype=torch.bool, device=dev),
            torch.zeros(MAX_REGIONS, dtype=torch.int64, device=dev),
        )

    def _prime(self, bufs, cams, lms, row0) -> None:
        """The carries at the start state, with fills and device copies
        only (no host-to-device copy: nothing waits)."""
        c, lm, st, trace, _flags, counts = bufs
        c.copy_(cams)
        lm.copy_(lms)
        st.zero_()
        st[IT].fill_(1.0)
        st[LAM].fill_(self.lam0)
        st[VEE].fill_(self.vee0)
        st[CUR:CUR + ROW_LEN].copy_(row0)
        st[PREV:PREV + ROW_LEN].copy_(row0)
        trace.zero_()
        counts.zero_()

    def run(self, cams, lms, err0):
        dev = self.device
        self.packed = isinstance(lms, LmState)
        lms_t = lms.rows if self.packed else lms
        row0 = torch.cat([err_row(err0, dev), err0["is_numerically_valid"]
                          .to(torch.float64).reshape(1)])
        if dev.type != "cuda":
            bufs = self._buffers(cams, lms_t)
            self._prime(bufs, cams, lms_t, row0[:ROW_LEN])
            self._program(EagerControl(), *bufs[:5])
        else:
            if self._bufs is None:
                self._bufs = self._buffers(cams, lms_t)
                self._prime(self._bufs, cams, lms_t, row0[:ROW_LEN])
                self._capture(self._bufs)
            bufs = self._bufs
            self._prime(bufs, cams, lms_t, row0[:ROW_LEN])
            self._graph.launch()
        c, lm, st, trace, _flags, counts = bufs
        host = torch.cat([st, trace.reshape(-1), row0,
                          counts.to(torch.float64)]).cpu().numpy()
        if dev.type == "cuda":
            self.region_counts = self.split(host)["counts"]
            self._graph.count_launches(self.region_counts)
        # the final state, apart from the graph's carries
        return c.clone(), self._wrap(lm.clone()), host

    def ran_kernels(self) -> set:
        """The kernels (by wrapper name) the last replay ran: the graph's
        own, and those of each region its device count says executed (a
        region's body is one chain of nodes, whose last kernel counts
        it)."""
        control = self._graph.control
        ran = set(control.root)
        for own, n in zip(control.regions, self.region_counts):
            if n > 0:
                ran |= set(own)
        return ran

    def split(self, host: np.ndarray) -> Dict[str, np.ndarray]:
        """The parts of `run`'s host vector: st, trace [T, cols], err0
        (the cost row and its validity) and counts."""
        t = self.T * len(TRACE_COLS)
        return {
            "st": host[:STATE_LEN],
            "trace": host[STATE_LEN:STATE_LEN + t].reshape(
                self.T, len(TRACE_COLS)),
            "err0": host[STATE_LEN + t:STATE_LEN + t + ROW_LEN + 1],
            "counts": host[STATE_LEN + t + ROW_LEN + 1:],
        }

    def _capture(self, bufs) -> None:
        g = capture(self.device, lambda ctl: self._program(ctl, *bufs[:5]),
                    bufs[5])
        self._graph = g
        self.captures += 1
        self.capture_s, self.instantiate_s = g.capture_s, g.instantiate_s
        self.nodes = g.graph.nodes()


def drive_device_loop(
    run: DeviceLmRun,
    state,  # lm._State
    options: SolverOptions,
    max_lm_iter: int,
    summary: SolverSummary,
    timer_total: Timer,
    log: Callable[[str], None],
    err0,
) -> None:
    """Run the device loop from `state` (its cost dict `err0`, still on
    the device) and rebuild the host loop's summary records and log
    lines from the traces, the iteration-0 record included: the initial
    cost arrives with the traces, so a step costs one blocking
    device-to-host transfer. A NaN or Inf initial cost raises the host
    loop's FloatingPointError before `state` is touched."""
    valid_first = options.use_projection_validity_check()

    t0 = Timer()
    cams_f, lms_f, host = run.run(state.cams, state.lms, err0)
    wall = t0.elapsed()
    parts = run.split(host)
    st, tr = parts["st"], parts["trace"]
    n = int(st[IT]) - 1
    term = int(st[TERM])

    e0 = parts["err0"]
    ri0 = _row_info(e0[:ROW_LEN], e0[ROW_LEN])
    log(f"Iteration 0, {error_summary_oneline(ri0, valid_first)}")
    if not ri0.is_numerically_valid:
        raise FloatingPointError(
            "did not expect numerical failure during linearization"
        )
    state.cams = cams_f
    state.lms = lms_f
    state.trial = None
    it0 = IterationSummary(iteration=0)
    it0.cost = ri0
    it0.trust_region_radius = options.initial_trust_region_radius
    it0.step_is_successful = True
    it0.step_is_valid = True
    it0.cumulative_time_in_seconds = timer_total.elapsed() - wall
    finish_iteration(summary, it0)

    it_time = wall / max(n, 1)
    col = _COL
    ri_cur = ri0
    new_outer = True
    for k in range(n):
        row = tr[k]
        it = k + 1
        if new_outer:
            log(f"Iteration {it}, "
                + error_summary_oneline(ri_cur, valid_first))
            summary.num_jacobian_evaluations += 1
        else:
            log(f"Iteration {it}, backtracking")
        summary.num_linear_solves += 1

        it_summary = IterationSummary(iteration=it)
        it_summary.linear_solver_iterations = int(row[col["lin_iters"]])
        it_summary.trust_region_radius = float(row[col["radius"]])
        it_summary.iteration_time_in_seconds = it_time
        it_summary.cumulative_time_in_seconds = (
            timer_total.elapsed() - wall + it_time * it
        )
        it_summary.solve_reduced_system_time_in_seconds = it_time

        lam_pre = _pre_reject_lambda(tr, k, options)
        if not row[col["has_cost"]]:
            # NaN increment (cpp:362-401)
            it_summary.step_is_valid = False
            it_summary.step_is_successful = False
            log(
                f"\t[Invalid] Numeric issues when computing increment "
                f"(contains NaNs), lambda: {lam_pre:.1e}"
            )
            finish_iteration(summary, it_summary)
            new_outer = False
            continue

        summary.num_residual_evaluations += 1
        ri2 = _row_info(row[:ROW_LEN], row[col["nv"]])
        it_summary.cost = ri2
        it_summary.step_is_valid = bool(row[col["valid"]])
        it_summary.step_is_successful = bool(row[col["accept"]])
        it_summary.relative_decrease = float(row[col["rel_dec"]])

        if not ri2.is_numerically_valid:
            log(
                "\t[EVAL] failed to evaluate cost: "
                + error_summary_oneline(ri2, valid_first)
            )
        else:
            log(
                f"\t[EVAL] f_diff {row[col['f_diff']]:.4e} "
                f"l_diff {row[col['l_diff']]:.4e} "
                f"ri1 {ri_cur.valid.error:.4e} "
                f"ri2 {ri2.valid.error:.4e}"
            )
        if it_summary.step_is_successful:
            log(
                f"\t[Success] error: {ri2.all.error:.4e}, "
                f"lambda: {lam_pre:.1e}, it_time: {it_time:.3f}s, "
                f"total_time: "
                f"{it_summary.cumulative_time_in_seconds:.3f}s"
            )
            ri_cur = ri2
            new_outer = True
        else:
            reason = "Reject" if it_summary.step_is_valid else "Invalid"
            log(
                f"\t[{reason}] error: {ri2.all.error:.4e}, "
                f"lambda: {lam_pre:.1e}, it_time: {it_time:.3f}s, "
                f"total_time: "
                f"{it_summary.cumulative_time_in_seconds:.3f}s"
            )
            new_outer = False
        finish_iteration(summary, it_summary)

    if term == 1:
        summary.termination_type = CONVERGENCE
        summary.message = (
            "Function tolerance reached. |cost_change|/cost <= "
            f"{options.function_tolerance}"
        )
    elif term == 2:
        summary.termination_type = NO_CONVERGENCE
        summary.message = (
            "Solver did not converge and reached maximum damping "
            f"lambda of {1.0 / options.min_trust_region_radius}"
        )
    else:
        summary.termination_type = NO_CONVERGENCE
        summary.message = (
            "Solver did not converge after maximum number of "
            f"{max_lm_iter} iterations"
        )


def _row_info(row: np.ndarray, nv) -> ResidualInfo:
    """ResidualInfo of a host cost row (ops/lm_kernels ROW_LEN order)."""
    return ResidualInfo(
        all=ResidualItem(num_obs=int(row[4]), error=float(row[0]),
                         residual_sum=float(row[1])),
        valid=ResidualItem(num_obs=int(row[5]), error=float(row[2]),
                           residual_sum=float(row[3])),
        is_numerically_valid=bool(nv),
    )


def _pre_reject_lambda(tr: np.ndarray, k: int, options) -> float:
    """The lambda the trial was SOLVED with (the host loop logs it
    before the post-trial update): the radius column stores the
    post-update value, so the solved-with lambda is the previous row's
    (or the initial lambda for the first trial)."""
    if k == 0:
        return 1.0 / options.initial_trust_region_radius
    return 1.0 / float(tr[k - 1][_COL["radius"]])
