"""Two ranks of the SPMD window layout on one card, through gloo.

    python -m povar_tpu_torch.tools.gloo_card [--runs N]

NCCL takes one rank a card, so the mesh's `spawn` (parallel/mesh.py)
runs D > 1 ranks on the card only with D cards. Torch's gloo backend can
put several ranks on one card where it takes CUDA tensors in the
collectives the mesh calls (all_reduce, all_gather; torch 2.11's does,
and broadcast too). `compare` runs two gloo ranks that both live on
cuda:0 (parallel/mesh._spawn_ranks), a harness of this tool and of
chip_smoke.py, not a user option: `spawn` keeps refusing more CUDA
ranks than cards.

`compare` (the command) runs venice-1778's first LARGE_N_ITERS step-1
iteration (SolverOptions() defaults; from its second trial on that
start is chaotic in f32 rounding, tools/large_scale.py) on a D = 2 mesh
of one card, whose ranks first try each collective on a CUDA tensor
(and stop, printing gloo's answers, where one is refused), and on a
1-device mesh, N runs each on solvers built once; it prints each run's
decisions, power-term counts and costs, and the largest relative gap of
a cost between a D = 2 run and a D = 1 run, and between any two runs
(chip_smoke.py's MESH_D2_TOL is twice the latter).

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch
import torch.distributed as dist

from povar_tpu_torch import SolverOptions
from povar_tpu_torch.parallel.mesh import _spawn_ranks, make_mesh
from povar_tpu_torch.tools.large_scale import (
    LARGE_N_ITERS,
    first_iterations,
    make_problem,
    stage_solvers,
)

# the collectives the mesh calls
OPS = ("all_reduce", "all_gather")
SCALE = "venice-1778"


def _try_ops(mesh) -> dict:
    """Each collective on a CUDA tensor: True (the right sums), False, or
    the error gloo raised."""
    x = torch.full((4,), float(mesh.rank + 1), device="cuda")
    want = {"all_reduce": [3.0] * 4, "all_gather": [1.0] * 4 + [2.0] * 4,
            "broadcast": [1.0] * 4}
    out = {}
    for op in want:
        try:
            if op == "all_gather":
                parts = [torch.empty_like(x) for _ in range(mesh.size)]
                dist.all_gather(parts, x)
                got = torch.cat(parts)
            else:
                got = x.clone()
                if op == "all_reduce":
                    dist.all_reduce(got)
                else:
                    dist.broadcast(got, 0)
            out[op] = got.device.type == "cuda" and got.tolist() == want[op]
        except Exception as e:  # the answer is the error itself
            out[op] = f"{type(e).__name__}: {e}"[:300]
    return out


def first_iterations_on(mesh, runs: int) -> list:
    """`runs` runs of SCALE's first LARGE_N_ITERS step-1 iterations
    (SolverOptions() defaults) on this rank of `mesh`, on one stage-1
    solver: each run's [(accepted, terms, cost)] per record."""
    problem = make_problem(SCALE)
    s1, _s2 = stage_solvers(problem, SolverOptions(), mesh)
    out = []
    for _ in range(runs):
        summary, _secs = first_iterations(problem, False, stage1=s1)
        out.append([(it.step_is_successful, it.linear_solver_iterations,
                     None if it.cost is None else it.cost.all.error)
                    for it in summary.iterations])
    return out


def probed_first_iterations(mesh, runs: int):
    """_try_ops on this rank's mesh, then first_iterations_on: (the
    probe's answers, the runs). Raises where gloo refuses a collective
    the mesh calls on a CUDA tensor."""
    ok = _try_ops(mesh)
    if not all(ok[op] is True for op in OPS):
        raise RuntimeError(f"gloo with CUDA tensors: {ok}")
    return ok, first_iterations_on(mesh, runs)


def compare(runs: int) -> float:
    """The module docstring's `compare` (the ranks probing gloo first,
    probed_first_iterations): the largest relative cost gap of a D = 2
    run against a D = 1 run (AssertionError where their decisions or
    counts differ)."""
    ranks = _spawn_ranks(probed_first_iterations, 2, "cuda", "gloo",
                         args=(runs,))
    print(f"gloo with CUDA tensors, two ranks on cuda:0: {ranks[0][0]}",
          flush=True)
    d2 = [runs_r for _ok, runs_r in ranks]
    if d2[0] != d2[1]:
        raise AssertionError(f"the two ranks differ: {d2}")
    d1 = first_iterations_on(make_mesh(1), runs)
    for d, rs in ((1, d1), (2, d2[0])):
        for r, recs in enumerate(rs):
            print(f"D = {d} run {r}: {recs}", flush=True)
    dec = {tuple(rec[:2] for rec in recs) for recs in d1 + d2[0]}

    def gap(xs, ys):
        return max(abs(a[2] - b[2]) / abs(b[2]) for x in xs for y in ys
                   for a, b in zip(x, y) if b[2] is not None)

    print(f"{SCALE}, first {LARGE_N_ITERS} step-1 iterations: D = 2 against D = 1 "
          f"on one card, decisions and counts the same in all runs "
          f"{len(dec) == 1}, largest cost gap {gap(d2[0], d1):.3e} (of any "
          f"two runs {gap(d1 + d2[0], d1 + d2[0]):.3e})", flush=True)
    if len(dec) != 1:
        raise AssertionError(f"decisions or counts differ: {dec}")
    return gap(d2[0], d1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=4)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gloo_card: no CUDA device", file=sys.stderr)
        return 1
    from povar_tpu_torch.ops import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    # the ranks load the kernels this process builds
    _build.build()
    compare(a.runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
