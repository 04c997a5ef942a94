"""The port's side of tests/test_torch_spmd_f64.py: what each gloo rank
of its D = 2 mesh runs (the stage outputs and the trajectories of the
mesh's pure f64), and the options and records both packages' runs share.
It imports nothing of JAX, so that the spawned ranks start without it."""

import torch

from povar_tpu_torch import (
    SolverOptions,
    bundle_adjust,
    create_homogeneous,
    from_numpy,
)
from povar_tpu_torch.options import SolverType, SolverTypeRiemannian
from povar_tpu_torch.parallel import spmd as tspmd
from povar_tpu_torch.tools.step2_spread import ring_case

# one torch thread a process: each rank's tensors are small
torch.set_num_threads(1)

LAM = 1e-3


def f64_options(cls, **kw):
    o = cls()
    o.mixed_precision_solves = False
    o.power_sc_iterations = 3
    o.eta = 0.0
    o.r_tolerance = -1.0
    o.pallas_kernels = "on"
    for k, v in kw.items():
        setattr(o, k, v)
    return o


def port_stages(mesh, c):
    """The port's mesh pure-f64 stage outputs on this rank, as the test's
    JAX stages: step 1 on case `c`'s cameras, step 2 on its ring state
    (landmark outputs in canonical order)."""
    plan = tspmd.build_spmd_plan(c["obs_cam"], c["obs_lm"], c["n_cams"],
                                 c["n_lms"], mesh.size, tspmd.PART_ALIGN)
    s = tspmd.SpmdStage1Solver(plan, c["obs_uv"], c["n_cams"], c["n_lms"],
                               f64_options(SolverOptions), mesh)
    cams = torch.as_tensor(c["cams1"])

    def lms(x):
        return s.unpad_landmarks(s.lm_unpack(x))

    lp = s.lm_pack(s.initialize_varproj(cams))
    lin = s.linearize(cams, lp)
    inc, n = s.solve_power(lin, LAM)
    nc, nl, ld = s.apply(cams, lp, lin, inc)
    inc2, n2 = s.solve_power(lin, LAM, landmark_damping=True)
    out1 = dict(
        lm0=lms(lp), e0=float(s.compute_error(cams, lp)["error_all"]),
        inc=inc.numpy(), n=int(n), ld=float(ld), lm1=lms(nl),
        cams1=nc.numpy(), inc2=inc2.numpy(), n2=int(n2),
        dtypes={lin.x.dtype, lin.hll_raw.dtype, lin.pose_scale.dtype},
    )
    s2 = tspmd.SpmdStage2Solver(plan, c["uv2"], c["n_cams"], c["n_lms"],
                                f64_options(SolverOptions), mesh)
    cams, lmh = create_homogeneous(torch.as_tensor(c["cams2"]),
                                   s2.pad_landmarks(c["lms2"]))
    lmh = s2.lm_pack(lmh)
    e = s2.compute_error(cams, lmh)
    lin = s2.linearize(cams, lmh)
    inc, n = s2.solve_power(lin, LAM)
    nc, nl, ld = s2.apply(cams, lmh, lin, inc, LAM)
    out2 = dict(
        e0=float(e["error_all"]), valid=int(e["num_obs_valid"]),
        inc=inc.numpy(), n=int(n), ld=float(ld), cams=nc.numpy(),
        lm=s2.unpad_landmarks(s2.lm_unpack(nl)),
        dtypes={lin.x4.dtype, lin.jlns.dtype, lin.kps.dtype},
    )
    return out1, out2


# ------------------------------------------------------- the trajectories

# (step-1 solver, step-2 solver) of each trajectory, on tools/
# step2_spread.py's `ring_case` (a consistent geometry near its optimum,
# whose trajectories in f64 do not part where the sums' order changes)
CONFIGS = {
    "defaults": ("POWER_VARPROJ", "RIPOBA"),
    "psc-ripcg": ("POWER_SCHUR_COMPLEMENT", "RIPCG"),
    "pcg-ripoba": ("PCG", "RIPOBA"),
}


def trajectory_options(cls, st_cls, st2_cls, config):
    st1, st2 = CONFIGS[config]
    o = cls()
    o.mixed_precision_solves = False
    o.max_num_iterations_step_1 = 4
    o.max_num_iterations_step_2 = 4
    o.solver_type_step_1 = st_cls[st1]
    o.solver_type_step_2 = st2_cls[st2]
    return o


def records(summary):
    return [(it.step_is_successful, it.linear_solver_iterations,
             None if it.cost is None else it.cost.all.error)
            for it in summary.iterations]


def port_trajectories(mesh):
    """The port's pure-f64 `bundle_adjust` on `mesh` (or on one device
    where it is None) for every configuration: {config: (step-1 records,
    step-2 records)}."""
    args, cam0, lm0 = ring_case()
    out = {}
    for config in CONFIGS:
        problem, _c, _l = from_numpy(*args[:3], cam0, lm0, device="cpu")
        opts = trajectory_options(SolverOptions, SolverType,
                                  SolverTypeRiemannian, config)
        where = dict(device="cpu") if mesh is None else dict(mesh=mesh)
        _, s1, s2 = bundle_adjust(problem, opts, log=lambda s: None, **where)
        out[config] = (records(s1), records(s2))
    return out


def port_rank(mesh, c):
    """Everything the D = 2 ranks run: the stages and the trajectories."""
    return port_stages(mesh, c), port_trajectories(mesh)
