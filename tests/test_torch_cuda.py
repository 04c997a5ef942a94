"""povar_tpu_torch on the card: each CUDA kernel of both steps, the
camera-table kernels and the SPMD window layout's slot kernels against
its plain PyTorch version on the same CUDA tensors, the step-1 slice and
the two-step `bundle_adjust` (composed term, SolverOptions() defaults,
PCG + RIPCG, POWER_SCHUR_COMPLEMENT + RIPOBA, the f32 state, the
unstructured layout, a 1-device mesh) on the card against the same
solves on the CPU, and the command-line app on the card.

Every test here is marked `cuda` and skips without a CUDA device. The
file imports nothing of JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest` skips tests/conftest.py, which configures JAX for the
rest of the suite.) chip_smoke.py runs the kernel check at the
venice-89 shapes; this file runs it at the CPU tests' small shapes
(O = 1024, N = 13, as tests/test_torch_pose_kernels.py) and at
N = 1024, where the two Schur-Jacobi kernels take their global-atomic
route (`hpp_b_structured` and `hppb2` take theirs at N = 2048); the
fused terms run over all slot parts and over a narrow prefix, and also
over parts of three widths and on camera-sorted landmarks; `cam_gather`
also on a 144-row table, more rows than one block stages at N = 1024,
and in both types on each of its routes (16-byte stores, one
observation a thread, row blocks); `hpp_b`'s f64 value groups on each
side of their routes' edges;
`e0_scatter` and `hpp_b` on each of their routes (N = 13 to 5000) and
in three row orders, `e0_scatter` also at a width of 5; `cam_scatter_add`
at R = 12, 121, 144 and 5 on each of its routes (N = 13 to 5000) in four
row orders, with its guards on dead rows, a NaN, repeated calls and one
device operation per call; the two
Schur-Jacobi kernels on each of their routes (N = 13 to 1024) in two
row orders, with their output's symmetry and one device operation per
call; the composed terms' scatters (`e0_scatter_structured`,
`scatter2`) on each of their routes (N = 89 to 6000) in three row
orders, with their guards on dead rows, a NaN, repeated calls and one
device operation per call; every kernel of both steps at N = 3000, 5000
and 13,682 (the camera tables read in place, the global accumulators),
`e0_u` in both types at N = 2000 to 13,682,
`cam_gather` with rows too wide for a block, and `cam_gather` /
`cam_scatter_add` on a [144, O] operand of more than 2^31 entries. The
device LM loop (solver/device_loop.py, csrc/lm.cu): `lm_step` bit for
bit against its plain version on edge cases, a captured graph of nested
WHILE and IF nodes against the same loops on the host, and the card's
device loop against its host loop in pure f64 (decisions, counts, costs
within 1e-9, launch counts rebuilt from the graph's region counts).

Tolerances, with the scales of povar_tpu_torch/tools/parity.py:
elementwise outputs 1e-5 entry by entry (against |plain| + the median
of its row); per-camera sums 1e-4 camera by camera and l_diff 1e-4 (the
order of f32 atomics); the f64 cost 1e-12; counts exactly. The step-2
projections divide by p2, so their camera table and landmarks keep p2
in [2.5, 9] (random ones make the division chaotic).
"""

import copy

import numpy as np
import pytest
import torch

from povar_tpu_torch import (
    SolverOptions,
    SolverSummary,
    Stage1Solver,
    Timer,
    bundle_adjust,
    create_homogeneous,
    from_numpy,
    make_mesh,
    optimize_step1,
    synthetic_bal_problem,
)
from povar_tpu_torch.options import SolverType, SolverTypeRiemannian
from povar_tpu_torch.tools.parity import scaled_error
from povar_tpu_torch.tools.pose2_ab import first_camera_rows
from povar_tpu_torch.tools.step2_spread import (
    OVERFLOW_TOL,
    RING_TOLS,
    SMALL_TOLS,
    overflow_case,
    ring_compare,
    ring_pipeline,
    small_case,
)
from povar_tpu_torch.ops import cam_kernels, cam_ref, launches, lm_kernels
from povar_tpu_torch.ops import pose2_kernels as pk2
from povar_tpu_torch.ops import pose2_ref
from povar_tpu_torch.ops import pose_kernels as pk
from povar_tpu_torch.ops import pose_ref, spmd_kernels, spmd_ref
from povar_tpu_torch.parallel import spmd as tspmd

ALPHA = 0.01
O = 1024
# fused-term slot parts (ofs, g, w) over the O rows: all of them, and a
# narrow prefix (the rest a composed suffix, as with a wide landmark)
PARTS = ((0, 64, 4), (256, 48, 16))
PREFIX = PARTS[:1]
ELEM, CAM, SUM = ("elem", 1e-5), ("cam", 1e-4), ("scalar", 1e-4)
F64, EXACT = ("scalar", 1e-12), ("exact", 0.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    return torch.device("cuda")


def _inputs(n_cams, device, seed=7):
    rng = np.random.default_rng(seed)
    f = np.float32
    mask = (rng.uniform(size=(1, O)) > 0.05).astype(f)
    sw = (rng.uniform(0.5, 1.0, (1, O)) * mask).astype(f)
    ct = rng.standard_normal((12, n_cams))
    # step 2: a camera table whose third row keeps p2 = P2 . x4 in
    # [2.5, 9] for the landmarks x4 below (x4[3] in [1, 2])
    ct2 = ct.copy()
    ct2[8:11] *= 0.1
    ct2[11] = rng.uniform(3.0, 4.0, n_cams)
    x4 = rng.standard_normal((4, O))
    x4[3] = rng.uniform(1.0, 2.0, O)
    d = dict(
        cam=rng.integers(0, n_cams, O).astype(np.int32),
        ct=ct.astype(f), x=rng.standard_normal((3, O)).astype(f),
        uv=rng.standard_normal((2, O)).astype(f), mask=mask, sw=sw,
        w=sw * sw, r_w=(rng.standard_normal((4, O)) * mask).astype(f),
        jls=rng.uniform(0.1, 1.0, (3, O)).astype(f),
        hib=rng.standard_normal((3, O)).astype(f),
        lh=rng.standard_normal((9, O)).astype(f),
        h=(rng.standard_normal((9, O)) * mask).astype(f),
        z=rng.standard_normal((12, n_cams)).astype(f),
        sb=rng.standard_normal((3, O)).astype(f),
        inc=rng.standard_normal((12, n_cams)).astype(f),
        inc_lm=rng.standard_normal((3, O)).astype(f),
        ct64=ct, x64=rng.standard_normal((3, O)),
        uv64=rng.standard_normal((2, O)),
        # step 2: homogeneous landmarks, the projection cache (mx, my,
        # 1/p2) and the solve's per-observation operands
        ct2=ct2.astype(f), ct2_64=ct2, x4=x4.astype(f), x4_64=x4,
        mm=(rng.standard_normal((3, O)) * mask).astype(f),
        r_w2=(rng.standard_normal((2, O)) * mask).astype(f),
        jlns=rng.standard_normal((6, O)).astype(f),
        jls8=rng.standard_normal((8, O)).astype(f),
        mat6=rng.standard_normal((6, O)).astype(f),
        ilm4=rng.standard_normal((4, O)).astype(f),
    )
    return {k: torch.as_tensor(v, device=device) for k, v in d.items()}


def _cases(t, n):
    a = dict(alpha=ALPHA)
    return [
        ("prepare", (t["cam"], t["ct"], t["x"], t["uv"], t["mask"]),
         dict(robust=1, huber=1.0, **a), [ELEM] * 4 + [CAM]),
        ("e0_factor", (t["cam"], t["ct"], t["uv"], t["w"], t["jls"],
                       t["lh"]), a, [ELEM]),
        ("hpp_b_structured", (t["cam"], t["ct"], t["x"], t["uv"], t["sw"],
                              t["r_w"], t["jls"], t["hib"], n), a,
         [CAM, CAM]),
        ("e0_u_structured", (t["cam"], t["x"], t["h"], t["z"]), {}, [ELEM]),
        ("e0_scatter_structured", (t["cam"], t["x"], t["h"], t["sb"], n),
         {}, [CAM]),
        ("apply_ldiff", (t["cam"], t["x"], t["uv"], t["sw"], t["r_w"],
                         t["jls"], t["inc_lm"], t["ct"], t["inc"]), a, [SUM]),
        ("pose_error", (t["cam"], t["ct64"], t["x64"], t["uv64"],
                        t["mask"]), dict(robust=1, huber=1.0, **a),
         [F64, F64, EXACT]),
        ("e0_term_parts", (t["cam"], t["x"], t["h"], t["z"], PARTS, n), {},
         [CAM]),
        ("e0_term_parts", (t["cam"], t["x"], t["h"], t["z"], PREFIX, n), {},
         [CAM]),
        ("schur_diag_structured", (t["cam"], t["x"], t["h"], n), {}, [CAM]),
        ("poba_t3", (t["cam"], t["ct"], t["x"], t["uv"], t["sw"], t["r_w"],
                     t["jls"], t["z"]), a, [ELEM]),
        ("apply_ldiff_stored", (t["cam"], t["x"], t["uv"], t["sw"],
                                t["r_w"], t["jls"], t["inc_lm"], t["ct"],
                                t["z"]), a, [SUM]),
    ]


def _cases2(t, n):
    obs = (t["cam"], t["x4"], t["mm"], t["sw"])
    return [
        ("prepare2", (t["cam"], t["ct2"], t["x4"], t["uv"], t["mask"]),
         dict(use_valid=True, robust=1, huber=1.0), [ELEM] * 5 + [CAM]),
        ("prepare2", (t["cam"], t["ct2"], t["x4"], t["uv"], t["mask"]),
         dict(use_valid=False, robust=0, huber=1.0), [ELEM] * 5 + [CAM]),
        ("hppb2", (*obs, t["r_w2"], t["jlns"], t["hib"], n), {},
         [CAM, CAM]),
        ("mat_dot2", (*obs, t["jlns"], t["r_w2"], t["z"]),
         dict(add_r=True), [ELEM]),
        ("mat_dot2", (*obs, t["mat6"], None, t["z"]), dict(add_r=False),
         [ELEM]),
        ("scatter2", (*obs, t["mat6"], t["sb"], n), {}, [CAM]),
        ("ldiff2", (*obs, t["r_w2"], t["jls8"], t["ilm4"], t["z"]), {},
         [SUM]),
        ("pose_error2", (t["cam"], t["ct2_64"], t["x4_64"], t["uv64"],
                         t["mask"]), dict(robust=1, huber=1.0),
         [EXACT, F64, F64, EXACT, F64, F64, EXACT]),
        ("e0_term2_parts", (*obs, t["mat6"], t["z"], PARTS, n), {}, [CAM]),
        ("e0_term2_parts", (*obs, t["mat6"], t["z"], PREFIX, n), {}, [CAM]),
        ("schur_diag2", (*obs, t["mat6"], n), {}, [CAM]),
    ]


def _close(name, got, want, specs):
    """Each output within the tolerance of its (kind, tol) in `specs`."""
    got = tuple(got.values()) if isinstance(got, dict) else got
    want = tuple(want.values()) if isinstance(want, dict) else want
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) == len(specs), name
    for k, (g, w, (kind, tol)) in enumerate(zip(got, want, specs)):
        err = scaled_error(g, w, kind)
        assert err <= tol, (name, k, kind, err)


@pytest.mark.cuda
@pytest.mark.parametrize("n_cams", [13, 1024])
def test_kernels_match_plain_versions(cuda, n_cams):
    """Each kernel once per call, counted once, within its tolerance."""
    t = _inputs(n_cams, cuda)
    for name, args, kw, specs in _cases(t, n_cams):
        launches.reset_launch_counts()
        got = getattr(pk, name)(*args, **kw)
        torch.cuda.synchronize()
        assert launches.launch_counts()[name] == 1, name
        _close(name, got, getattr(pose_ref, name)(*args, **kw), specs)


@pytest.mark.cuda
@pytest.mark.parametrize("n_cams", [13, 1024])
def test_step2_kernels_match_plain_versions(cuda, n_cams):
    """Each step-2 kernel once per call, counted once, within its
    tolerance; the cost's counts exactly."""
    t = _inputs(n_cams, cuda)
    for name, args, kw, specs in _cases2(t, n_cams):
        launches.reset_launch_counts()
        got = getattr(pk2, name)(*args, **kw)
        torch.cuda.synchronize()
        assert launches.launch_counts()[name] == 1, name
        _close(name, got, getattr(pose2_ref, name)(*args, **kw), specs)


# the per-observation operands of hppb2 and the fused step-2 term
OBS2 = ("cam", "x4", "mm", "sw", "r_w2", "jlns", "hib", "mat6")
# slot parts of three widths (3, 7, 16), each with a ragged last tile of
# the fused term (85, 36 and 16 landmarks per tile)
MIXED = ((0, 100, 3), (300, 37, 7), (559, 29, 16))


# the per-observation operands of hpp_b_structured and the fused step-1
# term
OBS1 = ("cam", "x", "uv", "sw", "r_w", "jls", "hib", "h")


def _rows_reordered(t, idx, keys=OBS2):
    """`t` with every per-observation operand in `keys` taken at idx."""
    return dict(t, **{k: t[k][..., idx].contiguous() for k in keys})


def _by_first_camera(t, parts, keys=OBS2):
    """`t` with each part's landmarks sorted by first camera."""
    return _rows_reordered(t, first_camera_rows(t["cam"], parts), keys)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["drawn", "by_camera"])
@pytest.mark.parametrize("n_cams", [13, 1024, 2048])
def test_hpp_b_structured_routes_and_orders(cuda, n_cams, order):
    """hpp_b_structured in moment form once per call within the
    per-camera tolerance: camera table and accumulators in shared memory
    (N = 13), the accumulators alone (N = 1024: 64 N floats exceed a
    block's shared memory) and straight to global memory (N = 2048), on
    the rows as drawn and sorted by camera, where whole warps share a
    camera and sum before their adds. Every entry of hpp is written (the
    kernel expands the moments into an uninitialized output)."""
    t = _inputs(n_cams, cuda)
    if order == "by_camera":
        t = _rows_reordered(t, torch.argsort(t["cam"].long(), stable=True),
                            OBS1)
    args = tuple(t[k] for k in ("cam", "ct", "x", "uv", "sw", "r_w", "jls",
                                "hib")) + (n_cams,)
    launches.reset_launch_counts()
    got = pk.hpp_b_structured(*args, alpha=ALPHA)
    torch.cuda.synchronize()
    assert launches.launch_counts()["hpp_b_structured"] == 1
    _close("hpp_b_structured", got,
           pose_ref.hpp_b_structured(*args, alpha=ALPHA), [CAM, CAM])


@pytest.mark.cuda
@pytest.mark.parametrize("sums", [True, False], ids=["sums", "nosums"])
@pytest.mark.parametrize("order", ["drawn", "by_camera"])
@pytest.mark.parametrize("n_cams", [13, 1024])
def test_prepare_sums_and_orders(cuda, n_cams, order, sums):
    """prepare once per call, per entry and (jpsq) per camera against its
    plain version, HUBER-weighted, on the rows as drawn and sorted by
    camera (whole warps on one camera, as the mesh's window order puts
    them), at N = 13 (per-warp accumulators) and N = 1024 (one shared
    accumulator per block), with and without the per-camera sums:
    without them r_w, sw and jpsq are None and ata / atr unchanged; with
    them jpsq's rows 4-7 equal rows 0-3 bit for bit (the last block
    writes both from one f64 sum)."""
    t = _inputs(n_cams, cuda)
    if order == "by_camera":
        t = _rows_reordered(t, torch.argsort(t["cam"].long(), stable=True),
                            ("cam", "x", "uv", "mask"))
    args = tuple(t[k] for k in ("cam", "ct", "x", "uv", "mask"))
    kw = dict(alpha=ALPHA, robust=1, huber=1.0, sums=sums)
    launches.reset_launch_counts()
    got = pk.prepare(*args, **kw)
    torch.cuda.synchronize()
    assert launches.launch_counts()["prepare"] == 1
    want = pose_ref.prepare(*args, **kw)
    if not sums:
        assert got[0] is got[1] is got[4] is None
        got, want = got[2:4], want[2:4]
        _close("prepare", got, want, [ELEM] * 2)
        return
    _close("prepare", got, want, [ELEM] * 4 + [CAM])
    assert torch.equal(got[4][4:8], got[4][0:4])


def _error2_inputs(t, rows):
    """pose_error2's operands from `t` (p2 in [2.5, 9]), tiled to `rows`
    rows, with some live rows projected to |p2| = 1e-7 (invalid, finite)
    and, for `bad`, NaN or inf landmarks on a few live and dead rows."""
    reps = rows // O
    cam = t["cam"].repeat(reps)
    mask = t["mask"].repeat(1, reps)
    ct, uv = t["ct2_64"], t["uv64"].repeat(1, reps)
    x4 = t["x4_64"].repeat(1, reps)
    live = torch.nonzero(mask[0] > 0)[:, 0]
    near = live[3::97]
    p2row = ct[8:12, cam[near].long()]  # [4, k]
    x4[:, near] -= p2row * ((p2row * x4[:, near]).sum(0)
                            - 1e-7) / (p2row * p2row).sum(0)
    return cam, ct, x4, uv, mask, live


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [False, True], ids=["finite", "nonfinite"])
@pytest.mark.parametrize("robust", [0, 1, 2], ids=["none", "huber", "cauchy"])
def test_pose_error2_norms_counts_and_repeats(cuda, robust, bad):
    """pose_error2 under NONE, HUBER and CAUCHY against its plain version
    at O = 1024 and 300 x 1024 rows (many blocks' partials), with live
    rows at |p2| < 1e-5 (counted, left out of the valid sums) and, for
    `nonfinite`, NaN and inf landmarks on live rows (the flag false, the
    sums non-finite as the plain version's) and on a dead row (no
    effect): the counts exact, the sums within 1e-12, and a second call
    (after one at the other size: the ticket resets) bit for bit the
    first."""
    t = _inputs(13, cuda)
    outs = {}
    for rows in (O, 300 * O):
        cam, ct, x4, uv, mask, live = _error2_inputs(t, rows)
        if bad:
            x4[0, live[5]] = float("nan")
            x4[2, live[40]] = float("inf")
            dead = torch.nonzero(mask[0] <= 0)[0, 0]
            x4[1, dead] = float("nan")
        args = (cam, ct, x4, uv, mask)
        kw = dict(robust=robust, huber=1.0)
        launches.reset_launch_counts()
        got = pk2.pose_error2(*args, **kw)
        torch.cuda.synchronize()
        assert launches.launch_counts()["pose_error2"] == 1
        want = pose2_ref.pose_error2(*args, **kw)
        assert int(want["num_obs_valid"]) < int(want["num_obs_all"])
        assert bool(want["is_numerically_valid"]) == (not bad)
        for k in want:
            g, w = got[k], want[k]
            assert g.dtype == w.dtype and g.shape == w.shape == (), k
            if g.dtype != torch.float64:
                assert torch.equal(g, w), k
            elif bad:
                assert not bool(torch.isfinite(w)), k
                assert torch.equal(g.isnan(), w.isnan()), k
                assert bool(g.isnan()) or bool(g == w), k
            else:
                _close(k, g, w, [F64])
        outs[rows] = (args, kw, {k: v.clone() for k, v in got.items()})
    for args, kw, first in outs.values():
        again = pk2.pose_error2(*args, **kw)
        for k, v in first.items():
            a, b = v.double(), again[k].double()
            assert torch.equal(a.isnan(), b.isnan()), k
            assert bool(a.isnan()) or bool(a == b), k


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["drawn", "by_first_camera"])
@pytest.mark.parametrize("parts", [PARTS, MIXED], ids=["parts", "mixed"])
@pytest.mark.parametrize("n_cams", [13, 1024])
def test_e0_term_parts_tiles_and_orders(cuda, n_cams, parts, order):
    """The fused step-1 term once per call within the per-camera
    tolerance: over parts of one and of three widths whose last tiles are
    ragged, on the landmarks as drawn and with each part's landmarks
    sorted by first camera; per-warp accumulators at N = 13, one shared
    accumulator at N = 1024."""
    t = _inputs(n_cams, cuda)
    if order == "by_first_camera":
        t = _by_first_camera(t, parts, OBS1)
    args = (t["cam"], t["x"], t["h"], t["z"], parts, n_cams)
    launches.reset_launch_counts()
    got = pk.e0_term_parts(*args)
    torch.cuda.synchronize()
    assert launches.launch_counts()["e0_term_parts"] == 1
    _close("e0_term_parts", got, pose_ref.e0_term_parts(*args), [CAM])


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["drawn", "by_camera"])
@pytest.mark.parametrize("n_cams", [13, 1024, 2048])
def test_hppb2_routes_and_orders(cuda, n_cams, order):
    """hppb2 in moment form once per call within the per-camera
    tolerance: through shared memory (N = 13, 1024) and straight to
    global memory (N = 2048: 52 N floats exceed a block's shared memory),
    on the rows as drawn and sorted by camera, where whole warps share a
    camera and sum before their atomics. Every entry of hpp12 is written
    (the kernel expands the moments into an uninitialized output)."""
    t = _inputs(n_cams, cuda)
    if order == "by_camera":
        t = _rows_reordered(t, torch.argsort(t["cam"].long(), stable=True))
    args = (t["cam"], t["x4"], t["mm"], t["sw"], t["r_w2"], t["jlns"],
            t["hib"], n_cams)
    launches.reset_launch_counts()
    got = pk2.hppb2(*args)
    torch.cuda.synchronize()
    assert launches.launch_counts()["hppb2"] == 1
    _close("hppb2", got, pose2_ref.hppb2(*args), [CAM, CAM])


def _device_ops(fn, reps=3, windows=3):
    """The names of the device operations the profiler records over
    `reps` calls of `fn` (after a warm-up call), in order; a window in
    which it records none is repeated, up to `windows` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


SCHUR_KERNELS = {"schur_diag_structured": "schur_diag_kernel",
                 "schur_diag2": "schur_diag2_kernel"}


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["drawn", "by_camera", "camera_runs"])
@pytest.mark.parametrize("n_cams", [13, 89, 242, 300, 964, 968, 1024])
def test_schur_diag_routes_orders_and_symmetry(cuda, n_cams, order):
    """Both Schur-Jacobi kernels in moment form once per call within the
    per-camera tolerance, on each route: per-warp private copies (N = 13,
    89), shared copies (N = 242, 300, 964: fewer than four copies of 60 N
    floats fit a block beside its static shared memory, and at 964 one)
    and f64 global atomics (N = 968, 1024), on the rows as drawn,
    sorted by camera and with the cameras in runs of 64 rows (at every N
    whole warps on one camera, which sum in a reduce-scatter tree, and
    ~5% dead lanes among them). corr is symmetric bit for bit (a row and
    its mirror come from one sum), every call leaves the sums buffer
    zeroed, and a call is one device operation, the kernel (no zero
    fill: the last block writes every entry)."""
    t = _inputs(n_cams, cuda)
    if order == "by_camera":
        t = _rows_reordered(t, torch.argsort(t["cam"].long(), stable=True),
                            ("cam", "x", "h", "x4", "mm", "sw", "mat6"))
    if order == "camera_runs":
        t["cam"] = ((torch.arange(O, device=cuda) // 64) % n_cams).to(
            torch.int32)
    calls = (
        ("schur_diag_structured", pk, pose_ref, (t["cam"], t["x"], t["h"])),
        ("schur_diag2", pk2, pose2_ref,
         (t["cam"], t["x4"], t["mm"], t["sw"], t["mat6"])),
    )
    for name, mod, ref, args in calls:
        launches.reset_launch_counts()
        got = getattr(mod, name)(*args, n_cams)
        torch.cuda.synchronize()
        assert launches.launch_counts()[name] == 1, name
        _close(name, got, getattr(ref, name)(*args, n_cams), [CAM])
        corr = got.view(12, 12, n_cams)
        assert torch.equal(corr, corr.transpose(0, 1)), name
        assert not any(bool(buf.any()) for buf in pk._SUMS.values()), name
        if n_cams == 89 and order == "drawn":
            ops = _device_ops(lambda: getattr(mod, name)(*args, n_cams))
            assert len(ops) == 3 and all(SCHUR_KERNELS[name] in op
                                         for op in ops), (name, ops)


# the composed terms' scatters: (wrapper module, plain module, operand
# keys of _inputs, the kernel's name in the profiler's records)
SCATTERS = {
    "e0_scatter_structured": (pk, pose_ref, ("cam", "x", "h", "sb"),
                              "e0_scatter_kernel"),
    "scatter2": (pk2, pose2_ref, ("cam", "x4", "mm", "sw", "mat6", "sb"),
                 "scatter2_kernel"),
}


def _scatter(name, t, n_cams):
    mod, ref, keys, _kernel = SCATTERS[name]
    args = tuple(t[k] for k in keys) + (n_cams,)
    return (lambda: getattr(mod, name)(*args),
            lambda: getattr(ref, name)(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["drawn", "by_camera", "camera_runs"])
@pytest.mark.parametrize("n_cams", [89, 1024, 6000])
@pytest.mark.parametrize("name", list(SCATTERS))
def test_composed_scatters_routes_guards_and_repeats(cuda, name, n_cams,
                                                     order):
    """e0_scatter_structured and scatter2 once per call within the
    per-camera tolerance, on each route: per-warp private copies
    (N = 89), shared copies (N = 1024) and f64 global atomics (N = 6000),
    on the rows as drawn, sorted by camera and with the cameras in runs
    of 64 rows (whole warps on one camera, which sum in a reduce-scatter
    tree, ~5% dead lanes among them). Dead rows add exactly zero: they
    all sit on the last camera, which no live row has, with operands that
    would not be zero if added (step 1: sb 1e30 beside h = 0; step 2: NaN
    in every operand beside sw = 0). A NaN in one live row makes its
    camera's sums NaN and no other's. Every call leaves the sums buffer
    zeroed: calls at N and at a larger N in turns, and after the NaN,
    agree with the plain version. A call is one device operation, the kernel
    (the last block writes every entry of out)."""
    t = _inputs(n_cams, cuda)
    if order == "by_camera":
        t = _rows_reordered(t, torch.argsort(t["cam"].long(), stable=True),
                            ("cam", "x", "h", "sb", "x4", "mm", "sw",
                             "mat6", "mask"))
    if order == "camera_runs":
        t["cam"] = ((torch.arange(O, device=cuda) // 64) % n_cams).to(
            torch.int32)
    run, plain = _scatter(name, t, n_cams)
    # a call at a larger N first (more sums, its ticket further on), so
    # that every call below reuses one sums buffer
    wide_run, wide_plain = _scatter(name, t, 2 * n_cams + 7)
    _close(name, wide_run(), wide_plain(), [CAM])
    launches.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    assert launches.launch_counts()[name] == 1
    _close(name, got, plain(), [CAM])

    # the dead rows on the last camera, with operands that would count
    dead = t["mask"][0] == 0
    last = n_cams - 1
    cam = torch.where(t["cam"] == last, 0, t["cam"])
    d = dict(t, cam=torch.where(dead, last, cam).to(torch.int32))
    clean = dict(d)
    if name == "e0_scatter_structured":
        d["sb"] = torch.where(dead, 1e30, t["sb"])
    else:
        for k in ("x4", "mm", "mat6", "sb"):
            d[k] = torch.where(dead, float("nan"), t[k])
    got = _scatter(name, d, n_cams)[0]()
    assert bool(dead.any()) and bool((got[:, last] == 0).all())
    _close(name, got, _scatter(name, clean, n_cams)[1](), [CAM])

    # a NaN in one live row: its camera's sums, and no other's
    row = int(torch.nonzero(~dead)[0])
    nan = dict(t, sb=t["sb"].clone())
    nan["sb"][0, row] = float("nan")
    got = _scatter(name, nan, n_cams)[0]()
    c = int(t["cam"][row])
    assert bool(got[:, c].isnan().all())
    assert bool(torch.cat([got[:, :c], got[:, c + 1:]], 1).isfinite().all())

    # after the NaN, and after the smaller call's ticket, the sums buffer
    # is zero again
    _close(name, wide_run(), wide_plain(), [CAM])
    _close(name, run(), plain(), [CAM])
    assert not any(bool(buf.any()) for buf in pk._SUMS.values())
    if n_cams == 89 and order == "drawn":
        ops = _device_ops(run)
        assert len(ops) == 3 and all(SCATTERS[name][3] in op
                                     for op in ops), ops


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["drawn", "by_first_camera"])
@pytest.mark.parametrize("parts", [PARTS, MIXED], ids=["parts", "mixed"])
@pytest.mark.parametrize("n_cams", [13, 1024])
def test_e0_term2_parts_tiles_and_orders(cuda, n_cams, parts, order):
    """The fused step-2 term once per call within the per-camera
    tolerance: over parts of one and of three widths whose last tiles are
    ragged, on the landmarks as drawn and with each part's landmarks
    sorted by first camera."""
    t = _inputs(n_cams, cuda)
    if order == "by_first_camera":
        t = _by_first_camera(t, parts)
    args = (t["cam"], t["x4"], t["mm"], t["sw"], t["mat6"], t["z"], parts,
            n_cams)
    launches.reset_launch_counts()
    got = pk2.e0_term2_parts(*args)
    torch.cuda.synchronize()
    assert launches.launch_counts()["e0_term2_parts"] == 1
    _close("e0_term2_parts", got, pose2_ref.e0_term2_parts(*args), [CAM])


@pytest.mark.cuda
@pytest.mark.parametrize("n_cams, rows", [(13, 12), (1024, 12), (1024, 144)])
def test_cam_gather_is_exact_on_the_card(cuda, n_cams, rows):
    """The camera gather once per call, counted once, bit for bit the
    plain version's table[:, cam], on entries from 1e-8 to 1e8."""
    rng = np.random.default_rng(n_cams + rows)
    table = torch.as_tensor(
        (rng.choice([-1.0, 1.0], (rows, n_cams))
         * 10.0 ** rng.uniform(-8, 8, (rows, n_cams))).astype(np.float32),
        device=cuda,
    )
    cam = torch.as_tensor(rng.integers(0, n_cams, O).astype(np.int32),
                          device=cuda)
    launches.reset_launch_counts()
    got = cam_kernels.cam_gather(table, cam)
    torch.cuda.synchronize()
    assert launches.launch_counts()["cam_gather"] == 1
    assert torch.equal(got, cam_ref.cam_gather(table, cam))


def _cam_cases(t, n):
    """The four camera-table kernels of the unstructured layout at both
    stages' shapes, on operands zeroed on the dead rows (as the solvers'
    slot pad rows are)."""
    rng = np.random.default_rng(n)
    live = t["mask"]

    def f32(rows, cols=O, scale=live):
        a = torch.as_tensor(rng.standard_normal((rows, cols)),
                            dtype=torch.float32, device=t["cam"].device)
        return a * scale if cols == O else a

    cam = t["cam"]
    w36, w33, sb = f32(36), f32(33), f32(3)
    return [
        ("cam_scatter_add", (f32(12), cam, n), [CAM]),
        ("cam_scatter_add", (f32(144), cam, n), [CAM]),
        ("e0_u", (w36, cam, f32(12, n)), [ELEM]),
        ("e0_u", (w33, cam, f32(11, n)), [ELEM]),
        ("e0_scatter", (w36, cam, sb, n), [CAM]),
        ("e0_scatter", (w33, cam, sb, n), [CAM]),
        ("hpp_b", (f32(48), f32(4), cam, n), [CAM, CAM]),
        ("hpp_b", (f32(22), f32(2), cam, n), [CAM, CAM]),
        ("e0_scatter", (f32(10), cam, f32(2), n), [CAM]),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["drawn", "by_camera", "first_camera"])
@pytest.mark.parametrize("n_cams", [13, 89, 300, 1024, 5000])
def test_cam_kernels_match_plain_versions(cuda, n_cams, order):
    """cam_scatter_add (12 and 144 rows), e0_u and e0_scatter ((dl, dc) =
    (3, 12), (3, 11) and (2, 5), a width with no instantiation of its own)
    and hpp_b ((k, d) = (4, 12) and (2, 11)) once per call, counted once,
    within their tolerances; e0_u bit for bit (it sums its terms in its
    plain version's order). The camera sums of csrc/cam.cu (e0_scatter,
    hpp_b) run at every N and in every row order: as drawn, sorted by
    camera (whole warps on one camera) and with each slot part's
    landmarks sorted by first camera; on every route: per-warp copies
    (both at N = 13 and 89, e0_scatter at 300), shared copies (hpp_b at
    300, e0_scatter at 1024) and global atomics (hpp_b at 1024, both at
    5000). hpp is symmetric bit for bit, and every call leaves its sums
    buffer zeroed for the next. The other two run at N = 13 and 1024 as
    drawn."""
    t = _inputs(n_cams, cuda)
    rows = {"drawn": None,
            "by_camera": torch.argsort(t["cam"].long(), stable=True),
            "first_camera": first_camera_rows(t["cam"], PARTS)}[order]
    sums_only = order != "drawn" or n_cams not in (13, 1024)
    for name, args, specs in _cam_cases(t, n_cams):
        if sums_only and name not in ("e0_scatter", "hpp_b"):
            continue
        if rows is not None:
            args = tuple(a[..., rows].contiguous() if torch.is_tensor(a)
                         else a for a in args)
        launches.reset_launch_counts()
        got = getattr(cam_kernels, name)(*args)
        torch.cuda.synchronize()
        assert launches.launch_counts()[name] == 1, name
        want = getattr(cam_ref, name)(*args)
        _close(name, got, want, specs)
        if name == "e0_u":
            assert torch.equal(got, want)
        if name == "hpp_b":
            d = got[1].shape[0]
            hpp = got[0].view(d, d, n_cams)
            assert torch.equal(hpp, hpp.transpose(0, 1))
    assert not any(bool(buf.any()) for buf in pk._SUMS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["drawn", "by_camera", "first_camera",
                                   "camera_runs"])
@pytest.mark.parametrize("n_cams", [13, 89, 300, 1024, 5000])
def test_cam_scatter_add_routes_guards_and_repeats(cuda, n_cams, order):
    """cam_scatter_add once per call, counted once, within the per-camera
    tolerance, at R = 12, 121 and 144 (row groups of 12 and 11) and 5 (a
    width with no instantiation of its own: one value a pass), on every
    route: per-warp private copies (N = 13, 89), shared copies (N = 300,
    1024; R = 121 at 5000: one copy of 11 N floats) and global atomics
    (R = 12, 144 at N = 5000), on the rows as drawn, sorted by camera, with
    each slot part's landmarks sorted by first camera and with the cameras
    in runs of 64 rows (whole warps on one camera, which sum in a
    reduce-scatter tree). Dead rows (zero operands, all on the last
    camera, which no live row has) add exactly zero; a NaN makes its own
    entry NaN and no other. Every call leaves the sums buffer zeroed:
    calls at N and at a larger N in turns, and after the NaN, agree with
    the plain version. A call is one device operation, the kernel (the
    last block of each row group writes its rows of out)."""
    t = _inputs(n_cams, cuda)
    cam, live = t["cam"], t["mask"]
    if order == "camera_runs":
        cam = ((torch.arange(O, device=cuda) // 64) % n_cams).to(torch.int32)
    rows = {"by_camera": torch.argsort(cam.long(), stable=True),
            "first_camera": first_camera_rows(cam, PARTS)}.get(order)
    if rows is not None:
        cam, live = cam[rows].contiguous(), live[:, rows].contiguous()
    rng = np.random.default_rng(n_cams)
    dead = live[0] == 0
    last = n_cams - 1
    cam_dead = torch.where(dead, last, torch.where(cam == last, 0, cam)).to(
        torch.int32)
    for r in (12, 121, 144, 5):
        v = torch.as_tensor(rng.standard_normal((r, O)), dtype=torch.float32,
                            device=cuda) * live
        wide = 2 * n_cams + 7
        _close("cam_scatter_add", cam_kernels.cam_scatter_add(v, cam, wide),
               cam_ref.cam_scatter_add(v, cam, wide), [CAM])
        launches.reset_launch_counts()
        got = cam_kernels.cam_scatter_add(v, cam, n_cams)
        torch.cuda.synchronize()
        assert launches.launch_counts()["cam_scatter_add"] == 1, r
        _close("cam_scatter_add", got, cam_ref.cam_scatter_add(v, cam, n_cams),
               [CAM])

        got = cam_kernels.cam_scatter_add(v, cam_dead, n_cams)
        assert bool(dead.any()) and bool((got[:, last] == 0).all()), r
        _close("cam_scatter_add", got,
               cam_ref.cam_scatter_add(v, cam_dead, n_cams), [CAM])

        row, k = int(torch.nonzero(~dead)[0]), r // 2
        nan = v.clone()
        nan[k, row] = float("nan")
        got = cam_kernels.cam_scatter_add(nan, cam, n_cams)
        c = int(cam[row])
        bad = torch.zeros_like(got, dtype=torch.bool)
        bad[k, c] = True
        assert bool(got[bad].isnan().all()), r
        assert bool(got[~bad].isfinite().all()), r

        _close("cam_scatter_add", cam_kernels.cam_scatter_add(v, cam, wide),
               cam_ref.cam_scatter_add(v, cam, wide), [CAM])
        _close("cam_scatter_add", cam_kernels.cam_scatter_add(v, cam, n_cams),
               cam_ref.cam_scatter_add(v, cam, n_cams), [CAM])
        assert not any(bool(buf.any()) for buf in pk._SUMS.values()), r
        if n_cams == 89 and order == "drawn":
            ops = _device_ops(lambda: cam_kernels.cam_scatter_add(v, cam,
                                                                  n_cams))
            assert len(ops) == 3 and all("cam_scatter_add_kernel" in op
                                         for op in ops), (r, ops)


def _cam_cases_f64(cam, live, n):
    """The five camera-table kernels in f64 at both steps' shapes (and
    the Schur corrections' 144 / 121 rows, step 2's 132-row tangent
    basis gather), on operands zeroed on the dead rows; per-camera sums
    to 1e-12 per camera (the order of f64 sums), the gathers and e0_u bit
    for bit."""
    rng = np.random.default_rng(n + 64)
    cam64 = ("cam", 1e-12)

    def f64(rows, cols=O):
        a = torch.as_tensor(rng.standard_normal((rows, cols)),
                            dtype=torch.float64, device=cam.device)
        return a * live.double() if cols == O else a

    w36, w33, sb = f64(36), f64(33), f64(3)
    return [
        ("cam_gather", (f64(12, n), cam), [EXACT]),
        ("cam_gather", (f64(132, n), cam), [EXACT]),
        ("cam_scatter_add", (f64(12), cam, n), [cam64]),
        ("cam_scatter_add", (f64(144), cam, n), [cam64]),
        ("cam_scatter_add", (f64(121), cam, n), [cam64]),
        ("cam_scatter_add", (f64(5), cam, n), [cam64]),
        ("e0_u", (w36, cam, f64(12, n)), [EXACT]),
        ("e0_u", (w33, cam, f64(11, n)), [EXACT]),
        ("e0_scatter", (w36, cam, sb, n), [cam64]),
        ("e0_scatter", (w33, cam, sb, n), [cam64]),
        ("hpp_b", (f64(48), f64(4), cam, n), [cam64, cam64]),
        ("hpp_b", (f64(22), f64(2), cam, n), [cam64, cam64]),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["drawn", "by_camera", "camera_runs"])
@pytest.mark.parametrize("n_cams", [13, 89, 300, 1024, 5000])
def test_cam_kernels_f64_match_plain_versions(cuda, n_cams, order):
    """The f64 instantiations of the five camera-table kernels (pure f64,
    `mixed_precision_solves=False`) against their plain versions in f64:
    once per call, counted once under `<name>_f64` and not under the f32
    name; cam_gather and e0_u bit for bit, the per-camera sums within
    1e-12 per camera; the output f64; hpp symmetric bit for bit; every
    call leaves the sums buffer zeroed. On every route of the sums: per-
    warp copies (N = 13; cam_scatter_add and e0_scatter at 89), shared
    copies (the others at 1024), hpp_b's value groups (N = 89 and 300)
    and global atomics (N = 5000), in three row orders (as drawn, sorted by camera, and in
    camera runs of 64 rows, whole warps on one camera). e0_u stages its
    [dc, N] table in shared memory, as its f32 instantiation does: up to
    the solvers' 1024 cameras (96 KB in f64)."""
    t = _inputs(n_cams, cuda)
    cam, live = t["cam"], t["mask"]
    if order == "camera_runs":
        cam = ((torch.arange(O, device=cuda) // 64) % n_cams).to(torch.int32)
    elif order == "by_camera":
        rows = torch.argsort(cam.long(), stable=True)
        cam, live = cam[rows].contiguous(), live[:, rows].contiguous()
    for name, args, specs in _cam_cases_f64(cam, live, n_cams):
        if name == "e0_u" and n_cams > 1024:
            continue  # its [dc, N] table in shared memory: N <= 1024
        launches.reset_launch_counts()
        got = getattr(cam_kernels, name)(*args)
        torch.cuda.synchronize()
        counts = launches.launch_counts()
        assert counts[f"{name}_f64"] == 1 and counts[name] == 0, name
        want = getattr(cam_ref, name)(*args)
        for g in (got if isinstance(got, tuple) else (got,)):
            assert g.dtype == torch.float64, name
        if specs[0] == EXACT:
            assert torch.equal(got, want), name
        else:
            _close(name, got, want, specs)
        if name == "hpp_b":
            d = got[1].shape[0]
            hpp = got[0].view(d, d, n_cams)
            assert torch.equal(hpp, hpp.transpose(0, 1))
    assert not any(bool(buf.any()) for buf in pk._SUMS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n_cams, rows", [(89, 12), (89, 132), (1024, 12),
                                          (1024, 132)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cam_gather_routes_on_the_card(cuda, dtype, n_cams, rows, offset):
    """cam_gather in both types once per call, counted once under its
    type's name, one device operation, bit for bit table[:, cam]: with
    16-byte stores of 4 / 2 observations a thread (offset 0), and one
    observation a thread where O is odd and cam is not aligned to them
    (offset 1: cam[1:]); the table whole in one row block (N = 89, and
    12 rows at N = 1024 in both types) or cut into row blocks (132 rows at
    N = 1024: 6 row blocks of 22 rows in f32, 11 of 12 in f64)."""
    rng = np.random.default_rng(n_cams + rows + offset)
    table = torch.as_tensor(rng.standard_normal((rows, n_cams)), dtype=dtype,
                            device=cuda)
    cam = torch.as_tensor(rng.integers(0, n_cams, O + 1).astype(np.int32),
                          device=cuda)[offset:offset + O - offset]
    name = "cam_gather" + ("_f64" if dtype == torch.float64 else "")
    launches.reset_launch_counts()
    got = cam_kernels.cam_gather(table, cam)
    torch.cuda.synchronize()
    counts = launches.launch_counts()
    assert counts[name] == 1 and sum(counts.values()) == 1, counts
    assert got.dtype == dtype and torch.equal(got,
                                              cam_ref.cam_gather(table, cam))
    # three calls: three device operations (the profiler may drop one)
    ops = _device_ops(lambda: cam_kernels.cam_gather(table, cam))
    assert 0 < len(ops) <= 3 and all("cam_gather_kernel" in op
                                     for op in ops), ops


# the f64 hpp_b's routes (csrc/cam.cu): private copies while 8 of the
# (d + d (d + 1) / 2) N doubles fit a block's 232,448 bytes, value groups
# while one copy fits with a tile of 32 rows of k d + k doubles, 32
# cameras, 32 peer masks, one word and 128 bytes of static shared
# memory, else the global route
HPP_F64_OPTIN = 232_448


def _hpp_f64_route(k: int, d: int, n: int) -> str:
    copy = 8 * (d + d * (d + 1) // 2) * n
    tile = 8 * 32 * (k * d + k) + 4 * (2 * 32 + 1)
    return ("private" if HPP_F64_OPTIN // copy >= 8 else "groups"
            if copy + tile + 128 <= HPP_F64_OPTIN else "global")


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["drawn", "by_camera", "camera_runs"])
@pytest.mark.parametrize("n_cams", [40, 41, 89, 303, 304, 366, 367])
def test_hpp_b_f64_value_groups_on_the_card(cuda, n_cams, order):
    """hpp_b's f64 instantiation at (k, d) = (4, 12) and (2, 11) on each
    side of its routes' edges (value groups from N = 41 / 48 to 303 /
    366): one device operation, the route's kernel (hpp_b_groups_kernel
    on the value groups), within 1e-12 per camera of the plain version,
    hpp symmetric bit for bit, the sums buffer left zeroed; in three row
    orders (camera runs of 64 rows: whole warps on one camera, which sum
    in a reduce-scatter tree)."""
    t = _inputs(n_cams, cuda)
    cam, live = t["cam"], t["mask"].double()
    if order == "camera_runs":
        cam = ((torch.arange(O, device=cuda) // 64) % n_cams).to(torch.int32)
    elif order == "by_camera":
        rows = torch.argsort(cam.long(), stable=True)
        cam, live = cam[rows].contiguous(), live[:, rows].contiguous()
    rng = np.random.default_rng(n_cams)
    for k, d in ((4, 12), (2, 11)):
        jp, rt = (torch.as_tensor(rng.standard_normal((x, O)), device=cuda)
                  * live for x in (k * d, k))
        launches.reset_launch_counts()
        got = cam_kernels.hpp_b(jp, rt, cam, n_cams)
        torch.cuda.synchronize()
        assert launches.launch_counts()["hpp_b_f64"] == 1
        _close("hpp_b", got, cam_ref.hpp_b(jp, rt, cam, n_cams),
               [("cam", 1e-12)] * 2)
        hpp = got[0].view(d, d, n_cams)
        assert torch.equal(hpp, hpp.transpose(0, 1))
        assert not any(bool(buf.any()) for buf in pk._SUMS.values())
        ops = _device_ops(lambda: cam_kernels.hpp_b(jp, rt, cam, n_cams))
        route = _hpp_f64_route(k, d, n_cams)
        kernel = ("hpp_b_groups_kernel" if route == "groups"
                  else "hpp_b_kernel")
        assert 0 < len(ops) <= 3 and all(kernel in op for op in ops), (route,
                                                                     ops)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    t = _inputs(13, cuda)
    with pytest.raises(TypeError, match="cam"):
        pk.e0_u_structured(t["cam"].long(), t["x"], t["h"], t["z"])
    with pytest.raises(TypeError, match="x"):
        pk.e0_u_structured(t["cam"], t["x"].double(), t["h"], t["z"])
    with pytest.raises(ValueError, match="contiguous"):
        pk.e0_u_structured(t["cam"], t["x"].T.contiguous().T, t["h"],
                           t["z"])
    with pytest.raises(ValueError, match="one CUDA device"):
        pk.e0_u_structured(t["cam"], t["x"].cpu(), t["h"], t["z"])
    with pytest.raises(ValueError, match="add_r"):
        pk2.mat_dot2(t["cam"], t["x4"], t["mm"], t["sw"], t["jlns"], None,
                     t["z"], add_r=True)
    with pytest.raises(TypeError, match="cam_table"):
        pk2.pose_error2(t["cam"], t["ct"], t["x4_64"], t["uv64"], t["mask"],
                        robust=0, huber=1.0)
    with pytest.raises(TypeError, match="table"):
        cam_kernels.cam_gather(t["ct"].half(), t["cam"])
    # the f64 instantiations take f64 operands only, and the f32 ones f32:
    # a mixed call is a TypeError, never a cast
    with pytest.raises(TypeError, match="x"):
        cam_kernels.e0_u(t["r_w"].repeat(9, 1), t["cam"], t["ct64"])
    with pytest.raises(TypeError, match="sb"):
        cam_kernels.e0_scatter(t["r_w"].repeat(9, 1).double(), t["cam"],
                               t["r_w"][:3], 13)
    with pytest.raises(TypeError, match="r_tilde"):
        cam_kernels.hpp_b(t["r_w"].repeat(12, 1).double(), t["r_w"],
                          t["cam"], 13)
    with pytest.raises(ValueError, match="hpp_b"):
        cam_kernels.hpp_b(t["r_w"].repeat(3, 1), t["r_w"][:3], t["cam"], 13)
    with pytest.raises(ValueError, match="z_table"):
        pk.poba_t3(t["cam"], t["ct"], t["x"], t["uv"], t["sw"], t["r_w"],
                   t["jls"], t["z"][:, :5], alpha=ALPHA)


@pytest.mark.cuda
def test_step1_slice_card_matches_cpu(cuda):
    """Six LM iterations of the slice on the card and on the CPU (plain
    versions): identical decisions and power-term counts, costs within
    1e-3 (f32 inner solves in another summation order), and every
    kernel of the composed term launched on the card."""
    problem, _ = synthetic_bal_problem(n_cams=8, n_lms=60, obs_per_lm=5,
                                       seed=7)
    opts = SolverOptions()
    opts.max_num_iterations_step_1 = 6
    opts.fused_power_term = False
    opts.device_lm_loop = "off"
    trajs = {}
    for dev in ("cuda", "cpu"):
        solver = Stage1Solver(
            problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks, opts, device=dev,
        )
        launches.reset_launch_counts()
        summary = SolverSummary()
        optimize_step1(
            solver, torch.as_tensor(problem.cam_space, device=dev),
            torch.as_tensor(problem.lm_p, device=dev), opts, summary,
            Timer(), log=lambda s: None,
        )
        counts = {k: v for k, v in launches.launch_counts().items()
                  if k in pk.KERNELS
                  and k not in FUSED_ONLY | CG_ONLY | PSC_ONLY}
        if dev == "cuda":
            assert min(counts.values()) > 0, counts
        else:
            assert max(counts.values()) == 0, counts
        trajs[dev] = [
            (it.step_is_successful, it.linear_solver_iterations,
             it.cost.all.error)
            for it in summary.iterations
        ]
    assert len(trajs["cuda"]) == len(trajs["cpu"])
    for (ok_g, n_g, c_g), (ok_c, n_c, c_c) in zip(trajs["cuda"], trajs["cpu"]):
        assert (ok_g, n_g) == (ok_c, n_c)
        np.testing.assert_allclose(c_g, c_c, rtol=1e-3)


# the kernels each configuration of `small_case` runs (every landmark of
# its problem is narrow, so the fused terms have no composed suffix);
# none runs POWER_SCHUR_COMPLEMENT, an f32 state or a mesh
FUSED_ONLY = {"e0_term_parts", "e0_term2_parts"}
CG_ONLY = {"schur_diag_structured", "schur_diag2"}
COMPOSED_ONLY = {"e0_u_structured", "e0_scatter_structured", "scatter2"}
PSC_ONLY = {"poba_t3", "apply_ldiff_stored"}
F32_ONLY = {"cam_gather"}
UNSTRUCTURED_ONLY = {"cam_scatter_add", "e0_u", "e0_scatter", "hpp_b"}
SPMD_ONLY = set(spmd_kernels.KERNELS)
# the camera-table kernels' f64 instantiations run in pure f64 only
F64_ONLY = set(cam_kernels.F64_KERNELS)
# the device LM loop's kernels (`small_case` and `ring_pipeline` run the
# host loop)
LM_ONLY = set(lm_kernels.KERNELS)
ALL = (set(launches.KERNELS) - PSC_ONLY - F32_ONLY - UNSTRUCTURED_ONLY
       - SPMD_ONLY - F64_ONLY - LM_ONLY)
SMALL_KERNELS = {
    "composed": ALL - FUSED_ONLY - CG_ONLY,
    "defaults": ALL - COMPOSED_ONLY - CG_ONLY,
    "cg": ALL - COMPOSED_ONLY,
}
# the kernels of the unstructured configurations of `small_case` and of
# `ring_pipeline`: step 1 and step 2 on Lin1 / Lin2 ("off": the camera-table kernels, the f64
# cost kernels, nothing structured), and CHOLESKY + RIPOBA under "auto"
# (step 1 unstructured with no power series, so no e0_u / e0_scatter;
# step 2 structured with the fused term)
UNSTRUCTURED_KERNELS = {
    "off": UNSTRUCTURED_ONLY | F32_ONLY | {"pose_error", "pose_error2"},
    "cholesky": {"cam_scatter_add", "hpp_b"} | F32_ONLY | (
        SMALL_KERNELS["defaults"] - {"prepare", "e0_factor", "hpp_b_structured",
                                     "e0_term_parts", "apply_ldiff"}),
}
# the kernels of the `ring_pipeline` configurations: PSC's apply in place
# of the VarProj one; the f32 state's cost through cam_gather in place of
# the f64 cost kernels; the unstructured ones
RING_KERNELS = {
    "psc": (ALL - COMPOSED_ONLY - CG_ONLY - {"apply_ldiff"}) | PSC_ONLY,
    "f32": (ALL - COMPOSED_ONLY - CG_ONLY - {"pose_error", "pose_error2"})
    | F32_ONLY,
    **UNSTRUCTURED_KERNELS,
}


@pytest.mark.cuda
@pytest.mark.parametrize("config", list(SMALL_KERNELS))
def test_bundle_adjust_card_matches_cpu(cuda, config):
    """The two-step solve of tools/step2_spread.py's `small_case` (the
    problem of tests/test_torch_stage2.py's pipeline test) on the card
    and on the CPU, with the composed power term, SolverOptions()
    defaults (the fused term) and PCG + RIPCG, every kernel of the
    configuration launched on the card and none on the CPU.

    Composed and defaults: identical decisions and power-term counts in
    both steps, final costs within SMALL_TOLS (2e-3 for step 1, 1e-3 for
    step 2; fifty card runs of the composed term, see that module; ten
    of the defaults put the gaps at 8.6e-4 and 6.3e-10 with identical
    decisions and counts: `--small 10 --small-config defaults`).

    PCG + RIPCG: `--small 10 --small-config cg` (an H100 80GB HBM3, 700
    W) found the truncated CG's q-tolerance test on near-ties that f32
    rounding decides: inner counts within one of the CPU's in both
    steps, step-1 decisions different in 3 of 10 runs and step-1 final
    costs up to 41% apart (PCG's step 1 ends in a flat valley of this
    noisy problem), while step 2 reached the CPU's optimum every time
    (gap <= 2.6e-10). So step 1 is held to counts within one and a 100x
    drop, step 2 to counts within one and SMALL_TOLS[1]."""
    jp, opts = small_case(config)
    kernels = SMALL_KERNELS[config]
    runs = {}
    for dev in ("cuda", "cpu"):
        p, _c, _l = from_numpy(jp.obs_cam, jp.obs_lm, jp.obs_uv, jp.cam_space,
                               jp.lm_p, device="cpu")
        launches.reset_launch_counts()
        _, s1, s2 = bundle_adjust(p, opts, log=lambda s: None, device=dev)
        counts = launches.launch_counts()
        assert len(counts) == 34
        if dev == "cuda":
            assert all(counts[k] > 0 for k in kernels), counts
        else:
            assert max(counts.values()) == 0, counts
        runs[dev] = (s1, s2)
    for step, g, c, rtol in zip((1, 2), runs["cuda"], runs["cpu"],
                                SMALL_TOLS):
        gn = [it.linear_solver_iterations for it in g.iterations]
        cn = [it.linear_solver_iterations for it in c.iterations]
        gd = [it.step_is_successful for it in g.iterations]
        cd = [it.step_is_successful for it in c.iterations]
        gf, cf = g.final_cost.all.error, c.final_cost.all.error
        if config != "cg":
            assert (gd, gn) == (cd, cn)
            np.testing.assert_allclose(gf, cf, rtol=rtol)
            continue
        assert all(abs(a - b) <= 1 for a, b in zip(gn, cn)), (gn, cn)
        if step == 1:
            assert gf <= 1e-2 * g.initial_cost.all.error, (gf, cf)
        else:
            np.testing.assert_allclose(gf, cf, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("config", list(RING_KERNELS))
def test_ring_bundle_adjust_card_matches_cpu(cuda, config):
    """`ring_pipeline` of tools/step2_spread.py on the card and on the
    CPU: POWER_SCHUR_COMPLEMENT + RIPOBA (4 + 4 iterations, f64 state),
    SolverOptions() defaults with an f32 state (6 + 6), and the
    unstructured layout and CHOLESKY + RIPOBA (6 + 6), every kernel of
    the configuration launched on the card and none on the CPU; identical
    decisions and power-term counts in both steps, every cost within
    RING_TOLS[config] relative of the CPU's (see that module)."""
    runs = {}
    for dev in ("cuda", "cpu"):
        launches.reset_launch_counts()
        runs[dev] = ring_pipeline(config, dev)
        counts = launches.launch_counts()
        if dev == "cuda":
            assert all(counts[k] > 0 for k in RING_KERNELS[config]), counts
        else:
            assert max(counts.values()) == 0, counts
    for (same, gap), rtol in zip(ring_compare(runs["cuda"], runs["cpu"]),
                                 RING_TOLS[config]):
        assert same
        assert gap <= rtol, gap


@pytest.mark.cuda
def test_cli_on_the_card(cuda, tmp_path):
    """`python -m povar_tpu_torch.cli` as a user runs it, on the card with
    SolverOptions() defaults, on the committed BAL fixture after
    --create-dataset: it exits 0 and writes a ba_log.json with both
    steps' records, strictly falling accepted costs in each, and the
    card's memory statistics."""
    import json
    import os
    import shutil
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    name = "mini-bal-12-48-pre.txt"
    shutil.copy(os.path.join(repo, "tests", "data", name), tmp_path / name)
    env = dict(os.environ, PYTHONPATH=repo)
    for argv in (["--input", name, "--create-dataset"],
                 ["--input", os.path.join("data_custom", name)]):
        proc = subprocess.run(
            [sys.executable, "-m", "povar_tpu_torch.cli", *argv],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=600,
        )
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    log = json.loads((tmp_path / "ba_log.json").read_text())
    for key in ("iterations1", "iterations"):
        accepted = [it["cost"] for it in log[key] if it["step_is_successful"]]
        assert len(accepted) > 1, key
        assert all(b < a for a, b in zip(accepted, accepted[1:])), key
    assert "cuda:0" in json.dumps(log)


@pytest.mark.cuda
@pytest.mark.parametrize("config", list(UNSTRUCTURED_KERNELS))
def test_unstructured_bundle_adjust_card_matches_cpu(cuda, config):
    """`bundle_adjust` of `small_case`'s problem with pallas_kernels="off"
    (6 + 10 iterations) and with CHOLESKY + RIPOBA (6 + 4: its step 2
    starts where the trajectory is chaotic, see
    tests/test_torch_unstructured_stage2.py) on the card and on the CPU:
    every kernel of the configuration launched on the card and none on
    the CPU; identical step-1 decisions and inner counts, step-1 final
    costs within SMALL_TOLS[0] (the f32 atomics' order); step 2 finite
    and below its start."""
    jp, opts = small_case(config)
    runs = {}
    for dev in ("cuda", "cpu"):
        p, _c, _l = from_numpy(jp.obs_cam, jp.obs_lm, jp.obs_uv, jp.cam_space,
                               jp.lm_p, device="cpu")
        launches.reset_launch_counts()
        _, s1, s2 = bundle_adjust(p, opts, log=lambda s: None, device=dev)
        counts = launches.launch_counts()
        if dev == "cuda":
            assert all(counts[k] > 0 for k in UNSTRUCTURED_KERNELS[config]), (
                counts)
        else:
            assert max(counts.values()) == 0, counts
        runs[dev] = (s1, s2)
    (g1, g2), (c1, _c2) = runs["cuda"], runs["cpu"]
    assert ([(it.step_is_successful, it.linear_solver_iterations)
             for it in g1.iterations]
            == [(it.step_is_successful, it.linear_solver_iterations)
                for it in c1.iterations])
    np.testing.assert_allclose(g1.final_cost.all.error,
                               c1.final_cost.all.error, rtol=SMALL_TOLS[0])
    assert np.isfinite(g2.final_cost.all.error)
    assert g2.final_cost.all.error < g2.initial_cost.all.error


@pytest.mark.cuda
@pytest.mark.parametrize("step1", ["POWER_VARPROJ", "CHOLESKY"])
def test_pure_f64_bundle_adjust_card_matches_cpu(cuda, step1):
    """Pure f64 (`mixed_precision_solves=False`): `bundle_adjust` of
    `ring_case`, 6 + 6 iterations, with RIPOBA after each step-1 solver,
    on the card and on the CPU: the five f64 instantiations (and the f64
    cost kernels) launched on the card and no f32 camera-table kernel,
    nothing on the CPU; identical records in both steps, every cost
    within 1e-9 relative of the CPU's (f64 sums in other orders)."""
    from povar_tpu_torch.options import SolverType
    from povar_tpu_torch.tools.step2_spread import ring_case

    args, cam0, lm0 = ring_case()
    opts = SolverOptions(mixed_precision_solves=False,
                         solver_type_step_1=SolverType[step1],
                         max_num_iterations_step_1=6,
                         max_num_iterations_step_2=6)
    runs = {}
    for dev in ("cuda", "cpu"):
        p, _c, _l = from_numpy(*args[:3], cam0, lm0, device="cpu")
        launches.reset_launch_counts()
        _, s1, s2 = bundle_adjust(p, opts, log=lambda s: None, device=dev)
        counts = launches.launch_counts()
        if dev == "cuda":
            want = {"cam_gather_f64", "cam_scatter_add_f64", "hpp_b_f64",
                    "pose_error", "pose_error2"}
            if step1 == "POWER_VARPROJ":
                want |= {"e0_u_f64", "e0_scatter_f64"}
            assert all(counts[k] > 0 for k in want), counts
            assert not any(counts[k] for k in cam_kernels.KERNELS), counts
        else:
            assert max(counts.values()) == 0, counts
        runs[dev] = (s1, s2)
    for g, c in zip(runs["cuda"], runs["cpu"]):
        assert ([(it.step_is_successful, it.linear_solver_iterations)
                 for it in g.iterations]
                == [(it.step_is_successful, it.linear_solver_iterations)
                    for it in c.iterations])
        np.testing.assert_allclose([it.cost.all.error for it in g.iterations],
                                   [it.cost.all.error for it in c.iterations],
                                   rtol=1e-9)


# SPMD window layouts: tests/test_pallas_spmd.py's two classes (several
# parts, a w = 1 part, tail lanes) and venice-89's one part of width 5
SPMD_LAYOUTS = {
    "two-class": (tspmd.ClassLayout(3, ((128, 3), (256, 2)), 1024),
                  tspmd.ClassLayout(2, ((128, 1),), 256)),
    "venice": (tspmd.ClassLayout(3, ((1536, 5),), 8192),),
}
SPMD_CALLS = {
    "class_part_sums": (tspmd.spmd_part_sums, "lanes"),
    "class_expand_rows": (tspmd.spmd_expand_rows, "rows"),
    "class_reduce_reexpand": (tspmd.spmd_reduce_reexpand, "lanes"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(SPMD_LAYOUTS))
@pytest.mark.parametrize("lead", [(), (4,), (3, 3)])
def test_spmd_kernels_match_plain_versions(cuda, layout, lead):
    """The three slot reduce/expand kernels, one launch each, bit-equal to
    their plain versions (both add the slot elements left to right)."""
    lay = SPMD_LAYOUTS[layout]
    o_dev, n_rows = spmd_ref.layout_sizes(lay)
    rng = np.random.default_rng(11)
    for name, (fn, src) in SPMD_CALLS.items():
        cols = o_dev if src == "lanes" else n_rows
        x = torch.as_tensor(rng.standard_normal(lead + (cols,)),
                            dtype=torch.float32)
        launches.reset_launch_counts()
        got = fn(x.to(cuda), lay)
        torch.cuda.synchronize()
        assert launches.launch_counts()[name] == 1, name
        want = fn(x, lay)
        assert got.shape == want.shape
        assert torch.equal(got.cpu(), want), name


@pytest.mark.cuda
def test_spmd_kernels_refuse_f64_and_strided(cuda):
    """An f64 or non-contiguous CUDA operand raises: no silent copy (an
    f64 state reaches the expansion as its f32 halves,
    parallel/spmd.spmd_expand_rows)."""
    lay = SPMD_LAYOUTS["two-class"]
    o_dev, _n_rows = spmd_ref.layout_sizes(lay)
    x = torch.zeros((3, o_dev), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        spmd_kernels.class_part_sums(x, lay)
    x = torch.zeros((o_dev, 3), dtype=torch.float32, device=cuda).T
    with pytest.raises(ValueError, match="contiguous"):
        spmd_kernels.class_reduce_reexpand(x, lay)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["unique rows", "overflow"])
def test_spmd_f64_cost_expands_through_the_kernel(cuda, case):
    """Both stages' f64 cost on a 1-device mesh (the mixed-precision
    cost of every LM trial) expands the state through the
    class_expand_rows kernel, once per call (its f32 hi and lo halves in
    one launch), with or without landmarks owning several slot rows, and
    gives the CPU's cost: the same halves, f64 sums in another order."""
    if case == "overflow":
        problem, _opts = overflow_case()
    else:
        problem, _ = synthetic_bal_problem(40, 300, 5, seed=1)
    plan = tspmd.build_spmd_plan(problem.obs_cam, problem.obs_lm,
                                 problem.num_cameras, problem.num_landmarks,
                                 1, tspmd.PART_ALIGN)
    assert plan.has_duplicates == (case == "overflow")
    args = (plan, problem.obs_uv, problem.num_cameras,
            problem.num_landmarks, SolverOptions())
    errors = {}
    for dev in ("cuda", "cpu"):
        mesh = make_mesh(1, dev)
        cams = torch.as_tensor(problem.cam_space, device=dev)
        s1 = tspmd.SpmdStage1Solver(*args, mesh)
        lp = s1.lm_pack(s1.pad_landmarks(problem.lm_p))
        s2 = tspmd.SpmdStage2Solver(*args, mesh)
        c2, lh = create_homogeneous(cams, s2.pad_landmarks(problem.lm_p))
        lh = s2.lm_pack(lh)
        for step, (s, c, lm) in enumerate(((s1, cams, lp), (s2, c2, lh)), 1):
            launches.reset_launch_counts()
            e = s.compute_error(c, lm)
            torch.cuda.synchronize()
            counts = launches.launch_counts()
            if dev == "cuda":
                assert counts["class_expand_rows"] == 1, counts
                assert counts["class_part_sums"] == 0, counts
            else:
                assert max(counts.values()) == 0, counts
            errors[dev, step] = float(e["error_all"])
    for step in (1, 2):
        assert np.isfinite(errors["cuda", step])
        np.testing.assert_allclose(errors["cuda", step], errors["cpu", step],
                                   rtol=1e-12)


@pytest.mark.cuda
def test_spmd_bundle_adjust_card_matches_cpu(cuda):
    """`bundle_adjust` on a 1-device mesh (the SPMD window layout) of
    tools/step2_spread.py's `overflow_case` (landmarks with several slot
    rows) on the card and on the CPU: the slot kernels launched on the
    card and none on the CPU; step 1's decisions and power-term counts
    identical and its costs within OVERFLOW_TOL (the f32 sums' order,
    see `overflow_case`); step 2 finite and below its start."""
    problem, opts = overflow_case()
    runs = {}
    for dev in ("cuda", "cpu"):
        launches.reset_launch_counts()
        _, s1, s2 = bundle_adjust(copy.deepcopy(problem), opts,
                                  log=lambda s: None,
                                  mesh=make_mesh(1, dev))
        counts = launches.launch_counts()
        if dev == "cuda":
            assert counts["class_part_sums"] > 0, counts
            assert counts["class_expand_rows"] > 0, counts
            assert counts["e0_term_parts"] == 0, counts
        else:
            assert max(counts.values()) == 0, counts
        runs[dev] = (s1, s2)
    (g1, g2), (c1, _c2) = runs["cuda"], runs["cpu"]
    assert ([(it.step_is_successful, it.linear_solver_iterations)
             for it in g1.iterations]
            == [(it.step_is_successful, it.linear_solver_iterations)
                for it in c1.iterations])
    for g, c in zip(g1.iterations, c1.iterations):
        np.testing.assert_allclose(g.cost.all.error, c.cost.all.error,
                                   rtol=OVERFLOW_TOL)
    assert np.isfinite(g2.final_cost.all.error)
    assert g2.final_cost.all.error < g2.initial_cost.all.error


# Large N: the routes past a block's shared memory (csrc/pose_common.cuh
# stage_table, launch_tiles; prepare's global sums, prepare2's global
# accumulator; the other table kernels read their tables in place at any
# N). At N = 3000 the fused terms and prepare2 read their table in place
# beside one shared accumulator; at N = 5000 the fused terms add straight
# to global memory, and prepare2 too; at N = 13,682 (final-13682's)
# prepare's per-camera sums go global too.
LARGE_N = [3000, 5000, 13_682]


@pytest.mark.cuda
@pytest.mark.parametrize("n_cams", LARGE_N)
def test_large_n_routes_match_plain_versions(cuda, n_cams):
    """Every step-1 and step-2 kernel (prepare also without its sums)
    once per call, counted once, within its tolerance, at the large-N
    routes."""
    t = _inputs(n_cams, cuda)
    nosums = ("prepare", (t["cam"], t["ct"], t["x"], t["uv"], t["mask"]),
              dict(robust=0, huber=1.0, alpha=ALPHA, sums=False),
              [ELEM] * 2)
    for mod, ref, cases in ((pk, pose_ref, _cases(t, n_cams) + [nosums]),
                            (pk2, pose2_ref, _cases2(t, n_cams))):
        for name, args, kw, specs in cases:
            launches.reset_launch_counts()
            got = getattr(mod, name)(*args, **kw)
            torch.cuda.synchronize()
            assert launches.launch_counts()[name] == 1, (name, n_cams)
            want = getattr(ref, name)(*args, **kw)
            if not kw.get("sums", True):
                got, want = got[2:4], want[2:4]
            _close(name, got, want, specs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_cams", [2000] + LARGE_N)
def test_large_n_e0_u_is_exact(cuda, n_cams, dtype):
    """The camera-table kernel e0_u at (dl, dc) = (3, 12) and (3, 11) bit
    for bit its plain version at N = 2000 to 13,682, where the earlier
    version staged its table (f64 up to N = 2,421, f32 up to 4,842) and
    this one reads it in place."""
    rng = np.random.default_rng(n_cams)
    cam = torch.as_tensor(rng.integers(0, n_cams, O).astype(np.int32),
                          device=cuda)
    for dc in (12, 11):
        w = torch.as_tensor(rng.standard_normal((3 * dc, O)), dtype=dtype,
                            device=cuda)
        x = torch.as_tensor(rng.standard_normal((dc, n_cams)), dtype=dtype,
                            device=cuda)
        launches.reset_launch_counts()
        got = cam_kernels.e0_u(w, cam, x)
        torch.cuda.synchronize()
        label = "e0_u" if dtype == torch.float32 else "e0_u_f64"
        assert launches.launch_counts()[label] == 1
        assert torch.equal(got, cam_ref.e0_u(w, cam, x)), (n_cams, dc)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, n_cams", [(torch.float32, 60_000),
                                           (torch.float64, 30_000)])
def test_cam_gather_reads_rows_in_place_past_a_block(cuda, dtype, n_cams):
    """cam_gather where one row of the table does not fit a block's
    shared memory (its direct route), bit for bit, also one observation
    a thread (cam[1:])."""
    rng = np.random.default_rng(n_cams)
    table = torch.as_tensor(rng.standard_normal((12, n_cams)), dtype=dtype,
                            device=cuda)
    cam = torch.as_tensor(rng.integers(0, n_cams, O).astype(np.int32),
                          device=cuda)
    for c in (cam, cam[1:]):
        got = cam_kernels.cam_gather(table, c)
        torch.cuda.synchronize()
        assert torch.equal(got, cam_ref.cam_gather(table, c))


@pytest.mark.cuda
def test_cam_gather_and_scatter_past_2_31_entries(cuda):
    """cam_gather and cam_scatter_add in f32 on a [144, O] operand of
    more than 2^31 entries (64-bit offsets; ~8.6 GB each): the gather
    bit for bit index_select's, the sums within the per-camera tolerance
    of index_add_'s."""
    n, r = 13_682, 144
    o = 2**31 // r + 1
    gen = torch.Generator(device=cuda).manual_seed(11)
    cam = torch.randint(0, n, (o,), generator=gen, device=cuda,
                        dtype=torch.int32)
    table = torch.randn((r, n), generator=gen, device=cuda)
    cam64 = cam.long()
    got = cam_kernels.cam_gather(table, cam)
    assert r * got.shape[1] > 2**31
    assert torch.equal(got, table.index_select(1, cam64))
    sums = cam_kernels.cam_scatter_add(got, cam, n)
    want = torch.zeros((r, n), device=cuda).index_add_(1, cam64, got)
    _close("cam_scatter_add", sums, want, [CAM])


# ---- the device LM loop (solver/device_loop.py, csrc/lm.cu)

def _lm_cases():
    """(trial row, state vector) pairs of lm_step's edge cases: a plain
    accept and reject, l_diff = 0 (quality inf), a NaN l_diff, a NaN
    increment (ok = 0), a NaN cost (nv = 0), lambda at its floor, at its
    ceiling, the ftol test met, the last iteration (no relinearization)
    and a state with no valid observation (the average channel's 0)."""
    row = [10.0, 3.0, 9.0, 2.5, 100.0, 90.0]
    st = [1.0, 0.0, 1e-4, 2.0, 12.0, 4.0, 11.0, 3.0, 100.0, 90.0,
          12.0, 4.0, 11.0, 3.0, 100.0, 90.0]
    cases = []
    for trial, head in (
            ([1, 1, 2.5, 4], {}),
            ([1, 1, -2.5, 4], {}),
            ([1, 1, 0.0, 3], {}),
            ([1, 1, float("nan"), 2], {}),
            ([0, 1, 2.5, 5], {}),
            ([1, 0, 2.5, 5], {}),
            ([1, 1, 2.5, 1], {2: 1e-16}),
            ([1, 1, -2.5, 1], {2: 1e31, 3: 64.0}),
            ([1, 1, 2.5, 1], {8: 10.0 + 1e-9, 12: 9.0 + 1e-9}),
            ([1, 1, 2.5, 1], {0: 5.0}),
    ):
        s = list(st)
        for k, v in head.items():
            s[k] = v
        cases.append((torch.tensor(row + trial, dtype=torch.float64),
                      torch.tensor(s, dtype=torch.float64)))
    zero = torch.tensor(row[:5] + [0.0] + [1, 1, 2.5, 3],
                        dtype=torch.float64)
    s = torch.tensor(st, dtype=torch.float64)
    s[9] = 0.0
    cases.append((zero, s))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("oc", [0, 1, 2])
@pytest.mark.parametrize("step1", [1, 0])
def test_lm_step_matches_plain_version(cuda, oc, step1):
    """The bookkeeping kernel against its plain version on the card, on
    every edge case of `_lm_cases`, under each optimized_cost channel and
    both accept rules: state vector, trace row and flags equal bit for
    bit (f64 without FMA contraction; NaN where the plain version has
    NaN)."""
    p = lm_kernels.LmParams(min_lambda=1e-16, max_lambda=1e32, ftol=1e-6,
                            min_rel_dec=0.0, vee_factor=2.0,
                            initial_vee=2.0, T=5, oc=oc, step1=step1)
    for trial, st in _lm_cases():
        outs = []
        for fn in (lm_kernels.lm_step, lm_kernels.lm_step_ref):
            s = st.to(cuda)
            trace = torch.zeros((5, len(lm_kernels.TRACE_COLS)),
                                dtype=torch.float64, device=cuda)
            flags = torch.zeros(3, dtype=torch.bool, device=cuda)
            fn(trial.to(cuda), s, trace, flags, p)
            outs.append((s.cpu(), trace.cpu(), flags.cpu()))
        for got, want in zip(*outs):
            torch.testing.assert_close(got, want, rtol=0, atol=0,
                                       equal_nan=True)


@pytest.mark.cuda
def test_graph_while_and_if_nodes(cuda):
    """A program of nested loops captured into a CUDA graph (device_loop
    .capture: WHILE nodes, an IF node, temporaries made inside the
    bodies) and replayed twice gives the eager loops' result, and its
    region counts give each body's executions: outer K times, the IF
    every third pass, the inner loop 1 + 2 + ... + K times."""
    from povar_tpu_torch.solver.device_loop import (
        MAX_REGIONS, EagerControl, capture,
    )

    K = 7

    def program(ctl, x, acc):
        def body():
            x.add_(1)
            ctl.cond(x % 3 == 0, lambda: acc.add_(10))
            j = torch.zeros((), dtype=torch.int64, device=x.device)

            def inner():
                j.add_(1)
                acc.add_(j * 0 + 1)
                return j < x

            ctl.while_loop(j < x, inner)
            return x < K

        ctl.while_loop(x < K, body)

    x0 = torch.zeros((), dtype=torch.int64)
    a0 = torch.zeros((), dtype=torch.int64)
    program(EagerControl(), x0, a0)
    x = torch.zeros((), dtype=torch.int64, device=cuda)
    acc = torch.zeros((), dtype=torch.int64, device=cuda)
    counts = torch.zeros(MAX_REGIONS, dtype=torch.int64, device=cuda)
    g = capture(cuda, lambda ctl: program(ctl, x, acc), counts)
    assert [len(r) > 0 for r in g.control.regions] == [True] * 3
    for _ in range(2):
        x.zero_()
        acc.zero_()
        counts.zero_()
        g.launch()
        assert int(x) == int(x0) == K
        assert int(acc) == int(a0) == 10 * (K // 3) + K * (K + 1) // 2
        assert counts.tolist()[:3] == [K, K // 3, K * (K + 1) // 2]


def _small_f64(st1, **kw):
    problem = synthetic_bal_problem(n_cams=8, n_lms=60, obs_per_lm=5,
                                    seed=7, noise=0.01)[0]
    opts = SolverOptions(mixed_precision_solves=False,
                         max_num_iterations_step_1=12,
                         max_num_iterations_step_2=8, **kw)
    opts.solver_type_step_1 = SolverType[st1]
    return problem, opts


def _traj(summary):
    return [(it.step_is_successful, it.step_is_valid,
             it.linear_solver_iterations) for it in summary.iterations]


def _step_runs(solver_cls, optimize, args, state, opts):
    """The step with the host loop, then twice with the device loop on
    one solver (the second run replays the captured graph): (summary,
    launch counts, result) of each."""
    out = []
    solvers = {}
    for mode in ("off", "on", "on"):
        o = copy.deepcopy(opts)
        o.device_lm_loop = mode
        if mode not in solvers:
            solvers[mode] = solver_cls(*args, o, device="cuda")
        launches.reset_launch_counts()
        summary = SolverSummary()
        res = optimize(solvers[mode], *state, o, summary, Timer(),
                       log=lambda s: None)
        out.append((summary, launches.launch_counts(), res))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("st1, st2", [("POWER_VARPROJ", "RIPOBA"),
                                      ("POWER_SCHUR_COMPLEMENT", "RIPOBA"),
                                      ("PCG", "RIPCG")])
def test_device_loop_card_matches_host_loop_f64(cuda, st1, st2):
    """Pure f64 on the card, step 1 and then step 2 from the host loop's
    step-1 result: the device loop ("on") and the host loop ("off") take
    the same decisions, validity and inner counts, with accepted costs
    and trust radii within 1e-9 (f64 atomics in another order); a second
    device-loop run on the same solver replays the captured graph, and
    its launch counts, rebuilt from the graph's region counts, equal the
    host loop's kernel for kernel, but for the two lm kernels and the
    cost kernel, which the host loop runs once more (it evaluates the
    start state's cost at iteration 0 and again at the top of iteration
    1, as the reference does; the device loop evaluates it once)."""
    from povar_tpu_torch import Stage2Solver, optimize_step2

    problem, opts = _small_f64(st1)
    opts.solver_type_step_2 = SolverTypeRiemannian[st2]
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    cams = torch.as_tensor(problem.cam_space, device=cuda)
    lms = torch.as_tensor(problem.lm_p, device=cuda)
    steps = [_step_runs(Stage1Solver, optimize_step1, args, (cams, lms),
                        opts)]
    c1, l1 = steps[0][0][2]
    steps.append(_step_runs(Stage2Solver, optimize_step2, args,
                            create_homogeneous(c1, l1), opts))
    for cost, ((off, c_off, _r), (on, _c, _r2), (on2, c_on2, _r3)) in zip(
            ("pose_error", "pose_error2"), steps):
        for s in (on, on2):
            assert _traj(off) == _traj(s)
            for ia, ib in zip(off.iterations, s.iterations):
                if ia.step_is_successful:
                    np.testing.assert_allclose(
                        ib.cost.all.error, ia.cost.all.error, rtol=1e-9)
                np.testing.assert_allclose(
                    ib.trust_region_radius, ia.trust_region_radius,
                    rtol=1e-9)
        lm = set(lm_kernels.KERNELS)
        assert c_on2["lm_step"] == len(on2.iterations) - 1
        assert c_off["lm_step"] == 0
        want = {k: v for k, v in c_off.items() if k not in lm}
        want[cost] -= 1
        assert {k: v for k, v in c_on2.items() if k not in lm} == want
