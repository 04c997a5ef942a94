"""BAL dataset I/O: text parser, dataset randomizer, pipeline loader.

File formats (reference: src/rootba_povar/bal/bal_problem.cpp):

1. Original BAL text (load_bal_varproj_space_matrix_write input,
   cpp:306-471): header `num_cams num_lms num_obs`, then num_obs lines
   `cam_idx lm_idx u v`, then 9 numbers per camera (Rodrigues rotation,
   translation, f, k1, k2), then 3 numbers per landmark.

2. "data_custom" randomized format (what --create-dataset writes and
   load_bal_eccv reads, cpp:182-303): same header/observation section
   (y NOT inverted on disk), then 15 numbers per camera (12 row-major
   space-matrix entries, then f, k1, k2), then 3 numbers per landmark.

Dataset creation (cpp:306-471) replaces all camera parameters with
N(0,1) draws for the first two space-matrix rows and sets the third row
to [0, 0, 0, 1] — the "initialization-free" random projective start.
The reference seeds from std::random_device (non-reproducible); we use a
seeded numpy Generator so runs are reproducible, which only changes
*which* random instance you get, not its distribution.

On load (load_bal_eccv, cpp:258-266) landmarks are re-drawn N(0,1); the
y image axis is inverted in memory (cpp:236-244).

A copy of povar_tpu/problem/bal_io.py (this package never imports jax
or povar_tpu). It tokenizes natively (csrc/bal_io.cpp, built at first
use by utils/native.py; a failed build raises), as the JAX package does
where its library is built; `numpy_tokens` is the plain version the
native tokenizer is held to. `create_dataset` writes the same bytes as
the JAX package's for the same seed.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from povar_tpu_torch.options import BalDatasetOptions
from povar_tpu_torch.problem.problem import BalProblem, DatasetSummary
from povar_tpu_torch.utils import native
from povar_tpu_torch.utils.timer import Timer


def numpy_tokens(path: str) -> np.ndarray:
    """The numpy tokenizer: every whitespace-separated token of the file
    as f64 (the native tokenizer's plain version)."""
    with open(path, "rb") as f:
        data = f.read()
    return np.array(data.split(), dtype=np.float64)


def _read_tokens(path: str) -> np.ndarray:
    """Whitespace-separated numeric tokens of the whole file (the BAL
    grammar is whitespace-insensitive, like the reference's fscanf),
    parsed natively."""
    if not os.path.exists(path):
        # clear message instead of a tokenizer traceback (the reference
        # LOG(FATAL)s "Could not open '{}'", bal_problem.cpp:187-189)
        raise FileNotFoundError(f"Could not open '{path}'")
    return native.parse_tokens(path)


def _split_header_obs(
    tokens: np.ndarray,
) -> Tuple[int, int, int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    num_cams = int(tokens[0])
    num_lms = int(tokens[1])
    num_obs = int(tokens[2])
    obs = tokens[3 : 3 + 4 * num_obs].reshape(num_obs, 4)
    obs_cam = obs[:, 0].astype(np.int32)
    obs_lm = obs[:, 1].astype(np.int32)
    obs_uv = np.ascontiguousarray(obs[:, 2:4])
    rest = tokens[3 + 4 * num_obs :]
    return num_cams, num_lms, num_obs, obs_cam, obs_lm, obs_uv, rest


def _camera_arity(tokens: np.ndarray) -> Optional[int]:
    """Numbers per camera implied by the token count: 9 for original
    BAL text (Rodrigues+translation+f,k1,k2), 15 for the randomized
    data_custom format (12 space-matrix entries+f,k1,k2). None if the
    file matches neither grammar."""
    if len(tokens) < 3:
        return None
    n_c, n_l, n_o = int(tokens[0]), int(tokens[1]), int(tokens[2])
    if n_c <= 0 or n_l < 0 or n_o < 0:
        return None
    body = len(tokens) - 3 - 4 * n_o - 3 * n_l
    if body % n_c == 0 and body // n_c in (9, 15):
        return body // n_c
    return None


def autodetect_input_type(path: str) -> str:
    """Content-based input detection. The reference's
    autodetect_input_type (bal_problem.cpp:131-133) unconditionally
    returns BAL and relies on the user passing the right file; here
    AUTO inspects the camera-block arity so an original BAL file fed
    without --create-dataset errors clearly instead of misparsing
    silently (VERDICT r3 #3). Returns "BAL" (original, 9/camera) or
    "ECCV" (data_custom, 15/camera)."""
    arity = _camera_arity(_read_tokens(path))
    if arity == 9:
        return "BAL"
    if arity == 15:
        return "ECCV"
    raise ValueError(
        f"'{path}' matches neither the original BAL grammar (9 numbers "
        "per camera) nor the data_custom grammar (15 numbers per "
        "camera); token count is inconsistent with its header"
    )


def _check_arity(tokens: np.ndarray, path: str, expected: int, fmt: str):
    arity = _camera_arity(tokens)
    if arity != expected:
        raise ValueError(
            f"'{path}' is not a {fmt} file ({expected} numbers per "
            f"camera): detected camera arity {arity}. "
            + (
                "This looks like an original BAL problem — run with "
                "--create-dataset first (or set "
                "--dataset-input-type BAL) to randomize it into the "
                "data_custom format."
                if arity == 9
                else "Pass the correct --dataset-input-type or check "
                "the file."
            )
        )


def load_bal_text(path: str) -> Tuple[int, int, int, np.ndarray, np.ndarray,
                                      np.ndarray, np.ndarray, np.ndarray]:
    """Parse an original BAL text problem; returns
    (n_cams, n_lms, n_obs, obs_cam, obs_lm, obs_uv, cam_params9, lm_p)."""
    tokens = _read_tokens(path)
    _check_arity(tokens, path, 9, "original BAL text")
    n_c, n_l, n_o, obs_cam, obs_lm, obs_uv, rest = _split_header_obs(tokens)
    cam_params = rest[: 9 * n_c].reshape(n_c, 9)
    lm_p = rest[9 * n_c : 9 * n_c + 3 * n_l].reshape(n_l, 3)
    return n_c, n_l, n_o, obs_cam, obs_lm, obs_uv, cam_params, lm_p


def create_dataset(
    input_path: str,
    output_dir: str = "data_custom",
    seed: Optional[int] = 38401,
) -> str:
    """--create-dataset: read original BAL text, randomize cameras, write
    the data_custom file (bal_problem.cpp:306-471). Returns output path.

    Writes the same format as the reference binary so either solver can
    consume the produced file. Camera randomization: 15 N(0,1) draws per
    camera of which the first 8 fill space-matrix rows 0-1; row 2 is
    [0,0,0,1]; intrinsics keep the original BAL f, k1, k2.

    Note the reference draws 15 values but uses only rows 0-1 from them
    (cpp:398-409); we reproduce the written *format*, not the RNG stream.
    """
    n_c, n_l, n_o, obs_cam, obs_lm, obs_uv, cam_params, lm_p = load_bal_text(
        input_path
    )
    rng = np.random.default_rng(seed)
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, os.path.basename(input_path))

    cams15 = rng.standard_normal((n_c, 15))
    space = np.zeros((n_c, 3, 4))
    space[:, 0, :] = cams15[:, 0:4]
    space[:, 1, :] = cams15[:, 4:8]
    space[:, 2, :] = np.array([0.0, 0.0, 0.0, 1.0])

    with open(out_path, "w") as f:
        f.write(f"{n_c} {n_l} {n_o}")
        for i in range(n_o):
            f.write(
                f"\n{obs_cam[i]} {obs_lm[i]} "
                f"{obs_uv[i, 0]:.6f} {obs_uv[i, 1]:.6f}"
            )
        for i in range(n_c):
            for v in space[i].reshape(12):
                f.write(f"\n{v:.6f}")
            for v in cam_params[i, 6:9]:
                f.write(f"\n{v:.6f}")
        for i in range(n_l):
            for v in lm_p[i]:
                f.write(f"\n{v:.6f}")
        f.write("\n")
    return out_path


def load_bal_eccv(path: str, seed: Optional[int] = 38401) -> BalProblem:
    """Load a data_custom problem (bal_problem.cpp:182-303): obs y-axis
    inverted, landmarks re-drawn N(0,1), space matrices from file."""
    tokens = _read_tokens(path)
    _check_arity(tokens, path, 15, "data_custom (ECCV)")
    n_c, n_l, n_o, obs_cam, obs_lm, obs_uv, rest = _split_header_obs(tokens)
    cam_params = rest[: 15 * n_c].reshape(n_c, 15)
    # landmark values on disk are ignored (re-randomized below)
    cam_space = np.ascontiguousarray(cam_params[:, :12].reshape(n_c, 3, 4))
    intrinsics = np.ascontiguousarray(cam_params[:, 12:15])

    obs_uv = obs_uv.copy()
    obs_uv[:, 1] = -obs_uv[:, 1]  # invert y axis (cpp:236-244)

    rng = np.random.default_rng(seed)
    lm_p = rng.standard_normal((n_l, 3))

    problem = BalProblem(
        cam_space=cam_space,
        intrinsics=intrinsics,
        lm_p=lm_p,
        obs_cam=obs_cam,
        obs_lm=obs_lm,
        obs_uv=obs_uv,
        input_path=path,
    )
    problem.sort_observations()
    return problem


def load_normalized_bal_problem(
    options: BalDatasetOptions,
    dataset_summary: Optional[DatasetSummary] = None,
    timing: Optional[dict] = None,
) -> BalProblem:
    """Pipeline loader (bal_problem.cpp:873-955): resolve input type,
    load, normalize, perturb, filter. If options.create_dataset, writes
    data_custom and raises SystemExit(0) like the reference
    (cpp:899-903).

    input_type semantics: AUTO detects by camera-block arity
    (autodetect_input_type); BAL means an original 9-number file (valid
    only with --create-dataset); ECCV means a randomized data_custom
    15-number file. The reference's AUTO always resolves to BAL
    (bal_problem.cpp:131-133) and misparses mismatched files; here a
    mismatch errors with instructions instead."""
    t = Timer()
    input_type = (options.input_type or "AUTO").upper()
    if input_type not in ("AUTO", "BAL", "ECCV"):
        raise ValueError(
            f"unknown input_type '{options.input_type}' "
            "(expected AUTO, BAL or ECCV)"
        )
    if input_type == "AUTO":
        input_type = autodetect_input_type(options.input)

    if options.create_dataset:
        if input_type != "BAL":
            raise ValueError(
                f"--create-dataset expects an original BAL file but "
                f"'{options.input}' is data_custom (15 numbers per "
                "camera) — it is already randomized"
            )
        create_dataset(options.input, seed=options.random_seed)
        raise SystemExit(0)
    if input_type == "BAL":
        raise ValueError(
            f"'{options.input}' is an original BAL problem (9 numbers "
            "per camera); the solver consumes the randomized "
            "data_custom format — run with --create-dataset first "
            "(bal_problem.cpp:897-903 semantics)"
        )
    problem = load_bal_eccv(options.input, seed=options.random_seed)
    load_time = t.reset()

    if options.normalize:
        problem.normalize(options.normalization_scale)
    problem.perturb(
        options.rotation_sigma,
        options.translation_sigma,
        options.point_sigma,
        options.random_seed,
    )
    problem.filter_obs(options.init_depth_threshold)
    preprocess_time = t.reset()

    if timing is not None:
        timing["load_time"] = load_time
        timing["preprocess_time"] = preprocess_time
    if dataset_summary is not None:
        s = problem.summarize(compute_sparsity=True)
        dataset_summary.__dict__.update(s.__dict__)
    return problem
