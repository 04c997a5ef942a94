"""povar_tpu_torch/tools/parity.py, the comparison that holds every CUDA
kernel to its plain version on the card (chip_smoke.py,
tests/test_torch_cuda.py): a few entries a million times larger than
the rest must not hide a wrong typical entry or camera. CPU only, no
JAX; well under a second.
"""

import numpy as np
import pytest
import torch

from povar_tpu_torch.tools.parity import scaled_error

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)


def _typical_with_outlier(shape, seed=0):
    """Seeded entries of magnitude ~1 with one entry of 1e10."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.5, shape) * rng.choice([-1.0, 1.0], shape)
    a.reshape(-1)[3] = 1e10
    return torch.as_tensor(a)


@pytest.mark.parametrize("kind, shape", [("elem", (3, 500)),
                                         ("cam", (12, 9))])
def test_outlier_does_not_hide_a_wrong_typical_entry(kind, shape):
    want = _typical_with_outlier(shape)
    got = want.clone()
    got[-1, -1] += 1e-3  # a typical entry off by ~1e-3 relative
    assert scaled_error(got, want, kind) > 1e-4
    # a bound relative to the whole output's largest entry misses it
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("kind, shape", [("elem", (3, 500)),
                                         ("cam", (12, 9)),
                                         ("scalar", ())])
def test_rounding_level_differences_pass(kind, shape):
    want = (_typical_with_outlier(shape) if shape
            else torch.tensor(123.456, dtype=torch.float64))
    got = (want.float().double() * (1 + 1e-7)).float()
    assert scaled_error(got, want, kind) <= 1e-6


def test_cam_scales_each_camera_by_its_own_largest_entry():
    want = torch.ones(4, 3, dtype=torch.float64)
    want[:, 0] = 1e10
    got = want.clone()
    got[2, 0] += 1e3  # 1e-7 of camera 0
    got[1, 2] += 1e-3  # 1e-3 of camera 2
    assert scaled_error(got, want, "cam") == pytest.approx(1e-3)
    got[1, 2] = want[1, 2]
    assert scaled_error(got, want, "cam") == pytest.approx(1e-7)


def test_exact_zero_scale_and_agreement():
    counts = torch.tensor([5, 0, 7])
    assert scaled_error(counts, counts.clone(), "exact") == 0.0
    assert scaled_error(counts + torch.tensor([0, 0, 1]), counts,
                        "exact") == 1.0
    zeros = torch.zeros(2, 8)
    assert scaled_error(zeros, zeros, "elem") == 0.0
    off = zeros.clone()
    off[0, 0] = 1e-30
    assert scaled_error(off, zeros, "elem") == float("inf")


def test_rejects_what_cannot_be_compared():
    a = torch.ones(2, 3)
    with pytest.raises(ValueError, match="shape"):
        scaled_error(a, torch.ones(3, 2), "elem")
    bad = a.clone()
    bad[0, 0] = float("nan")
    with pytest.raises(ValueError, match="non-finite"):
        scaled_error(bad, a, "elem")
    with pytest.raises(ValueError, match="kind"):
        scaled_error(a, a, "max")
