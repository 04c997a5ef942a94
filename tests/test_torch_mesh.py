"""The process mesh of povar_tpu_torch/parallel/mesh.py on the CPU: gloo
ranks started by `spawn`, their all-reduce, and a failing rank, which
ends the run instead of leaving its peer waiting in a collective.

The ranks import this module, which imports no JAX, so each starts in a
few seconds.
"""

import time

import pytest
import torch

from povar_tpu_torch.parallel.mesh import spawn

# one torch thread a test process: the CPU tests' tensors are small,
# and a parallel run's xdist workers share the host's cores
torch.set_num_threads(1)


def _sum(mesh, x):
    t = torch.full((3,), float(mesh.rank + x))
    return mesh.all_reduce_(t).tolist(), mesh.rank, mesh.size


def _fail(mesh):
    if mesh.rank == 0:
        raise ValueError("rank 0 fails")
    # rank 1 waits for rank 0's part of the sum, which never comes
    return mesh.all_reduce_(torch.ones(3)).tolist()


def test_spawn_all_reduces_over_two_ranks():
    """Two gloo ranks meet (a file rendezvous, no port to race for) and
    sum their tensors; results come back in rank order."""
    assert spawn(_sum, 2, "cpu", args=(1,)) == [([3.0] * 3, 0, 2),
                                               ([3.0] * 3, 1, 2)]


def test_spawn_ends_the_run_when_a_rank_fails():
    """A rank that raises ends the run: spawn raises at once, with the
    failing rank's error or its peer's (whose collective lost the
    failing rank's connection), and the peer does not hold the run."""
    t0 = time.monotonic()
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 0 fails|all_reduce"):
        spawn(_fail, 2, "cpu")
    assert time.monotonic() - t0 < 60
