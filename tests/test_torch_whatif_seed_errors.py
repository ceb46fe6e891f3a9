"""``LinkFailureSweep.seed_base_from`` (``openr_tpu_torch/ops/whatif.py``)
warm-starts a generation's base solve from the previous generation's plan.
An old generation that cannot give a plan leaves the new one cold, as in
the reference (``openr_tpu/ops/whatif.py:210-212``), but a kernel that
fails to build, load or launch (``kernels/build.py`` ``KernelError``) is no
such generation: the error reaches the caller, so a broken kernel never
hides behind a cold start.

CPU cases: the old generation's base solve fails in ``check_launch`` (a
refused launch) or in the kernel build (no nvcc), and ``seed_base_from``
raises; its plan fails otherwise, and the new engine starts cold and
solves the same base as the reference engine.
"""

import numpy as np
import pytest

from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.emulation.topology import build_adj_dbs, grid_edges
from openr_tpu_torch.kernels import build
from openr_tpu_torch.kernels.build import KernelError, check_launch
from openr_tpu_torch.ops import csr
from openr_tpu_torch.ops import whatif as twhatif


def grid_topo(side=4, bump=0):
    """A side x side grid from node0, one link raised by ``bump``."""
    edges = [(a, b, w + (bump if (a, b) == ("node0", "node1") else 0))
             for a, b, w in grid_edges(side)]
    ls = LinkState("0", "node0")
    for db in build_adj_dbs(edges).values():
        ls.update_adjacency_database(db)
    return csr.encode_link_state(ls)


def generations():
    old = twhatif.LinkFailureSweep(grid_topo(), "node0", device="cpu")
    new = twhatif.LinkFailureSweep(grid_topo(bump=3), "node0", device="cpu")
    return old, new


def test_kernel_error_is_a_runtime_error():
    """Callers that catch RuntimeError (a launcher's refusal) still do."""
    with pytest.raises(RuntimeError):
        check_launch("sweep_spf_link_failures", 1)
    assert issubclass(KernelError, RuntimeError)


def test_seed_base_from_propagates_a_refused_launch(monkeypatch):
    """The old generation's base solve reaches a kernel whose launch is
    refused: ``seed_base_from`` raises the kernel's error."""
    old, new = generations()

    def refused(*args, **kwargs):
        check_launch("sweep_spf_link_failures", 1)  # cudaErrorInvalidValue

    monkeypatch.setattr(twhatif, "sweep_spf_link_failures", refused)
    with pytest.raises(KernelError, match="sweep_spf_link_failures"):
        new.seed_base_from(old)
    assert new.base_source == "unset"


def test_seed_base_from_propagates_a_failed_build(monkeypatch):
    """The old generation's base solve needs a kernel that cannot be built
    (no nvcc): ``seed_base_from`` raises the build's error."""
    old, new = generations()
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(build.os.environ, "get", lambda *_a: None)
    monkeypatch.setattr(build.Path, "exists", lambda _self: False)

    def needs_a_build(*args, **kwargs):
        build.build_all()

    monkeypatch.setattr(twhatif, "sweep_spf_link_failures", needs_a_build)
    with pytest.raises(KernelError, match="nvcc not found"):
        new.seed_base_from(old)


def test_seed_base_from_an_unusable_generation_starts_cold(monkeypatch):
    """An old generation whose plan fails otherwise leaves the new engine
    cold; its base is the cold solve, equal to the reference's."""
    from openr_tpu.decision.link_state import LinkState as RefLinkState
    from openr_tpu.emulation import topology as jtopo
    from openr_tpu.ops.csr import encode_link_state
    from openr_tpu.ops.whatif import LinkFailureSweep as RefSweep

    old, new = generations()

    def unusable():
        raise ValueError("the old generation's tables are gone")

    monkeypatch.setattr(old, "plan", unusable)
    assert new.seed_base_from(old) is False
    dist, nh = new.base_solve()
    assert new.base_source == "device"
    edges = [(a, b, w + (3 if (a, b) == ("node0", "node1") else 0))
             for a, b, w in jtopo.grid_edges(4)]
    ls = RefLinkState("0", "node0")
    for db in jtopo.build_adj_dbs(edges).values():
        ls.update_adjacency_database(db)
    ref_dist, ref_nh = RefSweep(encode_link_state(ls), "node0").base_solve()
    assert np.array_equal(dist, np.asarray(ref_dist)) and np.array_equal(nh, np.asarray(ref_nh))


def test_seed_base_from_a_usable_generation_still_seeds():
    """The repair leaves the warm seed in place where the old plan works."""
    old, new = generations()
    assert new.seed_base_from(old) is True
