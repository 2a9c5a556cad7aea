"""The port's plain MIXED-addition ladder against the JAX reference's
shamir_ladder_mixed (batch 3, canonical X, Y, Z bit-equal) and against
the port's projective ladder in affine form."""
import numpy as np
import pytest
import torch

from fabric_mod_tpu_torch.ops import limbs9 as TL
from fabric_mod_tpu_torch.ops import p256 as tp
from tests.test_torch_p256 import _inputs, _run_both


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain limb code is many small ops: one intra-op thread a
    worker keeps the tier-1 workers from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("edge", [0, 1])
def test_mixed_ladder_matches_reference(edge):
    want, got = _run_both(True, edge)
    for w, g, name in zip(want, got, "XYZ"):
        assert np.array_equal(w, g), name


def test_mixed_equals_projective_in_affine_form():
    u1, u2, qx, qy = (torch.from_numpy(a) for a in _inputs(0))
    fp = tp._consts()[0]
    rinv = pow(1 << TL.RBITS, -1, tp.P)

    def affine(xyz, lane):
        X, Y, Z = (TL.limbs_to_int(TL.canonical(c, fp)[:, lane]) * rinv % tp.P
                   for c in xyz)
        if Z == 0:
            return None
        zi = pow(Z, -1, tp.P)
        return (X * zi % tp.P, Y * zi % tp.P)

    proj = tp.shamir_ladder(u1, u2, qx, qy)
    mixed = tp.shamir_ladder_mixed(u1, u2, qx, qy)
    for lane in range(u1.shape[1]):
        assert affine(proj, lane) == affine(mixed, lane), lane
    assert affine(mixed, 0) is None
