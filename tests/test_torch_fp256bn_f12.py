"""The port's Fp12 operations (fabric_mod_tpu_torch/ops/fp256bn_dev.py) against
the JAX reference's (fabric_mod_tpu/ops/fp256bn_dev.py), run eagerly on
the same seeded numpy inputs: limb planes equal with np.array_equal.
(Split from test_torch_fp256bn_dev.py so the two spread over workers.)"""
import random

import pytest
import torch

from fabric_mod_tpu.ops import fp256bn_dev as J
from fabric_mod_tpu_torch.ops import fp256bn_dev as T
from tests._torch_fp256bn_planes import (
    _planes, assert_planes_equal, j12, leaves12, t12)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_F12_OPS = {
    "mul": (lambda x, y: T.f12_mul(x, y), lambda x, y: J.f12_mul(x, y)),
    "sqr": (lambda x, y: T.f12_sqr(x), lambda x, y: J.f12_sqr(x)),
    "inv": (lambda x, y: T.f12_inv(x), lambda x, y: J.f12_inv(x)),
    "frobenius": (lambda x, y: T.f12_frobenius(x),
                  lambda x, y: J.f12_frobenius(x)),
    # lazy (non-canonical) limbs in: a product of products
    "lazy": (lambda x, y: T.f12_mul(T.f12_sqr(x), T.f12_mul(x, y)),
             lambda x, y: J.f12_mul(J.f12_sqr(x), J.f12_mul(x, y))),
}


@pytest.mark.parametrize("op", sorted(_F12_OPS))
def test_fp12_ops_bit_equal(op):
    rng = random.Random(23)
    x, y = _planes(rng, 12), _planes(rng, 12)
    port, ref = _F12_OPS[op]
    assert_planes_equal(leaves12(port(t12(x), t12(y))), ref(j12(x), j12(y)))
