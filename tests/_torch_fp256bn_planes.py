"""Seeded limb planes and layout helpers shared by the FP256BN pairing
differentials: the port's (K, 2, 3, 2, batch) tower tensors against the
reference's nested tuples of (K, batch) planes."""
import numpy as np
import torch

from fabric_mod_tpu_torch.idemix import fp256bn as host
from fabric_mod_tpu_torch.ops import fp256bn_dev as T

P = host.P
BATCH = 2


def _planes(rng, n):
    """n random Montgomery-form Fp values per lane: (n, K, BATCH) f32."""
    return np.stack([np.stack([T._mont_np(rng.randrange(P))
                               for _ in range(BATCH)], -1)
                     for _ in range(n)])


def t2(a):                              # (2, K, B) numpy -> (K, 2, B)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, 0, 1)))


def t6(a):                              # (6, K, B): c0.a c0.b c1.a ...
    return torch.stack([t2(a[2 * i:2 * i + 2]) for i in range(3)], 2)


def t12(a):
    return torch.stack([t6(a[:6]), t6(a[6:])], 3)


def j2(a):
    return (a[0], a[1])


def j6(a):
    return tuple(j2(a[2 * i:2 * i + 2]) for i in range(3))


def j12(a):
    return (j6(a[:6]), j6(a[6:]))


def leaves2(t):
    return [t[:, 0], t[:, 1]]


def leaves6(t):
    return [x for i in range(3) for x in leaves2(t[:, :, i])]


def leaves12(t):
    return leaves6(t[:, :, :, 0]) + leaves6(t[:, :, :, 1])


def jleaves(x):
    if isinstance(x, tuple):
        return [leaf for c in x for leaf in jleaves(c)]
    return [np.asarray(x)]


def assert_planes_equal(port_leaves, ref):
    ref_leaves = jleaves(ref)
    assert len(port_leaves) == len(ref_leaves)
    for i, (p, r) in enumerate(zip(port_leaves, ref_leaves)):
        assert np.array_equal(p.numpy(), r), f"limb plane {i} differs"


