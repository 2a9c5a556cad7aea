"""convert.py: the reference's constants and device-layout inputs carried
into the port's tensors and back; the port's self-built constants equal
the reference's after conversion."""
import numpy as np
import torch

from fabric_mod_tpu.ops import p256 as jp
from fabric_mod_tpu_torch import convert
from fabric_mod_tpu_torch.ops import p256 as tp


def test_constants_equal_reference():
    fp, fn, _, _, _ = jp._consts()
    ref = convert.constants_from_reference(
        {"p256.p": convert.fieldspec_arrays(fp),
         "p256.n": convert.fieldspec_arrays(fn)},
        jp._g_table(), jp._g_table_affine())
    tfp, tfn, _, _, _ = tp._consts()
    port = convert.constants_from_reference(
        {"p256.p": convert.fieldspec_arrays(tfp),
         "p256.n": convert.fieldspec_arrays(tfn)},
        tp._g_table(), tp._g_table_affine())
    assert ref["fields"].keys() == port["fields"].keys()
    for field, arrays in ref["fields"].items():
        for name, t in arrays.items():
            assert torch.equal(t, port["fields"][field][name]), (field, name)
    assert torch.equal(ref["g_table"], port["g_table"])
    assert torch.equal(ref["g_table_affine"], port["g_table_affine"])


def test_limb_and_window_planes_round_trip():
    rng = np.random.default_rng(9)
    limbs = rng.integers(-273, 274, (30, 5)).astype(np.float32)
    windows = rng.integers(0, 16, (64, 5)).astype(np.int32)
    tl = convert.limbs_from_reference(limbs)
    tw = convert.limbs_from_reference(windows)
    assert tl.dtype == torch.float32 and tw.dtype == torch.int32
    assert np.array_equal(convert.limbs_to_reference(tl), limbs)
    assert np.array_equal(convert.limbs_to_reference(tw), windows)
