"""The end-to-end differential of tests/test_torch_e2e.py with the
port's tensor-policy evaluator: every endorsement policy of a block
(the channel reference /Channel/Application/Endorsement, an implicit
meta policy over the orgs' signature policies) is decided in one
evaluator pass over the block's verify mask, which must be a CPU
tensor on both transaction blocks, with no evaluation falling back to
the closures.  Txflags, blocks and the state fingerprint must equal the
reference's."""
import torch

from fabric_mod_tpu_torch.bccsp import gpu
from fabric_mod_tpu_torch.policy import tensorpolicy
from tests import _torch_e2e_scenario as scenario


def test_e2e_tensor_policy_equals_reference(tmp_path, monkeypatch):
    torch.set_num_threads(1)
    tensorpolicy.reset_counts()
    # no verdict cache, so no block's mask can come back from the host
    scenario.run(tmp_path, monkeypatch,
                 gpu.GpuVerifier(device="cpu", buckets=(8, 64),
                                 cache_size=0),
                 tensor_policy=True)
    assert tensorpolicy.counts() == {"cpu": 2}
