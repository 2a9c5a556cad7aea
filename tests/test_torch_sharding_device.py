"""The channel-sharding acceptance differential with the port's device
verifier: 3 channels x 3 blocks x 3 txs through a ChannelShardRouter of
2 slices, each slice a `GpuVerifier(device="cpu")` (the plain PyTorch
verify path), blocks submitted round robin.  Per channel, the txflags
and state fingerprint must equal the reference router's
(FakeBatchVerifier(SwCSP()) slices, on the same encoded blocks) and an
independent unsharded run's.  Its own file: the plain verify costs
seconds a call on the CPU and this run makes nine.  The two slices'
verifiers share one enqueue lock here: the plain path is Python-bound
under one interpreter lock, and two such calls at once take twice as
long as one after the other."""
import threading

import pytest
import torch

from fabric_mod_tpu_torch.bccsp import gpu
from tests import _torch_sharding_world as W


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the CPU verify is thousands of small ops."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_sharded_device_verifier_run_equals_reference_and_independent_runs(
        tmp_path):
    port_world, ref = W.make_world()
    streams = W.make_streams(port_world)
    reference = W.reference_router_run(ref, streams, tmp_path)
    baseline = W.make_baseline(port_world, streams)
    one_at_a_time = threading.Lock()

    def slice_verifier(_index, _mesh):
        v = gpu.GpuVerifier(device="cpu", cache_size=0, buckets=(16,))
        v._enqueue = one_at_a_time
        return v
    got = W.sharded_run(port_world, streams, slice_verifier)
    W.check_sharded(got, reference, baseline)
