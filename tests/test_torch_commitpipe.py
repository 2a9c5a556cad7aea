"""The pipelined committer against the synchronous path.

Three encoded blocks from utils/fixtures.make_commit_blocks (every
planted invalid kind, and a VALIDATION_PARAMETER pin in block 1 that
forces a barrier) go through the port's synchronous Committer and
through `PipelinedCommitter` at depths 1 and 2 over a
`ValidatorCommitTarget`: the txflags must equal the fixture's and the
state fingerprints must be equal.  Depth 2 also runs with the
GpuVerifier on the CPU and the tensor-policy evaluator, so a verify
mask made on the stage thread is consumed on the commit thread.

A block whose staging raises must surface that error to its caller and
poison the pipe; the channel's next `store_block` rebuilds the pipe
from the committed height and commits.
"""
import pytest
import torch

from fabric_mod_tpu_torch.bccsp import gpu, sw
from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
from fabric_mod_tpu_torch.e2e import _signer
from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder
from fabric_mod_tpu_torch.peer.channel import Channel
from fabric_mod_tpu_torch.peer.commitpipe import (PipelinedCommitter,
                                                  ValidatorCommitTarget)
from fabric_mod_tpu_torch.policy import tensorpolicy
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures

N_BLOCKS, N_TX = 3, 16
V = m.TxValidationCode


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def fixture_blocks():
    world = fixtures.make_commit_world()
    blocks, expected = fixtures.make_commit_blocks(world, N_BLOCKS, N_TX)
    sync = world.committer(sw.SwVerifier())
    flags = [sync.store_block(m.Block.decode(raw)) for raw in blocks]
    assert flags == expected
    return world, blocks, expected, sync.ledger.state_fingerprint()


@pytest.mark.parametrize("depth, device_verify", [
    (1, False), (2, False), (2, True)])
def test_pipeline_equals_synchronous_commit(fixture_blocks, depth,
                                            device_verify):
    world, blocks, expected, fingerprint = fixture_blocks
    # no verdict cache: a cross-block repeat would otherwise hit it and
    # hand that block a host mask
    verifier = (gpu.GpuVerifier(device="cpu", buckets=(64,), cache_size=0)
                if device_verify else sw.SwVerifier())
    committer = world.committer(verifier, tensor_policy=device_verify)
    target = ValidatorCommitTarget(committer.validator, committer.ledger)
    tensorpolicy.reset_counts()
    pipe = PipelinedCommitter(target, depth=depth)
    try:
        decoded = [m.Block.decode(raw) for raw in blocks]
        for block in decoded:
            pipe.submit(block)
        assert pipe.flush(timeout_s=120)
    finally:
        pipe.close()
    assert pipe.error is None
    assert [list(protoutil.block_txflags(b)) for b in decoded] == expected
    assert committer.ledger.state_fingerprint() == fingerprint
    if device_verify:
        # the evaluator got the CPU tensor mask of every block
        assert tensorpolicy.counts() == {"cpu": N_BLOCKS}
    assert pipe.stage_secs > 0 and pipe.commit_secs > 0


@pytest.fixture(scope="module")
def network():
    """A seeded genesis and two chained 2-tx blocks of valid 2-of-3
    endorsed puts on it."""
    mat = fixtures.make_network_material(5)
    csp = sw.SwCSP()
    genesis = m.Block.decode(mat.genesis)
    cid, _ = config_from_block(genesis)
    client = _signer(csp, mat.client)
    peers = [_signer(csp, p) for p in mat.peers.values()]
    blocks, prev = [], protoutil.block_header_hash(genesis.header)
    for b in (1, 2):
        envs = []
        for j in range(2):
            rw = RWSetBuilder()
            rw.add_write("mycc", f"b{b}t{j}", b"v")
            envs.append(protoutil.create_signed_tx(
                cid, "mycc", rw.build().encode(), client, peers[j:j + 2]))
        block = protoutil.new_block(b, prev, envs)
        prev = protoutil.block_header_hash(block.header)
        blocks.append(block.encode())
    return mat, blocks


def _channel(network, pipeline_depth):
    """A fresh channel (SwVerifier, in-memory ledger) on the genesis,
    and fresh copies of the blocks."""
    mat, blocks = network
    csp = sw.SwCSP()
    genesis = m.Block.decode(mat.genesis)
    cid, cfg = config_from_block(genesis)
    channel = Channel(cid, KvLedger(cid), sw.SwVerifier(),
                      Bundle(cid, cfg, csp), csp,
                      pipeline_depth=pipeline_depth)
    channel.init_from_genesis(genesis)
    return channel, [m.Block.decode(raw) for raw in blocks]


def test_stage_error_surfaces_and_the_pipe_is_rebuilt(network):
    channel, (b1, b2) = _channel(network, pipeline_depth=2)
    real_stage = channel.stage_block

    def failing_stage(block):
        if block.header.number == 1:
            raise RuntimeError("staging failed")
        return real_stage(block)
    channel.stage_block = failing_stage
    try:
        with pytest.raises(RuntimeError, match="staging failed"):
            channel.store_block(b1)
        poisoned = channel._commit_pipe
        assert isinstance(poisoned.error, RuntimeError)
        with pytest.raises(RuntimeError, match="staging failed"):
            poisoned.submit(b1)            # the error is sticky
        assert channel.ledger.height == 1
        channel.stage_block = real_stage
        assert channel.store_block(b1) == [V.VALID, V.VALID]
        assert channel.commit_pipeline() is not poisoned
        assert channel.store_block(b2) == [V.VALID, V.VALID]
        assert channel.ledger.height == 3
    finally:
        channel.close()


def test_synchronous_channel_matches_pipelined_channel(network):
    sync, blocks = _channel(network, pipeline_depth=0)
    piped, again = _channel(network, pipeline_depth=1)
    try:
        for block, copy in zip(blocks, again):
            assert sync.store_block(block) == piped.store_block(copy) == \
                [V.VALID, V.VALID]
        assert sync.ledger.state_fingerprint() == \
            piped.ledger.state_fingerprint()
        assert sync.commit_pipeline() is None
    finally:
        piped.close()
