"""The block-commit differential of test_torch_txvalidator.py with
raw-message verify items: the port's MSP is built with
`raw_messages=True` (SHA-256 of each message computed by the verify
path, on the card in production), the reference runs with
FABRIC_MOD_TPU_FUSED_HASH on, the tensor policy off and on in both."""
import pytest
import torch

from tests.test_torch_txvalidator import (N_BLOCKS, check_expected,
                                          commit_world,
                                          run_port, run_reference)

from fabric_mod_tpu_torch.bccsp import gpu
from fabric_mod_tpu_torch.policy import tensorpolicy


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as in test_torch_txvalidator.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    ca_pems, policy, world, blocks, expected = commit_world(True)
    ref = {tensor: run_reference(ca_pems, policy, blocks,
                                 tmp_path_factory.mktemp("ref"), tensor,
                                 fused=True)
           for tensor in (False, True)}
    return world, blocks, expected, ref


class _RecordOnlyCache(gpu.VerdictCache):
    """Takes the verdicts written back but never answers a probe, so
    every block's lanes all miss."""

    def get_many(self, keys):
        return [None] * len(keys)


@pytest.fixture(scope="module")
def port(case):
    """The tensor arm with every lane a cache miss (every block's mask
    comes through the fused seam as a tensor, and its verdicts are
    written back at the host sync), then the closure arm answered from
    those verdicts."""
    world, blocks, _expected, _ref = case
    recorded = _RecordOnlyCache(4096)
    items = []
    real = gpu.marshal_items

    def recording(batch, size=None):
        items.extend(batch)
        return real(batch, size)
    tensorpolicy.reset_counts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gpu, "marshal_items", recording)
        tensor = run_port(world, blocks,
                          gpu.GpuVerifier(device="cpu", cache=recorded), True)
    passes = tensorpolicy.counts()
    cache = gpu.VerdictCache(4096)
    cache.put_many(list(recorded._od), list(recorded._od.values()))
    assert len(cache) == len(set(map(gpu.VerdictCache.key_of, items)))
    closure = run_port(world, blocks, gpu.GpuVerifier(
        device="cpu", cache=cache), False)
    assert cache.misses == 0
    return {True: tensor, False: closure}, items, passes


@pytest.mark.parametrize("tensor", [False, True])
def test_reference_flags_equal_expected(case, tensor):
    _world, _blocks, expected, ref = case
    check_expected(expected)
    assert ref[tensor][0] == expected
    assert ref[tensor][1] == ref[not tensor][1]


@pytest.mark.parametrize("tensor", [False, True])
def test_port_flags_and_fingerprint_equal_reference(case, port, tensor):
    _world, _blocks, expected, ref = case
    runs, _items, _passes = port
    flags, fp = runs[tensor]
    assert flags == expected
    assert fp == ref[False][1]


def test_port_raw_items_and_tensor_masks(port):
    """Every staged item carried its raw message, and every block's
    evaluator pass took the tensor mask."""
    _runs, items, passes = port
    assert items and all(it.message is not None and it.digest == b""
                         for it in items)
    assert passes == {"cpu": N_BLOCKS}


def test_raw_lanes_hash_into_the_packed_e_rows(case, monkeypatch):
    """On the CPU the raw route runs the SHA-256 kernel's plain twin
    (ops/sha256.sha256_e on CPU tensors) once per verify call: each raw
    lane's digest lands in the packed buffer's e rows, the lanes without
    a message keep theirs, and the block's flags are the fixture's."""
    import hashlib

    import numpy as np

    from fabric_mod_tpu_torch.ops import p256_core, sha256
    from fabric_mod_tpu_torch.protos import messages as m
    world, blocks, expected, _ref = case
    calls, items = [], []
    real_sha, real_marshal = sha256.sha256_e, gpu.marshal_items

    def recording_sha(words, nblocks, packed):
        before = packed.clone()
        out = real_sha(words, nblocks, packed)
        calls.append((words, before, packed.clone()))
        return out

    def recording_marshal(batch, size=None):
        items.append(list(batch))
        return real_marshal(batch, size)
    monkeypatch.setattr(sha256, "sha256_e", recording_sha)
    monkeypatch.setattr(gpu, "marshal_items", recording_marshal)
    launches = sha256.counts()
    committer = world.committer(gpu.GpuVerifier(device="cpu", cache_size=0))
    assert committer.store_block(m.Block.decode(blocks[0])) == expected[0]
    assert sha256.counts() == launches
    assert len(calls) == len(items) >= 1
    for (words, before, after), batch in zip(calls, items):
        assert words.device.type == "cpu" and words.dtype == torch.int32
        has_msg = p256_core.has_msg(after).numpy()
        assert has_msg[:len(batch)].all() and not has_msg[len(batch):].any()
        e = after[p256_core.ROW_E:p256_core.ROW_E + 8].numpy().view(np.uint32)
        for lane, item in enumerate(batch):
            value = sum(int(x) << (32 * k) for k, x in enumerate(e[:, lane]))
            assert value.to_bytes(32, "big") == \
                hashlib.sha256(item.message).digest()
        rest = torch.ones(p256_core.ROWS, dtype=torch.bool)
        rest[p256_core.ROW_E:p256_core.ROW_E + 8] = False
        assert torch.equal(after[rest], before[rest])
        assert torch.equal(after[:, len(batch):], before[:, len(batch):])
