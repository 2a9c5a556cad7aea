"""The block-commit path, port against reference: the same encoded
blocks go through the JAX package's TxValidator (with
FakeBatchVerifier(SwCSP()), the FABRIC_MOD_TPU_TENSOR_POLICY knob off
and on) and KvLedger, and through the port's TxValidator (GpuVerifier on
the CPU, `tensor_policy` off and on) and KvLedger.  Per-block
txflags must equal the fixture's expected flags in every arm, and after
the three blocks every ledger gives the same state fingerprint.

The world's certificates and keys are issued by the reference's CA and
carried across as bytes (convert.world_from_reference); the blocks are
signed by the port's fixtures (make_commit_blocks: every planted invalid
kind and a VALIDATION_PARAMETER pin).  This file runs digest items over
two 32-lane buckets per block; test_torch_txvalidator_raw.py runs the
raw-message items (the FABRIC_MOD_TPU_FUSED_HASH knob on the reference
side)."""
import pytest
import torch

from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu_torch import convert
from fabric_mod_tpu_torch.bccsp import gpu
from fabric_mod_tpu_torch.policy import tensorpolicy
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.utils import fixtures

N_BLOCKS, N_TX = 3, 16
V = m.TxValidationCode


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the CPU verify is thousands of small ops,
    which run no faster on more threads and far slower when several
    test processes share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reference_world_pems():
    """The reference's three-org world (its CA, over `cryptography`) as
    plain bytes."""
    from fabric_mod_tpu.msp import ca as jca
    from fabric_mod_tpu.policy import from_string
    cas, signers = {}, {}
    for org in ("Org1", "Org2", "Org3"):
        cas[org] = jca.CA(f"ca.{org.lower()}", org)
        cert, key = cas[org].issue(f"peer0.{org.lower()}", org, ous=["peer"])
        signers[org] = (org, jca.cert_pem(cert), jca.key_pem(key))
    cert, key = cas["Org1"].issue("client@org1", "Org1", ous=["client"])
    signers["client"] = ("Org1", jca.cert_pem(cert), jca.key_pem(key))
    policy = jm.ApplicationPolicy(signature_policy=from_string(
        fixtures.ENDORSEMENT_POLICY)).encode()
    return {o: ca.cert_pem() for o, ca in cas.items()}, signers, policy


def run_reference(ca_pems, policy, blocks, root, tensor, fused):
    """The reference TxValidator + KvLedger over `blocks`, knobs set as
    given: (per-block flags, state fingerprint)."""
    from fabric_mod_tpu.bccsp.sw import SwCSP
    from fabric_mod_tpu.bccsp.tpu import FakeBatchVerifier
    from fabric_mod_tpu.ledger import KvLedger
    from fabric_mod_tpu.msp.cache import CachedMsp
    from fabric_mod_tpu.msp.identities import deserialize_cert
    from fabric_mod_tpu.msp.mspimpl import Msp, MspManager
    from fabric_mod_tpu.peer import Committer, TxValidator, \
        ValidationInfoProvider
    from fabric_mod_tpu.peer.txvalidator import VALIDATION_PARAMETER
    from fabric_mod_tpu.policy import ApplicationPolicyEvaluator
    with pytest.MonkeyPatch.context() as mp:
        for knob, on in (("FABRIC_MOD_TPU_TENSOR_POLICY", tensor),
                         ("FABRIC_MOD_TPU_FUSED_HASH", fused)):
            if on:
                mp.setenv(knob, "1")
            else:
                mp.delenv(knob, raising=False)
        csp = SwCSP()
        mgr = CachedMsp(MspManager([Msp(o, csp, [deserialize_cert(p)])
                                    for o, p in ca_pems.items()]))
        led = KvLedger(str(root), "bench")

        def state_vp(ns, key):
            meta = led.state.get_metadata(ns, key)
            return meta.get(VALIDATION_PARAMETER) if meta else None
        validator = TxValidator(
            "bench", mgr, ApplicationPolicyEvaluator(mgr),
            FakeBatchVerifier(csp), ValidationInfoProvider(policy),
            tx_id_exists=led.tx_id_exists, state_metadata=state_vp)
        committer = Committer(validator, led)
        flags = [committer.store_block(jm.Block.decode(b)) for b in blocks]
        fp = led.state_fingerprint()
        led.close()
    return flags, fp


def run_port(world, blocks, verifier, tensor):
    """The port's Committer over `blocks`: (per-block flags, state
    fingerprint)."""
    committer = world.committer(verifier, tensor_policy=tensor)
    flags = [committer.store_block(m.Block.decode(b)) for b in blocks]
    return flags, committer.ledger.state_fingerprint()


def commit_world(raw_messages):
    ca_pems, signers, policy = _reference_world_pems()
    world = convert.world_from_reference(ca_pems, signers, policy,
                                         raw_messages=raw_messages)
    blocks, expected = fixtures.make_commit_blocks(world, N_BLOCKS, N_TX)
    return ca_pems, policy, world, blocks, expected


def check_expected(expected):
    """The blocks plant every kind the fixture promises."""
    kinds = {f for block in expected for f in block}
    assert kinds == {V.VALID, V.ENDORSEMENT_POLICY_FAILURE,
                     V.BAD_CREATOR_SIGNATURE, V.DUPLICATE_TXID,
                     V.MVCC_READ_CONFLICT}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    ca_pems, policy, world, blocks, expected = commit_world(False)
    ref = {tensor: run_reference(ca_pems, policy, blocks,
                                 tmp_path_factory.mktemp("ref"), tensor,
                                 fused=False)
           for tensor in (False, True)}
    return world, blocks, expected, ref


@pytest.fixture(scope="module")
def port(case):
    """Both port arms, sharing one verdict cache: the tensor arm runs
    cold (block 0 all misses: the fused seam's CPU tensor mask), the
    closure arm is then answered from the cache."""
    world, blocks, _expected, _ref = case
    cache = gpu.VerdictCache(4096)
    chunks = []
    real = gpu.marshal_items

    def counting(items, size=None):
        chunks.append(len(items))
        return real(items, size)
    tensorpolicy.reset_counts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gpu, "marshal_items", counting)
        tensor = run_port(world, blocks, gpu.GpuVerifier(
            device="cpu", cache=cache, buckets=(32,)), True)
    passes = tensorpolicy.counts()
    closure = run_port(world, blocks, gpu.GpuVerifier(
        device="cpu", cache=cache, buckets=(32,)), False)
    return {True: tensor, False: closure}, chunks, passes


@pytest.mark.parametrize("tensor", [False, True])
def test_reference_flags_equal_expected(case, tensor):
    _world, _blocks, expected, ref = case
    check_expected(expected)
    assert ref[tensor][0] == expected
    assert ref[tensor][1] == ref[not tensor][1]


@pytest.mark.parametrize("tensor", [False, True])
def test_port_flags_and_fingerprint_equal_reference(case, port, tensor):
    _world, _blocks, expected, ref = case
    runs, _chunks, _passes = port
    flags, fp = runs[tensor]
    assert flags == expected
    assert fp == ref[False][1]


def test_port_tensor_arm_took_the_device_mask_over_two_buckets(port):
    """Block 0's items span two 32-lane buckets and reach the evaluator
    as a tensor on the verifier's device (here the CPU); later blocks,
    with cache hits, take the numpy mask."""
    _runs, chunks, passes = port
    assert len(chunks) >= 2 and chunks[0] == 32 and chunks[1] > 0
    assert passes.get("cpu", 0) >= 1
    assert sum(passes.values()) == N_BLOCKS


def test_barriers_and_config_txs_match_reference(case):
    """Staging-only behaviour, with the host oracle as the verifier:
    which blocks need a barrier (the VALIDATION_PARAMETER writes of the
    odd blocks), and a CONFIG tx failing closed with no applier wired
    and passing with one — as in the reference."""
    from fabric_mod_tpu.bccsp.sw import SwCSP
    from fabric_mod_tpu.bccsp.tpu import FakeBatchVerifier
    from fabric_mod_tpu.msp.cache import CachedMsp
    from fabric_mod_tpu.msp.identities import deserialize_cert
    from fabric_mod_tpu.msp.mspimpl import Msp, MspManager
    from fabric_mod_tpu.peer import TxValidator, ValidationInfoProvider
    from fabric_mod_tpu.policy import ApplicationPolicyEvaluator
    from fabric_mod_tpu_torch.bccsp import sw
    from fabric_mod_tpu_torch.peer import txvalidator as ptv
    from fabric_mod_tpu_torch.policy import ApplicationPolicyEvaluator as PAPE
    from fabric_mod_tpu_torch.protos import protoutil
    world, blocks, _expected, _ref = case
    client = world.signers["client"]
    ch = protoutil.make_channel_header(m.HeaderType.CONFIG, "bench",
                                       tx_id="cfg", timestamp=1)
    sh = protoutil.make_signature_header(client.serialize(), b"n" * 24)
    cfg = protoutil.new_block(0, b"", [protoutil.sign_envelope(
        protoutil.make_payload(ch, sh, b"config"), client)]).encode()
    ca_pems = {org: msp.roots[0].pem()
               for org, msp in world.mgr._msp._msps.items()}
    csp = SwCSP()
    jmgr = CachedMsp(MspManager([Msp(o, csp, [deserialize_cert(p)])
                                 for o, p in ca_pems.items()]))
    for apply, want in ((None, V.INVALID_CONFIG_TRANSACTION),
                        (lambda env: None, V.VALID)):
        port = ptv.TxValidator("bench", world.mgr, PAPE(world.mgr),
                               sw.SwVerifier(),
                               ptv.ValidationInfoProvider(world.policy),
                               config_apply=apply)
        ref = TxValidator("bench", jmgr, ApplicationPolicyEvaluator(jmgr),
                          FakeBatchVerifier(csp),
                          ValidationInfoProvider(world.policy),
                          config_apply=apply)
        assert port.validate(m.Block.decode(cfg)) == \
            ref.validate(jm.Block.decode(cfg)) == [want]
        barriers = [port.stage(m.Block.decode(b)).needs_barrier
                    for b in blocks]
        ref_barriers = [ref.stage(jm.Block.decode(b)).needs_barrier
                        for b in blocks]
        assert barriers == ref_barriers == [False, True, False]
