"""The three-org world, streams and commit targets that
tests/test_torch_sharding.py and test_torch_sharding_device.py share:
the reference's CA issues the certificates and keys, carried across as
bytes (convert.world_from_reference); the reference's MSP manager and
signers are built over the same bytes."""
from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu_torch import convert
from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
from fabric_mod_tpu_torch.peer.commitpipe import ValidatorCommitTarget
from fabric_mod_tpu_torch.peer.txvalidator import (TxValidator,
                                                   ValidationInfoProvider)
from fabric_mod_tpu_torch.policy import ApplicationPolicyEvaluator
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.sharding import ChannelShardRouter
from fabric_mod_tpu_torch.utils import fixtures

N_CHANNELS, N_BLOCKS, N_TX = 3, 3, 3


class HostSlice(sw.SwVerifier):
    """The host verifier with the async seam a slice verifier offers
    (GpuVerifier's shape): verified at the call, resolved later."""

    def verify_many_async(self, items):
        mask = self.verify_many(items)
        return lambda: mask

    # the fused lane: the host has no device tensor, so its resolver
    # hands back the numpy mask, which the tensor policy also takes
    verify_many_fused_async = verify_many_async


def _reference_world_pems():
    """The reference's three-org world (its CA) as plain bytes."""
    from fabric_mod_tpu.msp import ca as jca
    from fabric_mod_tpu.policy import from_string
    cas, signers = {}, {}
    for org in ("Org1", "Org2", "Org3"):
        cas[org] = jca.CA(f"ca.{org.lower()}", org)
        cert, key = cas[org].issue(f"peer0.{org.lower()}", org, ous=["peer"])
        signers[org] = (org, jca.cert_pem(cert), jca.key_pem(key))
    policy = jm.ApplicationPolicy(signature_policy=from_string(
        fixtures.ENDORSEMENT_POLICY)).encode()
    return {o: ca.cert_pem() for o, ca in cas.items()}, signers, policy


class _RefWorld:
    """The reference's MSP manager and signers over the same bytes."""

    def __init__(self, ca_pems, signer_pems, policy):
        from fabric_mod_tpu.bccsp.sw import SwCSP
        from fabric_mod_tpu.msp.identities import (SigningIdentity,
                                                   deserialize_cert)
        from fabric_mod_tpu.msp.mspimpl import Msp, MspManager
        self.csp = SwCSP()
        self.mgr = MspManager([Msp(o, self.csp, [deserialize_cert(p)])
                               for o, p in ca_pems.items()])
        self.signers = {name: SigningIdentity(mspid, deserialize_cert(cert),
                                              key, self.csp)
                        for name, (mspid, cert, key) in signer_pems.items()}
        self.policy = policy

    def target(self, cid, verifier, root):
        from fabric_mod_tpu.ledger import KvLedger as RefLedger
        from fabric_mod_tpu.peer import TxValidator as RefValidator
        from fabric_mod_tpu.peer import ValidationInfoProvider as RefVIP
        from fabric_mod_tpu.peer import ValidatorCommitTarget as RefTarget
        from fabric_mod_tpu.policy import ApplicationPolicyEvaluator as RefAPE
        led = RefLedger(str(root), cid)
        validator = RefValidator(cid, self.mgr, RefAPE(self.mgr), verifier,
                                 RefVIP(self.policy),
                                 tx_id_exists=led.tx_id_exists)
        return RefTarget(validator, led)


def make_world():
    ca_pems, signer_pems, policy = _reference_world_pems()
    return (convert.world_from_reference(ca_pems, signer_pems, policy),
            _RefWorld(ca_pems, signer_pems, policy))


def make_streams(port_world):
    return {f"ch{i}": fixtures.make_channel_stream(
        port_world.signers, f"ch{i}", N_BLOCKS, N_TX)
        for i in range(N_CHANNELS)}


def target(port_world, cid, verifier) -> ValidatorCommitTarget:
    led = KvLedger(cid)
    validator = TxValidator(
        cid, port_world.mgr, ApplicationPolicyEvaluator(port_world.mgr),
        verifier, ValidationInfoProvider(port_world.policy),
        tx_id_exists=led.tx_id_exists)
    return ValidatorCommitTarget(validator, led)


def make_baseline(port_world, streams):
    """Independent unsharded synchronous runs (host verifier)."""
    return fixtures.independent_baseline(
        streams, lambda cid: target(port_world, cid, sw.SwVerifier()))


def flags(ledger):
    return [list(protoutil.block_txflags(ledger.get_block_by_number(n)))
            for n in range(ledger.height)]


def reference_router_run(ref, streams, root):
    """The reference's ChannelShardRouter over 2 FakeBatchVerifier
    slices, round robin: {cid: (flags, fingerprint)}."""
    from fabric_mod_tpu.bccsp.tpu import FakeBatchVerifier
    from fabric_mod_tpu.sharding import ChannelShardRouter as RefRouter
    router = RefRouter(n_slices=2, depth=2, verifier_factory=(
        lambda i, mesh: FakeBatchVerifier(ref.csp)))
    targets, out = {}, {}
    try:
        for cid in streams:
            targets[cid] = ref.target(cid, router.add_channel(cid),
                                      root / f"ref-{cid}")
            router.bind_target(cid, targets[cid])
        for n in range(N_BLOCKS):
            for cid, raws in streams.items():
                router.submit_block(cid, jm.Block.decode(raws[n]))
        assert router.flush(timeout_s=120)
        for cid, t in targets.items():
            out[cid] = (flags(t.ledger), t.ledger.state_fingerprint())
    finally:
        router.close()
        for t in targets.values():
            t.ledger.close()
    return out




def sharded_run(port_world, streams, verifier_factory):
    """The port's ChannelShardRouter over 2 slices of
    `verifier_factory(i, mesh)`, blocks submitted round robin (every
    channel's pipe live at once): {cid: (flags, fingerprint)}."""
    router = ChannelShardRouter(n_slices=2, depth=2,
                                verifier_factory=verifier_factory)
    targets = {}
    try:
        for cid in streams:
            targets[cid] = target(port_world, cid, router.add_channel(cid))
            router.bind_target(cid, targets[cid])
        assert router.map.loads() == [2, 1]
        for n in range(N_BLOCKS):
            for cid, raws in streams.items():
                router.submit_block(cid, m.Block.decode(raws[n]))
        assert router.flush(timeout_s=300)
    finally:
        router.close()
    return {cid: (flags(t.ledger), t.ledger.state_fingerprint())
            for cid, t in targets.items()}


def check_sharded(got, reference, baseline) -> None:
    """Per channel: the reference router's flags and fingerprint, and the
    independent run's; and the flags carry both outcomes."""
    distinct = set()
    for cid, run in got.items():
        assert run == reference[cid], cid
        assert run == baseline[cid][:2], cid
        distinct |= {f for blk in run[0] for f in blk}
    V = m.TxValidationCode
    assert distinct == {V.VALID, V.ENDORSEMENT_POLICY_FAILURE}
