"""Signature fixtures — real P-256 signatures from seeds, with the
expected verdict mask.

The port's copy of fabric_mod_tpu/utils/fixtures.py's verify fixtures
(`make_verify_items`, `signature_arrays`), plus `make_block`: the
signature traffic of one committed block — 1000 transactions under a
2-of-3 endorsement policy (the txvalidator configuration of BASELINE.md
#2), so 1000 creator + 2000 endorser signatures; the sharding
differentials' `make_channel_stream` and `independent_baseline`; and
the durable ledger's streams: bench.py's state-scale stream
(`make_statescale_blocks`, `prefill_statescale`) and a collection
definition followed by private writes (`make_pvt_blocks`).
Everything is made by the pure-python signer (bccsp/sw.py) from a seed:
no `cryptography` wheel, and no randomness outside the seed but the tx
nonces of protoutil.create_signed_tx.
"""
from __future__ import annotations

import dataclasses
import datetime
import hashlib
import json
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.bccsp.api import VerifyItem


def _keys(seed: bytes, label: bytes, n: int) -> List[sw.PrivateKey]:
    return [sw.PrivateKey.from_seed(seed + b"|" + label + b"|%d" % i)
            for i in range(n)]


def make_verify_items(
        n: int, n_keys: int = 8, invalid_every: Optional[int] = None,
        seed: bytes = b"fixture") -> Tuple[List[VerifyItem], List[bool]]:
    """n signed VerifyItems over `n_keys` keys; every `invalid_every`-th
    item (i % invalid_every == invalid_every - 1) gets a tampered
    digest.  Signatures are low-S, like production signing."""
    keys = _keys(seed, b"key", min(n_keys, max(n, 1)))
    items, expect = [], []
    for i in range(n):
        k = keys[i % len(keys)]
        digest = hashlib.sha256(seed + b"-%d" % i).digest()
        sig = k.sign(digest)
        bad = invalid_every is not None and i % invalid_every == invalid_every - 1
        if bad:
            digest = hashlib.sha256(seed + b"-tampered-%d" % i).digest()
        items.append(VerifyItem(digest, sig, k.public_xy()))
        expect.append(not bad)
    return items, expect


def signature_arrays(
        n: int, tamper_last: bool = True,
        seed: bytes = b"fixture") -> Tuple[np.ndarray, ...]:
    """The same fixtures as (n, 32) uint8 arrays (digest, r, s, qx, qy)
    plus the expected mask — the shape ops/p256.marshal_inputs takes."""
    items, _ = make_verify_items(n, n_keys=1, seed=seed)
    d = np.zeros((n, 32), np.uint8)
    r = np.zeros((n, 32), np.uint8)
    s = np.zeros((n, 32), np.uint8)
    qx = np.zeros((n, 32), np.uint8)
    qy = np.zeros((n, 32), np.uint8)
    expect = np.ones(n, bool)
    for i, it in enumerate(items):
        ri, si = sw.decode_dss_signature(it.signature)
        d[i] = np.frombuffer(it.digest, np.uint8)
        r[i] = np.frombuffer(ri.to_bytes(32, "big"), np.uint8)
        s[i] = np.frombuffer(si.to_bytes(32, "big"), np.uint8)
        qx[i] = np.frombuffer(it.public_xy[:32], np.uint8)
        qy[i] = np.frombuffer(it.public_xy[32:], np.uint8)
    if tamper_last and n:
        d[n - 1, 0] ^= 0xFF
        expect[n - 1] = False
    return d, r, s, qx, qy, expect



# The verify core's edge lanes (ops/p256_core.py): the digest e may be
# any 256-bit value, padding lanes are all zeros, and invalid keys and
# out-of-range scalars still run the whole core.
CORE_EDGE_LANES = 13


def make_core_lanes(n: int, seed: bytes = b"core"):
    """(planes, pre_ok, expect): n lanes of the verify core's inputs —
    the five (n, 32) uint8 planes (e, r, s, qx, qy), a host mask with
    one False lane, and the verdict each lane must get.  Lanes from
    CORE_EDGE_LANES on are valid signatures; the first ones:

      0  valid                      7   off-curve key (y ^ 1)
      1  valid, e = 2^256 - 1       8   key (0, 0)
      2  valid, e = n               9   r = 5 (r + n < p), s random
      3  valid, e = n + 1           10  qx = p + 1 (out of range)
      4  valid, e = n - 1           11  valid, pre_ok False
      5  valid, e = 0               12  s = 2^256 - 1 (out of range)
      6  padding: all zeros
    """
    if n < CORE_EDGE_LANES:
        raise ValueError(f"need at least {CORE_EDGE_LANES} lanes")
    key = sw.PrivateKey.from_seed(seed)
    xy = key.public_xy()
    rng = random.Random(seed)
    N, P = sw.N, sw.P
    digests = [rng.randbytes(32) for _ in range(n)]
    for lane, e in ((1, (1 << 256) - 1), (2, N), (3, N + 1), (4, N - 1),
                    (5, 0)):
        digests[lane] = e.to_bytes(32, "big")
    planes = [np.zeros((n, 32), np.uint8) for _ in range(5)]
    d, r, s, qx, qy = planes
    for i in range(n):
        ri, si = sw.decode_dss_signature(key.sign(digests[i]))
        d[i] = np.frombuffer(digests[i], np.uint8)
        r[i] = np.frombuffer(ri.to_bytes(32, "big"), np.uint8)
        s[i] = np.frombuffer(si.to_bytes(32, "big"), np.uint8)
        qx[i] = np.frombuffer(xy[:32], np.uint8)
        qy[i] = np.frombuffer(xy[32:], np.uint8)
    expect = np.ones(n, bool)
    for a in planes:
        a[6] = 0
    qy[7, 31] ^= 1
    qx[8] = 0
    qy[8] = 0
    r[9] = np.frombuffer((5).to_bytes(32, "big"), np.uint8)
    s[9] = np.frombuffer(rng.randrange(1, N).to_bytes(32, "big"), np.uint8)
    qx[10] = np.frombuffer((P + 1).to_bytes(32, "big"), np.uint8)
    s[12] = 0xFF
    pre_ok = np.ones(n, bool)
    pre_ok[11] = False
    expect[6:CORE_EDGE_LANES] = False
    return planes, pre_ok, expect


ORGS = (b"Org1", b"Org2", b"Org3")


def make_block(block_no: int, n_tx: int = 1000, n_clients: int = 64,
               raw_endorsers: bool = False, adversarial: bool = True,
               seed: bytes = b"block") -> Tuple[List[VerifyItem], np.ndarray]:
    """The signature items of one block and its expected verdict mask.

    Each transaction carries a creator signature (one of `n_clients`
    client keys, spread round-robin) over its 200-2000 byte payload and
    two endorser signatures (2 of the 3 org peers, chosen per tx) over
    their proposal-response bytes — 3 items per tx, all distinct.  With
    `raw_endorsers` the endorser items carry the raw message (hashed on
    the device); otherwise every item carries its SHA-256 digest.

    With `adversarial`, the lanes of the reference bench's differential
    (bench.py measure_diffverify) are planted every 97 items: tampered
    digest/message, wrong key, s = 0, r = n, off-curve key, key (0, 0),
    high-S mirror — each expected False."""
    rng = random.Random(hashlib.sha256(seed + b"|%d" % block_no).digest())
    clients = _keys(seed, b"client", n_clients)
    peers = _keys(seed, b"peer", len(ORGS))
    items: List[VerifyItem] = []
    keys: List[sw.PrivateKey] = []
    for j in range(n_tx):
        payload = (b"blk%d-tx%d|" % (block_no, j)
                   + rng.randbytes(rng.randrange(200, 2001)))
        creator = clients[(block_no * n_tx + j) % n_clients]
        items.append(VerifyItem(hashlib.sha256(payload).digest(),
                                creator.sign(hashlib.sha256(payload).digest()),
                                creator.public_xy()))
        keys.append(creator)
        for org in sorted(rng.sample(range(len(ORGS)), 2)):
            prp = (b"prp|" + ORGS[org] + b"|%d|%d|" % (block_no, j)
                   + rng.randbytes(rng.randrange(200, 2001)))
            digest = hashlib.sha256(prp).digest()
            sig = peers[org].sign(digest)
            if raw_endorsers:
                items.append(VerifyItem(b"", sig, peers[org].public_xy(), prp))
            else:
                items.append(VerifyItem(digest, sig, peers[org].public_xy()))
            keys.append(peers[org])
    expect = np.ones(len(items), bool)
    if adversarial:
        _plant_adversarial(items, keys, expect)
    return items, expect


# --- the block-commit world -------------------------------------------------

CHANNEL = "bench"
NAMESPACE = "mycc"
# 2-of-3 org peers: BASELINE.md config #2
ENDORSEMENT_POLICY = "OutOf(2, 'Org1.peer', 'Org2.peer', 'Org3.peer')"
# the validity windows of make_commit_world's certificates start here
CERT_EPOCH = datetime.datetime(2025, 1, 1, tzinfo=datetime.timezone.utc)
_PAIRS = (("Org1", "Org2"), ("Org2", "Org3"), ("Org1", "Org3"))


@dataclasses.dataclass
class CommitWorld:
    """A channel's membership for the block-commit path: the MSP
    manager (second-chance cached, as a peer's channel wraps it), the
    signers by name ("Org1", "Org2", "Org3" — one peer each — and
    "client", an Org1 client), and the chaincode-wide endorsement
    policy as ApplicationPolicy bytes."""
    mgr: object
    signers: Dict[str, object]
    policy: bytes
    channel_id: str = CHANNEL

    def committer(self, verifier, tensor_policy: bool = False, ledger=None):
        """A Committer over `ledger` (a fresh durable ledger in a
        temporary directory by default), wired for key-level policies
        and duplicate-txid checks against it."""
        from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
        from fabric_mod_tpu_torch.peer.txvalidator import (
            VALIDATION_PARAMETER, Committer, TxValidator,
            ValidationInfoProvider)
        from fabric_mod_tpu_torch.policy import ApplicationPolicyEvaluator
        led = ledger if ledger is not None else KvLedger(self.channel_id)

        def state_vp(ns, key):
            meta = led.state.get_metadata(ns, key)
            return meta.get(VALIDATION_PARAMETER) if meta else None
        validator = TxValidator(
            self.channel_id, self.mgr, ApplicationPolicyEvaluator(self.mgr),
            verifier, ValidationInfoProvider(self.policy),
            tx_id_exists=led.tx_id_exists, state_metadata=state_vp,
            tensor_policy=tensor_policy)
        return Committer(validator, led)


def world_from_pems(ca_cert_pems: Dict[str, bytes],
                    signer_pems: Dict[str, Tuple[str, bytes, bytes]],
                    policy: bytes, raw_messages: bool = False,
                    channel_id: str = CHANNEL) -> CommitWorld:
    """A CommitWorld from plain bytes: each org's CA certificate PEM,
    each signer's (mspid, certificate PEM, PKCS#8 key PEM), the
    endorsement policy.  `raw_messages`: verify items carry raw
    messages, hashed on the card."""
    from fabric_mod_tpu_torch.bccsp import x509
    from fabric_mod_tpu_torch.msp.cache import CachedMsp
    from fabric_mod_tpu_torch.msp.mspimpl import Msp, MspManager
    csp = sw.SwCSP()
    msps = {org: Msp(org, csp, [x509.load_pem_x509_certificate(pem)],
                     raw_messages=raw_messages)
            for org, pem in ca_cert_pems.items()}
    signers = {name: msps[mspid].signing_identity(cert_pem, key_pem)
               for name, (mspid, cert_pem, key_pem) in signer_pems.items()}
    return CommitWorld(CachedMsp(MspManager(list(msps.values()))), signers,
                       policy, channel_id)


def commit_world_pems(seed: bytes = b"commit"):
    """The seeded material of make_commit_world as plain bytes:
    (ca_cert_pems, signer_pems, policy) for `world_from_pems`."""
    from fabric_mod_tpu_torch.msp import ca as calib
    from fabric_mod_tpu_torch.policy import from_string
    from fabric_mod_tpu_torch.protos import messages as m
    cas, signer_pems = {}, {}
    for org in ("Org1", "Org2", "Org3"):
        ca = calib.CA(f"ca.{org.lower()}", org, seed=seed, now=CERT_EPOCH)
        cas[org] = ca
        cert, key = ca.issue(f"peer0.{org.lower()}", org, ous=["peer"])
        signer_pems[org] = (org, cert.pem(), calib.key_pem(key))
    cert, key = cas["Org1"].issue("client@org1", "Org1", ous=["client"])
    signer_pems["client"] = ("Org1", cert.pem(), calib.key_pem(key))
    policy = m.ApplicationPolicy(
        signature_policy=from_string(ENDORSEMENT_POLICY)).encode()
    return ({org: ca.cert_pem() for org, ca in cas.items()}, signer_pems,
            policy)


def make_commit_world(seed: bytes = b"commit",
                      raw_messages: bool = False) -> CommitWorld:
    """BASELINE.md config #2's channel: 3 orgs with one peer each and a
    client, the 2-of-3 endorsement policy — every certificate and key
    made from `seed`."""
    return world_from_pems(*commit_world_pems(seed),
                           raw_messages=raw_messages)


def _flip(sig: bytes) -> bytes:
    """A signature with one bit of r flipped: still strict DER and low
    S, no longer valid."""
    b = bytearray(sig)
    b[10] ^= 1
    return bytes(b)


def _signed_tx(world: CommitWorld, rwset: bytes, endorsers, nonce: bytes,
               timestamp: int, bad_creator: bool = False,
               bad_endorser: Optional[int] = None,
               chaincode: str = NAMESPACE):
    """protoutil.create_signed_tx with the nonce and timestamp given,
    and the optional tampering of the creator's or one endorser's
    signature."""
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    creator = world.signers["client"]
    creator_bytes = creator.serialize()
    tx_id = protoutil.compute_tx_id(nonce, creator_bytes)
    cca = m.ChaincodeAction(
        results=rwset, events=b"", response=m.Response(status=200),
        chaincode_id=m.ChaincodeID(name=chaincode))
    prp_bytes = m.ProposalResponsePayload(
        proposal_hash=hashlib.sha256(tx_id.encode()).digest(),
        extension=cca.encode()).encode()
    endorsements = []
    for i, name in enumerate(endorsers):
        e = world.signers[name]
        ident = e.serialize()
        sig = e.sign_message(prp_bytes + ident)
        endorsements.append(m.Endorsement(
            endorser=ident, signature=_flip(sig) if i == bad_endorser else sig))
    cap = m.ChaincodeActionPayload(action=m.ChaincodeEndorsedAction(
        proposal_response_payload=prp_bytes, endorsements=endorsements))
    tx = m.Transaction(actions=[m.TransactionAction(payload=cap.encode())])
    ch = protoutil.make_channel_header(
        m.HeaderType.ENDORSER_TRANSACTION, world.channel_id, tx_id=tx_id,
        timestamp=timestamp)
    payload = protoutil.make_payload(
        ch, protoutil.make_signature_header(creator_bytes, nonce), tx.encode())
    env = protoutil.sign_envelope(payload, creator)
    if bad_creator:
        env = m.Envelope(payload=env.payload, signature=_flip(env.signature))
    return env


def _pin_org(b: int) -> str:
    """The org the VALIDATION_PARAMETER pin of odd block b names."""
    return ("Org3", "Org1")[(b // 2) % 2]


def make_commit_blocks(world: CommitWorld, n_blocks: int, n_tx: int,
                       plant_every: int = 16, seed: bytes = b"blocks"
                       ) -> Tuple[List[bytes], List[List[int]]]:
    """`n_blocks` chained, encoded blocks of `n_tx` transactions each,
    and the txflags every transaction must end with.

    Each tx is signed by the world's client and endorsed by two of the
    three org peers, and writes its own key.  Block 0 tx 0 writes
    "pinned" and tx 1 "counter".  Every odd block's tx 0 pins "pinned"
    to one org with a VALIDATION_PARAMETER metadata write, endorsed as
    the pin in force (or, for the first, the chaincode policy) requires.
    In every block, at position k = j % plant_every (`plant_every` >=
    16):
      3  one endorsement only (1 of 3)        ENDORSEMENT_POLICY_FAILURE
      5  creator signature tampered           BAD_CREATOR_SIGNATURE
      7  one of two endorser signatures bad   ENDORSEMENT_POLICY_FAILURE
      9  a repeat of the envelope at k = 8    DUPLICATE_TXID
     11  reads "counter" at a stale version   MVCC_READ_CONFLICT
    and from block 1 on:
     12  a repeat of the previous block's k = 8 tx       DUPLICATE_TXID
     13  reads "counter" at its committed version        VALID
     14  writes "pinned", not endorsed by the pinned org
                                              ENDORSEMENT_POLICY_FAILURE
     15  writes "pinned", endorsed by the pinned org     VALID
    Nonces and timestamps come from `seed`, signatures are RFC 6979:
    the same inputs give the same bytes."""
    from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder
    from fabric_mod_tpu_torch.peer.txvalidator import VALIDATION_PARAMETER
    from fabric_mod_tpu_torch.policy import from_string
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    if plant_every < 16:
        raise ValueError("plant_every must be at least 16")
    V = m.TxValidationCode
    ns = NAMESPACE
    blocks, expected, prev_hash = [], [], b""
    prev_envs: List = []
    for b in range(n_blocks):
        envs, flags = [], []
        # the pin in force after tx 0 of this block, if any
        pin = _pin_org(b) if b % 2 == 1 else (
            _pin_org(b - 1) if b >= 2 else None)
        for j in range(n_tx):
            k = j % plant_every
            nonce = hashlib.sha256(seed + b"|nonce|%d|%d" % (b, j)).digest()[:24]
            ts = 1_735_689_600_000_000_000 + (b * n_tx + j) * 1000
            rw = RWSetBuilder()
            endorsers = _PAIRS[j % 3]
            flag = V.VALID
            kw = {}
            if b == 0 and j < 2:
                rw.add_write(ns, ("pinned", "counter")[j], b"v0")
            elif j == 0 and b % 2 == 1:
                standing = _pin_org(b - 2) if b >= 3 else None
                vp = m.ApplicationPolicy(signature_policy=from_string(
                    f"'{pin}.peer'")).encode()
                rw.add_metadata_write(ns, "pinned", VALIDATION_PARAMETER, vp)
                endorsers = ("Org1", "Org2") if standing is None else \
                    (standing, next(o for o in ("Org1", "Org2", "Org3")
                                    if o != standing))
            elif k == 9:
                envs.append(envs[j - 1])
                flags.append(V.DUPLICATE_TXID)
                continue
            elif k == 12 and b >= 1:
                envs.append(prev_envs[j - 4])
                flags.append(V.DUPLICATE_TXID)
                continue
            else:
                rw.add_write(ns, f"b{b}t{j}", b"v")
                if k == 3:
                    endorsers = endorsers[:1]
                    flag = V.ENDORSEMENT_POLICY_FAILURE
                elif k == 5:
                    kw["bad_creator"] = True
                    flag = V.BAD_CREATOR_SIGNATURE
                elif k == 7:
                    endorsers, kw["bad_endorser"] = ("Org1", "Org2"), 1
                    flag = V.ENDORSEMENT_POLICY_FAILURE
                elif k == 11:
                    rw.add_read(ns, "counter", (b + 1, 999))
                    flag = V.MVCC_READ_CONFLICT
                elif k == 13 and b >= 1:
                    rw.add_read(ns, "counter", (0, 1))
                elif k in (14, 15) and pin is not None:
                    rw = RWSetBuilder()
                    rw.add_write(ns, "pinned", b"v%d" % j)
                    others = tuple(o for o in ("Org1", "Org2", "Org3")
                                   if o != pin)
                    if k == 14:
                        endorsers = others
                        flag = V.ENDORSEMENT_POLICY_FAILURE
                    else:
                        endorsers = (pin, others[0])
            envs.append(_signed_tx(world, rw.build().encode(), endorsers,
                                   nonce, ts, **kw))
            flags.append(flag)
        block = protoutil.new_block(b, prev_hash, envs)
        prev_hash = protoutil.block_header_hash(block.header)
        blocks.append(block.encode())
        expected.append(flags)
        prev_envs = envs
    return blocks, expected


NETWORK_ORGS = ("Org1", "Org2", "Org3")


def make_network_material(seed: int = 0, channel_id: str = "testchannel",
                          consensus_type: str = "solo", orderers: int = 1,
                          gossip_peers: int = 0, spare_orderers: int = 0,
                          **batch_config):
    """An e2e.NetworkMaterial made from `seed`: a CA per org of
    NETWORK_ORGS and one for the orderer org, a peer and an admin per
    org, a client of the first org, `orderers` orderer signers under the
    orderer CA (consenter ids "orderer0", "orderer1", ...; as the
    reference's soak/world.py:387-390 makes one per consenter), and
    the standard genesis block (the configtxgen step of the reference's
    e2e Network) with `consensus_type` ("solo", or "etcdraft" with the
    consenter ids in its RaftMetadata) and the orderer group's
    `batch_config` (genesis.orderer_group's max_message_count,
    batch_timeout, preferred_max_bytes, ...).  `gossip_peers` more peer
    signers, round-robin over the orgs ("gossip<i>.<org>"), go to the
    material's `gossip_peers`: one identity for each gossip peer of a
    composed network; an admin of the orderer org (after every other
    certificate, so theirs do not change) its `orderer_admin`.
    `spare_orderers` more orderer signers ("orderer<orderers>", ...),
    issued after the admin, join `consenters` without being in the
    genesis consenter set: orderers that can join the channel later.
    Certificates and keys are the same for the same
    seed; the genesis envelope carries a fresh nonce."""
    from fabric_mod_tpu_torch.channelconfig import genesis
    from fabric_mod_tpu_torch.e2e import NetworkMaterial
    from fabric_mod_tpu_torch.msp import ca as calib
    if orderers < 1 or (consensus_type == "solo" and orderers != 1):
        raise ValueError("solo takes one orderer; etcdraft one or more")
    tag = b"network|%d" % seed

    def signer(ca, cn, org, ou):
        cert, key = ca.issue(cn, org, ous=[ou])
        return (org, cert.pem(), calib.key_pem(key))
    cas = {org: calib.CA(f"ca.{org.lower()}", org, seed=tag, now=CERT_EPOCH)
           for org in NETWORK_ORGS}
    orderer_ca = calib.CA("ca.orderer", "OrdererOrg", seed=tag,
                          now=CERT_EPOCH)
    first = NETWORK_ORGS[0]
    ids = [f"orderer{i}" for i in range(orderers)]
    if consensus_type != "solo":
        batch_config = dict(batch_config, consenters=ids)
    block = genesis.standard_network(
        channel_id, {org: [ca.cert_pem()] for org, ca in cas.items()},
        {"OrdererOrg": [orderer_ca.cert_pem()]},
        consensus_type=consensus_type, **batch_config)
    client = signer(cas[first], f"client@{first.lower()}", first, "client")
    peers = {org: signer(ca, f"peer0.{org.lower()}", org, "peer")
             for org, ca in cas.items()}
    admins = {org: signer(ca, f"admin@{org.lower()}", org, "admin")
              for org, ca in cas.items()}
    consenters = {oid: signer(orderer_ca, oid, "OrdererOrg", "orderer")
                  for oid in ids}
    gossip = []
    for i in range(gossip_peers):
        org = NETWORK_ORGS[i % len(NETWORK_ORGS)]
        gossip.append(signer(cas[org], f"gossip{i}.{org.lower()}", org,
                             "peer"))
    orderer_admin = signer(orderer_ca, "admin@orderer", "OrdererOrg", "admin")
    for i in range(orderers, orderers + spare_orderers):
        consenters[f"orderer{i}"] = signer(orderer_ca, f"orderer{i}",
                                           "OrdererOrg", "orderer")
    return NetworkMaterial(
        ca_pems={org: ca.cert_pem() for org, ca in cas.items()},
        orderer_ca_pem=orderer_ca.cert_pem(),
        client=client, peers=peers, admins=admins,
        orderer=consenters[ids[0]],
        genesis=block.encode(),
        consenters=(consenters if consensus_type != "solo"
                    or spare_orderers else {}),
        gossip_peers=gossip, orderer_admin=orderer_admin)


def tamper_block_signature(raw_block: bytes) -> bytes:
    """An encoded orderer-signed block with the last byte of its first
    block signature flipped (inside s, so the DER still parses): the
    MCS must refuse it."""
    from fabric_mod_tpu_torch.protos import messages as m
    block = m.Block.decode(raw_block)
    slot = m.BlockMetadataIndex.SIGNATURES
    meta = m.Metadata.decode(block.metadata.metadata[slot])
    sig = bytearray(meta.signatures[0].signature)
    sig[-1] ^= 0x01
    meta.signatures[0].signature = bytes(sig)
    block.metadata.metadata[slot] = meta.encode()
    return block.encode()


# the key-level endorsement policy the e2e stream's setvp txs pin
E2E_PIN_POLICY = b"OR('Org1.peer')"


def make_e2e_stream(net, n_tx: int, plant_every: int = 50,
                    order_free: bool = False):
    """`n_tx` transactions for the port's e2e `Network`, endorsed by its
    endorsers against its current state (put txs endorsed by Org1 and
    Org2 unless planted), with a planted kind of each sort in every
    group of `plant_every` (>= 8) txs:

      position 1   endorsed by Org1 only        ENDORSEMENT_POLICY_FAILURE
      position 2   a put, the group's anchor    VALID
      position 3   Org1 + Org3, Org3's endorsement signature flipped
                                                ENDORSEMENT_POLICY_FAILURE
      position 4   a get of the anchor's key    MVCC_READ_CONFLICT
      position 5   the previous group's anchor envelope again (the
                   first group's own)           DUPLICATE_TXID
      position 6   a setvp pin (a VALIDATION_PARAMETER write: the
                   commit pipe drains at a barrier)   VALID
      after 6      one more envelope whose creator signature is
                   flipped: Broadcast rejects it, so it is not one of
                   the `n_tx`

    With `order_free`, only the kinds whose flag does not depend on the
    order the orderer sees the envelopes in are planted (positions 1
    and 3 and the tampered creator); positions 4, 5 and 6 are plain
    puts to keys of their own.  That is the stream concurrent
    submitters can send: the read conflict, the duplicate and the pin
    are dropped, as their flags (or those after them) follow the order.

    Returns (submits, expected): the envelopes in submission order as
    (Envelope, accepted), and the expected flag of each accepted tx in
    order.  Under the default MAJORITY endorsement policy of 3 orgs."""
    from fabric_mod_tpu_torch.policy.policydsl import from_string
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    if plant_every < 8:
        raise ValueError("plant_every must leave room for the 6 kinds")
    V = m.TxValidationCode
    pin = m.ApplicationPolicy(
        signature_policy=from_string(E2E_PIN_POLICY.decode())).encode()

    def endorse(args, orgs=("Org1", "Org2"), flip=None):
        sp, prop, _ = protoutil.create_chaincode_proposal(
            net.channel_id, "mycc", args, net.client)
        responses = [net.endorsers[o].process_proposal(sp) for o in orgs]
        if flip is not None:
            e = responses[flip].endorsement
            e.signature = _flip(e.signature)
        return protoutil.create_tx_from_responses(prop, responses, net.client)

    submits, expected = [], []
    anchor = prev_anchor = None
    for i in range(n_tx):
        j = i % plant_every
        key = b"k%d" % i
        flag = V.VALID
        if j == 1:
            env = endorse([b"put", key, b"v"], ("Org1",))
            flag = V.ENDORSEMENT_POLICY_FAILURE
        elif j == 2:
            env = endorse([b"put", key, b"v"])
            prev_anchor, anchor = anchor, (key, env)
        elif j == 3:
            env = endorse([b"put", key, b"v"], ("Org1", "Org3"), flip=1)
            flag = V.ENDORSEMENT_POLICY_FAILURE
        elif order_free and j in (4, 5, 6):
            env = endorse([b"put", key, b"v%d" % i])
        elif j == 4:
            env = endorse([b"get", anchor[0]])
            flag = V.MVCC_READ_CONFLICT
        elif j == 5:
            env = (prev_anchor or anchor)[1]
            flag = V.DUPLICATE_TXID
        elif j == 6:
            env = endorse([b"setvp", b"pin%d" % i, pin], ("Org2", "Org3"))
        else:
            env = endorse([b"put", key, b"v%d" % i])
        submits.append((env, True))
        expected.append(flag)
        if j == 6:
            bad = endorse([b"put", b"x%d" % i, b"v"])
            submits.append((m.Envelope(payload=bad.payload,
                                       signature=_flip(bad.signature)),
                            False))
    return submits, expected


def _replace(it: VerifyItem, **kw) -> VerifyItem:
    fields = dict(digest=it.digest, signature=it.signature,
                  public_xy=it.public_xy, message=it.message)
    fields.update(kw)
    return VerifyItem(**fields)


def _plant_adversarial(items, keys, expect) -> None:
    n = len(items)
    for base in range(0, n - 8, 97):
        it = items[base]
        if it.message is not None:
            m = bytearray(it.message)
            m[0] ^= 1
            items[base] = _replace(it, message=bytes(m))
        else:
            d = bytearray(it.digest)
            d[0] ^= 1
            items[base] = _replace(it, digest=bytes(d))
        own = items[base + 1].public_xy
        other = next(k.public_xy() for k in keys[base + 2:] + keys[:base]
                     if k.public_xy() != own)
        items[base + 1] = _replace(items[base + 1], public_xy=other)
        r, s = sw.decode_dss_signature(items[base + 3].signature)
        items[base + 3] = _replace(items[base + 3],
                                   signature=sw.encode_dss_signature(r, 0))
        r, s = sw.decode_dss_signature(items[base + 4].signature)
        items[base + 4] = _replace(items[base + 4],
                                   signature=sw.encode_dss_signature(sw.N, s))
        xy = bytearray(items[base + 5].public_xy)
        xy[63] ^= 1
        items[base + 5] = _replace(items[base + 5], public_xy=bytes(xy))
        items[base + 6] = _replace(items[base + 6], public_xy=b"\x00" * 64)
        r, s = sw.decode_dss_signature(items[base + 7].signature)
        items[base + 7] = _replace(items[base + 7],
                                   signature=sw.encode_dss_signature(r, sw.N - s))
        expect[[base, base + 1, base + 3, base + 4, base + 5, base + 6,
                base + 7]] = False


# --- channel sharding: N channels' streams and their independent oracle ----

def make_channel_stream(signers, cid: str, n_blocks: int,
                        txs_per_block: int, under_endorse_every: int = 4,
                        namespace: str = NAMESPACE) -> List[bytes]:
    """One channel's encoded block stream for the sharding differentials
    (the reference's make_channel_stream): every `under_endorse_every`-th
    tx is endorsed by Org1 alone (fails a 2-of-3 policy, so the flags
    carry signal), keys are per channel (`{cid}-b{n}t{j}` holding
    `cid`) so fingerprints differ across channels.  `signers` maps org
    -> SigningIdentity for Org1/Org2 (Org1 is the creator).  Nonces, and
    so tx ids, are random (protoutil.create_signed_tx, as in the
    reference): a differential makes a stream once and feeds every arm
    the same bytes."""
    from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder
    from fabric_mod_tpu_torch.protos import protoutil
    blocks, prev = [], b""
    for n in range(n_blocks):
        envs = []
        for j in range(txs_per_block):
            b = RWSetBuilder()
            b.add_write(namespace, f"{cid}-b{n}t{j}", cid.encode())
            endorsers = (("Org1",)
                         if (n * txs_per_block + j) % under_endorse_every
                         == under_endorse_every - 1
                         else ("Org1", "Org2"))
            envs.append(protoutil.create_signed_tx(
                cid, namespace, b.build().encode(), signers["Org1"],
                [signers[o] for o in endorsers]))
        blk = protoutil.new_block(n, prev, envs)
        prev = protoutil.block_header_hash(blk.header)
        blocks.append(blk.encode())
    return blocks


def independent_baseline(streams, make_target) -> dict:
    """The sharding differentials' oracle: per channel, an INDEPENDENT
    unsharded synchronous run of its stream into a fresh ledger —
    {cid: (per_block_flags, state_fingerprint, wall_secs)}.
    `make_target(cid)` builds a fresh ValidatorCommitTarget-shaped
    (validator, ledger) pair with its own unsharded verifier."""
    import time
    from fabric_mod_tpu_torch.peer.txvalidator import Committer
    from fabric_mod_tpu_torch.protos import messages as m
    out = {}
    for cid, raws in streams.items():
        t = make_target(cid)
        committer = Committer(t.validator, t.ledger)
        t0 = time.perf_counter()
        flags = [list(committer.store_block(m.Block.decode(raw)))
                 for raw in raws]
        out[cid] = (flags, t.ledger.state_fingerprint(),
                    time.perf_counter() - t0)
    return out


# --- the durable ledger: bench.py's state-scale stream ----------------------

def statescale_key(i: int) -> str:
    """The i-th prefilled key of the state-scale stream (bench.py:741)."""
    return "sk%07d" % i


def prefill_statescale(ledger, n_keys: int, chunk: int = 200_000) -> None:
    """Write keys 0..n_keys-1 of the state-scale stream at version
    (0, 0) straight into the ledger's state, in batches of `chunk`
    (bench.py:867's prefill; before the first fingerprint, so nothing
    is folded)."""
    from fabric_mod_tpu_torch.ledger.statedb import UpdateBatch
    for lo in range(0, n_keys, chunk):
        batch = UpdateBatch()
        for i in range(lo, min(lo + chunk, n_keys)):
            batch.put(NAMESPACE, statescale_key(i), b"seed-%07d" % i, (0, 0))
        ledger.state.apply_updates(batch, 0)


def make_statescale_blocks(world: CommitWorld, n_blocks: int,
                           txs_per_block: int, touch_space: int,
                           seed: bytes = b"statescale") -> List[bytes]:
    """bench.py:745's state-scale stream, signed by the world's client
    and peers: chained encoded blocks whose every key lies in the first
    `touch_space` prefilled keys, so one stream gives the same flags at
    every state size.  Each tx reads 28 keys of the upper half of that
    space (0.5% of them at a stale version), probes 2 absent keys,
    writes 3 keys of the lower half (10% deletes), adds a phantom range
    over prefilled rows (10%) or an empty range (15%), and is
    under-endorsed (Org2 alone against the 2-of-3 policy) 8% of the
    time; block 2's tx 0 pins key 1's VALIDATION_PARAMETER to Org3, so
    every later block's tx 1, writing key 1 under Org1 + Org2, fails.
    The draws are bench.py's (random.Random(1807)); nonces and
    timestamps come from `seed`."""
    from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder
    from fabric_mod_tpu_torch.peer.txvalidator import VALIDATION_PARAMETER
    from fabric_mod_tpu_torch.policy import from_string
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    rng = random.Random(1807)
    write_pool = touch_space // 2
    pin_key = statescale_key(1)
    sk = statescale_key
    blocks, prev = [], b""
    for n in range(n_blocks):
        envs = []
        for j in range(txs_per_block):
            b = RWSetBuilder()
            endorsers = ("Org1", "Org2")
            if n == 2 and j == 0:
                b.add_metadata_write(NAMESPACE, pin_key, VALIDATION_PARAMETER,
                                     m.ApplicationPolicy(
                                         signature_policy=from_string(
                                             "'Org3.peer'")).encode())
            elif n >= 3 and j == 1:
                b.add_write(NAMESPACE, pin_key, b"pinned%d" % n)
            else:
                for _ in range(28):
                    k = sk(write_pool + rng.randrange(touch_space - write_pool))
                    if rng.random() < 0.005:
                        b.add_read(NAMESPACE, k, (9999, 0))      # stale
                    else:
                        b.add_read(NAMESPACE, k, (0, 0))         # fresh
                for _ in range(2):
                    b.add_read(NAMESPACE, "zz%05d" % rng.randrange(1000), None)
                for _ in range(3):
                    k = sk(rng.randrange(write_pool))
                    if rng.random() < 0.10:
                        b.add_write(NAMESPACE, k, None)          # delete
                    else:
                        b.add_write(NAMESPACE, k, b"v%d.%d" % (n, j))
                r = rng.random()
                if r < 0.10:
                    # prefilled rows in range, none recorded: phantom
                    b.add_range_query(NAMESPACE, sk(write_pool + 50),
                                      sk(write_pool + 52), True, [])
                elif r < 0.25:
                    b.add_range_query(NAMESPACE, "zz~0", "zz~9", True, [])
                if rng.random() < 0.08:
                    endorsers = ("Org2",)    # under-endorsed
            nonce = hashlib.sha256(seed + b"|%d|%d" % (n, j)).digest()[:24]
            ts = 1_735_689_600_000_000_000 + (n * txs_per_block + j) * 1000
            envs.append(_signed_tx(world, b.build().encode(), endorsers,
                                   nonce, ts))
        blk = protoutil.new_block(n, prev, envs)
        prev = protoutil.block_header_hash(blk.header)
        blocks.append(blk.encode())
    return blocks


# --- the lifecycle slice: signed puts over deployed chaincodes ---------------

def make_put_txs(world: CommitWorld, puts, seed: bytes = b"puts"):
    """One signed put envelope for each (namespace, key, value,
    endorsers) of `puts`, as the world's client, endorsed by the named
    peers; nonces and timestamps from `seed` and the position."""
    from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder
    envs = []
    for i, (ns, key, value, endorsers) in enumerate(puts):
        b = RWSetBuilder()
        b.add_write(ns, key, value)
        nonce = hashlib.sha256(seed + b"|%d" % i).digest()[:24]
        envs.append(_signed_tx(world, b.build().encode(), endorsers, nonce,
                               1_735_689_600_000_000_000 + i * 1000,
                               chaincode=ns))
    return envs


# the endorsers of a put that meets, and of one that misses, each
# namespace's policy in the lifecycle stream: mycc under the channel's
# MAJORITY default, cc2 under its own AND(Org1, Org3)
LIFECYCLE_ENDORSERS = {"mycc": (("Org1", "Org2"), ("Org1",)),
                       "cc2": (("Org1", "Org3"), ("Org1", "Org2"))}


def make_lifecycle_stream(world: CommitWorld, n_tx: int,
                          under_every: int = 10, seed: int = 0,
                          prefix: str = "lc", endorsers=None):
    """`n_tx` blind puts that mix `mycc` and the deployed `cc2` (the
    namespace of each drawn from `seed` with numpy), every
    `under_every`-th endorsed by a set its namespace's policy refuses:
    `endorsers` maps a namespace to its (meeting, refused) sets
    (LIFECYCLE_ENDORSERS by default: cc2's refused set is a MAJORITY of
    orgs).  Returns [(envelope, expected flag)]."""
    from fabric_mod_tpu_torch.protos import messages as m
    V = m.TxValidationCode
    endorsers = endorsers or LIFECYCLE_ENDORSERS
    rng = np.random.RandomState(seed)
    spaces = sorted(endorsers)
    puts, flags = [], []
    for i, pick in enumerate(rng.randint(len(spaces), size=n_tx)):
        ns = spaces[int(pick)]
        under = i % under_every == under_every - 1
        puts.append((ns, f"{prefix}{i}", b"v%d" % i,
                     endorsers[ns][int(under)]))
        flags.append(V.ENDORSEMENT_POLICY_FAILURE if under else V.VALID)
    envs = make_put_txs(world, puts, b"%s|%d" % (prefix.encode(), seed))
    return list(zip(envs, flags))


# --- config updates ----------------------------------------------------------

def config_with_batch_size(config, max_message_count: int):
    """A copy of channel `config` whose orderer BatchSize carries
    `max_message_count`: the desired config of a batch-size update."""
    from fabric_mod_tpu_torch.channelconfig.bundle import (
        BATCH_SIZE, ORDERER, groups_of, set_group, set_value, values_of)
    from fabric_mod_tpu_torch.protos import messages as m
    desired = m.Config.decode(config.encode())
    orderer = groups_of(desired.channel_group)[ORDERER]
    value = values_of(orderer)[BATCH_SIZE]
    batch = m.BatchSize.decode(value.value)
    batch.max_message_count = max_message_count
    value.value = batch.encode()
    set_value(orderer, BATCH_SIZE, value)
    set_group(desired.channel_group, ORDERER, orderer)
    return desired


def config_with_consenters(config, consenter_ids):
    """A copy of channel `config` whose Raft consenter set is
    `consenter_ids`: the desired config of a membership update."""
    from fabric_mod_tpu_torch.channelconfig.bundle import (
        CONSENSUS_TYPE, ORDERER, groups_of, set_group, set_value, values_of)
    from fabric_mod_tpu_torch.protos import messages as m
    desired = m.Config.decode(config.encode())
    orderer = groups_of(desired.channel_group)[ORDERER]
    value = values_of(orderer)[CONSENSUS_TYPE]
    ctype = m.ConsensusType.decode(value.value)
    ctype.metadata = m.RaftMetadata(consenters=list(consenter_ids)).encode()
    value.value = ctype.encode()
    set_value(orderer, CONSENSUS_TYPE, value)
    set_group(desired.channel_group, ORDERER, orderer)
    return desired


# --- rich queries: a JSON-document stream ----------------------------------

RICH_OWNERS = ("alice", "bob", "carol", "dave", "erin")
RICH_COLORS = ("red", "blue", "green", "yellow")


def make_rich_documents(n: int, seed: int = 0, prefix: str = "doc"
                        ) -> List[Tuple[str, bytes]]:
    """`n` (key, JSON document bytes) pairs made from `seed` with numpy:
    keys `<prefix>00000`.., each document {"owner", "size" (0-99),
    "color", "meta": {"score" (a float), "flag" (true / false, or 1 / 0:
    booleans against numbers), "tag" ("t0".."t9", absent in ~30%)}},
    the shapes the selector operators (implicit equality, $gt..$lte,
    $in, $nin, $exists, $not, $and, $or, $nor, dotted paths), sort,
    fields, limit and bookmark are exercised on."""
    rng = np.random.RandomState(seed)
    owners = rng.randint(len(RICH_OWNERS), size=n)
    sizes = rng.randint(100, size=n)
    colors = rng.randint(len(RICH_COLORS), size=n)
    scores = rng.randint(1000, size=n)
    flags = rng.randint(4, size=n)
    tags = rng.randint(14, size=n)
    out = []
    for i in range(n):
        meta = {"score": int(scores[i]) / 1000.0,
                "flag": (True, False, 1, 0)[int(flags[i])]}
        if tags[i] < 10:
            meta["tag"] = "t%d" % int(tags[i])
        doc = {"owner": RICH_OWNERS[int(owners[i])], "size": int(sizes[i]),
               "color": RICH_COLORS[int(colors[i])], "meta": meta}
        out.append(("%s%05d" % (prefix, i),
                    json.dumps(doc, sort_keys=True).encode()))
    return out


# --- private data: a collection definition and a private stream -------------

PVT_COLLECTION = "col1"


def network_world(material) -> CommitWorld:
    """A CommitWorld over an e2e.NetworkMaterial's orgs: its peers as
    "Org1".."Org3" and its client, on the genesis block's channel (no
    endorsement policy: a Channel reads its own)."""
    from fabric_mod_tpu_torch.channelconfig import config_from_block
    from fabric_mod_tpu_torch.protos import messages as m
    cid, _config = config_from_block(m.Block.decode(material.genesis))
    return world_from_pems(material.ca_pems,
                           dict(material.peers, client=material.client),
                           b"", channel_id=cid)


def make_pvt_blocks(world: CommitWorld, n_blocks: int, n_tx: int,
                    pad_blocks: int = 0, pvt_every: int = 10,
                    first_block: int = 0, prev_hash: bytes = b"",
                    members=("Org1", "Org2"), btl: int = 2,
                    seed: bytes = b"pvt"):
    """A private-data stream, chained from block `first_block` after
    `prev_hash`: a definition block (one tx writing `_lifecycle`
    `namespaces/mycc`: a ChaincodeDefinition whose collection
    PVT_COLLECTION has any member of each of `members` as its member-orgs
    policy and `btl` as its block-to-live), then `n_blocks` blocks of
    `n_tx` txs in which every `pvt_every`-th tx (j % pvt_every == 0)
    writes one private key of the collection (only its hashes enter the
    block) and the others a public key, then `pad_blocks` one-tx public
    blocks.  Every tx is endorsed by Org1 and Org2 and VALID under a
    2-of-3 or majority policy.

    Returns (blocks, plaintext, private_keys): the encoded blocks, each
    private tx's TxPvtReadWriteSet by tx id, and {tx id: (key,
    value)}."""
    from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder
    from fabric_mod_tpu_torch.peer.lifecycle import LIFECYCLE_NS, definition_key
    from fabric_mod_tpu_torch.policy import from_string
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    package = m.CollectionConfigPackage(config=[m.CollectionConfig(
        static_collection_config=m.StaticCollectionConfig(
            name=PVT_COLLECTION, block_to_live=btl,
            member_orgs_policy=from_string("OR(%s)" % ", ".join(
                f"'{o}.member'" for o in members))))])
    definition = m.ChaincodeDefinition(
        version="1.0", sequence=1, collections=package.encode()).encode()
    creator = world.signers["client"].serialize()
    plaintext, private_keys = {}, {}
    blocks, prev = [], prev_hash
    sizes = [1] + [n_tx] * n_blocks + [1] * pad_blocks
    for i, size in enumerate(sizes):
        num = first_block + i
        envs = []
        for j in range(size):
            nonce = hashlib.sha256(seed + b"|%d|%d" % (num, j)).digest()[:24]
            ts = 1_735_689_600_000_000_000 + (num * 100_000 + j) * 1000
            rw = RWSetBuilder()
            chaincode = NAMESPACE
            if i == 0:
                chaincode = LIFECYCLE_NS
                rw.add_write(LIFECYCLE_NS, definition_key(NAMESPACE),
                             definition)
            elif i <= n_blocks and j % pvt_every == 0:
                key = f"p{num}t{j}"
                value = hashlib.sha256(seed + key.encode()).hexdigest()[:32]
                rw.add_pvt_write(NAMESPACE, PVT_COLLECTION, key,
                                 value.encode())
                txid = protoutil.compute_tx_id(nonce, creator)
                plaintext[txid] = rw.build_pvt()
                private_keys[txid] = (key, value.encode())
            else:
                rw.add_write(NAMESPACE, f"b{num}t{j}", b"v")
            envs.append(_signed_tx(world, rw.build().encode(),
                                   ("Org1", "Org2"), nonce, ts,
                                   chaincode=chaincode))
        blk = protoutil.new_block(num, prev, envs)
        prev = protoutil.block_header_hash(blk.header)
        blocks.append(blk.encode())
    return blocks, plaintext, private_keys


# --- idemix: BASELINE.md config #4, an idemix MSP channel -------------------

IDEMIX_MSPID = "IdemixOrg"


@dataclasses.dataclass
class IdemixWorld:
    """An idemix membership: the issuer (its key carries the MSP's four
    attributes ou, role, enrollment, rh), the verifier's MSP over the
    issuer's public key and the Revocation Authority's public key, the
    users, and the Revocation Authority."""
    issuer: object
    msp: object
    users: List[object]
    ra: object


def make_idemix_world(seed: int = 0, n_users: int = 4) -> IdemixWorld:
    """An idemix world made from `seed`: issuer key, users (user 0 an
    admin client, then members alternating peer and client) and the RA
    key."""
    from fabric_mod_tpu_torch.idemix.revocation import RevocationAuthority
    from fabric_mod_tpu_torch.msp import idemixmsp
    rng = random.Random(seed)
    issuer = idemixmsp.IdemixIssuer(IDEMIX_MSPID, rng=rng)
    users = [issuer.issue_user(
        f"user{i}@{IDEMIX_MSPID.lower()}", ou=("client", "peer")[i % 2],
        role=idemixmsp.ROLE_ADMIN if i == 0 else idemixmsp.ROLE_MEMBER)
        for i in range(n_users)]
    ra = RevocationAuthority(sw.PrivateKey.from_seed(b"idemix-ra|%d" % seed))
    msp = idemixmsp.IdemixMsp(IDEMIX_MSPID, issuer.key,
                              revocation_pk_pem=ra.public_pem)
    return IdemixWorld(issuer, msp, users, ra)


def make_presentations(world: IdemixWorld, n: int, plant_every: int = 16,
                       seed: int = 0):
    """n presentations (sig, msg, disclosed), by the world's users in
    turn, each disclosing OU and role — `credential.batch_verify`'s
    items — and the verdicts it must give.  Every `plant_every`-th
    (i % plant_every == plant_every - 1) is planted, the kinds in turn:
    Ā tampered by + G (the pairing fails), a wrong disclosed value (the
    Schnorr check fails), A′ = identity (filtered before the pairing)."""
    from fabric_mod_tpu_torch.idemix import credential
    from fabric_mod_tpu_torch.idemix.fp256bn import G1, g1_add
    from fabric_mod_tpu_torch.msp.idemixmsp import ATTR_ROLE
    rng = random.Random(seed)
    items, expect = [], []
    for i in range(n):
        user = world.users[i % len(world.users)]
        msg = b"idemix-tx|%d|%d" % (seed, i)
        disclosed = user._disclosed()
        sig = credential.sign(world.issuer.key, user._cred, user._sk, msg,
                              disclosed, rng=rng)
        planted = i % plant_every == plant_every - 1
        if planted:
            kind = (i // plant_every) % 3
            if kind == 0:
                sig.A_bar = g1_add(sig.A_bar, G1.generator())
            elif kind == 1:
                disclosed = dict(disclosed)
                disclosed[ATTR_ROLE] += 1
            else:
                sig.A_prime = None
        items.append((sig, msg, disclosed))
        expect.append(not planted)
    return items, expect


def make_pairing_lanes(world: IdemixWorld, n: int, tamper_every: int = 97,
                       seed: int = 0):
    """Inputs of a full-width pairing check without n signatures:
    A_i = A_0 + i·G and Ā_i = Ā_0 + i·(x·G) with Ā_0 = x·A_0 (x the
    issuer's secret), so e(A_i, W) = e(Ā_i, g2) by construction; every
    `tamper_every`-th lane (i % tamper_every == tamper_every - 1) gets
    Ā + G.  Returns ([A_i], [Ā_i], expected mask)."""
    from fabric_mod_tpu_torch.idemix.fp256bn import R, G1, g1_add, g1_mul
    x = world.issuer.key.x
    g = G1.generator()
    a = g1_mul(random.Random(seed).randrange(1, R), g)
    abar, xg = g1_mul(x, a), g1_mul(x, g)
    a_pts, abar_pts, expect = [], [], []
    for i in range(n):
        bad = i % tamper_every == tamper_every - 1
        a_pts.append(a)
        abar_pts.append(g1_add(abar, g) if bad else abar)
        expect.append(not bad)
        a, abar = g1_add(a, g), g1_add(abar, xg)
    return a_pts, abar_pts, np.array(expect)


# the deliver fan-out cell's chain (bench.py:1948 `_fanout_chain`): 20
# blocks, the CONFIG block in the middle
FANOUT_BLOCKS = 20
FANOUT_CONFIG_AT = 10


def make_fanout_chain(channel_id: str, n_blocks: int = FANOUT_BLOCKS,
                      config_at: int = FANOUT_CONFIG_AT):
    """A committed chain for the deliver fan-out (the shape of the
    reference's bench.py:1948 `_fanout_chain`): each block holds three
    one-action endorser txs with a chaincode event (the filtered
    projection has real work) and one two-action tx (the batch scanner
    rejects it into the per-tx fallback); block `config_at` holds one
    CONFIG tx instead (the forced session re-check).  Every tx VALID,
    nonces and previous hashes fixed.  The reference's helper appends
    only the last action of its multi-action tx; this one appends both,
    as its docstring intends."""
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil

    def tx_bytes(txid, nactions=1):
        actions = []
        for _ in range(nactions):
            ev = m.ChaincodeEvent(chaincode_id="cc", tx_id=txid,
                                  event_name="moved",
                                  payload=b"p" * 64).encode()
            cca = m.ChaincodeAction(results=b"rw" * 32, events=ev)
            prp = m.ProposalResponsePayload(proposal_hash=b"h" * 32,
                                            extension=cca.encode())
            cap = m.ChaincodeActionPayload(
                chaincode_proposal_payload=b"cpp",
                action=m.ChaincodeEndorsedAction(
                    proposal_response_payload=prp.encode(),
                    endorsements=[m.Endorsement(endorser=b"e" * 64,
                                                signature=b"s" * 70)]))
            actions.append(m.TransactionAction(header=b"sh",
                                               payload=cap.encode()))
        return m.Transaction(actions=actions).encode()

    def env(txid, htype=m.HeaderType.ENDORSER_TRANSACTION, data=b""):
        ch = protoutil.make_channel_header(htype, channel_id, tx_id=txid)
        sh = protoutil.make_signature_header(b"creator", b"\x00" * 24)
        payload = protoutil.make_payload(ch, sh, data)
        return m.Envelope(payload=payload.encode(), signature=b"sig")

    blocks = []
    for b in range(n_blocks):
        if b == config_at:
            envs = [env(f"cfg-{b}", htype=m.HeaderType.CONFIG,
                        data=b"new-config")]
        else:
            envs = [env(f"t{b}-{i}", data=tx_bytes(f"t{b}-{i}"))
                    for i in range(3)]
            envs.append(env(f"t{b}-multi",
                            data=tx_bytes(f"t{b}-multi", nactions=2)))
        blk = protoutil.new_block(b, b"\x00" * 32, envs)
        protoutil.set_block_txflags(
            blk, bytes([m.TxValidationCode.VALID] * len(envs)))
        blocks.append(blk)
    return blocks
