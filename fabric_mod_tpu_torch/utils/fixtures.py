"""Signature fixtures — real P-256 signatures from seeds, with the
expected verdict mask.

The port's copy of fabric_mod_tpu/utils/fixtures.py's verify fixtures
(`make_verify_items`, `signature_arrays`), plus `make_block`: the
signature traffic of one committed block — 1000 transactions under a
2-of-3 endorsement policy (the txvalidator configuration of BASELINE.md
#2), so 1000 creator + 2000 endorser signatures.  Everything is made by
the pure-python signer (bccsp/sw.py) from a seed: no `cryptography`
wheel and no randomness outside the seed.
"""
from __future__ import annotations

import dataclasses
import datetime
import hashlib
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

    def committer(self, verifier, tensor_policy: bool = False):
        """A Committer over a fresh in-memory ledger, wired for
        key-level policies and duplicate-txid checks against it."""
        from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
        from fabric_mod_tpu_torch.peer.txvalidator import (
            VALIDATION_PARAMETER, Committer, TxValidator,
            ValidationInfoProvider)
        from fabric_mod_tpu_torch.policy import ApplicationPolicyEvaluator
        led = KvLedger(self.channel_id)

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
               bad_endorser: Optional[int] = None):
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
        chaincode_id=m.ChaincodeID(name=NAMESPACE))
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
                          **batch_config):
    """An e2e.NetworkMaterial made from `seed`: a CA per org of
    NETWORK_ORGS and one for the orderer org, a peer and an admin per
    org, a client of the first org, the orderer's signer, and the
    standard genesis block (the
    configtxgen step of the reference's e2e Network) with the orderer
    group's `batch_config` (genesis.orderer_group's max_message_count,
    batch_timeout, preferred_max_bytes, ...).  Certificates and keys
    are the same for the same seed; the genesis envelope carries a
    fresh nonce."""
    from fabric_mod_tpu_torch.channelconfig import genesis
    from fabric_mod_tpu_torch.e2e import NetworkMaterial
    from fabric_mod_tpu_torch.msp import ca as calib
    tag = b"network|%d" % seed

    def signer(ca, cn, org, ou):
        cert, key = ca.issue(cn, org, ous=[ou])
        return (org, cert.pem(), calib.key_pem(key))
    cas = {org: calib.CA(f"ca.{org.lower()}", org, seed=tag, now=CERT_EPOCH)
           for org in NETWORK_ORGS}
    orderer_ca = calib.CA("ca.orderer", "OrdererOrg", seed=tag,
                          now=CERT_EPOCH)
    first = NETWORK_ORGS[0]
    block = genesis.standard_network(
        channel_id, {org: [ca.cert_pem()] for org, ca in cas.items()},
        {"OrdererOrg": [orderer_ca.cert_pem()]}, **batch_config)
    return NetworkMaterial(
        ca_pems={org: ca.cert_pem() for org, ca in cas.items()},
        orderer_ca_pem=orderer_ca.cert_pem(),
        client=signer(cas[first], f"client@{first.lower()}", first,
                      "client"),
        peers={org: signer(ca, f"peer0.{org.lower()}", org, "peer")
               for org, ca in cas.items()},
        admins={org: signer(ca, f"admin@{org.lower()}", org, "admin")
                for org, ca in cas.items()},
        orderer=signer(orderer_ca, "orderer0", "OrdererOrg", "orderer"),
        genesis=block.encode())


# the key-level endorsement policy the e2e stream's setvp txs pin
E2E_PIN_POLICY = b"OR('Org1.peer')"


def make_e2e_stream(net, n_tx: int, plant_every: int = 50):
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
