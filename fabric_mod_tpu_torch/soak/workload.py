"""Mixed soak workload: interleaved x509 + idemix signer lanes.

The port's copy of fabric_mod_tpu/soak/workload.py, with its own copy of
the idemix fixture (soak/idemix_fixture.json).  The x509 lane's blocks
are verified on the card by the soak world's shared verifier; the
idemix lane signs, deserializes and verifies with `IdemixMsp` on the
host, as the reference's does: an idemix identity's `verify` is a host
verdict in both packages.

The x509 lane drives the full endorse -> broadcast -> order -> deliver
-> validate -> commit loop (the e2e pipeline) across every soak
channel, recording each ADMITTED envelope (broadcast returned success)
for the run-wide exactly-once audit — the broadcaststorm ledger-audit
invariant extended across hours of churn: a submit the ordering
service ACKED either commits exactly once or the retained envelope is
resubmitted at the quiesced tail until it does.

The idemix lane is the first scaled idemix scenario: anonymous BBS+
presentations signed and MSP-verified continuously alongside the x509
traffic.  Credentials come from a COMMITTED fixture
(soak/idemix_fixture.json) so the lane pays zero per-run issuer/
credential pairing setup — each unit of work is sign_message (fresh
unlinkable presentation) + IdemixMsp deserialize + verify (two host
pairings), with every 8th presentation tampered and required to
verify False so the lane proves the verdict path, not a
constant-True short circuit.

Both lanes park at a shared gate so the invariant checker can
quiesce traffic around convergence checks, and both survive transient
failures (leaderless windows, injected faults) by retrying — the
production client stance.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from fabric_mod_tpu_torch.concurrency import (RegisteredThread,
                                              assert_joined)
from fabric_mod_tpu_torch.observability import get_logger
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil

log = get_logger("soak.workload")

_FIXTURE_PATH = os.path.join(os.path.dirname(__file__),
                             "idemix_fixture.json")
_fixture_cache: Optional[dict] = None
_fixture_lock = threading.Lock()


def load_idemix_fixture() -> dict:
    """Pre-built idemix material: issuer key + issued credentials,
    deserialized once per process.  Returns {"msp", "issuer_key",
    "signers": [IdemixSigningIdentity, ...]}."""
    global _fixture_cache
    with _fixture_lock:
        if _fixture_cache is not None:
            return _fixture_cache
        from fabric_mod_tpu_torch.idemix import credential as idmx
        from fabric_mod_tpu_torch.msp import idemixmsp
        with open(_FIXTURE_PATH) as f:
            raw = json.load(f)
        ik = idmx.IssuerKey.from_dict(raw["issuer"])
        msp = idemixmsp.IdemixMsp(raw["mspid"], ik)
        signers = []
        for u in raw["users"]:
            user = idemixmsp.IdemixUser(
                raw["mspid"], int(u["sk"]),
                idmx.Credential.from_dict(u["cred"]),
                u["ou"], int(u["role"]))
            signers.append(idemixmsp.IdemixSigningIdentity(user, ik))
        _fixture_cache = {"msp": msp, "issuer_key": ik,
                          "signers": signers}
        return _fixture_cache


class _Unit:
    """Busy-count guard around one unit of lane work: pause() waits
    until no unit is in flight before declaring the gate quiesced."""

    __slots__ = ("_wl",)

    def __init__(self, wl: "MixedWorkload"):
        self._wl = wl

    def __enter__(self):
        with self._wl._lock:
            self._wl._busy += 1

    def __exit__(self, *exc):
        with self._wl._lock:
            self._wl._busy -= 1


class MixedWorkload:
    """Two lanes over a SoakWorld, pausable for quiesce windows."""

    def __init__(self, world, x509_gap_s: float = 0.12,
                 idemix_gap_s: float = 1.0, tamper_every: int = 8):
        self.world = world
        self._x509_gap = x509_gap_s
        self._idemix_gap = idemix_gap_s
        self._tamper_every = max(2, tamper_every)
        self._gate = threading.Event()
        self._gate.set()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._busy = 0
        # cid -> {txid: encoded envelope} — retained for the
        # resubmit-at-tail path of the exactly-once audit
        self.admitted: Dict[str, Dict[str, bytes]] = {
            cid: {} for cid in world.channel_ids}
        self.x509_count = 0
        self.idemix_count = 0
        self.idemix_tamper_rejects = 0
        self.submit_errors = 0
        self.errors: List[str] = []        # lane-fatal problems
        self._seq = 0
        self._threads: List[RegisteredThread] = []

    # -- gate --------------------------------------------------------------

    def _unit(self) -> "_Unit":
        """Context guard: one unit of lane work between gate checks."""
        return _Unit(self)

    def pause(self, timeout_s: float = 30.0) -> None:
        """Close the gate and wait for in-flight units to park."""
        self._gate.clear()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._busy == 0:
                    return
            time.sleep(0.01)
        raise RuntimeError("workload did not quiesce in time")

    def resume(self) -> None:
        self._gate.set()

    # -- lanes -------------------------------------------------------------

    def _x509_lane(self) -> None:
        world = self.world
        while not self._stop.is_set():
            if not self._gate.wait(timeout=0.25):
                continue
            if self._stop.is_set():
                return
            with self._unit():
                with self._lock:
                    i = self._seq
                    self._seq += 1
                cid = world.channel_ids[i % len(world.channel_ids)]
                try:
                    bcast = world.pick_broadcast(cid)
                    txid, env = self._make_and_submit(cid, i, bcast)
                    with self._lock:
                        self.admitted[cid][txid] = env
                        self.x509_count += 1
                except Exception as e:     # noqa: BLE001 — retry lane
                    with self._lock:
                        self.submit_errors += 1
                    log.debug("x509 submit retryable failure: %s", e)
                    time.sleep(0.1)
            self._stop.wait(self._x509_gap)

    def _make_and_submit(self, cid: str, i: int, bcast):
        """Endorse + submit one put-tx; returns (txid, env_bytes) —
        the envelope is retained so a tx lost to a leader kill can be
        RESUBMITTED verbatim at the quiesced tail."""
        world = self.world
        sp, prop, tx_id = protoutil.create_chaincode_proposal(
            cid, "mycc",
            [b"put", b"soak-k%d" % i, b"soak-v%d" % i], world.client)
        endorsers = list(world.endorsers[cid].values())
        responses = [e.process_proposal(sp) for e in endorsers]
        env = protoutil.create_tx_from_responses(prop, responses,
                                                 world.client)
        bcast.submit(env)
        return tx_id, env.encode()

    def resubmit(self, cid: str, txid: str) -> None:
        env = m.Envelope.decode(self.admitted[cid][txid])
        self.world.pick_broadcast(cid).submit(env)

    def _idemix_lane(self) -> None:
        fx = load_idemix_fixture()
        msp, signers = fx["msp"], fx["signers"]
        n = 0
        while not self._stop.is_set():
            if not self._gate.wait(timeout=0.25):
                continue
            if self._stop.is_set():
                return
            with self._unit():
                try:
                    signer = signers[n % len(signers)]
                    msg = b"soak-idemix-%d" % n
                    sig = signer.sign_message(msg)
                    ident = msp.deserialize_identity(signer.serialize())
                    if n % self._tamper_every == self._tamper_every - 1:
                        ok = ident.verify(msg + b"-tampered", sig)
                        if ok:
                            self.errors.append(
                                "idemix accepted a tampered "
                                "presentation")
                            return
                        with self._lock:
                            self.idemix_tamper_rejects += 1
                    else:
                        if not ident.verify(msg, sig):
                            self.errors.append(
                                "idemix rejected an honest "
                                "presentation")
                            return
                    with self._lock:
                        self.idemix_count += 1
                except Exception as e:     # noqa: BLE001
                    self.errors.append(f"idemix lane died: {e!r}")
                    return
                n += 1
            self._stop.wait(self._idemix_gap)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        for name, target in (("soak-x509-lane", self._x509_lane),
                             ("soak-idemix-lane", self._idemix_lane)):
            t = RegisteredThread(target=target, name=name,
                                 structure="MixedWorkload")
            self._threads.append(t)
            t.start()

    def stop(self) -> None:
        self._stop.set()
        self._gate.set()
        assert_joined(self._threads, owner="MixedWorkload", timeout=15)

    # -- audit surface -----------------------------------------------------

    def admitted_txids(self, cid: str) -> List[str]:
        with self._lock:
            return list(self.admitted[cid])

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {"x509": self.x509_count,
                    "idemix": self.idemix_count,
                    "idemix_tamper_rejects": self.idemix_tamper_rejects,
                    "submit_errors": self.submit_errors}


def committed_txids(ledger) -> List[str]:
    """Every VALID ENDORSER_TRANSACTION txid committed on a ledger,
    in order, duplicates INCLUDED (the audit counts multiplicity — an
    admitted tx applying to state twice is as much a failure as
    zero).  Only VALID flags count: a legitimately re-ordered
    envelope (raft repropose/park-requeue after a leadership change,
    or the audit's own tail resubmission racing a late flush) commits
    with DUPLICATE_TXID and applies nothing — that is the dedup
    mechanism WORKING, not an exactly-once violation."""
    V = m.TxValidationCode
    out: List[str] = []
    for num in range(1, ledger.height):
        block = ledger.get_block_by_number(num)
        if block is None:
            continue
        flags = protoutil.block_txflags(block)
        for i, env in enumerate(protoutil.get_envelopes(block)):
            try:
                payload = protoutil.unmarshal_envelope_payload(env)
                ch = m.ChannelHeader.decode(payload.header.channel_header)
            except Exception:
                continue
            if ch.type != m.HeaderType.ENDORSER_TRANSACTION or \
                    not ch.tx_id:
                continue
            if i < len(flags) and flags[i] != V.VALID:
                continue
            out.append(ch.tx_id)
    return out
