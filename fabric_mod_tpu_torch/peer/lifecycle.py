"""Chaincode lifecycle: org approvals and committed definitions.

The port of fabric_mod_tpu/peer/lifecycle.py (reference:
core/chaincode/lifecycle — the `_lifecycle` system chaincode's
ApproveChaincodeDefinitionForMyOrg, CheckCommitReadiness and
CommitChaincodeDefinition at scc.go:911, the approval bookkeeping at
lifecycle.go:770; committed definitions feed the plugin dispatcher,
plugindispatcher/dispatcher.go:102, per namespace).

The ceremony: each org APPROVES the exact definition parameters (a
digest of version, sequence, policy, collections and plugin, stored
under `approvals/<cc>/<seq>/<mspid>`); COMMIT succeeds only when a
MAJORITY of the channel's application orgs approved the committed
parameters.

An approval is an org-local act: it is endorsed by one org and validates
against that org's own Endorsement policy.  Commit and every other
`_lifecycle` write validate against LifecycleEndorsement.
`LifecycleValidationInfo.validation_info_for_writes` makes the split by
the tx's written keys.

A definition lives in the `_lifecycle` namespace under `namespaces/<cc>`
and names the namespace's validation plugin and endorsement policy; it
arrives by an ordinary endorsed tx, so it is ordered, MVCC-checked and
in force from the NEXT block on.  A namespace without one validates
against the channel's default policy.
"""
from __future__ import annotations

import hashlib
import json
import re
from typing import Callable, List, Optional, Tuple

from fabric_mod_tpu_torch.peer.chaincode import ChaincodeError, ChaincodeStub
from fabric_mod_tpu_torch.protos import messages as m

LIFECYCLE_NS = "_lifecycle"

_APPROVAL_RE = re.compile(r"^approvals/([^/]+)/(\d+)/([^/]+)$")


def definition_key(cc_name: str) -> str:
    return f"namespaces/{cc_name}"


def approval_key(cc_name: str, sequence: int, mspid: str) -> str:
    return f"approvals/{cc_name}/{sequence}/{mspid}"


def _param_digest(version: str, sequence: int, policy: bytes,
                  collections: bytes, plugin: str) -> bytes:
    """An approval binds to the exact parameters, the validation plugin
    included: approving (v1, policy A, vscc) is not approving (v1,
    policy A, another plugin)."""
    h = hashlib.sha256()
    for part in (version.encode(), str(sequence).encode(), policy,
                 collections, plugin.encode()):
        h.update(len(part).to_bytes(4, "big"))
        h.update(part)
    return h.digest()


class LifecycleContract:
    """The `_lifecycle` system chaincode.  args [op, ...]:

      approve(name, version, sequence, policy, collections[, plugin]) —
        record the creator's org's approval;
      checkcommitreadiness(same) -> JSON {org: approved};
      commit(same) — needs matching approvals from a majority of the
        channel's application orgs;
      queryapproved(name, sequence) -> the creator org's digest, hex;
      query(name) -> the committed definition's bytes.

    `channel_orgs`: () -> the channel's application MSP ids, read at
    every call.  (The reference's is optional and, left out, lets a
    commit through with no approvals; nothing here builds it so.)"""

    def __init__(self, channel_orgs: Callable[[], List[str]]):
        self._channel_orgs = channel_orgs

    @staticmethod
    def _def_args(stub: ChaincodeStub):
        name = stub.args[1].decode()
        version = stub.args[2].decode()
        sequence = int(stub.args[3].decode())
        policy = stub.args[4] if len(stub.args) > 4 else b""
        collections = stub.args[5] if len(stub.args) > 5 else b""
        plugin = (stub.args[6].decode()
                  if len(stub.args) > 6 and stub.args[6] else "vscc")
        if collections:                     # must decode as a package
            m.CollectionConfigPackage.decode(collections)
        if "/" in name:
            raise ChaincodeError(f"invalid chaincode name {name!r}")
        return name, version, sequence, policy, collections, plugin

    @staticmethod
    def _committed(stub: ChaincodeStub, name: str):
        prev = stub.get_state(definition_key(name))
        return m.ChaincodeDefinition.decode(prev) if prev else None

    def _check_sequence(self, stub: ChaincodeStub, name: str,
                        sequence: int) -> None:
        prev = self._committed(stub, name)
        prev_seq = prev.sequence if prev is not None else 0
        if sequence != prev_seq + 1:
            raise ChaincodeError(
                f"definition sequence {sequence} != expected "
                f"{prev_seq + 1}")

    def _approvals(self, stub: ChaincodeStub, name: str, sequence: int,
                   digest: bytes):
        """{org: approved with matching parameters} over the channel's
        orgs."""
        orgs = list(self._channel_orgs())
        out = {}
        for org in orgs:
            got = stub.get_state(approval_key(name, sequence, org))
            out[org] = bool(got) and got == digest
        return out

    def invoke(self, stub: ChaincodeStub) -> bytes:
        if not stub.args:
            raise ChaincodeError("no args")
        op = stub.args[0].decode()

        if op == "approve":
            # the approving org is the creator's: the key embeds it, so
            # one org never writes another's approval, and validation
            # pins the tx to that org's Endorsement policy
            name, version, sequence, policy, collections, plugin = \
                self._def_args(stub)
            mspid = stub.creator_mspid()
            if not mspid:
                raise ChaincodeError("approve: no creator identity")
            # a late org may approve the committed sequence to catch up
            # when the parameters match; anything else is committed + 1
            prev = self._committed(stub, name)
            if prev is not None and sequence == prev.sequence:
                if (prev.version != version
                        or prev.endorsement_policy != policy
                        or prev.validation_plugin != plugin
                        or prev.collections != collections):
                    raise ChaincodeError(
                        f"approve for committed sequence {sequence} "
                        f"must match the committed definition")
            else:
                self._check_sequence(stub, name, sequence)
            stub.put_state(
                approval_key(name, sequence, mspid),
                _param_digest(version, sequence, policy, collections,
                              plugin))
            return b"ok"

        if op == "checkcommitreadiness":
            name, version, sequence, policy, collections, plugin = \
                self._def_args(stub)
            digest = _param_digest(version, sequence, policy,
                                   collections, plugin)
            ready = self._approvals(stub, name, sequence, digest)
            return json.dumps(ready, sort_keys=True).encode()

        if op == "queryapproved":
            name = stub.args[1].decode()
            sequence = int(stub.args[2].decode())
            got = stub.get_state(approval_key(name, sequence,
                                              stub.creator_mspid()))
            return got.hex().encode() if got else b""

        if op == "commit":
            name, version, sequence, policy, collections, plugin = \
                self._def_args(stub)
            self._check_sequence(stub, name, sequence)
            digest = _param_digest(version, sequence, policy, collections,
                                   plugin)
            ready = self._approvals(stub, name, sequence, digest)
            if not ready:
                # 1-of-0 is unsatisfiable: say why
                raise ChaincodeError(
                    "commit: channel has no application orgs to approve "
                    "definitions")
            yes = sum(ready.values())
            need = len(ready) // 2 + 1  # MAJORITY of the orgs
            if yes < need:
                raise ChaincodeError(
                    f"commit of {name!r} sequence {sequence}: approvals "
                    f"{yes}/{len(ready)} (need {need}): {ready}")
            d = m.ChaincodeDefinition(
                sequence=sequence, version=version,
                endorsement_policy=policy, validation_plugin=plugin,
                collections=collections)
            stub.put_state(definition_key(name), d.encode())
            return b"ok"

        if op == "query":
            raw = stub.get_state(definition_key(stub.args[1].decode()))
            return raw if raw is not None else b""
        raise ChaincodeError(f"unknown lifecycle op {op!r}")


class LifecycleValidationInfo:
    """Namespace -> (plugin, policy) from committed definitions, else
    the channel default; `_lifecycle` itself is governed by
    /Channel/Application/LifecycleEndorsement, except an org-local
    approval (`validation_info_for_writes`)."""

    def __init__(self, state_get: Callable[[str, str], Optional[bytes]],
                 default_policy: bytes,
                 lifecycle_policy: Optional[bytes] = None):
        self._state_get = state_get
        self._default = default_policy
        self._lifecycle_policy = lifecycle_policy or m.ApplicationPolicy(
            channel_config_policy_reference=
            "/Channel/Application/LifecycleEndorsement").encode()

    def validation_info(self, ns: str) -> Tuple[str, bytes]:
        if ns == LIFECYCLE_NS:
            return "vscc", self._lifecycle_policy
        raw = self._state_get(LIFECYCLE_NS, definition_key(ns))
        if raw:
            try:
                d = m.ChaincodeDefinition.decode(raw)
            except Exception:
                # a malformed on-ledger definition falls through to the
                # default policy, as the reference does
                d = None
            if d is not None and d.endorsement_policy:
                return (d.validation_plugin or "vscc",
                        d.endorsement_policy)
        return "vscc", self._default

    def validation_info_for_writes(self, ns: str, written_keys: List[str]
                                   ) -> Tuple[str, bytes]:
        """A `_lifecycle` tx whose writes are all one org's approval
        keys validates against /Channel/Application/<org>/Endorsement."""
        if ns == LIFECYCLE_NS and written_keys:
            orgs = set()
            for key in written_keys:
                got = _APPROVAL_RE.match(key)
                if got is None:
                    orgs = None
                    break
                orgs.add(got.group(3))
            if orgs is not None and len(orgs) == 1:
                return "vscc", m.ApplicationPolicy(
                    channel_config_policy_reference=
                    f"/Channel/Application/{orgs.pop()}/Endorsement"
                ).encode()
        return self.validation_info(ns)
