"""Service discovery: peers, config, endorsement descriptors.

The port's copy of fabric_mod_tpu/discovery/service.py (`_satisfying_sets`
:46, `DiscoveryService` :126; reference: discovery/ — service.go:294's
query dispatch, endorsement/endorsement.go:84 PeersForEndorsement
computing the LAYOUTS (which combinations of peers satisfy a
chaincode's endorsement policy, :160 computeEndorsementResponse), the
auth cache of authcache.go:196, and common/graph's combinations).

The layout computation walks the compiled signature-policy tree and
enumerates the minimal principal multisets that satisfy it, then maps
principals to orgs and orgs to alive peers.

Access: `check_access` evaluates the channel's Readers policy over the
query's signed data with the `verify_many` the service is given — a
peer's `GpuVerifier.verify_many`, so the signature verifies on the card
— and caches the verdict keyed on the config sequence, so a config
update re-verifies every query it sees.
"""
from __future__ import annotations

import hashlib
import itertools
import threading
from typing import Dict, List, Optional, Sequence

from fabric_mod_tpu_torch.channelconfig.bundle import values_of
from fabric_mod_tpu_torch.msp.ca import cert_pem
from fabric_mod_tpu_torch.policy import policydsl
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos.protoutil import SignedData

MAX_LAYOUTS = 64                     # the combinatorics cap
AUTH_CACHE_CAP = 4096                # verdicts kept before a clear
READERS = "/Channel/Application/Readers"
ORDERER_ADDRESSES = "OrdererAddresses"


class DiscoveryError(Exception):
    pass


# -- layout computation ------------------------------------------------------

def _principal_org(principal: m.MSPPrincipal) -> Optional[str]:
    """Principal -> owning MSP id (role and OU principals carry it)."""
    if principal.principal_classification == \
            m.PrincipalClassification.ROLE:
        return m.MSPRole.decode(principal.principal).msp_identifier
    if principal.principal_classification == \
            m.PrincipalClassification.ORGANIZATION_UNIT:
        return m.OrganizationUnit.decode(
            principal.principal).msp_identifier
    return None


def _satisfying_sets(rule: m.SignaturePolicy,
                     principals: Sequence[m.MSPPrincipal]
                     ) -> List[Dict[int, int]]:
    """All minimal principal-index multisets satisfying `rule`
    ({principal_idx: count}), capped at MAX_LAYOUTS."""
    if rule.signed_by >= 0:
        return [{rule.signed_by: 1}]
    if rule.n_out_of is None:
        return []
    n = rule.n_out_of.n
    subs = rule.n_out_of.rules
    if n <= 0:
        return [{}]
    # every n-combination of sub-rules, their sets crossed
    out: List[Dict[int, int]] = []
    for combo in itertools.combinations(range(len(subs)), n):
        partials: List[Dict[int, int]] = [{}]
        for i in combo:
            subsets = _satisfying_sets(subs[i], principals)
            partials = [_merge(a, b) for a in partials for b in subsets]
            if len(partials) > MAX_LAYOUTS:
                partials = partials[:MAX_LAYOUTS]
        out.extend(partials)
        if len(out) > MAX_LAYOUTS:
            return out[:MAX_LAYOUTS]
    seen, deduped = set(), []
    for s in out:
        key = tuple(sorted(s.items()))
        if key not in seen:
            seen.add(key)
            deduped.append(s)
    return deduped


def _merge(a: Dict[int, int], b: Dict[int, int]) -> Dict[int, int]:
    """AND-combine: counts ADD — evaluation consumes one signature per
    satisfied leaf, so a principal in two AND branches needs two
    endorsements."""
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return out


class Layout:
    """One way to satisfy the policy: org -> how many endorsements."""

    __slots__ = ("quantities_by_org",)

    def __init__(self, quantities_by_org: Dict[str, int]):
        self.quantities_by_org = quantities_by_org

    def __repr__(self):
        return f"Layout({self.quantities_by_org})"


class EndorsementDescriptor:
    """(reference: the discovery protocol's EndorsementDescriptor)"""

    def __init__(self, chaincode: str, layouts: List[Layout],
                 peers_by_org: Dict[str, List[m.GossipMember]]):
        self.chaincode = chaincode
        self.layouts = layouts
        self.peers_by_org = peers_by_org

    def usable_layouts(self) -> List[Layout]:
        """The layouts the known alive peers can satisfy."""
        return [lo for lo in self.layouts
                if all(len(self.peers_by_org.get(org, [])) >= cnt
                       for org, cnt in lo.quantities_by_org.items())]


# -- the service -------------------------------------------------------------

class DiscoveryService:
    """One channel's discovery endpoint (reference: service.go)."""

    def __init__(self, bundle_fn, vinfo, membership_fn, verify_many):
        """`bundle_fn() -> Bundle`, the channel's live config;
        `vinfo.validation_info(cc) -> (plugin, ApplicationPolicy bytes)`
        resolves chaincode endorsement policies (the validator's own
        provider); `membership_fn() -> {org_mspid: [GossipMember]}`, the
        gossip view; `verify_many` checks the Readers signatures: a
        peer's `GpuVerifier.verify_many` on the card.  It has no default:
        the policy layer would read None as its host verifier."""
        if verify_many is None:
            raise ValueError("DiscoveryService needs a verify_many")
        self._bundle = bundle_fn
        self._vinfo = vinfo
        self._membership = membership_fn
        self._verify_many = verify_many
        self._auth_cache: Dict[bytes, bool] = {}
        self._auth_lock = threading.Lock()

    # -- auth (reference: authcache.go:196) ------------------------------
    def check_access(self, sd: SignedData) -> bool:
        bundle = self._bundle()
        # keyed on the config sequence too: an update that changes the
        # Readers policy must not be answered from earlier verdicts
        key = hashlib.sha256(
            bundle.sequence.to_bytes(8, "big")
            + sd.identity + sd.data + sd.signature).digest()
        with self._auth_lock:
            if key in self._auth_cache:
                return self._auth_cache[key]
        pol = bundle.policy(READERS)
        ok = pol is not None and pol.evaluate_signed_data(
            [sd], self._verify_many)
        with self._auth_lock:
            if len(self._auth_cache) > AUTH_CACHE_CAP:
                self._auth_cache.clear()
            self._auth_cache[key] = ok
        return ok

    # -- queries ----------------------------------------------------------
    def peers(self) -> Dict[str, List[m.GossipMember]]:
        return self._membership()

    def config(self) -> Dict:
        """(reference: the config query: the MSPs' root certificates
        and the orderer endpoints)"""
        bundle = self._bundle()
        out = {"msps": {}, "orderers": []}
        for msp in bundle.msp_manager.msps():
            out["msps"][msp.mspid] = [cert_pem(c) for c in msp.roots]
        vals = values_of(bundle.config.channel_group)
        if ORDERER_ADDRESSES in vals:
            out["orderers"] = list(m.OrdererAddresses.decode(
                vals[ORDERER_ADDRESSES].value).addresses)
        return out

    def peers_for_endorsement(self, chaincode: str
                              ) -> EndorsementDescriptor:
        """(reference: endorsement.go:84 PeersForEndorsement)"""
        _plugin, policy_bytes = self._vinfo.validation_info(chaincode)
        ap = m.ApplicationPolicy.decode(policy_bytes)
        bundle = self._bundle()
        if ap.signature_policy is not None:
            env = ap.signature_policy
        else:
            pol = bundle.policy(ap.channel_config_policy_reference)
            env = getattr(pol, "envelope", None)
            if env is None:
                # an implicit meta policy over the orgs' Endorsement
                # policies: a MAJORITY of the orgs (the default shape)
                orgs = sorted(bundle.application.org_mspids)
                need = len(orgs) // 2 + 1
                env = policydsl.from_string("OutOf(%d, %s)" % (
                    need, ", ".join(f"'{o}.peer'" for o in orgs)))
        if env.rule is None:
            raise DiscoveryError("policy has no rule")
        layouts = []
        for s in _satisfying_sets(env.rule, env.identities):
            by_org: Dict[str, int] = {}
            ok = True
            for idx, cnt in s.items():
                if idx >= len(env.identities):
                    ok = False
                    break
                org = _principal_org(env.identities[idx])
                if org is None:
                    ok = False
                    break
                by_org[org] = by_org.get(org, 0) + cnt
            if ok and by_org:
                layouts.append(Layout(by_org))
        return EndorsementDescriptor(chaincode, layouts, self._membership())
