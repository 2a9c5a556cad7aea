"""Typed, immutable view of a channel's on-ledger configuration.

The port's copy of fabric_mod_tpu/channelconfig/bundle.py `Bundle`
(:174; reference: common/channelconfig/bundle.go — the materialized
config-tx view every service consults — plus api.go:262's typed
Application/Orderer accessors), over the port's own X.509 layer
(bccsp/x509.py) where the reference reads `cryptography` or its
`_x509fallback`.

A Bundle is built once from a `Config` proto tree and never mutated;
a config update produces a NEW bundle that its owner (registrar,
channel) swaps in atomically, so a block validates against exactly one
bundle snapshot.  The policy tree and MSP manager are materialized
here: signature policies compile to the two-phase batch evaluators of
policy/cauthdsl.py, implicit meta policies resolve over the group tree
like common/policies/implicitmeta.go.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from fabric_mod_tpu_torch.bccsp import x509
from fabric_mod_tpu_torch.msp.cache import CachedMsp
from fabric_mod_tpu_torch.msp.mspimpl import Msp, MspManager, NodeOUs
from fabric_mod_tpu_torch.policy.cauthdsl import PolicyError
from fabric_mod_tpu_torch.policy.manager import (PolicyManager,
                                                 compile_policy_bytes)
from fabric_mod_tpu_torch.protos import messages as m

# Canonical group / value keys (reference: common/channelconfig/api.go)
APPLICATION = "Application"
ORDERER = "Orderer"
MSP_KEY = "MSP"
BATCH_SIZE = "BatchSize"
BATCH_TIMEOUT = "BatchTimeout"
CONSENSUS_TYPE = "ConsensusType"
CAPABILITIES = "Capabilities"
HASHING_ALGORITHM = "HashingAlgorithm"
BLOCK_DATA_HASHING_STRUCTURE = "BlockDataHashingStructure"

BLOCK_VALIDATION_POLICY = "BlockValidation"


class ConfigError(Exception):
    pass


# -- map-style accessors over the repeated entry encoding -------------------

def groups_of(g: m.ConfigGroup) -> Dict[str, m.ConfigGroup]:
    return {e.key: e.value for e in g.groups if e.value is not None}


def values_of(g: m.ConfigGroup) -> Dict[str, m.ConfigValue]:
    return {e.key: e.value for e in g.values if e.value is not None}


def policies_of(g: m.ConfigGroup) -> Dict[str, m.ConfigPolicy]:
    return {e.key: e.value for e in g.policies if e.value is not None}


def set_group(g: m.ConfigGroup, key: str, sub: m.ConfigGroup) -> None:
    g.groups = [e for e in g.groups if e.key != key]
    g.groups.append(m.ConfigGroupEntry(key=key, value=sub))
    g.groups.sort(key=lambda e: e.key)


def set_value(g: m.ConfigGroup, key: str, val: m.ConfigValue) -> None:
    g.values = [e for e in g.values if e.key != key]
    g.values.append(m.ConfigValueEntry(key=key, value=val))
    g.values.sort(key=lambda e: e.key)


def set_policy(g: m.ConfigGroup, key: str, pol: m.ConfigPolicy) -> None:
    g.policies = [e for e in g.policies if e.key != key]
    g.policies.append(m.ConfigPolicyEntry(key=key, value=pol))
    g.policies.sort(key=lambda e: e.key)


# -- MSP materialization ----------------------------------------------------

def msp_from_config(conf: m.MSPConfig, csp) -> Msp:
    """FabricMSPConfig -> live Msp (reference: msp/configbuilder.go +
    mspimplsetup.go — certs, NodeOUs).  The port carries no CRL parser,
    so a config with a revocation list is refused rather than read
    without it."""
    if conf.type != 0:
        raise ConfigError(f"unsupported MSP type {conf.type}")
    f = m.FabricMSPConfig.decode(conf.config)
    if not f.name or not f.root_certs:
        raise ConfigError("MSP config needs a name and root certs")
    if f.revocation_list:
        raise ConfigError(f"MSP {f.name}: revocation lists are not "
                          "supported by this package")
    roots = [x509.load_pem_x509_certificate(c) for c in f.root_certs]
    inters = [x509.load_pem_x509_certificate(c)
              for c in f.intermediate_certs]
    admins = [x509.load_pem_x509_certificate(c) for c in f.admins]
    node_ous = None
    if f.fabric_node_ous is not None and f.fabric_node_ous.enable:
        nu = f.fabric_node_ous

        def ou(ident, default):
            return (ident.organizational_unit_identifier
                    if ident is not None and
                    ident.organizational_unit_identifier else default)
        node_ous = NodeOUs(
            enable=True,
            client_ou=ou(nu.client_ou_identifier, "client"),
            peer_ou=ou(nu.peer_ou_identifier, "peer"),
            admin_ou=ou(nu.admin_ou_identifier, "admin"),
            orderer_ou=ou(nu.orderer_ou_identifier, "orderer"))
    return Msp(f.name, csp, roots, inters, admins, node_ous=node_ous)


# -- typed sections ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OrdererConfig:
    """(reference: channelconfig/orderer.go OrdererConfig)"""
    batch_size: m.BatchSize
    batch_timeout_s: float
    consensus_type: str
    consensus_metadata: bytes
    org_mspids: Tuple[str, ...]
    capabilities: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class ApplicationConfig:
    """(reference: channelconfig/application.go ApplicationConfig)"""
    org_mspids: Tuple[str, ...]
    capabilities: Tuple[str, ...]


def _parse_timeout(s: str) -> float:
    """Duration strings the way the reference's yaml uses them: "2s",
    "500ms", "1m"."""
    s = s.strip()
    for suffix, mult in (("ms", 1e-3), ("s", 1.0), ("m", 60.0)):
        if s.endswith(suffix):
            return float(s[:-len(suffix)]) * mult
    return float(s)


def _capabilities(values: Dict[str, m.ConfigValue]) -> Tuple[str, ...]:
    cv = values.get(CAPABILITIES)
    if cv is None:
        return ()
    return tuple(e.key for e in m.Capabilities.decode(cv.value).capabilities)


# -- the bundle -------------------------------------------------------------

class Bundle:
    """Immutable channel config snapshot: raw tree + typed views +
    policy/MSP managers (reference: channelconfig/bundle.go)."""

    def __init__(self, channel_id: str, config: m.Config, csp):
        if config.channel_group is None:
            raise ConfigError("config has no channel group")
        self.channel_id = channel_id
        self.config = config
        self.sequence = config.sequence
        root = config.channel_group
        top = groups_of(root)

        # MSPs first (policies compile against them)
        msps: List[Msp] = []
        for section in (APPLICATION, ORDERER):
            sec = top.get(section)
            if sec is None:
                continue
            for org_name, org in groups_of(sec).items():
                mv = values_of(org).get(MSP_KEY)
                if mv is None:
                    raise ConfigError(f"org {org_name} has no MSP value")
                msps.append(msp_from_config(m.MSPConfig.decode(mv.value),
                                            csp))
        # second-chance caches around the manager, per bundle: every
        # policy of the tree and every consumer of this bundle shares
        # them.  The port's X.509 chain check is pure Python (~3 ms per
        # identity), and a channel policy reference stages each
        # signature once per sub-policy, so uncached a 1000-tx block
        # would pay it thousands of times.  A config update builds a new
        # bundle and so starts cold (reference: the peer's CachedMsp,
        # msp/cache/cache.go).
        self.msp_manager = CachedMsp(MspManager(msps))

        # the policy tree mirrors the group tree (reference: the policy
        # manager is built per config in policies.NewManagerImpl)
        self.policy_manager = self._build_policy_tree("Channel", root)

        self.orderer: Optional[OrdererConfig] = None
        osec = top.get(ORDERER)
        if osec is not None:
            vals = values_of(osec)
            if BATCH_SIZE not in vals or BATCH_TIMEOUT not in vals:
                raise ConfigError("orderer group needs BatchSize/BatchTimeout")
            ctv = (m.ConsensusType.decode(vals[CONSENSUS_TYPE].value)
                   if CONSENSUS_TYPE in vals else m.ConsensusType(type="solo"))
            self.orderer = OrdererConfig(
                batch_size=m.BatchSize.decode(vals[BATCH_SIZE].value),
                batch_timeout_s=_parse_timeout(
                    m.BatchTimeout.decode(vals[BATCH_TIMEOUT].value).timeout),
                consensus_type=ctv.type or "solo",
                consensus_metadata=ctv.metadata,
                org_mspids=tuple(sorted(groups_of(osec))),
                capabilities=_capabilities(vals))

        self.application: Optional[ApplicationConfig] = None
        asec = top.get(APPLICATION)
        if asec is not None:
            self.application = ApplicationConfig(
                org_mspids=tuple(sorted(groups_of(asec))),
                capabilities=_capabilities(values_of(asec)))

    def _build_policy_tree(self, name: str,
                           group: m.ConfigGroup) -> PolicyManager:
        mgr = PolicyManager(name)
        for key, sub in sorted(groups_of(group).items()):
            mgr.add_sub_manager(self._build_policy_tree(key, sub))
        metas: List[Tuple[str, m.ImplicitMetaPolicy]] = []
        for pname, cp in sorted(policies_of(group).items()):
            pol = cp.policy
            if pol is None:
                continue
            if pol.type == m.PolicyType.SIGNATURE:
                mgr.add_policy(pname, compile_policy_bytes(
                    pol.value, self.msp_manager, self.sequence))
            elif pol.type == m.PolicyType.IMPLICIT_META:
                metas.append((pname, m.ImplicitMetaPolicy.decode(pol.value)))
            else:
                raise PolicyError(f"unsupported policy type {pol.type}")
        for pname, meta in metas:
            mgr.resolve_implicit_meta(pname, meta)
        return mgr

    # -- conveniences used by orderer/peer wiring ------------------------
    def batch_config(self):
        from fabric_mod_tpu_torch.orderer.blockcutter import BatchConfig
        oc = self.orderer
        if oc is None:
            raise ConfigError("no orderer section in channel config")
        return BatchConfig(
            max_message_count=oc.batch_size.max_message_count,
            absolute_max_bytes=oc.batch_size.absolute_max_bytes,
            preferred_max_bytes=oc.batch_size.preferred_max_bytes,
            batch_timeout_s=oc.batch_timeout_s)

    def policy(self, path: str):
        return self.policy_manager.get_policy(path)
