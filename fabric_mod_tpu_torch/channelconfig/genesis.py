"""Genesis config construction — the port's copy of
fabric_mod_tpu/channelconfig/genesis.py `standard_network` (:160) and the
builders it uses (reference: internal/configtxgen/encoder/encoder.go —
NewChannelGroup / NewApplicationGroup / NewOrdererGroup / NewOrgGroup).

The standard config tree: per-org groups carrying MSP material and
Readers/Writers/Admins/Endorsement signature policies, Application and
Orderer sections with implicit-meta roll-ups, channel-level values and
policies, wrapped into an unsigned genesis block (block 0 of every
chain).  The genesis envelope carries a fresh nonce, so two builds of
the same config differ in their bytes but not in their `Config`.
"""
from __future__ import annotations

from typing import Optional, Sequence

from fabric_mod_tpu_torch.channelconfig.bundle import (
    APPLICATION, BATCH_SIZE, BATCH_TIMEOUT, BLOCK_DATA_HASHING_STRUCTURE,
    BLOCK_VALIDATION_POLICY, CONSENSUS_TYPE, HASHING_ALGORITHM, MSP_KEY,
    ORDERER, set_group, set_policy, set_value)
from fabric_mod_tpu_torch.policy import policydsl
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil

ADMINS = "Admins"
READERS = "Readers"
WRITERS = "Writers"
ENDORSEMENT = "Endorsement"
LIFECYCLE_ENDORSEMENT = "LifecycleEndorsement"


def _sig_policy(dsl: str) -> m.Policy:
    return m.Policy(type=m.PolicyType.SIGNATURE,
                    value=policydsl.from_string(dsl).encode())


def _meta_policy(rule: int, sub_policy: str) -> m.Policy:
    return m.Policy(
        type=m.PolicyType.IMPLICIT_META,
        value=m.ImplicitMetaPolicy(sub_policy=sub_policy, rule=rule).encode())


def _config_policy(pol: m.Policy, mod_policy: str = ADMINS) -> m.ConfigPolicy:
    return m.ConfigPolicy(policy=pol, mod_policy=mod_policy)


def _config_value(msg, mod_policy: str = ADMINS) -> m.ConfigValue:
    return m.ConfigValue(value=msg.encode(), mod_policy=mod_policy)


def org_group(mspid: str, root_cert_pems: Sequence[bytes],
              node_ous: bool = True,
              admin_cert_pems: Sequence[bytes] = ()) -> m.ConfigGroup:
    """One organization's config group (reference: encoder.go
    NewOrdererOrgGroup/NewApplicationOrgGroup)."""
    fconf = m.FabricMSPConfig(
        name=mspid,
        root_certs=list(root_cert_pems),
        admins=list(admin_cert_pems),
        revocation_list=[],
        fabric_node_ous=m.FabricNodeOUs(enable=1) if node_ous else None)
    g = m.ConfigGroup(mod_policy=ADMINS)
    set_value(g, MSP_KEY, _config_value(
        m.MSPConfig(type=0, config=fconf.encode())))
    set_policy(g, READERS, _config_policy(
        _sig_policy(f"OR('{mspid}.member')")))
    set_policy(g, WRITERS, _config_policy(
        _sig_policy(f"OR('{mspid}.member')")))
    set_policy(g, ADMINS, _config_policy(
        _sig_policy(f"OR('{mspid}.admin')")))
    set_policy(g, ENDORSEMENT, _config_policy(
        _sig_policy(f"OR('{mspid}.peer')")))
    return g


def _std_meta_policies(g: m.ConfigGroup) -> None:
    set_policy(g, READERS, _config_policy(
        _meta_policy(m.ImplicitMetaRule.ANY, READERS)))
    set_policy(g, WRITERS, _config_policy(
        _meta_policy(m.ImplicitMetaRule.ANY, WRITERS)))
    set_policy(g, ADMINS, _config_policy(
        _meta_policy(m.ImplicitMetaRule.MAJORITY, ADMINS)))


def application_group(orgs: Sequence[m.ConfigGroup],
                      org_names: Sequence[str]) -> m.ConfigGroup:
    g = m.ConfigGroup(mod_policy=ADMINS)
    for name, org in zip(org_names, orgs):
        set_group(g, name, org)
    _std_meta_policies(g)
    set_policy(g, ENDORSEMENT, _config_policy(
        _meta_policy(m.ImplicitMetaRule.MAJORITY, ENDORSEMENT)))
    set_policy(g, LIFECYCLE_ENDORSEMENT, _config_policy(
        _meta_policy(m.ImplicitMetaRule.MAJORITY, ENDORSEMENT)))
    return g


def orderer_group(orgs: Sequence[m.ConfigGroup], org_names: Sequence[str],
                  consensus_type: str = "solo",
                  max_message_count: int = 500,
                  absolute_max_bytes: int = 10 * 1024 * 1024,
                  preferred_max_bytes: int = 2 * 1024 * 1024,
                  batch_timeout: str = "2s",
                  consenters: Sequence[str] = ()) -> m.ConfigGroup:
    g = m.ConfigGroup(mod_policy=ADMINS)
    for name, org in zip(org_names, orgs):
        set_group(g, name, org)
    _std_meta_policies(g)
    # block signatures validate against ANY orderer-org Writers
    # (reference: encoder.go NewOrdererGroup BlockValidation policy)
    set_policy(g, BLOCK_VALIDATION_POLICY, _config_policy(
        _meta_policy(m.ImplicitMetaRule.ANY, WRITERS)))
    set_value(g, BATCH_SIZE, _config_value(m.BatchSize(
        max_message_count=max_message_count,
        absolute_max_bytes=absolute_max_bytes,
        preferred_max_bytes=preferred_max_bytes)))
    set_value(g, BATCH_TIMEOUT, _config_value(
        m.BatchTimeout(timeout=batch_timeout)))
    set_value(g, CONSENSUS_TYPE, _config_value(m.ConsensusType(
        type=consensus_type,
        metadata=(m.RaftMetadata(consenters=list(consenters)).encode()
                  if consenters else b""))))
    return g


def channel_group(app: Optional[m.ConfigGroup],
                  ordr: Optional[m.ConfigGroup]) -> m.ConfigGroup:
    root = m.ConfigGroup(mod_policy=ADMINS)
    if app is not None:
        set_group(root, APPLICATION, app)
    if ordr is not None:
        set_group(root, ORDERER, ordr)
    _std_meta_policies(root)
    set_value(root, HASHING_ALGORITHM, _config_value(
        m.HashingAlgorithm(name="SHA256")))
    set_value(root, BLOCK_DATA_HASHING_STRUCTURE, _config_value(
        m.BlockDataHashingStructure(width=(1 << 32) - 1)))
    return root


def config_block(channel_id: str, config: m.Config, number: int = 0,
                 previous_hash: bytes = b"",
                 last_update: Optional[m.Envelope] = None) -> m.Block:
    """Wrap a Config into a CONFIG block (genesis when number == 0)."""
    cenv = m.ConfigEnvelope(config=config, last_update=last_update)
    ch = protoutil.make_channel_header(m.HeaderType.CONFIG, channel_id)
    sh = protoutil.make_signature_header(b"", protoutil.new_nonce())
    payload = protoutil.make_payload(ch, sh, cenv.encode())
    return protoutil.new_block(number, previous_hash,
                               [m.Envelope(payload=payload.encode())])


def standard_network(channel_id: str, org_cas: dict,
                     orderer_cas: dict, **orderer_kwargs) -> m.Block:
    """{mspid: [root PEM]} maps for the application and orderer orgs ->
    the genesis block (the e2e topology builder)."""
    app_orgs = [org_group(mspid, pems)
                for mspid, pems in sorted(org_cas.items())]
    ord_orgs = [org_group(mspid, pems)
                for mspid, pems in sorted(orderer_cas.items())]
    root = channel_group(
        application_group(app_orgs, sorted(org_cas)),
        orderer_group(ord_orgs, sorted(orderer_cas), **orderer_kwargs))
    return config_block(channel_id, m.Config(sequence=0, channel_group=root))
