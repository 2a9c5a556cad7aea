"""Config-update validation and application.

The port's copy of fabric_mod_tpu/channelconfig/configtx.py (reference:
common/configtx/validator.go:212 `ValidatorImpl` — ProposeConfigUpdate
— with update.go:203's authorizeUpdate and the configmap delta model).

A CONFIG_UPDATE carries a read_set (elements it depends on, pinned at
their current versions) and a write_set (elements it changes, each at
version current+1).  Validation:

  1. read_set versions must match the current config exactly;
  2. every write_set element equals the current one (same version,
     identical bytes — context carried along), bumps its version by
     exactly one (modified), or is new (version 0);
  3. each modified/new element's mod_policy — resolved against the
     CURRENT bundle's policy tree — must be satisfied by the update's
     signature set;
  4. the result is the current config with the write_set merged,
     sequence + 1.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from fabric_mod_tpu_torch.channelconfig.bundle import (
    Bundle, groups_of, policies_of, set_group, set_policy, set_value,
    values_of)
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.protos.protoutil import SignedData


class ConfigTxError(Exception):
    pass


def _verify_read_set(cur: Optional[m.ConfigGroup],
                     rs: m.ConfigGroup, path: str) -> None:
    if cur is None:
        raise ConfigTxError(f"read_set references missing group {path}")
    if rs.version != cur.version:
        raise ConfigTxError(
            f"read_set version mismatch at {path}: "
            f"{rs.version} != {cur.version}")
    cur_groups = groups_of(cur)
    for key, sub in groups_of(rs).items():
        _verify_read_set(cur_groups.get(key), sub, f"{path}/{key}")
    for kind, accessor in (("value", values_of), ("policy", policies_of)):
        cur_items = accessor(cur)
        for key, item in accessor(rs).items():
            if key not in cur_items:
                raise ConfigTxError(
                    f"read_set references missing {kind} {path}/{key}")
            if item.version != cur_items[key].version:
                raise ConfigTxError(
                    f"read_set {kind} version mismatch at {path}/{key}")


class _Change:
    """One modified/new element and the policy that must authorize it."""

    __slots__ = ("path", "policy_path")

    def __init__(self, path: str, policy_path: str):
        self.path = path
        self.policy_path = policy_path


def _resolve_policy_path(mod_policy: str, group_path: str) -> str:
    """mod_policy names resolve relative to their group unless absolute
    (reference: common/policies/util.go + update.go policyForItem)."""
    if not mod_policy:
        return ""
    if mod_policy.startswith("/"):
        return mod_policy
    return f"{group_path}/{mod_policy}"


def _merge_group(cur: Optional[m.ConfigGroup], wr: m.ConfigGroup,
                 group_path: str, changes: List[_Change]) -> m.ConfigGroup:
    """Return the merged group; record every version-bumped element.
    Group mod-policies resolve against the group's own path,
    value/policy mod-policies against their containing group."""
    if cur is None:
        # a brand-new group is authorized by its own mod_policy (an
        # empty one fails closed below)
        if wr.version != 0:
            raise ConfigTxError(
                f"new group {group_path} must have version 0")
        changes.append(_Change(
            group_path, _resolve_policy_path(wr.mod_policy, group_path)))
        cur = m.ConfigGroup()

    out = m.ConfigGroup(version=wr.version,
                        mod_policy=wr.mod_policy or cur.mod_policy)
    bumped = wr.version == cur.version + 1
    if bumped:
        changes.append(_Change(
            group_path, _resolve_policy_path(cur.mod_policy, group_path)))
    elif wr.version != cur.version:
        raise ConfigTxError(
            f"group {group_path}: version {wr.version} vs current "
            f"{cur.version} (must be same or +1)")

    # write_set entries overlay the current contents.  A version-bumped
    # group's membership is authoritative (elements it omits are
    # removed); an unbumped group only carries context.
    cur_groups, wr_groups = groups_of(cur), groups_of(wr)
    for key in sorted(set(cur_groups) | set(wr_groups)):
        if key in wr_groups:
            set_group(out, key, _merge_group(
                cur_groups.get(key), wr_groups[key],
                f"{group_path}/{key}", changes))
        elif not bumped:
            set_group(out, key, cur_groups[key])

    for kind, accessor, setter in (("value", values_of, set_value),
                                   ("policy", policies_of, set_policy)):
        cur_items = accessor(cur)
        wr_items = accessor(wr)
        for key in sorted(set(cur_items) | set(wr_items)):
            path = f"{group_path}/{key}"
            if key not in wr_items:
                if not bumped:
                    setter(out, key, cur_items[key])
                continue
            item = wr_items[key]
            cur_item = cur_items.get(key)
            if cur_item is None:
                if item.version != 0:
                    raise ConfigTxError(
                        f"new {kind} {path} must have version 0")
                changes.append(_Change(
                    path, _resolve_policy_path(item.mod_policy, group_path)))
            elif item.version == cur_item.version + 1:
                changes.append(_Change(
                    path,
                    _resolve_policy_path(cur_item.mod_policy, group_path)))
            elif item.version == cur_item.version:
                if item.encode() != cur_item.encode():
                    raise ConfigTxError(
                        f"{kind} {path} changed without version bump")
            else:
                raise ConfigTxError(
                    f"{kind} {path}: version {item.version} vs current "
                    f"{cur_item.version}")
            setter(out, key, item)
    return out


def _update_signature_set(cue: m.ConfigUpdateEnvelope) -> List[SignedData]:
    """(reference: configtx/update.go:203 — signed data is
    signature_header ‖ config_update per signature)"""
    sds = []
    for sig in cue.signatures:
        try:
            sh = m.SignatureHeader.decode(sig.signature_header)
        except Exception:
            continue
        sds.append(SignedData(data=sig.signature_header + cue.config_update,
                              identity=sh.creator, signature=sig.signature))
    return sds


def propose_config_update(bundle: Bundle, cue: m.ConfigUpdateEnvelope,
                          verify_many=None) -> m.Config:
    """Validate a ConfigUpdateEnvelope against `bundle`; return the new
    Config to adopt (reference: validator.go ProposeConfigUpdate)."""
    if not cue.config_update:
        raise ConfigTxError("empty config update")
    try:
        cu = m.ConfigUpdate.decode(cue.config_update)
    except Exception as e:
        raise ConfigTxError(f"bad ConfigUpdate: {e}") from e
    if cu.channel_id != bundle.channel_id:
        raise ConfigTxError(
            f"config update for channel {cu.channel_id!r}, "
            f"expected {bundle.channel_id!r}")
    if cu.write_set is None:
        raise ConfigTxError("config update has no write_set")
    if cu.read_set is not None:
        _verify_read_set(bundle.config.channel_group, cu.read_set,
                         "/Channel")

    changes: List[_Change] = []
    merged = _merge_group(bundle.config.channel_group, cu.write_set,
                          "/Channel", changes)
    if not changes:
        raise ConfigTxError("config update changes nothing")

    sds = _update_signature_set(cue)
    for ch in changes:
        if not ch.policy_path:
            raise ConfigTxError(
                f"element {ch.path} has no mod_policy (fail-closed)")
        pol = bundle.policy_manager.get_policy(ch.policy_path)
        if pol is None:
            raise ConfigTxError(
                f"mod_policy {ch.policy_path!r} for {ch.path} not found")
        if not pol.evaluate_signed_data(sds, verify_many):
            raise ConfigTxError(
                f"mod_policy {ch.policy_path!r} rejected change to "
                f"{ch.path}")
    return m.Config(sequence=bundle.sequence + 1, channel_group=merged)


def config_from_block(block: m.Block) -> Tuple[str, m.Config]:
    """(channel_id, Config) of a CONFIG block, genesis or later."""
    envs = protoutil.get_envelopes(block)
    if len(envs) != 1:
        raise ConfigTxError("config block must carry exactly one tx")
    payload = protoutil.unmarshal_envelope_payload(envs[0])
    ch = m.ChannelHeader.decode(payload.header.channel_header)
    if ch.type != m.HeaderType.CONFIG:
        raise ConfigTxError("not a CONFIG envelope")
    cenv = m.ConfigEnvelope.decode(payload.data)
    if cenv.config is None:
        raise ConfigTxError("CONFIG envelope has no config")
    return ch.channel_id, cenv.config


def extract_config_update(env: m.Envelope) -> m.ConfigUpdateEnvelope:
    """Unwrap a client-submitted CONFIG_UPDATE envelope."""
    payload = protoutil.unmarshal_envelope_payload(env)
    ch = m.ChannelHeader.decode(payload.header.channel_header)
    if ch.type != m.HeaderType.CONFIG_UPDATE:
        raise ConfigTxError("not a CONFIG_UPDATE envelope")
    return m.ConfigUpdateEnvelope.decode(payload.data)
