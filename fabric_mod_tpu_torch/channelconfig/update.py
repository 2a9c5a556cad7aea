"""Config-update computation: diff two configs into a ConfigUpdate.

The port's copy of fabric_mod_tpu/channelconfig/update.py (reference:
internal/configtxlator/update/update.go `Compute` — the tool that turns
(current config, desired config) into the minimal read_set/write_set
pair clients sign and submit).

Semantics mirrored from the reference:
* an element whose bytes change gets version+1 in the write_set;
* a group whose membership changes (add/remove) bumps its own version
  and carries its FULL desired membership (merge treats bumped
  membership as authoritative, so removals work);
* unchanged elements inside a bumped group ride along at their current
  version as context; unchanged groups are omitted entirely;
* the read_set pins every group on the path to a change at its
  current version (version stubs, no bodies).
"""
from __future__ import annotations

from typing import Optional, Tuple

from fabric_mod_tpu_torch.channelconfig.bundle import (
    groups_of, policies_of, set_group, set_policy, set_value, values_of)
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil


class UpdateComputeError(Exception):
    pass


def _items_equal(a, b) -> bool:
    return a.encode() == b.encode()


def _compute_group(cur: m.ConfigGroup, new: m.ConfigGroup
                   ) -> Tuple[Optional[m.ConfigGroup],
                              Optional[m.ConfigGroup], bool]:
    """Returns (read_stub, write_group, changed)."""
    read = m.ConfigGroup(version=cur.version)
    write = m.ConfigGroup(version=cur.version,
                          mod_policy=new.mod_policy or cur.mod_policy)

    cg, ng = groups_of(cur), groups_of(new)
    cv_all = {acc: (acc(cur), acc(new))
              for acc in (values_of, policies_of)}

    # pass 1: does THIS group's version bump?  (membership or mod_policy
    # or any direct value/policy difference — reference: update.go's
    # sameness check covers the whole group body)
    changed_here = (new.mod_policy not in ("", cur.mod_policy)
                    or set(cg) != set(ng))
    for accessor in (values_of, policies_of):
        cv, nv = cv_all[accessor]
        if set(cv) != set(nv):
            changed_here = True
            continue
        for key in nv:
            if not _items_equal(_strip_version(cv[key]),
                                _strip_version(nv[key])):
                changed_here = True
                break

    # pass 2: emit.  A bumped group's write_set carries its FULL
    # membership (the merge treats it as authoritative), exactly like
    # the reference's Compute emitting the whole updated group.
    child_changed = False
    for key in sorted(set(cg) & set(ng)):
        r, w, ch = _compute_group(cg[key], ng[key])
        if ch:
            child_changed = True
            set_group(read, key, r)
            set_group(write, key, w)
        elif changed_here:
            set_group(write, key, ng[key])
    for key in sorted(set(ng) - set(cg)):
        set_group(write, key, _zero_versions(ng[key]))

    for accessor, setter in ((values_of, set_value),
                             (policies_of, set_policy)):
        cv, nv = cv_all[accessor]
        for key in sorted(set(nv)):
            if key not in cv:
                setter(write, key, _copy_item(nv[key], version=0))
            elif not _items_equal(_strip_version(cv[key]),
                                  _strip_version(nv[key])):
                setter(write, key,
                       _copy_item(nv[key], version=cv[key].version + 1))
            elif changed_here:
                setter(write, key,
                       _copy_item(nv[key], version=cv[key].version))
    if changed_here:
        write.version = cur.version + 1
    return read, write, changed_here or child_changed


def _strip_version(item):
    c = type(item).decode(item.encode())
    c.version = 0
    return c


def _copy_item(item, version: int):
    c = type(item).decode(item.encode())
    c.version = version
    return c


def _zero_versions(group: m.ConfigGroup) -> m.ConfigGroup:
    """New subtrees enter at version 0 everywhere."""
    out = m.ConfigGroup(version=0, mod_policy=group.mod_policy)
    for key, sub in sorted(groups_of(group).items()):
        set_group(out, key, _zero_versions(sub))
    for accessor, setter in ((values_of, set_value),
                             (policies_of, set_policy)):
        for key, item in sorted(accessor(group).items()):
            setter(out, key, _copy_item(item, version=0))
    return out


def compute_update(channel_id: str, cur: m.Config,
                   new_group: m.ConfigGroup) -> m.ConfigUpdate:
    """Diff the current config against a desired channel group
    (reference: update.go Compute)."""
    if cur.channel_group is None:
        raise UpdateComputeError("current config has no channel group")
    read, write, changed = _compute_group(cur.channel_group, new_group)
    if not changed:
        raise UpdateComputeError("no differences between configs")
    return m.ConfigUpdate(channel_id=channel_id, read_set=read,
                          write_set=write)


def signed_update_envelope(channel_id: str, update: m.ConfigUpdate,
                           signers) -> m.Envelope:
    """Wrap + sign a ConfigUpdate as the CONFIG_UPDATE envelope clients
    broadcast (reference: configtx signing + protoutil)."""
    cu_bytes = update.encode()
    sigs = []
    for signer in signers:
        sh = protoutil.make_signature_header(
            signer.serialize(), protoutil.new_nonce()).encode()
        sigs.append(m.ConfigSignature(
            signature_header=sh,
            signature=signer.sign_message(sh + cu_bytes)))
    cue = m.ConfigUpdateEnvelope(config_update=cu_bytes, signatures=sigs)
    lead = signers[0]
    ch = protoutil.make_channel_header(
        m.HeaderType.CONFIG_UPDATE, channel_id)
    shdr = protoutil.make_signature_header(
        lead.serialize(), protoutil.new_nonce())
    payload = protoutil.make_payload(ch, shdr, cue.encode())
    return protoutil.sign_envelope(payload, lead)
