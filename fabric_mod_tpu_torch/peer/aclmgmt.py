"""ACL management: API resource names -> channel policies.

The port's copy of fabric_mod_tpu/peer/aclmgmt.py (reference:
core/aclmgmt — NewACLProvider with the resource defaults of
resources.go; CheckACL routes a resource's configured or default policy
through the policy manager).

`check_acl` evaluates the resource's channel policy with
`evaluate_signed_data(sds, verify_many)`: with `verify_many` the
channel's verifier (a GpuVerifier or a BatchingVerifyService), each
check is one device call; None verifies on the host.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from fabric_mod_tpu_torch.protos.protoutil import SignedData

# Default resource policy map (reference: aclmgmt/defaults — the peer's
# API surface gated by channel policies)
DEFAULT_ACLS: Dict[str, str] = {
    "peer/Propose": "/Channel/Application/Writers",
    "peer/ChaincodeToChaincode": "/Channel/Application/Writers",
    "event/Block": "/Channel/Application/Readers",
    "event/FilteredBlock": "/Channel/Application/Readers",
    "qscc/GetChainInfo": "/Channel/Application/Readers",
    "qscc/GetBlockByNumber": "/Channel/Application/Readers",
    "qscc/GetTransactionByID": "/Channel/Application/Readers",
    "cscc/GetConfigBlock": "/Channel/Application/Readers",
    "cscc/GetChannelConfig": "/Channel/Application/Readers",
    "lifecycle/CommitChaincodeDefinition":
        "/Channel/Application/Writers",
    "lifecycle/QueryChaincodeDefinition":
        "/Channel/Application/Readers",
    "discovery": "/Channel/Application/Readers",
}


class ACLError(Exception):
    pass


class ACLProvider:
    """(reference: aclmgmt.go NewACLProvider + CheckACL).  `bundle_fn`
    returns the channel's current Bundle (read afresh on every call, so
    a config update moves both the policies and the sequence)."""

    def __init__(self, bundle_fn, verify_many=None,
                 overrides: Optional[Dict[str, str]] = None):
        self._bundle = bundle_fn
        self._verify_many = verify_many
        self._map = dict(DEFAULT_ACLS)
        self._map.update(overrides or {})

    def policy_for(self, resource: str) -> Optional[str]:
        return self._map.get(resource)

    def config_sequence(self) -> Optional[int]:
        """The current channel config sequence: the invalidation key of
        session-scoped ACL caches (reference: deliver.go's SessionAC
        re-evaluates when it advances)."""
        return getattr(self._bundle(), "sequence", None)

    def check_acl(self, resource: str,
                  sds: Sequence[SignedData]) -> None:
        """Raises ACLError unless the signature set satisfies the
        resource's policy (fail-closed for unknown resources)."""
        ref = self._map.get(resource)
        if ref is None:
            raise ACLError(f"no ACL policy mapped for {resource!r}")
        pol = self._bundle().policy(ref)
        if pol is None:
            raise ACLError(f"policy {ref!r} not in channel config")
        if not pol.evaluate_signed_data(sds, self._verify_many):
            raise ACLError(f"access denied for {resource!r} ({ref})")
