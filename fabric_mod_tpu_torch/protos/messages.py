"""Wire message definitions.

Field numbers mirror the reference's proto schema (fabric-protos:
common/common.proto, common/policies.proto, msp/identities.proto,
peer/proposal.proto, peer/transaction.proto, peer/chaincode.proto,
ledger/rwset/*.proto) so the structure is recognizable and a future
interop shim is mechanical; the implementation is the deterministic
encoder in wire.py.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from fabric_mod_tpu_torch.protos.wire import Msg, message

_f = dataclasses.field


# --- common/common.proto ---------------------------------------------------

class HeaderType:
    MESSAGE = 0
    CONFIG = 1
    CONFIG_UPDATE = 2
    ENDORSER_TRANSACTION = 3
    ORDERER_TRANSACTION = 4
    DELIVER_SEEK_INFO = 5
    CHAINCODE_PACKAGE = 6


class TxValidationCode:
    VALID = 0
    NIL_ENVELOPE = 1
    BAD_PAYLOAD = 2
    BAD_COMMON_HEADER = 3
    BAD_CREATOR_SIGNATURE = 4
    INVALID_ENDORSER_TRANSACTION = 5
    INVALID_CONFIG_TRANSACTION = 6
    UNSUPPORTED_TX_PAYLOAD = 7
    BAD_PROPOSAL_TXID = 8
    DUPLICATE_TXID = 9
    ENDORSEMENT_POLICY_FAILURE = 10
    MVCC_READ_CONFLICT = 11
    PHANTOM_READ_CONFLICT = 12
    UNKNOWN_TX_TYPE = 13
    TARGET_CHAIN_NOT_FOUND = 14
    MARSHAL_TX_ERROR = 15
    NIL_TXACTION = 16
    EXPIRED_CHAINCODE = 17
    CHAINCODE_VERSION_CONFLICT = 18
    BAD_HEADER_EXTENSION = 19
    BAD_CHANNEL_HEADER = 20
    BAD_RESPONSE_PAYLOAD = 21
    BAD_RWSET = 22
    ILLEGAL_WRITESET = 23
    INVALID_WRITESET = 24
    INVALID_CHAINCODE = 25
    NOT_VALIDATED = 254
    INVALID_OTHER_REASON = 255


@message
class ChannelHeader(Msg):
    FIELDS = ((1, "type", "i"), (2, "version", "i"), (3, "timestamp", "u"),
              (4, "channel_id", "s"), (5, "tx_id", "s"), (6, "epoch", "u"),
              (7, "extension", "b"), (8, "tls_cert_hash", "b"))
    type: int = 0
    version: int = 0
    timestamp: int = 0          # unix nanos (proto uses Timestamp msg)
    channel_id: str = ""
    tx_id: str = ""
    epoch: int = 0
    extension: bytes = b""
    tls_cert_hash: bytes = b""


@message
class SignatureHeader(Msg):
    FIELDS = ((1, "creator", "b"), (2, "nonce", "b"))
    creator: bytes = b""
    nonce: bytes = b""


@message
class Header(Msg):
    FIELDS = ((1, "channel_header", "b"), (2, "signature_header", "b"))
    channel_header: bytes = b""
    signature_header: bytes = b""


@message
class Payload(Msg):
    FIELDS = ((1, "header", ("m", "Header")), (2, "data", "b"))
    header: Optional[Header] = None
    data: bytes = b""


@message
class Envelope(Msg):
    FIELDS = ((1, "payload", "b"), (2, "signature", "b"))
    payload: bytes = b""
    signature: bytes = b""


@message
class BlockHeader(Msg):
    FIELDS = ((1, "number", "u"), (2, "previous_hash", "b"),
              (3, "data_hash", "b"))
    number: int = 0
    previous_hash: bytes = b""
    data_hash: bytes = b""


@message
class BlockData(Msg):
    FIELDS = ((1, "data", ["b"]),)
    data: List[bytes] = _f(default_factory=list)


@message
class MetadataSignature(Msg):
    FIELDS = ((1, "signature_header", "b"), (2, "signature", "b"))
    signature_header: bytes = b""
    signature: bytes = b""


@message
class Metadata(Msg):
    FIELDS = ((1, "value", "b"),
              (2, "signatures", [("m", "MetadataSignature")]))
    value: bytes = b""
    signatures: List[MetadataSignature] = _f(default_factory=list)


class BlockMetadataIndex:
    SIGNATURES = 0
    LAST_CONFIG = 1           # deprecated in ref; kept for layout parity
    TRANSACTIONS_FILTER = 2
    COMMIT_HASH = 4


@message
class BlockMetadata(Msg):
    FIELDS = ((1, "metadata", ["b"]),)
    metadata: List[bytes] = _f(default_factory=list)


@message
class Block(Msg):
    FIELDS = ((1, "header", ("m", "BlockHeader")),
              (2, "data", ("m", "BlockData")),
              (3, "metadata", ("m", "BlockMetadata")))
    header: Optional[BlockHeader] = None
    data: Optional[BlockData] = None
    metadata: Optional[BlockMetadata] = None


@message
class LastConfig(Msg):
    FIELDS = ((1, "index", "u"),)
    index: int = 0


# --- msp/identities.proto --------------------------------------------------

@message
class SerializedIdentity(Msg):
    FIELDS = ((1, "mspid", "s"), (2, "id_bytes", "b"))
    mspid: str = ""
    id_bytes: bytes = b""       # PEM cert


# --- common/policies.proto -------------------------------------------------

@message
class NOutOf(Msg):
    FIELDS = ((1, "n", "i"), (2, "rules", [("m", "SignaturePolicy")]))
    n: int = 0
    rules: List["SignaturePolicy"] = _f(default_factory=list)


@message
class SignaturePolicy(Msg):
    # proto oneof: a leaf is signed_by (an identities index, 0 is
    # meaningful so the usual zero-suppression cannot apply), an inner
    # node is n_out_of.  Custom encode keeps the invariant explicit.
    FIELDS = ((1, "signed_by", "i"), (2, "n_out_of", ("m", "NOutOf")))
    signed_by: int = -1
    n_out_of: Optional[NOutOf] = None

    def encode(self) -> bytes:
        from fabric_mod_tpu_torch.protos import wire
        out = bytearray()
        if self.n_out_of is None:
            wire._write_tag(out, 1, 0)
            wire.write_varint(out, self.signed_by)
        else:
            wire._write_len_delim(out, 2, self.n_out_of.encode())
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "SignaturePolicy":
        m = super().decode(buf)
        # wire default for an inner node: mark leaf side unset
        if m.n_out_of is not None:
            m.signed_by = -1
        return m


class MSPRoleType:
    MEMBER = 0
    ADMIN = 1
    CLIENT = 2
    PEER = 3
    ORDERER = 4


@message
class MSPRole(Msg):
    FIELDS = ((1, "msp_identifier", "s"), (2, "role", "i"))
    msp_identifier: str = ""
    role: int = 0


class PrincipalClassification:
    ROLE = 0
    ORGANIZATION_UNIT = 1
    IDENTITY = 2


@message
class OrganizationUnit(Msg):
    FIELDS = ((1, "msp_identifier", "s"),
              (2, "organizational_unit_identifier", "s"),
              (3, "certifiers_identifier", "b"))
    msp_identifier: str = ""
    organizational_unit_identifier: str = ""
    certifiers_identifier: bytes = b""


@message
class MSPPrincipal(Msg):
    FIELDS = ((1, "principal_classification", "i"), (2, "principal", "b"))
    principal_classification: int = 0
    principal: bytes = b""


@message
class SignaturePolicyEnvelope(Msg):
    FIELDS = ((1, "version", "i"), (2, "rule", ("m", "SignaturePolicy")),
              (3, "identities", [("m", "MSPPrincipal")]))
    version: int = 0
    rule: Optional[SignaturePolicy] = None
    identities: List[MSPPrincipal] = _f(default_factory=list)


class PolicyType:
    # common/policies.proto Policy.PolicyType
    UNKNOWN = 0
    SIGNATURE = 1
    MSP = 2
    IMPLICIT_META = 3


@message
class Policy(Msg):
    FIELDS = ((1, "type", "i"), (2, "value", "b"))
    type: int = 0
    value: bytes = b""


class ImplicitMetaRule:
    ANY = 0
    ALL = 1
    MAJORITY = 2


@message
class ImplicitMetaPolicy(Msg):
    FIELDS = ((1, "sub_policy", "s"), (2, "rule", "i"))
    sub_policy: str = ""
    rule: int = 0


@message
class ApplicationPolicy(Msg):
    # oneof: signature_policy or channel_config_policy_reference
    FIELDS = ((1, "signature_policy", ("m", "SignaturePolicyEnvelope")),
              (2, "channel_config_policy_reference", "s"))
    signature_policy: Optional[SignaturePolicyEnvelope] = None
    channel_config_policy_reference: str = ""


# --- peer/chaincode.proto --------------------------------------------------

@message
class ChaincodeID(Msg):
    FIELDS = ((1, "path", "s"), (2, "name", "s"), (3, "version", "s"))
    path: str = ""
    name: str = ""
    version: str = ""


@message
class ChaincodeInput(Msg):
    FIELDS = ((1, "args", ["b"]), (3, "is_init", "u"))
    args: List[bytes] = _f(default_factory=list)
    is_init: int = 0


@message
class ChaincodeSpec(Msg):
    FIELDS = ((1, "type", "i"), (2, "chaincode_id", ("m", "ChaincodeID")),
              (3, "input", ("m", "ChaincodeInput")), (4, "timeout", "i"))
    type: int = 0
    chaincode_id: Optional[ChaincodeID] = None
    input: Optional[ChaincodeInput] = None
    timeout: int = 0


@message
class ChaincodeInvocationSpec(Msg):
    FIELDS = ((1, "chaincode_spec", ("m", "ChaincodeSpec")),)
    chaincode_spec: Optional[ChaincodeSpec] = None


@message
class ChaincodeHeaderExtension(Msg):
    FIELDS = ((2, "chaincode_id", ("m", "ChaincodeID")),)
    chaincode_id: Optional[ChaincodeID] = None


# --- peer/proposal.proto ---------------------------------------------------

@message
class Proposal(Msg):
    FIELDS = ((1, "header", "b"), (2, "payload", "b"), (3, "extension", "b"))
    header: bytes = b""
    payload: bytes = b""
    extension: bytes = b""


@message
class SignedProposal(Msg):
    FIELDS = ((1, "proposal_bytes", "b"), (2, "signature", "b"))
    proposal_bytes: bytes = b""
    signature: bytes = b""


@message
class TransientMapEntry(Msg):
    FIELDS = ((1, "key", "s"), (2, "value", "b"))
    key: str = ""
    value: bytes = b""


@message
class ChaincodeProposalPayload(Msg):
    # TransientMap (field 2) carries side-channel inputs (private
    # data); it is STRIPPED when the payload embeds into a tx
    FIELDS = ((1, "input", "b"),
              (2, "transient_map", [("m", "TransientMapEntry")]))
    input: bytes = b""          # ChaincodeInvocationSpec bytes
    transient_map: List["TransientMapEntry"] = _f(default_factory=list)


@message
class Response(Msg):
    FIELDS = ((1, "status", "i"), (2, "message", "s"), (3, "payload", "b"))
    status: int = 0
    message: str = ""
    payload: bytes = b""


@message
class Endorsement(Msg):
    FIELDS = ((1, "endorser", "b"), (2, "signature", "b"))
    endorser: bytes = b""       # SerializedIdentity bytes
    signature: bytes = b""


@message
class ProposalResponse(Msg):
    FIELDS = ((1, "version", "i"), (2, "timestamp", "u"),
              (4, "response", ("m", "Response")), (5, "payload", "b"),
              (6, "endorsement", ("m", "Endorsement")))
    version: int = 0
    timestamp: int = 0
    response: Optional[Response] = None
    payload: bytes = b""        # ProposalResponsePayload bytes
    endorsement: Optional[Endorsement] = None


@message
class ChaincodeAction(Msg):
    FIELDS = ((1, "results", "b"), (2, "events", "b"),
              (3, "response", ("m", "Response")),
              (4, "chaincode_id", ("m", "ChaincodeID")))
    results: bytes = b""        # TxReadWriteSet bytes
    events: bytes = b""
    response: Optional[Response] = None
    chaincode_id: Optional[ChaincodeID] = None


@message
class ProposalResponsePayload(Msg):
    FIELDS = ((1, "proposal_hash", "b"), (2, "extension", "b"))
    proposal_hash: bytes = b""
    extension: bytes = b""      # ChaincodeAction bytes


# --- peer/transaction.proto ------------------------------------------------

@message
class ChaincodeEndorsedAction(Msg):
    FIELDS = ((1, "proposal_response_payload", "b"),
              (2, "endorsements", [("m", "Endorsement")]))
    proposal_response_payload: bytes = b""
    endorsements: List[Endorsement] = _f(default_factory=list)


@message
class ChaincodeActionPayload(Msg):
    FIELDS = ((1, "chaincode_proposal_payload", "b"),
              (2, "action", ("m", "ChaincodeEndorsedAction")))
    chaincode_proposal_payload: bytes = b""
    action: Optional[ChaincodeEndorsedAction] = None


@message
class TransactionAction(Msg):
    FIELDS = ((1, "header", "b"), (2, "payload", "b"))
    header: bytes = b""         # SignatureHeader bytes
    payload: bytes = b""        # ChaincodeActionPayload bytes


@message
class Transaction(Msg):
    FIELDS = ((1, "actions", [("m", "TransactionAction")]),)
    actions: List[TransactionAction] = _f(default_factory=list)


@message
class ProcessedTransaction(Msg):
    FIELDS = ((1, "transaction_envelope", ("m", "Envelope")),
              (2, "validation_code", "i"))
    transaction_envelope: Optional[Envelope] = None
    validation_code: int = 0


# --- ledger/rwset ----------------------------------------------------------

@message
class Version(Msg):
    FIELDS = ((1, "block_num", "u"), (2, "tx_num", "u"))
    block_num: int = 0
    tx_num: int = 0


@message
class KVRead(Msg):
    FIELDS = ((1, "key", "s"), (2, "version", ("m", "Version")))
    key: str = ""
    version: Optional[Version] = None


@message
class KVWrite(Msg):
    FIELDS = ((1, "key", "s"), (2, "is_delete", "u"), (3, "value", "b"))
    key: str = ""
    is_delete: int = 0
    value: bytes = b""


@message
class RangeQueryInfo(Msg):
    FIELDS = ((1, "start_key", "s"), (2, "end_key", "s"),
              (3, "itr_exhausted", "u"), (4, "reads_merkle_hash", "b"))
    start_key: str = ""
    end_key: str = ""
    itr_exhausted: int = 0
    reads_merkle_hash: bytes = b""


@message
class KVRWSet(Msg):
    FIELDS = ((1, "reads", [("m", "KVRead")]),
              (2, "range_queries_info", [("m", "RangeQueryInfo")]),
              (3, "writes", [("m", "KVWrite")]),
              (4, "metadata_writes", [("m", "KVMetadataWrite")]))
    reads: List[KVRead] = _f(default_factory=list)
    range_queries_info: List[RangeQueryInfo] = _f(default_factory=list)
    writes: List[KVWrite] = _f(default_factory=list)
    metadata_writes: List["KVMetadataWrite"] = _f(default_factory=list)


@message
class NsReadWriteSet(Msg):
    FIELDS = ((1, "namespace", "s"), (2, "rwset", "b"),
              (3, "collection_hashed_rwset",
               [("m", "CollectionHashedReadWriteSet")]))
    namespace: str = ""
    rwset: bytes = b""          # KVRWSet bytes
    collection_hashed_rwset: List["CollectionHashedReadWriteSet"] = \
        _f(default_factory=list)


@message
class TxReadWriteSet(Msg):
    FIELDS = ((1, "data_model", "i"),
              (2, "ns_rwset", [("m", "NsReadWriteSet")]))
    data_model: int = 0
    ns_rwset: List[NsReadWriteSet] = _f(default_factory=list)


# --- common/configtx.proto -------------------------------------------------
# Proto maps are repeated {key, value} entry messages on the wire; the
# channelconfig layer converts to/from dicts and keeps entries sorted by
# key so encodings stay deterministic (wire.py's consensus requirement).

@message
class ConfigSignature(Msg):
    FIELDS = ((1, "signature_header", "b"), (2, "signature", "b"))
    signature_header: bytes = b""
    signature: bytes = b""


@message
class ConfigUpdateEnvelope(Msg):
    FIELDS = ((1, "config_update", "b"),
              (2, "signatures", [("m", "ConfigSignature")]))
    config_update: bytes = b""  # ConfigUpdate bytes
    signatures: List[ConfigSignature] = _f(default_factory=list)


@message
class ConfigGroupEntry(Msg):
    FIELDS = ((1, "key", "s"), (2, "value", ("m", "ConfigGroup")))
    key: str = ""
    value: Optional["ConfigGroup"] = None


@message
class ConfigValueEntry(Msg):
    FIELDS = ((1, "key", "s"), (2, "value", ("m", "ConfigValue")))
    key: str = ""
    value: Optional["ConfigValue"] = None


@message
class ConfigPolicyEntry(Msg):
    FIELDS = ((1, "key", "s"), (2, "value", ("m", "ConfigPolicy")))
    key: str = ""
    value: Optional["ConfigPolicy"] = None


@message
class ConfigGroup(Msg):
    FIELDS = ((1, "version", "u"),
              (2, "groups", [("m", "ConfigGroupEntry")]),
              (3, "values", [("m", "ConfigValueEntry")]),
              (4, "policies", [("m", "ConfigPolicyEntry")]),
              (5, "mod_policy", "s"))
    version: int = 0
    groups: List[ConfigGroupEntry] = _f(default_factory=list)
    values: List[ConfigValueEntry] = _f(default_factory=list)
    policies: List[ConfigPolicyEntry] = _f(default_factory=list)
    mod_policy: str = ""


@message
class ConfigValue(Msg):
    FIELDS = ((1, "version", "u"), (2, "value", "b"), (3, "mod_policy", "s"))
    version: int = 0
    value: bytes = b""
    mod_policy: str = ""


@message
class ConfigPolicy(Msg):
    FIELDS = ((1, "version", "u"), (2, "policy", ("m", "Policy")),
              (3, "mod_policy", "s"))
    version: int = 0
    policy: Optional[Policy] = None
    mod_policy: str = ""


@message
class Config(Msg):
    FIELDS = ((1, "sequence", "u"), (2, "channel_group", ("m", "ConfigGroup")))
    sequence: int = 0
    channel_group: Optional[ConfigGroup] = None


@message
class ConfigEnvelope(Msg):
    FIELDS = ((1, "config", ("m", "Config")), (2, "last_update", ("m", "Envelope")))
    config: Optional[Config] = None
    last_update: Optional[Envelope] = None


@message
class ConfigUpdate(Msg):
    FIELDS = ((1, "channel_id", "s"), (2, "read_set", ("m", "ConfigGroup")),
              (3, "write_set", ("m", "ConfigGroup")))
    channel_id: str = ""
    read_set: Optional[ConfigGroup] = None
    write_set: Optional[ConfigGroup] = None


# --- common/configuration.proto + orderer/configuration.proto values -------

@message
class HashingAlgorithm(Msg):
    FIELDS = ((1, "name", "s"),)
    name: str = ""


@message
class BlockDataHashingStructure(Msg):
    FIELDS = ((1, "width", "u"),)
    width: int = 0


@message
class OrdererAddresses(Msg):
    FIELDS = ((1, "addresses", ["s"]),)
    addresses: List[str] = _f(default_factory=list)


@message
class Capability(Msg):
    FIELDS = ()


@message
class CapabilityEntry(Msg):
    FIELDS = ((1, "key", "s"), (2, "value", ("m", "Capability")))
    key: str = ""
    value: Optional[Capability] = None


@message
class Capabilities(Msg):
    FIELDS = ((1, "capabilities", [("m", "CapabilityEntry")]),)
    capabilities: List[CapabilityEntry] = _f(default_factory=list)


@message
class BatchSize(Msg):
    FIELDS = ((1, "max_message_count", "u"), (2, "absolute_max_bytes", "u"),
              (3, "preferred_max_bytes", "u"))
    max_message_count: int = 0
    absolute_max_bytes: int = 0
    preferred_max_bytes: int = 0


@message
class BatchTimeout(Msg):
    FIELDS = ((1, "timeout", "s"),)   # duration string, e.g. "2s"
    timeout: str = ""


@message
class ConsensusType(Msg):
    FIELDS = ((1, "type", "s"), (2, "metadata", "b"), (3, "state", "i"))
    type: str = ""
    metadata: bytes = b""
    state: int = 0


@message
class RaftMetadata(Msg):
    """Consenter set carried in ConsensusType.metadata (reference:
    etcdraft.ConfigMetadata — ours lists transport node ids; consenter
    TLS identity is pinned at the cluster-comm layer)."""
    FIELDS = ((1, "consenters", ["s"]),)
    consenters: List[str] = _f(default_factory=list)


# --- msp/msp_config.proto --------------------------------------------------

@message
class FabricOUIdentifier(Msg):
    FIELDS = ((1, "certificate", "b"),
              (2, "organizational_unit_identifier", "s"))
    certificate: bytes = b""
    organizational_unit_identifier: str = ""


@message
class FabricNodeOUs(Msg):
    FIELDS = ((1, "enable", "u"),
              (2, "client_ou_identifier", ("m", "FabricOUIdentifier")),
              (3, "peer_ou_identifier", ("m", "FabricOUIdentifier")),
              (4, "admin_ou_identifier", ("m", "FabricOUIdentifier")),
              (5, "orderer_ou_identifier", ("m", "FabricOUIdentifier")))
    enable: int = 0
    client_ou_identifier: Optional[FabricOUIdentifier] = None
    peer_ou_identifier: Optional[FabricOUIdentifier] = None
    admin_ou_identifier: Optional[FabricOUIdentifier] = None
    orderer_ou_identifier: Optional[FabricOUIdentifier] = None


@message
class FabricMSPConfig(Msg):
    FIELDS = ((1, "name", "s"), (2, "root_certs", ["b"]),
              (3, "intermediate_certs", ["b"]), (4, "admins", ["b"]),
              (5, "revocation_list", ["b"]),
              (11, "fabric_node_ous", ("m", "FabricNodeOUs")))
    name: str = ""
    root_certs: List[bytes] = _f(default_factory=list)      # PEM
    intermediate_certs: List[bytes] = _f(default_factory=list)
    admins: List[bytes] = _f(default_factory=list)
    revocation_list: List[bytes] = _f(default_factory=list)  # DER CRLs
    fabric_node_ous: Optional[FabricNodeOUs] = None


@message
class MSPConfig(Msg):
    FIELDS = ((1, "type", "i"), (2, "config", "b"))
    type: int = 0               # 0 = FABRIC (X.509)
    config: bytes = b""         # FabricMSPConfig bytes


# --- key-level validation metadata (ledger/rwset kvrwset.proto) ------------

@message
class KVMetadataEntry(Msg):
    FIELDS = ((1, "name", "s"), (2, "value", "b"))
    name: str = ""
    value: bytes = b""


@message
class KVMetadataWrite(Msg):
    FIELDS = ((1, "key", "s"), (2, "entries", [("m", "KVMetadataEntry")]))
    key: str = ""
    entries: List[KVMetadataEntry] = _f(default_factory=list)


# --- chaincode lifecycle definition (the committed state record the
# --- validation-info provider resolves; reference: core/chaincode/
# --- lifecycle's namespaces/fields state keys, collapsed to one record) ----

@message
class ChaincodeDefinition(Msg):
    FIELDS = ((1, "sequence", "u"), (2, "version", "s"),
              (3, "endorsement_policy", "b"),
              (4, "validation_plugin", "s"), (5, "init_required", "u"),
              (6, "collections", "b"))
    sequence: int = 0
    version: str = ""
    endorsement_policy: bytes = b""     # ApplicationPolicy bytes
    validation_plugin: str = ""
    init_required: int = 0
    collections: bytes = b""            # CollectionConfigPackage bytes


# --- orderer/ab.proto (broadcast/deliver service messages) -----------------

class Status:
    # common/common.proto Status (the HTTP-ish codes the reference uses)
    UNKNOWN = 0
    SUCCESS = 200
    BAD_REQUEST = 400
    FORBIDDEN = 403
    NOT_FOUND = 404
    REQUEST_ENTITY_TOO_LARGE = 413
    # admission shed (orderer/admission.py): retryable, with a
    # retry-after hint serialized in BroadcastResponse.info (the gRPC
    # RESOURCE_EXHAUSTED analog on the reference's HTTP-ish scale)
    RESOURCE_EXHAUSTED = 429
    INTERNAL_SERVER_ERROR = 500
    NOT_IMPLEMENTED = 501
    SERVICE_UNAVAILABLE = 503


@message
class BroadcastResponse(Msg):
    FIELDS = ((1, "status", "i"), (2, "info", "s"))
    status: int = 0
    info: str = ""


@message
class SeekNewest(Msg):
    FIELDS = ()


@message
class SeekOldest(Msg):
    FIELDS = ()


@message
class SeekSpecified(Msg):
    FIELDS = ((1, "number", "u"),)
    number: int = 0


@message
class SeekPosition(Msg):
    # oneof: newest / oldest / specified
    FIELDS = ((1, "newest", ("m", "SeekNewest")),
              (2, "oldest", ("m", "SeekOldest")),
              (3, "specified", ("m", "SeekSpecified")))
    newest: Optional[SeekNewest] = None
    oldest: Optional[SeekOldest] = None
    specified: Optional[SeekSpecified] = None


class SeekBehavior:
    BLOCK_UNTIL_READY = 0
    FAIL_IF_NOT_READY = 1


@message
class SeekInfo(Msg):
    FIELDS = ((1, "start", ("m", "SeekPosition")),
              (2, "stop", ("m", "SeekPosition")),
              (3, "behavior", "i"))
    start: Optional[SeekPosition] = None
    stop: Optional[SeekPosition] = None
    behavior: int = 0


@message
class DeliverResponse(Msg):
    # oneof: status / block / filtered_block (the filtered arm is the
    # peer event service's response, peer/events.proto DeliverResponse)
    FIELDS = ((1, "status", "i"), (2, "block", ("m", "Block")),
              (3, "filtered_block", ("m", "FilteredBlock")))
    status: int = 0
    block: Optional[Block] = None
    filtered_block: Optional["FilteredBlock"] = None


# --- peer/events.proto (client-facing event deliver service) ---------------
# (reference: core/peer/deliverevents.go:240-310 — the filtered-block
# shape SDKs consume to learn a tx's validation code)

@message
class ChaincodeEvent(Msg):
    # peer/chaincode_event.proto
    FIELDS = ((1, "chaincode_id", "s"), (2, "tx_id", "s"),
              (3, "event_name", "s"), (4, "payload", "b"))
    chaincode_id: str = ""
    tx_id: str = ""
    event_name: str = ""
    payload: bytes = b""


@message
class FilteredChaincodeAction(Msg):
    FIELDS = ((1, "chaincode_event", ("m", "ChaincodeEvent")),)
    chaincode_event: Optional[ChaincodeEvent] = None


@message
class FilteredTransactionActions(Msg):
    FIELDS = ((1, "chaincode_actions",
               [("m", "FilteredChaincodeAction")]),)
    chaincode_actions: List[FilteredChaincodeAction] = _f(
        default_factory=list)


@message
class FilteredTransaction(Msg):
    FIELDS = ((1, "txid", "s"), (2, "type", "i"),
              (3, "tx_validation_code", "i"),
              (4, "transaction_actions",
               ("m", "FilteredTransactionActions")))
    txid: str = ""
    type: int = 0               # HeaderType
    tx_validation_code: int = 0
    transaction_actions: Optional[FilteredTransactionActions] = None


@message
class FilteredBlock(Msg):
    # field 3 is skipped in peer/events.proto: filtered_transactions
    # is 4 (SDK wire parity)
    FIELDS = ((1, "channel_id", "s"), (2, "number", "u"),
              (4, "filtered_transactions", [("m", "FilteredTransaction")]))
    channel_id: str = ""
    number: int = 0
    filtered_transactions: List[FilteredTransaction] = _f(
        default_factory=list)


# --- gossip/message.proto (the epidemic layer's wire messages) -------------

@message
class GossipMember(Msg):
    FIELDS = ((1, "endpoint", "s"), (2, "metadata", "b"),
              (3, "pki_id", "b"))
    endpoint: str = ""
    metadata: bytes = b""
    pki_id: bytes = b""


@message
class PeerTime(Msg):
    FIELDS = ((1, "inc_num", "u"), (2, "seq_num", "u"))
    inc_num: int = 0            # process incarnation (boot time)
    seq_num: int = 0            # monotonic within incarnation


@message
class AliveMessage(Msg):
    FIELDS = ((1, "membership", ("m", "GossipMember")),
              (2, "timestamp", ("m", "PeerTime")),
              (4, "identity", "b"))
    membership: Optional[GossipMember] = None
    timestamp: Optional[PeerTime] = None
    identity: bytes = b""       # SerializedIdentity


@message
class GossipPayload(Msg):
    FIELDS = ((1, "seq_num", "u"), (2, "data", "b"))
    seq_num: int = 0            # block number
    data: bytes = b""           # Block bytes


@message
class DataMessage(Msg):
    FIELDS = ((1, "payload", ("m", "GossipPayload")),)
    payload: Optional[GossipPayload] = None


@message
class GossipHello(Msg):
    FIELDS = ((1, "nonce", "u"), (2, "metadata", "b"), (3, "msg_type", "i"))
    nonce: int = 0
    metadata: bytes = b""
    msg_type: int = 0


@message
class DataDigest(Msg):
    FIELDS = ((1, "nonce", "u"), (2, "digests", ["b"]), (3, "msg_type", "i"))
    nonce: int = 0
    digests: List[bytes] = _f(default_factory=list)
    msg_type: int = 0


@message
class DataRequest(Msg):
    FIELDS = ((1, "nonce", "u"), (2, "digests", ["b"]), (3, "msg_type", "i"))
    nonce: int = 0
    digests: List[bytes] = _f(default_factory=list)
    msg_type: int = 0


@message
class DataUpdate(Msg):
    FIELDS = ((1, "nonce", "u"), (2, "data", [("m", "GossipEnvelope")]),
              (3, "msg_type", "i"))
    nonce: int = 0
    data: List["GossipEnvelope"] = _f(default_factory=list)
    msg_type: int = 0


@message
class PvtDataElement(Msg):
    FIELDS = ((1, "txid", "s"), (2, "payload", "b"))
    txid: str = ""
    payload: bytes = b""        # TxPvtReadWriteSet bytes


@message
class PvtDataDigest(Msg):
    """Identifies one missing private write-set (reference:
    gossip/protoext + the reconciler's PvtDataDigest)."""
    FIELDS = ((1, "block_num", "u"), (2, "tx_num", "u"),
              (3, "namespace", "s"), (4, "collection", "s"))
    block_num: int = 0
    tx_num: int = 0
    namespace: str = ""
    collection: str = ""


@message
class PvtDataRequest(Msg):
    FIELDS = ((1, "nonce", "u"), (2, "digests", [("m", "PvtDataDigest")]))
    nonce: int = 0
    digests: List["PvtDataDigest"] = _f(default_factory=list)


@message
class PvtDataResponseElement(Msg):
    FIELDS = ((1, "digest", ("m", "PvtDataDigest")), (2, "rwset", "b"))
    digest: Optional[PvtDataDigest] = None
    rwset: bytes = b""          # KVRWSet bytes (plaintext writes)


@message
class PvtDataResponse(Msg):
    FIELDS = ((1, "nonce", "u"),
              (2, "elements", [("m", "PvtDataResponseElement")]))
    nonce: int = 0
    elements: List[PvtDataResponseElement] = _f(default_factory=list)


@message
class RelayMessage(Msg):
    """One relayed deliver frame: the leader's once-encoded
    DeliverResponse bytes pushed down the dissemination tree verbatim
    (dissemination/relay.py) — a receiving peer forwards the SAME
    bytes to its children, so every hop ships what a direct orderer
    pull would have returned."""
    FIELDS = ((1, "seq_num", "u"), (2, "frame", "b"), (3, "config", "u"),
              (4, "epoch", "u"))
    seq_num: int = 0            # block number
    frame: bytes = b""          # DeliverResponse wire bytes
    config: int = 0             # carries a channel config tx
    epoch: int = 0              # sender's tree epoch


@message
class GossipMessage(Msg):
    # oneof payload: alive/data/hello/digest/request/update/private
    FIELDS = ((1, "nonce", "u"), (2, "channel", "b"), (3, "tag", "i"),
              (5, "alive_msg", ("m", "AliveMessage")),
              (6, "data_msg", ("m", "DataMessage")),
              (7, "hello", ("m", "GossipHello")),
              (8, "data_dig", ("m", "DataDigest")),
              (9, "data_req", ("m", "DataRequest")),
              (10, "data_update", ("m", "DataUpdate")),
              (11, "private_data", ("m", "PvtDataElement")),
              (12, "pvt_req", ("m", "PvtDataRequest")),
              (13, "pvt_resp", ("m", "PvtDataResponse")),
              (14, "relay_msg", ("m", "RelayMessage")))
    nonce: int = 0
    channel: bytes = b""
    tag: int = 0
    alive_msg: Optional[AliveMessage] = None
    data_msg: Optional[DataMessage] = None
    hello: Optional[GossipHello] = None
    data_dig: Optional[DataDigest] = None
    data_req: Optional[DataRequest] = None
    data_update: Optional[DataUpdate] = None
    private_data: Optional["PvtDataElement"] = None
    pvt_req: Optional[PvtDataRequest] = None
    pvt_resp: Optional[PvtDataResponse] = None
    relay_msg: Optional[RelayMessage] = None


@message
class GossipEnvelope(Msg):
    FIELDS = ((1, "payload", "b"), (2, "signature", "b"))
    payload: bytes = b""        # GossipMessage bytes
    signature: bytes = b""


# --- private data: collections + hashed rwsets -----------------------------
# (reference: peer/collection.proto + ledger/rwset/kvrwset.proto's
# hashed read/write sets and rwset.proto's TxPvtReadWriteSet)

@message
class StaticCollectionConfig(Msg):
    FIELDS = ((1, "name", "s"),
              (2, "member_orgs_policy", ("m", "SignaturePolicyEnvelope")),
              (3, "required_peer_count", "i"),
              (4, "maximum_peer_count", "i"),
              (5, "block_to_live", "u"),
              (6, "member_only_read", "u"),
              (7, "member_only_write", "u"))
    name: str = ""
    member_orgs_policy: Optional[SignaturePolicyEnvelope] = None
    required_peer_count: int = 0
    maximum_peer_count: int = 0
    block_to_live: int = 0      # 0 = never expires
    member_only_read: int = 0
    member_only_write: int = 0


@message
class CollectionConfig(Msg):
    FIELDS = ((1, "static_collection_config",
               ("m", "StaticCollectionConfig")),)
    static_collection_config: Optional[StaticCollectionConfig] = None


@message
class CollectionConfigPackage(Msg):
    FIELDS = ((1, "config", [("m", "CollectionConfig")]),)
    config: List[CollectionConfig] = _f(default_factory=list)


@message
class KVWriteHash(Msg):
    FIELDS = ((1, "key_hash", "b"), (2, "is_delete", "u"),
              (3, "value_hash", "b"))
    key_hash: bytes = b""
    is_delete: int = 0
    value_hash: bytes = b""


@message
class KVReadHash(Msg):
    FIELDS = ((1, "key_hash", "b"), (2, "version", ("m", "Version")))
    key_hash: bytes = b""
    version: Optional[Version] = None


@message
class HashedRWSet(Msg):
    FIELDS = ((1, "hashed_reads", [("m", "KVReadHash")]),
              (2, "hashed_writes", [("m", "KVWriteHash")]))
    hashed_reads: List[KVReadHash] = _f(default_factory=list)
    hashed_writes: List[KVWriteHash] = _f(default_factory=list)


@message
class CollectionHashedReadWriteSet(Msg):
    FIELDS = ((1, "collection_name", "s"), (2, "hashed_rwset", "b"))
    collection_name: str = ""
    hashed_rwset: bytes = b""   # HashedRWSet bytes


@message
class CollectionPvtReadWriteSet(Msg):
    FIELDS = ((1, "collection_name", "s"), (2, "rwset", "b"))
    collection_name: str = ""
    rwset: bytes = b""          # KVRWSet bytes (plaintext)


@message
class NsPvtReadWriteSet(Msg):
    FIELDS = ((1, "namespace", "s"),
              (2, "collection_pvt_rwset",
               [("m", "CollectionPvtReadWriteSet")]))
    namespace: str = ""
    collection_pvt_rwset: List[CollectionPvtReadWriteSet] = \
        _f(default_factory=list)


@message
class TxPvtReadWriteSet(Msg):
    FIELDS = ((1, "data_model", "i"),
              (2, "ns_pvt_rwset", [("m", "NsPvtReadWriteSet")]))
    data_model: int = 0
    ns_pvt_rwset: List[NsPvtReadWriteSet] = _f(default_factory=list)
