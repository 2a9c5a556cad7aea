"""In-process chaincode runtime: contracts, stub, registry.

The port's copy of fabric_mod_tpu/peer/chaincode.py `ChaincodeStub`,
`ChaincodeRegistry`, `FuncContract` and `KvContract` (reference:
core/chaincode/chaincode_support.go:193 `Execute` and the shim handler,
handler.go:180-202 HandleGetState/HandlePutState): a contract is a
Python object invoked against a stub bound to a TxSimulator, which
records the read-write set.  The stub carries the proposal's transient
map, the creator, the private-data calls, one chaincode event a tx
(shim SetEvent) and rich JSON-selector queries (shim GetQueryResult).
"""
from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Protocol

from fabric_mod_tpu_torch.protos import messages as m


class ChaincodeError(Exception):
    pass


class ChaincodeStub:
    """What a contract sees (reference: the shim's stub API —
    GetState/PutState/DelState/GetStateByRange over the simulator)."""

    def __init__(self, namespace: str, simulator, args: List[bytes],
                 txid: str, channel_id: str,
                 transient: Optional[Dict[str, bytes]] = None,
                 creator: bytes = b""):
        self.namespace = namespace
        self._sim = simulator
        self.args = args
        self.txid = txid
        self.channel_id = channel_id
        # side-channel inputs, never part of the ordered tx (reference:
        # the shim's GetTransient)
        self.transient = dict(transient or {})
        # serialized creator identity (reference: shim GetCreator)
        self.creator = creator
        # at most one event a tx; a repeat call overwrites (reference:
        # shim SetEvent)
        self.event = None               # (name, payload) | None

    def set_event(self, name: str, payload: bytes = b"") -> None:
        """Attach a chaincode event to this tx's action; listeners get
        it on commit (without the payload on the filtered stream)."""
        if not name:
            raise ValueError("event name must be non-empty")
        self.event = (name, payload)

    def creator_mspid(self) -> str:
        """The proposal creator's MSP id ('' when it does not decode)."""
        try:
            return m.SerializedIdentity.decode(self.creator).mspid
        except Exception:
            return ""

    def get_query_result(self, query):
        """Rich JSON-selector query (reference: shim GetQueryResult,
        handler.go HandleGetQueryResult): ([(key, doc)], bookmark)."""
        return self._sim.execute_query(self.namespace, query)

    def get_state(self, key: str) -> Optional[bytes]:
        return self._sim.get_state(self.namespace, key)

    def put_state(self, key: str, value: bytes) -> None:
        self._sim.set_state(self.namespace, key, value)

    def del_state(self, key: str) -> None:
        self._sim.delete_state(self.namespace, key)

    def get_state_range(self, start: str, end: str):
        return self._sim.get_state_range(self.namespace, start, end)

    def set_state_metadata(self, key: str, name: str, value: bytes) -> None:
        """(reference: shim PutStateMetadata — e.g. key-level
        endorsement via the VALIDATION_PARAMETER entry)"""
        self._sim.set_state_metadata(self.namespace, key, name, value)

    # -- private data (reference: shim PutPrivateData/GetPrivateData) --
    def put_private_data(self, collection: str, key: str,
                         value: bytes) -> None:
        self._sim.set_private_data(self.namespace, collection, key, value)

    def get_private_data(self, collection: str, key: str):
        return self._sim.get_private_data(self.namespace, collection, key)

    def del_private_data(self, collection: str, key: str) -> None:
        self._sim.delete_private_data(self.namespace, collection, key)


class Contract(Protocol):
    def invoke(self, stub: ChaincodeStub) -> bytes: ...


class ChaincodeRegistry:
    """name -> contract (reference: the launch registry, core/scc)."""

    def __init__(self):
        self._contracts: Dict[str, Contract] = {}
        self._resolver: Optional[Callable[[str], Optional[Contract]]] = None

    def register(self, name: str, contract: Contract) -> None:
        self._contracts[name] = contract

    def set_resolver(self, resolver) -> None:
        """Miss handler (reference: launch on first use,
        chaincode_support.go:93).  A contract it returns is cached; None
        is not, so a chaincode installed later still resolves."""
        self._resolver = resolver

    def get(self, name: str) -> Optional[Contract]:
        cc = self._contracts.get(name)
        if cc is None and self._resolver is not None:
            cc = self._resolver(name)
            if cc is not None:
                self._contracts[name] = cc
        return cc

    def execute(self, name: str, stub: ChaincodeStub) -> bytes:
        cc = self.get(name)
        if cc is None:
            raise ChaincodeError(f"chaincode {name!r} not installed")
        return cc.invoke(stub)


class FuncContract:
    """A plain function(stub) -> bytes as a contract."""

    def __init__(self, fn: Callable[[ChaincodeStub], bytes]):
        self._fn = fn

    def invoke(self, stub: ChaincodeStub) -> bytes:
        return self._fn(stub)


class KvContract:
    """The example contract: args [op, key, value?] with put, get, del,
    putev (a put with a "kv-put" event), setvp (a key-level endorsement
    override), query (args [op, Mango query JSON] -> JSON {"results":
    [{key, doc}], "bookmark"}), and putpvt / getpvt (args [op,
    collection, key]; putpvt's value comes in the transient map under
    "value", so it never lands in the ordered tx)."""

    def invoke(self, stub: ChaincodeStub) -> bytes:
        if not stub.args:
            raise ChaincodeError("no args")
        op = stub.args[0].decode()
        if op == "put":
            stub.put_state(stub.args[1].decode(), stub.args[2])
            return b"ok"
        if op == "get":
            val = stub.get_state(stub.args[1].decode())
            return val if val is not None else b""
        if op == "del":
            stub.del_state(stub.args[1].decode())
            return b"ok"
        if op == "putev":
            stub.put_state(stub.args[1].decode(), stub.args[2])
            stub.set_event("kv-put", stub.args[1])
            return b"ok"
        if op == "setvp":
            # state-based endorsement (reference: integration/sbe)
            stub.set_state_metadata(stub.args[1].decode(),
                                    "VALIDATION_PARAMETER", stub.args[2])
            return b"ok"
        if op == "query":
            results, bookmark = stub.get_query_result(stub.args[1])
            return json.dumps(
                {"results": [{"key": k, "doc": d} for k, d in results],
                 "bookmark": bookmark}).encode()
        if op == "putpvt":
            value = stub.transient.get("value")
            if value is None:
                raise ChaincodeError("putpvt needs transient 'value'")
            stub.put_private_data(stub.args[1].decode(),
                                  stub.args[2].decode(), value)
            return b"ok"
        if op == "getpvt":
            val = stub.get_private_data(stub.args[1].decode(),
                                        stub.args[2].decode())
            return val if val is not None else b""
        raise ChaincodeError(f"unknown op {op!r}")
