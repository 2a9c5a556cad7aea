"""In-process chaincode runtime: contracts, stub, registry.

The port's copy of fabric_mod_tpu/peer/chaincode.py `ChaincodeStub`,
`ChaincodeRegistry` and `KvContract` (:142) (reference:
core/chaincode/chaincode_support.go:193 `Execute` and the shim handler,
handler.go:180-202 HandleGetState/HandlePutState): a contract is a
Python object invoked against a stub bound to a TxSimulator, which
records the read-write set.  The stub carries the proposal's transient
map and the private-data calls (:25-36, :82-91).  Rich queries and
chaincode events are not ported; the contract raises on their ops.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Protocol


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

    def register(self, name: str, contract: Contract) -> None:
        self._contracts[name] = contract

    def get(self, name: str) -> Optional[Contract]:
        return self._contracts.get(name)

    def execute(self, name: str, stub: ChaincodeStub) -> bytes:
        cc = self.get(name)
        if cc is None:
            raise ChaincodeError(f"chaincode {name!r} not installed")
        return cc.invoke(stub)


class KvContract:
    """The example contract: args [op, key, value?] with put, get, del,
    setvp (a key-level endorsement override), and putpvt / getpvt
    (args [op, collection, key]; putpvt's value comes in the transient
    map under "value", so it never lands in the ordered tx)."""

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
        if op == "setvp":
            # state-based endorsement (reference: integration/sbe)
            stub.set_state_metadata(stub.args[1].decode(),
                                    "VALIDATION_PARAMETER", stub.args[2])
            return b"ok"
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
        # the reference's putev and query need chaincode events and rich
        # queries, neither ported
        raise ChaincodeError(f"unknown op {op!r}")
