"""System chaincodes: QSCC (ledger queries) + CSCC (channel config).

The port's copy of fabric_mod_tpu/peer/scc.py (reference: core/scc — qscc/query.go:228's
GetChainInfo/GetBlockByNumber/GetBlockByTxID/GetTransactionByID and
cscc/configure.go:305's GetConfigBlock/GetChannelConfig — in-process
chaincodes dispatched through the same registry as user contracts.)

Read-only: they run against the committed ledger through the stub's
channel binding, produce no writes, and their proposal responses are
not meant to be ordered (clients query, they don't submit).
"""
from __future__ import annotations

import json

from fabric_mod_tpu_torch.peer.chaincode import (ChaincodeError,
                                                 ChaincodeRegistry,
                                                 ChaincodeStub, KvContract)
from fabric_mod_tpu_torch.peer.lifecycle import LIFECYCLE_NS, LifecycleContract
from fabric_mod_tpu_torch.protos import protoutil


class QsccContract:
    """(reference: core/scc/qscc/query.go)"""

    def __init__(self, ledger):
        self._ledger = ledger

    def invoke(self, stub: ChaincodeStub) -> bytes:
        if not stub.args:
            raise ChaincodeError("no args")
        op = stub.args[0].decode()
        if op == "GetChainInfo":
            h = self._ledger.height
            tip = (self._ledger.get_block_by_number(h - 1)
                   if h else None)
            info = {
                "height": h,
                "currentBlockHash":
                    protoutil.block_header_hash(tip.header).hex()
                    if tip else "",
                "previousBlockHash":
                    tip.header.previous_hash.hex() if tip else "",
            }
            return json.dumps(info, sort_keys=True).encode()
        if op == "GetBlockByNumber":
            num = int(stub.args[1].decode())
            blk = self._ledger.get_block_by_number(num)
            if blk is None:
                raise ChaincodeError(f"block {num} not found")
            return blk.encode()
        if op == "GetBlockByTxID":
            blk = self._ledger.blockstore.get_block_by_txid(
                stub.args[1].decode())
            if blk is None:
                raise ChaincodeError("tx not found")
            return blk.encode()
        if op == "GetTransactionByID":
            pt = self._ledger.get_transaction_by_id(
                stub.args[1].decode())
            if pt is None:
                raise ChaincodeError("tx not found")
            return pt.encode()
        raise ChaincodeError(f"unknown qscc op {op!r}")


class CsccContract:
    """(reference: core/scc/cscc/configure.go)"""

    def __init__(self, channel):
        self._channel = channel

    def invoke(self, stub: ChaincodeStub) -> bytes:
        if not stub.args:
            raise ChaincodeError("no args")
        op = stub.args[0].decode()
        if op == "GetChannelConfig":
            return self._channel.bundle().config.encode()
        if op == "GetConfigBlock":
            ledger = self._channel.ledger
            # walk back from the tip's last-config pointer
            h = ledger.height
            if h == 0:
                raise ChaincodeError("empty chain")
            tip = ledger.get_block_by_number(h - 1)
            lc = protoutil.block_last_config_index(tip)
            blk = ledger.get_block_by_number(lc or 0)
            if blk is None:
                raise ChaincodeError("config block pruned")
            return blk.encode()
        if op == "GetChannels":
            return json.dumps(
                [self._channel.channel_id]).encode()
        raise ChaincodeError(f"unknown cscc op {op!r}")


def build_default_registry(channel, ledger):
    """The standard per-peer chaincode registry: user contract +
    system chaincodes + the lifecycle ceremony wired to the channel's
    application orgs (reference: the SCC registrations of
    internal/peer/node/start.go)."""
    registry = ChaincodeRegistry()
    registry.register("mycc", KvContract())
    registry.register(LIFECYCLE_NS, LifecycleContract(
        channel_orgs=lambda: list(
            channel.bundle().application.org_mspids)))
    registry.register("qscc", QsccContract(ledger))
    registry.register("cscc", CsccContract(channel))
    return registry
