"""Gossip peers of either package composed around an ordered channel,
for the gossip tests (the composition of the reference's
tests/test_gossip.py fixture and bench.py:2229 `_build_relay_world`):
each peer has a durable ledger of its own, a Channel over the channel's
genesis block and a GossipNode on an in-process network.  `PortPeer`
and `RefPeer` take the same arguments, and both packages' nodes speak
envelope bytes, so one network may carry peers of both.

`seed_membership` fills every node's membership view and identity
mapper directly, as bench.py:2229 does, instead of alive rounds: the
push and pull paths under test stay fully signed and verified.
"""
import os
import random

from fabric_mod_tpu_torch.bccsp.sw import SwCSP
from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
from fabric_mod_tpu_torch.gossip import GossipNode
from fabric_mod_tpu_torch.ledger.kvledger import LedgerManager
from fabric_mod_tpu_torch.msp.identities import (SigningIdentity,
                                                 deserialize_cert)
from fabric_mod_tpu_torch.peer.channel import Channel
from fabric_mod_tpu_torch.protos import messages as m


class PortPeer:
    """One port peer: `mgr` (its LedgerManager), `channel`, `node`."""

    def __init__(self, root, index, genesis: bytes, pems, network,
                 verifier, bundle=None, seed=0, clock=None,
                 tensor_policy=False, pipeline_depth=0):
        csp = SwCSP()
        block = m.Block.decode(genesis)
        channel_id, config = config_from_block(block)
        if bundle is None:
            bundle = Bundle(channel_id, config, csp)
        self.mgr = LedgerManager(os.path.join(root, f"gossip{index}"))
        ledger = self.mgr.create_or_open(channel_id)
        self.channel = Channel(channel_id, ledger, verifier, bundle, csp,
                               tensor_policy=tensor_policy,
                               pipeline_depth=pipeline_depth)
        if ledger.height == 0:
            self.channel.init_from_genesis(block)
        mspid, cert_pem, key_pem = pems
        signer = SigningIdentity(mspid, deserialize_cert(cert_pem), key_pem,
                                 csp)
        self.node = GossipNode(f"gossip{index}:7051", signer, self.channel,
                               network, rng=random.Random(seed + index),
                               clock=clock)

    @property
    def ledger(self):
        return self.channel.ledger

    def close(self):
        self.node.stop()
        self.channel.close()
        self.mgr.close()


class RefPeer:
    """One reference peer as tests/test_gossip.py composes one: the
    reference's LedgerManager, Channel (host verifier) and GossipNode,
    with `PortPeer`'s arguments."""

    def __init__(self, root, index, genesis: bytes, pems, network, seed=0):
        from fabric_mod_tpu.bccsp.sw import SwCSP as JSwCSP
        from fabric_mod_tpu.bccsp.tpu import FakeBatchVerifier
        from fabric_mod_tpu.channelconfig import Bundle as JBundle
        from fabric_mod_tpu.channelconfig.configtx import \
            config_from_block as j_config_from_block
        from fabric_mod_tpu.gossip import GossipNode as JGossipNode
        from fabric_mod_tpu.ledger.kvledger import \
            LedgerManager as JLedgerManager
        from fabric_mod_tpu.msp.identities import \
            SigningIdentity as JSigningIdentity
        from fabric_mod_tpu.msp.identities import \
            deserialize_cert as j_deserialize_cert
        from fabric_mod_tpu.peer.channel import Channel as JChannel
        from fabric_mod_tpu.protos import messages as jm
        csp = JSwCSP()
        block = jm.Block.decode(genesis)
        channel_id, config = j_config_from_block(block)
        self.mgr = JLedgerManager(os.path.join(root, f"ref{index}"))
        ledger = self.mgr.create_or_open(channel_id)
        self.channel = JChannel(channel_id, ledger, FakeBatchVerifier(csp),
                                JBundle(channel_id, config, csp), csp)
        if ledger.height == 0:
            self.channel.init_from_genesis(block)
        mspid, cert_pem, key_pem = pems
        signer = JSigningIdentity(mspid, j_deserialize_cert(cert_pem),
                                  key_pem, csp)
        self.node = JGossipNode(f"gossip{index}:7051", signer, self.channel,
                                network, rng=random.Random(seed + index))

    @property
    def ledger(self):
        return self.channel.ledger

    def close(self):
        self.node.stop()
        self.mgr.close()


def seed_membership(nodes, messages):
    """Every node learns every other's endpoint and identity, with no
    message sent; `messages` is the package's protos.messages, or, for
    nodes of both packages, a function giving a node's."""
    for node in nodes:
        msgs = messages(node) if callable(messages) else messages
        for other in nodes:
            if other is node:
                continue
            node.mapper.put(other._identity)
            node._members_by_pki[other.pki_id] = other.endpoint
            node.discovery.handle_alive(other.pki_id, msgs.AliveMessage(
                membership=msgs.GossipMember(endpoint=other.endpoint,
                                             pki_id=other.pki_id),
                timestamp=msgs.PeerTime(inc_num=1, seq_num=1)))
