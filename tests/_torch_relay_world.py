"""The port's relay-mode gossip peers around an ordered channel, for the
dissemination tests (the composition of the reference's
tests/test_dissemination.py fixture and bench.py:2229
`_build_relay_world`): each peer a PortPeer (ledger, Channel,
GossipNode) with a RelayService and a GossipService whose relay it is,
membership seeded as `seed_membership` does, and a tap of every frame a
peer's relay verified.  Leadership is pinned to the minimum (PKI-ID,
endpoint) peer unless `static` is False (then the election decides,
ticked by the caller).
"""
from tests._torch_gossip_world import PortPeer, seed_membership

from fabric_mod_tpu_torch.dissemination import RelayService
from fabric_mod_tpu_torch.gossip import GossipService, InProcNetwork
from fabric_mod_tpu_torch.protos import messages as m

NEVER_S = 3600.0        # an election interval no test reaches


class RelayWorld:
    """`peers`, `relays` (RelayService), `services` (GossipService),
    `taps` ([(num, frame)] per peer), `lead` (the pinned or first
    elected leader's index) and `streams` (deliver sources made)."""

    def __init__(self, root, material, source_factory, verifiers,
                 degree=2, queue_cap=64, static=True, clock=None,
                 state_interval_s=0.5, tensor_policy=False,
                 pipeline_depth=0):
        self.fabric = InProcNetwork()
        self.peers = [
            PortPeer(root, i, material.genesis, pems, self.fabric,
                     verifiers[i], seed=i, clock=clock,
                     tensor_policy=tensor_policy,
                     pipeline_depth=pipeline_depth)
            for i, pems in enumerate(material.gossip_peers)]
        nodes = [p.node for p in self.peers]
        seed_membership(nodes, m)
        self.relays, self.taps = [], []
        for node in nodes:
            relay = RelayService(node, degree=degree, queue_cap=queue_cap)
            tap = []
            relay.relay.on_deliver = \
                lambda num, frame, acc=tap: acc.append((num, frame))
            self.relays.append(relay)
            self.taps.append(tap)
        self.lead = min(range(len(nodes)),
                        key=lambda i: (nodes[i].pki_id, nodes[i].endpoint))
        self.streams = []

        def factory():
            self.streams.append(1)
            return source_factory()
        self.services = [
            GossipService(node, factory,
                          static_leader=(i == self.lead) if static else None,
                          election_interval_s=NEVER_S, relay=relay)
            for i, (node, relay) in enumerate(zip(nodes, self.relays))]
        for node in nodes:
            # pinned before GossipService.start's idempotent start
            node.state.start(interval_s=state_interval_s)
        self.stopped = set()

    def start(self):
        # children accept before the root starts pushing
        for i, s in enumerate(self.services):
            if i != self.lead:
                s.start()
        self.services[self.lead].start()

    def heights(self, live_only=True):
        return [p.ledger.height for i, p in enumerate(self.peers)
                if not (live_only and i in self.stopped)]

    def errors(self):
        out = []
        for i, (p, s, r) in enumerate(zip(self.peers, self.services,
                                          self.relays)):
            if i not in self.stopped:
                out += s.errors + p.node.state.errors + r.errors
        return out

    def stop_peer(self, i):
        self.services[i].stop()
        self.peers[i].close()
        self.stopped.add(i)

    def close(self):
        # the root first: no push races the others' teardown
        order = [self.lead] + [i for i in range(len(self.peers))
                               if i != self.lead]
        for i in order:
            if i not in self.stopped:
                self.services[i].stop()
        for i in order:
            if i not in self.stopped:
                self.peers[i].close()
