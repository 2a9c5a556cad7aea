"""Cross-peer block dissemination: one orderer pull per org, a
deterministic relay tree to every other peer.

The port's copy of fabric_mod_tpu/dissemination/ (the gossip layer's
org-leader pull, grown into a relay: the deliver fan-out's once-encoded
frames pushed across peers down a tree every member derives on its own,
so the orderer's deliver load is one stream per leader whatever the
peer count).

* ``tree.py``    — RelayTree: a pure function of (alive membership,
                   leader, epoch) with fan-out `degree`; deterministic
                   reparenting.
* ``relay.py``   — BlockRelay: frames off the leader's BlockFanout ring,
                   pushed child-ward over the gossip comm with bounded
                   per-child queues and counted drops; gaps fall back to
                   the anti-entropy pull.
* ``service.py`` — RelayService: bound to GossipService's leadership
                   transitions (the sole DeliverClient at the leader,
                   teardown on demotion, rebuild from the height on
                   promotion); non-leaders commit through the
                   GossipStateProvider buffer.
"""
from fabric_mod_tpu_torch.dissemination.tree import (RelayTree,  # noqa: F401
                                                     reparent_plan)
from fabric_mod_tpu_torch.dissemination.relay import BlockRelay  # noqa: F401
from fabric_mod_tpu_torch.dissemination.service import (  # noqa: F401
    RelayService)
