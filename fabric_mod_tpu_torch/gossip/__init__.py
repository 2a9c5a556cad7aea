"""The epidemic dissemination layer — the port's copy of
fabric_mod_tpu/gossip/ (reference: gossip/): membership discovery, push
fan-out, pull anti-entropy, identity mapping, and in-order state
transfer into the commit pipeline."""
from fabric_mod_tpu_torch.gossip.comm import GossipComm, InProcNetwork  # noqa: F401
from fabric_mod_tpu_torch.gossip.discovery import Discovery             # noqa: F401
from fabric_mod_tpu_torch.gossip.identity import IdentityMapper         # noqa: F401
from fabric_mod_tpu_torch.gossip.election import (                      # noqa: F401
    LeaderElectionService)
from fabric_mod_tpu_torch.gossip.node import GossipNode                 # noqa: F401
from fabric_mod_tpu_torch.gossip.service import GossipService           # noqa: F401
from fabric_mod_tpu_torch.gossip.state import (                         # noqa: F401
    GossipStateProvider, PayloadsBuffer)
