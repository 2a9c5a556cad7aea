"""Service discovery (the port of fabric_mod_tpu/discovery/; reference:
discovery/)."""
from fabric_mod_tpu_torch.discovery.service import (  # noqa: F401
    DiscoveryError, DiscoveryService, EndorsementDescriptor, Layout)
