"""Channel configuration — the port's copies of
fabric_mod_tpu/channelconfig/ bundle.py, configtx.py, genesis.py,
update.py and capabilities.py: the typed bundle with its MSP manager
and policy tree, config-update validation, genesis construction,
config-update computation and capability levels."""
from fabric_mod_tpu_torch.channelconfig.bundle import (  # noqa: F401
    APPLICATION, ORDERER, Bundle, ConfigError, groups_of, policies_of,
    values_of)
from fabric_mod_tpu_torch.channelconfig.configtx import (  # noqa: F401
    ConfigTxError, config_from_block, extract_config_update,
    propose_config_update)
from fabric_mod_tpu_torch.channelconfig import genesis  # noqa: F401
from fabric_mod_tpu_torch.channelconfig.update import (  # noqa: F401
    compute_update, signed_update_envelope)
