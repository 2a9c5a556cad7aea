"""Channel configuration — the port's copies of
fabric_mod_tpu/channelconfig/ bundle.py, configtx.py and genesis.py:
the typed bundle with its MSP manager and policy tree, config-update
validation, and genesis construction."""
from fabric_mod_tpu_torch.channelconfig.bundle import (  # noqa: F401
    APPLICATION, ORDERER, Bundle, ConfigError, groups_of, policies_of,
    values_of)
from fabric_mod_tpu_torch.channelconfig.configtx import (  # noqa: F401
    ConfigTxError, config_from_block, extract_config_update,
    propose_config_update)
from fabric_mod_tpu_torch.channelconfig import genesis  # noqa: F401
