"""The ordering service — the port's copies of fabric_mod_tpu/orderer/
blockcutter.py, blockwriter.py, msgprocessor.py, consensus.py (solo),
registrar.py, broadcast.py and deliver.py."""
from fabric_mod_tpu_torch.orderer.blockcutter import BatchConfig, BlockCutter  # noqa: F401
from fabric_mod_tpu_torch.orderer.blockwriter import BlockWriter  # noqa: F401
from fabric_mod_tpu_torch.orderer.broadcast import Broadcast, BroadcastError  # noqa: F401
from fabric_mod_tpu_torch.orderer.consensus import SoloChain  # noqa: F401
from fabric_mod_tpu_torch.orderer.deliver import DeliverService  # noqa: F401
from fabric_mod_tpu_torch.orderer.msgprocessor import (  # noqa: F401
    MsgRejectedError, StandardChannelProcessor)
from fabric_mod_tpu_torch.orderer.registrar import ChainSupport, Registrar  # noqa: F401
