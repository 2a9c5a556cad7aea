"""The ordering service — the port's copies of fabric_mod_tpu/orderer/
blockcutter.py, blockwriter.py, msgprocessor.py, consensus.py (solo),
raft.py and raftchain.py (Raft, in-process transport), registrar.py,
broadcast.py, stagedbroadcast.py and deliver.py."""
from fabric_mod_tpu_torch.orderer.blockcutter import BatchConfig, BlockCutter  # noqa: F401
from fabric_mod_tpu_torch.orderer.blockwriter import BlockWriter  # noqa: F401
from fabric_mod_tpu_torch.orderer.broadcast import Broadcast, BroadcastError  # noqa: F401
from fabric_mod_tpu_torch.orderer.consensus import (  # noqa: F401
    NotLeaderError, SoloChain)
from fabric_mod_tpu_torch.orderer.deliver import DeliverService  # noqa: F401
from fabric_mod_tpu_torch.orderer.msgprocessor import (  # noqa: F401
    MsgRejectedError, StandardChannelProcessor)
from fabric_mod_tpu_torch.orderer.raft import RaftNode, RaftTransport, RaftWAL  # noqa: F401
from fabric_mod_tpu_torch.orderer.raftchain import RaftChain  # noqa: F401
from fabric_mod_tpu_torch.orderer.registrar import ChainSupport, Registrar  # noqa: F401
from fabric_mod_tpu_torch.orderer.stagedbroadcast import (  # noqa: F401
    IngressClosedError, StagedIngress)
