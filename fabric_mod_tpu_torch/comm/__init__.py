"""Communication: RPC over mutual TLS (reference: internal/pkg/comm) and
TLS material utilities (common/crypto), the port of
fabric_mod_tpu/comm/ over its own wire (comm/wire.py)."""
from fabric_mod_tpu_torch.comm.grpc_comm import (  # noqa: F401
    GRPCClient, GRPCServer, MethodKind, RpcError, StatusCode)
from fabric_mod_tpu_torch.comm.tls import TlsCA, track_expiration  # noqa: F401
