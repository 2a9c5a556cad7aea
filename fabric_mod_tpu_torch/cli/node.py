"""node: the process entry points — a standalone orderer, a standalone
peer, or the combined single-process topology.

The port's copy of fabric_mod_tpu/cli/node.py (reference:
orderer/common/server/main.go:71 `Main` for `--role orderer`;
internal/peer/node/start.go:205 `serve` for `--role peer`; the combined
role keeps the in-process topology for development).

    # a Raft ordering node (Broadcast/Deliver and the cluster Step):
    python -m fabric_mod_tpu_torch.cli.main node --role orderer --id o0 \\
        --genesis genesis.block --crypto crypto-config \\
        --listen 127.0.0.1:7050 --cluster-listen 127.0.0.1:7055 \\
        --cluster-peers o0=127.0.0.1:7055,o1=...,o2=... --tls-dir tls/o0

    # a committing peer pulling from the ordering service with
    # failover across endpoints, verifying on the card:
    python -m fabric_mod_tpu_torch.cli.main node --role peer --org Org1 \\
        --genesis genesis.block --crypto crypto-config \\
        --orderers 127.0.0.1:7050,127.0.0.1:7150 --config core.yaml

`core.yaml`'s `peer.BCCSP.Default` picks the peer's verifier: GPU (the
default: the card's GpuVerifier, whose kernels are built or loaded and
whose four batch buckets are warmed before the peer serves) or SW (the
host's SwVerifier).  A `--tls-dir` holds ca.crt, server.crt, server.key
and, for mutual TLS between orderers, client.crt and client.key.  Each
role serves /metrics, /healthz and /logspec (and, on orderers, the
channel-participation API) on its operations address and runs until
SIGINT or SIGTERM (or `stop_event`, in process).
"""
from __future__ import annotations

import itertools
import os
import signal
import threading
import time

from fabric_mod_tpu_torch.bccsp.sw import SwCSP
from fabric_mod_tpu_torch.channelconfig import Bundle
from fabric_mod_tpu_torch.channelconfig.configtx import config_from_block
from fabric_mod_tpu_torch.concurrency.threads import RegisteredThread
from fabric_mod_tpu_torch.config import PeerConfig, load_config
from fabric_mod_tpu_torch.msp.identities import (SigningIdentity,
                                                 deserialize_cert)
from fabric_mod_tpu_torch.observability import (OperationsServer,
                                                default_health,
                                                default_provider,
                                                get_logger, init_logging)
from fabric_mod_tpu_torch.orderer import Broadcast, DeliverService, Registrar
from fabric_mod_tpu_torch.protos import messages as m

log = get_logger("node")

_role_seq = itertools.count()


def _register_role_health(health, name, checker):
    """A per-instance key (name#seq): two roles hosted in one process
    (embedding, in-process tests) share the process-default registry,
    and a fixed key would let the second registration mask the first's
    failing checker."""
    key = f"{name}#{next(_role_seq)}"
    health.register(key, checker)
    return key


def _ledger_checker(ledger):
    def check():
        if ledger.height <= 0:
            raise RuntimeError("empty ledger")
    return check


def _load_signer(crypto_dir: str, org: str, kind: str, csp):
    base = os.path.join(crypto_dir, org)
    with open(os.path.join(base, f"{kind}s", f"{kind}0.pem"), "rb") as f:
        cert = deserialize_cert(f.read())
    with open(os.path.join(base, f"{kind}s", f"{kind}0.key"), "rb") as f:
        key_pem = f.read()
    return SigningIdentity(org, cert, key_pem, csp)


def make_verifier(peer_cfg: PeerConfig):
    """The peer's verifier by `peer.BCCSP.Default`: on "GPU" the card's
    GpuVerifier, after building whatever kernel is not yet built (a
    process that finds them built only loads them) and warming every
    batch bucket, so no block waits on a first launch; on "SW" the
    host's SwVerifier.  The peer's modules import torch; an orderer
    node never does."""
    if peer_cfg.bccsp.upper() == "SW":
        from fabric_mod_tpu_torch.bccsp.sw import SwVerifier
        return SwVerifier()
    t0 = time.perf_counter()
    import torch
    t_import = time.perf_counter() - t0
    from fabric_mod_tpu_torch.bccsp.gpu import BUCKETS, GpuVerifier
    from fabric_mod_tpu_torch.ops import _build
    from fabric_mod_tpu_torch.utils.fixtures import make_verify_items
    t0 = time.perf_counter()
    torch.cuda.init()
    torch.zeros(1, device="cuda").sum().item()   # the context, made
    t_context = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build.build_many()
    verifier = GpuVerifier()
    items, expect = make_verify_items(BUCKETS[-1], n_keys=4, seed=b"warmup")
    for bucket in BUCKETS:
        log.info("warming the card's verify kernels (bucket %d)", bucket)
        got = verifier.verify_many(items[:bucket])
        if list(got) != expect[:bucket]:
            raise RuntimeError(f"the card's verdicts differ from the "
                               f"construction at bucket {bucket}")
    _build.export_counts()
    log.info("start-up: torch import %.3f s, CUDA context %.3f s, kernels "
             "loaded and %d buckets warmed %.3f s; %d kernel builds (nvcc) "
             "in this process", t_import, t_context, len(BUCKETS),
             time.perf_counter() - t0, _build.nvcc_count())
    return verifier


def _install_stop_signals(stop):
    try:
        signal.signal(signal.SIGINT, lambda *_: stop.set())
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        from fabric_mod_tpu_torch.observability.diag import \
            install_signal_dump
        install_signal_dump()              # SIGUSR1 -> thread stacks
    except ValueError:
        pass                               # not the main thread (tests)


def _start_ops(peer_cfg: PeerConfig, health, participation=None):
    """The operations server (reference: core.yaml operations.*).  The
    participation API can destroy channel storage: it is mounted only on
    loopback, or off loopback behind client-authenticated TLS."""
    host, _, port = peer_cfg.ops_listen_address.rpartition(":")
    ops_tls = None
    if peer_cfg.ops_tls_cert and peer_cfg.ops_tls_key:
        ops_tls = {"cert": peer_cfg.ops_tls_cert,
                   "key": peer_cfg.ops_tls_key,
                   "client_ca": peer_cfg.ops_tls_client_ca or None}
    loopback = (host or "127.0.0.1") in ("127.0.0.1", "localhost", "::1")
    if participation is not None and not (
            loopback or (ops_tls and ops_tls["client_ca"])):
        log.warning("ops listener on %s is not loopback and has no "
                    "client-authenticated TLS: participation API "
                    "disabled", host)
        participation = None
    ops = OperationsServer(host or "127.0.0.1", int(port or 0),
                           default_provider(), health,
                           participation=participation, tls=ops_tls)
    ops.start()
    return ops


def _read_genesis(genesis_path: str):
    with open(genesis_path, "rb") as f:
        block = m.Block.decode(f.read())
    cid, config = config_from_block(block)
    return block, cid, config


def run_node(genesis_path: str, crypto_dir: str, orderer_org: str,
             data_dir: str, peer_cfg: PeerConfig,
             stop_event=None) -> Broadcast:
    """The combined topology in one process: a registrar with the
    genesis' consenter, a committing peer delivering from it in process,
    and the operations server.  On GPU the orderer's Writers checks go
    through a BatchingVerifyService over the peer's verifier."""
    init_logging(default_provider(), peer_cfg.log_spec)
    csp = SwCSP()
    genesis_block, cid, config = _read_genesis(genesis_path)
    verifier = make_verifier(peer_cfg)
    from fabric_mod_tpu_torch.ledger.kvledger import LedgerManager
    from fabric_mod_tpu_torch.peer.channel import Channel
    from fabric_mod_tpu_torch.peer.deliverclient import DeliverClient
    ingress = ingress_verify = None
    if peer_cfg.bccsp.upper() == "GPU":
        import functools
        from fabric_mod_tpu_torch.bccsp.gpu import BatchingVerifyService
        ingress = BatchingVerifyService(verifier)
        ingress_verify = functools.partial(ingress.verify_many, timeout=600)
    orderer_signer = _load_signer(crypto_dir, orderer_org, "orderer", csp)
    registrar = Registrar(os.path.join(data_dir, "orderer"),
                          orderer_signer, csp, verify_many=ingress_verify)
    support = registrar.get_chain(cid)
    if support is None:
        support = registrar.create_channel(genesis_block)
    broadcast = Broadcast(registrar)

    ledger_mgr = LedgerManager(os.path.join(data_dir, peer_cfg.ledger_dir))
    ledger = ledger_mgr.create_or_open(cid)
    channel = Channel(cid, ledger, verifier, Bundle(cid, config, csp), csp)
    if ledger.height == 0:
        channel.init_from_genesis(genesis_block)

    from fabric_mod_tpu_torch.orderer.participation import \
        ChannelParticipation
    health = default_health()
    _register_role_health(health, "ledger", _ledger_checker(ledger))
    ops = _start_ops(peer_cfg, health,
                     participation=ChannelParticipation(registrar))
    log.info("ops server on %s; channel %s at height %d",
             ops.addr, cid, ledger.height)

    client = DeliverClient(channel, DeliverService(support))
    runner = RegisteredThread(
        target=lambda: client.run(idle_timeout_s=3600.0),
        name="node-deliver", structure="cli.node")
    runner.start()

    stop = stop_event or threading.Event()
    _install_stop_signals(stop)
    stop.wait()
    client.stop()
    runner.join()
    broadcast.close()
    ops.stop()
    registrar.close()
    channel.close()
    ledger_mgr.close()
    if ingress is not None:
        ingress.close()
    return broadcast


def _read_tls_dir(tls_dir):
    """An optional TLS directory: ca.crt server.crt server.key
    [client.crt client.key]; a dict of PEM bytes, or None."""
    if not tls_dir:
        return None
    out = {}
    for name in ("ca.crt", "server.crt", "server.key",
                 "client.crt", "client.key"):
        path = os.path.join(tls_dir, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                out[name] = f.read()
    return out or None


def run_orderer(node_id: str, genesis_path: str, crypto_dir: str,
                orderer_org: str, data_dir: str, listen: str,
                cluster_listen: str, cluster_peers: dict,
                peer_cfg: PeerConfig, tls=None, stop_event=None,
                ready=None) -> None:
    """A standalone ordering node (reference: orderer/common/server/
    main.go:71): a registrar with the consenter by ConsensusType, the
    AtomicBroadcast server, the cluster Step transport and the
    participation API on the operations listener.  Its Writers checks
    run on the host.  `ready(info)`, when given, receives the bound
    ports once the node serves."""
    init_logging(default_provider(), peer_cfg.log_spec)
    csp = SwCSP()
    genesis_block, cid, _config = _read_genesis(genesis_path)
    signer = _load_signer(crypto_dir, orderer_org, "orderer", csp)

    tls = tls or {}
    transport = None
    consenters = {}
    if cluster_peers:
        from fabric_mod_tpu_torch.orderer.cluster import GRPCRaftTransport
        from fabric_mod_tpu_torch.orderer.raftchain import RaftChain
        transport = GRPCRaftTransport(
            node_id, dict(cluster_peers), listen_address=cluster_listen,
            server_cert=tls.get("server.crt"),
            server_key=tls.get("server.key"),
            client_ca=tls.get("ca.crt"),
            client_cert=tls.get("client.crt"),
            client_key=tls.get("client.key"))
        transport.start()
        wal_dir = os.path.join(data_dir, "raft")
        os.makedirs(wal_dir, exist_ok=True)

        def raft_factory(support, _t=transport):
            return RaftChain(
                node_id, sorted(cluster_peers), _t,
                os.path.join(wal_dir, f"{support.channel_id}.wal"),
                support)
        consenters["etcdraft"] = raft_factory

    registrar = Registrar(os.path.join(data_dir, "orderer"), signer,
                          csp, consenters=consenters)
    support = registrar.get_chain(cid)
    if support is None:
        support = registrar.create_channel(genesis_block)

    from fabric_mod_tpu_torch.orderer.server import OrdererServer
    server = OrdererServer(registrar, listen,
                           server_cert_pem=tls.get("server.crt"),
                           server_key_pem=tls.get("server.key"))
    server.start()

    health = default_health()
    _register_role_health(health, "registrar", lambda: None)
    from fabric_mod_tpu_torch.orderer.participation import \
        ChannelParticipation
    ops = _start_ops(peer_cfg, health,
                     participation=ChannelParticipation(registrar))
    log.info("orderer %s: channel %s, broadcast/deliver on port %d, "
             "ops on %s", node_id, cid, server.port, ops.addr)
    if ready is not None:
        ready({"port": server.port, "ops": ops.addr,
               "cluster_port": transport.listen_port if transport else None,
               "registrar": registrar})

    stop = stop_event or threading.Event()
    _install_stop_signals(stop)
    stop.wait()
    server.stop()
    ops.stop()
    registrar.close()
    if transport is not None:
        transport.stop()


def run_peer(org: str, genesis_path: str, crypto_dir: str,
             data_dir: str, orderer_addresses: list,
             peer_cfg: PeerConfig, tls=None, stop_event=None,
             peer_listen: str = "127.0.0.1:0", ready=None) -> None:
    """A standalone committing peer (reference: internal/peer/node/
    start.go:205): ledger, channel, the MCS-verified pipelined deliver
    client with endpoint failover, and the endorsement and event
    services on one listener at `peer_listen`.  `ready(info)`, when
    given, receives the bound ports once the peer serves."""
    init_logging(default_provider(), peer_cfg.log_spec)
    csp = SwCSP()
    genesis_block, cid, config = _read_genesis(genesis_path)
    verifier = make_verifier(peer_cfg)
    from fabric_mod_tpu_torch.ledger.kvledger import LedgerManager
    from fabric_mod_tpu_torch.peer.channel import Channel
    from fabric_mod_tpu_torch.peer.deliverclient import DeliverClient

    ledger_mgr = LedgerManager(os.path.join(data_dir, peer_cfg.ledger_dir))
    ledger = ledger_mgr.create_or_open(cid)
    channel = Channel(cid, ledger, verifier, Bundle(cid, config, csp), csp)
    if ledger.height == 0:
        channel.init_from_genesis(genesis_block)

    from fabric_mod_tpu_torch.peer.blocksprovider import (
        Endpoint, FailoverDeliverSource)
    tls = tls or {}
    endpoints = [Endpoint(addr, server_root_pem=tls.get("ca.crt"))
                 for addr in orderer_addresses]
    source = FailoverDeliverSource(endpoints, cid)
    client = DeliverClient(channel, source)
    runner = RegisteredThread(
        target=lambda: client.run(idle_timeout_s=3600.0),
        name="peer-deliver", structure="cli.node")
    runner.start()

    # the endorsement surface (reference: core/endorser's ProcessProposal
    # service registered at node start): user contract, system
    # chaincodes and the lifecycle, and the client event service — on
    # one listener, as the reference's single peer server.  Worker
    # headroom: event streams park a worker at the chain tip (capped at
    # the service's max_streams, 40); endorsement always finds one free
    from fabric_mod_tpu_torch.comm.grpc_comm import GRPCServer
    from fabric_mod_tpu_torch.peer.aclmgmt import ACLProvider
    from fabric_mod_tpu_torch.peer.deliverevents import EventDeliverServer
    from fabric_mod_tpu_torch.peer.endorser import Endorser
    from fabric_mod_tpu_torch.peer.endorserserver import EndorserServer
    from fabric_mod_tpu_torch.peer.scc import build_default_registry
    peer_signer = _load_signer(crypto_dir, org, "peer", csp)
    endorser = Endorser(channel, build_default_registry(channel, ledger),
                        peer_signer)
    pserver = GRPCServer(peer_listen,
                         server_cert_pem=tls.get("server.crt"),
                         server_key_pem=tls.get("server.key"),
                         max_workers=64)
    eserver = EndorserServer(endorser, grpc=pserver)
    acl = ACLProvider(channel.bundle, verify_many=verifier.verify_many)
    events = EventDeliverServer(cid, ledger, acl, grpc=pserver)
    pserver.start()

    health = default_health()
    _register_role_health(health, "ledger", _ledger_checker(ledger))
    ops = _start_ops(peer_cfg, health)
    log.info("peer (%s): channel %s at height %d, endorser and events on "
             "port %d, orderers %s, ops on %s", org, cid, ledger.height,
             eserver.port, orderer_addresses, ops.addr)
    if ready is not None:
        ready({"port": eserver.port, "ops": ops.addr, "ledger": ledger,
               "source": source})

    stop = stop_event or threading.Event()
    _install_stop_signals(stop)
    stop.wait()
    client.stop()
    # join the puller and committer before the stores close: a commit
    # in flight must not race the ledger's files going away
    runner.join()
    source.close()
    events.stop()           # wakes tip-parked deliver handlers first
    pserver.stop(1.0)
    ops.stop()
    channel.close()
    ledger_mgr.close()


def main(argv=None, stop_event=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="node")
    ap.add_argument("--role", choices=("combined", "orderer", "peer"),
                    default="combined")
    ap.add_argument("--genesis", required=True)
    ap.add_argument("--crypto", default="crypto-config")
    ap.add_argument("--orderer-org", default="OrdererOrg")
    ap.add_argument("--org", default="Org1", help="peer role: MSP org")
    ap.add_argument("--data", default="data")
    ap.add_argument("--config", default=None, help="core.yaml path")
    ap.add_argument("--id", default="o0", help="orderer node id")
    ap.add_argument("--listen", default="127.0.0.1:0",
                    help="orderer broadcast/deliver address")
    ap.add_argument("--cluster-listen", default="127.0.0.1:0",
                    help="orderer raft Step address")
    ap.add_argument("--cluster-peers", default="",
                    help="id=host:port,... raft cluster map")
    ap.add_argument("--orderers", default="",
                    help="peer role: comma-separated deliver endpoints")
    ap.add_argument("--peer-listen", default="127.0.0.1:0",
                    help="peer role: endorsement service address")
    ap.add_argument("--tls-dir", default="",
                    help="dir with ca.crt server.crt server.key "
                         "[client.crt client.key]")
    args = ap.parse_args(argv)
    peer_cfg = load_config(PeerConfig, args.config)
    tls = _read_tls_dir(args.tls_dir)
    if args.role == "orderer":
        peers = {}
        for part in filter(None, args.cluster_peers.split(",")):
            pid, _, addr = part.partition("=")
            peers[pid] = addr
        run_orderer(args.id, args.genesis, args.crypto,
                    args.orderer_org, args.data, args.listen,
                    args.cluster_listen, peers, peer_cfg, tls=tls,
                    stop_event=stop_event)
    elif args.role == "peer":
        addrs = [a for a in args.orderers.split(",") if a]
        run_peer(args.org, args.genesis, args.crypto, args.data,
                 addrs, peer_cfg, tls=tls, stop_event=stop_event,
                 peer_listen=args.peer_listen)
    else:
        run_node(args.genesis, args.crypto, args.orderer_org,
                 args.data, peer_cfg, stop_event=stop_event)
    return 0
