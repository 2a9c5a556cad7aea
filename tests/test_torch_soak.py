"""The port's seeded in-process soak under churn (fabric_mod_tpu_torch/
soak/), against the reference.

The reference's acceptance configuration (tests/test_soak.py:137-148):
seed 8, nine events covering all nine churn kinds, two channels, two
peers at start, 3-5 txs between events, 60 s recovery windows, three
Raft orderers on a manual clock, the background fault plan armed,
mixed x509 and idemix traffic.  The harness gates every invariant
itself (convergence after every event, exactly-once, the revocation
cut, fault fires, the leak sweep over the port's registered workers),
so the report's figures mean they held.  Here the shared verifier is
the host `sw.SwVerifier`: on this CPU the plain verify path costs
seconds a call, too slow for a soak; on the card the soak's default is
one GpuVerifier (chip_smoke phase 17).

Then p0's chain on soak0 — every block it committed, config blocks
included — is replayed block by block through a reference Channel with
the reference's host verifier: equal txflags on every block and an
equal state fingerprint.
"""
import os

from fabric_mod_tpu.bccsp.sw import SwCSP as JSwCSP
from fabric_mod_tpu.bccsp.tpu import FakeBatchVerifier
from fabric_mod_tpu.channelconfig import Bundle as JBundle
from fabric_mod_tpu.channelconfig.configtx import config_from_block as j_cfb
from fabric_mod_tpu.ledger.kvledger import LedgerManager as JLedgerManager
from fabric_mod_tpu.peer.channel import Channel as JChannel
from fabric_mod_tpu.protos import messages as jm

from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.ledger.kvledger import LedgerManager
from fabric_mod_tpu_torch.observability.metrics import default_provider
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.soak import (CORE_KINDS, SoakConfig, SoakHarness,
                                       committed_txids)

SEED = 8


def test_soak_under_churn_inprocess_replays_through_the_reference(tmp_path):
    cfg = SoakConfig(seed=SEED, n_events=9, n_channels=2, n_peers=2,
                     gap_txs=(3, 5), recovery_window_s=60.0,
                     verifier=sw.SwVerifier())
    root = str(tmp_path / "soak")
    rep = SoakHarness(cfg, root=root).run()

    kinds = [e["kind"] for e in rep["events"]]
    assert set(kinds) == set(CORE_KINDS), kinds
    assert rep["x509_txs"] > 0 and rep["audited_txs"] == rep["x509_txs"]
    assert rep["idemix_txs"] > 0 and rep["idemix_tamper_rejects"] > 0
    assert rep["fault_fires"] > 0
    assert rep["peers_final"] == 3
    for ev in rep["events"]:
        assert 0 <= ev["recovery_s"] <= cfg.recovery_window_s + 15, ev
    revoke = next(e for e in rep["events"] if e["kind"] == "acl_revoke")
    assert revoke["cut_at_block"] > 0
    assert revoke["received_before_cut"] <= revoke["cut_at_block"]
    crash = next(e for e in rep["events"]
                 if e["kind"] == "peer_crash_rejoin")
    assert all(h > 0 for h in crash["heights"].values()), crash
    restart = next(e for e in rep["events"]
                   if e["kind"] == "orderer_restart")
    assert all(h > 0 for h in restart["store_heights"].values()), restart
    part = next(e for e in rep["events"] if e["kind"] == "network_partition")
    assert part["peers"] or part["orderers"], part
    assert not rep["sharded"] and not rep["relay_mode"]
    text = default_provider().render_prometheus()
    for name in ("fabric_soak_recovery_seconds", "fabric_soak_heartbeat",
                 "fabric_soak_events_total", "fabric_faults_injected_total"):
        assert name in text

    # p0's soak0 chain through a reference Channel, block by block
    mgr = LedgerManager(os.path.join(root, "peers", "p0"))
    try:
        ledger = mgr.create_or_open("soak0")
        assert ledger.replayed_blocks == 0
        raws = [ledger.get_block_by_number(n).encode()
                for n in range(ledger.height)]
        flags = [list(protoutil.block_txflags(ledger.get_block_by_number(n)))
                 for n in range(1, ledger.height)]
        fp = ledger.state_fingerprint()
        txids = committed_txids(ledger)
    finally:
        mgr.close()
    assert len(txids) == len(set(txids)) > 0
    jcsp = JSwCSP()
    genesis = jm.Block.decode(raws[0])
    cid, config = j_cfb(genesis)
    jmgr = JLedgerManager(str(tmp_path / "ref"))
    try:
        jledger = jmgr.create_or_open(cid)
        channel = JChannel(cid, jledger, FakeBatchVerifier(jcsp),
                           JBundle(cid, config, jcsp), jcsp)
        channel.init_from_genesis(genesis)
        got = [list(channel.store_block(jm.Block.decode(raw)))
               for raw in raws[1:]]
        assert got == flags
        assert jledger.state_fingerprint() == fp
        # config blocks moved the reference's bundle as they moved p0's
        assert channel.bundle().sequence > 0
    finally:
        jmgr.close()
