"""The in-process end-to-end network, port against reference, with the
endorsement policies decided by the port's policy closures: the JAX
package's `Network` and the port's, built from the same material, order
and commit the same stream — endorsed by both packages' endorsers, with
every planted kind and a config-update block that forces a barrier —
and must give equal txflags per block, equal block data and header
hashes, and an equal state fingerprint (tests/_torch_e2e_scenario.py).
The port verifies with the GpuVerifier on the CPU.
test_torch_e2e_tensor.py runs the same stream with the tensor-policy
evaluator."""
import pytest
import torch

from fabric_mod_tpu_torch.bccsp import gpu
from tests import _torch_e2e_scenario as scenario


def test_e2e_equals_reference(tmp_path, monkeypatch):
    torch.set_num_threads(1)
    scenario.run(tmp_path, monkeypatch,
                 gpu.GpuVerifier(device="cpu", buckets=(8, 64)),
                 tensor_policy=False)


def test_network_without_a_card_raises(tmp_path):
    """verifier=None builds GpuVerifier() on the card: without one the
    Network raises instead of running the plain path or a host
    verifier."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the GpuVerifier would build")
    from fabric_mod_tpu_torch.e2e import Network
    from fabric_mod_tpu_torch.utils import fixtures
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Network(str(tmp_path), material=fixtures.make_network_material(3))


def test_run_pipeline_reports_the_deliver_clients_seconds():
    """run_pipeline endorses, orders and commits its puts and fills
    `stats` with the deliver client's counters (host verifier: the
    GpuVerifier's CPU path is what the differentials above run)."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import sw
    stats = {}
    assert e2e.run_pipeline(6, sw.SwVerifier(), stats=stats) > 0
    assert set(stats) == {"stage_secs", "await_secs", "commit_secs",
                          "mcs_secs", "wall_secs"}
    assert all(v >= 0 for v in stats.values())
    assert stats["commit_secs"] >= stats["await_secs"]


def test_endorse_and_submit_commits_and_is_found_by_tx_id(tmp_path):
    """The client convenience endorses, broadcasts and returns the tx
    id; the committed txs are found by id with their validation codes
    (a get of a missing key is VALID, a one-org endorsement fails the
    MAJORITY policy)."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import sw
    from fabric_mod_tpu_torch.peer.endorser import endorse_and_submit
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.utils import fixtures
    net = e2e.Network(str(tmp_path), fixtures.make_network_material(
        4, max_message_count=3, batch_timeout="60s"),
        verifier=sw.SwVerifier())
    try:
        org1, org2, _ = (net.endorsers[o] for o in ("Org1", "Org2", "Org3"))
        sent = [(endorse_and_submit(net.channel_id, "mycc", args,
                                    net.client, ends, net.broadcast), want)
                for args, ends, want in (
                    ([b"put", b"a", b"1"], [org1, org2],
                     m.TxValidationCode.VALID),
                    ([b"put", b"b", b"2"], [org1],
                     m.TxValidationCode.ENDORSEMENT_POLICY_FAILURE),
                    ([b"get", b"c"], [org1, org2],
                     m.TxValidationCode.VALID))]
        assert e2e.commit_until(net, 3, 60)[1] == 3
        for tx_id, want in sent:
            assert net.ledger.tx_id_exists(tx_id)
            assert net.ledger.get_transaction_by_id(tx_id) \
                .validation_code == want
        assert not net.ledger.tx_id_exists("no-such-tx")
        assert net.ledger.new_query_executor().get_state("mycc", "a") == b"1"
    finally:
        net.close()
