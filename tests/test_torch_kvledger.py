"""The port's block-store ledger against the reference's: the same
blocks committed with the same flags into a directory-backed ledger of
each package (through each LedgerManager) give the same final flags,
state fingerprint, stored blocks, tx-id answers and simulation results;
and reopening the port's directory replays the blocks into the same
state.  The blocks are the port's seeded commit fixture (every planted
kind, a VALIDATION_PARAMETER pin); no verify runs here."""
import pytest

from fabric_mod_tpu.ledger.kvledger import LedgerManager as JLedgerManager
from fabric_mod_tpu.protos import messages as jm

from fabric_mod_tpu_torch.ledger.kvledger import LedgerManager
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures

NS = fixtures.NAMESPACE


@pytest.fixture(scope="module")
def ledgers(tmp_path_factory):
    world = fixtures.make_commit_world()
    blocks, expected = fixtures.make_commit_blocks(world, 3, 16)
    root = tmp_path_factory.mktemp("ledgers")
    mgr = LedgerManager(str(root / "port"))
    jmgr = JLedgerManager(str(root / "ref"))
    led, jled = mgr.create_or_open("ch"), jmgr.create_or_open("ch")
    for raw, flags in zip(blocks, expected):
        assert led.commit_block(m.Block.decode(raw), flags) == \
            jled.commit_block(jm.Block.decode(raw), flags) == flags
    yield root, mgr, led, jled, blocks
    mgr.close()
    jmgr.close()


def test_blocks_and_tx_ids_equal_reference(ledgers):
    _root, _mgr, led, jled, blocks = ledgers
    assert led.height == jled.height == len(blocks)
    assert led.state_fingerprint() == jled.state_fingerprint()
    for num in range(len(blocks)):
        got = led.get_block_by_number(num)
        assert got.encode() == jled.get_block_by_number(num).encode()
        for env in protoutil.get_envelopes(got):
            txid = protoutil.envelope_channel_header(env).tx_id
            pt, jpt = (led.get_transaction_by_id(txid),
                       jled.get_transaction_by_id(txid))
            assert pt.validation_code == jpt.validation_code
            assert pt.transaction_envelope.encode() == \
                jpt.transaction_envelope.encode()
            assert led.tx_id_exists(txid) and jled.tx_id_exists(txid)
    assert led.get_block_by_number(len(blocks)) is None
    assert led.get_transaction_by_id("no-such-tx") is None
    assert not led.tx_id_exists("no-such-tx")


def test_simulation_equals_reference(ledgers):
    _root, _mgr, led, jled, _blocks = ledgers
    keys = sorted(key for ns, key, _v, _ver in led.state.iter_state()
                  if ns == NS)
    assert keys
    qe, jqe = led.new_query_executor(), jled.new_query_executor()
    for key in keys + ["absent"]:
        assert qe.get_state(NS, key) == jqe.get_state(NS, key)
    assert list(qe.get_state_range(NS, keys[0], keys[-1])) == \
        list(jqe.get_state_range(NS, keys[0], keys[-1]))
    # read a committed key and an absent one, write, delete, pin, range
    sims = []
    for ledger in (led, jled):
        sim = ledger.new_tx_simulator("sim-tx")
        assert sim.get_state(NS, keys[0]) is not None
        assert sim.get_state(NS, "absent") is None
        sim.set_state(NS, "new", b"v")
        assert sim.get_state(NS, "new") == b"v"
        sim.delete_state(NS, keys[1])
        sim.set_state_metadata(NS, keys[2], "VALIDATION_PARAMETER", b"p")
        list(sim.get_state_range(NS, keys[0], keys[3]))
        sims.append(sim.done().encode())
    assert sims[0] == sims[1]


def test_reopen_replays_the_block_store(ledgers):
    root, _mgr, led, _jled, _blocks = ledgers
    again = LedgerManager(str(root / "port"))
    try:
        assert again.ledger_ids() == ["ch"]
        reopened = again.create_or_open("ch")
        assert reopened.height == led.height
        assert reopened.state_fingerprint() == led.state_fingerprint()
    finally:
        again.close()
