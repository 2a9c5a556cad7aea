"""The system chaincodes and chaincode events, port against reference on
one chain: the JAX package's Network orders a few blocks (puts, a putev
with a chaincode event, a lifecycle definition), the port's Network,
built from the same material, commits the same blocks; QSCC and CSCC
then answer with equal payloads through either package's endorser, and
the putev tx's ChaincodeAction and filtered-block frame are equal."""
import json

import pytest

from fabric_mod_tpu.e2e import Network as JNetwork
from fabric_mod_tpu.peer import chaincode as jchaincode
from fabric_mod_tpu.peer import fanout as jfanout
from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu.protos import protoutil as jprotoutil

from fabric_mod_tpu_torch import convert, e2e
from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.peer import chaincode, fanout
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """(reference network, port network, putev tx id, put tx id)."""
    mp = pytest.MonkeyPatch()
    for knob in ("FABRIC_MOD_TPU_TENSOR_POLICY",
                 "FABRIC_MOD_TPU_COMMIT_PIPELINE"):
        mp.delenv(knob, raising=False)
    root = tmp_path_factory.mktemp("scc")
    ref = JNetwork(str(root / "ref"), max_message_count=4,
                   batch_timeout="100ms")
    pnet = e2e.Network(str(root / "port"),
                       convert.network_material_from_reference(ref),
                       verifier=sw.SwVerifier())
    try:
        put = ref.invoke([b"put", b"a", b"1"])
        ev = ref.invoke([b"putev", b"b", b"2"])
        ref.invoke([b"del", b"a"])
        assert ref.pump_committed(3) == 3
        ref.deploy_chaincode("cc2", "1.0", 1)
        for n in range(1, ref.ledger.height):
            flags = pnet.channel.store_block(m.Block.decode(
                ref.ledger.get_block_by_number(n).encode()))
            assert list(flags) == list(jprotoutil.block_txflags(
                ref.ledger.get_block_by_number(n)))
        assert pnet.ledger.state_fingerprint() == ref.ledger.state_fingerprint()
        yield ref, pnet, ev, put
    finally:
        pnet.close()
        ref.close()
        mp.undo()


def _ask(net, pu, cc, args):
    sp, _p, _t = pu.create_chaincode_proposal(net.channel_id, cc, args,
                                              net.client)
    resp = net.endorsers["Org1"].process_proposal(sp)
    return resp.response.status, resp.response.payload


@pytest.mark.parametrize("cc, args", [
    ("qscc", [b"GetChainInfo"]),
    ("qscc", [b"GetBlockByNumber", b"1"]),
    ("qscc", [b"GetBlockByNumber", b"99"]),
    ("qscc", [b"GetBlockByTxID", "put"]),
    ("qscc", [b"GetTransactionByID", "putev"]),
    ("qscc", [b"GetTransactionByID", b"nope"]),
    ("qscc", [b"Bogus"]),
    ("cscc", [b"GetConfigBlock"]),
    ("cscc", [b"GetChannelConfig"]),
    ("cscc", [b"GetChannels"]),
], ids=lambda v: v if isinstance(v, str) else None)
def test_system_chaincode_payloads_equal_reference(chain, cc, args):
    ref, pnet, ev, put = chain
    args = [{"put": put, "putev": ev}[a].encode() if isinstance(a, str)
            else a for a in args]
    got = _ask(pnet, protoutil, cc, args)
    want = _ask(ref, jprotoutil, cc, args)
    assert got == want
    if args == [b"GetChainInfo"]:
        info = json.loads(got[1])
        tip = pnet.ledger.get_block_by_number(pnet.ledger.height - 1)
        assert info["height"] == pnet.ledger.height
        assert info["currentBlockHash"] == \
            protoutil.block_header_hash(tip.header).hex()


def test_putev_action_and_filtered_frame_equal_reference(chain):
    """The same putev proposal through both packages' endorsers gives
    the same ChaincodeAction (its event included); the committed block's
    filtered frame is equal, with the event's payload stripped."""
    ref, pnet, ev, _put = chain
    sp, _p, _t = jprotoutil.create_chaincode_proposal(
        ref.channel_id, "mycc", [b"putev", b"c", b"3"], ref.client)
    jresp = ref.endorsers["Org2"].process_proposal(sp)
    presp = pnet.endorsers["Org2"].process_proposal(
        m.SignedProposal.decode(sp.encode()))
    jcca = jm.ProposalResponsePayload.decode(jresp.payload).extension
    pcca = m.ProposalResponsePayload.decode(presp.payload).extension
    assert pcca == jcca
    event = m.ChaincodeEvent.decode(m.ChaincodeAction.decode(pcca).events)
    assert (event.event_name, event.payload) == ("kv-put", b"c")
    loc = pnet.ledger.blockstore.get_tx_loc(ev)
    block = pnet.ledger.get_block_by_number(loc[0])
    frames = [fanout.encode_frame(pnet.channel_id, "filtered", block, batch=b)
              for b in (True, False)]
    jframe = jfanout.encode_frame(ref.channel_id, "filtered",
                                  jm.Block.decode(block.encode()))
    assert frames[0] == frames[1] == jframe
    fb = m.DeliverResponse.decode(frames[0]).filtered_block
    [action] = fb.filtered_transactions[loc[1]].transaction_actions \
        .chaincode_actions
    assert action.chaincode_event.event_name == "kv-put"
    assert action.chaincode_event.payload == b""
    # a tx without an event keeps the empty events field
    assert m.ChaincodeAction.decode(m.ProposalResponsePayload.decode(
        pnet.endorsers["Org2"].process_proposal(m.SignedProposal.decode(
            jprotoutil.create_chaincode_proposal(
                ref.channel_id, "mycc", [b"put", b"d", b"4"],
                ref.client)[0].encode())).payload).extension).events == b""


def _creator_event(stub):
    """A function contract: writes the creator's MSP id under args[0]
    and raises an event named after it."""
    org = stub.creator_mspid()
    stub.put_state(stub.args[0].decode(), org.encode())
    stub.set_event("by-" + org, stub.args[0])
    return org.encode()


def test_func_contract_action_equals_reference(chain):
    """A plain function registered as a FuncContract answers the same
    proposal with the same response and ChaincodeAction in both
    packages."""
    ref, pnet, _ev, _put = chain
    ref.chaincodes.register("fcc", jchaincode.FuncContract(_creator_event))
    pnet.chaincodes.register("fcc", chaincode.FuncContract(_creator_event))
    sp, _p, _t = jprotoutil.create_chaincode_proposal(
        ref.channel_id, "fcc", [b"who"], ref.client)
    jresp = ref.endorsers["Org1"].process_proposal(sp)
    presp = pnet.endorsers["Org1"].process_proposal(
        m.SignedProposal.decode(sp.encode()))
    assert (presp.response.status, presp.response.payload) == \
        (jresp.response.status, jresp.response.payload) == \
        (200, ref.client.mspid.encode())
    pcca = m.ProposalResponsePayload.decode(presp.payload).extension
    assert pcca == jm.ProposalResponsePayload.decode(jresp.payload).extension
    event = m.ChaincodeEvent.decode(m.ChaincodeAction.decode(pcca).events)
    assert (event.event_name, event.payload) == \
        ("by-" + ref.client.mspid, b"who")
