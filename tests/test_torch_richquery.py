"""Rich (JSON-selector) queries, port against reference: the selector
operators on seeded documents, `execute` with sort, fields, limit and
bookmark, the simulator's read set, and a `query` tx through the port's
KvContract and endorser."""
import json

import pytest

from fabric_mod_tpu.ledger import richquery as jrq
from fabric_mod_tpu.ledger.kvledger import KvLedger as JKvLedger
from fabric_mod_tpu.ledger.statedb import UpdateBatch as JUpdateBatch

from fabric_mod_tpu_torch.ledger import richquery as rq
from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
from fabric_mod_tpu_torch.ledger.statedb import UpdateBatch
from fabric_mod_tpu_torch.utils import fixtures

N_DOCS = 120


@pytest.fixture(scope="module")
def docs():
    return fixtures.make_rich_documents(N_DOCS, seed=15)


SELECTORS = [
    {"owner": "alice"},
    {"owner": {"$eq": "bob"}},
    {"owner": {"$ne": "bob"}},
    {"size": {"$gt": 50}},
    {"size": {"$gte": 50, "$lt": 70}},
    {"size": {"$lte": 10}},
    {"color": {"$in": ["red", "blue"]}},
    {"color": {"$nin": ["red", "blue"]}},
    {"meta.tag": {"$exists": True}},
    {"meta.tag": {"$exists": False}},
    {"size": {"$not": {"$gt": 20}}},
    {"$and": [{"owner": "carol"}, {"size": {"$gt": 30}}]},
    {"$or": [{"owner": "alice"}, {"color": "green"}]},
    {"$nor": [{"owner": "alice"}, {"color": "green"}]},
    {"$not": {"owner": "dave"}},
    {"meta.flag": True},
    {"meta.flag": 1},
    {"size": {"$gt": True}},
    {"meta.score": {"$gte": 0.5}},
    {"meta.tag": {"$lt": "t5"}},
]


@pytest.mark.parametrize("selector", SELECTORS,
                         ids=[json.dumps(s, sort_keys=True)
                              for s in SELECTORS])
def test_match_selector_equals_reference(docs, selector):
    """Every operator, booleans against numbers included, matches the
    same documents in both packages (and some, not all or none)."""
    port = [rq.match_selector(json.loads(v), selector) for _k, v in docs]
    ref = [jrq.match_selector(json.loads(v), selector) for _k, v in docs]
    assert port == ref
    if selector not in ({"size": {"$gt": True}},):
        assert 0 < sum(port) < len(docs)


def _rows(docs):
    return [(k, v, (1, i)) for i, (k, v) in enumerate(sorted(docs))]


QUERIES = [
    {"selector": {"owner": "alice"}},
    {"selector": {"size": {"$gt": 20}}, "limit": 7},
    {"selector": {"size": {"$gt": 20}}, "sort": [{"size": "desc"}],
     "limit": 9},
    {"selector": {"color": "red"}, "sort": ["owner", "size"],
     "fields": ["owner", "meta.tag"]},
    {"selector": {"owner": {"$in": ["bob", "carol"]}}, "limit": 5,
     "fields": ["size"]},
    {"selector": {"size": {"$lt": 0}}},
]


@pytest.mark.parametrize("query", QUERIES,
                         ids=[str(i) for i in range(len(QUERIES))])
def test_execute_equals_reference(docs, query):
    """Results and bookmarks are equal; the bookmark pages through the
    whole result set in both packages."""
    rows = _rows(docs)
    raw = json.dumps(query).encode()
    port = rq.execute(rows, rq.RichQuery.parse(raw))
    ref = jrq.execute(rows, jrq.RichQuery.parse(raw))
    assert port == ref
    if "limit" in query and "sort" not in query:
        pages_p, pages_r, bm_p, bm_r = [], [], "", ""
        for _ in range(40):
            page = dict(query, bookmark=bm_p)
            got, bm_p = rq.execute(rows, rq.RichQuery.parse(json.dumps(page)))
            want, bm_r = jrq.execute(rows, jrq.RichQuery.parse(
                json.dumps(dict(query, bookmark=bm_r))))
            assert got == want and bm_p == bm_r
            if not got:
                break
            pages_p.extend(got)
            pages_r.extend(want)
        full = rq.execute(rows, rq.RichQuery.parse(json.dumps(
            {"selector": query["selector"],
             **({"fields": query["fields"]} if "fields" in query else {})})))
        assert pages_p == full[0] == pages_r


@pytest.mark.parametrize("bad", [
    b"not json", b'{"limit": 3}', b'{"selector": {}, "limit": -1}',
    b'{"selector": {}, "sort": "size"}',
    b'{"selector": {"size": {"$regex": "x"}}}',
    b'{"selector": {}, "sort": [{"a": "asc"}, {"b": "desc"}]}'])
def test_bad_queries_raise_in_both(docs, bad):
    rows = _rows(docs)
    with pytest.raises(rq.QueryError):
        rq.execute(rows, rq.RichQuery.parse(bad))
    with pytest.raises(jrq.QueryError):
        jrq.execute(rows, jrq.RichQuery.parse(bad))


def test_simulator_records_reads_not_phantoms(tmp_path, docs):
    """A rich query during simulation puts each returned key in the read
    set at its committed version, with no range query: the same rwset
    bytes as the reference's simulator."""
    led = KvLedger("ch", str(tmp_path / "port"))
    jled = JKvLedger(str(tmp_path / "ref"), "ch")
    try:
        for ledger, batch in ((led, UpdateBatch()), (jled, JUpdateBatch())):
            for i, (k, v) in enumerate(docs):
                batch.put("mycc", k, v, (1, i))
            ledger.state.apply_updates(batch, 1)
        q = b'{"selector": {"owner": "alice"}, "limit": 4}'
        sim, jsim = led.new_tx_simulator("t"), jled.new_tx_simulator("t")
        got, bm = sim.execute_query("mycc", q)
        want, jbm = jsim.execute_query("mycc", q)
        assert got == want and bm == jbm and len(got) == 4
        rwset, jrwset = sim.done(), jsim.done()
        assert rwset.encode() == jrwset.encode()
        from fabric_mod_tpu_torch.ledger.rwsetutil import parse_tx_rwset
        [(ns, kv)] = parse_tx_rwset(rwset)
        assert ns == "mycc" and not kv.range_queries_info
        assert [r.key for r in kv.reads] == [k for k, _d in got]
        # the plain executor records nothing and gives the same answer
        assert led.new_query_executor().execute_query("mycc", q) == (got, bm)
    finally:
        led.close()
        jled.close()


def test_query_tx_through_kvcontract(tmp_path):
    """`query` through the port's endorser: the JSON payload lists the
    matches, and the ordered tx commits VALID with the matches read."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import sw
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    net = e2e.Network(str(tmp_path), fixtures.make_network_material(
        16, max_message_count=50, batch_timeout="100ms"),
        verifier=sw.SwVerifier())
    try:
        docs = fixtures.make_rich_documents(12, seed=3)
        for k, v in docs:
            net.invoke([b"put", k.encode(), v])
        assert net.pump_committed(len(docs)) == len(docs)
        q = b'{"selector": {"size": {"$gte": 30}}, "sort": [{"size": "asc"}]}'
        sp, _prop, _t = protoutil.create_chaincode_proposal(
            net.channel_id, "mycc", [b"query", q], net.client)
        resp = net.endorsers["Org1"].process_proposal(sp)
        assert resp.response.status == 200
        out = json.loads(resp.response.payload)
        want = sorted((json.loads(v)["size"], k) for k, v in docs
                      if json.loads(v)["size"] >= 30)
        assert [(r["doc"]["size"], r["key"]) for r in out["results"]] == want
        assert out["bookmark"] == ""
        txid = net.invoke([b"query", q])
        assert net.pump_committed(len(docs) + 1) == len(docs) + 1
        assert net.ledger.get_transaction_by_id(txid).validation_code == \
            m.TxValidationCode.VALID
    finally:
        net.close()


def test_documents_are_seeded():
    a = fixtures.make_rich_documents(20, seed=1)
    assert a == fixtures.make_rich_documents(20, seed=1)
    assert a != fixtures.make_rich_documents(20, seed=2)
    assert all(isinstance(json.loads(v), dict) for _k, v in a)
