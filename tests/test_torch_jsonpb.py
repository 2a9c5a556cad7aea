"""The port's protos/jsonpb.py against the reference's: `to_json` gives
equal dicts and `proto_encode` equal bytes across the packages, for a
genesis Config, a 16-tx Block, one of its Envelopes and a ConfigUpdate,
and a hypothesis round trip over seeded field values."""
import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from fabric_mod_tpu.protos import jsonpb as ref_jsonpb
from fabric_mod_tpu.protos import messages as rm
from fabric_mod_tpu_torch.protos import jsonpb
from fabric_mod_tpu_torch.protos import messages as m


@pytest.fixture(scope="module")
def samples():
    """{type name: encoded message}: a genesis Config, a 16-tx Block,
    its first Envelope, and the ConfigUpdate of a BatchSize change."""
    from fabric_mod_tpu_torch.channelconfig import config_from_block
    from fabric_mod_tpu_torch.channelconfig import update
    from fabric_mod_tpu_torch.utils import fixtures
    material = fixtures.make_network_material(21, max_message_count=1000)
    _cid, config = config_from_block(m.Block.decode(material.genesis))
    blocks, _flags = fixtures.make_commit_blocks(
        fixtures.make_commit_world(), 1, 16)
    block = m.Block.decode(blocks[0])
    new = m.Config.decode(config.encode())
    for g in new.channel_group.groups:
        if g.key == "Orderer":
            for v in g.value.values:
                if v.key == "BatchSize":
                    bs = m.BatchSize.decode(v.value.value)
                    bs.max_message_count = 500
                    v.value.value = bs.encode()
    cu = update.compute_update("testchannel", config, new.channel_group)
    return {"Config": config.encode(), "Block": blocks[0],
            "Envelope": block.data.data[0], "ConfigUpdate": cu.encode()}


@pytest.mark.parametrize("type_name",
                         ["Config", "Block", "Envelope", "ConfigUpdate"])
def test_json_and_bytes_equal_across_packages(samples, type_name):
    raw = samples[type_name]
    got = jsonpb.proto_decode(type_name, raw)
    want = ref_jsonpb.proto_decode(type_name, raw)
    assert got == want
    assert got                                      # not an empty message
    text = json.loads(json.dumps(got, sort_keys=True))
    assert jsonpb.proto_encode(type_name, text) == raw
    assert ref_jsonpb.proto_encode(type_name, text) == raw
    msg = getattr(m, type_name).decode(raw)
    assert jsonpb.from_json(type_name, got) == msg
    assert jsonpb.to_json(msg) == got


def test_unknown_field_and_type_raise():
    with pytest.raises(jsonpb.JsonPbError, match="no field 'nope'"):
        jsonpb.from_json("Config", {"nope": 1})
    with pytest.raises(jsonpb.JsonPbError, match="unknown message type"):
        jsonpb.proto_decode("NoSuchType", b"")
    with pytest.raises(jsonpb.JsonPbError, match="unknown message type"):
        jsonpb.proto_encode("NoSuchType", {})
    with pytest.raises(jsonpb.JsonPbError, match="no field"):
        jsonpb.from_json("Config", {"channel_group": {"groups": [
            {"key": "x", "value": {"bogus": 1}}]}})


_names = st.text(alphabet="abcdefghijklmnopqrstuvwxyzABC_/.-", max_size=12)


@st.composite
def _configs(draw):
    def group(depth):
        return rm.ConfigGroup(
            version=draw(st.integers(0, 2 ** 32)),
            groups=([rm.ConfigGroupEntry(key=draw(_names), value=group(
                depth - 1)) for _ in range(draw(st.integers(0, 2)))]
                    if depth else []),
            values=[rm.ConfigValueEntry(key=draw(_names), value=rm.ConfigValue(
                version=draw(st.integers(0, 9)),
                value=draw(st.binary(max_size=40)),
                mod_policy=draw(_names)))
                for _ in range(draw(st.integers(0, 3)))],
            mod_policy=draw(_names))
    return rm.Config(sequence=draw(st.integers(0, 2 ** 63)),
                     channel_group=group(2))


@settings(max_examples=60, deadline=None, derandomize=True)
@given(_configs())
def test_round_trip_over_seeded_field_values(cfg):
    raw = cfg.encode()
    got = jsonpb.proto_decode("Config", raw)
    assert got == ref_jsonpb.proto_decode("Config", raw)
    assert jsonpb.proto_encode("Config", got) == raw
    assert jsonpb.from_json(m.Config, got) == m.Config.decode(raw)
