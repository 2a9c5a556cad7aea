"""The port's semaphore, service limiter and endorser cap against the
reference's (tests/test_aux_components.py `test_semaphore_sheds_load`
and `test_endorser_concurrency_cap`): the same requests are shed in
both packages."""
import threading

import pytest

from fabric_mod_tpu.utils import semaphore as ref_sem
from fabric_mod_tpu_torch.utils import semaphore as port_sem


def _shed_script(mod):
    """The reference test's requests in order: True served, False shed."""
    out = []

    def attempt(cm):
        try:
            with cm:
                out.append(True)
        except mod.AcquireTimeout:
            out.append(False)

    sem = mod.Semaphore(1)
    with sem.acquire():
        attempt(sem.acquire(timeout_s=0.05))
    attempt(sem.acquire(timeout_s=0.05))
    out.append(sem.try_acquire())
    out.append(sem.try_acquire())
    sem.release()
    lim = mod.ServiceLimiter({"endorser": 1, "off": 0}, timeout_s=0.05)
    with lim.limit("endorser"):
        attempt(lim.limit("endorser"))
        attempt(lim.limit("off"))
    attempt(lim.limit("unlimited-service"))
    attempt(lim.limit("endorser"))
    return out


def test_semaphore_sheds_load():
    assert _shed_script(port_sem) == _shed_script(ref_sem) == [
        False, True, True, False, False, True, True, True]
    with pytest.raises(ValueError):
        port_sem.Semaphore(0)


def _statuses(net, endorser_cls, signer, proposal):
    """[first, while the only permit is held, after] response statuses
    of a max_concurrency=1 endorser."""
    capped = endorser_cls(net.channel, net.chaincodes, signer,
                          max_concurrency=1)
    out = [capped.process_proposal(proposal(b"k0")).response.status]
    capped._limiter._sem.acquire()
    try:
        r = capped.process_proposal(proposal(b"k1")).response
        out.append(r.status)
        assert r.status != 503 or "endorser overloaded" in r.message
    finally:
        capped._limiter.release()
    out.append(capped.process_proposal(proposal(b"k2")).response.status)
    return out


def test_endorser_concurrency_cap(tmp_path):
    from fabric_mod_tpu import e2e as ref_e2e
    from fabric_mod_tpu.peer.endorser import Endorser as RefEndorser
    from fabric_mod_tpu.protos import protoutil as ref_pu
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp.sw import SwVerifier
    from fabric_mod_tpu_torch.peer.endorser import Endorser
    from fabric_mod_tpu_torch.protos import protoutil
    from fabric_mod_tpu_torch.utils import fixtures

    ref_net = ref_e2e.Network(str(tmp_path / "ref"), batch_timeout="100ms",
                              max_message_count=5)
    net = e2e.Network(str(tmp_path / "port"),
                      fixtures.make_network_material(
                          5, max_message_count=5, batch_timeout="100ms"),
                      verifier=SwVerifier())
    got = {}
    try:
        def ref_run():
            got["ref"] = _statuses(
                ref_net, RefEndorser, ref_net.endorsers["Org1"]._signer,
                lambda k: ref_pu.create_chaincode_proposal(
                    ref_net.channel_id, "mycc", [b"put", k, b"v"],
                    ref_net.client)[0])
        t = threading.Thread(target=ref_run)
        t.start()                         # both wait out their 5 s shed
        got["port"] = _statuses(
            net, Endorser, net.peer_signers["Org1"],
            lambda k: protoutil.create_chaincode_proposal(
                net.channel_id, "mycc", [b"put", k, b"v"], net.client)[0])
        t.join(60)
        assert Endorser(net.channel, net.chaincodes,
                        net.peer_signers["Org1"])._limiter is None
    finally:
        net.close()
        ref_net.close()
    assert got["port"] == got["ref"] == [200, 503, 200]
