"""Shared per-block deliver fan-out: materialize once, ship to N.

The port's copy of fabric_mod_tpu/peer/fanout.py (reference:
common/deliver/deliver.go + core/peer/deliverevents.go — block
materialization is the shared object and the stream the cheap thing:
without it every Deliver/DeliverFiltered stream re-fetches,
re-projects, re-encodes and re-ACL-checks every block on its own).

Three shared dimensions, one engine:

* `BlockFanout` — one per (channel, form in {full, filtered}): on each
  commit notification the block is materialized once (the filtered
  projection once, the `DeliverResponse` wire bytes encoded once) into
  a bounded ring of ready frames that N streams consume by sequence
  number.  A slow subscriber past the ring's tail gets a per-stream
  ledger re-read (counted, never inserted: replaying cold history must
  not evict the tip's frames).
* `CommitNotifier` (ledger/notifier.py) — one thread parked on the
  ledger's commit condition materializes the new frames and then wakes
  the parked streams.
* `AclGroups` — standing subscriptions grouped by (resource, creator):
  the session ACL re-check runs once per (group, config sequence [,
  forced config block]) with one `check_acl` on the group's
  representative SignedData, and the verdict goes to every member.
  This is sound because a group's members share the creator identity,
  each member's own seek signature was verified at admission, and the
  re-check's verdict depends only on (creator, current config).  With
  an `ACLProvider` over the channel's verifier each check is one
  device call.

The filtered projection decodes the block body in one vectorized pass
(protos/batchdecode.py) with the per-tx decode as the fallback for any
row the scanner cannot prove clean.  Metrics and tracing spans of the
reference are left out; its `deliver.fanout` fault point is in
`get_frame`, so an injected stream death kills one consumer only.  The
ring
size is a constructor argument (the reference's
FABRIC_MOD_TPU_FANOUT_RING, default 128).
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, Optional

from fabric_mod_tpu_torch import faults
from fabric_mod_tpu_torch.ledger.notifier import CommitNotifier
from fabric_mod_tpu_torch.observability import tracing
from fabric_mod_tpu_torch.protos import batchdecode
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil

FORMS = ("full", "filtered")
# the reference's FABRIC_MOD_TPU_FANOUT_RING default
RING_SIZE = 128


# ---------------------------------------------------------------------------
# Filtered-block projection (reference: deliverevents.go:293), shared by
# the ring (batch path) and the per-stream arm.
# ---------------------------------------------------------------------------

def _filtered_actions(tx_bytes: bytes) -> m.FilteredTransactionActions:
    """The generic per-tx action projection: the fallback that owns the
    verdict for anything the batch scanner cannot prove clean."""
    actions = []
    tx = m.Transaction.decode(tx_bytes)
    for action in tx.actions:
        cap = m.ChaincodeActionPayload.decode(action.payload)
        if cap.action is None:
            continue
        prp = m.ProposalResponsePayload.decode(
            cap.action.proposal_response_payload)
        cca = m.ChaincodeAction.decode(prp.extension)
        event = None
        if cca.events:
            ev = m.ChaincodeEvent.decode(cca.events)
            # payload stripped, per the reference's filtered contract
            event = m.ChaincodeEvent(chaincode_id=ev.chaincode_id,
                                     tx_id=ev.tx_id,
                                     event_name=ev.event_name)
        actions.append(m.FilteredChaincodeAction(chaincode_event=event))
    return m.FilteredTransactionActions(chaincode_actions=actions)


def filtered_block(channel_id: str, block: m.Block,
                   batch: bool = True) -> m.FilteredBlock:
    """Project a committed block to its filtered form: per tx its txid,
    header type, validation code and chaincode events with the payload
    stripped (filtered streams never carry application data).

    With `batch` (the default) the spine and tx-body layers decode in
    one vectorized pass; a row the scanner cannot prove clean falls back
    to the generic per-tx decode, which owns every malformed-input
    outcome, so the output is value-identical to the per-tx projection
    (`batch=False`, the differential reference and the per-stream
    arm)."""
    flags = protoutil.block_txflags(block)
    envs = protoutil.get_envelopes(block)
    datas = list(block.data.data)
    spine = (batchdecode.decode_block_spine(datas) if batch
             else [None] * len(datas))
    tx_datas = [row.payload.data
                if row is not None
                and row.ch.type == m.HeaderType.ENDORSER_TRANSACTION
                else None
                for row in spine]
    batch_actions = batchdecode.decode_filtered_actions(tx_datas)
    ftxs = []
    for i, env in enumerate(envs):
        code = (flags[i] if i < len(flags)
                else m.TxValidationCode.NOT_VALIDATED)
        row = spine[i]
        if row is not None:
            payload, ch = row.payload, row.ch
        else:
            try:
                payload = protoutil.unmarshal_envelope_payload(env)
                ch = m.ChannelHeader.decode(payload.header.channel_header)
            except Exception:
                # an undecodable envelope still carries its code
                ftxs.append(m.FilteredTransaction(tx_validation_code=code))
                continue
        ftx = m.FilteredTransaction(txid=ch.tx_id, type=ch.type,
                                    tx_validation_code=code)
        if ch.type == m.HeaderType.ENDORSER_TRANSACTION:
            if batch_actions[i] is not None:
                ftx.transaction_actions = batch_actions[i]
            else:
                try:
                    ftx.transaction_actions = _filtered_actions(
                        payload.data)
                except Exception:
                    # a malformed tx body: the filtered event still
                    # carries txid and code, which is the contract
                    pass
        ftxs.append(ftx)
    return m.FilteredBlock(channel_id=channel_id,
                           number=block.header.number,
                           filtered_transactions=ftxs)


def _is_config_block(block: m.Block) -> bool:
    """Whether a committed block carries a channel config tx (its first
    envelope's header type; config blocks hold exactly one)."""
    try:
        env = protoutil.get_envelopes(block)[0]
        payload = protoutil.unmarshal_envelope_payload(env)
        ch = m.ChannelHeader.decode(payload.header.channel_header)
        return ch.type == m.HeaderType.CONFIG
    except Exception:
        return False


def encode_frame(channel_id: str, form: str, block: m.Block,
                 batch: bool = True) -> bytes:
    """The wire DeliverResponse for one (block, form): what a per-stream
    sender would build; the ring builds it once.  `batch=False` is the
    per-tx projection (the per-stream arm and the identity gate's
    reference)."""
    if form == "filtered":
        resp = m.DeliverResponse(
            filtered_block=filtered_block(channel_id, block, batch=batch))
    else:
        resp = m.DeliverResponse(block=block)
    return resp.encode()


class _ConfigMemo:
    """Bounded LRU over (block number -> is config block): both forms'
    rings and every per-stream re-read share it, so a block is
    classified at most once while it stays warm; evictions go one at a
    time."""

    def __init__(self, cap: int = 4096):
        self._cap = cap
        self._d: "collections.OrderedDict[int, bool]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def classify(self, block: m.Block) -> bool:
        num = block.header.number
        with self._lock:
            if num in self._d:
                self._d.move_to_end(num)
                return self._d[num]
        val = _is_config_block(block)
        with self._lock:
            self._d[num] = val
            self._d.move_to_end(num)
            while len(self._d) > self._cap:
                self._d.popitem(last=False)
        return val

    def __len__(self) -> int:
        return len(self._d)


class _Frame:
    """One ready-to-send block frame: encoded once, shipped N times."""

    __slots__ = ("num", "payload", "is_config")

    def __init__(self, num: int, payload: bytes, is_config: bool):
        self.num = num
        self.payload = payload
        self.is_config = is_config


def _fanout_stats() -> Dict[str, int]:
    return {"materialized": 0, "encoded": 0, "ring_hits": 0,
            "fallbacks": 0}


class BlockFanout:
    """The bounded ring of ready frames for one (channel, form).  `ledger`
    gives `height` and `get_block_by_number`; `stats` may be shared with
    an engine (a bare ring, such as the dissemination relay's, keeps its
    own)."""

    def __init__(self, channel_id: str, ledger, form: str,
                 ring_size: int = RING_SIZE,
                 stats: Optional[Dict[str, int]] = None,
                 classify: Optional[Callable[[m.Block], bool]] = None):
        self._channel_id = channel_id
        self._ledger = ledger
        self.form = form
        self._ring_size = max(1, ring_size)
        self._ring: Dict[int, _Frame] = {}
        self._lock = threading.Lock()
        self._classify = classify or _is_config_block
        self.stats = stats if stats is not None else _fanout_stats()

    def _build(self, num: int) -> Optional[_Frame]:
        blk = self._ledger.get_block_by_number(num)
        if blk is None:
            return None
        with tracing.span("fanout.materialize", block=num):
            is_cfg = self._classify(blk)
            payload = encode_frame(self._channel_id, self.form, blk)
        return _Frame(num, payload, is_cfg)

    def materialize_upto(self, height: int) -> None:
        """Fill the ring window [height - ring_size, height): called by
        the notifier thread on commit, and by a joining stream catching
        up inside the window.  Exactly once: the whole fill runs under
        the ring lock, so a racing on-demand get() never repeats the
        projection and encode."""
        with self._lock:
            lo = max(0, height - self._ring_size)
            for num in range(lo, height):
                if num in self._ring:
                    continue
                fr = self._build(num)
                if fr is None:
                    break
                self._ring[num] = fr
                self.stats["materialized"] += 1
                self.stats["encoded"] += 1
            for num in [k for k in self._ring if k < lo]:
                del self._ring[num]

    def get(self, num: int) -> Optional[_Frame]:
        """The frame for block `num`, or None when it is not committed
        yet.  Inside the ring window: the shared frame (materialized at
        most once).  Past the tail: a per-stream re-read, counted and
        not inserted."""
        height = self._ledger.height
        if num >= height:
            return None
        with self._lock:
            fr = self._ring.get(num)
        if fr is not None:
            self.stats["ring_hits"] += 1
            return fr
        if num >= height - self._ring_size:
            # a stream joining mid-chain inside the window: fill the
            # ring on demand (shared with any concurrent joiner)
            self.materialize_upto(height)
            with self._lock:
                fr = self._ring.get(num)
            if fr is not None:
                self.stats["ring_hits"] += 1
                return fr
        self.stats["fallbacks"] += 1
        return self._build(num)


# ---------------------------------------------------------------------------
# Batched session ACLs
# ---------------------------------------------------------------------------

class _AclGroup:
    """All standing subscriptions for one (resource, creator)."""

    __slots__ = ("resource", "rep_sd", "verdicts", "lock")

    def __init__(self, resource: str, rep_sd):
        self.resource = resource
        self.rep_sd = rep_sd
        # (config_sequence, forced config block or None) -> error or None
        self.verdicts: "collections.OrderedDict" = collections.OrderedDict()
        self.lock = threading.Lock()


class AclGroupSession:
    """One stream's handle on its group's shared session re-check: a
    no-op until the config sequence moves, forced when a config block
    flows through this stream; the evaluation runs once per (group,
    key), not once per stream."""

    __slots__ = ("_groups", "_group", "_seq")

    def __init__(self, groups: "AclGroups", group: _AclGroup, seq0):
        self._groups = groups
        self._group = group
        self._seq = seq0

    def recheck(self, force: bool = False,
                config_mark: Optional[int] = None) -> None:
        seq = self._groups.sequence()
        if not force and seq == self._seq:
            return
        self._seq = seq
        self._groups.check(self._group, seq,
                           config_mark if force else None)


class AclGroups:
    """Group registry and the once-per-(group, key) evaluator.  `acl`
    gives `check_acl(resource, sds)` and, optionally,
    `config_sequence()`."""

    _VERDICT_KEEP = 64

    def __init__(self, acl, channel_id: str):
        self._acl = acl
        self._seq_of = getattr(acl, "config_sequence", None)
        self._channel_id = channel_id
        self._groups: Dict[tuple, _AclGroup] = {}
        self._lock = threading.Lock()
        self.stats = {"checks": 0, "reuses": 0}

    def sequence(self):
        return self._seq_of() if self._seq_of is not None else None

    def join(self, resource: str, sd, seq0) -> AclGroupSession:
        key = (resource, bytes(sd.identity))
        with self._lock:
            group = self._groups.get(key)
            if group is None:
                group = _AclGroup(resource, sd)
                self._groups[key] = group
        return AclGroupSession(self, group, seq0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._groups)

    def check(self, group: _AclGroup, seq, mark: Optional[int]) -> None:
        """Evaluate (or reuse) the group's verdict for (seq, mark); a
        deny is raised for every member (fail-closed).

        Reuse is sound only because a verdict depends on (creator,
        config sequence): a provider that exposes no `config_sequence`
        gives no key under which verdicts are stable, so every check
        evaluates afresh."""
        key = (seq, mark)
        with group.lock:
            if seq is not None and key in group.verdicts:
                err = group.verdicts[key]
                self.stats["reuses"] += 1
            else:
                err = None
                try:
                    self._acl.check_acl(group.resource, [group.rep_sd])
                except Exception as e:
                    # the deny is the verdict: kept and raised for every
                    # member below (a verifier's error included, so the
                    # session fails closed)
                    err = e
                if seq is not None:
                    group.verdicts[key] = err
                    while len(group.verdicts) > self._VERDICT_KEEP:
                        group.verdicts.popitem(last=False)
                self.stats["checks"] += 1
        if err is not None:
            raise err


# ---------------------------------------------------------------------------
# The engine: two rings, a notifier and the ACL groups, one per channel
# ---------------------------------------------------------------------------

class FanoutEngine:
    """One channel's shared deliver fan-out (see the module docstring).
    `ledger` gives `height`, `height_changed` and `get_block_by_number`
    (a KvLedger); `acl` an ACLProvider or any object with its
    `check_acl` (and optionally `config_sequence`)."""

    def __init__(self, channel_id: str, ledger, acl,
                 ring_size: int = RING_SIZE):
        self.channel_id = channel_id
        self._ledger = ledger
        self.stats: Dict[str, Dict[str, int]] = {
            form: _fanout_stats() for form in FORMS}
        self.cfg_memo = _ConfigMemo()
        self.fanouts: Dict[str, BlockFanout] = {
            form: BlockFanout(channel_id, ledger, form, ring_size,
                              self.stats[form],
                              classify=self.cfg_memo.classify)
            for form in FORMS}
        self.acl_groups = AclGroups(acl, channel_id)
        self.notifier = CommitNotifier(
            ledger.height_changed, lambda: ledger.height,
            name=f"deliver-{channel_id}")
        self.notifier.on_commit(self._on_commit)
        self._subs = {form: 0 for form in FORMS}
        self._subs_lock = threading.Lock()

    # -- subscriber accounting (a form with no subscribers skips the
    #    eager per-commit materialization; on-demand fills cover joins)
    def attach(self, form: str) -> None:
        with self._subs_lock:
            self._subs[form] += 1

    def detach(self, form: str) -> None:
        with self._subs_lock:
            self._subs[form] -= 1

    def _on_commit(self, height: int) -> None:
        for form in FORMS:
            with self._subs_lock:
                active = self._subs[form] > 0
            if active:
                self.fanouts[form].materialize_upto(height)

    def get_frame(self, form: str, num: int) -> Optional[_Frame]:
        """One stream pulling its next frame; the `deliver.fanout`
        seam kills that stream only, the ring and the others untouched."""
        faults.point("deliver.fanout")
        return self.fanouts[form].get(num)

    def close(self) -> None:
        self.notifier.close()
