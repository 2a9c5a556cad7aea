"""Vectorized block decode: one varint/field scan per layer for all txs
of a block — the port's copy of fabric_mod_tpu/protos/batchdecode.py.

`decode_block_spine` (reference :198) evaluates the protobuf wire
grammar of the envelope spine (Envelope -> Payload -> Header ->
ChannelHeader / SignatureHeader) as numpy array arithmetic over the
whole block at once: tag varints, length varints and bounds checks are
batched gathers and masks, and only the final per-row object
construction stays in Python.  `decode_block_rwsets` (reference :679)
extends the scan down through each endorser tx's body (Transaction ->
... -> ChaincodeAction -> TxReadWriteSet -> KVRWSet -> its reads,
writes, range queries and metadata writes) into flat per-block planes
that the vectorized MVCC (ledger/mvcc.py) compares with numpy, and a
`TxBody` per tx that staging reads instead of re-decoding.
`decode_filtered_actions` (reference :330) walks the same body layers
down to the chaincode event for the deliver fan-out's filtered
projection (peer/fanout.py).

Correctness stance (as the reference's): the scanner's ACCEPTANCE must
be sound, not complete.  A row the scanner accepts produces values
identical to the generic decoder (protos/messages.py; differential-
tested against the reference's scanner, which is tested against the
generic decoder, including zero-suppressed defaults, unknown-field
skipping and wire-type enforcement); any row it cannot prove clean —
truncated varints, >9-byte varints, unknown wire types, known fields on
the wrong wire type, DUPLICATED known fields (the generic decoder
parses every occurrence of a submessage/string field, so last-wins
acceptance is only sound for a single one), trailing bytes, malformed
UTF-8 — comes back as ``None`` and the caller re-runs the generic
per-tx decoder, which owns the verdict for malformed inputs.  The
scanner therefore can never *change* a validation outcome, only skip
redundant host work.  Blocks of fewer than 4 rows are not scanned (the
numpy setup costs more than the generic decode there).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from fabric_mod_tpu_torch.protos import messages as m

# the spine never carries more fields per message than this; rows with
# more fall back to the generic decoder
_MAX_FIELDS = 12
# varints longer than 9 bytes (shift > 56) fall back: vectorizing the
# 10-byte two's-complement tail is not worth it for fields that are
# timestamps and enums in practice
_MAX_VARINT = 9


class SpineRow:
    """One tx's batch-decoded spine: the exact objects the per-tx
    staging loop would have decoded itself."""

    __slots__ = ("env", "payload", "ch", "sh")

    def __init__(self, env: m.Envelope, payload: m.Payload,
                 ch: m.ChannelHeader, sh: m.SignatureHeader):
        self.env = env
        self.payload = payload
        self.ch = ch
        self.sh = sh


def _read_varints(flat: np.ndarray, pos: np.ndarray, active: np.ndarray,
                  width: int = _MAX_VARINT):
    """Vectorized varint decode at per-row byte offsets.

    Returns (value uint64, nbytes int64, ok bool) — rows with no
    terminator within `width` bytes come back ok=False (the caller
    falls back to the generic decoder for them; `width` is sized per
    call site: tags are 1-2 bytes, lengths < 2^28, only field VALUES
    need the full 9).  Reads are clipped to the flat buffer; the
    caller's bounds checks reject any row whose varint would have
    crossed its span, so clipped/neighbor bytes never influence an
    accepted row's value.
    """
    k = min(width, _MAX_VARINT) + 1
    idx = pos[:, None] + np.arange(k, dtype=np.int64)
    b = flat[np.minimum(idx, flat.size - 1)].astype(np.uint64)
    stop = (b & np.uint64(0x80)) == 0
    first_stop = np.argmax(stop, axis=1)
    nbytes = first_stop.astype(np.int64) + 1
    ok = active & stop.any(axis=1) & (nbytes <= k - 1)
    take = np.arange(k)[None, :] < nbytes[:, None]
    shifts = (np.uint64(7) * np.arange(k, dtype=np.uint64))[None, :]
    val = np.where(take, (b & np.uint64(0x7F)) << shifts,
                   np.uint64(0)).sum(axis=1, dtype=np.uint64)
    return val, nbytes, ok


def scan_message(flat: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                 spec: dict, max_fields: int = _MAX_FIELDS):
    """Scan one message layer for every row at once.

    `spec` maps field number -> kind ("u"/"i" varint, "r" a REPEATED
    length-delimited field — wire-type enforced but not captured and
    not dup-rejected, for declared repeated fields the caller does not
    read, e.g. endorsements — anything else a single length-delimited
    span).  Returns (results, ok): results[num] is a
    dict of (val, off, ln, present) arrays (absent -> default; a
    DUPLICATED known field rejects its row — see the module
    docstring); ok marks rows
    whose ENTIRE span parsed cleanly under the wire rules the generic
    decoder enforces.  Rows entering with start == end are trivially
    ok (an empty message decodes to all defaults).
    """
    n = starts.size
    pos = starts.astype(np.int64).copy()
    ends = ends.astype(np.int64)
    ok = np.ones(n, bool)
    res = {num: {"val": np.zeros(n, np.uint64),
                 "off": np.zeros(n, np.int64),
                 "ln": np.zeros(n, np.int64),
                 "present": np.zeros(n, bool)}
           for num, kind in spec.items() if kind != "r"}
    zero = np.int64(0)
    for _ in range(max_fields):
        active = ok & (pos < ends)
        if not active.any():
            break
        # spine tags are single-byte (field <= 15); a 2-byte budget
        # still accepts any field the specs name, and higher unknown
        # fields just fall back
        tagv, tagn, tok = _read_varints(flat, pos, active, width=2)
        ok &= np.where(active, tok, True)
        active &= tok
        pos2 = pos + np.where(active, tagn, zero)
        wt = (tagv & np.uint64(7)).astype(np.int64)
        num = (tagv >> np.uint64(3)).astype(np.int64)

        is0 = active & (wt == 0)
        if is0.any():
            v0, n0, ok0 = _read_varints(flat, pos2, is0)
            ok &= np.where(is0, ok0 & (pos2 + n0 <= ends), True)
        else:                         # no varint fields this round
            v0 = np.zeros(n, np.uint64)
            n0 = np.zeros(n, np.int64)

        is2 = active & (wt == 2)
        l2, n2, ok2 = _read_varints(flat, pos2, is2, width=4)
        l2i = l2.astype(np.int64)
        body = pos2 + n2
        ok &= np.where(is2, ok2 & (l2 < np.uint64(1 << 31))
                       & (body + l2i <= ends), True)

        is5 = active & (wt == 5)
        is1 = active & (wt == 1)
        ok &= np.where(is5, pos2 + 4 <= ends, True)
        ok &= np.where(is1, pos2 + 8 <= ends, True)
        ok &= ~(active & ~(is0 | is2 | is5 | is1))

        hitrow = active & ok
        for fnum, kind in spec.items():
            hit = hitrow & (num == fnum)
            if kind == "r":
                # declared repeated field the caller skips: every
                # occurrence must still be length-delimited (the
                # generic decoder raises otherwise), nothing captured
                ok &= ~(hit & (wt != 2))
                continue
            want0 = kind in ("u", "i")
            # the generic decoder raises on a known field arriving on
            # the wrong wire type — reject the row so the fallback
            # reproduces that outcome
            ok &= ~(hit & (wt != (0 if want0 else 2)))
            # DUPLICATED known fields also fall back: the generic
            # decoder parses EVERY occurrence of a submessage/string
            # field (and raises on a malformed non-last one) while
            # this scanner would only validate the last — last-wins
            # acceptance is only sound when there is exactly one
            ok &= ~(hit & res[fnum]["present"])
            hit &= ok
            slot = res[fnum]
            if want0:
                slot["val"] = np.where(hit, v0, slot["val"])
            else:
                slot["off"] = np.where(hit, body, slot["off"])
                slot["ln"] = np.where(hit, l2i, slot["ln"])
            slot["present"] |= hit

        adv = np.where(is0, n0, zero)
        adv = np.where(is2, n2 + l2i, adv)
        adv = np.where(is5, np.int64(4), adv)
        adv = np.where(is1, np.int64(8), adv)
        pos = np.where(active & ok, pos2 + adv, pos)
    # anything still unconsumed (more fields than the scan budget, or
    # a parse that stalled) is a fallback row, not a verdict
    ok &= pos >= ends
    return res, ok


_ENV_SPEC = {1: "b", 2: "b"}
_PAYLOAD_SPEC = {1: "b", 2: "b"}
_HEADER_SPEC = {1: "b", 2: "b"}
_SH_SPEC = {1: "b", 2: "b"}
_CH_SPEC = {1: "i", 2: "i", 3: "u", 4: "s", 5: "s", 6: "u",
            7: "b", 8: "b"}


def _span(res: dict, num: int):
    return res[num]["off"], res[num]["ln"]


def decode_block_spine(datas: Sequence[bytes]
                       ) -> List[Optional[SpineRow]]:
    """Batch-decode the Envelope/Payload/Header spine of a whole block.

    Returns one entry per tx: a SpineRow whose decoded objects are
    value-identical to the generic per-tx decode, or None for any row
    the scanner could not prove clean (the caller falls back to the
    generic decoder for exactly those rows).  Rows with an empty or
    absent payload, or an absent payload.header, are also None: their
    flag outcome (NIL_ENVELOPE / BAD_PAYLOAD) belongs to the per-tx
    path's own error handling.
    """
    n = len(datas)
    out: List[Optional[SpineRow]] = [None] * n
    if n < 4:
        return out                    # numpy setup beats tiny blocks
    try:
        lens = np.fromiter(map(len, datas), np.int64, n)
        joined = b"".join(datas)
    except TypeError:
        return out
    if not joined:
        return out
    flat = np.frombuffer(joined, np.uint8)
    starts = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    ends = starts + lens

    # L1: Envelope(payload, signature)
    env_res, ok = scan_message(flat, starts, ends, _ENV_SPEC)
    pay_off, pay_ln = _span(env_res, 1)
    ok &= env_res[1]["present"] & (pay_ln > 0)

    def gated(off, ln):
        """Empty spans for already-rejected rows: the layer scan is a
        no-op there (ok stays whatever it was)."""
        return np.where(ok, off, 0), np.where(ok, off + ln, 0)

    # L2: Payload(header, data)
    s2, e2 = gated(pay_off, pay_ln)
    pl_res, ok2 = scan_message(flat, s2, e2, _PAYLOAD_SPEC)
    ok &= ok2 & pl_res[1]["present"]
    hdr_off, hdr_ln = _span(pl_res, 1)
    data_off, data_ln = _span(pl_res, 2)

    # L3: Header(channel_header, signature_header)
    s3, e3 = gated(hdr_off, hdr_ln)
    h_res, ok3 = scan_message(flat, s3, e3, _HEADER_SPEC)
    ok &= ok3
    ch_off, ch_ln = _span(h_res, 1)
    sh_off, sh_ln = _span(h_res, 2)

    # L4: ChannelHeader (all eight fields) + SignatureHeader
    s4, e4 = gated(ch_off, ch_ln)
    ch_res, ok4 = scan_message(flat, s4, e4, _CH_SPEC)
    ok &= ok4
    s5, e5 = gated(sh_off, sh_ln)
    sh_res, ok5 = scan_message(flat, s5, e5, _SH_SPEC)
    ok &= ok5

    sig_off, sig_ln = _span(env_res, 2)
    cre_off, cre_ln = _span(sh_res, 1)
    non_off, non_ln = _span(sh_res, 2)
    ext_off, ext_ln = _span(ch_res, 7)
    tls_off, tls_ln = _span(ch_res, 8)
    cid_off, cid_ln = _span(ch_res, 4)
    tid_off, tid_ln = _span(ch_res, 5)

    # python-native lists for the construction loop: indexing numpy
    # scalars row by row costs more than the whole scan
    (pay_o, pay_l, sig_o, sig_l, data_o, data_l, ch_o, ch_l, sh_o,
     sh_l, cre_o, cre_l, non_o, non_l, ext_o, ext_l, tls_o, tls_l,
     cid_o, cid_l, tid_o, tid_l) = (
        a.tolist() for a in (
            pay_off, pay_ln, sig_off, sig_ln, data_off, data_ln,
            ch_off, ch_ln, sh_off, sh_ln, cre_off, cre_ln, non_off,
            non_ln, ext_off, ext_ln, tls_off, tls_ln, cid_off,
            cid_ln, tid_off, tid_ln))
    ch_type = ch_res[1]["val"].tolist()
    ch_ver = ch_res[2]["val"].tolist()
    ch_ts = ch_res[3]["val"].tolist()
    ch_epoch = ch_res[6]["val"].tolist()

    for i in np.nonzero(ok)[0].tolist():
        try:
            channel_id = joined[cid_o[i]:cid_o[i] + cid_l[i]].decode()
            tx_id = joined[tid_o[i]:tid_o[i] + tid_l[i]].decode()
        except UnicodeDecodeError:
            continue                  # generic decode raises: fallback
        env = m.Envelope(
            payload=joined[pay_o[i]:pay_o[i] + pay_l[i]],
            signature=joined[sig_o[i]:sig_o[i] + sig_l[i]])
        payload = m.Payload(
            header=m.Header(
                channel_header=joined[ch_o[i]:ch_o[i] + ch_l[i]],
                signature_header=joined[sh_o[i]:sh_o[i] + sh_l[i]]),
            data=joined[data_o[i]:data_o[i] + data_l[i]])
        ch = m.ChannelHeader(
            type=ch_type[i], version=ch_ver[i],
            timestamp=ch_ts[i], channel_id=channel_id,
            tx_id=tx_id, epoch=ch_epoch[i],
            extension=joined[ext_o[i]:ext_o[i] + ext_l[i]],
            tls_cert_hash=joined[tls_o[i]:tls_o[i] + tls_l[i]])
        sh = m.SignatureHeader(
            creator=joined[cre_o[i]:cre_o[i] + cre_l[i]],
            nonce=joined[non_o[i]:non_o[i] + non_l[i]])
        out[i] = SpineRow(env, payload, ch, sh)
    return out


# ---------------------------------------------------------------------------
# Tx-body layers: the deliver fan-out's shared filtered
# projection walks Transaction -> TransactionAction ->
# ChaincodeActionPayload -> ChaincodeEndorsedAction ->
# ProposalResponsePayload -> ChaincodeAction -> ChaincodeEvent — the
# "residual per-tx staging python" tail — in the same one-scan-per-
# layer style as the spine.  Every DECLARED field of each message is
# in its spec so a wrong-wire-type occurrence rejects the row exactly
# where the generic decoder would raise; `actions` is spec'd single
# (a multi-action tx dup-rejects into the sound per-tx fallback), and
# the submessages the per-tx decode parses (each endorsement, the
# chaincode action's response and chaincode id) get sub-scans.
# ---------------------------------------------------------------------------

_TX_SPEC = {1: "b"}                    # Transaction.actions (1 action)
_TXA_SPEC = {1: "b", 2: "b"}           # TransactionAction
_CAP_SPEC = {1: "b", 2: "b"}           # ChaincodeActionPayload
_PRP_SPEC = {1: "b", 2: "b"}           # ProposalResponsePayload
_CCA_SPEC = {1: "b", 2: "b", 3: "b", 4: "b"}   # ChaincodeAction
_CEV_SPEC = {1: "s", 2: "s", 3: "s", 4: "b"}   # ChaincodeEvent


def decode_filtered_actions(tx_datas: Sequence[Optional[bytes]]
                            ) -> List[Optional[
                                m.FilteredTransactionActions]]:
    """Batch-build FilteredTransactionActions for a block's endorser
    txs (payload.data per tx; None rows are skipped).

    Same contract as :func:`decode_block_spine`: an entry is either
    value-identical to the per-tx generic path
    (``peer/fanout._filtered_actions`` — chaincode event payloads
    STRIPPED) or ``None``, and the caller re-runs the generic decoder
    for exactly the ``None`` rows, which keeps ownership of every
    malformed-input outcome.  Unlike the reference's scanner, this one
    also validates the submessages the per-tx decode parses and the
    reference skips (each Endorsement, the ChaincodeAction's response
    and chaincode_id): a row malformed only there is ``None`` here, where
    the reference returns actions that its per-tx path would not.
    """
    n = len(tx_datas)
    out: List[Optional[m.FilteredTransactionActions]] = [None] * n
    live = [i for i, d in enumerate(tx_datas) if d is not None]
    nl = len(live)
    if nl < 4:
        return out                    # numpy setup beats tiny batches
    try:
        lens = np.fromiter((len(tx_datas[i]) for i in live), np.int64, nl)
        joined = b"".join(tx_datas[i] for i in live)
    except TypeError:
        return out
    if not joined:
        return out
    flat = np.frombuffer(joined, np.uint8)
    starts = np.zeros(nl, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    ends = starts + lens

    def gated(off, ln, mask):
        """Empty spans for rows outside `mask`: their layer scan is a
        trivially-ok no-op (absent parents stay absent)."""
        return np.where(mask, off, 0), np.where(mask, off + ln, 0)

    # L1: Transaction(actions) — dup field 1 (a multi-action tx)
    # rejects into the fallback, so accepted rows have 0 or 1 action
    tx_res, ok = scan_message(flat, starts, ends, _TX_SPEC)
    act_off, act_ln = _span(tx_res, 1)
    act_present = tx_res[1]["present"]

    # L2: TransactionAction(header, payload)
    s, e = gated(act_off, act_ln, ok & act_present)
    ta_res, ok2 = scan_message(flat, s, e, _TXA_SPEC)
    ok &= ok2
    pay_off, pay_ln = _span(ta_res, 2)

    # L3: ChaincodeActionPayload(ccpp, action)
    s, e = gated(pay_off, pay_ln, ok & act_present)
    cap_res, ok3 = scan_message(flat, s, e, _CAP_SPEC)
    ok &= ok3
    ea_off, ea_ln = _span(cap_res, 2)
    # absent action => the generic loop `continue`s (empty actions
    # list); PRESENT-but-empty still decodes the cascade of defaults
    ea_present = cap_res[2]["present"]

    # L4: ChaincodeEndorsedAction(prp, endorsements*) — the generic
    # decode parses every Endorsement, so each occurrence gets a
    # validating sub-scan (the reference skips them, spec "r", and so
    # accepts rows whose endorsement the per-tx decode rejects)
    deep = ok & act_present & ea_present
    s, e = gated(ea_off, ea_ln, deep)
    cea_res, ok4, cea_rep = scan_collect(flat, s, e, _CEA_RW_SPEC)
    ok &= ok4
    e_rows, e_off, e_ln = cea_rep[2]
    _, ok_e = scan_message(flat, e_off, e_off + e_ln, _END_SPEC)
    bad = e_rows[~ok_e]
    if bad.size:
        ok[np.unique(bad)] = False
    prp_off, prp_ln = _span(cea_res, 1)

    # L5: ProposalResponsePayload(hash, extension)
    s, e = gated(prp_off, prp_ln, deep)
    prp_res, ok5 = scan_message(flat, s, e, _PRP_SPEC)
    ok &= ok5
    ext_off, ext_ln = _span(prp_res, 2)

    # L6: ChaincodeAction(results, events, response, chaincode_id) —
    # response and chaincode_id are submessages the generic decode
    # parses, so both get validating sub-scans (the reference's scanner
    # does not)
    s, e = gated(ext_off, ext_ln, deep)
    cca_res, ok6 = scan_message(flat, s, e, _CCA_SPEC)
    ok &= ok6
    for fnum, spec in ((3, _RESP_SPEC), (4, _CCID_SPEC)):
        off, ln = _span(cca_res, fnum)
        _, ok_sub = scan_message(flat, *gated(off, ln, deep), spec)
        ok &= ok_sub
    ev_off, ev_ln = _span(cca_res, 2)

    # L7: ChaincodeEvent — only for non-empty `events` (the generic
    # path's `if cca.events:` truthiness gate)
    has_ev = deep & (ev_ln > 0)
    s, e = gated(ev_off, ev_ln, ok & has_ev)
    cev_res, ok7 = scan_message(flat, s, e, _CEV_SPEC)
    ok &= ok7

    ccid_o, ccid_l = (a.tolist() for a in _span(cev_res, 1))
    txid_o, txid_l = (a.tolist() for a in _span(cev_res, 2))
    name_o, name_l = (a.tolist() for a in _span(cev_res, 3))
    act_p = act_present.tolist()
    ea_p = ea_present.tolist()
    has_e = has_ev.tolist()

    for j in np.nonzero(ok)[0].tolist():
        i = live[j]
        if not (act_p[j] and ea_p[j]):
            out[i] = m.FilteredTransactionActions(chaincode_actions=[])
            continue
        event = None
        if has_e[j]:
            try:
                event = m.ChaincodeEvent(
                    chaincode_id=joined[ccid_o[j]:ccid_o[j]
                                        + ccid_l[j]].decode(),
                    tx_id=joined[txid_o[j]:txid_o[j]
                                 + txid_l[j]].decode(),
                    event_name=joined[name_o[j]:name_o[j]
                                      + name_l[j]].decode())
            except UnicodeDecodeError:
                continue              # generic decode raises: fallback
        out[i] = m.FilteredTransactionActions(
            chaincode_actions=[m.FilteredChaincodeAction(
                chaincode_event=event)])
    return out


# ---------------------------------------------------------------------------
# Rwset columnar planes: extend the scan downward through
# the endorser-tx body — Transaction -> TransactionAction ->
# ChaincodeActionPayload -> ChaincodeEndorsedAction (endorsements
# COLLECTED this time, not skipped) -> ProposalResponsePayload ->
# ChaincodeAction (Response/ChaincodeID validated) -> TxReadWriteSet
# -> NsReadWriteSet -> KVRWSet -> KVRead/KVWrite/RangeQueryInfo/
# KVMetadataWrite — into flat per-block planes the MVCC stage can
# hash-join and compare with numpy.  Same soundness contract: any row
# (or any row whose ANY descendant) the scanner can't prove identical
# to the generic decoder falls back, counted, and the generic path
# owns the verdict.
# ---------------------------------------------------------------------------

_CEA_RW_SPEC = {1: "b", 2: "*"}        # ChaincodeEndorsedAction (collect)
_END_SPEC = {1: "b", 2: "b"}           # Endorsement
_RESP_SPEC = {1: "i", 2: "s", 3: "b"}  # Response
_CCID_SPEC = {1: "s", 2: "s", 3: "s"}  # ChaincodeID
_TXRW_SPEC = {1: "i", 2: "*"}          # TxReadWriteSet(ns_rwset*)
_NSRW_SPEC = {1: "s", 2: "b", 3: "*"}  # NsReadWriteSet(colls*)
_COLL_SPEC = {1: "s", 2: "b"}          # CollectionHashedReadWriteSet
_KVRW_SPEC = {1: "*", 2: "*", 3: "*", 4: "*"}  # KVRWSet (all collected)
_KVR_SPEC = {1: "s", 2: "b"}           # KVRead(key, version)
_VER_SPEC = {1: "u", 2: "u"}           # Version
_KVW_SPEC = {1: "s", 2: "u", 3: "b"}   # KVWrite
_RQI_SPEC = {1: "s", 2: "s", 3: "u", 4: "b"}   # RangeQueryInfo
_KVMW_SPEC = {1: "s", 2: "*"}          # KVMetadataWrite(entries*)
_KVME_SPEC = {1: "s", 2: "b"}          # KVMetadataEntry

# occurrence-collecting scans must outlast scan_message's 12-field
# budget: a KVRWSet row carries one field occurrence per read/write
_MAX_OCCURRENCES = 4096


def scan_collect(flat: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                 spec: dict, max_iters: int = _MAX_OCCURRENCES):
    """scan_message variant whose "*" fields are REPEATED
    length-delimited fields with every occurrence COLLECTED.

    Returns (results, ok, reps): results/ok as scan_message (for the
    non-"*" fields; a "*" occurrence on the wrong wire type rejects
    its row), and reps[num] = (rows, offs, lns) int64 arrays — one
    entry per occurrence, grouped by row in stable document order,
    occurrences of rows that later failed filtered out.  The loop
    runs until no row is active (pos strictly advances for every
    active row each iteration, so it terminates); rows needing more
    than `max_iters` iterations fall back via the unconsumed check.
    """
    n = starts.size
    pos = starts.astype(np.int64).copy()
    ends = ends.astype(np.int64)
    ok = np.ones(n, bool)
    res = {num: {"val": np.zeros(n, np.uint64),
                 "off": np.zeros(n, np.int64),
                 "ln": np.zeros(n, np.int64),
                 "present": np.zeros(n, bool)}
           for num, kind in spec.items() if kind not in ("r", "*")}
    rep: dict = {num: [] for num, kind in spec.items() if kind == "*"}
    zero = np.int64(0)
    for _ in range(max_iters):
        active = ok & (pos < ends)
        if not active.any():
            break
        tagv, tagn, tok = _read_varints(flat, pos, active, width=2)
        ok &= np.where(active, tok, True)
        active &= tok
        pos2 = pos + np.where(active, tagn, zero)
        wt = (tagv & np.uint64(7)).astype(np.int64)
        num = (tagv >> np.uint64(3)).astype(np.int64)

        is0 = active & (wt == 0)
        if is0.any():
            v0, n0, ok0 = _read_varints(flat, pos2, is0)
            ok &= np.where(is0, ok0 & (pos2 + n0 <= ends), True)
        else:
            v0 = np.zeros(n, np.uint64)
            n0 = np.zeros(n, np.int64)

        is2 = active & (wt == 2)
        l2, n2, ok2 = _read_varints(flat, pos2, is2, width=4)
        l2i = l2.astype(np.int64)
        body = pos2 + n2
        ok &= np.where(is2, ok2 & (l2 < np.uint64(1 << 31))
                       & (body + l2i <= ends), True)

        is5 = active & (wt == 5)
        is1 = active & (wt == 1)
        ok &= np.where(is5, pos2 + 4 <= ends, True)
        ok &= np.where(is1, pos2 + 8 <= ends, True)
        ok &= ~(active & ~(is0 | is2 | is5 | is1))

        hitrow = active & ok
        for fnum, kind in spec.items():
            hit = hitrow & (num == fnum)
            if kind in ("r", "*"):
                ok &= ~(hit & (wt != 2))
                if kind == "*":
                    hit &= ok
                    if hit.any():
                        rep[fnum].append((np.nonzero(hit)[0],
                                          body[hit], l2i[hit]))
                continue
            want0 = kind in ("u", "i")
            ok &= ~(hit & (wt != (0 if want0 else 2)))
            ok &= ~(hit & res[fnum]["present"])
            hit &= ok
            slot = res[fnum]
            if want0:
                slot["val"] = np.where(hit, v0, slot["val"])
            else:
                slot["off"] = np.where(hit, body, slot["off"])
                slot["ln"] = np.where(hit, l2i, slot["ln"])
            slot["present"] |= hit

        adv = np.where(is0, n0, zero)
        adv = np.where(is2, n2 + l2i, adv)
        adv = np.where(is5, np.int64(4), adv)
        adv = np.where(is1, np.int64(8), adv)
        pos = np.where(active & ok, pos2 + adv, pos)
    ok &= pos >= ends
    empty = np.zeros(0, np.int64)
    reps = {}
    for fnum, chunks in rep.items():
        if not chunks:
            reps[fnum] = (empty, empty, empty)
            continue
        rows = np.concatenate([c[0] for c in chunks])
        offs = np.concatenate([c[1] for c in chunks])
        lns = np.concatenate([c[2] for c in chunks])
        keep = ok[rows]               # drop occurrences of failed rows
        rows, offs, lns = rows[keep], offs[keep], lns[keep]
        order = np.argsort(rows, kind="stable")
        reps[fnum] = (rows[order], offs[order], lns[order])
    return res, ok, reps


class TxBody:
    """One accepted tx's staged body view — the exact values the
    generic ``_stage_tx``/``_stage_key_policies`` pair would have
    decoded itself (shared by VP resolution, key-level policy staging,
    and the vectorized MVCC planes)."""

    __slots__ = ("ns", "prp", "endorsements", "no_action", "has_pvt",
                 "groups")

    def __init__(self, ns, prp, endorsements, no_action, has_pvt,
                 groups):
        self.ns = ns                  # ChaincodeAction.chaincode_id.name
        self.prp = prp                # exact prp bytes endorsers signed
        self.endorsements = endorsements   # [(endorser, signature)]
        self.no_action = no_action    # tx.actions empty => NIL_TXACTION
        self.has_pvt = has_pvt        # any collection_hashed_rwset
        # ordered per-ns-OCCURRENCE written view, mirroring
        # parse_tx_rwset: [(ns, [(wkey,...)], [(mkey, entries)])]
        self.groups = groups

    def lifecycle_write_keys(self, ns: str):
        """The write keys (not metadata keys) under `ns`, in document
        order across repeated ns occurrences: what the generic decode
        gives write-aware validation-info resolution."""
        return [k for g_ns, wkeys, _metas in self.groups
                if g_ns == ns for k in wkeys]


class BlockRWSets:
    """Columnar per-block rwset planes + per-tx staged bodies.

    ``bodies[i]`` is a TxBody for every tx the scanner accepted (None
    = fall back to the generic per-tx decoder, counted in
    ``fallbacks``).  The flat planes carry one row per read / write /
    range-query / metadata-write across every ACCEPTED tx, sorted by
    tx then document order, with ``*_bounds`` searchsorted slice
    boundaries per tx; ``read_nsi``/``range_nsi`` carry a global
    ns-occurrence ordinal so MVCC can replay the generic per-ns
    check order (reads then ranges, occurrence by occurrence).
    """

    __slots__ = (
        "n", "bodies", "fallbacks", "txids", "types",
        "read_tx", "read_nsi", "read_ns", "read_key",
        "read_has_ver", "read_vb", "read_vt", "read_bounds",
        "write_tx", "write_ns", "write_key", "write_del", "write_val",
        "write_bounds",
        "range_tx", "range_nsi", "range_ns", "range_rqi",
        "range_bounds",
        "meta_tx", "meta_ns", "meta_key", "meta_entries", "meta_bounds",
    )

    def __init__(self, n: int):
        self.n = n
        self.bodies: List[Optional[TxBody]] = [None] * n
        self.fallbacks = 0
        # filled by the stage() spine pre-pass: value-identical to the
        # generic envelope_channel_header decode for spine-accepted
        # rows, None where commit must re-decode generically
        self.txids: List[Optional[str]] = [None] * n
        self.types: List[Optional[int]] = [None] * n
        self.read_tx = []
        self.read_nsi = []
        self.read_ns = []
        self.read_key = []
        self.read_has_ver = []
        self.read_vb = []
        self.read_vt = []
        self.write_tx = []
        self.write_ns = []
        self.write_key = []
        self.write_del = []
        self.write_val = []
        self.range_tx = []
        self.range_nsi = []
        self.range_ns = []
        self.range_rqi = []
        self.meta_tx = []
        self.meta_ns = []
        self.meta_key = []
        self.meta_entries = []

    def finalize(self):
        grid = np.arange(self.n + 1)
        self.read_tx = np.asarray(self.read_tx, np.int64)
        self.read_nsi = np.asarray(self.read_nsi, np.int64)
        self.read_has_ver = np.asarray(self.read_has_ver, bool)
        self.read_vb = np.asarray(self.read_vb, np.int64)
        self.read_vt = np.asarray(self.read_vt, np.int64)
        self.read_bounds = np.searchsorted(self.read_tx, grid)
        self.write_tx = np.asarray(self.write_tx, np.int64)
        self.write_bounds = np.searchsorted(self.write_tx, grid)
        self.range_tx = np.asarray(self.range_tx, np.int64)
        self.range_nsi = np.asarray(self.range_nsi, np.int64)
        self.range_bounds = np.searchsorted(self.range_tx, grid)
        self.meta_tx = np.asarray(self.meta_tx, np.int64)
        self.meta_bounds = np.searchsorted(self.meta_tx, grid)
        return self


def decode_block_rwsets(tx_datas: Sequence[Optional[bytes]]
                        ) -> Optional[BlockRWSets]:
    """Batch-decode a block's endorser-tx bodies into columnar rwset
    planes (payload.data per tx; None rows — non-endorser txs, rows
    the spine already rejected — are skipped).

    Returns None for tiny blocks (the numpy setup beats them), else a
    BlockRWSets whose accepted bodies/planes are value-identical to
    the generic Transaction -> ... -> KVRWSet decode and whose
    fallback rows (bodies[i] None with a non-None input) are counted.
    """
    n = len(tx_datas)
    live = [i for i, d in enumerate(tx_datas) if d is not None]
    nl = len(live)
    if nl < 4:
        return None                   # numpy setup beats tiny batches
    try:
        lens = np.fromiter((len(tx_datas[i]) for i in live), np.int64, nl)
        joined = b"".join(tx_datas[i] for i in live)
    except TypeError:
        return None
    if not joined:
        return None
    flat = np.frombuffer(joined, np.uint8)
    starts = np.zeros(nl, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    ends = starts + lens
    arange1 = np.arange(nl + 1)

    def spans(res, num):
        off, ln = _span(res, num)
        return off, off + ln

    def fail_parents(tx_rows, child_ok):
        """A failed descendant row makes its whole tx a fallback."""
        bad = tx_rows[~child_ok]
        if bad.size:
            ok[np.unique(bad)] = False

    # L1: Transaction(actions) — dup field 1 (multi-action) rejects
    tx_res, ok = scan_message(flat, starts, ends, _TX_SPEC)
    act_present = tx_res[1]["present"]
    # L2: TransactionAction(header, payload) — absent action rows scan
    # the (0,0) span, trivially ok (their body is NIL_TXACTION's)
    ta_res, ok2 = scan_message(flat, *spans(tx_res, 1), _TXA_SPEC)
    ok &= ok2
    # L3: ChaincodeActionPayload(ccpp, action)
    cap_res, ok3 = scan_message(flat, *spans(ta_res, 2), _CAP_SPEC)
    ok &= ok3
    # an action-bearing tx whose endorsed action is ABSENT falls back:
    # the generic path's `cap.action.proposal_response_payload` owns
    # that (AttributeError -> INVALID_ENDORSER_TRANSACTION) verdict
    ok &= ~(act_present & ~cap_res[2]["present"])
    # L4: ChaincodeEndorsedAction(prp, endorsements COLLECTED)
    cea_res, ok4, cea_rep = scan_collect(flat, *spans(cap_res, 2),
                                         _CEA_RW_SPEC)
    ok &= ok4
    e_rows, e_off, e_ln = cea_rep[2]
    # L4b: every Endorsement occurrence, flattened across the block
    end_res, ok_e = scan_message(flat, e_off, e_off + e_ln, _END_SPEC)
    fail_parents(e_rows, ok_e)
    # L5: ProposalResponsePayload(hash, extension)
    prp_res, ok5 = scan_message(flat, *spans(cea_res, 1), _PRP_SPEC)
    ok &= ok5
    # L6: ChaincodeAction(results, events, response, chaincode_id) —
    # response and chaincode_id are submessages the generic staging
    # path DECODES, so both get validating sub-scans (absent ones scan
    # the (0,0) span, trivially ok)
    cca_res, ok6 = scan_message(flat, *spans(prp_res, 2), _CCA_SPEC)
    ok &= ok6
    resp_res, ok6a = scan_message(flat, *spans(cca_res, 3), _RESP_SPEC)
    ok &= ok6a
    ccid_res, ok6b = scan_message(flat, *spans(cca_res, 4), _CCID_SPEC)
    ok &= ok6b
    # L7: TxReadWriteSet(data_model, ns_rwset COLLECTED) over results
    txrw_res, ok7, txrw_rep = scan_collect(flat, *spans(cca_res, 1),
                                           _TXRW_SPEC)
    ok &= ok7
    ns_tx, ns_off, ns_ln = txrw_rep[2]     # ns row -> live row
    # L8: NsReadWriteSet(namespace, rwset, colls COLLECTED)
    nsrw_res, ok8, nsrw_rep = scan_collect(flat, ns_off, ns_off + ns_ln,
                                           _NSRW_SPEC)
    fail_parents(ns_tx, ok8)
    c_rows, c_off, c_ln = nsrw_rep[3]      # coll row -> ns row
    # L8b: CollectionHashedReadWriteSet — validated (generic decodes
    # it), its presence marks the tx pvt-bearing
    coll_res, ok_c = scan_message(flat, c_off, c_off + c_ln, _COLL_SPEC)
    fail_parents(ns_tx[c_rows], ok_c)
    # L9: KVRWSet with all four repeated fields collected
    kv_res, ok9, kv_rep = scan_collect(flat, *spans(nsrw_res, 2),
                                       _KVRW_SPEC)
    fail_parents(ns_tx, ok9)
    r_rows, r_off, r_ln = kv_rep[1]        # read row -> ns row
    q_rows, q_off, q_ln = kv_rep[2]        # range row -> ns row
    w_rows, w_off, w_ln = kv_rep[3]        # write row -> ns row
    m_rows, m_off, m_ln = kv_rep[4]        # meta row -> ns row
    # L10: KVRead(key, version) + Version sub-scan
    kvr_res, ok_r = scan_message(flat, r_off, r_off + r_ln, _KVR_SPEC)
    fail_parents(ns_tx[r_rows], ok_r)
    ver_res, ok_v = scan_message(flat, *spans(kvr_res, 2), _VER_SPEC)
    fail_parents(ns_tx[r_rows], ok_v)
    # L10b: KVWrite / RangeQueryInfo / KVMetadataWrite(+entries)
    kvw_res, ok_w = scan_message(flat, w_off, w_off + w_ln, _KVW_SPEC)
    fail_parents(ns_tx[w_rows], ok_w)
    rqi_res, ok_q = scan_message(flat, q_off, q_off + q_ln, _RQI_SPEC)
    fail_parents(ns_tx[q_rows], ok_q)
    kvm_res, ok_m, kvm_rep = scan_collect(flat, m_off, m_off + m_ln,
                                          _KVMW_SPEC)
    fail_parents(ns_tx[m_rows], ok_m)
    me_rows, me_off, me_ln = kvm_rep[2]    # entry row -> meta row
    kvme_res, ok_me = scan_message(flat, me_off, me_off + me_ln,
                                   _KVME_SPEC)
    fail_parents(ns_tx[m_rows[me_rows]], ok_me)

    # slice boundaries: ns rows per live row, child rows per ns row,
    # entry rows per meta row — every level is row-sorted, so a tx's
    # descendants are contiguous ranges at each level
    ns_b = np.searchsorted(ns_tx, arange1)
    n_ns = ns_tx.size
    grid_ns = np.arange(n_ns + 1)
    rd_b = np.searchsorted(r_rows, grid_ns)
    wr_b = np.searchsorted(w_rows, grid_ns)
    rq_b = np.searchsorted(q_rows, grid_ns)
    mt_b = np.searchsorted(m_rows, grid_ns)
    cl_b = np.searchsorted(c_rows, grid_ns)
    en_b = np.searchsorted(me_rows, np.arange(m_rows.size + 1))
    e_b = np.searchsorted(e_rows, arange1)

    # python-native lists for the construction loop
    def lst(res, num):
        return res[num]["off"].tolist(), res[num]["ln"].tolist()

    prp_o, prp_l = lst(cea_res, 1)
    eo_o, eo_l = lst(end_res, 1)
    es_o, es_l = lst(end_res, 2)
    rm_o, rm_l = lst(resp_res, 2)          # Response.message (utf-8)
    cp_o, cp_l = lst(ccid_res, 1)          # ChaincodeID.path
    cn_o, cn_l = lst(ccid_res, 2)          # ChaincodeID.name
    cv_o, cv_l = lst(ccid_res, 3)          # ChaincodeID.version
    ccid_present = cca_res[4]["present"].tolist()
    nsn_o, nsn_l = lst(nsrw_res, 1)
    cno_o, cno_l = lst(coll_res, 1)
    rk_o, rk_l = lst(kvr_res, 1)
    ver_present = kvr_res[2]["present"].tolist()
    ver_b = ver_res[1]["val"].tolist()
    ver_t = ver_res[2]["val"].tolist()
    wk_o, wk_l = lst(kvw_res, 1)
    wd_v = kvw_res[2]["val"].tolist()
    wv_o, wv_l = lst(kvw_res, 3)
    qs_o, qs_l = lst(rqi_res, 1)
    qe_o, qe_l = lst(rqi_res, 2)
    qx_v = rqi_res[3]["val"].tolist()
    qh_o, qh_l = lst(rqi_res, 4)
    mk_o, mk_l = lst(kvm_res, 1)
    men_o, men_l = lst(kvme_res, 1)
    mev_o, mev_l = lst(kvme_res, 2)
    act_p = act_present.tolist()

    out = BlockRWSets(n)
    for j in np.nonzero(ok)[0].tolist():
        i = live[j]
        if not act_p[j]:
            out.bodies[i] = TxBody("", b"", [], True, False, [])
            continue
        try:
            # strings the generic decode would utf-8-decode (and raise
            # on): validate them all, used or not
            joined[rm_o[j]:rm_o[j] + rm_l[j]].decode()
            ns_name = ""
            if ccid_present[j]:
                joined[cp_o[j]:cp_o[j] + cp_l[j]].decode()
                joined[cv_o[j]:cv_o[j] + cv_l[j]].decode()
                ns_name = joined[cn_o[j]:cn_o[j] + cn_l[j]].decode()
            endors = [
                (joined[eo_o[k]:eo_o[k] + eo_l[k]],
                 joined[es_o[k]:es_o[k] + es_l[k]])
                for k in range(e_b[j], e_b[j + 1])]
            prp = joined[prp_o[j]:prp_o[j] + prp_l[j]]
            has_pvt = False
            groups = []
            t_reads, t_writes, t_ranges, t_metas = [], [], [], []
            for u in range(ns_b[j], ns_b[j + 1]):
                ns = joined[nsn_o[u]:nsn_o[u] + nsn_l[u]].decode()
                for c in range(cl_b[u], cl_b[u + 1]):
                    has_pvt = True
                    joined[cno_o[c]:cno_o[c] + cno_l[c]].decode()
                for r in range(rd_b[u], rd_b[u + 1]):
                    t_reads.append((
                        u, ns,
                        joined[rk_o[r]:rk_o[r] + rk_l[r]].decode(),
                        ver_present[r], ver_b[r], ver_t[r]))
                for q in range(rq_b[u], rq_b[u + 1]):
                    t_ranges.append((u, ns, m.RangeQueryInfo(
                        start_key=joined[qs_o[q]:qs_o[q]
                                         + qs_l[q]].decode(),
                        end_key=joined[qe_o[q]:qe_o[q]
                                       + qe_l[q]].decode(),
                        itr_exhausted=qx_v[q],
                        reads_merkle_hash=joined[qh_o[q]:qh_o[q]
                                                 + qh_l[q]])))
                wkeys = []
                for w in range(wr_b[u], wr_b[u + 1]):
                    key = joined[wk_o[w]:wk_o[w] + wk_l[w]].decode()
                    wkeys.append(key)
                    t_writes.append((
                        ns, key, bool(wd_v[w]),
                        joined[wv_o[w]:wv_o[w] + wv_l[w]]))
                metas = []
                for t in range(mt_b[u], mt_b[u + 1]):
                    key = joined[mk_o[t]:mk_o[t] + mk_l[t]].decode()
                    entries = [
                        (joined[men_o[x]:men_o[x]
                                + men_l[x]].decode(),
                         joined[mev_o[x]:mev_o[x] + mev_l[x]])
                        for x in range(en_b[t], en_b[t + 1])]
                    metas.append((key, entries))
                    t_metas.append((ns, key, entries))
                groups.append((ns, wkeys, metas))
        except UnicodeDecodeError:
            continue                  # generic decode raises: fallback
        out.bodies[i] = TxBody(ns_name, prp, endors, False, has_pvt,
                               groups)
        for nsi, ns, key, hv, vb, vt in t_reads:
            out.read_tx.append(i)
            out.read_nsi.append(nsi)
            out.read_ns.append(ns)
            out.read_key.append(key)
            out.read_has_ver.append(hv)
            out.read_vb.append(vb)
            out.read_vt.append(vt)
        for ns, key, is_del, val in t_writes:
            out.write_tx.append(i)
            out.write_ns.append(ns)
            out.write_key.append(key)
            out.write_del.append(is_del)
            out.write_val.append(val)
        for nsi, ns, rqi in t_ranges:
            out.range_tx.append(i)
            out.range_nsi.append(nsi)
            out.range_ns.append(ns)
            out.range_rqi.append(rqi)
        for ns, key, entries in t_metas:
            out.meta_tx.append(i)
            out.meta_ns.append(ns)
            out.meta_key.append(key)
            out.meta_entries.append(entries)
    out.fallbacks = nl - sum(
        1 for i in live if out.bodies[i] is not None)
    return out.finalize()
