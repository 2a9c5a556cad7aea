"""Broker-based consenter: ordering through a shared append-only topic.

The port's copy of fabric_mod_tpu/orderer/broker.py (`Broker` :33-101,
`BrokerChain` :112; reference: orderer/consensus/kafka — chain.go:1181:
every orderer posts envelopes to one partition and consumes the SAME
offset-ordered stream, so all nodes cut identical blocks; batch
timeouts are made deterministic by time-to-cut (TTC) messages — the
first TTC naming a block number wins, later ones are ignored; the last
consumed offset rides in block metadata so a restart resumes mid-stream
without re-cutting, LAST_OFFSET_PERSISTED).

`Broker` is the transport seam: an in-process stand-in for the kafka
cluster, with optional file persistence.  A topic file is a run of
frames `<len u32 LE><crc32 u32 LE><message>`, and a message is
`<kind u8><number i64 LE><payload>` (kind 0 a normal envelope, 1 a
config envelope, 2 a TTC; number the config sequence, or the TTC's
block number).  The format is the reference's byte for byte, so either
package reads the other's topic.  Opening a topic crops a torn tail
(a frame cut short or failing its CRC) and truncates the file there.
Determinism comes from the stream, not the broker: any transport that
delivers the same messages in the same order to every consumer works.

A channel runs on it when its ConsensusType is "kafka" and the
registrar's `consenters` maps that type to
`lambda support: BrokerChain(broker, support)`.
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

from fabric_mod_tpu_torch.concurrency import RegisteredThread
from fabric_mod_tpu_torch.orderer.consensus import ChainHaltedError
from fabric_mod_tpu_torch.protos import messages as m

_NORMAL, _CONFIG, _TTC = 0, 1, 2
TOPIC_SUFFIX = ".topic"


class Broker:
    """Offset-ordered topics (reference: the kafka partition).  With
    `dir_path`, every append is framed, flushed and fsynced to
    `<dir_path>/<topic>.topic`, and the topics found there load on
    open."""

    def __init__(self, dir_path: Optional[str] = None):
        self._dir = dir_path
        self._topics: Dict[str, List[bytes]] = {}
        self._files: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        if dir_path:
            os.makedirs(dir_path, exist_ok=True)
            for name in sorted(os.listdir(dir_path)):
                if name.endswith(TOPIC_SUFFIX):
                    self._load(name[:-len(TOPIC_SUFFIX)])

    def _load(self, topic: str) -> None:
        path = os.path.join(self._dir, topic + TOPIC_SUFFIX)
        with open(path, "rb") as f:
            raw = f.read()
        msgs: List[bytes] = []
        pos = good = 0
        while pos + 8 <= len(raw):
            ln, crc = struct.unpack_from("<II", raw, pos)
            end = pos + 8 + ln
            if end > len(raw) or zlib.crc32(raw[pos + 8:end]) != crc:
                break
            msgs.append(raw[pos + 8:end])
            good = pos = end
        if good < len(raw):
            with open(path, "r+b") as f:
                f.truncate(good)
        self._topics[topic] = msgs

    def append(self, topic: str, msg: bytes) -> int:
        """-> the assigned offset."""
        with self._cv:
            msgs = self._topics.setdefault(topic, [])
            if self._dir:
                f = self._files.get(topic)
                if f is None:
                    f = open(os.path.join(self._dir, topic + TOPIC_SUFFIX),
                             "ab")
                    self._files[topic] = f
                f.write(struct.pack("<II", len(msg), zlib.crc32(msg)) + msg)
                f.flush()
                os.fsync(f.fileno())
            msgs.append(msg)
            self._cv.notify_all()
            return len(msgs) - 1

    def read(self, topic: str, from_offset: int,
             timeout_s: float = 0.2) -> List[Tuple[int, bytes]]:
        """Messages at offsets >= from_offset; waits up to `timeout_s`
        when there are none (the consumer poll)."""
        with self._cv:
            msgs = self._topics.get(topic, [])
            if from_offset >= len(msgs):
                self._cv.wait(timeout_s)
                msgs = self._topics.get(topic, [])
            return [(i, msgs[i]) for i in range(from_offset, len(msgs))]

    def close(self) -> None:
        with self._lock:
            for f in self._files.values():
                f.close()
            self._files.clear()


def _encode(kind: int, payload: bytes, number: int = 0) -> bytes:
    return bytes([kind]) + struct.pack("<q", number) + payload


def _decode(raw: bytes) -> Tuple[int, int, bytes]:
    return raw[0], struct.unpack_from("<q", raw, 1)[0], raw[9:]


class BrokerChain:
    """Consenter over a Broker topic (reference: kafka chain.go:1181).

    Every ordering decision derives from the shared stream: size cuts
    from the message counts, timeout cuts from the first TTC naming the
    next block number, so every consumer builds the same blocks.  Each
    block carries the offset of the last message it includes in
    metadata slot OFFSET_MD_SLOT; a chain reopened over its store
    resumes from the offset after it, so messages pending at a crash
    are consumed again and nothing written is cut twice."""

    # the consenter-metadata slot (the reference's ORDERER index: its
    # kafka chain keeps LAST_OFFSET_PERSISTED there, the Raft chain its
    # applied index; a channel has one consenter)
    OFFSET_MD_SLOT = 3

    def __init__(self, broker: Broker, support,
                 topic: Optional[str] = None):
        self._broker = broker
        self._support = support
        self._topic = topic or support.channel_id
        self._halted = threading.Event()
        self._thread = RegisteredThread(
            target=self._run, name=f"broker-chain[{self._topic}]",
            structure="orderer.broker")
        self._timer_lock = threading.Lock()
        self._timer: Optional[threading.Timer] = None
        self._consumed = 0
        store = support.store
        if store.height > 1:
            tip = store.get_block_by_number(store.height - 1)
            md = tip.metadata.metadata if tip.metadata else []
            # slot 4: chains written before the offset moved to the
            # consenter slot resume too (reference :144-152)
            for slot in (self.OFFSET_MD_SLOT, 4):
                if len(md) > slot and md[slot] and len(md[slot]) == 8:
                    self._consumed = struct.unpack("<q", md[slot])[0] + 1
                    break
        # the offset of the newest message in the cutter's pending batch
        # (what a cut of the pending batch is stamped with)
        self._pending_last = self._consumed - 1

    @property
    def consumed(self) -> int:
        """The next offset this chain reads."""
        return self._consumed

    # -- consenter surface ------------------------------------------------
    def start(self) -> None:
        self._thread.start()

    def halt(self) -> None:
        self._halted.set()
        with self._timer_lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
        if self._thread.is_alive():
            self._thread.join(timeout=5)

    def wait_ready(self) -> None:
        if self._halted.is_set():
            raise ChainHaltedError("chain is halted")

    def order(self, env: m.Envelope, config_seq: int) -> None:
        self.wait_ready()
        self._broker.append(self._topic,
                            _encode(_NORMAL, env.encode(), config_seq))

    def configure(self, env: m.Envelope, config_seq: int) -> None:
        self.wait_ready()
        self._broker.append(self._topic,
                            _encode(_CONFIG, env.encode(), config_seq))

    # -- timeout -> TTC (reference: sendTimeToCut) ------------------------
    def _arm_timer(self, next_block: int) -> None:
        with self._timer_lock:
            if self._timer is not None or self._halted.is_set():
                return

            def fire():
                with self._timer_lock:
                    self._timer = None
                if not self._halted.is_set():
                    self._broker.append(self._topic,
                                        _encode(_TTC, b"", next_block))
            self._timer = threading.Timer(self._support.batch_timeout_s(),
                                          fire)
            self._timer.daemon = True
            self._timer.start()

    def _disarm_timer(self) -> None:
        with self._timer_lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None

    # -- the consume loop -------------------------------------------------
    def _write(self, batch, offset: int, is_config: bool = False,
               config_env: Optional[m.Envelope] = None) -> None:
        support = self._support
        block = support.writer.create_next_block(batch)
        md = block.metadata.metadata
        while len(md) <= self.OFFSET_MD_SLOT:
            md.append(b"")
        md[self.OFFSET_MD_SLOT] = struct.pack("<q", offset)
        if is_config:
            support.process_config(config_env, block)
        else:
            support.writer.write_block(block)

    def _run(self) -> None:
        support = self._support
        while not self._halted.is_set():
            for offset, raw in self._broker.read(self._topic,
                                                 self._consumed):
                if self._halted.is_set():
                    return
                self._consume(support, offset, raw)
                self._consumed = offset + 1

    def _consume(self, support, offset: int, raw: bytes) -> None:
        kind, number, payload = _decode(raw)
        if kind == _TTC:
            # the first TTC for the CURRENT next block cuts; stale ones
            # (earlier numbers) are ignored.  The block is stamped with
            # the last message it INCLUDES, not the TTC's offset
            if number == support.store.height:
                batch = support.cutter.cut()
                if batch:
                    self._disarm_timer()
                    self._write(batch, self._pending_last)
            return
        try:
            env = m.Envelope.decode(payload)
        except Exception:
            return
        if kind == _CONFIG:
            if number < support.sequence():
                try:
                    env, _cfg, _seq = support.reprocess_config(env)
                except Exception:
                    return
            pending = support.cutter.cut()
            if pending:
                self._disarm_timer()
                self._write(pending, self._pending_last)
            self._write([env], offset, is_config=True, config_env=env)
            return
        if number < support.sequence():
            try:
                support.revalidate_normal(env)
            except Exception:
                return
        batches, pending = support.cutter.ordered(env)
        for idx, batch in enumerate(batches):
            self._disarm_timer()
            # a batch holds THIS message only when it is the last one
            # and nothing stayed pending; earlier batches end at the
            # previous pending tail
            contains_env = idx == len(batches) - 1 and not pending
            self._write(batch, offset if contains_env
                        else self._pending_last)
        if pending:
            self._pending_last = offset
            self._arm_timer(support.store.height)
