#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's device paths once on one CUDA card: the
block commit, the end-to-end network around it (the main path) on a solo
and on a three-node Raft ordering service, gossip around it, the
dissemination tree and the deliver fan-out, channel sharding, the
durable ledger and private data, the idemix presentation verify, the
service surface (discovery, external chaincode, the broker consenter,
the operations server), the soak under churn with faults armed, the
offline tools, whose network commits under armed lock guards, and the
transport: Raft orderers and peers over mutual TLS, in process and as OS
processes, verifying on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught):

1. header — the card's name, and its name and power limit from nvidia-smi;
2. build — the four sources from fabric_mod_tpu_torch/csrc/ (nvcc,
   started together): the ladders, the verify core's prologue and
   epilogue, the raw lanes' SHA-256 and the idemix pairing check's two
   kernels, with ptxas' registers, stack,
   spills and barriers for each entry function; with them the
   measurement scripts/sha256_latency_probe.cu (into build/probe/), whose
   clock64 readings of dependent chains on one warp (the cycles a link
   of SHF -> LOP3 -> IADD3, of a shuffle and an add, and of the SHA-256
   round's own chain) phase 3's chain floor uses;
3. kernel against plain — each ladder kernel at 2048 lanes against its
   plain PyTorch version on the card (random windows, distinct keys
   (i+2)G, identity-adjacent edge lanes, an off-curve and a (0, 0) key):
   canonical X, Y, Z must be bit-equal, and the mixed ladder must equal
   the projective one in affine form on every valid-key lane.  Then the
   verify core's kernels (utils/fixtures.make_core_lanes at 2048 lanes:
   signatures plus edge lanes — digests >= n, an all-zero padding lane,
   an off-curve and a (0, 0) key, r + n < p, out-of-range scalars
   s = 2^256 - 1 and, set here, s = n, a host-masked lane): the
   prologue's window planes and key_ok must be bit-equal to the plain
   prologue's at 2048 lanes, at 16 and at 1 lane, and for every edge
   lane alone; the epilogue's verdicts over the ladder's output equal to
   the plain epilogue's and the construction's.  Prints each kernel's
   ms per call, the bound (32-bit multiply-adds the function needs over
   the card's integer multiply-add rate at its SM clock, or its bytes
   over the memory rate) and, for the ladders, threads per lane, block
   size and one lane's critical path in rounds.  The verify core's
   kernels are timed on the device alone (CUDA events around launches
   made straight through the C entry point and queued behind a sleep)
   and through their wrappers (CUDA events over 10 calls, and host wall
   per call), the prologue at 1, 16 and 2048 lanes.  Then the SHA-256
   kernel (csrc/sha256.cu) at 2048 lanes: the block-commit fixture's
   real creator and endorser messages and edge lengths (0 to 3000
   bytes), every 97th lane without a message; its e rows must be
   bit-equal to the plain sha256_blocks' on every lane (and hashlib's on
   sampled lanes), the other rows and lanes untouched.  At the main
   path's inputs (2048 real messages): bit-equal again, device time,
   the plain version's time, the bound (32-bit operations over the real
   blocks, or bytes) and the launch geometry; bit-equal and timed at 16
   and 1 lanes too; at each width the cycles a round of the longest
   lane, the chain floor (the kernel's longest dependent chain in its
   SASS, a step, times the cycles a dependent instruction takes, from
   phase 2's probe, and the round's chain measured whole; "not
   measured" where cuobjdump cannot read the SASS) and the dispatch
   floor (its ALU-pipe instructions a step x 2 cycles); its SASS opcode
   counts; and the
   words plane's host packing time, bytes and pinned upload time, as the
   main path packs it and with the reference's power-of-two rounding;
4. verify path — 4 blocks of 1000 transactions (3000 signatures each,
   2-of-3 endorsement) through GpuVerifier.verify_many, once per ladder;
   the 4th block's endorser items are raw messages hashed on the card
   by the SHA-256 kernel (the plain torch SHA-256 must not run there).
   Verdicts must equal the fixtures' expected masks bit for bit and, on
   256 sampled lanes per block, the pure-python software verify; the
   five ECDSA kernels' launch counts (zeroed just before) must have risen;
5. block commit — the system's main path: 4 encoded blocks of 1000
   transactions (utils/fixtures.make_commit_blocks: every planted invalid
   kind, a VALIDATION_PARAMETER pin) through the port's Committer
   (TxValidator, MVCC, durable ledger) into a fresh ledger per arm:
   (a) the projective ladder with the tensor-policy evaluator, which must
   receive a CUDA mask on every block; (b) the same with the policy
   closures; (c) the mixed ladder with the evaluator; (d) the host
   software verifier, the oracle (over 6 spawned processes); (f) as (a) on
   make_commit_world(raw_messages=True): every item a raw message,
   hashed by the SHA-256 kernel, which no other arm may launch (arm (e)
   of earlier versions, the vectorized MVCC, is now every arm's).
   Staging runs the columnar batch decode, and the commit the vectorized
   MVCC, in every arm, which must take it on every block.  Every
   arm's txflags must equal the fixture's and each other, every state
   fingerprint must be equal, and the five ECDSA kernels' launch counts
   (zeroed just before) must have risen.  Prints ms per block by stage
   (the stage split into the batch decode and the rest), the spine and
   body scans' fallback rows, committed tx/s and the evaluator's device
   ms;
8. e2e (run after 5) — the system's own end-to-end loop
   (fabric_mod_tpu_torch/e2e.py `Network`): one channel of 3 orgs from
   utils/fixtures.make_network_material, a solo orderer cutting 1000-tx
   blocks on count (batch timeout 10 s), one committing peer with the
   projective-ladder GpuVerifier and the tensor-policy evaluator, 2,000
   put txs (2 blocks: Raft orders two entries and the deliver client's
   double buffer holds two blocks; cut from 4,000 to keep the script
   inside its time limit beside phase 14) endorsed up front (2 of 3
   orgs, MAJORITY) by
   fixtures.make_e2e_stream.  Two arms in turns, each on a fresh
   network from the same seed's material:
   (a) unstaged, the Writers check on the host, one submitting thread,
   with a planted kind of each sort every 50 txs (one-org endorsement, a
   flipped endorsement, an MVCC read conflict, a resubmitted envelope, a
   setvp pin that drains the commit pipe at a barrier, and a tampered
   creator signature that Broadcast rejects); every block's flags must
   be the construction's in submission order;
   (b) staged ingress with the Writers check batched on the card
   (`Network(ingress_batching=True, staged_batch=256)`, 32 submitting
   threads) on the order-free stream (only the one-org and the flipped
   endorsements and the tampered creator are planted: concurrent
   submitters reorder the envelopes, and those kinds' flags do not
   depend on the order); every txid's flag must be the construction's,
   the ingress verify calls must have batched more than one envelope
   on average, and no submitter may see a device error.
   Timed (e2e.commit_until, as e2e.run_pipeline): the deliver client
   starts, the submitters broadcast every envelope, and the span ends
   when the 2,000 txs are committed.  In both arms every block must hold
   1000 txs, the rejections must be exactly the tampered envelopes, the
   state fingerprint must equal that of a fresh ledger fed the ordered
   blocks with the expected flags, the MCS (one verify per block) and
   the validator (one fused verify per block) — and in (b) ingress —
   must each have launched the prologue, the projective ladder and the
   epilogue (launches counted by the calling path), and the evaluator
   must have received a CUDA mask on every block.  Prints, per arm,
   committed tx/s, ingress seconds per submit, the deliver client's
   stage/await/commit seconds, MCS ms per block, the kernel launches by
   path and the evaluator's fallbacks; in (b) the ingress device calls
   and the mean cohort.  Then torch.profiler over one block of (a)'s on
   a fresh peer, its MCS check and its stage-and-commit: launches,
   device busy, idle share;
7. idemix (run last) — the batched FP256BN
   pairing check on its two hand-written kernels (csrc/fp256bn_pairing.cu
   via ops/fp256bn_cuda.py): (a) a pairing check at 1024 lanes, a
   1000-tx idemix block's width, from utils/fixtures.make_pairing_lanes
   (every 97th lane tampered), with the launch counts zeroed just
   before: exactly one Miller and one final-exponentiation launch; the
   mask stays a CUDA tensor until its one copy and must be bit-equal to
   the plain version's on the card (ops/fp256bn_dev.pairing_check_plain),
   to the construction's and, on 8 sampled lanes, to the host pairings'
   equality; ms per check (CUDA events and wall, warm, and the first
   call's), the plain check's ms; then each kernel on the check's inputs
   against its plain version on the card (the Miller words bit-equal,
   the verdicts equal, and the final exponentiation's pairing-mode words
   on all 1024 lanes bit-equal), both kernels again at the ragged widths
   1, 33 and 63, their device ms (CUDA events around launches queued
   behind a sleep), the plain version's ms and the bound (the
   reference's Fp products a lane as 32-bit multiply-adds over the
   card's rate, or bytes), beside the kernels' own products and rounds a
   lane and their geometry (threads a lane, lanes a block, blocks, warps
   an SM); (b) 4 full pairings
   through the kernels, each equal to the host `pairing` exactly; (c)
   batch_verify of 64 presentations (3 planted kinds): verdicts equal
   the expected ones and, on the first 16, the host path's;
   presentations/s of both paths, the 63-lane check's ms (events and
   wall) and its share of the device path; (d) the plain version's
   profile at 1024 lanes: torch.profiler over one of each repeated piece
   (the line precompute, a Miller doubling step, an add step, a
   cyclotomic square, a multiply, and the rest once), scaled by the
   schedule's static counts: launches per check, device busy ms, idle
   share; under `--phase 7` only (the whole script leaves it out for its
   time limit), after phase 7's other parts, since a window of ~10^5
   device records blinds later ones (PERF.md §7);
6. profile (run after 9) — torch.profiler over one verify of each
   block kind, over a verify call of one signature, of one 2048-lane
   bucket and of one raw 2048-lane bucket (which must launch the four
   kernels once each), and over one whole block commit:
   wall time, device busy time and idle share, the heaviest device
   kernels; and over the policy evaluator's pass alone: its launches
   and device time per block.  Every torch.profiler window (phases 6,
   8, 10, 11, 12, 14 and 15 (a)) prints the hand-written launches it
   recorded against those made while it was open; where it missed one,
   busy is printed as a lower bound and the idle share as an upper one.

9. Raft e2e (run after 8) — phase 8's two arms again, each on a fresh
   network of three Raft orderers (utils/fixtures.make_network_material
   with consensus_type="etcdraft": one RaftChain per orderer over one
   in-process RaftTransport, each orderer its own registrar, store and
   WAL), with Fabric's documented etcdraft timing (election 5-10 s,
   heartbeat 0.5 s); the first election happens before the timed span
   and the peer delivers from the first orderer.  The arms reuse phase
   8's endorsed streams (the networks share the seed's certificates):
   (c) unstaged, one submitter sending every envelope to a follower,
   which forwards it to the leader; per-block flags in submission
   order; (d) staged (`ingress_batching=True, staged_batch=256`, each
   orderer its own ingress service over the one verifier), 32
   submitters spread round-robin over the three orderers; flags per
   txid.  Every check of phase 8 holds, and the three orderers' stores
   must hold the same chain (heights, header hashes, metadata slot 3,
   a signature of each node's own), the leader must not change during
   the span, submits must have been forwarded, and (c)'s state
   fingerprint must equal (a)'s (the same envelopes in the same
   order).  Prints phase 8's figures and the forwarded submits, the
   elections and leader changes during the span and each node's WAL
   fsyncs.

10. gossip (run last, after 9, 6 and 7: after (b)'s long profiled
   window, later torch.profiler windows on the card recorded none of the
   hand-written kernels; BASELINE.md #5, the reference's bench.py:1278
   and :2229) — (a) the storm: 96 puts ordered by a solo network into
   three 32-tx blocks; 50 peer threads, each its own MCS over one
   bundle, start on a barrier and verify the blocks 3 times over: on
   the host verifier (the oracle), then through one
   BatchingVerifyService over the card's GpuVerifier with no memo-cache
   (a warm-up run, the timed run, a profiled run) and with the default
   memo-cache; every peer must accept every block and, in every arm,
   reject a copy with one flipped orderer-signature byte.  Prints block
   verifies/s of each arm and their ratio, the calls into the
   GpuVerifier and the mean cohort, the launches, and the split of
   sampled MCS calls (every 10th peer's) into host time, verify_many's
   wall and the device span of the calls they rode on.  (b) the
   network: a solo network orders the first 2 blocks of phase 8 arm
   (a)'s stream (1000 txs each, arm (a)'s order); 50 gossip peers, each
   its own ledger, Channel (tensor policy, commit pipe of depth 2),
   GossipNode and GossipService, every channel's verifier one
   BatchingVerifyService over one GpuVerifier, every view seeded, then
   a round of signed alive messages from 4 of the peers (each to every
   other; fresh news is forwarded; cut from all 50 for the time limit); a copy of block 1 with a flipped signature byte is pushed
   to every peer, which must reject it; the minimum-PKI-ID peer, pinned
   as static leader, delivers and pushes, the others commit what the
   pushes and their pulls bring.  Every peer must reach the orderer's
   height with arm (a)'s flags and state, keep no error, and the three
   digest kernels must have launched.  Prints the wall from the first
   delivered block to the last peer's last commit, peer-blocks/s, the
   envelopes sent, the envelope, MCS and commit verify calls, the calls
   into the GpuVerifier by size, the launches, and torch.profiler over
   the last block's spread.

11. deliver fan-out and dissemination trees (run after 10) — (a)
   bench.py:2383's top point: a solo network (50 ms batch timeout)
   orders 2 one-put blocks (cut from 6, then 4); 128 all-pull peers, each its own
   DeliverClient and orderer stream, then 128 relay-mode peers
   (dissemination.RelayService, degree 4, per-child queue 64; membership
   and each tree parent's identity seeded as bench.py:2229 does, the
   leadership pinned to the minimum (PKI-ID, endpoint)); in both arms
   every channel (tensor policy, commit pipe of depth 2) verifies through
   one BatchingVerifyService over one GpuVerifier.  The orderer must have
   served 1 stream to the relay arm and 128 to the pull arm, every
   non-leader must have taken the whole chain through the tree with each
   frame byte-identical to the pull arm's encoding, both arms must hold
   one state fingerprint, a copy of block 1 with a flipped
   orderer-signature byte relayed to a leaf must be rejected by its MCS,
   and no peer may keep an error.  Prints both arms' blocks*peers/s over
   the same blocks and their ratio, the relay's stats, the envelope, MCS
   and commit verify calls, the calls into the GpuVerifier and the mean
   cohort, the launches, and torch.profiler over the relay arm's last
   block.  (b) phase 10 (b)'s 50 peers and 2 x 1000-tx blocks with the
   relay in place of the epidemic push (seeded membership): every peer
   must reach arm (a)'s flags and state with no error kept; prints the
   spread wall, peer-blocks/s, envelopes and MCS checks a peer-block
   beside phase 10 (b)'s.  (c) bench.py:2027's top point: 10,000
   subscribers, half full and half filtered, over 8 threads, read the
   20-block fan-out chain (utils/fixtures.make_fanout_chain, block 10 a
   CONFIG block) through one FanoutEngine whose session ACL is an
   ACLProvider over the channel's bundle with the card's GpuVerifier,
   4 groups of real client identities; every stream's digest must equal
   the per-stream encoding's, each (block, form) be materialized and
   encoded once with no fallback, and the ACL checks lie between the
   group count and twice it; prints shared and per-stream blocks*subs/s
   and the ACL checks.

12. channel sharding (run after 11) — (a) bench.py:1677's multichannel
   curve at BASELINE.md #2's 1000-tx blocks: 4 channels mc0-mc3 of 2
   blocks each (utils/fixtures.make_channel_stream over
   make_commit_world's 3 orgs and 2-of-3 policy, every 4th tx endorsed
   by Org1 alone), placed by one sharding.ChannelShardRouter (depth-2
   pipes, tensor policy) on its slices — slice meshes where the cards
   split evenly, else unmeshed GpuVerifiers on the one card, without
   memo-cache — while riders verify 8 items (every 3rd tampered) every
   20 ms through the router's shared CrossChannelVerifyService.  The 7
   points of bench.py:1857-1871's axes (slices 1, 2, 4; channels 1, 2,
   4; riders 0, 4, 16), after one untimed warm point; each is gated,
   before any rate, on every channel's per-block flags and fingerprint
   equal to an independent unsharded synchronous run on one GpuVerifier
   (flags holding VALID and ENDORSEMENT_POLICY_FAILURE) and every rider
   verdict the construction's.  Prints per point committed tx/s, rider
   verifies/s, meshed, the calls into each slice's GpuVerifier and
   their mean items, the service's flushes and dispatch groups per
   slice, and the launches; once, the serial independent tx/s and
   vs_baseline at the middle point (2, 2, 4), and torch.profiler over
   the last round of a 4-slice, 4-channel point: kernels, the
   hand-written launches it recorded against those made, busy and idle
   share (bounds when it missed any), and how many kernels overlapped
   an earlier one.  (b) in one flush window a raising slice
   verifier fails only its own futures while the other slice's riders
   resolve on the card; a channel whose block has one flipped byte in
   every 10th creator signature gets exactly those txs
   BAD_CREATOR_SIGNATURE while the other channel's flags and
   fingerprint equal its independent run.  (c) with two or more cards
   only: GpuVerifier(mesh=data_mesh()) and each slice_meshes(2)
   verifier equal a one-card GpuVerifier on 2048 planted lanes; on one
   card it says so and runs nothing.

13. the durable ledger and private data (run after 12; every block
   validated by a GpuVerifier on the card, which must launch the verify
   core's three kernels in each part) — (a) bench.py:745's state-scale
   stream (8 blocks of 1000 txs, raised from bench.py's 32: 28 reads a
   tx, 0.5% stale, 2 absent probes, 3 writes with 10% deletes, 10%
   phantom and 15% empty ranges, a VALIDATION_PARAMETER pin at block 2,
   8% under-endorsed) committed by the port's Committer (tensor policy)
   into a durable and a durable=False ledger prefilled at 10,000, 100,000
   and 1,000,000 keys (bench.py:3365); before any rate, as
   bench.py:945-1001: equal flags across arms and sizes with more kinds
   than VALID, equal fingerprints across arms, incremental == full scan,
   no body-decode fallback row, and the durable ledger reopened replays
   0 blocks to the same fingerprint.  Prints per arm and size committed
   tx/s, ms a block of stage and of MVCC + commit, prefill s, the
   fingerprint's seed-scan, incremental and full-scan s, and for the
   durable arm its writes and frames a block, log bytes and reopen s.
   (b) phase 5's first 4 blocks into two durable ledgers, the last block
   of one added with its final flags to the block store only before it
   closes (the reference's crash seam, kvledger.py:452-457): the reopen
   must replay exactly one block and equal the other ledger in flags,
   fingerprint and sampled key histories; its state log then cut inside
   its last record, a reopen crops it and reaches the same fingerprint.
   (c) three peers (Org1, Org2, Org3), each a durable ledger, Channel
   and GossipNode on one in-process network, joined by signed alive
   messages: a definition of col1 (members Org1 and Org2, BTL 2), 4
   blocks of 1000 txs whose every 10th tx is private, 3 padding blocks;
   Org1's transient store holds all plaintext, Org2's forged plaintext
   for 5 txs, Org3's none.  No plaintext in any block; Org1 commits every
   private write, Org2 hashes only (digests missing, the forged
   plaintext rejected); after reconcile_tick rounds Org2's private state
   and fingerprint equal Org1's; distribute_pvt never reaches Org3 and
   Org3's requests get nothing; after the padding blocks the BTL purge
   has emptied mycc$$pcol1 and the three fingerprints are equal.  Prints
   the missing counts, the rounds and _commit_pvt's ms a block.

14. lifecycle, system chaincodes, config updates, rich queries and
   snapshots (run after 13) — a solo e2e Network at BASELINE.md #2's
   width (3 orgs, MAJORITY default, 1000-tx blocks, 2 s batch timeout)
   with the tensor policy, the default GpuVerifier on the card (its
   verdict cache on) and staged ingress from 32 threads; beside it a
   host oracle (a Channel and durable ledger of its own over the
   software verifier, run in a pool of 6 processes) commits every block
   the peer commits, to equal txflags a block and equal fingerprints
   after each part, and the verify core must launch at least once a
   block.  (a) an approval by
   Org1's admin endorsed by Org2's peer alone fails Org1's Endorsement
   policy; Org3's org-local approval is VALID; a commit with one
   approval recorded is refused at endorsement; deploy_chaincode("cc2",
   "1.0", 1, AND(Org1, Org3)) commits Org1's and Org2's approvals each
   in its own block, then the definition, every ceremony tx VALID;
   checkcommitreadiness and queryapproved read through an endorser.
   (b) 2 x 1000 blind puts over mycc and cc2, every 10th endorsed by a
   set its namespace refuses (Org1 alone; Org1 + Org2 for cc2), from 32
   threads: the construction's flags by txid; committed tx/s, stage and
   commit ms a block, verify-core launches a block, one tensor-policy
   pass a block on the card, and torch.profiler over the evaluator's
   pass on the last block, staged again after the counted parts.
   (c) cc2 sequence 2 (OutOf(2, Org1, Org2, Org3)) commits in a block
   whose cc2 invokes are still judged by sequence 1 (Org1 + Org2
   refused, Org1 + Org3 VALID); the next block by sequence 2.  (e)
   1,000 JSON documents, then one 1000-tx block: 100 query txs
   (selector, sort, limit 3) VALID, 100 more each behind a rewrite of
   its first result MVCC_READ_CONFLICT, fill puts.  (d) a config update
   by the port's compute_update, signed by the orderer org's admin and
   two org admins, takes BatchSize from 1000 to 500: the next 1000 txs
   come in 2 blocks, CSCC GetConfigBlock returns the config block, QSCC
   GetChainInfo the height and tip hash.  (f) phase 13's state-scale
   stream at 100,000 keys into a durable ledger on the card (4 blocks),
   snapshot_to, verify_snapshot, bootstrap_from_snapshot into a second
   ledger: equal fingerprints (== full scans); both commit the stream's
   next 2 blocks and a replay of a block-0 tx (DUPLICATE_TXID on both:
   the joined peer knows it only as a pruned-range tx id) through their
   own TxValidators on the card, with equal flags and fingerprints; both
   reopen replaying 0 blocks; rebuild_dbs refuses the bootstrapped
   ledger; on a closed copy of the network peer's ledger rebuild_dbs
   reopens to the same fingerprint, and rollback by 2 blocks and their
   recommit through a Channel on the card reach it again.  Prints the
   export, verify and bootstrap seconds and the snapshot's bytes.

15. observability and the orderer's ingress — (b) first, right after
   phase 3 (the process's first GpuVerifier dispatch, before any
   profiler window): the device lens, one armed GpuVerifier dispatch of
   a 1000-tx block's signatures in the 2048-lane bucket (endorser lanes
   raw) inside a torch.profiler window, whose Chrome trace must hold one
   kernel event for each launch of the window, per kernel; (a) right
   after phase 8's arms: arm (a)'s two ordered blocks through a fresh
   peer's pipelined committer on the card, untraced and then traced and
   profiled: equal flags and fingerprints (== phase 8 (a)'s), the named
   substages explaining the pipe's stage, await and commit buckets
   within 10% (floored at bench.py's 100 ms over 32 blocks, scaled to
   the blocks committed; bench.py:690's grouping), seconds a block
   by substage and the device idle share; (c) at the end, bench.py's
   broadcast storm at its width, cut to 1024 pre-signed envelopes (from
   4096, for the time limit) from 8 clients, 16-tx blocks, the drain
   pinned by a write_block sleep to ~1/4 of the calibrated submit
   rate, gated (queue cap 64 and the
   overload gate) against ungated, then unthrottled unstaged against
   staged 64, the Writers checks on the card: every admitted envelope
   committed exactly once, every shed typed, the gated queue within its
   cap, the gated arm shedding and the ungated not; p99 admission ms
   and sheds by reason; (d) phase 9's three Raft orderers order phase
   8's order-free stream, a config update adds orderer3, which joins
   from that block (replicating and verifying the chain on the card),
   orderer4 follows from genesis, the four consenters order phase 8's
   full stream: the follower's chain and orderer3's replicated blocks
   byte-equal to the source's, orderer3's own blocks equal but for its
   signature, a source with one flipped orderer-signature byte refused
   by a join and by a follower; blocks replicated a second.

16. the service surface (run after 15, at BASELINE.md #2's width: 1000-tx
   blocks, 3 orgs, the 2-of-3 default, signatures verified on the card)
   — (b) first: the KV contract packaged as ccaas (peer/ccpackage.py),
   served by a ChaincodeServer in a child process (which imports the
   port alone), resolved through a ChaincodeLauncher as the endorsers'
   mycc; phase 8 (a)'s transactions endorsed over TCP, ordered and
   committed on the card into 2 x 1000-tx blocks: flags and fingerprint
   equal to phase 8 (a)'s in-process arm; ms a remote invoke.  (a) on
   that network: 2,048 signed discovery queries (1,024 of the three
   orgs' members, 512 with a flipped signature bit, 512 from an org
   outside the channel) through DiscoveryService.check_access from 8
   threads, the Readers signatures verified by the card (a coalescing
   service over a GpuVerifier without memo-cache): every verdict the
   host SwVerifier oracle's, launches nonzero; a second pass from the
   auth cache with none; a config update (BatchTimeout -> 200 ms) bumps
   the sequence and the next pass launches again; the lifecycle deploys
   cc2 (AND(Org1, Org3)); the layouts of cc2 and of mycc (the
   implicit-meta MAJORITY default).  (c) two registrars consume one
   persisted Broker topic for a "kafka" channel; phase 8 (a)'s stream in
   order; the peer commits the first's chain on the card: equal data
   hashes on both, phase 8 (a)'s fingerprint; the broker and the second
   registrar restarted resume at the persisted offset and cut nothing.
   (d) while (c)'s peer commits (traced), an HTTPS OperationsServer with
   a required client certificate from the port's CA (a client without
   one refused) is scraped (/metrics, /healthz, all 200), beside an HTTP
   one: /metrics' commit-pipe and verifier series moved, /flight and
   /trace hold the blocks' timelines and spans, /logspec round-trips,
   /debug/threads answers, /healthz 200 -> 503 (a planted staging error
   in the channel's pipe) -> 200 (the channel discards it), the
   participation routes list the channels and a REST join answers what
   ChannelParticipation.join gives.

17. the soak under churn (run after 16, before 7 (d)'s profile; no
   profiler window) — (a) the reference's acceptance soak
   (tests/test_soak.py:137): seed 8, nine events covering all nine
   churn kinds, two channels, two peers at start, 3-5 txs between
   events, 60 s recovery windows; three Raft orderers (8-tx blocks,
   200 ms batch timeout), the background fault plan armed at p = 0.05
   (gossip drops, deliver stream deaths, Raft submit faults), mixed
   x509 and idemix traffic, every soak peer's blocks, MCS checks,
   gossip envelopes, config checks and event-stream ACL checks, and
   every orderer's Writers checks, verified by one shared GpuVerifier
   on the card (the idemix lane verifies on
   the host, as the reference's does): every event converges within its
   window, every admitted x509 tx is committed exactly once, tampered
   idemix presentations rejected, faults fired, three peers at the end,
   the audit subscriber cut FORBIDDEN at the revocation block, no
   registered worker thread leaked; the schedule, recovery seconds by
   kind, tx/s of both lanes, fault fires, submit errors and launches.
   (b) fault seams against the card: `bccsp.device.dispatch` armed once
   under a BatchingVerifyService over a GpuVerifier: every waiter of
   that batch gets InjectedFault and no verdict, the next batch's
   verdicts equal the plain version's (and the construction's); the
   same for `bccsp.device.resolve`; `commitpipe.commit` armed on the
   second pass while a Channel with a depth-2 pipe commits phase 8
   (a)'s blocks on the card: the pipe is rebuilt once and the
   fingerprint equals phase 8 (a)'s.  (c) the sharded soak: seed 8,
   three events, every peer's channels behind a ChannelShardRouter of
   GpuVerifier slices; `--phase 17` only (the whole script leaves it
   out for its time limit).

18. the offline tools and the lock discipline (after 17, before 7 (d))
   — (a) on the host, through `fabric_mod_tpu_torch.cli.main`: cryptogen
   from a crypto config in the reference's YAML (Org1-Org3 with one
   peer, one user and one admin each, and OrdererOrg), configtxgen with
   a solo profile at 1000 txs a block, configtxlator's proto_decode ->
   proto_encode of the genesis (the same bytes) and compute_update of a
   BatchSize 1000 -> 500 change, which the channel's config processing
   accepts signed by the orderer org's admin (sequence 1, 500); `import
   yaml` and `import grpc` probed and logged (the port imports neither).
   (b) the tree and genesis read back as network material (cli/
   cryptogen.network_material); a solo e2e Network on the card's
   GpuVerifier inside `concurrency.armed()`: two 1000-tx blocks endorsed
   by 2 of 3 orgs (one group of phase 8's planted kinds through the
   endorsers, then puts signed by the tree's peers, every 10th by Org1
   alone), ordered and committed; every flag the construction's, no
   RaceError, the lock-order registry observed ordering edges, no
   registered worker left after close, each verify-core kernel launched
   3 times a block (two validation calls and the MCS check).  (c)
   `ledger snapshot` of (b)'s peer and `join-from-snapshot`: equal
   height and fingerprint.  (d) `discover endorsers` over (a)'s genesis
   (no signature checked): the three 2-of-3 layouts.  (e)
   `idemixgen ca-keygen` and `signerconfig`, then 16 presentations under
   that key and one with Abar tampered verified in one batch on the
   card: 1 + 1 pairing launches, 16 true, the tampered one false.

19. the transport (after 18) — comm/ over mutual TLS on loopback
   (the port's own framing on `ssl` sockets), the orderer's and the
   peer's servers, Raft and gossip over the wire, deliver failover and
   node/chaincode.  (a) in this process, BASELINE.md #2's width: three
   Raft orderers (Registrar, RaftChain over GRPCRaftTransport,
   OrdererServer, host Writers checks), two peers (Org1, Org2) sharing
   one GpuVerifier, each pulling through a FailoverDeliverSource over
   the three orderers (the first leader first), serving an
   EndorserServer and an EventDeliverServer on one GRPCServer, and
   gossiping over GRPCGossipNetwork with GossipAuth (joined by signed
   alive messages).  Two 1000-tx blocks endorsed 2 of 3: block 1 holds
   50 txs endorsed through RemoteEndorser, the rest hand-signed, one
   with a flipped endorsement; then the leader's server and transport
   stop and its chain halts; block 2 (a flipped endorsement and an MVCC
   read conflict of a block-1 key) goes to the new leader; all through
   8 GrpcBroadcaster streams, and an EventDeliverClient over the wire
   waits for a block-2 txid (VALID).  Gates: both peers' flags equal
   the construction's by txid and each other's, equal fingerprints, the
   surviving orderers at one height, the peers' sources rotated, no
   registered worker left, each verify-core kernel launched >= 3 times
   a block.  (b) three `cli.main node --role orderer` processes and two
   `--role peer` processes (core.yaml `peer.BCCSP.Default: GPU`) from
   the tools' material (cryptogen, configtxgen at 1000 txs a block,
   500 ms batch timeout) and comm/tls TLS directories
   (utils/procnet.py): 24 puts through GrpcBroadcaster and 3 `chaincode
   invoke`s, the Raft leader SIGKILLed, 24 more puts and an `invoke
   --wait-event`; `chaincode query` gives the last value at both peers.
   Gates: both peers past the kill height and equal, each peer's
   `fabric_bccsp_verdict_cache_misses` above its warm-up's 2048 (items
   went to the card), each peer's `fabric_gpu_kernel_nvcc_builds_total`
   0 (the children load phase 2's build); every child SIGTERMed in a
   `finally` (SIGKILLed if it lingers), the logs printed when a gate
   fails.  Prints (a)'s committed tx/s, its election and failover
   seconds and launches, (b)'s peers' start-up (torch import, CUDA
   context, kernels and warm-up, shown apart) and the seconds from the
   kill to the next commit.

   python3 chip_smoke.py --phase 11
   python3 chip_smoke.py --phase 12
   python3 chip_smoke.py --phase 13
   python3 chip_smoke.py --phase 14
   python3 chip_smoke.py --phase 19

run phase 11 (its (b) on a stream endorsed there, without phase 10 (b)
beside it), phase 12, phase 13 (its (b) on blocks signed there) or
phase 14 alone after the header, and print no kernels line;
`--phase 15` runs (b), phase 8 (a), then (a), (c) and (d) ((d)
ordering arm (a)'s stream twice); `--phase 16` runs phase 8 (a), then
phase 16 on its stream; `--phase 17` runs phase 8 (a), then phase 17;
`--phase 18` runs phase 18 alone, `--phase 19` phase 19 alone, and
`--phase 7` phase 7 with its (d).

It prints one JSON line describing each of the seven kernels
(`launches` counts the block-commit phase, the four e2e arms, phase
7's check, pairings and batch_verify, phase 10's two parts, phase 11's
three, phase 12 (a)'s sweep, phase 13's three parts, phase 14, phase
15's four parts, phase 16's commits and discovery passes, and phase
17's soaks and fault seams, phase 18's network and presentations, and
phase 19 (a)'s two blocks),
and
as its last line
{"ok": true, "device": {...}}.  Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

LANES = 2048
N_BLOCKS = 4
# phases 8 and 9: the e2e arms' 1000-tx blocks (cut from 4 for the time
# limit; 2 keep Raft's consecutive entries and two blocks in the deliver
# client's double buffer)
E2E_BLOCKS = 2
TX_PER_BLOCK = 1000
SAMPLE = 256
SEED = 20261016
# block-commit phase: a planted invalid tx of each kind every 50 txs
PLANT_EVERY = 50
# the host oracles (phase 5 arm (d), phase 14) verify over this many
# spawned processes: the pure-python verify is ~1.4 ms a signature
ORACLE_WORKERS = 6

# idemix phase: a 1000-tx idemix block's pairing checks (padded to the
# next power of two), every 97th lane tampered; bench.py's presentation
# width with a planted presentation every 16
IDEMIX_LANES = 1024
IDEMIX_TAMPER_EVERY = 97
IDEMIX_SAMPLE = 8
IDEMIX_PAIRINGS = 4
IDEMIX_PRESENTATIONS = 64
IDEMIX_PLANT_EVERY = 16
IDEMIX_HOST_CHECKED = 16
# checks (and kernel launches) a device-time reading of phase 7 averages
IDEMIX_REPS = 5
# the ragged widths both pairing kernels are held at against their plain
# versions (a lone lane, one past a warp's 32, the 63 of batch_verify)
IDEMIX_RAGGED = (1, 33, 63)

# e2e phase: the solo orderer cuts on count, well inside this timeout;
# a 1000-tx block of these ~2.8 KB envelopes is ~2.8 MB, over the
# genesis default preferred_max_bytes (2 MiB), which would cut by size
E2E_BATCH_TIMEOUT = "10s"
E2E_PREFERRED_MAX_BYTES = 4 * 1024 * 1024
E2E_TIMEOUT_S = 600

# H100 SXM published peak (NVIDIA H100 datasheet): HBM bytes/s.
PEAK_BYTES = 3.35e12
# 32-bit integer multiply-adds per SM per clock (Hopper SM: 4 x 16 lanes).
INT_MADD_PER_SM_CLOCK = 64

# The function's word products per lane of each ladder (PERF.md has the
# count).  A field multiply is 64 32x32->64 word products, a square 36,
# each product two 32-bit multiply-adds (low and high halves).  RCB
# formulas: point_double 10 multiplies + 3 squares, point_add 14,
# point_add_mixed 13; Q table 7 doublings + 7 additions; key to
# Montgomery 2, output from Montgomery 3 multiplies.
MUL_PRODUCTS, SQR_PRODUCTS = 64, 36
PRODUCTS_DOUBLE = 10 * MUL_PRODUCTS + 3 * SQR_PRODUCTS
PRODUCTS_ADD = 14 * MUL_PRODUCTS
PRODUCTS_ADD_MIXED = 13 * MUL_PRODUCTS
PRODUCTS_TABLE = 7 * PRODUCTS_DOUBLE + 7 * PRODUCTS_ADD
PRODUCTS_CONVERT = 5 * MUL_PRODUCTS
# mixed only: the p-2 chain (255 squares + 13 multiplies) inside the
# simultaneous inversion (14 + 28 multiplies) and the 30 affine multiplies
PRODUCTS_NORMALISE = 255 * SQR_PRODUCTS + (13 + 14 + 28 + 30) * MUL_PRODUCTS
# One lane's critical path in rounds (a round is one multiply per thread
# of the lane's group; three rounds per formula, one each to convert in
# and out)
ROUNDS = 14 * 3 + 64 * 6 * 3 + 2
# mixed: + the prefix chain (14) and the p-2 chain (268) in sequence,
# 14 rounds of the backward pass, ceil(30 / threads per lane) rounds of
# the affine table
ROUNDS_NORMALISE_FIXED = 14 + 268 + 14

# The verify core's kernels (csrc/p256_core.cu), word products per lane.
# A product mod n (CIOS) is 64 a*b word products + 8 for the quotient
# digits + 64 for m*n, a square mod n the same with 36 for a*a; a
# product mod p 64, a square 36 (the reduction has no multiply).
# Prologue, the Fermat schedule (the inverse as a power to n - 2): s to
# Montgomery form, the power's table (14), its 252 squarings and one
# product per non-zero window of n - 2 after the first, u1 and u2.  The
# bound takes the smaller of it and this kernel's own count.  The divstep
# schedule (this kernel): per batch of 30 divsteps the matrix applied to
# (f, g), 4 products a limb, and to (d, e) mod n, 6 a limb, over 9 limbs
# (the divsteps' own few 32-bit multiplies uncounted); then s to
# Montgomery form, the inverse out of the plain domain, u1 and u2.  Both
# add the key check's 3 products and 2 squares mod p.  Epilogue: 3
# products mod p (X == r'*Z tested as r'*Z*R^-1 == X*R^-1).
FN_PRODUCTS = 64 + 8 + 64
FN_SQR_PRODUCTS = 36 + 8 + 64
BATCH_PRODUCTS = 9 * (4 + 6)
PROLOGUE_P_PRODUCTS = 3 * MUL_PRODUCTS + 2 * SQR_PRODUCTS
EPILOGUE_PRODUCTS = 3 * MUL_PRODUCTS
# bytes per lane, each input read once and each output written once:
# prologue e, r, s, qx, qy in, two 64-window int32 planes and key_ok
# out; epilogue X, Z, r and the flags word and key_ok in, the verdict out
PROLOGUE_BYTES = 5 * 32 + 2 * 64 * 4 + 1
EPILOGUE_BYTES = 3 * 32 + 4 + 1 + 1
# the prologue's widths on the main path: the MCS check of a block (1
# signature), an ingress cohort (~16), a validator bucket
PROLOGUE_WIDTHS = (1, 16, LANES)
# the edge lane that phase 3 gives s = n (a valid lane of make_core_lanes)
S_EQ_N_LANE = 13
# launches per device-time reading; the sleep in front of them (cycles,
# ~25 ms at 1980 MHz) outlasts their enqueue, so the events time the
# kernels back to back and not the host
DEVICE_REPS = 200
SLEEP_CYCLES = 50_000_000

# The SHA-256 kernel (csrc/sha256.cu): the 32-bit instructions one 64-byte
# block needs on this card, a rotate one funnel shift (SHF), any function of
# three words one LOP3, an add of three words one IADD3.  The message
# schedule, 48 words x (each small sigma 2 SHF + 1 shift + 1 LOP3; the
# 4-term sum 2 IADD3); 64 rounds x (each big sigma 3 SHF + 1 LOP3; ch and
# maj 1 LOP3 each; t1 = h + S1 + ch + K + w 2 IADD3; e = d + t1 1; a = t1 +
# S0 + maj 1 IADD3); the 8 adds into the state.  At the card's 32-bit
# integer rate (INT_MADD_PER_SM_CLOCK: Hopper's 64 int32 lanes per SM).
# Phase 3 prints the opcode counts of the built kernel's SASS beside it.
SHA_OPS_PER_BLOCK = 48 * (2 * 4 + 2) + 64 * (4 + 1 + 2 + 4 + 1 + 1 + 1) + 8
# (IMAD included: nvcc puts some adds on the multiply-add pipe as IMAD.IADD)
SHA_SASS_ALU = ("LOP3", "SHF", "IADD3", "IMAD", "IADD", "SHL", "SHR")
# The round's chain in the SASS: integer instructions on the ALU pipe and on
# the FMA pipe (IMAD), each a warp instruction in 2 dispatch cycles (16 lanes
# of each pipe a scheduler: INT_MADD_PER_SM_CLOCK / 4 schedulers), and the
# instructions that end a straight-line segment (the consumer's 64 unrolled
# rounds are the segment with the longest dependent chain)
SASS_ALU_PIPE = ("SHF", "LOP3", "IADD3", "IADD", "SHL", "SHR", "LEA", "PRMT",
                 "VIADD", "SEL")
SASS_FMA_PIPE = ("IMAD",)
SASS_SEGMENT_END = ("BRA", "BSSY", "BSYNC", "BAR", "EXIT", "RET", "WARPSYNC",
                    "CALL", "NANOSLEEP")
DISPATCH_CYCLES_PER_WARP_OP = 2
# scripts/sha256_latency_probe.cu, built beside the package's sources
# into build/probe/ (a directory .gitignore lists); iterations of 8 links
# a launch; its modes
PROBE_SOURCE = Path(__file__).resolve().parent / "scripts" / \
    "sha256_latency_probe.cu"
PROBE_ITERS = 4096
PROBE_MODES = {"alu": 0, "shuffle": 1, "round": 2}
# phase 3's other widths of the SHA kernel: an ingress cohort, an MCS check
SHA_WIDTHS = (16, 1)
# steps a block of the two-thread consumer: 64 rounds, the a-side two behind
SHA_PAIR_STEPS = 66
# phase 3's SHA lanes: the commit fixture's real creator and endorser
# messages, then these edge lengths (bytes); every SHA_NO_MSG_EVERY-th lane
# carries no message and must keep its e rows; hashlib checks a sample
SHA_EDGE_LENGTHS = (0, 1, 55, 56, 63, 64, 119, 120, 1000, 2000, 3000)
SHA_NO_MSG_EVERY = 97
SHA_HASHLIB_SAMPLE = 256
UPLOAD_REPS = 20

# phase 8 arm (b): concurrent submitters and the lanes' drain bound
E2E_SUBMITTERS = 32
E2E_STAGED_BATCH = 256

# phase 9: BASELINE.md #3's three orderers, with Fabric's documented
# etcdraft timing (sampleconfig/configtx.yaml EtcdRaft.Options:
# TickInterval 500 ms, ElectionTick 10, HeartbeatTick 1)
RAFT_ORDERERS = 3
RAFT_ELECTION_TIMEOUT = (5.0, 10.0)
RAFT_HEARTBEAT_S = 0.5

# phase 10: BASELINE.md #5's 50-peer gossip (bench.py:1278 measure_gossip,
# bench.py:2229's composed peers).  The storm's 96 puts are cut on count
# into three 32-tx blocks (the reference's 50 ms timeout would cut them
# at the pace of the host's Writers checks instead); every 10th storm
# peer's MCS calls are split by time.  The network's peers keep the
# reference's anti-entropy cadence (0.5 s): a push reaches ~sqrt(N) peers
# a hop, and the pull repairs the peers it missed.
GOSSIP_PEERS = 50
STORM_TXS = 96
STORM_BLOCK_TXS = 32
STORM_BATCH_TIMEOUT = "2s"
STORM_REPS = 3
STORM_SAMPLE_EVERY = 10
# (b) is cut to the stream's first 2 blocks (depth): its 4 blocks took
# 217 s of phase 10 on the card, the 50 peers' commits holding one GIL
GOSSIP_BLOCKS = 2
GOSSIP_TIMEOUT_S = 900.0
# (b)'s signed alive round comes from 4 of the 50 peers, every view
# seeded first (depth: the round from all 50 took 72.8 s of the script's
# 1,200 s limit on an H100; cut to 10 for phase 16, then to 4 for phase
# 19's room)
GOSSIP_ALIVE_SENDERS = 4

# phase 11 (a): bench.py:2383 `measure_dissemination`'s top point: 128
# peers, one-put blocks (a 50 ms batch timeout, 12-tx cap), the relay
# at the reference's defaults (degree 4, per-child queue 64) and
# bench.py:2229's long anti-entropy cadence (the relay's repair prod
# stays live)
RELAY_PEERS = 128
# cut from 6, then 4 (depth: ~10 s a block over the two arms' 256 peers)
# for the time limit; block 1 unprofiled, block 2 profiled
RELAY_BLOCKS = 2
RELAY_BATCH_TXS = 12
RELAY_BATCH_TIMEOUT = "50ms"
RELAY_DEGREE = 4
RELAY_QUEUE = 64
RELAY_ANTI_ENTROPY_S = 120.0
RELAY_TIMEOUT_S = 600.0
# phase 11 (c): bench.py:2027 `measure_deliverfanout`'s top point
FANOUT_SUBSCRIBERS = 10_000
FANOUT_WORKERS = 8
FANOUT_GROUPS = 4
FANOUT_PER_STREAM_SAMPLE = 128

# phase 12: bench.py:1677 `measure_multichannel` on the card, at
# BASELINE.md #2's 1000-tx blocks (bench.py used 4): 4 channels of 2
# blocks, bench.py:1857-1871's axes (each varied about the middle point,
# 7 points), riders of 8 items every 20 ms through the shared service
MC_CHANNELS = 4
MC_BLOCKS = 2
MC_BLOCK_TXS = 1000
MC_SLICES = (1, 2, 4)
MC_CHANNEL_AXIS = (1, 2, 4)
MC_RIDERS = (0, 4, 16)
MC_MIDDLE = tuple(axis[len(axis) // 2]
                  for axis in (MC_SLICES, MC_CHANNEL_AXIS, MC_RIDERS))
MC_RIDER_ITEMS = 8
MC_RIDER_EVERY_S = 0.02
MC_RIDER_TIMEOUT_S = 30.0
MC_PROFILED = (4, 4, 4)
MC_TAMPER_EVERY = 10
# phase 12 (c): lanes of the mesh differential (two or more cards only)
MESH_LANES = 2048

# 13. the durable ledger and private data: (a) bench.py:745's state-scale
# stream at bench.py:3365's sizes (its 32-tx blocks raised to 1000), (b)
# the crash seam on BASELINE.md #2's blocks, (c) a collection of Org1 and
# Org2 with block-to-live 2 across three peers
SCALE_SIZES = (10_000, 100_000, 1_000_000)
SCALE_BLOCKS = 6          # cut from 8; phase 14 (f) commits all 6
SCALE_BLOCK_TXS = 1000
CRASH_BLOCKS = 4
HISTORY_SAMPLE = 64
PVT_BLOCKS = 4
PVT_EVERY = 10
PVT_BTL = 2
PVT_PAD_BLOCKS = 3
PVT_FORGED = 5
PVT_ROUNDS = 20
CORE_KERNELS = ("ladder_projective", "verify_prologue", "verify_epilogue")
# the ECDSA verify path's kernels (the idemix pairing's are apart)
VERIFY_KERNELS = ("ladder_projective", "ladder_mixed", "verify_prologue",
                  "verify_epilogue", "sha256_e")
# phase 14: the lifecycle slice on a solo network with 1000-tx blocks
LC_SEED = 1415
LC_BATCH_TIMEOUT = "2s"
# (b)'s blocks: cut from 4 (depth) for phase 19's room
LC_BLOCKS = 2
LC_UNDER_EVERY = 10
LC_UPGRADE_INVOKES = 10
LC_NEW_BATCH = 500
LC_DOCS = 1000
LC_QUERIES = 100
LC_QUERY_LIMIT = 3
LC_SNAPSHOT_KEYS = 100_000
LC_SOURCE_BLOCKS = 4
# where (b)'s tensor-policy passes must find the verify mask
LC_MASK_DEVICE = "cuda"


# phase 15: the traced commit (bench.py:597-690's traced arm and
# grouping), the storm at bench.py:2568's width, participation
OBS_DEPTH = 2
ATTRIBUTION = {"stage": ("unpack", "device_dispatch", "policy_gather"),
               "await": ("verdict_await",),
               "commit": ("policy_device", "policy_finish", "mvcc",
                          "ledger_write")}
ATTRIBUTION_TOL = 0.10
# the floor for timer noise: 100 ms over bench.py's least commitpipe
# stream (32 blocks, bench.py:2990), scaled to the blocks committed here
ATTRIBUTION_FLOOR_S = 0.1
ATTRIBUTION_FLOOR_BLOCKS = 32
STORM_CHANNEL = "storm"
# cut from bench.py's 4096 (depth: the ungated arm drains every envelope
# at a quarter of the submit rate, ~67 s at 4096, ~36-48 s at 2048) for
# the time limit; the gated arm still meets its cap of 64 at once
STORM_TXS_15 = 1024
STORM_CLIENTS = 8
STORM_MAX_MESSAGES = 16
STORM_BATCH_TIMEOUT_15 = "100ms"
STORM_STAGED = 64
STORM_OVERLOAD = 4.0


def log(msg: str) -> None:
    print(msg, flush=True)


def ladder_inputs(torch, np, device):
    """Random windows, distinct keys (i+2)G, edge and invalid lanes."""
    from fabric_mod_tpu_torch.ops import limbs9, p256
    rng = np.random.default_rng(SEED)
    u1 = rng.integers(0, 16, (p256.N_WINDOWS, LANES)).astype(np.int32)
    u2 = rng.integers(0, 16, (p256.N_WINDOWS, LANES)).astype(np.int32)
    u1[:, 0] = 0
    u2[:, 0] = 0                        # lane 0: stays at infinity
    u2[:, 1] = 0                        # lane 1: G adds only
    u1[:, 2] = 0                        # lane 2: Q adds only
    u1[1:, 3] = 0                       # lane 3: one MSB window
    u2[:p256.N_WINDOWS - 1, 4] = 0      # lane 4: one LSB window
    g = (p256.GX, p256.GY)
    pts, acc = [], p256._affine_add(g, g)
    for _ in range(LANES):
        pts.append(acc)
        acc = p256._affine_add(acc, g)
    xs = [x for x, _ in pts]
    ys = [y for _, y in pts]
    ys[5] ^= 1                          # lane 5: off-curve key
    xs[6], ys[6] = 0, 0                 # lane 6: key (0, 0)
    R = 1 << limbs9.RBITS
    qx = limbs9.to_device(np.stack([limbs9.int_to_limbs(x * R % p256.P)
                                    for x in xs]), device)
    qy = limbs9.to_device(np.stack([limbs9.int_to_limbs(y * R % p256.P)
                                    for y in ys]), device)
    return (torch.as_tensor(u1, device=device),
            torch.as_tensor(u2, device=device), qx, qy, {5, 6})


def affine_of(torch, xyz_canon):
    """Canonical (K, n) Montgomery-270 limbs X, Y, Z -> per-lane affine
    python ints (None at infinity)."""
    from fabric_mod_tpu_torch.ops import limbs9, p256
    rinv = pow(1 << limbs9.RBITS, -1, p256.P)
    cols = [c.cpu().numpy() for c in xyz_canon]
    out = []
    for lane in range(cols[0].shape[1]):
        X, Y, Z = (limbs9.limbs_to_int(c[:, lane]) * rinv % p256.P
                   for c in cols)
        if Z == 0:
            out.append(None)
            continue
        zi = pow(Z, -1, p256.P)
        out.append((X * zi % p256.P, Y * zi % p256.P))
    return out


def time_cuda(torch, fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ladder_products_per_lane(mixed: bool, u1, u2) -> float:
    """Word products per lane that this run's windows need (mean)."""
    from fabric_mod_tpu_torch.ops import p256
    base = (PRODUCTS_TABLE + PRODUCTS_CONVERT
            + p256.N_WINDOWS * p256.WINDOW * PRODUCTS_DOUBLE)
    if not mixed:
        return base + 2 * p256.N_WINDOWS * PRODUCTS_ADD
    nonzero = int((u1 != 0).sum().item() + (u2 != 0).sum().item())
    return (base + PRODUCTS_NORMALISE
            + nonzero * PRODUCTS_ADD_MIXED / u1.shape[1])


def chain_rounds(mixed: bool, per_lane: int) -> int:
    """One lane's critical path in rounds of multiplies (this design)."""
    if not mixed:
        return ROUNDS
    return ROUNDS + ROUNDS_NORMALISE_FIXED + -(-30 // per_lane)


def sm_clock_hz() -> float:
    """The SM clock nvidia-smi reports as the card's maximum."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def sass_listing(path, kernel: str):
    """[(opcode, operands)] of the first function in the built library at
    `path` whose name contains `kernel` (cuobjdump of the toolkit that
    built it; a label is ("<label>:", "")), or None where it cannot be
    read."""
    from fabric_mod_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    try:
        out = subprocess.run([tool, "-sass", str(path)], check=True,
                             capture_output=True, text=True,
                             timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    listing, state = [], "before"
    for line in out.splitlines():
        text = line.strip()
        if text.startswith("Function :"):
            if state == "inside":
                break
            state = "inside" if kernel in text else state
            continue
        if state != "inside":
            continue
        if re.match(r"\.L_\w+:", text):
            listing.append((text, ""))
            continue
        m = re.match(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)\s*([^;]*);", text)
        if m:
            listing.append((m.group(1), m.group(2)))
    return listing or None


def sass_opcodes(path, kernel: str):
    """{opcode: count} over `kernel`'s SASS (sass_listing), or None."""
    listing = sass_listing(path, kernel)
    if listing is None:
        return None
    counts = {}
    for op, _args in listing:
        if not op.endswith(":"):
            base = op.split(".")[0]
            counts[base] = counts.get(base, 0) + 1
    return counts


def sass_chain(listing):
    """The straight-line segment of a SASS listing with the longest chain
    of dependent integer instructions (ALU or FMA pipe; a load's or a
    shuffle's result starts a chain at 0): (that chain's length in
    instructions, {opcode: count} of the segment's instructions)."""
    best = (0, {})
    depth, counts, longest = {}, {}, 0
    for op, args in listing + [("EXIT", "")]:
        base = op.split(".")[0]
        if op.endswith(":") or base in SASS_SEGMENT_END:
            if longest > best[0]:
                best = (longest, counts)
            depth, counts, longest = {}, {}, 0
            continue
        counts[base] = counts.get(base, 0) + 1
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", args)]
        if not regs:
            continue
        if (base in SASS_ALU_PIPE or base in SASS_FMA_PIPE) and re.match(
                r"R\d+\b", args):
            d = 1 + max((depth.get(r, 0) for r in regs[1:]), default=0)
            longest = max(longest, d)
            width = 2 if ".WIDE" in op else 1
        else:
            # a load or shuffle: its result starts a chain
            d = 0
            width = 4 if ".128" in op else (2 if ".64" in op else 1)
        for k in range(width):
            depth[regs[0] + k] = d
    return best


def prologue_products() -> int:
    """Word products per lane of a prologue that inverts by Fermat."""
    from fabric_mod_tpu_torch.ops import p256
    e = p256.N - 2
    nonzero = sum(1 for w in range(1, 64) if (e >> (4 * (63 - w))) & 15)
    n_mul = 1 + 14 + nonzero + 2
    return (n_mul * FN_PRODUCTS + 63 * 4 * FN_SQR_PRODUCTS
            + PROLOGUE_P_PRODUCTS)


def divstep_products(s_values) -> float:
    """Word products per lane of this prologue (the divstep schedule) on
    these scalars, the mean over the lanes: each lane's batches are what
    its own s needs."""
    from fabric_mod_tpu_torch.ops import p256_core
    batches = [p256_core.inversion_batches(s) for s in s_values]
    return (BATCH_PRODUCTS * sum(batches) / len(batches)
            + 4 * FN_PRODUCTS + PROLOGUE_P_PRODUCTS)


def device_ms(torch, launch, reps: int = DEVICE_REPS) -> float:
    """Mean device milliseconds per launch of `launch()`: the launches
    queue behind a sleep kernel, so the events around them time their
    run on the card, not their enqueue."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn, reps: int) -> float:
    """Mean host wall milliseconds per call of fn() (its enqueue: the
    card is synchronised before and after, outside the reading)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def kernel_counts() -> dict:
    """Launch counts of every kernel of the paths (ladders, core, the
    raw lanes' SHA-256 and the idemix pairing check)."""
    from fabric_mod_tpu_torch.ops import (fp256bn_cuda, p256_core,
                                          p256_cuda, sha256)
    return {**p256_cuda.counts(), **p256_core.counts(), **sha256.counts(),
            **fp256bn_cuda.counts()}


def reset_kernel_counts() -> None:
    from fabric_mod_tpu_torch.ops import (fp256bn_cuda, p256_core,
                                          p256_cuda, sha256)
    p256_cuda.reset_counts()
    p256_core.reset_counts()
    sha256.reset_counts()
    fp256bn_cuda.reset_counts()


def require_launched(counts: dict, where: str) -> None:
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} was not launched on {where}")


def require_equal_prologue(torch, got, want, where: str) -> int:
    """Raise unless the prologue's (u1_w, u2_w, key_ok) equal the plain
    ones bit for bit; the max absolute difference (0)."""
    err = 0
    for g, w, what in zip(got, want, ("u1 windows", "u2 windows", "key_ok")):
        if not torch.equal(g, w):
            diff = g != w
            bad = (diff.any(0) if diff.dim() == 2 else diff).nonzero()
            raise AssertionError(f"verify_prologue ({where}): {what} differ "
                                 f"from the plain prologue at lanes "
                                 f"{bad.flatten()[:8].tolist()}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def phase_core_kernels(torch, np, dev, clock, n_sm):
    """Phase 3 for the verify core: the prologue kernel at 1, 16 and 2048
    lanes and the epilogue kernel at 2048 lanes against their plain
    versions on the card; device time apart from the wrapper's."""
    from fabric_mod_tpu_torch.ops import _build, p256, p256_core, p256_cuda
    from fabric_mod_tpu_torch.utils import fixtures
    t0 = time.perf_counter()
    planes, pre_ok, expect = fixtures.make_core_lanes(LANES, seed=b"smoke")
    planes[2][S_EQ_N_LANE] = np.frombuffer(p256.N.to_bytes(32, "big"), np.uint8)
    expect[S_EQ_N_LANE] = False
    _, range_ok, rn_lt_p = p256.range_checks(*planes)
    buf = torch.from_numpy(p256_core.pack(planes, range_ok, pre_ok,
                                          rn_lt_p)).to(dev)
    e = p256_core.rows(buf, p256_core.ROW_E)
    s_values = [int.from_bytes(bytes(b), "big") for b in planes[2]]
    log(f"core lanes: {LANES} signed in {time.perf_counter() - t0:.1f} s "
        f"({fixtures.CORE_EDGE_LANES} edge lanes and lane {S_EQ_N_LANE} "
        f"with s = n: e >= n, padding, invalid keys, out-of-range scalars, "
        f"a host-masked lane)")
    lib = _build.load("p256_core")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rate = INT_MADD_PER_SM_CLOCK * n_sm * clock
    fermat = prologue_products()

    def bound(products, nbytes, width):
        ops = 2 * products * width / rate * 1e3
        byt = nbytes * width / PEAK_BYTES * 1e3
        return max(ops, byt), "operations" if ops >= byt else "bytes", byt

    got = p256_core.prologue(e, buf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = p256_core.prologue_plain(e, buf)
    torch.cuda.synchronize()
    pro_plain_ms = (time.perf_counter() - t0) * 1e3
    pro_err = require_equal_prologue(torch, got, want, f"{LANES} lanes")
    # every edge lane alone: the plain prologue is lane by lane, so its
    # 2048-lane planes' column is the 1-lane answer
    for i in range(S_EQ_N_LANE + 1):
        one = buf[:, i:i + 1].contiguous()
        got1 = p256_core.prologue(p256_core.rows(one, p256_core.ROW_E), one)
        pro_err = max(pro_err, require_equal_prologue(
            torch, got1, [w[..., i:i + 1] for w in want], f"lane {i} alone"))
    pro_rows = {}
    for width in PROLOGUE_WIDTHS:
        sub = buf[:, :width].contiguous()
        e_w = p256_core.rows(sub, p256_core.ROW_E)
        got_w = p256_core.prologue(e_w, sub)
        pro_err = max(pro_err, require_equal_prologue(
            torch, got_w, [w[..., :width] for w in want], f"{width} lanes"))
        u1_w, u2_w, key_w = got_w
        args = (e_w.data_ptr(), sub.data_ptr(), u1_w.data_ptr(),
                u2_w.data_ptr(), key_w.data_ptr(), width, stream)
        if lib.p256_core_prologue_launch(*args) != 0:
            raise AssertionError("verify_prologue: direct launch failed")
        dev_ms = device_ms(torch, lambda: lib.p256_core_prologue_launch(*args))
        ev_ms = time_cuda(torch, lambda: p256_core.prologue(e_w, sub), reps=10)
        wrap_ms = host_ms(torch, lambda: p256_core.prologue(e_w, sub), reps=100)
        divstep = divstep_products(s_values[:width])
        b_ms, b_by, b_bytes = bound(min(fermat, divstep), PROLOGUE_BYTES, width)
        pro_rows[width] = (dev_ms, b_ms, b_by)
        log(f"kernel verify_prologue at width {width}: window planes and "
            f"key_ok bit-equal to plain; device {dev_ms:.4f} ms per call "
            f"(CUDA events over {DEVICE_REPS} direct launches queued behind "
            f"a sleep), {ev_ms:.4f} ms per wrapper call (CUDA events, 10 "
            f"wrapper calls), wrapper host wall {wrap_ms:.4f} ms "
            f"per call; bound {b_ms:.5f} ms by {b_by} (word products per "
            f"lane: divstep schedule {divstep:.1f}, Fermat schedule "
            f"{fermat}; bytes {b_bytes:.6f} ms)")
    log(f"kernel verify_prologue: every edge lane alone bit-equal to plain; "
        f"2 threads per lane, one warp per rank, lanes per block "
        f"= width / {n_sm} SMs within [1, 32]; plain "
        f"{pro_plain_ms:.1f} ms per {LANES}-lane call")

    u1, u2, key_ok = got
    X, _Y, Z = p256_cuda.ladder_words(
        u1, u2, p256_core.rows(buf, p256_core.ROW_QX),
        p256_core.rows(buf, p256_core.ROW_QY))
    ok = p256_core.epilogue(X, Z, buf, key_ok)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok_plain = p256_core.epilogue_plain(X, Z, buf, key_ok)
    torch.cuda.synchronize()
    epi_plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(ok, ok_plain):
        bad = (ok != ok_plain).nonzero().flatten()[:8].tolist()
        raise AssertionError(f"verify_epilogue differs from the plain "
                             f"epilogue at lanes {bad}")
    if ok.cpu().numpy().tolist() != expect.tolist():
        bad = np.nonzero(ok.cpu().numpy() != expect)[0][:8].tolist()
        raise AssertionError(f"core verdicts differ from the construction "
                             f"at lanes {bad}")
    epi_err = int((ok.to(torch.int64) - ok_plain.to(torch.int64)).abs().max())
    args = (X.data_ptr(), Z.data_ptr(), buf.data_ptr(), key_ok.data_ptr(),
            ok.data_ptr(), LANES, stream)
    if lib.p256_core_epilogue_launch(*args) != 0:
        raise AssertionError("verify_epilogue: direct launch failed")
    epi_ms = device_ms(torch, lambda: lib.p256_core_epilogue_launch(*args))
    epi_ev_ms = time_cuda(torch, lambda: p256_core.epilogue(X, Z, buf, key_ok),
                          reps=10)
    epi_wrap_ms = host_ms(torch, lambda: p256_core.epilogue(X, Z, buf, key_ok),
                          reps=100)
    e_ms, e_by, e_bytes = bound(EPILOGUE_PRODUCTS, EPILOGUE_BYTES, LANES)
    log(f"kernel verify_epilogue: verdicts equal to plain on {LANES} lanes "
        f"(and the construction's); device {epi_ms:.4f} ms per call (CUDA "
        f"events over {DEVICE_REPS} direct launches queued behind a sleep)")
    log(f"kernel verify_epilogue: wrapper {epi_ev_ms:.4f} ms per call (CUDA "
        f"events, 10 calls); wrapper host wall "
        f"{epi_wrap_ms:.4f} ms per call (100 calls); plain "
        f"{epi_plain_ms:.1f} ms/call; bound {e_ms:.5f} ms by {e_by} "
        f"({EPILOGUE_PRODUCTS} word products per lane; bytes "
        f"{e_bytes:.6f} ms)")
    out = {}
    for name, ms, plain_ms, err, b_ms, b_by in (
            ("verify_prologue", pro_rows[LANES][0], pro_plain_ms, pro_err,
             pro_rows[LANES][1], pro_rows[LANES][2]),
            ("verify_epilogue", epi_ms, epi_plain_ms, epi_err, e_ms, e_by)):
        out[name] = {
            "name": name, "route": "cuda",
            "source": "fabric_mod_tpu_torch/csrc/p256_core.cu",
            "replaces": "fabric_mod_tpu/ops/p256.py:516",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        }
    log("verify core: library_ms null (no PyTorch call computes these); "
        "ms in the JSON line is the device time at 2048 lanes")
    return out


def commit_messages(blocks, limit: int) -> list:
    """The raw verify messages of encoded commit blocks, in block order,
    as the MSP's raw-message items carry them: each tx's creator message
    (its envelope's payload) and each endorsement's (the proposal-
    response payload and the endorser's identity); at most `limit`."""
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    out = []
    for raw in blocks:
        for data in m.Block.decode(raw).data.data:
            env = m.Envelope.decode(data)
            out.append(env.payload)
            tx = protoutil.extract_endorser_tx(
                protoutil.unmarshal_envelope_payload(env))
            for action in tx.actions:
                _cca, prp, ends = protoutil.tx_rwset_and_endorsements(action)
                out.extend(prp + e.endorser for e in ends)
            if len(out) >= limit:
                return out[:limit]
    return out


def sha_geometry(lib) -> str:
    """The SHA-256 kernel's launch geometry, described."""
    import ctypes
    vals = [ctypes.c_int() for _ in range(4)]
    lib.sha256_e_geometry(*(ctypes.byref(v) for v in vals))
    lanes, producers, depth, ring_bytes = (v.value for v in vals)
    return (f"{lanes} lanes a thread block, 1 consumer warp (two threads a "
            f"lane: e-side and a-side, a shuffle a round) and {producers} "
            f"producer warp, a ring of {depth} slots = {ring_bytes} bytes of "
            f"dynamic shared memory a block")


def start_probe_build():
    """nvcc of PROBE_SOURCE into build/probe/, started (Popen) to run
    beside the package's builds; finish_probe_build waits for it."""
    from fabric_mod_tpu_torch.ops import _build
    out = _build.BUILD_DIR.parent / "probe" / "sha256_latency_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-o", str(out), str(PROBE_SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def finish_probe_build(started):
    """The built probe as a ctypes library; raises if nvcc failed."""
    import ctypes
    proc, out = started
    log_text, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc of {PROBE_SOURCE} exited {proc.returncode}"
                           f"\n{log_text}")
    fn = ctypes.CDLL(str(out)).sha256_latency_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    return fn


def latency_probe(torch, dev, probe_fn) -> dict:
    """Cycles a link of a dependent chain takes on this card, by the
    probe's clock64 over a chain on one warp (its second launch; the
    first warms the instruction cache): {"alu": one of SHF -> LOP3 ->
    IADD3 (a third of it is a dependent instruction), "shuffle": a
    butterfly shuffle and an add, "round": the round's chain, three SHF
    into a LOP3 into an IADD3}."""
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cycles = {}
    for name, mode in PROBE_MODES.items():
        for _ in range(2):
            if probe_fn(out.data_ptr(), PROBE_ITERS, mode, stream) != 0:
                raise AssertionError("sha256_latency_probe: launch failed")
            torch.cuda.synchronize()
        cycles[name] = out[0].item() / out[1].item()
    return cycles


def phase_sha_kernel(torch, np, dev, clock, n_sm, messages, probe):
    """Phase 3 for the raw lanes' SHA-256.  Correctness: the kernel
    against its plain version on the card at 2048 lanes of real
    commit-path messages and the edge lengths, every SHA_NO_MSG_EVERY-th
    lane without a message, in the packed buffer's e rows; hashlib on
    sampled lanes.  Then, at the main path's inputs (2048 real messages,
    every lane raw): the kernel against plain again, device time, the
    plain version's time, the bound, the widths 16 and 1, the chain and
    dispatch floors (probe: latency_probe's readings), the
    words plane's host packing, bytes and upload."""
    import hashlib

    from fabric_mod_tpu_torch import device as _device
    from fabric_mod_tpu_torch.bccsp import der
    from fabric_mod_tpu_torch.ops import _build, p256_core, sha256
    rng = np.random.default_rng(SEED + 3)

    def lanes(msgs, has_msg):
        """The plane (as bccsp/gpu.marshal_items packs it: as many blocks
        as the longest message needs), its upload, and a packed buffer
        of random words with FLAG_HAS_MSG where has_msg."""
        words, nblocks, ok = der.pack_messages(msgs, LANES)
        if not ok.all():
            raise AssertionError("pack_messages rejected a message")
        nblocks = np.where(has_msg, nblocks, 0).astype(np.int32)
        base = rng.integers(-2**31, 2**31, (p256_core.ROWS, LANES)).astype(
            np.int32)
        base[p256_core.ROW_FLAGS] = (
            np.where(has_msg, p256_core.FLAG_HAS_MSG, 0)
            | p256_core.FLAG_RANGE_OK)
        return (words, nblocks, _device.upload(words.view(np.int32), dev),
                _device.upload(nblocks, dev), torch.from_numpy(base).to(dev))

    def against_plain(w, nb, buf0, what):
        got = buf0.clone()
        sha256.sha256_e(w, nb, got)
        torch.cuda.synchronize()
        want = buf0.clone()
        t0 = time.perf_counter()
        sha256.sha256_e_plain(w, nb, want)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(got, want):
            bad = (got != want).any(0).nonzero().flatten()[:8].tolist()
            raise AssertionError(f"sha256_e ({what}) differs from the plain "
                                 f"SHA-256 at lanes {bad}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        return got, plain_ms, err

    # correctness on real messages, edge lengths and lanes without one
    msgs = list(messages[:LANES - len(SHA_EDGE_LENGTHS)])
    msgs += [rng.bytes(n) for n in SHA_EDGE_LENGTHS]
    if len(msgs) != LANES:
        raise AssertionError(f"{len(msgs)} SHA lanes, expected {LANES}")
    has_msg = np.ones(LANES, bool)
    has_msg[::SHA_NO_MSG_EVERY] = False
    words, nblocks, w, nb, buf0 = lanes(msgs, has_msg)
    got, _plain_ms, err = against_plain(w, nb, buf0, "edge lanes")
    keep = torch.from_numpy(~has_msg).to(dev)
    if not torch.equal(got[:, keep], buf0[:, keep]) or not torch.equal(
            got[p256_core.ROW_E + 8:], buf0[p256_core.ROW_E + 8:]):
        raise AssertionError("sha256_e wrote outside the raw lanes' e rows")
    e_words = got[p256_core.ROW_E:p256_core.ROW_E + 8].cpu().numpy().view(
        np.uint32)
    raw_lanes = np.nonzero(has_msg)[0]
    edge = list(range(LANES - len(SHA_EDGE_LENGTHS), LANES))
    sample = sorted(set(rng.choice(raw_lanes, min(SHA_HASHLIB_SAMPLE,
                                                  raw_lanes.size),
                                   replace=False).tolist())
                    | {i for i in edge if has_msg[i]})
    for lane in sample:
        value = sum(int(x) << (32 * k) for k, x in enumerate(e_words[:, lane]))
        if value.to_bytes(32, "big") != hashlib.sha256(msgs[lane]).digest():
            raise AssertionError(f"sha256_e lane {lane} differs from hashlib")
    log(f"kernel sha256_e: {LANES} lanes ({len(msgs) - len(SHA_EDGE_LENGTHS)}"
        f" real creator and endorser messages of the commit fixture, "
        f"{len(SHA_EDGE_LENGTHS)} edge lengths {list(SHA_EDGE_LENGTHS)}, "
        f"{int((~has_msg).sum())} lanes without a message): e rows bit-equal "
        f"to the plain sha256_blocks on every lane, lanes without a message "
        f"and the other rows untouched, == hashlib on {len(sample)} sampled "
        f"lanes; blocks per raw lane mean {nblocks[has_msg].mean():.2f}, max "
        f"{int(nblocks.max())}")

    # the main path's inputs: a 2048-lane bucket of real messages
    real = list(messages[:LANES])
    all_raw = np.ones(LANES, bool)
    words, nblocks, w, nb, buf0 = lanes(real, all_raw)
    got, plain_ms, err_main = against_plain(w, nb, buf0, "main path")
    err = max(err, err_main)
    # the plane as the reference packs it, rounded up to a power of two
    # blocks (zero blocks past the longest message's), for its upload
    rounded = np.zeros((LANES, 1 << (words.shape[1] - 1).bit_length(), 16),
                       np.uint32)
    rounded[:, :words.shape[1]] = words

    def upload_ms(plane):
        arr = plane.view(np.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(UPLOAD_REPS):
            _device.upload(arr, dev)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / UPLOAD_REPS
    # the first pass fills the pinned-memory cache (the main path runs
    # with it warm); the second is the reading
    for _ in range(2):
        up_ms, rounded_ms = upload_ms(words), upload_ms(rounded)
    t0 = time.perf_counter()
    der.pack_messages(real, LANES)
    pack_ms = (time.perf_counter() - t0) * 1e3

    lib = _build.load("sha256")
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = buf0.clone()
    args = (w.data_ptr(), nb.data_ptr(), words.shape[1], scratch.data_ptr(),
            LANES, stream)
    if lib.sha256_e_launch(*args) != 0:
        raise AssertionError("sha256_e: direct launch failed")
    dev_ms = device_ms(torch, lambda: lib.sha256_e_launch(*args))
    ev_ms = time_cuda(torch, lambda: sha256.sha256_e(w, nb, scratch), reps=10)
    wrap_ms = host_ms(torch, lambda: sha256.sha256_e(w, nb, scratch),
                      reps=100)
    real_blocks = int(nblocks.sum())
    ops = real_blocks * SHA_OPS_PER_BLOCK
    bound_ops = ops / (INT_MADD_PER_SM_CLOCK * n_sm * clock) * 1e3
    nbytes = real_blocks * 64 + LANES * 8 + LANES * 32
    bound_bytes = nbytes / PEAK_BYTES * 1e3
    b_ms = max(bound_ops, bound_bytes)
    b_by = "operations" if bound_ops >= bound_bytes else "bytes"
    log(f"kernel sha256_e at the main path's inputs ({LANES} real messages, "
        f"blocks per lane mean {nblocks.mean():.2f}, max {int(nblocks.max())};"
        f" {sha_geometry(lib)}): bit-equal "
        f"to plain; device {dev_ms:.4f} ms per call (CUDA events over "
        f"{DEVICE_REPS} direct launches queued behind a sleep), {ev_ms:.4f} ms "
        f"per wrapper call (CUDA events, 10 calls), wrapper host wall "
        f"{wrap_ms:.4f} ms per call; plain {plain_ms:.1f} ms per call; bound "
        f"{b_ms:.5f} ms by {b_by} ({real_blocks} real blocks x "
        f"{SHA_OPS_PER_BLOCK} 32-bit operations at {INT_MADD_PER_SM_CLOCK}/SM/"
        f"clock x {n_sm} SMs x {clock / 1e6:.0f} MHz = {bound_ops:.5f} ms; "
        f"{nbytes} bytes = {bound_bytes:.6f} ms); library_ms null (no "
        f"PyTorch call computes SHA-256)")

    # the chain: what the SASS and the card (phase 2's probe) say a round
    # can take; without the SASS the chain and dispatch floors are not
    # measured
    kernel = "sha256_e_kernel"
    listing = sass_listing(_build.library_path("sha256"), kernel)
    chain, seg = sass_chain(listing) if listing else (0, {})
    steps = SHA_PAIR_STEPS
    dep_step = chain / steps
    alu = sum(seg.get(op, 0) for op in SASS_ALU_PIPE) / steps
    fma = sum(seg.get(op, 0) for op in SASS_FMA_PIPE) / steps
    dispatch_step = DISPATCH_CYCLES_PER_WARP_OP * max(alu, fma)
    per_dep = probe["alu"] / 3
    for width in (LANES,) + SHA_WIDTHS:
        if width == LANES:
            ms_w, max_nb = dev_ms, int(nblocks.max())
        else:
            buf_w = buf0[:, :width].contiguous()
            against_plain(w[:width], nb[:width], buf_w, f"{width} lanes")
            a_w = (w.data_ptr(), nb.data_ptr(), words.shape[1],
                   buf_w.data_ptr(), width, stream)
            ms_w = device_ms(torch, lambda a=a_w: lib.sha256_e_launch(*a))
            max_nb = int(nblocks[:width].max())
        cycles = max_nb * steps / clock * 1e3
        if chain:
            floors = (f"chain floor {cycles * dep_step * per_dep:.4f} ms "
                      f"({max_nb} blocks x {steps} steps x {dep_step:.2f} "
                      f"dependent instructions a step x {per_dep:.2f} cycles "
                      f"each / {clock / 1e6:.0f} MHz); dispatch floor "
                      f"{cycles * dispatch_step:.4f} ms")
        else:
            floors = ("chain floor not measured, dispatch floor not "
                      "measured (cuobjdump gave no SASS)")
        log(f"sha256_e at {width} lanes (longest lane {max_nb} blocks): "
            f"device {ms_w:.4f} ms per call (bit-equal to plain); "
            f"{ms_w * 1e-3 * clock / (max_nb * 64):.1f} cycles a round of "
            f"the longest lane; {floors}; {cycles * probe['round']:.4f} ms "
            f"at the round's chain measured whole ({probe['round']:.2f} "
            f"cycles a link)")
    if chain:
        log(f"sha256_e round (SASS, cuobjdump): the longest dependent chain "
            f"{chain} instructions over a block's {steps} unrolled steps, "
            f"{dep_step:.2f} a step; a step dispatches {alu:.2f} ALU-pipe and "
            f"{fma:.2f} FMA-pipe instructions (the segment: "
            f"{dict(sorted(seg.items()))}), so one warp dispatches a step in "
            f"no fewer than {dispatch_step:.1f} cycles "
            f"({DISPATCH_CYCLES_PER_WARP_OP} cycles a warp instruction on a "
            f"pipe of 16 lanes)")
    ops_seen = sass_opcodes(_build.library_path("sha256"), kernel)
    if ops_seen is None:
        log("sha256_e SASS: not read (cuobjdump gave nothing)")
    else:
        counted = {op: ops_seen.get(op, 0) for op in SHA_SASS_ALU}
        log(f"sha256_e SASS (cuobjdump; the consumer's 64 unrolled rounds, "
            f"the producer's unrolled schedule and the set-up around them): "
            f"32-bit ALU {sum(counted.values())} ({counted}), "
            f"all instructions {sum(ops_seen.values())} "
            f"({dict(sorted(ops_seen.items(), key=lambda kv: -kv[1]))}); "
            f"the bound counts {SHA_OPS_PER_BLOCK} a block")
    log(f"sha256 words plane: packed on the host in {pack_ms:.2f} ms "
        f"(der.pack_messages, its second call); {words.nbytes} bytes as the main path packs it "
        f"({words.shape[1]} blocks, the longest message's), uploaded pinned "
        f"in {up_ms:.3f} ms; {rounded.nbytes} bytes with the reference's "
        f"rounding to a power of two ({rounded.shape[1]} blocks), "
        f"{rounded_ms:.3f} ms (host wall per upload, {UPLOAD_REPS} uploads "
        f"each, after a pass of both that warms the pinned-memory cache)")
    return {"sha256_e": {
        "name": "sha256_e", "route": "cuda",
        "source": "fabric_mod_tpu_torch/csrc/sha256.cu",
        "replaces": "fabric_mod_tpu/ops/sha256.py:81",
        "launches": 0, "max_abs_err": err, "ms": dev_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}}


def phase_kernels(torch, np, dev):
    from fabric_mod_tpu_torch.ops import limbs9, p256, p256_cuda
    fp = p256._consts()[0]
    u1, u2, qx, qy, invalid = ladder_inputs(torch, np, dev)
    per_lane, block = p256_cuda.geometry()
    results, canon = {}, {}
    for mixed in (False, True):
        name = p256_cuda.KERNELS[mixed]
        plain_fn = p256.shamir_ladder_mixed if mixed else p256.shamir_ladder
        got = p256_cuda.ladder(u1, u2, qx, qy, mixed=mixed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain_fn(u1, u2, qx, qy)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got_c = [limbs9.canonical(c, fp) for c in got]
        want_c = [limbs9.canonical(c, fp) for c in want]
        err = max(float((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got_c, want_c))
        for g, w, coord in zip(got_c, want_c, "XYZ"):
            if not torch.equal(g, w):
                bad = (g != w).any(0).nonzero().flatten()[:8].tolist()
                raise AssertionError(f"{name}: {coord} differs from the "
                                     f"plain ladder at lanes {bad}")
        canon[mixed] = got_c
        qx_w = p256_cuda.mont_limbs_to_words(qx).contiguous()
        qy_w = p256_cuda.mont_limbs_to_words(qy).contiguous()
        u1c, u2c = u1.contiguous(), u2.contiguous()
        p256_cuda.kernel_words(u1c, u2c, qx_w, qy_w, mixed)      # warm
        ms = time_cuda(torch, lambda: p256_cuda.kernel_words(
            u1c, u2c, qx_w, qy_w, mixed), reps=10)
        products = ladder_products_per_lane(mixed, u1, u2)
        madds = 2 * products * LANES
        clock = sm_clock_hz()
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        table_bytes = (16 * 3 if not mixed else 15 * 2) * 32
        nbytes = LANES * (2 * 64 * 4 + 2 * 32 + 3 * 32) + table_bytes
        bound_ops = madds / (INT_MADD_PER_SM_CLOCK * n_sm * clock) * 1e3
        bound_bytes = nbytes / PEAK_BYTES * 1e3
        results[name] = {
            "name": name, "route": "cuda",
            "source": "fabric_mod_tpu_torch/csrc/p256_ladder.cu",
            "replaces": ("fabric_mod_tpu/ops/p256_pallas.py:159" if mixed
                         else "fabric_mod_tpu/ops/p256_pallas.py:81"),
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "library_ms": None,
        }
        log(f"kernel {name}: bit-equal to plain on {LANES} lanes; "
            f"{per_lane} threads per lane, blocks of {block} threads; "
            f"{ms:.4f} ms per {LANES}-lane call (CUDA events, 10 calls), "
            f"plain {plain_ms:.1f} ms/call; bound "
            f"{results[name]['bound_ms']:.4f} ms by "
            f"{results[name]['bound_by']} ({products:.0f} word products = "
            f"{2 * products:.0f} 32-bit multiply-adds per lane at "
            f"{INT_MADD_PER_SM_CLOCK}/SM/clock x {n_sm} SMs x "
            f"{clock / 1e6:.0f} MHz; bytes {bound_bytes:.5f} ms); "
            f"critical path per lane {chain_rounds(mixed, per_lane)} rounds; "
            "library_ms null (no PyTorch call computes this)")
    proj = affine_of(torch, canon[False])
    mix = affine_of(torch, canon[True])
    diff = [i for i in range(LANES) if i not in invalid and proj[i] != mix[i]]
    if diff:
        raise AssertionError(f"mixed != projective in affine form at {diff[:8]}")
    if proj[0] is not None:
        raise AssertionError("all-zero lane did not stay at infinity")
    log(f"mixed ladder == projective ladder in affine form on "
        f"{LANES - len(invalid)} valid-key lanes")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    results.update(phase_core_kernels(torch, np, dev, sm_clock_hz(), n_sm))
    return results


def phase_main_path(torch, np, blocks):
    from fabric_mod_tpu_torch.bccsp import gpu, sw
    rng = np.random.default_rng(SEED + 1)
    verifiers = {lad: gpu.GpuVerifier(ladder=lad, cache_size=0)
                 for lad in gpu.LADDERS}
    # warm-up outside the counted run: first launches, constant uploads
    warm_items, warm_expect = blocks[0][0][:64], blocks[0][1][:64]
    for v in verifiers.values():
        if not (v.verify_many(warm_items) == warm_expect).all():
            raise AssertionError("warm-up verdicts differ from the fixture")
    sw_checked = {}
    for bi, (items, _expect) in enumerate(blocks):
        idx = rng.choice(len(items), SAMPLE, replace=False)
        sw_checked[bi] = (idx, np.array([sw.verify_item(items[i]) for i in idx]))
    # the raw block's lanes must hash in the SHA-256 kernel: count every
    # call of the plain torch SHA-256 on a CUDA tensor (there must be none)
    from fabric_mod_tpu_torch.ops import sha256
    plain_sha_calls = []
    plain_sha = sha256.sha256_blocks

    def counted_sha(words, nblocks):
        if words.device.type == "cuda":
            plain_sha_calls.append(words.shape)
        return plain_sha(words, nblocks)
    sha256.sha256_blocks = counted_sha
    try:
        _verify_blocks(torch, np, blocks, verifiers, sw_checked)
    finally:
        sha256.sha256_blocks = plain_sha
    if plain_sha_calls:
        raise AssertionError(f"the torch SHA-256 ran on the card "
                             f"{len(plain_sha_calls)} times")
    counts = kernel_counts()
    require_launched({k: counts[k] for k in VERIFY_KERNELS}, "the verify path")
    log(f"verify path: the raw block's digests came from the sha256_e "
        f"kernel ({counts['sha256_e']} launches), 0 torch SHA-256 calls on "
        f"the card")
    return counts


def _verify_blocks(torch, np, blocks, verifiers, sw_checked):
    """Phase 4's timed run: every block through each ladder's verifier."""
    reset_kernel_counts()
    for lad, v in verifiers.items():
        before = kernel_counts()
        block_ms = []
        for bi, (items, expect) in enumerate(blocks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = v.verify_many(items)
            block_ms.append((time.perf_counter() - t0) * 1e3)
            if got.shape != expect.shape or not (got == expect).all():
                bad = np.nonzero(got != expect)[0][:8].tolist()
                raise AssertionError(f"{lad}: block {bi} verdicts differ "
                                     f"from the expected mask at {bad}")
            idx, want = sw_checked[bi]
            if not (got[idx] == want).all():
                raise AssertionError(f"{lad}: block {bi} differs from the "
                                     "software verify on sampled lanes")
        after = kernel_counts()
        launched = {k: after[k] - before[k] for k in after}
        n_items = sum(len(b[0]) for b in blocks)
        log(f"verify path ({lad} ladder): {N_BLOCKS} blocks x {len(blocks[0][0])} "
            f"signatures, verdicts == expected masks and == sw on "
            f"{SAMPLE} sampled lanes/block; ms per block "
            f"{[round(m, 1) for m in block_ms]}; "
            f"{n_items / (sum(block_ms) / 1e3):.0f} verifies/s; "
            f"kernel launches {launched} "
            f"({sum(launched.values()) / N_BLOCKS:.1f} per 1000-tx block)")


# what the last device_profile window recorded of the hand-written
# launches made while it was open: {"launched": {kernel: n}, "seen":
# {kernel: n}} (PERF.md §7: the profiler can miss them)
LAST_WINDOW: dict = {"launched": {}, "seen": {}}


def device_profile(torch, fn):
    """Run fn() under torch.profiler: (wall ms, device kernels, device
    busy ms, [(name, count, ms)] heaviest first), or device figures None
    when the profiler recorded no device kernel.  LAST_WINDOW holds the
    hand-written launches of the window against those it recorded."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    before = kernel_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launched = {k: v - before[k] for k, v in kernel_counts().items()
                if v - before[k]}
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    names: dict = {}
    for e in kernels:
        names[e.name] = names.get(e.name, 0) + 1
    LAST_WINDOW["launched"] = launched
    LAST_WINDOW["seen"] = {k: recorded_launches(names, k) for k in launched}
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    if not kernels or busy_us <= 0:
        return wall_ms, None, None, []
    by_name: dict = {}
    for e in kernels:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return wall_ms, len(kernels), busy_us / 1e3, \
        [(name, c, t / 1e3) for name, (c, t) in top]


def window_complete() -> bool:
    """Whether the last device_profile window recorded every
    hand-written launch made in it."""
    return all(LAST_WINDOW["seen"][k] >= n
               for k, n in LAST_WINDOW["launched"].items())


def window_note() -> str:
    """The last window's hand-written launches, recorded against made."""
    launched, seen = LAST_WINDOW["launched"], LAST_WINDOW["seen"]
    return (f"hand-written launches recorded {sum(seen.values())} of "
            f"{sum(launched.values())} "
            f"({'complete' if window_complete() else 'INCOMPLETE'}"
            f"{'' if not launched else f': {seen} of {launched}'})")


def idle_text(busy_ms, wall_ms) -> str:
    """Busy and idle share of the last window: exact when it recorded
    every hand-written launch, else bounds (a missed kernel adds to
    busy)."""
    idle = 1 - busy_ms / wall_ms
    if window_complete():
        return f"device busy {busy_ms:.1f} ms, device idle share {idle:.3f}"
    return (f"device busy >= {busy_ms:.1f} ms, device idle share <= "
            f"{idle:.3f} (the profiler missed hand-written launches)")


def log_profile(label, wall_ms, n_kernels, busy_ms, top) -> None:
    if n_kernels is None:
        log(f"profile {label}: wall {wall_ms:.1f} ms; device time not "
            f"measured (the profiler recorded no device kernels); "
            f"{window_note()}")
        return
    log(f"profile {label}: wall {wall_ms:.1f} ms, device kernels "
        f"{n_kernels}, {idle_text(busy_ms, wall_ms)}; {window_note()}")
    for name, c, t in top:
        log(f"  {t:9.2f} ms  x{c:<6d} {name[:90]}")


def phase_block_commit(torch, np, world, raw_world, blocks, expected):
    """The block commit through the port's Committer, arm by arm, each
    into a fresh durable ledger.  Returns the kernel launch counts of
    the GPU arms."""
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.ledger import kvledger
    from fabric_mod_tpu_torch.policy import tensorpolicy
    from fabric_mod_tpu_torch.protos import messages as m
    # (arm, label, ladder, tensor policy, raw messages); every arm commits
    # through the vectorized MVCC (arm (e) of earlier runs is arm (a))
    arms = (("a", "projective ladder, tensor policy", "projective", True,
             False),
            ("b", "projective ladder, policy closures", "projective", False,
             False),
            ("c", "mixed ladder, tensor policy", "mixed", True, False),
            ("d", f"host software verifier (oracle, {ORACLE_WORKERS} "
             "processes)", None, False, False),
            ("f", "projective ladder, tensor policy, raw messages hashed "
             "by the sha256_e kernel", "projective", True, True))
    n_tx = sum(len(f) for f in expected)
    n_valid = sum(f == m.TxValidationCode.VALID for b in expected for f in b)
    flags_by_arm, fps = {}, {}
    # the vectorized MVCC passes, by arm (one a block in every arm)
    vector_passes = []
    vectorized = kvledger.validate_and_prepare_batch_vectorized

    def counted_vector(*args):
        vector_passes.append(arm)
        return vectorized(*args)
    kvledger.validate_and_prepare_batch_vectorized = counted_vector
    pool = PoolSwVerifier(ORACLE_WORKERS)
    reset_kernel_counts()
    try:
        for arm, label, ladder, tensor, raw in arms:
            verifier = (gpu.GpuVerifier(ladder=ladder, cache_size=0)
                        if ladder else pool)
            committer = (raw_world if raw else world).committer(
                verifier, tensor_policy=tensor)
            tensorpolicy.reset_counts()
            flags_by_arm[arm] = []
            timings = []
            wall = 0.0
            before = kernel_counts()
            for bi, raw_block in enumerate(blocks):
                block = m.Block.decode(raw_block)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                flags = committer.store_block(block)
                wall += time.perf_counter() - t0
                timings.append(committer.last_timings)
                if flags != expected[bi]:
                    bad = [i for i, (g, w) in enumerate(
                        zip(flags, expected[bi])) if g != w][:8]
                    raise AssertionError(f"arm {arm}: block {bi} txflags "
                                         f"differ from the expected flags "
                                         f"at {bad}")
                flags_by_arm[arm].append(flags)
            fps[arm] = committer.ledger.state_fingerprint()
            launched = {k: v - before[k] for k, v in kernel_counts().items()}
            passes = tensorpolicy.counts()
            want = {"cuda": len(blocks)} if tensor else {}
            if passes != want:
                raise AssertionError(f"arm {arm}: policy evaluator passes "
                                     f"{passes}, expected {want}")
            if (launched["sha256_e"] > 0) != raw:
                raise AssertionError(f"arm {arm}: sha256_e launched "
                                     f"{launched['sha256_e']} times")
            if vector_passes.count(arm) != len(blocks):
                raise AssertionError(f"arm {arm}: {vector_passes.count(arm)}"
                                     f" vectorized MVCC passes")
            stages = ("stage", "verify", "policy", "commit")
            split = {k: [round(t[k] * 1e3, 1) for t in timings]
                     for k in stages + ("decode",)}
            rest = [round((t["stage"] - t["decode"]) * 1e3, 1)
                    for t in timings]
            total = [round(sum(t[k] for k in stages) * 1e3, 1)
                     for t in timings]
            log(f"block commit arm ({arm}) {label}: {len(blocks)} blocks x "
                f"{len(expected[0])} txs, txflags == expected; ms per block "
                f"{total}: stage {split['stage']} (batch decode "
                f"{split['decode']}, the rest {rest}), verify "
                f"{split['verify']}, policy {split['policy']}, mvcc+commit "
                f"{split['commit']}; spine fallbacks "
                f"{[t['spine_fallbacks'] for t in timings]}, body fallbacks "
                f"{[t['body_fallbacks'] for t in timings]}; "
                f"{n_tx / wall:.1f} committed tx/s ({n_valid / wall:.1f} "
                f"valid tx/s); kernel launches {launched}; fingerprint "
                f"{fps[arm][:16]}")
            if tensor:
                dev_ms = [round(t["policy_device_ms"], 3) for t in timings]
                log(f"  policy evaluator on the CUDA mask: {passes['cuda']} "
                    f"passes, device ms per block {dev_ms} (CUDA events)")
    finally:
        kvledger.validate_and_prepare_batch_vectorized = vectorized
        pool.close()
    if len({tuple(map(tuple, f)) for f in flags_by_arm.values()}) != 1:
        raise AssertionError("arms disagree on txflags")
    if len(set(fps.values())) != 1:
        raise AssertionError(f"state fingerprints differ across arms: {fps}")
    counts = kernel_counts()
    require_launched({k: counts[k] for k in VERIFY_KERNELS},
                     "the block-commit path")
    log(f"block commit: all arms agree on txflags and state fingerprint "
        f"{fps['a']}; kernel launches {counts}")
    return counts


def phase_profile(torch, blocks, world, commit_blocks):
    """Where a block's time goes: torch.profiler over one verify_many
    per block kind (digest-only, raw endorsers), over a verify call of
    one signature (an MCS check's width) and of one 2048-lane bucket —
    launches per verify call — and over one whole block commit
    (projective ladder, tensor policy); then over the policy evaluator's
    pass alone, on the verify mask of the block."""
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.protos import messages as m
    v = gpu.GpuVerifier(ladder="projective", cache_size=0)
    digest_items = blocks[0][0]
    raw_items = blocks[-1][0]
    for label, items in (("digest block", digest_items),
                         ("raw-endorser block", raw_items),
                         ("verify call, 1 signature", digest_items[:1]),
                         ("verify call, one 2048-lane bucket",
                          digest_items[:LANES]),
                         ("raw verify call, one 2048-lane bucket",
                          raw_items[:LANES])):
        v.verify_many(items)                               # warm
        before = kernel_counts()
        prof = device_profile(torch, lambda: v.verify_many(items))
        kernels = {k: c - before[k] for k, c in kernel_counts().items()}
        log_profile(f"{label} ({len(items)} signatures; kernel launches "
                    f"{kernels}; {prof[1]} device launches in all)", *prof)
        if label.startswith("raw verify call") and kernels != {
                "ladder_projective": 1, "ladder_mixed": 0,
                "verify_prologue": 1, "verify_epilogue": 1, "sha256_e": 1,
                "fp256bn_miller": 0, "fp256bn_final_exp": 0}:
            raise AssertionError(f"a raw verify call launched {kernels}, "
                                 f"expected the four kernels once each")
    committer = world.committer(v, tensor_policy=True)
    block = m.Block.decode(commit_blocks[0])
    log_profile(f"block commit ({len(block.data.data)} txs, tensor policy)",
                *device_profile(torch, lambda: committer.store_block(block)))
    staged = world.committer(v, tensor_policy=True).validator.stage(
        m.Block.decode(commit_blocks[0]))
    raw = staged.mask_fn()
    torch.cuda.synchronize()
    session = staged.session

    def evaluator():
        session.attach_mask(raw)
        session.verdicts()
    wall_ms, n_kernels, busy_ms, top = device_profile(torch, evaluator)
    log_profile(f"policy evaluator pass ({len(session)} evaluations)",
                wall_ms, n_kernels, busy_ms, top)
    log(f"policy evaluator per block: {n_kernels} device launches, "
        f"device busy {busy_ms} ms, wall {wall_ms:.2f} ms (torch.profiler)")


def phase_e2e(torch, dev, arm="a", n_blocks=N_BLOCKS,
              block_txs=TX_PER_BLOCK, plant_every=PLANT_EVERY,
              submitters=E2E_SUBMITTERS, staged_batch=E2E_STAGED_BATCH,
              stream=None):
    """One arm of the end-to-end network on a fresh network: phase 8 on
    a solo orderer, phase 9 on three Raft orderers.  (a), (c): unstaged,
    the Writers check on the host, one submitter, the full plant stream,
    per-block flags; in (c) the submitter sends every envelope to a
    follower, which forwards it to the leader.  (b), (d): staged ingress
    with the Writers check batched on the card (`ingress_batching`,
    `staged_batch`; in (d) each orderer its own service), `submitters`
    threads (in (d) spread round-robin over the three orderers), the
    order-free stream, flags per txid.  `stream` (submits, flags) reuses
    an earlier arm's endorsed stream (the networks share the seed's
    certificates).  Returns the kernels' launch counts of the timed
    run, (material, block 1, its expected flags) for profile_e2e_block,
    the stream and the peer's state fingerprint."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
    from fabric_mod_tpu_torch.ops import p256
    from fabric_mod_tpu_torch.orderer import BroadcastError
    from fabric_mod_tpu_torch.policy import tensorpolicy
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    from fabric_mod_tpu_torch.utils import fixtures
    staged = arm in "bd"
    raft = arm in "cd"
    n_tx = n_blocks * block_txs
    material = fixtures.make_network_material(
        SEED, consensus_type="etcdraft" if raft else "solo",
        orderers=RAFT_ORDERERS if raft else 1,
        max_message_count=block_txs, batch_timeout=E2E_BATCH_TIMEOUT,
        preferred_max_bytes=E2E_PREFERRED_MAX_BYTES)
    # no verdict cache: every block's mask is the device tensor
    verifier = gpu.GpuVerifier(device=dev, ladder="projective", cache_size=0)
    raft_timing = (dict(election_timeout=RAFT_ELECTION_TIMEOUT,
                        heartbeat_s=RAFT_HEARTBEAT_S) if raft else {})
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        net = e2e.Network(os.path.join(root, "timed"), material=material,
                          verifier=verifier, tensor_policy=True,
                          ingress_batching=staged,
                          staged_batch=staged_batch if staged else 0,
                          **raft_timing)
        try:
            if raft:
                leader = net.raft_leader()
                log(f"e2e arm ({arm}): {len(net.orderers)} Raft orderers "
                    f"{[o.id for o in net.orderers]}, leader {leader} "
                    f"elected in {time.perf_counter() - t0:.1f} s (before "
                    f"the timed span)")
                follower = next(o for o in net.orderers if o.id != leader)
            t0 = time.perf_counter()
            if stream is None:
                stream = fixtures.make_e2e_stream(
                    net, n_tx, plant_every, order_free=staged)
            submits, flat = stream
            planted = sum(not ok for _env, ok in submits)
            expected = [flat[b * block_txs:(b + 1) * block_txs]
                        for b in range(n_blocks)]
            accepted = [env for env, ok in submits if ok]
            txid = [protoutil.envelope_channel_header(env).tx_id
                    for env, _ok in submits]
            want_by_txid = dict(zip(
                [t for t, (_e, ok) in zip(txid, submits) if ok], flat))
            log(f"e2e arm ({arm}) fixtures: {n_tx} txs endorsed by the "
                f"network's endorsers (+{planted} tampered"
                f"{', order-free kinds only' if staged else ''}) in "
                f"{time.perf_counter() - t0:.1f} s (pure-python signer; "
                f"0 s when an earlier arm's stream is reused)")
            if staged and len(want_by_txid) != len(accepted):
                raise AssertionError("the order-free stream repeats a txid")

            # which path reached the verifier: the MCS calls verify_many,
            # the validator verify_many_fused_async, the ingress service
            # verify_many_async (which verify_many also calls: the outer
            # tag wins).  Each call tags its thread; each core run inside
            # the verifier's enqueue lock adds its kernel launches to its
            # thread's path.  Each block's tensor session is kept for its
            # fallback count; each ingress verify call's size is a cohort.
            calls = {"mcs": 0, "validator": 0, "ingress": 0}
            by_path = {k: dict.fromkeys(kernel_counts(), 0) for k in calls}
            path = threading.local()
            sessions, cohorts = [], []

            def counted(name, fn):
                def call(items):
                    outer = getattr(path, "name", None)
                    if outer is None:
                        calls[name] += 1
                        path.name = name
                    try:
                        return fn(items)
                    finally:
                        if outer is None:
                            path.name = None
                return call
            verifier.verify_many = counted("mcs", verifier.verify_many)
            verifier.verify_many_fused_async = counted(
                "validator", verifier.verify_many_fused_async)
            verifier.verify_many_async = counted(
                "ingress", verifier.verify_many_async)
            core = p256._core

            def tagged_core(*args, **kw):
                before = kernel_counts()
                out = core(*args, **kw)
                key = getattr(path, "name", None) or "untagged"
                tally = by_path.setdefault(
                    key, dict.fromkeys(before, 0))
                for k, v in kernel_counts().items():
                    tally[k] += v - before[k]
                return out
            commit_staged = net.channel.commit_staged

            def keep_session(staged_block):
                sessions.append(staged_block.session)
                return commit_staged(staged_block)
            net.channel.commit_staged = keep_session
            if staged:
                for o in net.orderers:
                    processor = o.support.processor

                    def cohort(items, ingress_verify=processor._verify_many):
                        cohorts.append(len(items))
                        return ingress_verify(items)
                    processor._verify_many = cohort

            rejected, device_errors, lock = set(), [], threading.Lock()

            def submit(share, broadcast):
                for i in share:
                    env, ok = submits[i]
                    try:
                        broadcast.submit(env)
                    except BroadcastError:
                        if ok:
                            raise
                        with lock:
                            rejected.add(i)
                        continue
                    except Exception as e:      # a device fault
                        with lock:
                            device_errors.append(repr(e))
                        continue
                    if not ok:
                        raise AssertionError("Broadcast accepted a tampered "
                                             "creator signature")

            def feed():
                nonlocal ingress_s
                order = list(range(len(submits)))
                if not staged:
                    submit(order, follower.broadcast if raft
                           else net.broadcast)
                else:
                    errors = []

                    def run(k):
                        try:
                            submit(order[k::submitters],
                                   net.orderers[k % len(net.orderers)]
                                   .broadcast)
                        except Exception as e:  # re-raised below
                            errors.append(e)
                    threads = [threading.Thread(target=run, args=(k,),
                                                daemon=True)
                               for k in range(submitters)]
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join(timeout=E2E_TIMEOUT_S)
                    if any(t.is_alive() for t in threads):
                        raise AssertionError("a submitter is still blocked")
                    if errors:
                        raise errors[0]
                ingress_s = time.perf_counter() - t0
            ingress_s = 0.0
            chains = [o.support.chain for o in net.orderers]

            def raft_counters():
                return [(c.raft.elections, c.raft.leader_changes,
                         c.raft.wal_syncs, c.forwarded) for c in chains]
            before = raft_counters() if raft else None
            p256._core = tagged_core
            try:
                reset_kernel_counts()
                tensorpolicy.reset_counts()
                t0 = time.perf_counter()
                client, _committed, span_s = e2e.commit_until(
                    net, n_tx, E2E_TIMEOUT_S, feed=feed,
                    idle_timeout_s=E2E_TIMEOUT_S)
            finally:
                p256._core = core
            counts = kernel_counts()
            passes = tensorpolicy.counts()
            raft_note = ""
            if raft:
                during = [tuple(a - b for a, b in zip(x, y))
                          for x, y in zip(raft_counters(), before)]
                require_same_chain(net, n_blocks)
                if net.raft_leader() != leader:
                    raise AssertionError(f"the leader changed during the "
                                         f"span: {leader} -> "
                                         f"{net.raft_leader()}")
                ids = [o.id for o in net.orderers]
                forwarded = sum(d[3] for d in during)
                if forwarded == 0 or chains[ids.index(leader)].forwarded:
                    raise AssertionError(f"forwarded submits {during}")
                raft_note = (
                    f"; Raft: {forwarded} submits forwarded to the leader "
                    f"{leader}, elections {sum(d[0] for d in during)} and "
                    f"leader changes {sum(d[1] for d in during)} during "
                    f"the span, WAL fsyncs by node "
                    f"{dict(zip(ids, (d[2] for d in during)))}; the "
                    f"{len(ids)} orderers hold the same chain")
            # every block full, every flag the construction's
            if net.ledger.height != 1 + n_blocks:
                sizes = [len(net.ledger.get_block_by_number(b).data.data)
                         for b in range(1, net.ledger.height)]
                raise AssertionError(f"ledger height {net.ledger.height}, "
                                     f"expected {1 + n_blocks}; txs per "
                                     f"block {sizes}")
            if device_errors:
                raise AssertionError(f"{len(device_errors)} device errors "
                                     f"at ingress: {device_errors[:3]}")
            tampered = {i for i, (_e, ok) in enumerate(submits) if not ok}
            if rejected != tampered:
                raise AssertionError(f"{len(rejected)} envelopes rejected at "
                                     f"ingress, {planted} planted; the "
                                     f"same ones: {rejected == tampered}")
            oracle = KvLedger(net.channel_id)
            genesis = m.Block.decode(material.genesis)
            oracle.commit_block(genesis, [m.TxValidationCode.VALID]
                                * len(genesis.data.data))
            for b in range(n_blocks):
                block = net.ledger.get_block_by_number(b + 1)
                if len(block.data.data) != block_txs:
                    raise AssertionError(f"block {b + 1} holds "
                                         f"{len(block.data.data)} txs")
                flags = list(protoutil.block_txflags(block))
                if staged:
                    want = [want_by_txid[protoutil.envelope_channel_header(
                        m.Envelope.decode(raw)).tx_id]
                        for raw in block.data.data]
                else:
                    want = expected[b]
                if flags != want:
                    bad = [i for i, (g, w) in enumerate(zip(flags, want))
                           if g != w][:8]
                    raise AssertionError(f"block {b + 1}: txflags differ "
                                         f"from the construction at {bad}")
                ordered = net.support.store.get_block_by_number(b + 1)
                if oracle.commit_block(ordered, want) != want:
                    raise AssertionError(f"oracle ledger changed block "
                                         f"{b + 1}'s flags")
            fp = net.ledger.state_fingerprint()
            oracle_fp = oracle.state_fingerprint()
            oracle.close()
            if fp != oracle_fp:
                raise AssertionError("state fingerprint differs from the "
                                     "construction oracle's")

            # the card: every device path, a device mask on every block
            want_calls = {"mcs": n_blocks, "validator": n_blocks}
            if {k: calls[k] for k in want_calls} != want_calls \
                    or (calls["ingress"] > 0) != staged:
                raise AssertionError(f"verifier calls {calls}, expected one "
                                     f"MCS and one validator call per block"
                                     f"{' and ingress calls' if staged else ''}")
            proj = "ladder_projective"
            for key, tally in by_path.items():
                if key != "untagged" and not (
                        tally[proj] == tally["verify_prologue"]
                        == tally["verify_epilogue"]):
                    raise AssertionError(f"{key}: launches {tally}: a ladder "
                                         "without its prologue or epilogue")
            summed = {k: sum(t[k] for t in by_path.values()) for k in counts}
            if summed != counts or counts["ladder_mixed"] != 0 \
                    or by_path["mcs"][proj] < n_blocks \
                    or by_path["validator"][proj] < n_blocks \
                    or (by_path["ingress"][proj] > 0) != staged:
                raise AssertionError(f"kernel launches {counts}, by path "
                                     f"{by_path}: expected each device path "
                                     f"to launch its kernels")
            if passes != {dev.type: n_blocks}:
                raise AssertionError(f"policy evaluator passes {passes}, "
                                     f"expected {n_blocks} on {dev.type}")
            if len(sessions) != n_blocks or not all(sessions):
                raise AssertionError("a block was committed without a "
                                     "tensor-policy session")
            ingress_note = ""
            if staged:
                mean = sum(cohorts) / max(1, len(cohorts))
                if not cohorts or mean <= 1.0 \
                        or sum(cohorts) != len(submits):
                    raise AssertionError(f"ingress cohorts {len(cohorts)}, "
                                         f"mean {mean:.2f}: expected "
                                         f"batches of more than one")
                ingress_note = (f"; ingress device calls "
                                f"{calls['ingress']}, cohorts {len(cohorts)} "
                                f"of mean size {mean:.2f} (max "
                                f"{max(cohorts)}), 0 device errors")
            fallbacks = sum(s.fallbacks for s in sessions)
            n_valid = sum(f == m.TxValidationCode.VALID for f in flat)
            label = (f"staged, {submitters} submitters, Writers batched on "
                     "the card" if staged else
                     "unstaged, 1 submitter, Writers on the host")
            if raft:
                label = (f"{len(net.orderers)} Raft orderers, " + label
                         + (" of each orderer, submitters round-robin over "
                            "the orderers" if staged else
                            ", every submit to a follower"))
            log(f"e2e arm ({arm}) {label}: {n_blocks} blocks x {block_txs} txs ordered, MCS-verified "
                f"and committed; txflags == construction"
                f"{' per txid' if staged else ''} ({n_valid} VALID); "
                f"{len(rejected)} ingress rejections == planted; "
                f"fingerprint == oracle ({fp[:16]}); "
                f"{n_tx / span_s:.1f} committed tx/s over the "
                f"ordering-and-commit span of {span_s:.2f} s; ingress "
                f"{ingress_s:.2f} s ({len(submits)} submits, "
                f"{ingress_s / len(submits) * 1e3:.3f} ms each); deliver "
                f"client stage {client.stage_secs:.2f} s, await "
                f"{client.await_secs:.2f} s, commit {client.commit_secs:.2f} "
                f"s; MCS {client.mcs_secs / n_blocks * 1e3:.1f} ms per "
                f"block; verifier calls {calls}; kernel launches {counts} "
                f"(by path {by_path}); evaluator passes {passes}, fallbacks "
                f"{fallbacks}{ingress_note}{raft_note}")
            first = net.support.store.get_block_by_number(1)
            first_flags = list(protoutil.block_txflags(
                net.ledger.get_block_by_number(1)))
            # phase 15 (a) commits these ordered blocks again, traced
            ORDERED[arm] = (material, [
                net.support.store.get_block_by_number(b).encode()
                for b in range(1, n_blocks + 1)], fp)
        finally:
            net.close()
    return counts, (material, first, first_flags), stream, fp


# arm -> (material, the ordered blocks 1..n encoded, the peer's state
# fingerprint), kept by phase_e2e for phase 15 (a)
ORDERED: dict = {}


def require_same_chain(net, n_blocks: int) -> None:
    """Raise unless every orderer of a Raft network holds the same chain:
    the same heights, header hashes and metadata slot 3 (the raft
    index), with a signature of its own on every block."""
    from fabric_mod_tpu_torch.orderer import RaftChain
    from fabric_mod_tpu_torch.protos import protoutil
    stores = [o.support.store for o in net.orderers]
    # the peer delivers from the first orderer; the others may lag it by
    # an apply
    deadline = time.monotonic() + 60
    while {s.height for s in stores} != {n_blocks + 1} \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    if {s.height for s in stores} != {n_blocks + 1}:
        raise AssertionError(f"orderer heights "
                             f"{[s.height for s in stores]}")
    slot = RaftChain.RAFT_INDEX_MD_SLOT
    for num in range(1, n_blocks + 1):
        blocks = [s.get_block_by_number(num) for s in stores]
        if len({protoutil.block_header_hash(b.header) for b in blocks}) != 1 \
                or len({bytes(b.metadata.metadata[slot])
                        for b in blocks}) != 1 \
                or len({bytes(b.metadata.metadata[0])
                        for b in blocks}) != len(blocks):
            raise AssertionError(f"block {num} differs across orderers, or "
                                 f"two orderers share a signature")


def profile_e2e_block(torch, material, block, expected):
    """torch.profiler over one ordered block on a fresh peer of the same
    network: its MCS check, then its stage and commit (one thread)."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.protos import protoutil
    with tempfile.TemporaryDirectory() as root:
        net = e2e.Network(root, material=material,
                          verifier=gpu.GpuVerifier(cache_size=0),
                          tensor_policy=True)
        try:
            ch = net.channel
            prev = protoutil.block_header_hash(
                net.ledger.get_block_by_number(0).header)

            def mcs():
                ch.mcs.verify_block(ch.channel_id, block,
                                    expected_prev_hash=prev)
            mcs()                                          # warm
            got = {}

            def stage_and_commit():
                staged = ch.stage_block(block)
                staged.resolve_mask()
                got["flags"] = ch.commit_staged(staged)
            for label, fn in (("MCS check", mcs),
                              ("stage and commit", stage_and_commit)):
                before = kernel_counts()
                wall_ms, n_k, busy_ms, top = device_profile(torch, fn)
                kernels = {k: v - before[k]
                           for k, v in kernel_counts().items()}
                log_profile(f"e2e block {block.header.number} {label} "
                            f"({len(block.data.data)} txs; kernel launches "
                            f"{kernels})", wall_ms, n_k, busy_ms, top)
            if got["flags"] != expected:
                raise AssertionError("the profiled block's flags differ "
                                     "from the construction")
        finally:
            net.close()


# --- phase 10: gossip (BASELINE.md #5) --------------------------------------

def _put_envelope(net, key: bytes, value: bytes):
    """One put endorsed by Org1 and Org2 (the network's MAJORITY)."""
    from fabric_mod_tpu_torch.protos import protoutil
    sp, prop, _ = protoutil.create_chaincode_proposal(
        net.channel_id, "mycc", [b"put", key, value], net.client)
    return protoutil.create_tx_from_responses(
        prop, [net.endorsers[o].process_proposal(sp)
               for o in ("Org1", "Org2")], net.client)


class _CountingNetwork:
    """Wraps an InProcNetwork's send to count the envelopes sent."""

    def __init__(self, network):
        self.network = network
        self.sent = 0
        self._lock = threading.Lock()
        send = network.send

        def counted(*args):
            with self._lock:
                self.sent += 1
            return send(*args)
        network.send = counted


class VerifyCallTags:
    """Counts the calls into a BatchingVerifyService by the path that made
    them: "envelope" (a gossip envelope's signature), "mcs" (a block's
    orderer signature) or "commit" (everything else: a block's validation)
    — the outermost tagged path of the calling thread — and the MCS's
    rejections."""

    def __init__(self, service):
        self.calls = {"envelope": 0, "mcs": 0, "commit": 0}
        self.rejections = 0
        self._tag = threading.local()
        self._lock = threading.Lock()
        inner = service.verify_many

        def tagged(items, timeout=30.0):
            with self._lock:
                self.calls[getattr(self._tag, "name", None) or "commit"] += 1
            return inner(items, timeout)
        service.verify_many = tagged

    def tagging(self, name, fn):
        """`fn` with its verify calls tagged `name`."""
        from fabric_mod_tpu_torch.peer.mcs import BlockVerificationError

        def call(*args, **kw):
            outer = getattr(self._tag, "name", None)
            self._tag.name = outer or name
            try:
                return fn(*args, **kw)
            except BlockVerificationError:
                with self._lock:
                    self.rejections += 1
                raise
            finally:
                self._tag.name = outer
        return call


def _cohorts(verifier) -> list:
    """Record the size of every call the coalescing service makes into
    `verifier` (its device calls before the memo-cache)."""
    sizes = []
    inner = verifier.verify_many_async

    def recorded(items):
        sizes.append(len(items))
        return inner(items)
    verifier.verify_many_async = recorded
    return sizes


class McsSplit:
    """The split of sampled MCS calls' wall: host time outside
    `verify_many` (data hash, decode, policy prepare), `verify_many`'s
    wall (the queue, the device, the resolve), and for the device calls
    that carried a sampled item the device span from before its enqueue
    to after its last kernel (CUDA events on the flusher's stream) and
    its host enqueue time."""

    def __init__(self, torch, device_verifier):
        self._torch = torch
        self._local = threading.local()
        self._marked = set()
        self._lock = threading.Lock()
        self.calls = []                    # (mcs wall s, verify_many wall s)
        self.device = []                   # (start, end, enqueue s, items)
        inner = device_verifier.verify_many_async

        def spanned(items):
            with self._lock:
                hit = any(id(it) in self._marked for it in items)
            if not hit:
                return inner(items)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            out = inner(items)
            enqueue_s = time.perf_counter() - t0
            end.record()
            self.device.append((start, end, enqueue_s, len(items)))
            return out
        device_verifier.verify_many_async = spanned

    def verifier(self, service):
        """A verifier seam for one sampled peer's MCS."""
        split = self

        class Timed:
            def verify_many(self, items):
                with split._lock:
                    split._marked.update(id(it) for it in items)
                t0 = time.perf_counter()
                try:
                    return service.verify_many(items)
                finally:
                    split._local.vm = time.perf_counter() - t0
                    with split._lock:
                        split._marked.difference_update(id(it)
                                                        for it in items)
        return Timed()

    def mcs(self, mcs):
        """Time each verify_block of one sampled peer's MCS."""
        inner = mcs.verify_block

        def timed(*args, **kw):
            self._local.vm = 0.0
            t0 = time.perf_counter()
            try:
                return inner(*args, **kw)
            finally:
                self.calls.append((time.perf_counter() - t0,
                                   self._local.vm))
        mcs.verify_block = timed
        return mcs

    def summary(self) -> str:
        self._torch.cuda.synchronize()
        n = len(self.calls)
        if not n:
            return "no sampled calls"
        wall = sum(c for c, _ in self.calls) / n * 1e3
        vm = sum(v for _, v in self.calls) / n * 1e3
        dev = [(s.elapsed_time(e), q * 1e3, k) for s, e, q, k in self.device]
        dev_note = "device spans not measured"
        if dev:
            dev_note = (
                f"the {len(dev)} device calls they rode on: device span "
                f"{sum(d for d, _, _ in dev) / len(dev):.3f} ms each (CUDA "
                f"events from before the enqueue to after the last kernel; "
                f"max {max(d for d, _, _ in dev):.3f}), of which the host "
                f"enqueue {sum(q for _, q, _ in dev) / len(dev):.3f} ms, "
                f"{sum(k for _, _, k in dev) / len(dev):.1f} items each")
        return (f"{n} sampled MCS calls: wall {wall:.3f} ms each = host "
                f"(data hash, decode, policy prepare) {wall - vm:.3f} ms + "
                f"verify_many {vm:.3f} ms (queue + device + resolve); "
                f"{dev_note}")


def phase_gossip_storm(torch, dev):
    """Phase 10 (a): GOSSIP_PEERS peer threads, each its own
    MessageCryptoService over one bundle, verify the same orderer-signed
    blocks STORM_REPS times (bench.py:1278 measure_gossip): on the host
    verifier (the oracle), on one BatchingVerifyService over the card's
    GpuVerifier with no memo-cache (every check reaches the card; timed
    after a warm-up run, then once more under torch.profiler) and with
    the default memo-cache; in every arm every peer must reject a copy
    with a flipped signature byte.  Returns the kernels' launches of the
    timed card run."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import gpu, sw
    from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
    from fabric_mod_tpu_torch.peer.mcs import (BlockVerificationError,
                                               MessageCryptoService)
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.utils import fixtures
    t_phase = time.perf_counter()
    material = fixtures.make_network_material(
        SEED + 10, max_message_count=STORM_BLOCK_TXS,
        batch_timeout=STORM_BATCH_TIMEOUT)
    with tempfile.TemporaryDirectory() as root:
        net = e2e.Network(root, material=material, verifier=sw.SwVerifier())
        try:
            envs = [_put_envelope(net, b"k%d" % i, b"v%d" % i)
                    for i in range(STORM_TXS)]
            for env in envs:
                net.broadcast.submit(env)
            store = net.support.store
            deadline = time.monotonic() + E2E_TIMEOUT_S
            while sum(len(store.get_block_by_number(b).data.data)
                      for b in range(1, store.height)) < STORM_TXS:
                if time.monotonic() > deadline:
                    raise AssertionError("the storm's blocks were not cut")
                time.sleep(0.01)
            blocks = [store.get_block_by_number(b)
                      for b in range(1, store.height)]
        finally:
            net.close()
    channel_id, config = config_from_block(m.Block.decode(material.genesis))
    bundle = Bundle(channel_id, config, sw.SwCSP())
    tampered = m.Block.decode(
        fixtures.tamper_block_signature(blocks[0].encode()))
    log(f"gossip (a) storm fixtures: {STORM_TXS} puts ordered into "
        f"{len(blocks)} orderer-signed blocks of "
        f"{[len(b.data.data) for b in blocks]} txs in "
        f"{time.perf_counter() - t_phase:.1f} s")

    def storm(verifier, split=None, check=None):
        """Every peer verifies every block STORM_REPS times (or, with
        `check`, the tampered copy once); seconds between the barrier and
        the last peer's end."""
        svcs = []
        for i in range(GOSSIP_PEERS):
            sampled = split is not None and i % STORM_SAMPLE_EVERY == 0
            svc = MessageCryptoService(
                lambda: bundle,
                split.verifier(verifier) if sampled else verifier)
            svcs.append(split.mcs(svc) if sampled else svc)
        start = threading.Barrier(GOSSIP_PEERS + 1)
        errors, rejected = [], []

        def peer(svc):
            start.wait()
            try:
                if check is not None:
                    try:
                        svc.verify_block(channel_id, check)
                    except BlockVerificationError:
                        rejected.append(1)
                    return
                for _ in range(STORM_REPS):
                    for blk in blocks:
                        svc.verify_block(channel_id, blk)
            except Exception as e:          # re-raised below
                errors.append(e)
        threads = [threading.Thread(target=peer, args=(s,), daemon=True)
                   for s in svcs]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=E2E_TIMEOUT_S)
        dt = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("a storm peer is still running")
        if errors:
            raise errors[0]
        if check is not None and len(rejected) != GOSSIP_PEERS:
            raise AssertionError(f"{len(rejected)} of {GOSSIP_PEERS} peers "
                                 f"rejected the tampered block")
        return dt

    n_verifies = GOSSIP_PEERS * STORM_REPS * len(blocks)
    host = sw.SwVerifier()
    host_s = storm(host)
    storm(host, check=tampered)
    host_rate = n_verifies / host_s
    log(f"gossip (a) arm 1, host verifier (the oracle): {n_verifies} block "
        f"verifies ({GOSSIP_PEERS} peers x {STORM_REPS} reps x "
        f"{len(blocks)} blocks) in {host_s:.3f} s: {host_rate:.1f} block "
        f"verifies/s; every peer rejected the tampered block")

    card = gpu.GpuVerifier(device=dev, cache_size=0)
    service = gpu.BatchingVerifyService(card)
    try:
        sizes = _cohorts(card)
        storm(service)                                   # warm-up
        split = McsSplit(torch, card)
        del sizes[:]
        reset_kernel_counts()
        card_s = storm(service, split=split)
        torch.cuda.synchronize()
        counts = kernel_counts()
        calls, items = len(sizes), sum(sizes)
        if items != n_verifies:
            raise AssertionError(f"{items} items reached the card, "
                                 f"{n_verifies} verifies were made")
        if counts["verify_prologue"] == 0 or counts["ladder_projective"] \
                != counts["verify_prologue"] or counts["verify_epilogue"] \
                != counts["verify_prologue"] or counts["ladder_mixed"]:
            raise AssertionError(f"storm kernel launches {counts}")
        card_rate = n_verifies / card_s
        log(f"gossip (a) arm 2, one BatchingVerifyService over the card's "
            f"GpuVerifier (memo-cache off: every check reaches the card): "
            f"{card_s:.3f} s, {card_rate:.1f} block verifies/s, "
            f"{card_rate / host_rate:.2f}x the host arm; {calls} calls into "
            f"the GpuVerifier, mean cohort {items / calls:.2f} items (max "
            f"{max(sizes)}); kernel launches {counts}; verdicts == the "
            f"host arm's (every genuine block accepted)")
        log(f"gossip (a) MCS wall split under the storm: {split.summary()}")
        wall_ms, n_k, busy_ms, top = device_profile(
            torch, lambda: storm(service))
        log_profile(f"gossip (a) storm of {n_verifies} block verifies "
                    f"(arm 2, profiled)", wall_ms, n_k, busy_ms, top)
        storm(service, check=tampered)
    finally:
        service.close()
    cached = gpu.BatchingVerifyService(gpu.GpuVerifier(device=dev))
    try:
        storm(cached)                                     # fills the cache
        cached_s = storm(cached)
        storm(cached, check=tampered)
    finally:
        cached.close()
    log(f"gossip (a) arm 3, as arm 2 with the GpuVerifier's default "
        f"memo-cache (the reference bench's setting): "
        f"{n_verifies / cached_s:.1f} block verifies/s "
        f"({n_verifies / cached_s / host_rate:.2f}x the host arm; after "
        f"one run every check is a cache hit); every peer rejected the "
        f"tampered block in arms 2 and 3; phase (a) "
        f"{time.perf_counter() - t_phase:.1f} s wall")
    return counts


class _GatedSource:
    """A deliver source that holds block `gate_at` until `release` is
    set, and notes when it hands out its first block."""

    def __init__(self, source, gate_at: int):
        self._source = source
        self.gate_at = gate_at
        self.release = threading.Event()
        self.first_at = None

    def blocks(self, start=0, stop=None, stop_event=None, timeout_s=30.0):
        for block in self._source.blocks(start, stop=stop,
                                         stop_event=stop_event,
                                         timeout_s=timeout_s):
            if block.header.number == self.gate_at:
                while not self.release.wait(0.05):
                    if stop_event is not None and stop_event.is_set():
                        return
            if self.first_at is None:
                self.first_at = time.perf_counter()
            yield block


def phase_gossip_network(torch, dev, stream, fingerprint):
    """Phase 10 (b): GOSSIP_PEERS gossip peers at BASELINE.md #5's width
    around a solo e2e Network that orders the head of phase 8's stream
    (arm (a)'s envelopes in arm (a)'s order, GOSSIP_BLOCKS blocks of
    TX_PER_BLOCK):
    each peer its own ledger, Channel (tensor policy, commit pipe of
    depth 2), GossipNode and GossipService on one in-process network,
    every channel's verifier one BatchingVerifyService over one
    GpuVerifier.  Every view is seeded, then the first
    GOSSIP_ALIVE_SENDERS peers send a round of signed alive messages; the
    minimum-PKI-ID peer is pinned as the static leader (bench.py:2229),
    the others commit what its pushes (and their forwards) bring.  A
    copy of block 1 with a flipped orderer-signature byte is pushed to
    every peer first.  Every peer must reach the orderer's height with
    arm (a)'s flags and its state after those blocks (its flags replayed
    into a fresh ledger; `fingerprint`, arm (a)'s own, when the whole
    stream is ordered), take no tampered block and keep no error.  The
    last block's spread runs under torch.profiler.  Returns the kernels'
    launches from the join to the last commit, and the spread's figures
    (its wall, peer-blocks/s, envelopes sent, MCS checks a peer-block)
    for phase 11 (b) to print beside its own."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import gpu, sw
    from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
    from fabric_mod_tpu_torch.gossip import (GossipNode, GossipService,
                                             InProcNetwork)
    from fabric_mod_tpu_torch.ledger.kvledger import LedgerManager
    from fabric_mod_tpu_torch.msp.identities import (SigningIdentity,
                                                     deserialize_cert)
    from fabric_mod_tpu_torch.orderer import BroadcastError, DeliverService
    from fabric_mod_tpu_torch.peer.channel import Channel
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    from fabric_mod_tpu_torch.utils import fixtures
    from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
    t_phase = time.perf_counter()
    submits, flat = stream
    n_blocks = GOSSIP_BLOCKS
    n_tx = n_blocks * TX_PER_BLOCK
    if len(flat) < n_tx:
        raise AssertionError(f"phase 8's stream holds {len(flat)} txs")
    material = fixtures.make_network_material(
        SEED, max_message_count=TX_PER_BLOCK, batch_timeout=E2E_BATCH_TIMEOUT,
        preferred_max_bytes=E2E_PREFERRED_MAX_BYTES,
        gossip_peers=GOSSIP_PEERS)
    with tempfile.TemporaryDirectory() as root:
        net = e2e.Network(os.path.join(root, "orderer"), material=material,
                          verifier=sw.SwVerifier())
        card = gpu.GpuVerifier(device=dev)
        service = gpu.BatchingVerifyService(card)
        services, nodes, channels, mgrs = [], [], [], []
        lead = None
        try:
            accepted = 0
            for env, ok in submits:
                if accepted == n_tx:
                    break
                try:
                    net.broadcast.submit(env)
                except BroadcastError:
                    if ok:
                        raise
                    continue
                if not ok:
                    raise AssertionError("Broadcast accepted a tampered "
                                         "creator signature")
                accepted += 1
            store = net.support.store
            deadline = time.monotonic() + E2E_TIMEOUT_S
            while store.height < n_blocks + 1:
                if time.monotonic() > deadline:
                    raise AssertionError(f"orderer height {store.height}")
                time.sleep(0.01)
            ordered_s = time.perf_counter() - t_phase
            # arm (a)'s state after these blocks: its flags replayed
            # into a fresh ledger (the whole stream's is arm (a)'s own)
            oracle = KvLedger(net.channel_id)
            genesis = m.Block.decode(material.genesis)
            oracle.commit_block(genesis, [m.TxValidationCode.VALID]
                                * len(genesis.data.data))
            for b in range(1, n_blocks + 1):
                oracle.commit_block(store.get_block_by_number(b),
                                    flat[(b - 1) * TX_PER_BLOCK:
                                         b * TX_PER_BLOCK])
            want_fp = oracle.state_fingerprint()
            oracle.close()
            if len(flat) == n_tx and want_fp != fingerprint:
                raise AssertionError("the replayed state differs from arm "
                                     "(a)'s")

            # the peers
            t0 = time.perf_counter()
            channel_id, config = config_from_block(genesis)
            fabric = InProcNetwork()
            sent = _CountingNetwork(fabric)
            tags = VerifyCallTags(service)
            calls = tags.calls
            for i, (mspid, cert_pem, key_pem) in enumerate(
                    material.gossip_peers):
                csp = sw.SwCSP()
                mgr = LedgerManager(os.path.join(root, f"gossip{i}"))
                mgrs.append(mgr)
                channel = Channel(channel_id, mgr.create_or_open(channel_id),
                                  service, Bundle(channel_id, config, csp),
                                  csp, tensor_policy=True, pipeline_depth=2)
                channel.init_from_genesis(m.Block.decode(material.genesis))
                channel.mcs.verify_block = tags.tagging(
                    "mcs", channel.mcs.verify_block)
                channels.append(channel)
                node = GossipNode(
                    f"gossip{i}:7051", SigningIdentity(
                        mspid, deserialize_cert(cert_pem), key_pem, csp),
                    channel, fabric)
                node.mapper.verify = tags.tagging("envelope",
                                                  node.mapper.verify)
                nodes.append(node)
            lead = min(range(GOSSIP_PEERS), key=lambda i: nodes[i].pki_id)
            source = _GatedSource(DeliverService(net.support), n_blocks)
            for i, node in enumerate(nodes):
                services.append(GossipService(node, lambda: source,
                                              static_leader=(i == lead)))
            built_s = time.perf_counter() - t0

            # membership: every view seeded with the peers that send no
            # alive (no message), then a signed alive round from the
            # first GOSSIP_ALIVE_SENDERS peers, each to every other, its
            # fresh news forwarded: the senders reach the views only
            # through the round
            for node in nodes:
                for other in nodes[GOSSIP_ALIVE_SENDERS:]:
                    if other is not node:
                        node.mapper.put(other._identity)
                        node._members_by_pki[other.pki_id] = other.endpoint
                        node.discovery.handle_alive(
                            other.pki_id, m.AliveMessage(
                                membership=m.GossipMember(
                                    endpoint=other.endpoint,
                                    pki_id=other.pki_id),
                                timestamp=m.PeerTime(inc_num=1, seq_num=1)))
            reset_kernel_counts()
            sizes = _cohorts(card)
            t0 = time.perf_counter()
            endpoints = [n.endpoint for n in nodes]
            for node in nodes[:GOSSIP_ALIVE_SENDERS]:
                node.join(endpoints)
            join_s = time.perf_counter() - t0
            if calls["envelope"] < GOSSIP_ALIVE_SENDERS * (GOSSIP_PEERS - 1):
                raise AssertionError(f"the alive round's envelope verifies "
                                     f"{dict(calls)}")
            views = [len(n.discovery.alive_members()) for n in nodes]
            if min(views) != GOSSIP_PEERS - 1:
                raise AssertionError(f"membership views {sorted(views)[:5]}")
            senders = {n.pki_id for n in nodes[:GOSSIP_ALIVE_SENDERS]}
            for i, n in enumerate(nodes):
                seen = {mb.pki_id for mb in n.discovery.alive_members()}
                if not senders - {n.pki_id} <= seen:
                    raise AssertionError(f"peer {i}'s view lacks "
                                         f"{len(senders - seen - {n.pki_id})}"
                                         f" of the alive round's senders")
            join_sent, join_calls = sent.sent, dict(calls)

            # a tampered block 1 pushed to every peer
            other = nodes[(lead + 1) % GOSSIP_PEERS]
            evil = m.Block.decode(fixtures.tamper_block_signature(
                store.get_block_by_number(1).encode()))
            msg = m.GossipMessage(
                nonce=1, channel=channel_id.encode(),
                data_msg=m.DataMessage(payload=m.GossipPayload(
                    seq_num=1, data=evil.encode())))
            other.comm.broadcast([e for e in endpoints
                                  if e != other.endpoint], msg)
            if tags.rejections != GOSSIP_PEERS - 1 or any(
                    n.state.buffer.missing_range() is not None
                    or c.ledger.height != 1 for n, c in zip(nodes, channels)):
                raise AssertionError(f"{tags.rejections} peers rejected the "
                                     "tampered block")

            # the spread: the leader delivers, pushes; the rest follow
            def heights():
                return [c.ledger.height for c in channels]
            for s in services:
                s.start()

            def wait_height(h):
                deadline = time.monotonic() + GOSSIP_TIMEOUT_S
                while min(heights()) < h:
                    errors = [e for s in services for e in s.errors] + [
                        e for n in nodes for e in n.state.errors]
                    if errors:
                        raise errors[0]
                    if time.monotonic() > deadline:
                        raise AssertionError(f"heights {sorted(heights())}")
                    time.sleep(0.005)
                return time.perf_counter()
            before_last = wait_height(n_blocks)
            spread_s = before_last - source.first_at
            mid_sent = sent.sent
            wall_ms, n_k, busy_ms, top = device_profile(
                torch, lambda: (source.release.set(),
                                wait_height(n_blocks + 1)))
            done = time.perf_counter()
            for n in nodes:
                n.state.flush(E2E_TIMEOUT_S)
            counts = kernel_counts()
            wall_s = done - source.first_at

            # every peer: the chain, arm (a)'s flags and state
            for i, c in enumerate(channels):
                if c.ledger.height != n_blocks + 1:
                    raise AssertionError(f"peer {i} at {c.ledger.height}")
                for b in range(1, n_blocks + 1):
                    got = c.ledger.get_block_by_number(b)
                    want = store.get_block_by_number(b)
                    slot = m.BlockMetadataIndex.SIGNATURES
                    if protoutil.block_header_hash(got.header) != \
                            protoutil.block_header_hash(want.header) or \
                            bytes(got.metadata.metadata[slot]) != \
                            bytes(want.metadata.metadata[slot]):
                        raise AssertionError(f"peer {i} block {b} is not "
                                             "the orderer's")
                    flags = list(protoutil.block_txflags(got))
                    if flags != flat[(b - 1) * TX_PER_BLOCK:b * TX_PER_BLOCK]:
                        raise AssertionError(f"peer {i} block {b}: txflags "
                                             "differ from arm (a)'s")
                if c.ledger.state_fingerprint() != want_fp:
                    raise AssertionError(f"peer {i}: state fingerprint "
                                         "differs from arm (a)'s")
            errors = [e for s in services for e in s.errors] + [
                e for n in nodes for e in n.state.errors]
            if errors:
                raise errors[0]
            if services[lead].client is None or any(
                    s.client is not None for i, s in enumerate(services)
                    if i != lead):
                raise AssertionError("a peer other than the leader pulled")
            require_launched({k: counts[k] for k in (
                "verify_prologue", "ladder_projective", "verify_epilogue")},
                "the gossip network")
            spread_calls = {k: calls[k] - join_calls[k] for k in calls}
            direct = GOSSIP_ALIVE_SENDERS * (GOSSIP_PEERS - 1)
            log(f"gossip (b) {GOSSIP_PEERS} peers over one "
                f"BatchingVerifyService on the card: the orderer "
                f"ordered phase 8's stream's first {n_blocks} blocks "
                f"({n_blocks} x {TX_PER_BLOCK} txs) in {ordered_s:.1f} s; "
                f"peers built in {built_s:.1f} s; membership: views "
                f"seeded with the {GOSSIP_PEERS - GOSSIP_ALIVE_SENDERS} "
                f"quiet peers, then a signed alive round from "
                f"{GOSSIP_ALIVE_SENDERS} peers in {join_s:.1f} s (each in "
                f"every view after it), "
                f"{join_sent} envelopes sent "
                f"({direct} direct, {join_sent - direct} forwarded), verify "
                f"calls {join_calls}; the tampered block 1 rejected by all "
                f"{tags.rejections} peers it reached")
            head = n_blocks - 1
            log(f"gossip (b) spread: leader gossip{lead} (the minimum "
                f"PKI-ID, static); {n_blocks} blocks to {GOSSIP_PEERS} peers "
                f"in {wall_s:.2f} s from the first delivered block to the "
                f"last peer's last commit "
                f"({GOSSIP_PEERS * n_blocks / wall_s:.1f} peer-blocks "
                f"committed/s; blocks 1-{head} unprofiled {spread_s:.2f} s, "
                f"{GOSSIP_PEERS * head / spread_s:.1f} peer-blocks/s); "
                f"gossip envelopes sent {sent.sent - join_sent} "
                f"({mid_sent - join_sent} for blocks 1-{head}); verify "
                f"calls {spread_calls} (envelope, MCS, commit); calls into "
                f"the GpuVerifier {len(sizes)} (join and spread), mean "
                f"cohort {sum(sizes) / len(sizes):.2f} items (max "
                f"{max(sizes)}); kernel launches {counts}; every peer at "
                f"height {n_blocks + 1} with arm (a)'s txflags and state "
                f"({want_fp[:16]}), no error kept, no tampered block taken")
            small = [k for k in sizes if k < 64]
            log(f"gossip (b) calls into the GpuVerifier by size: "
                f"{sizes.count(1)} of {len(sizes)} carry one item (the "
                f"serial envelope and MCS checks), median "
                f"{sorted(sizes)[len(sizes) // 2]}, {len(sizes) - len(small)} "
                f"of 64 items or more (commit groups); mean of the others "
                f"{sum(small) / max(1, len(small)):.2f}")
            log_profile(f"gossip (b) block {n_blocks}'s spread to "
                        f"{GOSSIP_PEERS} peers", wall_ms, n_k, busy_ms, top)
            figures = {
                "wall_s": wall_s,
                "peer_blocks_s": GOSSIP_PEERS * n_blocks / wall_s,
                "envelopes": sent.sent - join_sent,
                "mcs_per_peer_block": spread_calls["mcs"] / (
                    GOSSIP_PEERS * n_blocks)}
        finally:
            # the leader first: no push races the others' teardown
            if lead is not None and services:
                services[lead].stop()
            for i, s in enumerate(services):
                if i != lead:
                    s.stop()
            for n in nodes:
                n.stop()
            for c in channels:
                c.close()
            for mg in mgrs:
                mg.close()
            service.close()
            net.close()
    log(f"gossip (b) phase: {time.perf_counter() - t_phase:.1f} s wall")
    return counts, figures


# --- phase 11: deliver fan-out and dissemination trees ----------------------

def _relay_channel(root, name, genesis_raw, verifier):
    """A peer's ledger and Channel (tensor policy, a commit pipe of depth
    2) over the genesis block, `verifier` its verifier."""
    from fabric_mod_tpu_torch.bccsp import sw
    from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
    from fabric_mod_tpu_torch.ledger.kvledger import LedgerManager
    from fabric_mod_tpu_torch.peer.channel import Channel
    from fabric_mod_tpu_torch.protos import messages as m
    genesis = m.Block.decode(genesis_raw)
    cid, config = config_from_block(genesis)
    csp = sw.SwCSP()
    mgr = LedgerManager(os.path.join(root, name))
    channel = Channel(cid, mgr.create_or_open(cid), verifier,
                      Bundle(cid, config, csp), csp, tensor_policy=True,
                      pipeline_depth=2)
    channel.init_from_genesis(genesis)
    return mgr, channel


class RelayPeers:
    """`material.gossip_peers` relay-mode gossip peers over one in-process
    network, composed as bench.py:2229 `_build_relay_world` does: each a
    ledger, Channel (tensor policy, commit pipe of depth 2), GossipNode,
    RelayService (`degree`, `queue_cap`) and GossipService with that
    relay, the leadership pinned to the minimum (PKI-ID, endpoint) peer.
    Membership and each peer's tree parent's identity are seeded (no alive
    round); the anti-entropy tick runs every RELAY_ANTI_ENTROPY_S.  Every
    channel's verifier is `service`, whose calls `tags` tags; every frame
    a relay verified is tapped."""

    def __init__(self, root, material, service, tags, source_factory,
                 degree=4, queue_cap=64):
        from fabric_mod_tpu_torch.bccsp import sw
        from fabric_mod_tpu_torch.dissemination import RelayService
        from fabric_mod_tpu_torch.gossip import (GossipNode, GossipService,
                                                 InProcNetwork)
        from fabric_mod_tpu_torch.msp.identities import (SigningIdentity,
                                                         deserialize_cert)
        from fabric_mod_tpu_torch.protos import messages as m
        self.fabric = InProcNetwork()
        self.sent = _CountingNetwork(self.fabric)
        self.mgrs, self.channels, self.nodes = [], [], []
        self.relays, self.taps, self.services = [], [], []
        self.streams = []
        self.lead = None
        for i, (mspid, cert_pem, key_pem) in enumerate(material.gossip_peers):
            mgr, channel = _relay_channel(root, f"relay{i}", material.genesis,
                                          service)
            self.mgrs.append(mgr)
            channel.mcs.verify_block = tags.tagging(
                "mcs", channel.mcs.verify_block)
            self.channels.append(channel)
            node = GossipNode(f"gossip{i}:7051", SigningIdentity(
                mspid, deserialize_cert(cert_pem), key_pem, sw.SwCSP()),
                channel, self.fabric)
            node.mapper.verify = tags.tagging("envelope", node.mapper.verify)
            self.nodes.append(node)
            relay = RelayService(node, degree=degree, queue_cap=queue_cap)
            tap = []
            relay.relay.on_deliver = \
                lambda num, frame, acc=tap: acc.append((num, frame))
            self.relays.append(relay)
            self.taps.append(tap)
        nodes = self.nodes
        for node in nodes:
            for other in nodes:
                if other is not node:
                    node.discovery.handle_alive(other.pki_id, m.AliveMessage(
                        membership=m.GossipMember(endpoint=other.endpoint,
                                                  pki_id=other.pki_id),
                        timestamp=m.PeerTime(inc_num=1, seq_num=1)))
        self.lead = min(range(len(nodes)),
                        key=lambda i: (nodes[i].pki_id, nodes[i].endpoint))
        self.tree = self.relays[self.lead].tree()
        self.by_ep = {nd.endpoint: nd for nd in nodes}
        for node in nodes:
            parent = self.tree.parent(node.endpoint)
            if parent is not None:
                # the one inbound signer a peer must verify
                node.mapper.put(self.by_ep[parent]._identity)

        def factory():
            src = source_factory()
            self.streams.append(src)
            return src
        for i, (node, relay) in enumerate(zip(nodes, self.relays)):
            self.services.append(GossipService(
                node, factory, static_leader=(i == self.lead), relay=relay))
            # pinned before GossipService.start's idempotent start
            node.state.start(interval_s=RELAY_ANTI_ENTROPY_S)

    def start_children(self):
        for i, s in enumerate(self.services):
            if i != self.lead:
                s.start()

    def heights(self):
        return [c.ledger.height for c in self.channels]

    def errors(self):
        return ([e for s in self.services for e in s.errors]
                + [e for nd in self.nodes for e in nd.state.errors]
                + [e for r in self.relays for e in r.errors])

    def wait_height(self, h, timeout_s):
        deadline = time.monotonic() + timeout_s
        while min(self.heights()) < h:
            errors = self.errors()
            if errors:
                raise errors[0]
            if time.monotonic() > deadline:
                raise AssertionError(f"heights {sorted(self.heights())[:8]}")
            time.sleep(0.005)
        return time.perf_counter()

    def stats(self) -> dict:
        return {k: sum(r.stats[k] for r in self.relays) for k in (
            "pushed", "forwarded", "received", "dropped", "send_failures",
            "repair_prods", "duplicates")}

    def close(self):
        # the root first: no push races the others' teardown
        if self.lead is not None and self.services:
            self.services[self.lead].stop()
        for i, s in enumerate(self.services):
            if i != self.lead:
                s.stop()
        for nd in self.nodes:
            nd.stop()
        for c in self.channels:
            c.close()
        for mg in self.mgrs:
            mg.close()


def phase_dissemination(torch, dev):
    """Phase 11 (a): bench.py:2383 `measure_dissemination`'s top point on
    the card.  A solo network orders RELAY_BLOCKS one-put blocks (each put
    submitted once the previous block is cut).  The all-pull arm first:
    RELAY_PEERS peers, each its own DeliverClient on its own orderer
    stream; its first peer's ledger encodes the byte-identity oracle.  Then
    the relay arm: RELAY_PEERS relay-mode peers (RelayPeers, degree
    RELAY_DEGREE), the pinned leader the only one that pulls.  In both
    arms every channel's verifier is one BatchingVerifyService over one
    GpuVerifier (no memo-cache: a peer verifies its own traffic).  Both
    arms' sources hold the last block until the others are in everywhere,
    so their rates cover the same blocks; the relay arm's last block runs
    under torch.profiler.  Gates: 1 orderer stream in the relay arm and
    RELAY_PEERS in the pull arm; every non-leader took the whole chain
    through the tree, every frame byte-identical to the pull arm's
    encoding; one state fingerprint across both arms; a copy of block 1
    with a flipped orderer-signature byte, relayed to a leaf by its
    parent, rejected by the MCS; no error kept.  Returns the kernels'
    launches of both arms."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import gpu, sw
    from fabric_mod_tpu_torch.orderer import DeliverService
    from fabric_mod_tpu_torch.peer.deliverclient import DeliverClient
    from fabric_mod_tpu_torch.peer.fanout import encode_frame
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.utils import fixtures
    t_phase = time.perf_counter()
    material = fixtures.make_network_material(
        SEED + 11, max_message_count=RELAY_BATCH_TXS,
        batch_timeout=RELAY_BATCH_TIMEOUT, gossip_peers=RELAY_PEERS)
    n, last = RELAY_PEERS, RELAY_BLOCKS
    with tempfile.TemporaryDirectory() as root:
        net = e2e.Network(os.path.join(root, "orderer"), material=material,
                          verifier=sw.SwVerifier())
        card = gpu.GpuVerifier(device=dev, cache_size=0)
        service = gpu.BatchingVerifyService(card)
        pulls, world = [], None
        try:
            store = net.support.store
            for i in range(last):
                net.broadcast.submit(_put_envelope(net, b"dk%d" % i,
                                                   b"dv%d" % i))
                deadline = time.monotonic() + E2E_TIMEOUT_S
                while store.height < i + 2:
                    if time.monotonic() > deadline:
                        raise AssertionError(f"orderer height {store.height}")
                    time.sleep(0.002)
            txs = [len(store.get_block_by_number(b).data.data)
                   for b in range(1, store.height)]
            if txs != [1] * last:
                raise AssertionError(f"a chain of {txs} txs")
            cid = net.channel_id
            tags = VerifyCallTags(service)
            sizes = _cohorts(card)
            reset_kernel_counts()
            ordered_s = time.perf_counter() - t_phase

            # -- the all-pull arm: its ledgers are the oracle ------------
            t0 = time.perf_counter()
            gate = threading.Event()

            def pull_source():
                src = _GatedSource(DeliverService(net.support), last)
                src.release = gate
                return src
            for i in range(n):
                mgr, channel = _relay_channel(root, f"pull{i}",
                                              material.genesis, service)
                channel.mcs.verify_block = tags.tagging(
                    "mcs", channel.mcs.verify_block)
                pulls.append((mgr, channel, DeliverClient(channel,
                                                          pull_source())))
            pull_built_s = time.perf_counter() - t0
            errors = []

            def run(client):
                try:
                    client.run(idle_timeout_s=E2E_TIMEOUT_S)
                except Exception as e:     # re-raised below
                    errors.append(e)

            def pull_heights():
                return [c.ledger.height for _, c, _ in pulls]

            def wait_pulls(h):
                deadline = time.monotonic() + RELAY_TIMEOUT_S
                while min(pull_heights()) < h:
                    if errors:
                        raise errors[0]
                    if time.monotonic() > deadline:
                        raise AssertionError(
                            f"pull heights {sorted(pull_heights())[:8]}")
                    time.sleep(0.005)
                return time.perf_counter()
            threads = [threading.Thread(target=run, args=(c,), daemon=True)
                       for _, _, c in pulls]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            pull_s = wait_pulls(last) - t0
            gate.set()
            wait_pulls(last + 1)
            for _, _, c in pulls:
                c.stop()
            for t in threads:
                t.join(timeout=60)
            if errors:
                raise errors[0]
            if any(c.rejected for _, _, c in pulls):
                raise AssertionError("a pull peer's MCS rejected a block")
            pull_calls = dict(tags.calls)
            pull_cohorts = list(sizes)
            ref = pulls[0][1].ledger
            refs = {num: encode_frame(cid, "full",
                                      ref.get_block_by_number(num))
                    for num in range(1, last + 1)}
            fps = {c.ledger.state_fingerprint() for _, c, _ in pulls}
            if len(fps) != 1:
                raise AssertionError(f"{len(fps)} pull-arm fingerprints")

            # -- the relay arm -------------------------------------------
            t0 = time.perf_counter()
            world = RelayPeers(
                root, material, service, tags,
                lambda: _GatedSource(DeliverService(net.support), last),
                degree=RELAY_DEGREE, queue_cap=RELAY_QUEUE)
            relay_built_s = time.perf_counter() - t0
            tree, lead = world.tree, world.lead
            depth = max(tree.depth(e) for e in tree.order)
            world.start_children()
            # a tampered block 1, relayed to a leaf by its parent
            leaf_ep = tree.order[-1]
            leaf = next(i for i, nd in enumerate(world.nodes)
                        if nd.endpoint == leaf_ep)
            parent = world.by_ep[tree.parent(leaf_ep)]
            evil = m.Block.decode(fixtures.tamper_block_signature(
                store.get_block_by_number(1).encode()))
            env = parent.comm.sign_once(m.GossipMessage(
                channel=cid.encode(), relay_msg=m.RelayMessage(
                    seq_num=1, frame=encode_frame(cid, "full", evil))))
            before = tags.rejections
            if not parent.comm.send_signed(leaf_ep, env) or \
                    tags.rejections != before + 1 or world.taps[leaf] or \
                    world.relays[leaf].stats["received"] != 1 or \
                    world.channels[leaf].ledger.height != 1:
                raise AssertionError("the leaf took the tampered frame")
            if world.errors():
                raise world.errors()[0]
            calls0, cohorts0 = dict(tags.calls), len(sizes)
            sent0 = world.sent.sent
            t0 = time.perf_counter()
            world.services[lead].start()
            relay_s = world.wait_height(last, RELAY_TIMEOUT_S) - t0
            mid_sent = world.sent.sent - sent0
            wall_ms, n_k, busy_ms, top = device_profile(
                torch, lambda: (world.streams[0].release.set(),
                                world.wait_height(last + 1,
                                                  RELAY_TIMEOUT_S)))
            for nd in world.nodes:
                nd.state.flush(E2E_TIMEOUT_S)
            torch.cuda.synchronize()
            counts = kernel_counts()

            # -- the gates -------------------------------------------------
            errors = world.errors()
            if errors:
                raise errors[0]
            if len(world.streams) != 1 or len(pulls) != n:
                raise AssertionError(f"orderer streams: relay "
                                     f"{len(world.streams)}, pull {len(pulls)}")
            if any(s.client is not None for i, s in enumerate(world.services)
                   if i != lead):
                raise AssertionError("a peer other than the leader pulled")
            for i, tap in enumerate(world.taps):
                got = dict(tap)
                if i == lead:
                    if got:
                        raise AssertionError("the root received frames")
                    continue
                if set(got) != set(refs):
                    raise AssertionError(f"peer {i} got frames {sorted(got)}")
                for num, frame in got.items():
                    if frame != refs[num]:
                        raise AssertionError(f"peer {i} frame {num} differs "
                                             "from the direct pull's")
            fps |= {c.ledger.state_fingerprint() for c in world.channels}
            if len(fps) != 1 or min(world.heights()) != last + 1:
                raise AssertionError(f"{len(fps)} fingerprints over both arms")
            require_launched({k: counts[k] for k in (
                "verify_prologue", "ladder_projective", "verify_epilogue")},
                "phase 11 (a)")
            relay_calls = {k: tags.calls[k] - calls0[k] for k in tags.calls}
            relay_cohorts = sizes[cohorts0:]
            stats = world.stats()
            pull_rate = (last - 1) * n / pull_s
            relay_rate = (last - 1) * n / relay_s
            log(f"dissemination (a) {n} peers x {last} one-tx blocks (ordered "
                f"in {ordered_s:.1f} s; peers built in {pull_built_s:.1f} / "
                f"{relay_built_s:.1f} s): all-pull {pull_rate:.1f} vs relay "
                f"{relay_rate:.1f} blocks*peers/s over blocks 1-{last - 1} "
                f"({relay_rate / pull_rate:.2f}x); orderer streams 1 vs {n}; "
                f"tree degree {RELAY_DEGREE}, depth {depth}, root gossip{lead}")
            log(f"dissemination (a) relay stats {stats}; envelopes sent "
                f"{world.sent.sent - sent0} ({mid_sent} for blocks 1-"
                f"{last - 1}); verify calls: pull arm {pull_calls}, relay "
                f"arm {relay_calls} (envelope, MCS, commit)")
            for label, cohorts in (("pull", pull_cohorts),
                                   ("relay", relay_cohorts)):
                log(f"dissemination (a) {label} arm: {len(cohorts)} calls "
                    f"into the GpuVerifier, mean cohort "
                    f"{sum(cohorts) / max(1, len(cohorts)):.2f} items (max "
                    f"{max(cohorts, default=0)}, "
                    f"{sum(1 for k in cohorts if k == 1)} of one item)")
            log(f"dissemination (a) every non-leader took blocks 1-{last} "
                f"through the tree, each frame == the pull arm's encoding; one "
                f"state fingerprint over {2 * n} peers ({fps.pop()[:16]}); the "
                f"tampered block 1 relayed to leaf gossip{leaf} rejected by "
                f"its MCS; kernel launches {counts}")
            log_profile(f"dissemination (a) block {last}'s relay to {n} peers",
                        wall_ms, n_k, busy_ms, top)
        finally:
            if world is not None:
                world.close()
            for mgr, channel, client in pulls:
                client.stop()
                channel.close()
                mgr.close()
            service.close()
            net.close()
    log(f"dissemination (a) phase: {time.perf_counter() - t_phase:.1f} s wall")
    return counts


def phase_relay_gossip(torch, dev, stream, fingerprint, gossip_figures):
    """Phase 11 (b): phase 10 (b)'s world with the relay in place of the
    epidemic push.  A solo network orders the same first GOSSIP_BLOCKS x
    TX_PER_BLOCK txs of phase 8 arm (a)'s stream; GOSSIP_PEERS relay-mode
    peers (RelayPeers at the reference's defaults) over one
    BatchingVerifyService on one GpuVerifier, membership seeded (no alive
    round).  Every peer must reach the orderer's height with arm (a)'s
    flags and phase 10 (b)'s state, and keep no error.  Prints the spread
    beside phase 10 (b)'s from the same run.  Returns the kernels'
    launches."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import gpu, sw
    from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
    from fabric_mod_tpu_torch.orderer import BroadcastError, DeliverService
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    from fabric_mod_tpu_torch.utils import fixtures
    t_phase = time.perf_counter()
    submits, flat = stream
    n_blocks = GOSSIP_BLOCKS
    n_tx = n_blocks * TX_PER_BLOCK
    material = fixtures.make_network_material(
        SEED, max_message_count=TX_PER_BLOCK, batch_timeout=E2E_BATCH_TIMEOUT,
        preferred_max_bytes=E2E_PREFERRED_MAX_BYTES,
        gossip_peers=GOSSIP_PEERS)
    with tempfile.TemporaryDirectory() as root:
        net = e2e.Network(os.path.join(root, "orderer"), material=material,
                          verifier=sw.SwVerifier())
        card = gpu.GpuVerifier(device=dev)
        service = gpu.BatchingVerifyService(card)
        world = None
        try:
            accepted = 0
            for env, ok in submits:
                if accepted == n_tx:
                    break
                try:
                    net.broadcast.submit(env)
                except BroadcastError:
                    if ok:
                        raise
                    continue
                accepted += 1
            store = net.support.store
            deadline = time.monotonic() + E2E_TIMEOUT_S
            while store.height < n_blocks + 1:
                if time.monotonic() > deadline:
                    raise AssertionError(f"orderer height {store.height}")
                time.sleep(0.01)
            oracle = KvLedger(net.channel_id)
            genesis = m.Block.decode(material.genesis)
            oracle.commit_block(genesis, [m.TxValidationCode.VALID]
                                * len(genesis.data.data))
            for b in range(1, n_blocks + 1):
                oracle.commit_block(store.get_block_by_number(b),
                                    flat[(b - 1) * TX_PER_BLOCK:
                                         b * TX_PER_BLOCK])
            want_fp = oracle.state_fingerprint()
            oracle.close()
            if fingerprint is not None and len(flat) == n_tx and \
                    want_fp != fingerprint:
                raise AssertionError("the replayed state differs from arm "
                                     "(a)'s")
            tags = VerifyCallTags(service)
            # gate_at 0: no block is held, the source only notes its first
            world = RelayPeers(
                root, material, service, tags,
                lambda: _GatedSource(DeliverService(net.support), 0))
            reset_kernel_counts()
            sizes = _cohorts(card)
            world.start_children()
            world.services[world.lead].start()
            done = world.wait_height(n_blocks + 1, GOSSIP_TIMEOUT_S)
            for nd in world.nodes:
                nd.state.flush(E2E_TIMEOUT_S)
            counts = kernel_counts()
            wall_s = done - world.streams[0].first_at
            for i, c in enumerate(world.channels):
                for b in range(1, n_blocks + 1):
                    flags = list(protoutil.block_txflags(
                        c.ledger.get_block_by_number(b)))
                    if flags != flat[(b - 1) * TX_PER_BLOCK:b * TX_PER_BLOCK]:
                        raise AssertionError(f"peer {i} block {b}: txflags "
                                             "differ from arm (a)'s")
                if c.ledger.state_fingerprint() != want_fp:
                    raise AssertionError(f"peer {i}: state fingerprint "
                                         "differs from arm (a)'s")
            errors = world.errors()
            if errors:
                raise errors[0]
            require_launched({k: counts[k] for k in (
                "verify_prologue", "ladder_projective", "verify_epilogue")},
                "phase 11 (b)")
            peer_blocks = GOSSIP_PEERS * n_blocks
            g = gossip_figures
            beside = ("phase 10 (b) did not run" if g is None else
                      f"phase 10 (b) in this run: {g['wall_s']:.2f} s, "
                      f"{g['peer_blocks_s']:.2f} peer-blocks/s, "
                      f"{g['envelopes']} envelopes, "
                      f"{g['mcs_per_peer_block']:.2f} MCS checks a peer-block")
            log(f"dissemination (b) {GOSSIP_PEERS} relay peers, {n_blocks} x "
                f"{TX_PER_BLOCK}-tx blocks (tree degree "
                f"{world.relays[0]._degree}, depth "
                f"{max(world.tree.depth(e) for e in world.tree.order)}): "
                f"spread {wall_s:.2f} s from the first delivered block to the "
                f"last peer's commit, {peer_blocks / wall_s:.2f} "
                f"peer-blocks/s, {world.sent.sent} envelopes sent, "
                f"{tags.calls['mcs'] / peer_blocks:.2f} MCS checks a "
                f"peer-block; {beside}")
            log(f"dissemination (b) relay stats {world.stats()}; verify calls "
                f"{tags.calls}; {len(sizes)} calls into the GpuVerifier, mean "
                f"cohort {sum(sizes) / max(1, len(sizes)):.2f} items; kernel "
                f"launches {counts}; every peer at height {n_blocks + 1} with "
                f"arm (a)'s txflags and state ({want_fp[:16]}), no error kept")
        finally:
            if world is not None:
                world.close()
            service.close()
            net.close()
    log(f"dissemination (b) phase: {time.perf_counter() - t_phase:.1f} s wall")
    return counts


class _RevealLedger:
    """A ledger-shaped replay source (bench.py:2002): a built chain
    revealed block by block."""

    def __init__(self, blocks):
        self._blocks = blocks
        self._revealed = 0
        self.height_changed = threading.Condition()

    @property
    def height(self):
        return self._revealed

    def get_block_by_number(self, num):
        if 0 <= num < self._revealed:
            return self._blocks[num]
        return None

    def reveal(self):
        self._revealed += 1
        with self.height_changed:
            self.height_changed.notify_all()


def phase_fanout(torch, dev):
    """Phase 11 (c): bench.py:2027 `measure_deliverfanout`'s top point.
    The fan-out chain (fixtures.make_fanout_chain) revealed block by block
    to FANOUT_SUBSCRIBERS subscribers, half full and half filtered, over
    FANOUT_WORKERS threads, through one FanoutEngine whose session ACL is
    an ACLProvider over the channel's bundle with the card's GpuVerifier
    as its verify_many; the seeks are signed by FANOUT_GROUPS real client
    identities (one group each).  The config block's commit moves the
    bundle's sequence.  Gates: every stream's digest equals the
    per-stream batch=False encoding's; one materialization and one encode
    per (block, form), no fallback; the ACL checks between the number of
    groups and twice that.  Returns the kernels' launches (the ACL
    checks')."""
    import hashlib
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import gpu, sw
    from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
    from fabric_mod_tpu_torch.peer.aclmgmt import ACLProvider
    from fabric_mod_tpu_torch.peer.fanout import FanoutEngine, encode_frame
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos.protoutil import SignedData
    from fabric_mod_tpu_torch.utils import fixtures
    t_phase = time.perf_counter()
    material = fixtures.make_network_material(SEED + 12)
    cid, config = config_from_block(m.Block.decode(material.genesis))
    csp = sw.SwCSP()
    moved = m.Config.decode(config.encode())
    moved.sequence = config.sequence + 1
    bundles = [Bundle(cid, config, csp)]
    next_bundle = Bundle(cid, moved, csp)
    card = gpu.GpuVerifier(device=dev, cache_size=0)
    acl = ACLProvider(lambda: bundles[-1], card.verify_many)
    signers = [material.client] + [material.peers[o]
                                   for o in ("Org1", "Org2", "Org3")]
    sds = []
    for i, pems in enumerate(signers[:FANOUT_GROUPS]):
        ident = e2e._signer(csp, pems)
        data = b"seek-info-%d" % i
        sds.append(SignedData(data=data, identity=ident.serialize(),
                              signature=ident.sign_message(data)))
    blocks = fixtures.make_fanout_chain(cid)
    n_blocks, n_subs = len(blocks), FANOUT_SUBSCRIBERS
    config_at = fixtures.FANOUT_CONFIG_AT
    refs = {}
    for form in ("full", "filtered"):
        h = hashlib.sha256()
        for blk in blocks:
            h.update(encode_frame(cid, form, blk, batch=False))
        refs[form] = h.hexdigest()
    led = _RevealLedger(blocks)
    eng = FanoutEngine(cid, led, acl, ring_size=max(128, n_blocks))
    forms = ["full" if i % 2 else "filtered" for i in range(n_subs)]
    seq0 = acl.config_sequence()
    sessions = [eng.acl_groups.join(
        "event/Block" if forms[i] == "full" else "event/FilteredBlock",
        sds[i % FANOUT_GROUPS], seq0) for i in range(n_subs)]
    for f in forms:
        eng.attach(f)
    digests = [hashlib.sha256() for _ in range(n_subs)]
    nexts = [0] * n_subs
    slices = [list(range(w, n_subs, FANOUT_WORKERS))
              for w in range(FANOUT_WORKERS)]
    errors = []
    log(f"fanout (c) fixtures: {n_blocks} blocks, {FANOUT_GROUPS} signed "
        f"seeks and the bundles in {time.perf_counter() - t_phase:.1f} s")

    def run_slice(idx):
        try:
            waiter = eng.notifier.waiter()
            pending = set(slices[idx])
            while pending:
                progress = False
                for s in list(pending):
                    while nexts[s] < n_blocks:
                        fr = eng.get_frame(forms[s], nexts[s])
                        if fr is None:
                            break
                        if fr.is_config:
                            sessions[s].recheck(force=True,
                                                config_mark=fr.num)
                        else:
                            sessions[s].recheck()
                        digests[s].update(fr.payload)
                        nexts[s] += 1
                        progress = True
                    if nexts[s] >= n_blocks:
                        pending.discard(s)
                if pending and not progress:
                    low = min(nexts[s] for s in pending)
                    if eng.notifier.wait_above(
                            low, waiter, timeout_s=60.0) == "timeout":
                        raise RuntimeError("fanout stall")
            eng.notifier.release(waiter)
        except Exception as e:             # re-raised below
            errors.append(e)

    def pace():
        for b in range(n_blocks):
            if b == config_at:
                bundles.append(next_bundle)    # the config commit
            led.reveal()
            time.sleep(0.001)                  # sustained, not a batch

    reset_kernel_counts()
    workers = [threading.Thread(target=run_slice, args=(w,), daemon=True)
               for w in range(FANOUT_WORKERS)]
    t0 = time.perf_counter()
    pacer = threading.Thread(target=pace, daemon=True)
    pacer.start()
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=E2E_TIMEOUT_S)
    shared_s = time.perf_counter() - t0
    pacer.join(timeout=60)
    for f in forms:
        eng.detach(f)
    eng.close()
    torch.cuda.synchronize()
    counts = kernel_counts()
    if errors:
        raise errors[0]
    if any(w.is_alive() for w in workers) or eng.notifier.errors:
        raise AssertionError("a fan-out worker is still running or the "
                             "notifier kept an error")
    for i in range(n_subs):
        if digests[i].hexdigest() != refs[forms[i]]:
            raise AssertionError(f"stream {i} ({forms[i]}) differs from the "
                                 "per-stream encoding")
    for form in ("full", "filtered"):
        st = eng.stats[form]
        if st["materialized"] != n_blocks or st["encoded"] != n_blocks \
                or st["fallbacks"]:
            raise AssertionError(f"{form} ring {st}")
    n_groups, checks = len(eng.acl_groups), eng.acl_groups.stats["checks"]
    if not n_groups <= checks <= 2 * n_groups:
        raise AssertionError(f"{checks} ACL checks for {n_groups} groups")
    require_launched({k: counts[k] for k in (
        "verify_prologue", "ladder_projective", "verify_epilogue")},
        "phase 11 (c)")
    sample = min(n_subs, FANOUT_PER_STREAM_SAMPLE)
    t0 = time.perf_counter()
    for i in range(sample):
        h = hashlib.sha256()
        for blk in blocks:
            h.update(encode_frame(cid, forms[i], blk, batch=False))
        if h.hexdigest() != refs[forms[i]]:
            raise AssertionError("the per-stream arm is not deterministic")
    per_s = time.perf_counter() - t0
    shared_rate = n_blocks * n_subs / shared_s
    per_rate = n_blocks * sample / per_s
    log(f"fanout (c) {n_subs} subscribers x {n_blocks} blocks over "
        f"{FANOUT_WORKERS} workers: shared {shared_rate:.1f} vs per-stream "
        f"{per_rate:.1f} blocks*subs/s ({shared_rate / per_rate:.1f}x, "
        f"per-stream sample {sample}); every stream's digest == the "
        f"per-stream encoding's; rings {eng.stats}; ACL checks {checks} for "
        f"{n_groups} groups ({eng.acl_groups.stats['reuses']} reuses), each "
        f"one verify on the card; kernel launches {counts}; phase "
        f"{time.perf_counter() - t_phase:.1f} s wall")
    return counts


def mc_sweep() -> list:
    """bench.py:1857-1871's points: each axis varied through its values
    with the other two at their middle."""
    s_mid, c_mid, p_mid = MC_MIDDLE
    return sorted({(s, c_mid, p_mid) for s in MC_SLICES}
                  | {(s_mid, c, p_mid) for c in MC_CHANNEL_AXIS}
                  | {(s_mid, c_mid, p) for p in MC_RIDERS})


def counted_verifier(**kwargs):
    """A GpuVerifier counting the calls into it and their items."""
    from fabric_mod_tpu_torch.bccsp import gpu

    class Counted(gpu.GpuVerifier):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.calls = 0
            self.items = 0
            self._count_lock = threading.Lock()

        def _verify_async(self, items, keep_device):
            with self._count_lock:
                self.calls += 1
                self.items += len(items)
            return super()._verify_async(items, keep_device)
    return Counted(**kwargs)


def mc_target(world, cid, verifier):
    """A fresh channel commit target: the port's TxValidator (tensor
    policy) over `verifier` and a fresh durable ledger."""
    from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
    from fabric_mod_tpu_torch.peer.commitpipe import ValidatorCommitTarget
    from fabric_mod_tpu_torch.peer.txvalidator import (TxValidator,
                                                       ValidationInfoProvider)
    from fabric_mod_tpu_torch.policy import ApplicationPolicyEvaluator
    led = KvLedger(cid)
    return ValidatorCommitTarget(TxValidator(
        cid, world.mgr, ApplicationPolicyEvaluator(world.mgr), verifier,
        ValidationInfoProvider(world.policy), tx_id_exists=led.tx_id_exists,
        tensor_policy=True), led)


def mc_flags(ledger) -> list:
    from fabric_mod_tpu_torch.protos import protoutil
    return [list(protoutil.block_txflags(ledger.get_block_by_number(n)))
            for n in range(ledger.height)]


def mc_meshes(torch, s):
    """bench.py:1725-1731: slice meshes where the cards split evenly into
    `s`, else None (unmeshed: each slice its own GpuVerifier on the
    current card, its default stream)."""
    from fabric_mod_tpu_torch.parallel import slice_meshes
    n = torch.cuda.device_count()
    return slice_meshes(s) if s <= n and n % s == 0 else None


def kernel_intervals(torch, fn):
    """fn() under torch.profiler: (wall ms, [(start us, end us)] of the
    device kernels or None when none was recorded, {name: count} of the
    recorded device kernels)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    names: dict = {}
    for e in kernels:
        names[e.name] = names.get(e.name, 0) + 1
    return wall_ms, (spans or None), names


def recorded_launches(names: dict, key: str) -> int:
    """How many of the profiler's kernels are the hand-written kernel
    counted under `key` (its CUDA name is `key` + "_kernel")."""
    return sum(c for name, c in names.items()
               if name.startswith(f"{key}_kernel"))


def overlapping_kernels(spans) -> int:
    """How many kernels started before an earlier kernel had ended."""
    n, end = 0, None
    for lo, hi in spans:
        if end is not None and lo < end:
            n += 1
        end = hi if end is None else max(end, hi)
    return n


def mc_point(torch, world, streams, baseline, s, c, p, profile=False):
    """One point of the curve: `c` channels on `s` slices of one
    ChannelShardRouter (depth-2 pipes), their blocks submitted round
    robin while `p` riders verify 8 items every 20 ms through the shared
    service.  Gated before any rate: per channel, per-block flags and the
    fingerprint equal the independent run's; every rider verdict the
    construction's.  With `profile`, the last round runs under
    torch.profiler after the earlier rounds were flushed."""
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.sharding import ChannelShardRouter
    from fabric_mod_tpu_torch.utils import fixtures
    cids = sorted(streams)[:c]
    meshes = mc_meshes(torch, s)
    router = ChannelShardRouter(
        n_slices=s, meshes=meshes, depth=2,
        verifier_factory=lambda i, mesh: counted_verifier(
            mesh=mesh, cache_size=0) if mesh is not None
        else counted_verifier(cache_size=0))
    rider_items, rider_expect = fixtures.make_verify_items(
        MC_RIDER_ITEMS, invalid_every=3, seed=b"mc-rider")
    stop = threading.Event()
    rider_counts = [0] * p
    rider_errs: list = []

    def rider(k):
        i = k
        while not stop.is_set():
            cid = cids[i % len(cids)]
            try:
                got = router.service.verify_many_for(
                    cid, rider_items, timeout=MC_RIDER_TIMEOUT_S)
            except Exception as e:           # the gate below raises it
                rider_errs.append(f"rider {k}: {e!r}")
                return
            if got != rider_expect:
                rider_errs.append(f"rider {k}: verdicts {got} != "
                                  f"{rider_expect}")
                return
            rider_counts[k] += 1
            i += 1
            stop.wait(MC_RIDER_EVERY_S)

    riders = [threading.Thread(target=rider, args=(k,), daemon=True)
              for k in range(p)]
    targets = {}
    profiled = None
    try:
        for cid in cids:
            targets[cid] = mc_target(world, cid, router.add_channel(cid))
            router.bind_target(cid, targets[cid])
        for t in riders:
            t.start()

        def round_(n):
            for cid in cids:
                router.submit_block(cid, m.Block.decode(streams[cid][n]))
            if not router.flush(timeout_s=600):
                raise AssertionError("multichannel flush timed out")
        before = kernel_counts()
        t0 = time.perf_counter()
        for n in range(MC_BLOCKS - (1 if profile else 0)):
            round_(n)
        if profile:
            pre = kernel_counts()
            profiled = kernel_intervals(torch, lambda: round_(MC_BLOCKS - 1))
            post = kernel_counts()
            profiled += ({k: post[k] - pre[k] for k in post},)
        dt = time.perf_counter() - t0
        after = kernel_counts()
    finally:
        stop.set()
        for t in riders:
            t.join(timeout=MC_RIDER_TIMEOUT_S + 60)
        router.close()
    if any(t.is_alive() for t in riders):
        raise AssertionError("a rider outlived the point")
    if rider_errs:
        raise AssertionError(rider_errs[0])
    for cid in cids:
        led = targets[cid].ledger
        if mc_flags(led) != baseline[cid][0]:
            raise AssertionError(f"sharded txflags diverge from the "
                                 f"independent run on {cid}")
        if led.state_fingerprint() != baseline[cid][1]:
            raise AssertionError(f"sharded state fingerprint diverges on "
                                 f"{cid}")
    txs = c * MC_BLOCKS * MC_BLOCK_TXS
    return {
        "slices": s, "channels": c, "riders": p,
        "tx_per_sec": txs / dt,
        "rider_verifies_per_sec": sum(rider_counts) * MC_RIDER_ITEMS / dt,
        "meshed": meshes is not None,
        "slice_calls": {i: (v.calls, v.items / max(v.calls, 1))
                        for i, v in router.verifiers.items()},
        "flushes": router.service.flushes,
        "groups": dict(router.service.groups),
        "launches": {k: after[k] - before[k] for k in after},
        "wall_s": dt,
        "profiled": profiled,
    }


def log_mc_point(pt) -> None:
    calls = ", ".join(f"slice {i}: {n} calls of {mean:.1f} items"
                      for i, (n, mean) in pt["slice_calls"].items())
    groups = ", ".join(f"{i}: {g}" for i, g in pt["groups"].items())
    # the profiled point's wall holds the profiler's own processing: no
    # rate is read from it
    rates = (f"{pt['tx_per_sec']:.1f} committed tx/s, "
             f"{pt['rider_verifies_per_sec']:.1f} rider verifies/s, "
             f"{pt['wall_s']:.3f} s" if pt["profiled"] is None
             else "profiled (no rate)")
    log(f"multichannel point slices={pt['slices']} channels="
        f"{pt['channels']} riders={pt['riders']}: {rates}, meshed="
        f"{pt['meshed']}; "
        f"GpuVerifier {calls}; shared service {pt['flushes']} flushes, "
        f"dispatch groups by slice {{{groups}}}; launches "
        f"{pt['launches']}")


def phase_multichannel(torch, dev):
    """Phase 12 (a): bench.py:1677's multichannel curve on the card.
    Returns the kernel counts of the sweep and the profiled point."""
    from fabric_mod_tpu_torch.utils import fixtures
    t0 = time.perf_counter()
    world = fixtures.make_commit_world()
    streams = {f"mc{c}": fixtures.make_channel_stream(
        world.signers, f"mc{c}", MC_BLOCKS, MC_BLOCK_TXS)
        for c in range(MC_CHANNELS)}
    log(f"multichannel (a) streams: {MC_CHANNELS} channels x {MC_BLOCKS} "
        f"blocks x {MC_BLOCK_TXS} txs signed in "
        f"{time.perf_counter() - t0:.1f} s (pure-python signer)")
    # the oracle: an independent unsharded synchronous run a channel on
    # one GpuVerifier; the first run warms the card, the second is timed
    # and must agree with it
    oracle = lambda cid: mc_target(world, cid,                 # noqa: E731
                                   counted_verifier(cache_size=0))
    baseline = fixtures.independent_baseline(streams, oracle)
    timed = fixtures.independent_baseline(streams, oracle)
    for cid, (flags, fp, _) in baseline.items():
        if timed[cid][:2] != (flags, fp):
            raise AssertionError(f"two independent runs of {cid} differ")
    kinds = {f for flags, _, _ in baseline.values()
             for blk in flags for f in blk}
    from fabric_mod_tpu_torch.protos import messages as m
    V = m.TxValidationCode
    if kinds != {V.VALID, V.ENDORSEMENT_POLICY_FAILURE}:
        raise AssertionError(f"multichannel flags {kinds}: the stream "
                             "must hold VALID and ENDORSEMENT_POLICY_FAILURE")
    warm = mc_point(torch, world, streams, baseline, *mc_sweep()[0])
    log(f"multichannel warm point (untimed): {warm['wall_s']:.3f} s")
    reset_kernel_counts()
    points = []
    for s, c, p in mc_sweep():
        pt = mc_point(torch, world, streams, baseline, s, c, p)
        log_mc_point(pt)
        points.append(pt)
    prof = mc_point(torch, world, streams, baseline, *MC_PROFILED,
                    profile=True)
    counts = kernel_counts()
    require_launched({k: counts[k] for k in (
        "verify_prologue", "ladder_projective", "verify_epilogue")},
        "the multichannel router's slices")
    log_mc_point(prof)
    # vs_baseline at one fixed point, the sweep's middle: each point is
    # one pass, so the best of seven would read high
    mid = next(pt for pt in points
               if (pt["slices"], pt["channels"], pt["riders"]) == MC_MIDDLE)
    mid_cids = sorted(streams)[:mid["channels"]]
    serial = (mid["channels"] * MC_BLOCKS * MC_BLOCK_TXS
              / sum(timed[cid][2] for cid in mid_cids))
    log(f"multichannel: {mid['tx_per_sec']:.1f} tx/s at the middle point "
        f"slices={mid['slices']} channels={mid['channels']} riders="
        f"{mid['riders']}; serial independent {serial:.1f} tx/s over the "
        f"same {mid['channels']} channels (one GpuVerifier, one block at "
        f"a time); vs_baseline {mid['tx_per_sec'] / serial:.3f} (one pass "
        "each)")
    wall_ms, spans, names, launched = prof["profiled"]
    s, c, p = MC_PROFILED
    head = (f"profile multichannel slices={s} channels={c} riders={p}, last "
            f"round: wall {wall_ms:.1f} ms")
    if spans is None:
        log(f"{head}; device time not measured (the profiler recorded no "
            "device kernels)")
        return counts
    path = ("verify_prologue", "ladder_projective", "verify_epilogue")
    seen = {k: recorded_launches(names, k) for k in path}
    whole = all(seen[k] >= launched[k] for k in path)
    busy_ms = sum(hi - lo for lo, hi in spans) / 1e3
    recorded = ", ".join(f"{k} {seen[k]} of {launched[k]}" for k in path)
    if whole:
        times = (f"device busy {busy_ms:.1f} ms, device idle share "
                 f"{1 - busy_ms / wall_ms:.3f}")
    else:
        # kernels the profiler missed would add to busy: a lower bound
        times = (f"device busy >= {busy_ms:.1f} ms and device idle share "
                 f"<= {1 - busy_ms / wall_ms:.3f} (lower and upper bounds: "
                 "the profiler missed hand-written launches)")
    log(f"{head}, device kernels {len(spans)}; hand-written launches "
        f"recorded / made in the round: {recorded}; {times}; recorded "
        f"kernels that overlapped an earlier one: "
        f"{overlapping_kernels(spans)} (every slice enqueues on the card's "
        "default stream)")
    return counts


class _DownSlice:
    """A slice verifier whose every call raises."""

    def verify_many_async(self, items):
        raise RuntimeError("slice 0 verifier down (injected)")


def phase_multichannel_isolation(torch, dev):
    """Phase 12 (b): a raising slice fails only its own group in a flush
    window it shares with a card slice; a channel's block with flipped
    creator-signature bytes changes that channel's flags alone."""
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.sharding import (ChannelShardRouter,
                                               CrossChannelVerifyService,
                                               ShardMap)
    from fabric_mod_tpu_torch.utils import fixtures
    V = m.TxValidationCode
    shard_map = ShardMap(2)
    shard_map.assign("victim")
    shard_map.assign("bystander")
    card = counted_verifier(cache_size=0)
    service = CrossChannelVerifyService(
        {0: _DownSlice(), 1: card},
        lambda tag: shard_map.slice_of(tag, default=0), deadline_s=0.25)
    items, expect = fixtures.make_verify_items(MC_RIDER_ITEMS,
                                               invalid_every=3)
    try:
        victims = [service.submit(it, tag="victim") for it in items]
        riders = [service.submit(it, tag="bystander") for it in items]
        got = [f.result(timeout=60) for f in riders]
        failed = 0
        for f in victims:
            if isinstance(f.exception(timeout=60), RuntimeError):
                failed += 1
    finally:
        service.close()
    if got != expect or failed != len(victims) or service.flushes != 1 \
            or service.groups != {0: 1, 1: 1} or card.calls != 1:
        raise AssertionError(
            f"isolation (b): bystander verdicts {got == expect}, victims "
            f"failed {failed}/{len(victims)}, flushes {service.flushes}, "
            f"card calls {card.calls}")
    log(f"multichannel (b) one flush window: slice 0 raised for its "
        f"{failed} futures, slice 1's {len(got)} riders resolved to the "
        f"construction's verdicts on the card ({card.calls} call)")

    world = fixtures.make_commit_world()
    streams = {cid: fixtures.make_channel_stream(
        world.signers, cid, MC_BLOCKS, MC_BLOCK_TXS) for cid in ("ta", "tb")}
    base = fixtures.independent_baseline(
        streams, lambda cid: mc_target(world, cid,
                                       counted_verifier(cache_size=0)))
    block = m.Block.decode(streams["ta"][0])
    tampered = set(range(0, MC_BLOCK_TXS, MC_TAMPER_EVERY))
    for i in tampered:
        env = m.Envelope.decode(block.data.data[i])
        sig = bytearray(env.signature)
        sig[10] ^= 1                          # a bit of r: still strict DER
        block.data.data[i] = m.Envelope(payload=env.payload,
                                        signature=bytes(sig)).encode()
    router = ChannelShardRouter(n_slices=2, verifier_factory=(
        lambda i, mesh: counted_verifier(cache_size=0)))
    targets, a_flags, errs = {}, [], []
    try:
        for cid in streams:
            targets[cid] = mc_target(world, cid, router.add_channel(cid))
            router.bind_target(cid, targets[cid])

        def run_a():
            try:
                a_flags.append(router.store_block("ta", block))
                a_flags.append(router.store_block(
                    "ta", m.Block.decode(streams["ta"][1])))
            except Exception as e:            # raised below
                errs.append(e)
        t = threading.Thread(target=run_a, daemon=True)
        t.start()
        for raw in streams["tb"]:
            router.store_block("tb", m.Block.decode(raw))
        t.join(timeout=300)
    finally:
        router.close()
    if errs:
        raise errs[0]
    if t.is_alive() or len(a_flags) != 2:
        raise AssertionError("the tampered channel did not commit")
    want_a = [list(f) for f in base["ta"][0]]
    for i in tampered:
        want_a[0][i] = V.BAD_CREATOR_SIGNATURE
    b_run = (mc_flags(targets["tb"].ledger),
             targets["tb"].ledger.state_fingerprint())
    if [list(f) for f in a_flags] != want_a \
            or mc_flags(targets["ta"].ledger) != want_a:
        raise AssertionError("the tampered channel's flags are not its "
                             "independent run's with the tampered txs "
                             "BAD_CREATOR_SIGNATURE")
    if targets["ta"].ledger.state_fingerprint() == base["ta"][1]:
        raise AssertionError("the tampered channel's state did not change")
    if b_run != base["tb"][:2]:
        raise AssertionError("the other channel's flags or state moved")
    log(f"multichannel (b) tampered channel: {len(tampered)} of "
        f"{MC_BLOCK_TXS} txs of ta's block 0 BAD_CREATOR_SIGNATURE, the "
        f"rest and block 1 as its independent run; tb's flags and "
        f"fingerprint equal its independent run ({b_run[1][:16]})")


def phase_mesh_cards(torch):
    """Phase 12 (c), two or more cards only: GpuVerifier(mesh=data_mesh())
    over every card and each verifier of slice_meshes(2) against a
    one-card GpuVerifier on 2048 lanes with planted lanes."""
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.parallel import data_mesh, slice_meshes
    from fabric_mod_tpu_torch.utils import fixtures
    n = torch.cuda.device_count()
    if n < 2:
        log(f"multichannel (c): needs two CUDA cards, this machine has {n}: "
            "not run")
        return
    items, expect = fixtures.make_block(2, n_tx=MESH_LANES // 3 + 1,
                                        raw_endorsers=True)
    items, expect = items[:MESH_LANES], expect[:MESH_LANES]
    want = gpu.GpuVerifier(cache_size=0).verify_many(items)
    if want.tolist() != expect.tolist():
        raise AssertionError("one-card verdicts differ from the construction")
    meshes = [data_mesh()] + (slice_meshes(2) if n % 2 == 0 else [])
    for mesh in meshes:
        v = gpu.GpuVerifier(mesh=mesh, cache_size=0)
        fused = v.verify_many_fused_async(items)()
        if v.verify_many(items).tolist() != want.tolist() \
                or fused.device != mesh[0] \
                or fused.cpu().tolist() != want.tolist():
            raise AssertionError(f"mesh {mesh}: verdicts differ from one "
                                 "card's")
        log(f"multichannel (c) mesh {[str(d) for d in mesh]}: {MESH_LANES} "
            f"lanes equal one card's verdicts")


def phase_sharding(torch, dev):
    """Phase 12: (a) the curve, (b) isolation, (c) the mesh (two or more
    cards); the counts of (a)'s sweep."""
    t0 = time.perf_counter()
    counts = phase_multichannel(torch, dev)
    phase_multichannel_isolation(torch, dev)
    phase_mesh_cards(torch)
    log(f"sharding phase: {time.perf_counter() - t0:.1f} s wall")
    return counts


def pairing_launched(before: dict, where: str) -> dict:
    """The kernel launches since `before`; raise unless the idemix
    pairing's two kernels ran exactly once each and no other kernel
    ran."""
    from fabric_mod_tpu_torch.ops import fp256bn_cuda
    launched = {k: v - before.get(k, 0) for k, v in kernel_counts().items()}
    want = {k: int(k in fp256bn_cuda.KERNELS) for k in launched}
    if launched != want:
        raise AssertionError(f"{where}: kernel launches {launched}, "
                             f"expected {want}")
    return launched


def timed(torch, fn):
    """(fn()'s result, its wall ms around a synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def pairing_kernel_entry(torch, name, is_add, lanes, launch, plain_ms, err,
                         geom):
    """One idemix kernel's JSON entry at a check's width: its device ms
    (`launch()` queued behind a sleep), the bound, and the plain
    version's ms and the compare error `err` as measured; the log line
    adds the kernels' own work a lane and their geometry `geom`.  The
    bound counts the least multiply-adds of the reference's formulas and
    the kernels' own; `bound_ms_reference` is the bound on the
    reference's count alone (the figure earlier runs printed)."""
    from fabric_mod_tpu_torch.ops import fp256bn_cuda as cuda
    from fabric_mod_tpu_torch.ops import fp256bn_programs
    miller = name == "fp256bn_miller"
    ms = device_ms(torch, launch, reps=IDEMIX_REPS)
    per_lane = cuda.products_per_lane(is_add, name, check=True)
    madds = cuda.multiply_adds_per_lane(is_add, name, check=True)
    threads = 2 * lanes if miller else lanes
    clock = sm_clock_hz()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def ops_ms(per_thread):
        return (per_thread * threads
                / (INT_MADD_PER_SM_CLOCK * n_sm * clock) * 1e3)
    bound_ops = ops_ms(madds["least"])
    miller_bytes = 4 * 32 + 2 * 384       # the lane's points in, values out
    nbytes = (lanes * (miller_bytes if miller else 2 * 384 + 1)
              + (2 * (len(is_add) + 2) * 128 + 4 * len(is_add)
                 if miller else 0))
    bound_bytes = nbytes / PEAK_BYTES * 1e3
    entry = {
        "name": name, "route": "cuda",
        "source": "fabric_mod_tpu_torch/csrc/fp256bn_pairing.cu",
        "replaces": ("fabric_mod_tpu/ops/fp256bn_dev.py:339" if miller
                     else "fabric_mod_tpu/ops/fp256bn_dev.py:397"),
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bound_ops, bound_bytes),
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": None,
        "bound_ms_reference": max(ops_ms(madds["reference"]), bound_bytes),
    }
    own = fp256bn_programs.design_counts(is_add, name, check=True)
    lanes_block = geom["lanes_per_block"]
    blocks = (2 if miller else 1) * -(-lanes // lanes_block)
    per_sm = geom[name]["blocks_per_sm"]
    log(f"kernel {name}: equal to its plain version on the card at "
        f"{lanes} lanes (max abs err {err}); {ms:.3f} ms per launch (CUDA "
        f"events, {IDEMIX_REPS} launches behind a sleep), plain "
        f"{plain_ms:.1f} ms; bound {entry['bound_ms']:.4f} ms by "
        f"{entry['bound_by']} ({madds['least']} 32-bit multiply-adds a "
        f"{'(lane, schedule)' if miller else 'lane'}, the least of the "
        f"kernels' own {madds['design']} ({own['products']} Fp products "
        f"of which {own['squares']} squares at {cuda.MULTIPLY_ADDS} / "
        f"{cuda.SQUARE_MULTIPLY_ADDS}, {own['inverses']} divsteps inverse "
        f"counted by its last product, in {own['rounds']} product rounds) "
        f"and the reference's {madds['reference']} ({per_lane} Fp products "
        f"x {cuda.MULTIPLY_ADDS}), x {threads} at {INT_MADD_PER_SM_CLOCK}"
        f"/SM/clock x {n_sm} SMs x {clock / 1e6:.0f} MHz; bytes "
        f"{bound_bytes:.5f} ms); on the reference's count alone "
        f"{entry['bound_ms_reference']:.4f} ms; geometry: "
        f"{geom['group']} threads a lane, {lanes_block} lanes a block of "
        f"{geom['group'] * lanes_block} threads, {blocks} blocks on "
        f"{min(blocks, n_sm)} of {n_sm} SMs, "
        f"{blocks * geom['group'] * lanes_block / 32 / n_sm:.2f} warps an "
        f"SM on average ({per_sm} blocks an SM at most, "
        f"{geom[name]['smem']} bytes of shared memory a block); "
        "library_ms null (no PyTorch call computes a pairing)")
    return entry


def pairing_ragged(torch, cuda, pts, lines, is_add):
    """Both pairing kernels at IDEMIX_RAGGED's widths against their plain
    versions on the card: the Miller words, the check's verdicts and the
    pairing-mode words.  These launches are outside the counted path."""
    for n in IDEMIX_RAGGED:
        p = pts[..., :n].contiguous()
        f_k = cuda.miller(p, lines, is_add)
        if not torch.equal(f_k, cuda.miller_plain(p, lines, is_add)):
            raise AssertionError(f"fp256bn_miller differs from its plain "
                                 f"version at {n} lanes")
        if not torch.equal(cuda.final_exp(f_k, True),
                           cuda.final_exp_plain(f_k, True)):
            raise AssertionError(f"fp256bn_final_exp's verdicts differ from "
                                 f"its plain version at {n} lanes")
        one = f_k[:1].contiguous()
        if not torch.equal(cuda.final_exp(one, False),
                           cuda.final_exp_plain(one, False)):
            raise AssertionError(f"fp256bn_final_exp's pairing words differ "
                                 f"from its plain version at {n} lanes")
    log(f"idemix (a) both kernels equal to their plain versions at the "
        f"ragged widths {IDEMIX_RAGGED}: Miller words, verdicts and "
        "pairing-mode words")


def phase_idemix(torch, np):
    """The idemix presentation verify on the card (phase 7): (launch
    counts of its main path, the two pairing kernels' JSON entries)."""
    from fabric_mod_tpu_torch import device as _device
    from fabric_mod_tpu_torch.idemix import credential
    from fabric_mod_tpu_torch.idemix import fp256bn as host
    from fabric_mod_tpu_torch.ops import fp256bn_cuda as cuda
    from fabric_mod_tpu_torch.ops import fp256bn_dev as dev
    from fabric_mod_tpu_torch.utils import fixtures
    t_phase = time.perf_counter()
    world = fixtures.make_idemix_world(SEED)
    ik = world.issuer.key
    a_pts, abar_pts, expect = fixtures.make_pairing_lanes(
        world, IDEMIX_LANES, IDEMIX_TAMPER_EVERY, seed=SEED)
    neg = [p.neg() for p in abar_pts]
    log(f"idemix fixtures: world and {IDEMIX_LANES} pairing lanes in "
        f"{time.perf_counter() - t_phase:.1f} s")
    dev.reset_counts()
    launched = dict.fromkeys(kernel_counts(), 0)

    # (a) the full-width pairing check: the main path's launches
    def check():
        return dev.pairing_check_batch(a_pts, ik.W, neg, ik.g2, lazy=True)
    reset_kernel_counts()
    t0 = time.perf_counter()
    mask_t = check()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    for k, v in pairing_launched({}, "idemix (a) check").items():
        launched[k] += v
    if mask_t.device.type != "cuda":
        raise AssertionError(f"pairing check mask on {mask_t.device}")
    mask = mask_t.cpu().numpy()
    if not np.array_equal(mask, expect):
        bad = np.nonzero(mask != expect)[0][:8].tolist()
        raise AssertionError(f"pairing check differs from the construction "
                             f"at lanes {bad}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(IDEMIX_REPS):
        mask_t = check()
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / IDEMIX_REPS
    event_ms = start.elapsed_time(end) / IDEMIX_REPS
    if not torch.equal(mask_t.cpu(), torch.from_numpy(expect)):
        raise AssertionError("warm pairing check differs from the construction")
    plain_t, plain_check_ms = timed(torch, lambda: dev.pairing_check_plain(
        a_pts, ik.W, neg, ik.g2, lazy=True))
    if plain_t.device.type != "cuda" or not torch.equal(plain_t, mask_t):
        bad = (plain_t.cpu() != mask_t.cpu()).nonzero().flatten()[:8].tolist()
        raise AssertionError(f"pairing check differs from the plain version "
                             f"on the card at lanes {bad}")
    rng = np.random.default_rng(SEED + 7)
    tampered = np.nonzero(~expect)[0]
    sample = sorted(set(tampered[:2].tolist()) | set(
        rng.choice(IDEMIX_LANES, IDEMIX_SAMPLE - 2, replace=False).tolist()))
    for i in sample:
        want = host.pairing(a_pts[i], ik.W) == host.pairing(abar_pts[i], ik.g2)
        if bool(mask[i]) != want:
            raise AssertionError(f"lane {i}: card {bool(mask[i])}, host "
                                 f"pairings {want}")
    log(f"idemix (a) pairing check at {IDEMIX_LANES} lanes: 1 + 1 kernel "
        f"launches; mask (a CUDA tensor) == the plain version's on the card, "
        f"== construction ({int((~expect).sum())} tampered) and == host "
        f"pairings on lanes {sample}; {event_ms:.3f} ms per check by CUDA "
        f"events, {wall_ms:.3f} ms wall (warm, {IDEMIX_REPS} checks; first "
        f"{first_ms:.1f} ms); the plain check {plain_check_ms:.1f} ms")

    # each kernel against its plain version on the check's inputs (these
    # launches are outside the counted main path)
    s1, s2 = dev.line_schedule(ik.W), dev.line_schedule(ik.g2)
    pts = _device.upload(np.stack([cuda.point_words(a_pts),
                                   cuda.point_words(neg)]), torch.device("cuda"))
    lines = _device.upload(np.stack([s1.line_words(), s2.line_words()]),
                           pts.device)
    is_add = _device.upload(s1.is_add.astype(np.int32), pts.device)
    f_k = cuda.miller(pts, lines, is_add)
    f_p, m_plain_ms = timed(torch, lambda: cuda.miller_plain(pts, lines,
                                                             is_add))
    m_err = int((f_k.to(torch.int64) - f_p.to(torch.int64)).abs().max())
    if m_err:
        raise AssertionError("fp256bn_miller differs from its plain version")
    ok_k = cuda.final_exp(f_k, check=True)
    ok_p, e_plain_ms = timed(torch, lambda: cuda.final_exp_plain(f_k, True))
    e_err = int((ok_k.to(torch.int64) - ok_p.to(torch.int64)).abs().max())
    if e_err or not torch.equal(ok_k, mask_t):
        raise AssertionError("fp256bn_final_exp differs from its plain "
                             "version or from the check")
    # pairing mode, word for word, on every lane (schedule 0's values)
    one = f_k[:1].contiguous()
    g_k = cuda.final_exp(one, check=False)
    g_p = cuda.final_exp_plain(one, False)
    g_err = int((g_k.to(torch.int64) - g_p.to(torch.int64)).abs().max())
    if g_err:
        bad = (g_k != g_p).any(0).any(0).nonzero().flatten()[:8].tolist()
        raise AssertionError(f"fp256bn_final_exp's pairing words differ from "
                             f"its plain version at lanes {bad}")
    log(f"idemix (a) fp256bn_final_exp in pairing mode == its plain version "
        f"word for word on all {IDEMIX_LANES} lanes")
    pairing_ragged(torch, cuda, pts, lines, is_add)
    geom = cuda.geometry(len(s1.is_add))
    entries = {
        "fp256bn_miller": pairing_kernel_entry(
            torch, "fp256bn_miller", s1.is_add, IDEMIX_LANES,
            lambda: cuda.miller(pts, lines, is_add), m_plain_ms, m_err,
            geom),
        "fp256bn_final_exp": pairing_kernel_entry(
            torch, "fp256bn_final_exp", s1.is_add, IDEMIX_LANES,
            lambda: cuda.final_exp(f_k, True), e_plain_ms, max(e_err, g_err),
            geom),
    }
    log(f"idemix (a) a check's bound: "
        f"{sum(e['bound_ms'] for e in entries.values()):.4f} ms (the two "
        f"kernels'; on the reference's count alone "
        f"{sum(e['bound_ms_reference'] for e in entries.values()):.4f}), "
        f"against {event_ms:.3f} ms")

    # (b) full pairings against the host
    before = kernel_counts()
    got = dev.pairing_batch(a_pts[:IDEMIX_PAIRINGS], ik.W)
    torch.cuda.synchronize()
    for k, v in pairing_launched(before, "idemix (b) pairings").items():
        launched[k] += v
    if got.device.type != "cuda":
        raise AssertionError(f"pairing_batch output on {got.device}")
    for i in range(IDEMIX_PAIRINGS):
        if dev.f12_to_host(got, i) != host.pairing(a_pts[i], ik.W):
            raise AssertionError(f"pairing {i} differs from the host's")
    log(f"idemix (b) {IDEMIX_PAIRINGS} full pairings through the kernels "
        "(1 + 1 launches) == host fp256bn.pairing exactly")

    # (c) batch_verify at bench.py's presentation width
    t0 = time.perf_counter()
    items, want = fixtures.make_presentations(
        world, IDEMIX_PRESENTATIONS, IDEMIX_PLANT_EVERY, seed=SEED)
    sign_s = time.perf_counter() - t0
    passes = dev.counts().get("cuda", 0)
    torch.cuda.synchronize()
    before = kernel_counts()
    t0 = time.perf_counter()
    got = credential.batch_verify(ik, items)
    dev_s = time.perf_counter() - t0
    for k, v in pairing_launched(before, "idemix (c) batch_verify").items():
        launched[k] += v
    if dev.counts().get("cuda", 0) != passes + 1:
        raise AssertionError("batch_verify did not run its pairing check "
                             "on the card")
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w][:8]
        raise AssertionError(f"batch_verify verdicts differ at {bad}")
    t0 = time.perf_counter()
    host_got = credential.batch_verify(ik, items[:IDEMIX_HOST_CHECKED],
                                       use_device=False)
    host_s = time.perf_counter() - t0
    if host_got != got[:IDEMIX_HOST_CHECKED]:
        raise AssertionError("device and host batch_verify disagree")
    todo = [s for s, _, _ in items
            if s.A_prime is not None and s.A_bar is not None]
    small = ([s.A_prime for s in todo], ik.W,
             [s.A_bar.neg() for s in todo], ik.g2)
    dev.pairing_check_batch(*small)                         # warm
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(IDEMIX_REPS):
        dev.pairing_check_batch(*small)
    end.record()
    torch.cuda.synchronize()
    pair_s = (time.perf_counter() - t0) / IDEMIX_REPS
    log(f"idemix (c) batch_verify of {IDEMIX_PRESENTATIONS} presentations "
        f"(signed in {sign_s:.1f} s; {len(want) - sum(want)} planted): "
        f"verdicts == expected, first {IDEMIX_HOST_CHECKED} == host path; "
        f"device path {IDEMIX_PRESENTATIONS / dev_s:.2f} presentations/s "
        f"({dev_s * 1e3:.1f} ms), host path "
        f"{IDEMIX_HOST_CHECKED / host_s:.2f} presentations/s; the "
        f"{len(todo)}-lane pairing check alone {pair_s * 1e3:.3f} ms wall "
        f"({start.elapsed_time(end) / IDEMIX_REPS:.3f} ms CUDA events; "
        f"warm, {IDEMIX_REPS} checks), {pair_s / dev_s:.3f} of the device "
        "path")

    log(f"idemix phase: {time.perf_counter() - t_phase:.1f} s wall; "
        f"pairing passes {dev.counts()}; main-path kernel launches "
        f"{ {k: v for k, v in launched.items() if v} }")
    # (d) the plain version's bounded profile, scaled to a whole check,
    # for the caller to run after every other profiler window: its ~10^5
    # device records leave later windows of the process blind (PERF.md §7)
    return launched, entries, lambda: profile_pairing_check(
        torch, ik, a_pts, neg, plain_check_ms)


def profile_pairing_check(torch, ik, a_pts, b_pts, check_wall_ms):
    """torch.profiler over one of each repeated piece of the plain
    version's pairing check (the line precompute, a Miller doubling step,
    an add step, a cyclotomic square, a multiply) and over the rest once,
    scaled by the schedule's static counts: launches, device busy ms and
    idle share per plain check against the unprofiled plain check's
    wall.  It describes the plain version only: on the main path the
    check is the two kernels' launches."""
    from fabric_mod_tpu_torch import device as _device
    from fabric_mod_tpu_torch.idemix import fp256bn as host
    from fabric_mod_tpu_torch.ops import fp256bn_dev as dev
    d = _device.resolve(None)
    s1, s2 = dev.line_schedule(ik.W), dev.line_schedule(ik.g2)
    ax, ay = dev._g1_batch_to_mont(a_pts, d)
    bx, by = dev._g1_batch_to_mont(b_pts, d)
    xp, yp = torch.stack([ax, bx], 1), torch.stack([ay, by], 1)
    (A1, B1), (A2, B2) = s1.tensors(d), s2.tensors(d)
    A = torch.stack([A1, A2], -1).unsqueeze(-1)
    B = torch.stack([B1, B2], -1).unsqueeze(-1)
    ly = dev._line_operands(xp, A, B)
    f2 = dev._miller(xp, yp, A, B, s1.is_add)
    g = dev.f12_mul(f2[..., 0, :], f2[..., 1, :])
    n_add = int(s1.is_add.sum()) + 2             # + the correction lines
    n_dbl = len(s1.is_add) - int(s1.is_add.sum())
    bits = bin(abs(host.U))[2:]

    def rest():
        f = dev.f12_conj(f2)
        f = dev.f12_mul(f[..., 0, :], f[..., 1, :])
        f = dev._easy_part(f)
        fu = [dev.f12_conj(f) for _ in range(3)]
        return dev.f12_is_one(dev._hard_tail(f, *fu))
    pieces = (
        ("line precompute", 1, lambda: dev._line_operands(xp, A, B)),
        ("Miller doubling step", n_dbl,
         lambda: dev._miller_step(f2, yp, ly[:, :, :, 0], False)),
        ("Miller add step", n_add,
         lambda: dev._miller_step(f2, yp, ly[:, :, :, 0], True)),
        ("cyclotomic square", 3 * len(bits), lambda: dev.f12_sqr(g)),
        ("cyclotomic multiply", 3 * bits.count("1"),
         lambda: dev.f12_mul(g, g)),
        ("rest (conj, pair product, easy part, tail, is_one)", 1, rest),
    )
    lanes = len(a_pts)
    launches = busy = wall = 0.0
    for label, n, fn in pieces:
        fn()                                               # warm
        w_ms, n_k, b_ms, _top = device_profile(torch, fn)
        wall += n * w_ms
        if n_k is None:
            log(f"idemix (d) {lanes} lanes, {label}: wall {w_ms:.2f} ms; "
                "device time not measured (no device kernels recorded)")
            launches = busy = None
            continue
        log(f"idemix (d) {lanes} lanes, {label}: x{n} per check; {n_k} "
            f"device launches, busy {b_ms:.3f} ms, wall {w_ms:.2f} ms each "
            f"({window_note()})")
        if launches is not None:
            launches += n * n_k
            busy += n * b_ms
    if launches is not None:
        log(f"idemix (d) per {lanes}-lane plain pairing check (scaled): "
            f"{launches:.0f} device launches, device busy {busy:.1f} ms; "
            f"device idle share {1 - busy / check_wall_ms:.3f} of the "
            f"unprofiled check's {check_wall_ms:.1f} ms wall (profiled "
            f"pieces sum to {wall:.1f} ms)")

def require_core_launched(before: dict, where: str) -> dict:
    """The kernel launches since `before`; raise unless each of the verify
    core's three kernels was launched."""
    launched = {k: v - before[k] for k, v in kernel_counts().items()}
    require_launched({k: launched[k] for k in CORE_KERNELS}, where)
    return launched


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def statescale_arm(torch, world, verifier, blocks, path, n_keys, durable):
    """One arm of phase 13 (a): a ledger at `path` prefilled with `n_keys`
    keys, the stream committed by a Committer on `verifier`; a durable
    ledger is then closed and reopened."""
    from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.utils import fixtures
    led = KvLedger(world.channel_id, path, durable=durable)
    t0 = time.perf_counter()
    fixtures.prefill_statescale(led, n_keys)
    out = {"prefill_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    led.state_fingerprint()                 # seed the incremental fold
    out["seed_s"] = time.perf_counter() - t0
    committer = world.committer(verifier, tensor_policy=True, ledger=led)
    if durable:
        writes0, frames0 = led.state.batch_writes, led.state.batch_frames
    flags, timings, wall = [], [], 0.0
    for raw in blocks:
        block = m.Block.decode(raw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flags.append(committer.store_block(block))
        wall += time.perf_counter() - t0
        timings.append(committer.last_timings)
    out.update(flags=flags, wall_s=wall,
               stage_ms=[t["stage"] * 1e3 for t in timings],
               commit_ms=[t["commit"] * 1e3 for t in timings],
               fallbacks=sum(t["body_fallbacks"] or 0 for t in timings))
    t0 = time.perf_counter()
    out["fp"] = led.state_fingerprint()
    out["incr_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["fp_full"] = led.state_fingerprint_full()
    out["full_s"] = time.perf_counter() - t0
    if not durable:
        led.close()
        return out
    out["writes"] = (led.state.batch_writes - writes0) / len(blocks)
    out["frames"] = (led.state.batch_frames - frames0) / len(blocks)
    led.close()
    out["log_bytes"] = dir_bytes(os.path.join(path, "state")) + \
        dir_bytes(os.path.join(path, "history"))
    t0 = time.perf_counter()
    again = KvLedger(world.channel_id, path)
    out["reopen_s"] = time.perf_counter() - t0
    out["replayed"] = again.replayed_blocks
    out["fp_reopen"] = again.state_fingerprint()
    again.close()
    return out


def make_scale_blocks() -> list:
    """Phase 13 (a)'s state-scale stream (phase 14 (f) commits its first
    blocks too), on make_commit_world's seeded orgs."""
    from fabric_mod_tpu_torch.utils import fixtures
    t0 = time.perf_counter()
    blocks = fixtures.make_statescale_blocks(
        fixtures.make_commit_world(), SCALE_BLOCKS, SCALE_BLOCK_TXS,
        min(SCALE_SIZES))
    log(f"state-scale stream: {SCALE_BLOCKS} blocks x {SCALE_BLOCK_TXS} txs "
        f"signed in {time.perf_counter() - t0:.1f} s")
    return blocks


def phase_statescale(torch, dev, blocks=None) -> dict:
    """Phase 13 (a): bench.py:745's state-scale stream (SCALE_BLOCKS blocks
    of SCALE_BLOCK_TXS txs: 28 reads a tx, 0.5% stale, 2 absent probes, 3
    writes with 10% deletes, 10% phantom and 15% empty ranges, the
    VALIDATION_PARAMETER pin at block 2, 8% under-endorsed) committed by
    the port's Committer on the card's GpuVerifier (tensor policy) into a
    durable and a durable=False ledger, each prefilled at each of
    SCALE_SIZES keys.  Gated before any rate, as bench.py:945-1001: the
    flags are equal across arms and sizes and hold more than VALID, the
    fingerprints are equal across arms, the incremental fingerprint equals
    the full scan, no body-decode fallback row; the durable ledger reopens
    replaying 0 blocks to the same fingerprint.  `blocks`: the stream
    (make_scale_blocks() when None).  Returns the launches."""
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.utils import fixtures
    world = fixtures.make_commit_world()
    if blocks is None:
        blocks = make_scale_blocks()
    verifier = gpu.GpuVerifier(device=dev, cache_size=0)
    before = kernel_counts()
    points, flags0 = [], None
    with tempfile.TemporaryDirectory() as root:
        for n_keys in SCALE_SIZES:
            arms = {durable: statescale_arm(
                torch, world, verifier, blocks,
                os.path.join(root, f"{'durable' if durable else 'memory'}"
                                   f"{n_keys}"), n_keys, durable)
                for durable in (True, False)}
            d, mem = arms[True], arms[False]
            if d["flags"] != mem["flags"]:
                raise AssertionError(f"phase 13 (a) @{n_keys}: the durable "
                                     f"arm's txflags differ from the "
                                     f"durable=False arm's")
            if d["fp"] != mem["fp"]:
                raise AssertionError(f"phase 13 (a) @{n_keys}: the state "
                                     f"fingerprints differ across arms")
            for name, arm in (("durable", d), ("durable=False", mem)):
                if arm["fp"] != arm["fp_full"]:
                    raise AssertionError(f"phase 13 (a) @{n_keys} {name}: "
                                         f"incremental fingerprint != full "
                                         f"scan")
                if arm["fallbacks"]:
                    raise AssertionError(f"phase 13 (a) @{n_keys} {name}: "
                                         f"{arm['fallbacks']} body-decode "
                                         f"fallback rows")
            if d["replayed"] != 0 or d["fp_reopen"] != d["fp"]:
                raise AssertionError(f"phase 13 (a) @{n_keys}: the durable "
                                     f"reopen replayed {d['replayed']} "
                                     f"blocks, fingerprint equal: "
                                     f"{d['fp_reopen'] == d['fp']}")
            if flags0 is None:
                flags0 = d["flags"]
                kinds = sorted({f for per in flags0 for f in per})
                if kinds == [m.TxValidationCode.VALID]:
                    raise AssertionError("phase 13 (a): the stream gave "
                                         "only VALID flags")
            elif d["flags"] != flags0:
                raise AssertionError(f"phase 13 (a) @{n_keys}: txflags "
                                     f"changed with the state size")
            points.append((n_keys, d, mem))
    launched = require_core_launched(before, "phase 13 (a)")
    n_tx = SCALE_BLOCKS * SCALE_BLOCK_TXS
    log(f"phase 13 (a): gates hold at {list(SCALE_SIZES)} keys — flags equal "
        f"across arms and sizes (kinds {kinds}), fingerprints equal across "
        f"arms, incremental == full scan, 0 body-decode fallback rows, the "
        f"durable reopen replays 0 blocks to the same fingerprint")
    for n_keys, d, mem in points:
        for name, arm in (("durable", d), ("durable=False", mem)):
            line = (f"phase 13 (a) @{n_keys} keys {name}: "
                    f"{n_tx / arm['wall_s']:.1f} committed tx/s; ms a block "
                    f"stage {[round(x, 1) for x in arm['stage_ms']]}, "
                    f"mvcc+commit {[round(x, 1) for x in arm['commit_ms']]}; "
                    f"prefill {arm['prefill_s']:.2f} s; fingerprint seed "
                    f"scan {arm['seed_s']:.3f} s, incremental "
                    f"{arm['incr_s']:.6f} s, full scan {arm['full_s']:.3f} s")
            if name == "durable":
                line += (f"; {arm['writes']:.2f} state writes and "
                         f"{arm['frames']:.1f} frames a block, state + "
                         f"history logs {arm['log_bytes']} bytes, reopen "
                         f"{arm['reopen_s']:.3f} s ({arm['replayed']} blocks "
                         f"replayed)")
            log(line)
    log(f"phase 13 (a) kernel launches {launched}")
    return launched


def phase_crash(torch, dev, blocks=None, expected=None) -> dict:
    """Phase 13 (b): CRASH_BLOCKS blocks of BASELINE.md #2
    (fixtures.make_commit_blocks) committed on the card into two durable
    ledgers; in the second, the last block goes, with its final flags, to
    the block store only before the ledger closes (the reference's crash
    seam, kvledger.py:452-457, emulated by hand).  Reopened, it must
    replay exactly one block and equal the uncrashed ledger in flags,
    fingerprint (incremental == full) and sampled key histories; with
    its state log then cut inside its last record, a second reopen must
    crop the tail and reach the same fingerprint.  Returns the
    launches."""
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    from fabric_mod_tpu_torch.utils import fixtures
    world = fixtures.make_commit_world()
    if blocks is None:
        t0 = time.perf_counter()
        blocks, expected = fixtures.make_commit_blocks(
            world, CRASH_BLOCKS, TX_PER_BLOCK, plant_every=PLANT_EVERY)
        log(f"phase 13 (b): {CRASH_BLOCKS} blocks x {TX_PER_BLOCK} txs signed "
            f"in {time.perf_counter() - t0:.1f} s")
    blocks, expected = blocks[:CRASH_BLOCKS], expected[:CRASH_BLOCKS]
    verifier = gpu.GpuVerifier(device=dev, cache_size=0)
    before = kernel_counts()
    with tempfile.TemporaryDirectory() as root:
        clean_dir = os.path.join(root, "clean")
        crash_dir = os.path.join(root, "crash")
        clean = world.committer(verifier, tensor_policy=True,
                                ledger=KvLedger(world.channel_id, clean_dir))
        crashed = world.committer(verifier, tensor_policy=True,
                                  ledger=KvLedger(world.channel_id, crash_dir))
        for i, raw in enumerate(blocks):
            flags = clean.store_block(m.Block.decode(raw))
            if flags != expected[i]:
                raise AssertionError(f"phase 13 (b): block {i}'s txflags "
                                     f"differ from the expected flags")
            if i < len(blocks) - 1:
                if crashed.store_block(m.Block.decode(raw)) != flags:
                    raise AssertionError(f"phase 13 (b): block {i}'s flags "
                                         f"differ between the ledgers")
        last = m.Block.decode(blocks[-1])
        protoutil.set_block_txflags(last, bytes(expected[-1]))
        crashed.ledger.blockstore.add_block(last)
        crashed.ledger.close()
        want_fp = clean.ledger.state_fingerprint()
        keys = sorted(k for ns, k, _v, _ver in clean.ledger.state.iter_state())
        sample = keys[::max(1, len(keys) // HISTORY_SAMPLE)] + ["counter",
                                                                "pinned"]
        want_hist = {k: clean.ledger.history.get_history_for_key(
            fixtures.NAMESPACE, k) for k in sample}
        t0 = time.perf_counter()
        again = KvLedger(world.channel_id, crash_dir)
        reopen_s = time.perf_counter() - t0
        got_flags = [list(protoutil.block_txflags(b))
                     for b in again.blockstore.iter_blocks()]
        hist = {k: again.history.get_history_for_key(fixtures.NAMESPACE, k)
                for k in sample}
        fp, full = again.state_fingerprint(), again.state_fingerprint_full()
        if again.replayed_blocks != 1:
            raise AssertionError(f"phase 13 (b): the reopen replayed "
                                 f"{again.replayed_blocks} blocks, not 1")
        if got_flags != expected or fp != want_fp or full != fp or \
                hist != want_hist:
            raise AssertionError(f"phase 13 (b): the reopened ledger differs "
                                 f"from the uncrashed one (flags "
                                 f"{got_flags == expected}, fingerprint "
                                 f"{fp == want_fp}, full scan {full == fp}, "
                                 f"histories {hist == want_hist})")
        again.close()
        state_dir = Path(crash_dir) / "state"
        log_path = max(state_dir.glob("state-log-*.dat"))
        size = log_path.stat().st_size
        with open(log_path, "r+b") as f:
            f.truncate(size - 5)            # inside the last record
        t0 = time.perf_counter()
        torn = KvLedger(world.channel_id, crash_dir)
        torn_s = time.perf_counter() - t0
        torn_fp = torn.state_fingerprint()
        torn_replayed = torn.replayed_blocks
        rewritten = log_path.stat().st_size
        # the cropped tail took the last block's savepoint with it, so
        # the reopen re-applies exactly that block
        if torn_replayed != 1 or torn_fp != want_fp or \
                torn.state_fingerprint_full() != torn_fp:
            raise AssertionError(f"phase 13 (b): torn tail: "
                                 f"{torn_replayed} blocks replayed, "
                                 f"fingerprint equal {torn_fp == want_fp}")
        torn.close()
        clean.ledger.close()
    launched = require_core_launched(before, "phase 13 (b)")
    log(f"phase 13 (b): crash after the block store append — the reopen "
        f"replayed 1 block in {reopen_s:.3f} s; flags, fingerprint "
        f"{fp[:16]} (== full scan) and {len(sample)} key histories equal the "
        f"uncrashed ledger's; state log cut from {size} to {size - 5} bytes "
        f"inside its last record: the reopen ({torn_s:.3f} s) cropped it, "
        f"replayed {torn_replayed} block and wrote the log back to "
        f"{rewritten} bytes, same fingerprint; kernel launches "
        f"{launched}")
    return launched


class _PvtPeer:
    """A phase 13 (c) peer: a durable ledger, a Channel (tensor policy) on
    the card's verifier, and a GossipNode on the shared network; its
    `_commit_pvt` is timed."""

    def __init__(self, root, i, material, pems, network, verifier):
        from fabric_mod_tpu_torch.bccsp import sw
        from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
        from fabric_mod_tpu_torch.gossip import GossipNode
        from fabric_mod_tpu_torch.ledger.kvledger import LedgerManager
        from fabric_mod_tpu_torch.msp.identities import (SigningIdentity,
                                                         deserialize_cert)
        from fabric_mod_tpu_torch.peer.channel import Channel
        from fabric_mod_tpu_torch.protos import messages as m
        import random
        csp = sw.SwCSP()
        genesis = m.Block.decode(material.genesis)
        cid, config = config_from_block(genesis)
        self.mgr = LedgerManager(os.path.join(root, f"pvt{i}"))
        self.ledger = self.mgr.create_or_open(cid)
        self.channel = Channel(cid, self.ledger, verifier,
                               Bundle(cid, config, csp), csp,
                               tensor_policy=True)
        self.channel.init_from_genesis(genesis)
        mspid, cert_pem, key_pem = pems
        self.mspid = mspid
        self.node = GossipNode(f"pvt{i}:7051", SigningIdentity(
            mspid, deserialize_cert(cert_pem), key_pem, csp), self.channel,
            network, rng=random.Random(SEED + i))
        self.pvt_ms = []
        inner = self.ledger._commit_pvt

        def timed(*args):
            t0 = time.perf_counter()
            inner(*args)
            self.pvt_ms.append((time.perf_counter() - t0) * 1e3)
        self.ledger._commit_pvt = timed

    def private_rows(self):
        from fabric_mod_tpu_torch.ledger.pvtdata import pvt_namespace
        from fabric_mod_tpu_torch.utils import fixtures
        return {k: v for k, v, _ver in self.ledger.state.get_state_range(
            pvt_namespace(fixtures.NAMESPACE, fixtures.PVT_COLLECTION), "", "")}

    def close(self):
        self.node.stop()
        self.channel.close()
        self.mgr.close()


def phase_private(torch, dev) -> dict:
    """Phase 13 (c): three peers (Org1, Org2, Org3), each a durable ledger
    and Channel on one card GpuVerifier and a GossipNode on one
    in-process network, joined by a round of signed alive messages.  A
    definition block gives mycc the collection col1 (members Org1 and
    Org2, BTL PVT_BTL), then PVT_BLOCKS blocks of TX_PER_BLOCK txs in which
    every PVT_EVERY-th tx writes a private key, then PVT_PAD_BLOCKS
    one-tx blocks.  Org1's transient store holds every plaintext, Org2's
    only forged plaintext for PVT_FORGED txs, Org3's none.  Gates: no
    plaintext in any block; every peer's flags VALID and equal; Org1
    commits every private write; Org2 commits hashes only, reports the
    digests missing and rejects the forged plaintext; after
    `reconcile_tick` rounds Org2's private state and fingerprint equal
    Org1's; `distribute_pvt` never reaches Org3 and Org3's requests get
    no plaintext; after the padding blocks the BTL purge has emptied
    mycc$$pcol1 on Org1 and Org2 and all fingerprints are equal.
    Returns the launches."""
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.gossip import InProcNetwork
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    from fabric_mod_tpu_torch.utils import fixtures
    material = fixtures.make_network_material(SEED, gossip_peers=3)
    world = fixtures.network_world(material)
    genesis = m.Block.decode(material.genesis)
    t0 = time.perf_counter()
    blocks, plain, keys = fixtures.make_pvt_blocks(
        world, PVT_BLOCKS, TX_PER_BLOCK, pad_blocks=PVT_PAD_BLOCKS,
        pvt_every=PVT_EVERY, first_block=1,
        prev_hash=protoutil.block_header_hash(genesis.header), btl=PVT_BTL)
    log(f"phase 13 (c): {len(blocks)} blocks ({PVT_BLOCKS} x {TX_PER_BLOCK} "
        f"txs, {len(plain)} private) signed in "
        f"{time.perf_counter() - t0:.1f} s")
    for raw in blocks:
        for _key, value in keys.values():
            if value in raw:
                raise AssertionError("phase 13 (c): a block carries private "
                                     "plaintext")
    card = gpu.GpuVerifier(device=dev)
    network = InProcNetwork()
    before = kernel_counts()
    with tempfile.TemporaryDirectory() as root:
        peers = [_PvtPeer(root, i, material, pems, network, card)
                 for i, pems in enumerate(material.gossip_peers)]
        try:
            org1, org2, org3 = peers
            if [p.mspid for p in peers] != ["Org1", "Org2", "Org3"]:
                raise AssertionError("phase 13 (c): one peer an org expected")
            for p in peers:
                p.node.join([q.node.endpoint for q in peers])
            for txid, pvt in plain.items():
                org1.channel.transient_store.persist(txid, 0, pvt)
            forged = sorted(plain)[:PVT_FORGED]
            for txid in forged:
                key, _value = keys[txid]
                org2.channel.transient_store.persist(
                    txid, 0, forged_pvt(key))
            missing_after = []
            for i, raw in enumerate(blocks):
                num = m.Block.decode(raw).header.number
                flags = [p.channel.store_block(m.Block.decode(raw))
                         for p in peers]
                if any(f != flags[0] for f in flags) or \
                        set(flags[0]) != {m.TxValidationCode.VALID}:
                    raise AssertionError(f"phase 13 (c): block {num} flags "
                                         f"not all VALID on every peer")
                mine = {keys[t][0]: keys[t][1] for t in plain
                        if keys[t][0].startswith(f"p{num}t")}
                rows1, rows2 = org1.private_rows(), org2.private_rows()
                if any(rows1.get(k) != v for k, v in mine.items()):
                    raise AssertionError(f"phase 13 (c): Org1 lacks block "
                                         f"{num}'s private writes")
                if any(k in rows2 for k in mine):
                    raise AssertionError(f"phase 13 (c): Org2 committed "
                                         f"plaintext of block {num}")
                missing_after.append(org2.ledger.missing_pvt_count())
                if i == PVT_BLOCKS:
                    break
            if org1.ledger.missing_pvt_count() != 0:
                raise AssertionError("phase 13 (c): Org1 reports missing "
                                     "digests")
            if missing_after[-1] != PVT_BLOCKS * len(
                    range(0, TX_PER_BLOCK, PVT_EVERY)):
                raise AssertionError(f"phase 13 (c): Org2 reports "
                                     f"{missing_after} digests missing")
            # the transient plaintext of the last private block, pushed to
            # the collection's members only
            policy = org1.channel.collection_policy(fixtures.NAMESPACE,
                                                    fixtures.PVT_COLLECTION)
            eligible = org1.node.eligibility_by_policy(policy)
            last = [t for t in plain
                    if keys[t][0].startswith(f"p{PVT_BLOCKS + 1}t")]
            reached = {org1.node.distribute_pvt(t, plain[t], eligible)
                       for t in last}
            org2_held = sum(
                [g.encode() for g in
                 org2.channel.transient_store.get_by_txid(t)] ==
                [plain[t].encode()] for t in last)
            if reached != {1} or org2_held != len(last) or any(
                    org3.channel.transient_store.get_by_txid(t)
                    for t in plain):
                raise AssertionError(f"phase 13 (c): distribute_pvt reached "
                                     f"{reached} peers, Org2 holds "
                                     f"{org2_held} of {len(last)} pushed "
                                     f"write sets, or Org3 holds some")
            before_rec = org2.ledger.missing_pvt_count()
            org3_missing = org3.ledger.missing_pvt_count()
            rounds = 0
            t0 = time.perf_counter()
            while org2.ledger.missing_pvt_count() and rounds < PVT_ROUNDS:
                org2.node.reconcile_tick()
                rounds += 1
            rec_s = time.perf_counter() - t0
            after_rec = org2.ledger.missing_pvt_count()
            org3.node.reconcile_tick()
            if after_rec or org2.private_rows() != org1.private_rows() or \
                    org2.ledger.state_fingerprint() != \
                    org1.ledger.state_fingerprint():
                raise AssertionError(f"phase 13 (c): after {rounds} rounds "
                                     f"Org2 has {after_rec} missing, private "
                                     f"state equal "
                                     f"{org2.private_rows() == org1.private_rows()}")
            if org3.private_rows():
                raise AssertionError("phase 13 (c): Org3 holds plaintext")
            for raw in blocks[PVT_BLOCKS + 1:]:
                for p in peers:
                    p.channel.store_block(m.Block.decode(raw))
            fps = {p.ledger.state_fingerprint() for p in peers}
            fulls = {p.ledger.state_fingerprint_full() for p in peers}
            if org1.private_rows() or org2.private_rows() or \
                    len(fps) != 1 or fps != fulls:
                raise AssertionError(f"phase 13 (c): after the BTL purge "
                                     f"Org1 / Org2 hold "
                                     f"{len(org1.private_rows())} / "
                                     f"{len(org2.private_rows())} private "
                                     f"rows, {len(fps)} fingerprints")
            pvt_ms = [round(x, 2) for x in org1.pvt_ms]
            pvt_ms2 = [round(x, 2) for x in org2.pvt_ms]
            heights = [p.ledger.height for p in peers]
        finally:
            for p in peers:
                p.close()
    launched = require_core_launched(before, "phase 13 (c)")
    log(f"phase 13 (c): {len(plain)} private txs, no plaintext in any block; "
        f"Org1 committed every private write; Org2 missing after each "
        f"private block {missing_after} ({PVT_FORGED} forged plaintexts "
        f"rejected); distribute_pvt reached 1 peer (Org2) each time, whose "
        f"transient store then held all {org2_held} pushed write sets, never "
        f"Org3; reconciliation {before_rec} -> {after_rec} missing in {rounds}"
        f" rounds ({rec_s:.3f} s; the BTL had dropped the first block's); "
        f"Org3 kept {org3_missing} missing and got no plaintext; after "
        f"{PVT_PAD_BLOCKS} more blocks mycc$$pcol1 is empty on Org1 and Org2 "
        f"and the 3 fingerprints are equal (heights {heights}); _commit_pvt "
        f"ms a block Org1 {pvt_ms}, Org2 {pvt_ms2}; kernel launches "
        f"{launched}")
    return launched


def forged_pvt(key: str):
    """A private write set of `key` with a value no block hashed."""
    from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder
    from fabric_mod_tpu_torch.utils import fixtures
    rw = RWSetBuilder()
    rw.add_pvt_write(fixtures.NAMESPACE, fixtures.PVT_COLLECTION, key,
                     b"forged")
    return rw.build_pvt()


def phase_durable(torch, dev, blocks=None, expected=None,
                  scale_blocks=None) -> dict:
    """Phase 13: (a) state scale (on `scale_blocks` when given), (b) crash
    and recovery, (c) private data across three peers.  Returns the
    launches of all three."""
    t0 = time.perf_counter()
    total = {}
    for launched in (phase_statescale(torch, dev, scale_blocks),
                     phase_crash(torch, dev, blocks, expected),
                     phase_private(torch, dev)):
        for k, v in launched.items():
            total[k] = total.get(k, 0) + v
    log(f"durable ledger phase: {time.perf_counter() - t0:.1f} s wall; "
        f"kernel launches {total}")
    return total


class PoolSwVerifier:
    """The host oracle's verifier: SwVerifier's `verify_item` over a pool
    of `workers` spawned processes (the pure-python verify is ~1.4 ms a
    signature; phase 14's oracle checks ~20,000).  `close()` stops the
    workers."""

    def __init__(self, workers: int):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        self._workers = workers
        self._pool = ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn"))

    def verify_many(self, items):
        import numpy as np
        from fabric_mod_tpu_torch.bccsp import sw
        items = list(items)
        if len(items) < 4 * self._workers:
            return np.array([sw.verify_item(it) for it in items], bool)
        chunk = max(1, len(items) // (4 * self._workers))
        return np.fromiter(self._pool.map(sw.verify_item, items,
                                          chunksize=chunk), bool, len(items))

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)


class LifecycleWorld:
    """Phase 14's network, its host oracle and the bookkeeping they
    share: `net` a solo e2e.Network (tensor policy, the default
    GpuVerifier on the card, staged ingress), `oracle` a Channel and
    durable ledger of its own over PoolSwVerifier that commits every
    block the network's peer committed, `world` the material's signers
    for hand-signed txs."""

    def __init__(self, torch, dev, root: str, pool):
        from fabric_mod_tpu_torch import e2e
        from fabric_mod_tpu_torch.bccsp import sw
        from fabric_mod_tpu_torch.channelconfig import (Bundle,
                                                        config_from_block)
        from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
        from fabric_mod_tpu_torch.peer.channel import Channel
        from fabric_mod_tpu_torch.peer.chaincode import KvContract
        from fabric_mod_tpu_torch.protos import messages as m
        from fabric_mod_tpu_torch.utils import fixtures
        self.material = fixtures.make_network_material(
            LC_SEED, max_message_count=TX_PER_BLOCK,
            batch_timeout=LC_BATCH_TIMEOUT,
            preferred_max_bytes=E2E_PREFERRED_MAX_BYTES)
        # verifier=None: the GpuVerifier Network builds, whose verdict
        # cache holds ingress's creator-signature verdicts; the fused
        # seam still hands the validator a mask on the card
        self.net = e2e.Network(os.path.join(root, "net"),
                               material=self.material, device=dev,
                               tensor_policy=True, ingress_batching=True,
                               staged_batch=E2E_STAGED_BATCH)
        # cc2 and the document namespace run the example contract: a
        # peer launches an installed chaincode on first use
        self.net.chaincodes.set_resolver(
            lambda name: KvContract() if name in ("cc2", "qcc") else None)
        self.world = fixtures.network_world(self.material)
        self.torch = torch
        genesis = m.Block.decode(self.material.genesis)
        cid, config = config_from_block(genesis)
        self.oracle_ledger = KvLedger(cid, os.path.join(root, "oracle"))
        self.oracle = Channel(cid, self.oracle_ledger, pool,
                              Bundle(cid, config, sw.SwCSP()), sw.SwCSP())
        self.oracle.init_from_genesis(m.Block.decode(self.material.genesis))
        self.oracle_secs = 0.0

    def pump(self, want_more: int, label: str, blocks=None) -> dict:
        """Deliver and commit until `want_more` more txs are in; the card
        must launch the verify core at least once a block.  `blocks`, if
        given, is the count of blocks they must come in.  Returns the
        client's figures and the launches."""
        from fabric_mod_tpu_torch import e2e
        net = self.net
        h0, before = net.ledger.height, kernel_counts()
        want = net.committed_txs() + want_more
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        client, got, _span = e2e.commit_until(net, want, 120.0,
                                              idle_timeout_s=10.0)
        self.torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_blocks = net.ledger.height - h0
        if got < want:
            raise AssertionError(f"phase 14 {label}: {got - want + want_more}"
                                 f" of {want_more} txs committed")
        if blocks is not None and n_blocks != blocks:
            sizes = [len(net.ledger.get_block_by_number(n).data.data)
                     for n in range(h0, net.ledger.height)]
            raise AssertionError(f"phase 14 {label}: the txs came in blocks "
                                 f"of {sizes}, not {blocks} blocks")
        launched = {k: v - before[k] for k, v in kernel_counts().items()}
        if launched["ladder_projective"] < n_blocks or \
                launched["verify_epilogue"] < n_blocks:
            raise AssertionError(f"phase 14 {label}: {launched} verify-core "
                                 f"launches for {n_blocks} blocks")
        return {"wall": wall, "blocks": n_blocks, "first": h0,
                "stage": client.stage_secs, "commit": client.commit_secs,
                "launched": launched}

    def check_oracle(self, label: str) -> None:
        """The oracle commits every block the peer has and it has not:
        equal txflags per block, then equal fingerprints."""
        from fabric_mod_tpu_torch.protos import messages as m
        from fabric_mod_tpu_torch.protos import protoutil
        led, oled = self.net.ledger, self.oracle_ledger
        t0 = time.perf_counter()
        for n in range(oled.height, led.height):
            block = led.get_block_by_number(n)
            want = list(protoutil.block_txflags(block))
            got = self.oracle.store_block(m.Block.decode(block.encode()))
            if list(got) != want:
                bad = [i for i, (g, w) in enumerate(zip(got, want))
                       if g != w][:8]
                raise AssertionError(f"phase 14 {label}: block {n}'s txflags "
                                     f"differ from the host oracle's at {bad}")
        self.oracle_secs += time.perf_counter() - t0
        fp = led.state_fingerprint()
        if fp != self.oracle_ledger.state_fingerprint() or \
                fp != led.state_fingerprint_full():
            raise AssertionError(f"phase 14 {label}: the peer's fingerprint "
                                 f"differs from the oracle's or its full scan")

    def flags_by_txid(self, txids) -> list:
        """The peer's committed flag of each tx id, each block read once."""
        from fabric_mod_tpu_torch.protos import protoutil
        led = self.net.ledger
        locs = [led.blockstore.get_tx_loc(t) for t in txids]
        flags = {num: protoutil.block_txflags(led.get_block_by_number(num))
                 for num in {num for num, _pos in locs}}
        return [flags[num][pos] for num, pos in locs]

    def ask(self, cc: str, args, signer=None, org: str = "Org1"):
        """A proposal answered by `org`'s endorser: (status, payload)."""
        from fabric_mod_tpu_torch.protos import protoutil
        sp, _prop, _t = protoutil.create_chaincode_proposal(
            self.net.channel_id, cc, args, signer or self.net.client)
        resp = self.net.endorsers[org].process_proposal(sp)
        return resp.response.status, resp.response.payload

    def endorsed(self, cc: str, args, orgs=("Org1", "Org2")):
        """(envelope, the first endorser's response payload)."""
        from fabric_mod_tpu_torch.protos import protoutil
        net = self.net
        sp, prop, _t = protoutil.create_chaincode_proposal(
            net.channel_id, cc, args, net.client)
        responses = [net.endorsers[o].process_proposal(sp) for o in orgs]
        if any(r.response.status != 200 for r in responses):
            raise AssertionError(f"phase 14: {cc} {args[0]!r} endorsement "
                                 f"failed: {responses[0].response.message}")
        return (protoutil.create_tx_from_responses(prop, responses,
                                                   net.client),
                responses[0].response.payload)

    def close(self) -> None:
        self.net.close()
        self.oracle.close()
        self.oracle_ledger.close()


def _txid(env) -> str:
    from fabric_mod_tpu_torch.protos import protoutil
    return protoutil.envelope_channel_header(env).tx_id


def _policy(spec: str) -> bytes:
    from fabric_mod_tpu_torch.policy import from_string
    from fabric_mod_tpu_torch.protos import messages as m
    return m.ApplicationPolicy(signature_policy=from_string(spec)).encode()


def lc_ceremony(lw) -> list:
    """Phase 14 (a): deploy cc2 (policy AND(Org1, Org3)) by the lifecycle
    ceremony, with its two negatives.  Returns the ceremony's blocks."""
    from fabric_mod_tpu_torch.peer.lifecycle import LIFECYCLE_NS
    from fabric_mod_tpu_torch.protos import messages as m
    V = m.TxValidationCode
    from fabric_mod_tpu_torch.policy import tensorpolicy
    net, first = lw.net, lw.net.ledger.height
    tensorpolicy.reset_counts()
    pol = _policy("AND('Org1.peer', 'Org3.peer')")
    args = [b"cc2", b"1.0", b"1", pol]
    # an approval by Org1's admin endorsed by Org2's peer alone fails
    # Org1's Endorsement policy; Org3's own approval is VALID
    wrong = net.invoke([b"approve"] + args, endorsing_orgs=["Org2"],
                       chaincode=LIFECYCLE_NS, signer=net.admins["Org1"])
    lw.pump(1, "(a) wrong-org approval", blocks=1)
    org3 = net.invoke([b"approve"] + args, endorsing_orgs=["Org3"],
                      chaincode=LIFECYCLE_NS, signer=net.admins["Org3"])
    lw.pump(1, "(a) Org3's approval", blocks=1)
    if lw.flags_by_txid([wrong, org3]) != [V.ENDORSEMENT_POLICY_FAILURE,
                                           V.VALID]:
        raise AssertionError(f"phase 14 (a): the wrong-org and Org3 "
                             f"approvals got {lw.flags_by_txid([wrong, org3])}")
    status, _ = lw.ask(LIFECYCLE_NS, [b"commit"] + args)
    if status == 200:
        raise AssertionError("phase 14 (a): a commit with one approval "
                             "recorded was endorsed")
    t0 = time.perf_counter()
    net.deploy_chaincode("cc2", "1.0", 1, policy=pol)
    ceremony_s = time.perf_counter() - t0
    ready = json.loads(lw.ask(LIFECYCLE_NS,
                              [b"checkcommitreadiness"] + args)[1])
    digest = lw.ask(LIFECYCLE_NS, [b"queryapproved", b"cc2", b"1"],
                    signer=net.admins["Org1"])[1]
    if ready != {"Org1": True, "Org2": True, "Org3": True} or \
            len(digest) != 64:
        raise AssertionError(f"phase 14 (a): readiness {ready}, Org1's "
                             f"approval digest {digest!r}")
    passes = tensorpolicy.counts()
    if passes != {LC_MASK_DEVICE: net.ledger.height - first}:
        raise AssertionError(f"phase 14 (a): tensor-policy passes {passes} "
                             f"for {net.ledger.height - first} blocks")
    lw.check_oracle("(a)")
    sizes = [len(net.ledger.get_block_by_number(n).data.data)
             for n in range(first, net.ledger.height)]
    log(f"phase 14 (a): cc2 deployed (AND(Org1, Org3)) by the ceremony in "
        f"{ceremony_s:.2f} s — blocks of {sizes} txs: the wrong-org approval "
        f"ENDORSEMENT_POLICY_FAILURE, Org3's org-local approval VALID, a "
        f"commit with one approval recorded refused at endorsement, Org1's "
        f"and Org2's approvals each in its own block, then the commit, every "
        f"ceremony tx VALID; checkcommitreadiness {ready}; queryapproved "
        f"{digest[:16].decode()}...; tensor-policy passes {passes} (the "
        f"org-local approvals' /Channel/Application/<org>/Endorsement "
        f"evaluated on the mask); flags == host oracle")
    return sizes


def lc_stream(lw) -> dict:
    """Phase 14 (b): LC_BLOCKS blocks of TX_PER_BLOCK blind puts mixing
    mycc and cc2, every LC_UNDER_EVERY-th under-endorsed for its
    namespace.  Returns its figures for the log."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.policy import tensorpolicy
    from fabric_mod_tpu_torch.utils import fixtures
    net = lw.net
    t0 = time.perf_counter()
    stream = fixtures.make_lifecycle_stream(
        lw.world, LC_BLOCKS * TX_PER_BLOCK, LC_UNDER_EVERY, LC_SEED)
    sign_s = time.perf_counter() - t0
    envs = [env for env, _f in stream]
    t0 = time.perf_counter()
    e2e.submit_all(net, envs, E2E_SUBMITTERS)
    ingress_s = time.perf_counter() - t0
    tensorpolicy.reset_counts()
    timed = lw.pump(len(envs), "(b)", blocks=LC_BLOCKS)
    passes = tensorpolicy.counts()
    if passes != {LC_MASK_DEVICE: LC_BLOCKS}:
        raise AssertionError(f"phase 14 (b): tensor-policy passes {passes}, "
                             f"expected one on the card a block")
    got = lw.flags_by_txid([_txid(env) for env in envs])
    want = [f for _e, f in stream]
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w][:8]
        raise AssertionError(f"phase 14 (b): flags differ from the "
                             f"construction at {bad}")
    lw.check_oracle("(b)")
    n = timed["blocks"]
    return {"sign": sign_s, "ingress": ingress_s, "passes": passes,
            "tx_s": len(envs) / timed["wall"], "blocks": n,
            "stage_ms": timed["stage"] / n * 1e3,
            "commit_ms": timed["commit"] / n * 1e3,
            "core_a_block": timed["launched"]["ladder_projective"] / n,
            "block": net.ledger.height - 1}


def lc_profile_evaluator(torch, lw, figures: dict) -> None:
    """Phase 14 (b)'s log line, with the evaluator's pass over its last
    block's policies alone under torch.profiler: the block staged again
    (its verify launches are no run of the main path, so this runs
    outside the counted parts)."""
    staged = lw.net.channel.validator().stage(
        lw.net.ledger.get_block_by_number(figures["block"]))
    raw = staged.mask_fn()
    torch.cuda.synchronize()

    def evaluator():
        staged.session.attach_mask(raw)
        staged.session.verdicts()
    wall_ms, n_kernels, busy_ms, _top = device_profile(torch, evaluator)
    f = figures
    log(f"phase 14 (b): {LC_BLOCKS} x {TX_PER_BLOCK} txs (mycc and cc2, every "
        f"{LC_UNDER_EVERY}th under-endorsed for its namespace) signed in "
        f"{f['sign']:.1f} s, broadcast from {E2E_SUBMITTERS} threads in "
        f"{f['ingress']:.2f} s; flags == construction and host oracle, "
        f"fingerprint == oracle == full scan; {f['tx_s']:.1f} committed tx/s "
        f"over {f['blocks']} blocks; ms a block stage {f['stage_ms']:.1f}, "
        f"commit {f['commit_ms']:.1f}; verify-core launches a block "
        f"{f['core_a_block']:.2f}; tensor-policy passes {f['passes']}, a "
        f"block's pass ({len(staged.session)} evaluations, {raw.device} "
        f"mask) {n_kernels} device launches, busy {busy_ms} ms, wall "
        f"{wall_ms:.2f} ms (torch.profiler; {window_note()})")


def lc_upgrade(lw) -> None:
    """Phase 14 (c): cc2 sequence 2 moves to OutOf(2, Org1, Org2, Org3).
    The block that commits it carries cc2 invokes judged by sequence 1
    (Org1 + Org2: refused; Org1 + Org3: VALID); the next block is judged
    by sequence 2 (Org1 + Org2: VALID; Org2 alone: refused)."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.peer.lifecycle import LIFECYCLE_NS
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.utils import fixtures
    V = m.TxValidationCode
    net = lw.net
    pol = _policy("OutOf(2, 'Org1.peer', 'Org2.peer', 'Org3.peer')")
    args = [b"cc2", b"2.0", b"2", pol]
    for org in ("Org1", "Org2"):
        net.invoke([b"approve"] + args, endorsing_orgs=[org],
                   chaincode=LIFECYCLE_NS, signer=net.admins[org])
        lw.pump(1, f"(c) {org}'s approval", blocks=1)
    k = LC_UPGRADE_INVOKES
    # beside cc2's invokes the block carries mycc puts (the channel
    # default) and Org3's approval of another chaincode (its org-local
    # policy): four policies in one tensor-policy pass
    same = fixtures.make_put_txs(lw.world, [
        ("cc2", f"up{i}", b"s1", ("Org1", "Org2") if i < k
         else ("Org1", "Org3")) for i in range(2 * k)] + [
        ("mycc", f"up{i}", b"s1", ("Org1", "Org2")) for i in range(k)],
        b"upgrade-same")
    commit = net.invoke([b"commit"] + args, chaincode=LIFECYCLE_NS)
    approve = net.invoke([b"approve", b"cc3", b"1.0", b"1", b""],
                         endorsing_orgs=["Org3"], chaincode=LIFECYCLE_NS,
                         signer=net.admins["Org3"])
    e2e.submit_all(net, same)
    lw.pump(2 + 3 * k, "(c) upgrade block", blocks=1)
    nxt = fixtures.make_put_txs(lw.world, [
        ("cc2", f"up{i}", b"s2", ("Org1", "Org2") if i < k else ("Org2",))
        for i in range(2 * k)], b"upgrade-next")
    e2e.submit_all(net, nxt)
    lw.pump(2 * k, "(c) next block", blocks=1)
    got_same = lw.flags_by_txid([commit, approve] + [_txid(e) for e in same])
    got_next = lw.flags_by_txid([_txid(e) for e in nxt])
    want_same = ([V.VALID] * 2 + [V.ENDORSEMENT_POLICY_FAILURE] * k
                 + [V.VALID] * 2 * k)
    want_next = [V.VALID] * k + [V.ENDORSEMENT_POLICY_FAILURE] * k
    if got_same != want_same or got_next != want_next:
        raise AssertionError(f"phase 14 (c): the upgrade block's flags "
                             f"{got_same}, the next block's {got_next}")
    lw.check_oracle("(c)")
    d = m.ChaincodeDefinition.decode(lw.ask(LIFECYCLE_NS,
                                            [b"query", b"cc2"])[1])
    log(f"phase 14 (c): cc2 sequence {d.sequence} ({d.version}) committed in "
        f"a block whose {2 * k} cc2 invokes were judged by sequence 1 (Org1 + "
        f"Org2 refused, Org1 + Org3 VALID), beside {k} mycc puts and Org3's "
        f"approval of cc3 (VALID); the next block by sequence 2 (Org1 + Org2 "
        f"VALID, Org2 alone refused); flags == host oracle")


def lc_rich_query(lw) -> None:
    """Phase 14 (e): LC_DOCS JSON documents in `qcc`, then one block of
    LC_QUERIES query txs over red and blue documents (VALID), LC_QUERIES
    over green and yellow ones each preceded in the block by a rewrite
    of its first result (MVCC_READ_CONFLICT), the rewrites and puts to
    fill TX_PER_BLOCK."""
    import numpy as np
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.utils import fixtures
    V = m.TxValidationCode
    net = lw.net
    docs = fixtures.make_rich_documents(LC_DOCS, seed=LC_SEED)
    doc_envs = fixtures.make_put_txs(
        lw.world, [("qcc", k, v, ("Org1", "Org2")) for k, v in docs],
        b"docs")
    e2e.submit_all(net, doc_envs, E2E_SUBMITTERS)
    lw.pump(LC_DOCS, "(e) documents", blocks=LC_DOCS // TX_PER_BLOCK)
    rng = np.random.RandomState(LC_SEED)
    t0 = time.perf_counter()
    queries, conflicted, rewrites, returned = [], [], [], 0
    for i in range(2 * LC_QUERIES):
        colors = ("red", "blue") if i < LC_QUERIES else ("green", "yellow")
        q = json.dumps({"selector": {"color": colors[int(rng.randint(2))],
                                     "size": {"$gte": int(rng.randint(80))}},
                        "sort": [{"size": "asc"}],
                        "limit": LC_QUERY_LIMIT}).encode()
        env, payload = lw.endorsed("qcc", [b"query", q])
        results = json.loads(payload)["results"]
        returned += len(results)
        if not results:
            raise AssertionError(f"phase 14 (e): query {q!r} matched nothing")
        (queries if i < LC_QUERIES else conflicted).append(env)
        if i >= LC_QUERIES:
            rewrites.append(("qcc", results[0]["key"], b'{"rewritten": 1}',
                             ("Org1", "Org2")))
    endorse_s = time.perf_counter() - t0
    rewrite_envs = fixtures.make_put_txs(lw.world, rewrites, b"rewrites")
    n_fill = TX_PER_BLOCK - 3 * LC_QUERIES
    fill = fixtures.make_put_txs(lw.world, [
        ("qcc", f"fill{i}", b"f", ("Org1", "Org2")) for i in range(n_fill)],
        b"fill")
    # the rewrites are ordered first: every conflicted query follows its
    # rewrite in the block
    e2e.submit_all(net, rewrite_envs, E2E_SUBMITTERS)
    e2e.submit_all(net, queries + conflicted + fill, E2E_SUBMITTERS)
    lw.pump(TX_PER_BLOCK, "(e) query block", blocks=1)
    got = lw.flags_by_txid([_txid(e) for e in
                            rewrite_envs + queries + conflicted + fill])
    want = ([V.VALID] * (2 * LC_QUERIES) + [V.MVCC_READ_CONFLICT] * LC_QUERIES
            + [V.VALID] * n_fill)
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w][:8]
        raise AssertionError(f"phase 14 (e): flags differ from the "
                             f"construction at {bad}")
    lw.check_oracle("(e)")
    log(f"phase 14 (e): {LC_DOCS} documents; {2 * LC_QUERIES} query txs "
        f"(selector, sort, limit {LC_QUERY_LIMIT}; {returned} results) "
        f"endorsed in {endorse_s:.2f} s; in one {TX_PER_BLOCK}-tx block "
        f"{LC_QUERIES} VALID and {LC_QUERIES} MVCC_READ_CONFLICT behind "
        f"the rewrite of a result; flags == construction and host oracle")


def lc_config_update(lw) -> None:
    """Phase 14 (d): BatchSize max_message_count TX_PER_BLOCK ->
    LC_NEW_BATCH by the port's compute_update, signed by the orderer
    org's and two application orgs' admins; the next TX_PER_BLOCK txs
    come in 2 blocks; CSCC returns the config block and QSCC the chain
    info."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.protos import protoutil
    from fabric_mod_tpu_torch.utils import fixtures
    net = lw.net
    desired = fixtures.config_with_batch_size(net.channel.bundle().config,
                                              LC_NEW_BATCH)
    net.update_config(desired, [net.orderer_admin, net.admins["Org1"],
                                net.admins["Org2"]])
    lw.pump(1, "(d) config block", blocks=1)
    config_num = net.ledger.height - 1
    batch = net.channel.bundle().orderer.batch_size.max_message_count
    if batch != LC_NEW_BATCH:
        raise AssertionError(f"phase 14 (d): the peer's bundle has batch "
                             f"size {batch}")
    # cc2 runs sequence 2 by now: 2 of 3 orgs
    stream = fixtures.make_lifecycle_stream(
        lw.world, TX_PER_BLOCK, LC_UNDER_EVERY, LC_SEED + 1, "cu",
        dict(fixtures.LIFECYCLE_ENDORSERS,
             cc2=(("Org2", "Org3"), ("Org3",))))
    envs = [env for env, _f in stream]
    e2e.submit_all(net, envs, E2E_SUBMITTERS)
    lw.pump(TX_PER_BLOCK, "(d) re-cut", blocks=TX_PER_BLOCK // LC_NEW_BATCH)
    if lw.flags_by_txid([_txid(e) for e in envs]) != [f for _e, f in stream]:
        raise AssertionError("phase 14 (d): flags differ from the "
                             "construction")
    status, raw = lw.ask("cscc", [b"GetConfigBlock"])
    if status != 200 or raw != net.ledger.get_block_by_number(
            config_num).encode():
        raise AssertionError("phase 14 (d): CSCC GetConfigBlock is not the "
                             "config block")
    info = json.loads(lw.ask("qscc", [b"GetChainInfo"])[1])
    tip = net.ledger.get_block_by_number(net.ledger.height - 1)
    if info["height"] != net.ledger.height or info["currentBlockHash"] != \
            protoutil.block_header_hash(tip.header).hex():
        raise AssertionError(f"phase 14 (d): QSCC GetChainInfo {info}")
    lw.check_oracle("(d)")
    sizes = [len(net.ledger.get_block_by_number(n).data.data)
             for n in range(config_num + 1, net.ledger.height)]
    log(f"phase 14 (d): the config update (BatchSize {TX_PER_BLOCK} -> "
        f"{LC_NEW_BATCH}) committed as block {config_num}; the next "
        f"{TX_PER_BLOCK} txs came in blocks of {sizes}; CSCC GetConfigBlock "
        f"== block {config_num}; QSCC GetChainInfo height {info['height']}, "
        f"tip {info['currentBlockHash'][:16]}; flags == host oracle")


def lc_snapshot(torch, dev, scale_blocks, peer_copy: str, peer_cid: str,
                peer_fp: str, peer_config, root: str) -> None:
    """Phase 14 (f): the state-scale stream at LC_SNAPSHOT_KEYS keys into
    a durable ledger on the card, its snapshot, a second peer
    bootstrapped from it, both committing the next 2 blocks and a
    replayed pruned-range tx; then the admin commands on `peer_copy`, a
    closed copy of the network peer's ledger on channel `peer_cid`
    (`peer_fp` its fingerprint, `peer_config` its last config)."""
    from fabric_mod_tpu_torch.bccsp import gpu, sw
    from fabric_mod_tpu_torch.channelconfig import Bundle
    from fabric_mod_tpu_torch.ledger import admin
    from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
    from fabric_mod_tpu_torch.ledger.snapshot import (
        bootstrap_from_snapshot, verify_snapshot)
    from fabric_mod_tpu_torch.peer.channel import Channel
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    from fabric_mod_tpu_torch.utils import fixtures
    V = m.TxValidationCode
    world = fixtures.make_commit_world()
    cid = world.channel_id
    src = KvLedger(cid, os.path.join(root, "source"))
    fixtures.prefill_statescale(src, LC_SNAPSHOT_KEYS)
    src_c = world.committer(gpu.GpuVerifier(device=dev, cache_size=0),
                            tensor_policy=True, ledger=src)
    for raw in scale_blocks[:LC_SOURCE_BLOCKS]:
        src_c.store_block(m.Block.decode(raw))
    snap = os.path.join(root, "snapshot")
    t0 = time.perf_counter()
    meta = src.snapshot_to(snap)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    verify_snapshot(snap)
    verify_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    joined_dir = os.path.join(root, "joined")
    joined = bootstrap_from_snapshot(snap, joined_dir)
    bootstrap_s = time.perf_counter() - t0
    if joined.state_fingerprint() != src.state_fingerprint() or \
            joined.state_fingerprint_full() != src.state_fingerprint():
        raise AssertionError("phase 14 (f): the bootstrapped ledger's "
                             "fingerprint differs from the source's")
    joined_c = world.committer(gpu.GpuVerifier(device=dev, cache_size=0),
                               tensor_policy=True, ledger=joined)
    # a replay of a tx of block 0, which the joined peer holds only as a
    # pruned-range tx id
    replay = protoutil.get_envelopes(m.Block.decode(scale_blocks[0]))[5]
    later = [m.Block.decode(raw) for raw in
             scale_blocks[LC_SOURCE_BLOCKS:LC_SOURCE_BLOCKS + 2]]
    prev = protoutil.block_header_hash(later[-1].header)
    later.append(protoutil.new_block(later[-1].header.number + 1, prev,
                                     [replay]))
    flags = {}
    for name, c in (("source", src_c), ("joined", joined_c)):
        flags[name] = [list(c.store_block(m.Block.decode(b.encode())))
                       for b in later]
    if flags["source"] != flags["joined"] or \
            flags["joined"][-1] != [V.DUPLICATE_TXID]:
        raise AssertionError(f"phase 14 (f): source flags "
                             f"{[f[-1:] for f in flags['source']]} vs joined "
                             f"{[f[-1:] for f in flags['joined']]}")
    fps = {name: (led.state_fingerprint(), led.state_fingerprint_full())
           for name, led in (("source", src), ("joined", joined))}
    if len({fp for pair in fps.values() for fp in pair}) != 1:
        raise AssertionError(f"phase 14 (f): fingerprints {fps}")
    src.close()
    joined.close()
    replayed = {}
    for name, path in (("source", os.path.join(root, "source")),
                       ("joined", joined_dir)):
        t0 = time.perf_counter()
        again = KvLedger(cid, path)
        replayed[name] = (again.replayed_blocks, time.perf_counter() - t0)
        if again.replayed_blocks or \
                again.state_fingerprint() != fps["source"][0]:
            raise AssertionError(f"phase 14 (f): the {name} ledger reopened "
                                 f"replaying {again.replayed_blocks} blocks")
        again.close()
    try:
        admin.rebuild_dbs(joined_dir)
        raise AssertionError("phase 14 (f): rebuild_dbs accepted a "
                             "bootstrapped ledger")
    except admin.AdminError:
        pass
    # the admin commands on the network peer's ledger
    t0 = time.perf_counter()
    admin.rebuild_dbs(peer_copy)
    led = KvLedger(peer_cid, peer_copy)
    rebuilt = (led.replayed_blocks, time.perf_counter() - t0)
    height = led.height
    tail = [led.get_block_by_number(n) for n in (height - 2, height - 1)]
    if led.state_fingerprint() != peer_fp:
        raise AssertionError("phase 14 (f): rebuild_dbs changed the peer "
                             "ledger's fingerprint")
    led.close()
    t0 = time.perf_counter()
    admin.rollback(peer_copy, height - 3)
    led = KvLedger(peer_cid, peer_copy)
    channel = Channel(led.ledger_id, led, gpu.GpuVerifier(device=dev),
                      Bundle(led.ledger_id, peer_config, sw.SwCSP()),
                      sw.SwCSP(), tensor_policy=True)
    for block in tail:
        got = channel.store_block(m.Block.decode(block.encode()))
        if list(got) != list(protoutil.block_txflags(block)):
            raise AssertionError("phase 14 (f): a recommitted block's flags "
                                 "differ")
    rolled_s = time.perf_counter() - t0
    if led.height != height or led.state_fingerprint() != peer_fp or \
            led.state_fingerprint_full() != peer_fp:
        raise AssertionError("phase 14 (f): rollback and recommit changed "
                             "the fingerprint")
    channel.close()
    led.close()
    log(f"phase 14 (f): {LC_SOURCE_BLOCKS} state-scale blocks at "
        f"{LC_SNAPSHOT_KEYS} keys; snapshot of {meta['state_entries']} "
        f"entries at height {meta['height']}, {dir_bytes(snap)} bytes: "
        f"export {export_s:.3f} s, verify {verify_s:.3f} s, bootstrap "
        f"{bootstrap_s:.3f} s; both peers committed 2 more blocks and a "
        f"replayed pruned-range tx (DUPLICATE_TXID on both) with equal flags "
        f"and fingerprints (== full scans); reopen replayed "
        f"{replayed['source'][0]} / {replayed['joined'][0]} blocks in "
        f"{replayed['source'][1]:.3f} / {replayed['joined'][1]:.3f} s; "
        f"rebuild_dbs refused on the bootstrapped ledger; the network peer's "
        f"ledger rebuilt ({rebuilt[0]} blocks replayed, {rebuilt[1]:.2f} s), "
        f"rolled back to {height - 2} and its 2 blocks recommitted on the "
        f"card ({rolled_s:.2f} s) to the same fingerprint")


def phase_lifecycle(torch, dev, scale_blocks=None) -> dict:
    """Phase 14: (a) the lifecycle ceremony, (b) full-width blocks over two
    namespaces, (c) an upgrade with the same-block rule, (e) rich
    queries, (d) a config update, then (f) snapshot, bootstrap and the
    admin commands.  The counts are set to 0 just before each part and
    read just after it; (b)'s profiled evaluator pass runs between two
    parts.  Returns the parts' launches."""
    import shutil
    from fabric_mod_tpu_torch.channelconfig import config_from_block
    t_phase = time.perf_counter()
    launched = dict.fromkeys(kernel_counts(), 0)

    def counted(part):
        reset_kernel_counts()
        out = part()
        for k, v in kernel_counts().items():
            launched[k] += v
        return out
    if scale_blocks is None:
        scale_blocks = make_scale_blocks()
    pool = PoolSwVerifier(ORACLE_WORKERS)
    try:
        with tempfile.TemporaryDirectory() as root:
            t0 = time.perf_counter()
            lw = counted(lambda: LifecycleWorld(torch, dev, root, pool))
            parts = {"setup": time.perf_counter() - t0}
            try:
                for name, part in (("a", lambda: lc_ceremony(lw)),
                                   ("b", lambda: lc_stream(lw)),
                                   ("c", lambda: lc_upgrade(lw)),
                                   ("e", lambda: lc_rich_query(lw)),
                                   ("d", lambda: lc_config_update(lw))):
                    t1 = time.perf_counter()
                    out = counted(part)
                    parts[name] = time.perf_counter() - t1
                    if name == "b":
                        lc_profile_evaluator(torch, lw, out)
                network_s = time.perf_counter() - t0
                peer_fp = lw.net.ledger.state_fingerprint()
                tip = lw.net.ledger.get_block_by_number(
                    lw.net.ledger.height - 1)
                from fabric_mod_tpu_torch.protos import protoutil
                config_block = lw.net.ledger.get_block_by_number(
                    protoutil.block_last_config_index(tip))
                peer_cid, peer_config = config_from_block(config_block)
                oracle_s = lw.oracle_secs
                peer_dir = lw.net.ledger.dir
            finally:
                lw.close()
            peer_copy = os.path.join(root, "peer-copy")
            shutil.copytree(peer_dir, peer_copy)
            t0 = time.perf_counter()
            counted(lambda: lc_snapshot(torch, dev, scale_blocks, peer_copy,
                                        peer_cid, peer_fp, peer_config,
                                        os.path.join(root, "snap")))
            snapshot_s = time.perf_counter() - t0
    finally:
        pool.close()
    require_launched({k: launched[k] for k in CORE_KERNELS}, "phase 14")
    log(f"lifecycle phase: {time.perf_counter() - t_phase:.1f} s wall "
        f"(network parts {network_s:.1f} s — "
        f"{ {k: round(v, 1) for k, v in parts.items()} } s — of which the "
        f"host oracle {oracle_s:.1f} s; snapshot and admin "
        f"{snapshot_s:.1f} s); kernel launches {launched}")
    return launched


# --- phase 15: observability, the orderer's ingress, participation ----------

def obs_commit(torch, material, blocks, traced: bool) -> dict:
    """Phase 8 (a)'s ordered blocks through a fresh peer's pipelined
    committer on the card (the tensor policy on, the verdict cache off),
    tracing armed or not; the traced run is also profiled for the
    device's busy time and for how many of the window's hand-written
    launches (made on the pipe's stage thread) the profiler recorded.
    Returns flags, fingerprint, the pipe's three buckets, the span
    totals and the block timelines."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.observability import tracing
    from fabric_mod_tpu_torch.peer.commitpipe import PipelinedCommitter
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    with tempfile.TemporaryDirectory() as root:
        net = e2e.Network(root, material=material,
                          verifier=gpu.GpuVerifier(cache_size=0),
                          tensor_policy=True)
        try:
            decoded = [m.Block.decode(raw) for raw in blocks]
            pipe = PipelinedCommitter(net.channel, depth=OBS_DEPTH,
                                      consumer="deliver")
            tracing.recorder().reset()

            def run():
                for block in decoded:
                    pipe.submit(block)
                if not pipe.flush(timeout_s=E2E_TIMEOUT_S):
                    raise AssertionError("phase 15 (a): the pipe did not "
                                         "commit the blocks in time")
            n_k = busy_ms = None
            seen = {}
            launched = kernel_counts()
            try:
                with tracing.active(traced):
                    if traced:
                        wall_ms, spans, names = kernel_intervals(torch, run)
                        n_k = len(spans or ())
                        busy_ms = sum(hi - lo for lo, hi in spans or ()) \
                            / 1e3
                        seen = {k: recorded_launches(names, k)
                                for k in CORE_KERNELS}
                    else:
                        t0 = time.perf_counter()
                        run()
                        wall_ms = (time.perf_counter() - t0) * 1e3
            finally:
                pipe.close()
            launched = {k: v - launched[k]
                        for k, v in kernel_counts().items()}
            totals = {k: v["secs"]
                      for k, v in tracing.substage_totals().items()}
            timelines = tracing.recorder().timelines()
            tracing.recorder().reset()
            return {"flags": [list(protoutil.block_txflags(b))
                              for b in decoded],
                    "fp": net.ledger.state_fingerprint(),
                    "buckets": {"stage": pipe.stage_secs,
                                "await": pipe.await_secs,
                                "commit": pipe.commit_secs},
                    "totals": totals, "timelines": timelines,
                    "wall_ms": wall_ms, "kernels": n_k, "busy_ms": busy_ms,
                    "seen": seen,
                    "launched": {k: launched[k] for k in CORE_KERNELS}}
        finally:
            net.close()


def obs_traced_commit(torch) -> dict:
    """15 (a): traced equals untraced, and the named substages explain
    the pipe's stage, await and commit buckets (bench.py:690ff's
    grouping, within 10% floored at ATTRIBUTION_FLOOR_S over
    ATTRIBUTION_FLOOR_BLOCKS blocks scaled to the blocks committed)."""
    material, blocks, fp8 = ORDERED["a"]
    off = obs_commit(torch, material, blocks, traced=False)
    on = obs_commit(torch, material, blocks, traced=True)
    if on["flags"] != off["flags"] or on["fp"] != off["fp"]:
        raise AssertionError("phase 15 (a): the traced commit's flags or "
                             "fingerprint differ from the untraced one")
    if off["fp"] != fp8:
        raise AssertionError("phase 15 (a): the fingerprint differs from "
                             "phase 8 (a)'s peer on the same blocks")
    n = len(blocks)
    if [t["block"] for t in on["timelines"]] != list(range(1, n + 1)):
        raise AssertionError(f"phase 15 (a): timelines "
                             f"{[t['block'] for t in on['timelines']]}")
    covered, held = {}, {}
    floor = ATTRIBUTION_FLOOR_S * n / ATTRIBUTION_FLOOR_BLOCKS
    for bucket, parts in ATTRIBUTION.items():
        have = sum(on["totals"].get(p, 0.0) for p in parts)
        want = on["buckets"][bucket]
        tol = max(ATTRIBUTION_TOL * want, floor)
        covered[bucket] = have / want if want > 0 else 1.0
        held[bucket] = (f"{tol * 1e3:.1f} ms, "
                        f"{'10%' if tol > floor else 'the floor'}")
        if abs(want - have) > tol:
            raise AssertionError(
                f"phase 15 (a): the {bucket} bucket {want:.3f} s against "
                f"its substages {'+'.join(parts)} {have:.3f} s (tolerance "
                f"{tol:.3f} s)")
    per_block = {k: round(v / n, 6) for k, v in sorted(on["totals"].items())}
    idle = (None if not on["busy_ms"] else
            1.0 - on["busy_ms"] / on["wall_ms"])
    complete = on["seen"] == on["launched"]
    mark = ("complete" if complete else
            "busy a LOWER BOUND, idle share an UPPER BOUND")
    log(f"phase 15 (a) traced commit: {n} blocks of phase 8 (a) "
        f"({sum(len(f) for f in on['flags'])} txs) through a pipelined "
        f"committer (depth {OBS_DEPTH}) on the card, untraced "
        f"{off['wall_ms']:.1f} ms and traced {on['wall_ms']:.1f} ms: flags "
        f"and fingerprint identical ({on['fp'][:16]}, == phase 8 (a)); "
        f"buckets s {{stage {on['buckets']['stage']:.4f}, await "
        f"{on['buckets']['await']:.4f}, commit {on['buckets']['commit']:.4f}}}"
        f" explained by their substages "
        f"{ {k: round(v, 3) for k, v in covered.items()} } (tolerance "
        f"{held}: the larger of 10% and {floor * 1e3:.2f} ms, 100 ms over "
        f"{ATTRIBUTION_FLOOR_BLOCKS} blocks scaled to {n})")
    log(f"phase 15 (a) seconds a block by substage: {per_block}")
    log(f"phase 15 (a) device: {on['kernels']} kernel events, busy "
        f"{on['busy_ms']} ms of {on['wall_ms']:.1f} ms wall, idle share "
        f"{'not measured' if idle is None else f'{idle:.4f}'} (torch.profiler"
        f" over the traced run; "
        f"{mark}: hand-written "
        f"kernels recorded {on['seen']} of launched {on['launched']}, "
        f"launched on the pipe's stage thread)")
    return {"per_block_s": per_block, "idle": idle, "complete": complete}


def obs_lens(torch, dev) -> None:
    """15 (b): one armed GpuVerifier dispatch of a 1000-tx block's
    signatures in the 2048-lane bucket inside the device lens; its
    trace's kernel events per name must equal the window's launches.
    Run it before any profiler window of the process (OBS_PARTS)."""
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.observability import tracing
    from fabric_mod_tpu_torch.ops import _build
    from fabric_mod_tpu_torch.utils import fixtures
    items, expect = fixtures.make_block(N_BLOCKS - 1, n_tx=TX_PER_BLOCK,
                                        raw_endorsers=True)
    items, expect = items[:LANES], expect[:LANES]
    out_dir = os.path.join("chiprun_out", "phase15_lens")
    verifier = gpu.GpuVerifier(device=dev, cache_size=0,
                               profile_dir=out_dir)
    verifier.verify_many(items[:8])                # outside the window
    tracing.rearm_device_profile()
    t0 = time.perf_counter()
    with tracing.active():
        mask = verifier.verify_many(items)
    wall = time.perf_counter() - t0
    lens = tracing.last_lens()
    if lens is None or lens.path is None or not os.path.exists(lens.path):
        raise AssertionError("phase 15 (b): the lens wrote no trace")
    if not (mask == expect).all():
        raise AssertionError("phase 15 (b): verdicts differ from the "
                             "construction")
    table = lens.kernel_table()
    want = {"sha256_e", "verify_prologue", "ladder_projective",
            "verify_epilogue"}
    log(f"phase 15 (b) device lens: one dispatch of {len(items)} lanes "
        f"(a 1000-tx block's, endorser lanes raw) in {wall:.3f} s inside "
        f"the window; kernel: (launches, trace events) {table}; trace "
        f"{lens.path} ({os.path.getsize(lens.path)} bytes); kernel builds "
        f"and loads so far {tracing.compile_count()} "
        f"(_build.build_count {_build.build_count()})")
    if set(table) != want or any(a != b or a < 1 for a, b in table.values()):
        raise AssertionError(f"phase 15 (b): the lens' trace does not hold "
                             f"every launch of its window: {table}")


def storm_material():
    """One org's channel, solo, 16-tx blocks every 100 ms, and 8 client
    identities (the client and 7 more peers of the seeded network: one
    token bucket each) — bench.py:2568's storm world."""
    from fabric_mod_tpu_torch.bccsp import sw
    from fabric_mod_tpu_torch.e2e import _signer
    from fabric_mod_tpu_torch.utils import fixtures
    mat = fixtures.make_network_material(
        SEED, STORM_CHANNEL, max_message_count=STORM_MAX_MESSAGES,
        batch_timeout=STORM_BATCH_TIMEOUT_15,
        gossip_peers=STORM_CLIENTS - 1)
    csp = sw.SwCSP()
    clients = [_signer(csp, p) for p in [mat.client, *mat.gossip_peers]]
    return mat, csp, clients


def storm_envelopes(clients, per_client: int):
    """Pre-signed envelopes, one Writers signature each, distinct tx ids
    (bench.py `_storm_envelopes`): [(client index, tx id, envelope)]."""
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    out = []
    for ci, signer in enumerate(clients):
        creator = signer.serialize()
        for j in range(per_client):
            tx_id = f"storm-c{ci}-{j}"
            ch = protoutil.make_channel_header(
                m.HeaderType.ENDORSER_TRANSACTION, STORM_CHANNEL,
                tx_id=tx_id)
            sh = protoutil.make_signature_header(creator,
                                                 protoutil.new_nonce())
            payload = protoutil.make_payload(ch, sh,
                                             b"storm-%d-%d" % (ci, j))
            out.append((ci, tx_id, protoutil.sign_envelope(payload, signer)))
    return out


def storm_arm(root, by_client, world, gated: bool, drain_delay_s: float,
              queue_cap: int, verify_many, staged: int = 0) -> dict:
    """One storm run (bench.py `_storm_arm`): every client thread pushes
    its envelopes as fast as ingress admits them; a sleep before each
    block write caps the drain (`drain_delay_s` 0: unthrottled).
    Returns the figures after the consistency gate: every admitted
    envelope committed exactly once, every shed typed."""
    from collections import Counter
    from fabric_mod_tpu_torch.orderer import Broadcast, Registrar
    from fabric_mod_tpu_torch.orderer.admission import (
        AdmissionController, ResourceExhaustedError)
    from fabric_mod_tpu_torch.e2e import _signer
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    mat, csp, _clients = world
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        registrar = Registrar(tmp, _signer(csp, mat.orderer), csp,
                              verify_many=verify_many,
                              submit_queue_cap=queue_cap if gated else 0)
        support = registrar.create_channel(m.Block.decode(mat.genesis))
        if drain_delay_s > 0:
            orig = support.writer.write_block

            def slow_write(block, *a, _orig=orig, **kw):
                time.sleep(drain_delay_s)
                return _orig(block, *a, **kw)
            support.writer.write_block = slow_write
        bcast = Broadcast(registrar, staged_batch=staged,
                          admission=(AdmissionController(queue_cap=queue_cap)
                                     if gated else None))
        admitted, shed, errors, latencies = [], [], [], []
        lock, stop, depth = threading.Lock(), threading.Event(), [0]

        def monitor():
            while not stop.is_set():
                depth[0] = max(depth[0],
                               support.chain.submit_queue_depth()[0])
                time.sleep(0.002)

        def client_main(mine):
            acc, sh, lat, errs = [], [], [], []
            for tx_id, env in mine:
                t0 = time.perf_counter()
                try:
                    bcast.submit(env)
                    lat.append(time.perf_counter() - t0)
                    acc.append(tx_id)
                except ResourceExhaustedError as e:
                    sh.append((tx_id, e.reason))
                except Exception as e:             # the gate below fails
                    errs.append((tx_id, repr(e)))
            with lock:
                admitted.extend(acc)
                shed.extend(sh)
                latencies.extend(lat)
                errors.extend(errs)
        threads = [threading.Thread(target=client_main, args=(ce,),
                                    daemon=True) for ce in by_client]
        mon = threading.Thread(target=monitor, daemon=True)
        mon.start()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        burst_s = time.perf_counter() - t0
        store = support.store
        deadline = time.time() + max(120.0,
                                     2 * len(admitted) * drain_delay_s + 30)
        while time.time() < deadline:
            if sum(len(store.get_block_by_number(i).data.data)
                   for i in range(1, store.height)) >= len(admitted):
                break
            time.sleep(0.02)
        drain_s = time.perf_counter() - t0 - burst_s
        stop.set()
        mon.join(timeout=2)
        committed = [protoutil.envelope_channel_header(env).tx_id
                     for n in range(1, store.height)
                     for env in protoutil.get_envelopes(
                         store.get_block_by_number(n))]
        bcast.close()
        registrar.close()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"phase 15 (c): {len(errors)} untyped "
                             f"failures, e.g. {errors[:3]}")
    dupes = {t: c for t, c in Counter(committed).items() if c > 1}
    if dupes or set(committed) != set(admitted):
        raise AssertionError(
            f"phase 15 (c): committed != admitted exactly once (double "
            f"{len(dupes)}, lost {len(set(admitted) - set(committed))}, "
            f"shed but committed {len(set(committed) - set(admitted))})")
    lat = sorted(latencies)
    reasons = dict(Counter(r for _t, r in shed))
    return {"accepted": len(admitted), "shed": len(shed),
            "shed_reasons": reasons,
            "p99_admission_ms": (lat[int(0.99 * (len(lat) - 1))] * 1e3
                                 if lat else 0.0),
            "accepted_tx_per_s": len(admitted) / burst_s,
            "sustained_tx_per_s": len(admitted) / (burst_s
                                                   + max(0.0, drain_s)),
            "max_queue_depth": depth[0], "burst_s": burst_s,
            "drain_s": max(0.0, drain_s)}


def obs_storm(torch, dev) -> None:
    """15 (c): bench.py:2568's broadcast storm at its width (8 clients,
    16-tx blocks, queue cap 64), cut to STORM_TXS_15 pre-signed
    envelopes, a write_block sleep pinning the
    drain to ~1/4 of the measured submit capacity, the gated arm
    (bounded queue and overload gate) against the ungated; then the
    unthrottled pair, unstaged against staged (64), the Writers checks
    on the card in every arm."""
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.bccsp.api import VerifyItem
    from fabric_mod_tpu_torch.orderer import Broadcast, Registrar
    from fabric_mod_tpu_torch.e2e import _signer
    from fabric_mod_tpu_torch.protos import messages as m
    world = storm_material()
    mat, csp, clients = world
    # bench.py's device arms: the verifier's verify_many, cache off (the
    # same envelopes replay in every arm), its 8- and 64-lane buckets
    # warmed outside the arms
    verifier = gpu.GpuVerifier(device=dev, cache_size=0)
    verify_many = verifier.verify_many
    for n in (1, STORM_STAGED):
        # distinct junk items: identical ones would dedup to one lane
        verify_many([VerifyItem((b"storm-warm-%08d" % i).ljust(32, b"\0"),
                                bytes(8), bytes(64)) for i in range(n)])
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        per_client = STORM_TXS_15 // STORM_CLIENTS
        envs = storm_envelopes(clients, per_client)
        by_client = [[(tx, env) for ci, tx, env in envs if ci == i]
                     for i in range(STORM_CLIENTS)]
        cal = storm_envelopes(clients[:1], STORM_MAX_MESSAGES)
        log(f"phase 15 (c) fixtures: {len(envs)} + {len(cal)} envelopes "
            f"signed in {time.perf_counter() - t0:.1f} s")
        registrar = Registrar(os.path.join(root, "cal"),
                              _signer(csp, mat.orderer), csp,
                              verify_many=verify_many)
        registrar.create_channel(m.Block.decode(mat.genesis))
        bcast = Broadcast(registrar)
        t0 = time.perf_counter()
        for _ci, _tx, env in cal:
            bcast.submit(env)
        per_submit_s = max(1e-5, (time.perf_counter() - t0) / len(cal))
        registrar.close()
        drain_delay_s = STORM_OVERLOAD * per_submit_s * STORM_MAX_MESSAGES
        queue_cap = max(STORM_MAX_MESSAGES,
                        min(4 * STORM_MAX_MESSAGES, len(envs) // 4))
        log(f"phase 15 (c) calibration: {per_submit_s * 1e3:.3f} ms a "
            f"submit -> offered ~{1 / per_submit_s:,.0f} tx/s, drain "
            f"capped at ~{STORM_MAX_MESSAGES / drain_delay_s:,.0f} tx/s; "
            f"queue cap {queue_cap}")
        arms = {}
        arms["gated"] = storm_arm(root, by_client, world, True,
                                  drain_delay_s, queue_cap, verify_many)
        arms["ungated"] = storm_arm(root, by_client, world, False,
                                    drain_delay_s, queue_cap,
                                    verify_many)
        arms["unstaged"] = storm_arm(root, by_client, world, True, 0.0,
                                     queue_cap, verify_many)
        arms["staged"] = storm_arm(root, by_client, world, True, 0.0,
                                   queue_cap, verify_many,
                                   staged=STORM_STAGED)
    gated, ungated = arms["gated"], arms["ungated"]
    if gated["max_queue_depth"] > queue_cap:
        raise AssertionError(f"phase 15 (c): gated queue depth "
                             f"{gated['max_queue_depth']} > cap {queue_cap}")
    if not gated["shed"]:
        raise AssertionError("phase 15 (c): the gated arm shed nothing")
    if ungated["shed"]:
        raise AssertionError("phase 15 (c): the ungated arm shed")
    for name, arm in arms.items():
        log(f"phase 15 (c) storm {name}: accepted {arm['accepted']}, shed "
            f"{arm['shed']} {arm['shed_reasons']}, p99 admission "
            f"{arm['p99_admission_ms']:.3f} ms, accepted "
            f"{arm['accepted_tx_per_s']:.1f} tx/s, sustained "
            f"{arm['sustained_tx_per_s']:.1f} tx/s (burst "
            f"{arm['burst_s']:.2f} s, drain {arm['drain_s']:.2f} s), max "
            f"queue depth {arm['max_queue_depth']}")
    ratio = arms["staged"]["sustained_tx_per_s"] / max(
        arms["unstaged"]["sustained_tx_per_s"], 1e-9)
    log(f"phase 15 (c): every admitted envelope committed exactly once and "
        f"every shed typed in all four arms; staged / unstaged sustained "
        f"{ratio:.3f}")


def _chain_bytes(store, lo=0, hi=None):
    hi = store.height if hi is None else hi
    return [store.get_block_by_number(i).encode() for i in range(lo, hi)]


def obs_participation(torch, dev, pre, post) -> None:
    """15 (d): a three-orderer Raft network (phase 9's) orders `pre`;
    a config update adds orderer3 to the consenter set; orderer3 joins
    from that config block, replicating the chain and verifying every
    block on the card; orderer4, not a member, follows from genesis;
    the cluster with orderer3 orders `post`.  Gates: the follower's
    chain and orderer3's replicated blocks byte-equal to the source's,
    orderer3's own blocks equal but for its verified signature, and a
    source with one flipped orderer-signature byte refused."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.channelconfig import (compute_update,
                                                    signed_update_envelope)
    from fabric_mod_tpu_torch.orderer import Registrar
    from fabric_mod_tpu_torch.orderer.participation import (
        ChannelParticipation, FollowerChain, ParticipationError,
        store_fetcher)
    from fabric_mod_tpu_torch.peer.mcs import MessageCryptoService
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.utils import fixtures
    material = fixtures.make_network_material(
        SEED, consensus_type="etcdraft", orderers=RAFT_ORDERERS,
        spare_orderers=2, max_message_count=TX_PER_BLOCK,
        batch_timeout=E2E_BATCH_TIMEOUT,
        preferred_max_bytes=E2E_PREFERRED_MAX_BYTES)
    member, follower_id = "orderer3", "orderer4"
    verifier = gpu.GpuVerifier(device=dev, cache_size=0)
    with tempfile.TemporaryDirectory() as root:
        net = e2e.Network(root, material=material, verifier=verifier,
                          election_timeout=RAFT_ELECTION_TIMEOUT,
                          heartbeat_s=RAFT_HEARTBEAT_S)
        try:
            src = net.orderers[0].support

            def txs():
                return sum(len(src.store.get_block_by_number(i).data.data)
                           for i in range(1, src.store.height))

            def feed(envs):
                want = txs() + len(envs)
                for env in envs:
                    net.broadcast.submit(env)
                deadline = time.monotonic() + E2E_TIMEOUT_S
                while txs() < want and time.monotonic() < deadline:
                    time.sleep(0.01)
                if txs() < want:
                    raise AssertionError("phase 15 (d): the cluster did not "
                                         "order the stream in time")
            feed(pre)
            cur = src.bundle().config
            ids = list(src.bundle().orderer.consenters())
            desired = fixtures.config_with_consenters(cur, ids + [member])
            net.broadcast.submit(signed_update_envelope(
                net.channel_id, compute_update(net.channel_id, cur,
                                               desired.channel_group),
                [net.orderer_admin]))
            deadline = time.monotonic() + 60
            while any(o.support.sequence() != 1 for o in net.orderers) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            join_block = src.store.get_block_by_number(src.writer.last_config)
            h = join_block.header.number + 1
            if h < 3 or any(o.support.sequence() != 1 for o in net.orderers):
                raise AssertionError(f"phase 15 (d): the membership update "
                                     f"did not apply (join height {h})")
            # a copy of the source with one flipped signature byte
            tampered_at = 1
            honest = store_fetcher(src.store)

            def tampered(lo, hi):
                return [m.Block.decode(fixtures.tamper_block_signature(
                    b.encode())) if b.header.number == tampered_at else b
                    for b in honest(lo, hi)]
            reg = Registrar(os.path.join(root, "tampered"),
                            e2e._signer(net.csp,
                                        material.consenters[member]),
                            net.csp, verifier=verifier,
                            block_fetcher=tampered)
            try:
                try:
                    ChannelParticipation(reg).join(join_block)
                except ParticipationError as e:
                    refused = str(e)
                else:
                    raise AssertionError("phase 15 (d): a join from the "
                                         "tampered source was accepted")
            finally:
                reg.close()
            reg = Registrar(os.path.join(root, "tampered_follower"),
                            e2e._signer(net.csp,
                                        material.consenters[follower_id]),
                            net.csp, verifier=verifier,
                            block_fetcher=tampered)
            try:
                bad = ChannelParticipation(reg).join(
                    m.Block.decode(material.genesis), as_follower=True)
                deadline = time.monotonic() + 60
                while bad.chain.rejected != [tampered_at] \
                        and time.monotonic() < deadline:
                    time.sleep(0.05)
                time.sleep(1.0)                    # a few more polls
                if bad.chain.rejected != [tampered_at] \
                        or bad.store.height != tampered_at \
                        or bad.chain.errors:
                    raise AssertionError(
                        f"phase 15 (d): the follower of the tampered source "
                        f"holds {bad.store.height} blocks, refused "
                        f"{bad.chain.rejected}, errors {bad.chain.errors}")
            finally:
                reg.close()
            t0 = time.perf_counter()
            joined = net.join_orderer(member, join_block)
            join_s = time.perf_counter() - t0
            follower = net.join_orderer(follower_id,
                                        m.Block.decode(material.genesis),
                                        as_follower=True)
            if not isinstance(follower.support.chain, FollowerChain):
                raise AssertionError("phase 15 (d): orderer4 is not a "
                                     "follower")
            feed(post)
            deadline = time.monotonic() + 120
            while len({o.support.store.height for o in net.orderers}) != 1 \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            top = src.store.height
            if {o.support.store.height for o in net.orderers} != {top} \
                    or top < h + 2:
                raise AssertionError(
                    f"phase 15 (d): heights "
                    f"{[(o.id, o.support.store.height) for o in net.orderers]}"
                    f", join height {h}")
            if _chain_bytes(follower.support.store) != _chain_bytes(src.store):
                raise AssertionError("phase 15 (d): the follower's block "
                                     "file differs from the source's")
            mine = joined.support.store
            if _chain_bytes(mine, 0, h) != _chain_bytes(src.store, 0, h):
                raise AssertionError("phase 15 (d): the joiner's replicated "
                                     "blocks differ from the source's")
            mcs = MessageCryptoService(joined.support.bundle, verifier)
            me = e2e._signer(net.csp, material.consenters[member]).serialize()
            for i in range(h, top):
                got, want = mine.get_block_by_number(i), \
                    src.store.get_block_by_number(i)
                if got.header.encode() != want.header.encode() \
                        or got.data.encode() != want.data.encode():
                    raise AssertionError(f"phase 15 (d): block {i} differs "
                                         f"on the joiner")
                mcs.verify_block(net.channel_id, got)
                meta = m.Metadata.decode(got.metadata.metadata[
                    m.BlockMetadataIndex.SIGNATURES])
                if m.SignatureHeader.decode(
                        meta.signatures[0].signature_header).creator != me:
                    raise AssertionError(f"phase 15 (d): block {i} of the "
                                         f"joiner is not its own")
            chain = follower.support.chain
            if chain.rejected or chain.errors:
                raise AssertionError("phase 15 (d): the follower refused an "
                                     "honest block")
            log(f"phase 15 (d) participation: {RAFT_ORDERERS} Raft orderers "
                f"ordered {len(pre)} txs; a config update added {member} "
                f"(block {h - 1}); {member} joined from it, replicating and "
                f"verifying on the card {h} blocks in {join_s:.3f} s "
                f"({h / join_s:.1f} blocks replicated/s), then the "
                f"{len(net.orderers) - 1} consenters ordered {len(post)} more "
                f"txs into {top - h} blocks; the follower {follower_id} "
                f"holds all {top} blocks byte-equal to the source; {member}'s "
                f"blocks 0..{h - 1} byte-equal, {h}..{top - 1} equal but for "
                f"its own signature, verified on the card; the tampered "
                f"source (block {tampered_at}'s signature) refused on the "
                f"join ({refused[:60]}...) and by a follower (stopped at "
                f"{tampered_at})")
        finally:
            net.close()


# phase 15 part -> (kernel launches, seconds).  (b), the device lens,
# runs right after phase 3, before any other dispatch of the process and
# before any profiler window: after a window of ~10^5 device activity
# records torch.profiler records (almost) no device activity in later
# windows of the process (scripts/torch_lens_stress.py, PERF.md §7).
# (a) runs right after phase 8's arms for the same reason; (c) and (d)
# at the end.
OBS_PARTS: dict = {}


def obs_part(name: str, fn, *args) -> None:
    """One part of phase 15, the kernel counts set to 0 just before it
    and read just after."""
    reset_kernel_counts()
    t0 = time.perf_counter()
    fn(*args)
    OBS_PARTS[name] = (kernel_counts(), time.perf_counter() - t0)


def phase_observability(torch, dev, pre, post) -> dict:
    """Phase 15: (a) the traced commit, (b) the device lens, (c) the
    storm, (d) participation; runs the parts not yet run and returns
    the four parts' kernel launches summed."""
    if "b" not in OBS_PARTS:
        obs_part("b", obs_lens, torch, dev)
    if "a" not in OBS_PARTS:
        obs_part("a", obs_traced_commit, torch)
    obs_part("c", obs_storm, torch, dev)
    obs_part("d", obs_participation, torch, dev, pre, post)
    launched: dict = {}
    for counts, _secs in OBS_PARTS.values():
        for k, v in counts.items():
            launched[k] = launched.get(k, 0) + v
    require_launched({k: launched[k] for k in CORE_KERNELS}, "phase 15")
    log(f"observability phase: parts "
        f"{ {k: round(v[1], 1) for k, v in sorted(OBS_PARTS.items())} } s "
        f"wall; kernel launches {launched}")
    return launched


# phase 16: the service surface at BASELINE.md #2's width (1000-tx blocks,
# 3 orgs, the 2-of-3 MAJORITY default, signatures verified by the card)
SVC_MEMBER_QUERIES = 1024
SVC_FLIPPED_QUERIES = 512
SVC_OUTSIDE_QUERIES = 512
SVC_THREADS = 8
# (a)'s config update: the batch timeout the lifecycle ceremony then waits
SVC_BATCH_TIMEOUT = "200ms"
SVC_POLICY = "AND('Org1.peer', 'Org3.peer')"
# (d): how often the HTTPS scraper reads /metrics and /healthz meanwhile
SVC_SCRAPE_EVERY_S = 0.25
# the child process serving the KV contract over the ccaas protocol: it
# puts the checkout on its own path and imports the port alone
CCAAS_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
from fabric_mod_tpu_torch.peer.chaincode import KvContract
from fabric_mod_tpu_torch.peer.extbuilder import ChaincodeServer
srv = ChaincodeServer(KvContract())
srv.start()
print(srv.address, flush=True)
sys.stdin.read()
srv.stop()
bad = [n for n in sys.modules if n.split(".")[0] in
       ("jax", "fabric_mod_tpu", "cryptography")]
print("modules", bad, flush=True)
"""


def svc_material(consensus_type="solo", orderers=1, **extra):
    """Phase 8's material (SEED: the same client, peer and admin
    certificates, so phase 8's endorsed stream is valid on it)."""
    from fabric_mod_tpu_torch.utils import fixtures
    return fixtures.make_network_material(
        SEED, consensus_type=consensus_type, orderers=orderers,
        max_message_count=TX_PER_BLOCK, batch_timeout=E2E_BATCH_TIMEOUT,
        preferred_max_bytes=E2E_PREFERRED_MAX_BYTES, **extra)


def svc_feed(net, submits):
    """Broadcast `submits` in order from one thread: every accepted
    envelope taken, every tampered one refused."""
    from fabric_mod_tpu_torch.orderer import BroadcastError
    for env, ok in submits:
        try:
            net.broadcast.submit(env)
        except BroadcastError:
            if ok:
                raise
            continue
        if not ok:
            raise AssertionError("Broadcast accepted a tampered creator "
                                 "signature")


def svc_commit(net, submits, expected, fingerprint, where):
    """Order and commit `submits` through `net` (the deliver client and
    one submitter, as phase 8 (a)); every block TX_PER_BLOCK txs with
    the construction's flags, the state `fingerprint`.  Returns the
    commit span in seconds."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.protos import protoutil
    n_tx = len(expected)
    _client, committed, span_s = e2e.commit_until(
        net, n_tx, E2E_TIMEOUT_S, feed=lambda: svc_feed(net, submits),
        idle_timeout_s=E2E_TIMEOUT_S)
    if committed != n_tx or net.ledger.height != 1 + n_tx // TX_PER_BLOCK:
        raise AssertionError(f"{where}: {committed} txs committed, height "
                             f"{net.ledger.height}")
    flags = [f for n in range(1, net.ledger.height)
             for f in protoutil.block_txflags(net.ledger.get_block_by_number(n))]
    if flags != list(expected):
        raise AssertionError(f"{where}: txflags differ from the construction")
    if net.ledger.state_fingerprint() != fingerprint:
        raise AssertionError(f"{where}: the state fingerprint differs from "
                             f"phase 8 (a)'s")
    return span_s


def svc_external(torch, dev, root, full, solo_fp):
    """16 (b): the KV contract as a ccaas package served by a
    ChaincodeServer in a child process, resolved through a
    ChaincodeLauncher as the endorsers' `mycc`; phase 8 (a)'s
    transactions (the same args, plants and order) endorsed over TCP,
    ordered and committed on the card into 2 x 1000-tx blocks: flags
    and fingerprint equal to phase 8 (a)'s in-process contract arm.
    Returns the network, the child and the launcher (part (a) runs on
    them; the caller closes them)."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.peer.ccpackage import PackageStore, build_package
    from fabric_mod_tpu_torch.peer.extbuilder import (ChaincodeLauncher,
                                                      ExternalContract)
    from fabric_mod_tpu_torch.utils import fixtures
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-c", CCAAS_CHILD, str(Path(__file__).resolve().parent)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    address = child.stdout.readline().strip()
    if not address:
        raise AssertionError(f"phase 16 (b): the chaincode server did not "
                             f"start (exit {child.poll()})")
    started_s = time.perf_counter() - t0
    store = PackageStore(os.path.join(root, "packages"))
    pkg_id = store.save(build_package(
        "mycc", json.dumps({"address": address}).encode(), cc_type="ccaas"))
    launcher = ChaincodeLauncher(store)
    net = e2e.Network(os.path.join(root, "external"), material=svc_material(),
                      verifier=gpu.GpuVerifier(device=dev, cache_size=0),
                      tensor_policy=True, pipeline_depth=OBS_DEPTH)
    try:
        # the in-process KV contract out, the launcher in: mycc resolves
        # to the installed package on its first endorsement
        net.chaincodes.unregister("mycc")
        n_tx = len(full[1])
        timing = {"calls": 0, "secs": 0.0}
        resolved = []

        def resolve(name):
            contract = launcher.resolve(name)
            if isinstance(contract, ExternalContract) and not resolved:
                resolved.append(contract)
                invoke = contract.invoke

                def timed(stub):
                    t = time.perf_counter()
                    try:
                        return invoke(stub)
                    finally:
                        timing["calls"] += 1
                        timing["secs"] += time.perf_counter() - t
                contract.invoke = timed
            return contract
        net.chaincodes.set_resolver(resolve)
        t0 = time.perf_counter()
        submits, flat = fixtures.make_e2e_stream(net, n_tx, PLANT_EVERY)
        endorse_s = time.perf_counter() - t0
        if not resolved or timing["calls"] < n_tx:
            raise AssertionError(f"phase 16 (b): mycc resolved to "
                                 f"{[type(c).__name__ for c in resolved]}, "
                                 f"{timing['calls']} remote invokes")
        if flat != full[1]:
            raise AssertionError("phase 16 (b): the stream's construction "
                                 "differs from phase 8 (a)'s")
        reset_kernel_counts()
        span_s = svc_commit(net, submits, flat, solo_fp, "phase 16 (b)")
        counts = kernel_counts()
        require_launched({k: counts[k] for k in CORE_KERNELS}, "phase 16 (b)")
        log(f"phase 16 (b) external chaincode: package {pkg_id[:24]}... "
            f"(ccaas) resolved through the ChaincodeLauncher to a chaincode "
            f"server in a child process (up in {started_s:.2f} s); {n_tx} "
            f"txs endorsed over TCP in {endorse_s:.1f} s "
            f"({endorse_s / n_tx * 1e3:.3f} ms a tx), "
            f"{timing['calls']} remote invokes at "
            f"{timing['secs'] / timing['calls'] * 1e3:.3f} ms each "
            f"(endorser wall: the invoke with its state callbacks); ordered "
            f"and committed on the card in {span_s:.1f} s "
            f"({n_tx / span_s:.1f} tx/s); flags and fingerprint "
            f"({solo_fp[:16]}) == phase 8 (a)'s in-process contract; "
            f"kernel launches {counts}")
        return net, child, launcher
    except BaseException:
        net.close()
        launcher.close()
        svc_stop_child(child)
        raise


def svc_stop_child(child) -> None:
    """End the chaincode server's process (its stdin closed: it stops its
    server and reports its modules) and reap it."""
    try:
        child.stdin.close()
        out = child.stdout.read()
        child.wait(timeout=30)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=10)
    if "modules []" not in out:
        raise AssertionError(f"phase 16 (b): the chaincode process loaded "
                             f"{out.strip()!r}")


def svc_queries(net):
    """(signed queries, expected verdicts): SVC_MEMBER_QUERIES from the
    three orgs' client, peers and admins, SVC_FLIPPED_QUERIES of theirs
    with one signature bit flipped, SVC_OUTSIDE_QUERIES from identities of
    an org outside the channel (Org9, its own CA)."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.msp import ca as calib
    from fabric_mod_tpu_torch.protos.protoutil import SignedData
    from fabric_mod_tpu_torch.utils import fixtures
    members = [net.client, *net.peer_signers.values(), *net.admins.values()]
    ca = calib.CA("ca.org9", "Org9", seed=b"phase16", now=fixtures.CERT_EPOCH)
    outsiders = []
    for i in range(4):
        cert, key = ca.issue(f"client{i}@org9", "Org9", ous=["client"])
        outsiders.append(e2e._signer(net.csp, ("Org9", cert.pem(),
                                               calib.key_pem(key))))
    queries, want = [], []
    for kind, n, signers in (("member", SVC_MEMBER_QUERIES, members),
                             ("flipped", SVC_FLIPPED_QUERIES, members),
                             ("outside", SVC_OUTSIDE_QUERIES, outsiders)):
        for i in range(n):
            s = signers[i % len(signers)]
            data = b"discovery|%s|%d" % (kind.encode(), i)
            sig = s.sign_message(data)
            if kind == "flipped":
                sig = fixtures._flip(sig)
            queries.append(SignedData(data=data, identity=s.serialize(),
                                      signature=sig))
            want.append(kind == "member")
    return queries, want


def svc_pass(svc, queries):
    """Every query through `svc.check_access` from SVC_THREADS threads
    (thread k takes queries k, k + SVC_THREADS, ...); (verdicts, s)."""
    got = [None] * len(queries)
    errors = []

    def run(k):
        try:
            for i in range(k, len(queries), SVC_THREADS):
                got[i] = svc.check_access(queries[i])
        except Exception as e:              # re-raised below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(k,), daemon=True)
               for k in range(SVC_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=E2E_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("phase 16 (a): a discovery thread is blocked")
    if errors:
        raise errors[0]
    return got, wall


def svc_discovery(torch, dev, net):
    """16 (a): 2048 signed discovery queries through
    DiscoveryService.check_access from SVC_THREADS threads, the Readers
    signatures verified by the card (a BatchingVerifyService over a
    GpuVerifier without memo-cache: concurrent queries share launches);
    every verdict the host SwVerifier oracle's; a second pass answered
    by the auth cache with no launch; a config update (BatchTimeout ->
    SVC_BATCH_TIMEOUT) bumps the sequence and the next pass verifies on
    the card again.  Then the lifecycle deploys cc2 (SVC_POLICY) and the
    layouts of cc2 and of mycc (the implicit-meta MAJORITY default) are
    printed.  Each pass reads its launches as a difference of the counts
    and resets nothing, so the counts the caller reads after this part
    hold all three passes, the config update and the deploy."""
    from fabric_mod_tpu_torch.bccsp import gpu, sw
    from fabric_mod_tpu_torch.discovery import DiscoveryService
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.utils import fixtures
    t0 = time.perf_counter()
    queries, want = svc_queries(net)
    signed_s = time.perf_counter() - t0
    oracle_svc = DiscoveryService(net.channel.bundle, net.channel._vinfo,
                                  lambda: {},
                                  verify_many=sw.SwVerifier().verify_many)
    t0 = time.perf_counter()
    oracle = [oracle_svc.check_access(q) for q in queries]
    oracle_s = time.perf_counter() - t0
    if oracle != want:
        raise AssertionError("phase 16 (a): the host oracle's verdicts "
                             "differ from the construction")
    card = gpu.GpuVerifier(device=dev, cache_size=0)
    service = gpu.BatchingVerifyService(card)
    sizes = _cohorts(card)
    members = {org: [m.GossipMember(endpoint=f"peer0.{org.lower()}:7051",
                                    pki_id=org.encode())]
               for org in ("Org1", "Org2", "Org3")}
    svc = DiscoveryService(net.channel.bundle, net.channel._vinfo,
                           lambda: members, verify_many=service.verify_many)
    try:
        passes = []
        for label in ("first", "cached", "after the config update"):
            if label == "after the config update":
                seq = net.channel.bundle().sequence
                desired = fixtures.config_with_batch_timeout(
                    net.channel.bundle().config, SVC_BATCH_TIMEOUT)
                base = net.committed_txs()
                net.update_config(desired, [net.orderer_admin,
                                            net.admins["Org1"],
                                            net.admins["Org2"]])
                if net.pump_committed(base + 1) != base + 1 or \
                        net.channel.bundle().sequence != seq + 1:
                    raise AssertionError("phase 16 (a): the config update "
                                         "did not commit")
            pre, before = kernel_counts(), len(sizes)
            got, wall = svc_pass(svc, queries)
            counts = {k: v - pre[k] for k, v in kernel_counts().items()}
            launched = sum(counts[k] for k in CORE_KERNELS)
            if got != oracle:
                raise AssertionError(f"phase 16 (a) {label} pass: "
                                     f"{sum(a != b for a, b in zip(got, oracle))}"
                                     f" verdicts differ from the oracle's")
            if (launched == 0) != (label == "cached"):
                raise AssertionError(f"phase 16 (a) {label} pass: "
                                     f"{launched} hand-written launches")
            if label != "cached":
                require_launched({k: counts[k] for k in CORE_KERNELS},
                                 f"phase 16 (a) {label} pass")
            passes.append((label, wall, launched, len(sizes) - before,
                           sizes[before:]))
        # a deployed definition (the ceremony at the new batch timeout)
        t0 = time.perf_counter()
        net.deploy_chaincode("cc2", "1.0", 1, policy=_policy(SVC_POLICY))
        deploy_s = time.perf_counter() - t0
        layouts = {cc: [lo.quantities_by_org for lo in
                        svc.peers_for_endorsement(cc).layouts]
                   for cc in ("cc2", "mycc")}
        if layouts != {"cc2": [{"Org1": 1, "Org3": 1}],
                       "mycc": [{"Org1": 1, "Org2": 1}, {"Org1": 1, "Org3": 1},
                                {"Org2": 1, "Org3": 1}]}:
            raise AssertionError(f"phase 16 (a): layouts {layouts}")
        conf = svc.config()
    finally:
        service.close()
    log(f"phase 16 (a) discovery: {len(queries)} signed queries "
        f"({SVC_MEMBER_QUERIES} of the three orgs' members, "
        f"{SVC_FLIPPED_QUERIES} flipped, {SVC_OUTSIDE_QUERIES} from Org9 "
        f"outside the channel; signed in {signed_s:.1f} s) through "
        f"check_access from {SVC_THREADS} threads; every pass's verdicts == "
        f"the host SwVerifier oracle's ({oracle_s:.2f} s serial)")
    for label, wall, launched, calls, cohort in passes:
        mean = sum(cohort) / len(cohort) if cohort else 0.0
        log(f"phase 16 (a) {label} pass: {wall:.3f} s "
            f"({len(queries) / wall:.1f} queries/s), hand-written "
            f"verify-core launches {launched}, calls into the GpuVerifier "
            f"{calls} (mean cohort {mean:.2f})")
    log(f"phase 16 (a) layouts: cc2 ({SVC_POLICY}, deployed by the "
        f"lifecycle in {deploy_s:.1f} s after the batch timeout went to "
        f"{SVC_BATCH_TIMEOUT}) {layouts['cc2']}; mycc (the implicit-meta "
        f"MAJORITY default) {layouts['mycc']}; config(): MSPs "
        f"{sorted(conf['msps'])}")


def svc_scrape(metrics_text: str, name: str) -> float:
    """The summed value of a series' samples in a text exposition."""
    total = 0.0
    for line in metrics_text.splitlines():
        key, _, value = line.rpartition(" ")
        if key == name or key.startswith(name + "{"):
            total += float(value)
    return total


def svc_broker_ops(torch, dev, root, full, solo_fp):
    """16 (c) and (d): two registrars consume one persisted Broker topic
    for a "kafka" channel (the peer's network's orderer and a second
    registrar); phase 8 (a)'s stream submitted in order, the peer
    committing the first registrar's chain on the card (MCS and
    validation), traced, while an HTTPS operations server with a
    required client certificate is scraped, beside an HTTP one with the
    participation routes.  Gates: equal data hashes on both registrars,
    phase 8 (a)'s fingerprint, the ops routes, a restart of the broker
    and the second registrar that resumes from the persisted offset and
    cuts nothing."""
    import ssl
    import urllib.error
    import urllib.request
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import gpu, sw
    from fabric_mod_tpu_torch.msp import ca as calib
    from fabric_mod_tpu_torch.observability import OperationsServer, tracing
    from fabric_mod_tpu_torch.orderer.broker import Broker, BrokerChain
    from fabric_mod_tpu_torch.orderer.participation import ChannelParticipation
    from fabric_mod_tpu_torch.orderer.registrar import Registrar
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.utils import fixtures
    import base64
    import struct
    submits, flat = full
    n_tx = len(flat)
    material = svc_material("kafka", orderers=2)
    broker_dir = os.path.join(root, "broker")
    broker = Broker(broker_dir)
    factory = {"kafka": lambda sup: BrokerChain(broker, sup)}
    net = e2e.Network(os.path.join(root, "kafka"), material=material,
                      verifier=gpu.GpuVerifier(device=dev),
                      tensor_policy=True, consenters=factory,
                      pipeline_depth=OBS_DEPTH)
    csp = sw.SwCSP()
    second = Registrar(os.path.join(root, "second"),
                       e2e._signer(csp, material.consenters["orderer1"]), csp,
                       consenters=factory)
    servers = []
    try:
        second.create_channel(m.Block.decode(material.genesis))
        chains = [net.support.chain, second.get_chain(net.channel_id).chain]
        if not all(isinstance(c, BrokerChain) for c in chains):
            raise AssertionError(f"phase 16 (c): consenters "
                                 f"{[type(c).__name__ for c in chains]}")
        # (d)'s servers: HTTPS with a required client certificate from
        # the port's own CA, HTTP with the participation routes
        ca = calib.CA("ca.ops", "OpsOrg", seed=b"phase16",
                      now=fixtures.CERT_EPOCH)
        pems = {}
        for name, (cert, key) in (
                ("server", ca.issue("localhost", "OpsOrg", ous=["server"])),
                ("client", ca.issue("operator", "OpsOrg", ous=["client"]))):
            for ext, data in (("pem", cert.pem()), ("key", calib.key_pem(key))):
                path = os.path.join(root, f"{name}.{ext}")
                with open(path, "wb") as f:
                    f.write(data)
                pems[f"{name}.{ext}"] = path
        pems["ca"] = os.path.join(root, "ca.pem")
        with open(pems["ca"], "wb") as f:
            f.write(ca.cert_pem())
        https = OperationsServer(tls={"cert": pems["server.pem"],
                                      "key": pems["server.key"],
                                      "client_ca": pems["ca"]})
        plain = OperationsServer(participation=ChannelParticipation(
            net.registrar))
        servers = [https, plain]
        for s in servers:
            s.start()
        ctx = ssl.create_default_context(cafile=pems["ca"])
        ctx.check_hostname = False
        ctx.load_cert_chain(pems["client.pem"], pems["client.key"])
        secure = "https://%s:%d" % https.addr
        base = "http://%s:%d" % plain.addr

        def get(url, context=None, method="GET", body=None):
            req = urllib.request.Request(url, data=body, method=method)
            try:
                with urllib.request.urlopen(req, timeout=60,
                                            context=context) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        code, text = get(secure + "/metrics", ctx)
        series = ("fabric_commitpipe_blocks_total",
                  "fabric_bccsp_verdict_cache_misses",
                  'fabric_trace_substage_seconds_count{stage="device_dispatch"}')
        before = {s: svc_scrape(text.decode(), s) for s in series}
        if code != 200 or get(secure + "/healthz", ctx)[0] != 200:
            raise AssertionError(f"phase 16 (d): /metrics {code}, /healthz "
                                 f"{get(secure + '/healthz', ctx)}")
        refused = False
        bare = ssl.create_default_context(cafile=pems["ca"])
        bare.check_hostname = False
        try:
            get(secure + "/healthz", bare)
        except (ssl.SSLError, urllib.error.URLError, ConnectionError):
            refused = True
        if not refused:
            raise AssertionError("phase 16 (d): HTTPS answered a client "
                                 "without a certificate")

        # the scraper reads /metrics and /healthz over HTTPS while the
        # peer commits
        scrapes, stop = [], threading.Event()

        def scrape():
            while not stop.is_set():
                scrapes.append((get(secure + "/metrics", ctx)[0],
                                get(secure + "/healthz", ctx)[0]))
                stop.wait(SVC_SCRAPE_EVERY_S)
        scraper = threading.Thread(target=scrape, daemon=True)
        tracing.recorder().reset()
        reset_kernel_counts()
        scraper.start()
        try:
            with tracing.active():
                span_s = svc_commit(net, submits, flat, solo_fp,
                                    "phase 16 (c)")
        finally:
            stop.set()
            scraper.join(timeout=60)
        counts = kernel_counts()
        require_launched({k: counts[k] for k in CORE_KERNELS}, "phase 16 (c)")
        if not scrapes or any(c != (200, 200) for c in scrapes):
            raise AssertionError(f"phase 16 (d): scrapes during the commit "
                                 f"{sorted(set(scrapes))}")
        # (c): both registrars cut the same blocks
        stores = [net.support.store, second.get_chain(net.channel_id).store]
        deadline = time.monotonic() + E2E_TIMEOUT_S
        while stores[1].height < stores[0].height:
            if time.monotonic() > deadline:
                raise AssertionError(f"phase 16 (c): heights "
                                     f"{[s.height for s in stores]}")
            time.sleep(0.01)
        hashes = [[s.get_block_by_number(n).header.data_hash
                   for n in range(s.height)] for s in stores]
        if hashes[0] != hashes[1] or len(hashes[0]) != 1 + E2E_BLOCKS:
            raise AssertionError("phase 16 (c): the registrars' blocks differ")
        slot = BrokerChain.OFFSET_MD_SLOT
        offsets = [struct.unpack("<q", stores[0].get_block_by_number(
            n).metadata.metadata[slot])[0] for n in range(1, stores[0].height)]

        # (d): the routes
        code, text = get(secure + "/metrics", ctx)
        after = {s: svc_scrape(text.decode(), s) for s in series}
        moved = {s: after[s] - before[s] for s in series}
        if code != 200 or moved[series[0]] != E2E_BLOCKS or any(
                v <= 0 for v in moved.values()):
            raise AssertionError(f"phase 16 (d): /metrics moved {moved}")
        flight = json.loads(get(base + "/flight")[1])
        timelines = [t["block"] for t in flight["timelines"]
                     if t["consumer"] == "deliver"]
        trace = json.loads(get(base + "/trace?limit=4096")[1])
        names = sorted({s["name"] for s in trace["spans"]})
        if timelines != list(range(1, 1 + E2E_BLOCKS)) or \
                "ledger_write" not in names:
            raise AssertionError(f"phase 16 (d): /flight timelines "
                                 f"{timelines}, /trace {names}")
        spec_put = get(base + "/logspec", method="PUT",
                       body=json.dumps({"spec": "peer=debug:info"}).encode())
        spec_get = json.loads(get(base + "/logspec")[1])
        get(base + "/logspec", method="PUT",
            body=json.dumps({"spec": "info"}).encode())
        threads_code, dump = get(base + "/debug/threads")
        if spec_put[0] != 204 or spec_get != {"spec": "peer=debug:info"} or \
                threads_code != 200 or b"opsserver-http" not in dump:
            raise AssertionError(f"phase 16 (d): /logspec {spec_put[0]} "
                                 f"{spec_get}, /debug/threads {threads_code}")
        # /healthz: a planted staging error poisons the channel's shared
        # pipe (503), the channel discards it (200 again)
        channel = net.channel
        healthy = get(secure + "/healthz", ctx)[0]

        def planted(_block):
            del channel.stage_block
            raise RuntimeError("phase 16 planted stage error")
        channel.stage_block = planted
        pipe = channel.commit_pipeline()
        fake = m.Block.decode(net.ledger.get_block_by_number(
            net.ledger.height - 1).encode())
        fake.header.number = net.ledger.height
        pipe.submit(fake)
        try:
            pipe.flush(E2E_TIMEOUT_S)
            raise AssertionError("phase 16 (d): the planted error did not "
                                 "fail the pipe")
        except RuntimeError as e:
            if "planted" not in str(e):
                raise
        poisoned, body = get(secure + "/healthz", ctx)
        failed = json.loads(body)["failed_checks"]
        if channel.commit_pipeline() is pipe or not pipe.closed:
            raise AssertionError("phase 16 (d): the channel kept the pipe")
        healed = get(secure + "/healthz", ctx)[0]
        if (healthy, poisoned, healed) != (200, 503, 200) or not any(
                k.startswith("commitpipe[channel#") and "planted" in v
                for k, v in failed.items()):
            raise AssertionError(f"phase 16 (d): /healthz {healthy} -> "
                                 f"{poisoned} {failed} -> {healed}")
        # participation: the list, and a REST join equal to a direct one
        listed = json.loads(get(base + "/participation/v1/channels")[1])
        want_list = {"channels": [{"name": net.channel_id,
                                   "height": 1 + E2E_BLOCKS,
                                   "status": "active"}]}
        join_material = fixtures.make_network_material(SEED, "svcjoin")
        code, joined = get(base + "/participation/v1/channels", method="POST",
                           body=json.dumps({"config_block": base64.b64encode(
                               join_material.genesis).decode()}).encode())
        direct = ChannelParticipation(second).join(
            m.Block.decode(join_material.genesis))
        info = json.loads(get(base + "/participation/v1/channels/svcjoin")[1])
        removed = get(base + "/participation/v1/channels/svcjoin",
                      method="DELETE")[0]
        if listed != want_list or code != 201 or json.loads(joined) != {
                "name": direct.channel_id, "height": direct.store.height} or \
                info != ChannelParticipation(second).channel_info("svcjoin") \
                or removed != 204:
            raise AssertionError(f"phase 16 (d): participation {listed}, "
                                 f"join {code} {joined}, info {info}, "
                                 f"remove {removed}")
        for s in servers:
            s.stop()
        servers = []

        # (c): a restart of the broker and the second registrar resumes
        # from the offset in its tip and cuts nothing
        tip = stores[1].height
        blocks = [stores[1].get_block_by_number(n).encode()
                  for n in range(tip)]
        second.close()
        second = None
        t0 = time.perf_counter()
        broker2 = Broker(broker_dir)
        try:
            second = Registrar(
                os.path.join(root, "second"),
                e2e._signer(csp, material.consenters["orderer1"]), csp,
                consenters={"kafka": lambda sup: BrokerChain(broker2, sup)})
            chain = second.get_chain(net.channel_id).chain
            topic = len(broker2.read(net.channel_id, 0, timeout_s=0))
            time.sleep(1.0)               # a wrong consumer would re-cut now
            store = second.get_chain(net.channel_id).store
            again = [store.get_block_by_number(n).encode()
                     for n in range(store.height)]
            if chain.consumed != offsets[-1] + 1 or topic != offsets[-1] + 1 \
                    or again != blocks or len(broker2.read(
                        net.channel_id, 0, timeout_s=0)) != topic:
                raise AssertionError(f"phase 16 (c): after the restart "
                                     f"consumed {chain.consumed}, topic "
                                     f"{topic}, offsets {offsets}, height "
                                     f"{store.height} (was {tip})")
            restart_s = time.perf_counter() - t0
        finally:
            if second is not None:
                second.close()
                second = None
            broker2.close()
    finally:
        for s in servers:
            s.stop()
        if second is not None:
            second.close()
        net.close()
        broker.close()
    log(f"phase 16 (c) broker consenter: {n_tx} txs of phase 8 (a)'s stream "
        f"ordered through one persisted topic consumed by 2 registrars and "
        f"committed on the card by the peer in {span_s:.1f} s "
        f"({n_tx / span_s:.1f} tx/s): equal data hashes on both, the "
        f"offsets stamped {offsets}, fingerprint == phase 8 (a)'s "
        f"({solo_fp[:16]}); the broker and the second registrar restarted "
        f"in {restart_s:.2f} s resumed at offset {offsets[-1] + 1} with "
        f"nothing re-cut; kernel launches {counts}")
    log(f"phase 16 (d) operations servers: {len(scrapes)} HTTPS scrapes of "
        f"/metrics and /healthz during the commit, all 200 (a client "
        f"without a certificate refused); /metrics moved "
        f"{ {k.split('{')[0]: v for k, v in moved.items()} }; /flight "
        f"timelines of blocks {timelines}; /trace span names {names}; "
        f"/logspec round trip; /debug/threads; /healthz {healthy} -> "
        f"{poisoned} (a planted stage error) -> {healed} (the pipe "
        f"discarded); /participation lists {listed['channels']}, a REST "
        f"join {json.loads(joined)} == ChannelParticipation.join's")


def phase_services(torch, dev, full, solo_fp) -> dict:
    """Phase 16: (b) external chaincode, then (a) discovery on its
    network, then (c) and (d) the broker consenter under the operations
    servers.  `full` is phase 8 (a)'s stream and `solo_fp` its
    fingerprint.  Returns the parts' kernel launches summed."""
    t_phase = time.perf_counter()
    parts = {}      # part -> (kernel launches, seconds)
    with tempfile.TemporaryDirectory() as root:
        reset_kernel_counts()
        t0 = time.perf_counter()
        net, child, launcher = svc_external(torch, dev, root, full, solo_fp)
        try:
            parts["b"] = (kernel_counts(), time.perf_counter() - t0)
            reset_kernel_counts()
            t0 = time.perf_counter()
            svc_discovery(torch, dev, net)
            parts["a"] = (kernel_counts(), time.perf_counter() - t0)
        finally:
            net.close()
            launcher.close()
            svc_stop_child(child)
        reset_kernel_counts()
        t0 = time.perf_counter()
        svc_broker_ops(torch, dev, root, full, solo_fp)
        parts["cd"] = (kernel_counts(), time.perf_counter() - t0)
    launched: dict = {}
    for counts, _secs in parts.values():
        for k, v in counts.items():
            launched[k] = launched.get(k, 0) + v
    require_launched({k: launched[k] for k in CORE_KERNELS}, "phase 16")
    log(f"services phase: {time.perf_counter() - t_phase:.1f} s wall, parts "
        f"{ {k: round(v[1], 1) for k, v in sorted(parts.items())} } s, "
        f"ladder launches "
        f"{ {k: v[0]['ladder_projective'] for k, v in sorted(parts.items())} }; "
        f"kernel launches {launched}")
    return launched

# ---------------------------------------------------------------------------
# phase 17: the soak under churn (the reference's acceptance soak,
# tests/test_soak.py:137-148), fault seams against the card, the sharded
# soak (tests/test_soak.py:195-213)
# ---------------------------------------------------------------------------

SOAK_SEED = 8
SOAK_EVENTS = 9
SOAK_SHARDED_EVENTS = 3
SOAK_FAULT_ITEMS = 32


def soak_config(**kw):
    from fabric_mod_tpu_torch.soak import SoakConfig
    return SoakConfig(seed=SOAK_SEED, n_channels=2, n_peers=2,
                      gap_txs=(3, 5), recovery_window_s=60.0, **kw)


def soak_report(tag: str, rep: dict, counts: dict) -> None:
    """Gates the harness does not (it gates convergence, exactly-once,
    the revocation cut, fault fires and leaks itself), then the figures."""
    from fabric_mod_tpu_torch.soak import CORE_KINDS
    kinds = [e["kind"] for e in rep["events"]]
    if not rep["x509_txs"] or rep["audited_txs"] != rep["x509_txs"]:
        raise AssertionError(f"phase 17 {tag}: audited {rep['audited_txs']} "
                             f"of {rep['x509_txs']} admitted x509 txs")
    if rep["fault_fires"] <= 0:
        raise AssertionError(f"phase 17 {tag}: no fault fired")
    if tag == "(a)":
        if set(kinds) != set(CORE_KINDS):
            raise AssertionError(f"phase 17 (a): kinds {kinds}")
        if rep["idemix_tamper_rejects"] <= 0 or not rep["idemix_txs"]:
            raise AssertionError("phase 17 (a): the idemix lane rejected "
                                 "no tampered presentation")
        if rep["peers_final"] != 3:
            raise AssertionError(f"phase 17 (a): {rep['peers_final']} "
                                 f"peers at the end")
        revoke = next(e for e in rep["events"] if e["kind"] == "acl_revoke")
        if revoke["cut_at_block"] <= 0:
            raise AssertionError("phase 17 (a): no revocation block")
    elif not rep["sharded"] or len(kinds) != SOAK_SHARDED_EVENTS:
        raise AssertionError(f"phase 17 {tag}: sharded {rep['sharded']}, "
                             f"kinds {kinds}")
    require_launched({k: counts[k] for k in CORE_KERNELS}, f"phase 17 {tag}")
    log(f"phase 17 {tag} soak: schedule "
        f"{[(e['kind'], e['gap_txs']) for e in rep['schedule']]}")
    log(f"phase 17 {tag} soak: recovery s by kind "
        f"{rep['recovery_s_by_kind']}; x509 {rep['x509_txs']} txs "
        f"({rep['x509_tx_per_sec']} tx/s, all audited once), idemix "
        f"{rep['idemix_txs']} ({rep['idemix_tx_per_sec']} /s, "
        f"{rep['idemix_tamper_rejects']} tampered rejected); fault fires "
        f"{rep['fault_fires']}, submit errors {rep['submit_errors']}; peers "
        f"at the end {rep['peers_final']}; wall {rep['wall_secs']} s; "
        f"kernel launches {counts}")
    for e in rep["events"]:
        extra = {k: v for k, v in e.items()
                 if k not in ("kind", "recovery_s", "pre_rate", "post_rate")}
        log(f"phase 17 {tag}   {e['kind']}: recovered in {e['recovery_s']} "
            f"s, tx/s {e['pre_rate']} -> {e['post_rate']} {extra}")


def soak_run(tag: str, **kw):
    """One soak through the harness a user calls, its default verifier
    (one GpuVerifier on the card shared by every peer and orderer);
    returns the kernel launches."""
    from fabric_mod_tpu_torch.soak import SoakHarness
    reset_kernel_counts()
    t0 = time.perf_counter()
    rep = SoakHarness(soak_config(**kw)).run()
    counts = kernel_counts()
    soak_report(tag, rep, counts)
    log(f"phase 17 {tag}: {time.perf_counter() - t0:.1f} s wall")
    return counts


def soak_fault_verify(dev, point: str) -> dict:
    """(b): `point` armed on its first pass under a BatchingVerifyService
    over a GpuVerifier on the card: every waiter of that batch gets the
    InjectedFault and no verdict; the next batch's verdicts equal the
    plain version's and the construction's.  Returns the launches."""
    from fabric_mod_tpu_torch import faults
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.utils import fixtures
    items, expect = fixtures.make_block(1, n_tx=40)
    n = SOAK_FAULT_ITEMS
    # the last n lanes hold seven planted false ones
    first, second = items[:n], items[-n:]
    want = [bool(x) for x in expect[-n:]]
    plain = [bool(x) for x in gpu.GpuVerifier(device="cpu", cache_size=0)
             .verify_many(second)]
    if plain != want:
        raise AssertionError(f"phase 17 (b) {point}: the plain version "
                             f"disagrees with the construction")
    reset_kernel_counts()
    svc = gpu.BatchingVerifyService(gpu.GpuVerifier(device=dev, cache_size=0),
                                    max_batch=n, deadline_s=5.0)
    plan = faults.FaultPlan().add(point, nth=1)
    try:
        with faults.active(plan):
            futs = [svc.submit(it) for it in first]
            errs = [f.exception(timeout=60) for f in futs]
            if not all(isinstance(e, faults.InjectedFault) for e in errs):
                raise AssertionError(
                    f"phase 17 (b) {point}: waiters got "
                    f"{sorted({type(e).__name__ for e in errs})}")
            futs = [svc.submit(it) for it in second]
            got = [f.result(timeout=60) for f in futs]
    finally:
        svc.close()
    counts = kernel_counts()
    if got != plain:
        raise AssertionError(f"phase 17 (b) {point}: the next batch's "
                             f"verdicts differ from the plain version's")
    if plan.fires(point) != 1:
        raise AssertionError(f"phase 17 (b) {point}: {plan.fires(point)} "
                             f"fires")
    require_launched({k: counts[k] for k in CORE_KERNELS},
                     f"phase 17 (b) {point}")
    log(f"phase 17 (b) {point}: {n} waiters of the first batch got "
        f"InjectedFault and no verdict; the next {n} verdicts equal the "
        f"plain version's ({sum(got)} true); passes "
        f"{plan.calls(point)}, fires 1; kernel launches {counts}")
    return counts


def soak_fault_commit(dev, solo_fp) -> dict:
    """(b): `commitpipe.commit` armed on its second pass while a Channel
    with a depth-2 pipe on the card commits phase 8 (a)'s ordered
    blocks: the poisoned pipe is rebuilt once, and the fingerprint
    equals phase 8 (a)'s."""
    from fabric_mod_tpu_torch import e2e, faults
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.protos import messages as m
    material, blocks, fp8 = ORDERED["a"]
    if fp8 != solo_fp:
        raise AssertionError("phase 17 (b): ORDERED is not phase 8 (a)'s")
    reset_kernel_counts()
    with tempfile.TemporaryDirectory() as root:
        net = e2e.Network(root, material=material,
                          verifier=gpu.GpuVerifier(device=dev),
                          tensor_policy=True, pipeline_depth=2)
        try:
            pipes = []
            plan = faults.FaultPlan().add("commitpipe.commit", nth=2)
            with faults.active(plan):
                for raw in blocks:
                    pipes.append(net.channel.commit_pipeline())
                    net.channel.store_block(m.Block.decode(raw))
                pipes.append(net.channel.commit_pipeline())
            rebuilt = len({id(p) for p in pipes}) - 1
            fp = net.ledger.state_fingerprint()
            height = net.ledger.height
        finally:
            net.close()
    counts = kernel_counts()
    if plan.fires("commitpipe.commit") != 1 or rebuilt != 1:
        raise AssertionError(f"phase 17 (b) commitpipe.commit: fires "
                             f"{plan.fires('commitpipe.commit')}, pipes "
                             f"rebuilt {rebuilt}")
    if fp != solo_fp or height != len(blocks) + 1:
        raise AssertionError("phase 17 (b) commitpipe.commit: the "
                             "fingerprint differs from phase 8 (a)'s")
    require_launched({k: counts[k] for k in CORE_KERNELS},
                     "phase 17 (b) commitpipe.commit")
    log(f"phase 17 (b) commitpipe.commit: fired on block 2 of "
        f"{len(blocks)}, the pipe rebuilt once, the block retried through "
        f"it; fingerprint == phase 8 (a)'s ({fp[:16]}); kernel launches "
        f"{counts}")
    return counts


def phase_soak(torch, dev, solo_fp, sharded: bool) -> dict:
    """Phase 17: (a) the default soak, (b) the fault seams, and with
    `sharded` (c) the sharded soak.  Returns the parts' launches
    summed."""
    t_phase = time.perf_counter()
    parts = {}
    parts["a"] = soak_run("(a)", n_events=SOAK_EVENTS)
    for point in ("bccsp.device.dispatch", "bccsp.device.resolve"):
        parts[point] = soak_fault_verify(dev, point)
    parts["commitpipe.commit"] = soak_fault_commit(dev, solo_fp)
    if sharded:
        parts["c"] = soak_run("(c)", n_events=SOAK_SHARDED_EVENTS,
                              sharded=True)
    launched: dict = {}
    for counts in parts.values():
        for k, v in counts.items():
            launched[k] = launched.get(k, 0) + v
    log(f"soak phase: {time.perf_counter() - t_phase:.1f} s wall; kernel "
        f"launches {launched}")
    return launched


# -- phase 18: the offline tools and the lock discipline ----------------------

TOOLS_CHANNEL = "toolchan"
TOOLS_ORGS = ("Org1", "Org2", "Org3")
# BASELINE.md #2's width: 3 peer orgs, one peer, one user and one admin
# each, and the orderer org, in the reference's crypto-config YAML
TOOLS_CRYPTO = "".join(
    ["PeerOrgs:\n"]
    + [f"  - Name: {o}\n    PeerCount: 1\n    UserCount: 1\n"
       for o in TOOLS_ORGS]
    + ["OrdererOrgs:\n  - Name: OrdererOrg\n    OrdererCount: 1\n"])
# a solo profile at 1000 txs a block (phase 8's batch cut)
TOOLS_PROFILE = (
    f"ChannelID: {TOOLS_CHANNEL}\n"
    f"PeerOrgs: [{', '.join(TOOLS_ORGS)}]\n"
    "OrdererOrgs: [OrdererOrg]\n"
    "BatchSize:\n"
    f"  MaxMessageCount: {TX_PER_BLOCK}\n"
    f"  PreferredMaxBytes: {E2E_PREFERRED_MAX_BYTES}\n"
    f"BatchTimeout: {E2E_BATCH_TIMEOUT}\n"
    "ConsensusType: solo\n")
TOOLS_NEW_BATCH = 500
TOOLS_PRESENTATIONS = 16
# verify-core launches a 1000-tx block: 2 validation calls + 1 MCS check
TOOLS_CORE_A_BLOCK = 3


def tools_cli(argv) -> str:
    """Run `python -m fabric_mod_tpu_torch.cli.main argv` in process;
    its standard output.  A nonzero exit raises."""
    import contextlib
    import io
    from fabric_mod_tpu_torch.cli.main import main as cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(list(argv))
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} exited {rc}")
    return out.getvalue()


def tools_make(root, verifier) -> dict:
    """18 (a): cryptogen, configtxgen and configtxlator on the host.  The
    genesis decodes to JSON and encodes back to the same bytes; the
    ConfigUpdate of a BatchSize 1000 -> 500 change, signed by the orderer
    org's admin, is accepted by the channel's config processing
    (verified by `verifier`).  Returns the paths."""
    import importlib.util
    from fabric_mod_tpu_torch.bccsp.sw import SwCSP
    from fabric_mod_tpu_torch.channelconfig import (Bundle, config_from_block,
                                                    signed_update_envelope)
    from fabric_mod_tpu_torch.channelconfig.configtx import (
        extract_config_update, propose_config_update)
    from fabric_mod_tpu_torch.msp.identities import (SigningIdentity,
                                                     deserialize_cert)
    from fabric_mod_tpu_torch.protos import messages as m
    log("phase 18 (a): on this machine `import yaml` "
        f"{'would succeed' if importlib.util.find_spec('yaml') else 'fails'}"
        f", `import grpc` "
        f"{'would succeed' if importlib.util.find_spec('grpc') else 'fails'}"
        "; the port imports neither")
    t0 = time.perf_counter()
    p = {k: os.path.join(root, v) for k, v in (
        ("crypto_yaml", "crypto-config.yaml"), ("profile", "configtx.yaml"),
        ("crypto", "crypto-config"), ("genesis", "genesis.block"),
        ("json", "genesis.json"), ("again", "genesis-again.block"),
        ("orig", "config.pb"), ("upd", "config-500.pb"),
        ("update", "update.pb"))}
    with open(p["crypto_yaml"], "w") as f:
        f.write(TOOLS_CRYPTO)
    with open(p["profile"], "w") as f:
        f.write(TOOLS_PROFILE)
    tools_cli(["cryptogen", "--config", p["crypto_yaml"], "--output",
               p["crypto"]])
    tools_cli(["configtxgen", "--profile", p["profile"], "--crypto",
               p["crypto"], "--output", p["genesis"]])
    with open(p["json"], "w") as f:
        f.write(tools_cli(["configtxlator", "proto_decode", "--type",
                           "Block", "--input", p["genesis"]]))
    tools_cli(["configtxlator", "proto_encode", "--type", "Block",
               "--input", p["json"], "--output", p["again"]])
    with open(p["genesis"], "rb") as a, open(p["again"], "rb") as b:
        raw = a.read()
        if b.read() != raw:
            raise AssertionError("phase 18 (a): proto_decode -> proto_encode "
                                 "changed the genesis block's bytes")
    cid, config = config_from_block(m.Block.decode(raw))
    new = m.Config.decode(config.encode())
    for g in new.channel_group.groups:
        if g.key == "Orderer":
            for v in g.value.values:
                if v.key == "BatchSize":
                    bs = m.BatchSize.decode(v.value.value)
                    bs.max_message_count = TOOLS_NEW_BATCH
                    v.value.value = bs.encode()
    with open(p["orig"], "wb") as f:
        f.write(config.encode())
    with open(p["upd"], "wb") as f:
        f.write(new.encode())
    tools_cli(["configtxlator", "compute_update", "--channel_id", cid,
               "--original", p["orig"], "--updated", p["upd"], "--output",
               p["update"]])
    csp = SwCSP()
    admin_dir = os.path.join(p["crypto"], "OrdererOrg", "admin")
    with open(os.path.join(admin_dir, "admin.pem"), "rb") as f:
        cert = deserialize_cert(f.read())
    with open(os.path.join(admin_dir, "admin.key"), "rb") as f:
        admin = SigningIdentity("OrdererOrg", cert, f.read(), csp)
    with open(p["update"], "rb") as f:
        update = m.ConfigUpdate.decode(f.read())
    bundle = Bundle(cid, config, csp)
    if bundle.batch_config().max_message_count != TX_PER_BLOCK \
            or bundle.application.org_mspids != TOOLS_ORGS:
        raise AssertionError("phase 18 (a): the genesis is not the profile's")
    nxt = propose_config_update(
        bundle, extract_config_update(signed_update_envelope(
            cid, update, [admin])), verifier.verify_many)
    got = Bundle(cid, nxt, csp).batch_config().max_message_count
    if (nxt.sequence, got) != (1, TOOLS_NEW_BATCH):
        raise AssertionError(f"phase 18 (a): the update gave sequence "
                             f"{nxt.sequence}, {got} txs a block")
    log(f"phase 18 (a) tools: cryptogen {list(TOOLS_ORGS)} + OrdererOrg, a "
        f"solo genesis at {TX_PER_BLOCK} txs a block ({len(raw)} bytes), "
        f"its JSON round trip byte-equal, the BatchSize -> "
        f"{TOOLS_NEW_BATCH} update ({len(update.encode())} bytes) accepted "
        f"at sequence 1; {time.perf_counter() - t0:.1f} s on the host")
    return p


def tools_stream(net, material) -> tuple:
    """18 (b)'s E2E_BLOCKS x TX_PER_BLOCK txs: one group of PLANT_EVERY
    through the network's endorsers (phase 8's planted kinds, a tampered
    creator among them), then blind puts signed by the tree's peers,
    Org1 and Org2 (2 of 3), every LC_UNDER_EVERY-th by Org1 alone.  A
    hand-signed put costs the host about a fifth of an endorsed one (no
    proposal check or simulation).  Returns (submits, expected flags)."""
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.utils import fixtures
    V = m.TxValidationCode
    submits, expected = fixtures.make_e2e_stream(net, PLANT_EVERY,
                                                 PLANT_EVERY)
    n_puts = E2E_BLOCKS * TX_PER_BLOCK - len(expected)
    under = [i % LC_UNDER_EVERY == LC_UNDER_EVERY - 1 for i in range(n_puts)]
    envs = fixtures.make_put_txs(
        fixtures.network_world(material),
        [(fixtures.NAMESPACE, f"t{i}", b"v%d" % i,
          ("Org1",) if u else ("Org1", "Org2"))
         for i, u in enumerate(under)], b"phase18")
    return (list(submits) + [(env, True) for env in envs],
            list(expected) + [V.ENDORSEMENT_POLICY_FAILURE if u else V.VALID
                              for u in under])


def tools_network(torch, p, verifier, root) -> tuple:
    """18 (b): a solo Network from (a)'s tree and genesis on the card's
    GpuVerifier, every guard armed: E2E_BLOCKS blocks of TX_PER_BLOCK
    txs endorsed by 2 of 3 orgs (tools_stream), ordered and committed.
    Returns (the peer's ledger dir, its height, its fingerprint, the
    launches)."""
    from fabric_mod_tpu_torch import concurrency, e2e
    from fabric_mod_tpu_torch.cli.cryptogen import network_material
    from fabric_mod_tpu_torch.protos import protoutil
    with open(p["genesis"], "rb") as f:
        material = network_material(p["crypto"], f.read())
    n_tx = E2E_BLOCKS * TX_PER_BLOCK
    before = set(concurrency.live_registered())
    concurrency.lock_registry().clear()
    with concurrency.armed():
        net = e2e.Network(os.path.join(root, "net"), material,
                          verifier=verifier)
        try:
            t0 = time.perf_counter()
            submits, expected = tools_stream(net, material)
            t_endorse = time.perf_counter() - t0
            reset_kernel_counts()
            _client, committed, span_s = e2e.commit_until(
                net, n_tx, E2E_TIMEOUT_S, feed=lambda: svc_feed(net, submits),
                idle_timeout_s=E2E_TIMEOUT_S)
            launched = kernel_counts()
            height = net.ledger.height
            if committed != n_tx or height != 1 + E2E_BLOCKS:
                raise AssertionError(f"phase 18 (b): {committed} txs "
                                     f"committed, height {height}")
            flags = [f for n in range(1, height)
                     for f in protoutil.block_txflags(
                         net.ledger.get_block_by_number(n))]
            if flags != list(expected):
                raise AssertionError("phase 18 (b): txflags differ from the "
                                     "construction")
            fp = net.ledger.state_fingerprint()
            ledger_dir = net.ledger.dir
        finally:
            net.close()
        leaked = [t.name for t in concurrency.live_registered()
                  if t not in before]
    edges = concurrency.lock_registry().edge_count()
    if leaked:
        raise AssertionError(f"phase 18 (b): registered workers left after "
                             f"close: {leaked}")
    if edges <= 0:
        raise AssertionError("phase 18 (b): the lock-order registry observed "
                             "no ordering: the guards did not run")
    # a 1000-tx block is 2,900-3,000 signature lanes: two 2048-lane
    # validation calls, and one MCS check of the orderer's signature
    for k in CORE_KERNELS:
        if launched[k] < TOOLS_CORE_A_BLOCK * E2E_BLOCKS:
            raise AssertionError(
                f"phase 18 (b): {k} launched {launched[k]} times for "
                f"{E2E_BLOCKS} blocks, under {TOOLS_CORE_A_BLOCK} a block")
    valid = sum(1 for f in expected if f == 0)
    log(f"phase 18 (b) tool-built network, guards armed: {n_tx} txs "
        f"endorsed by 2 of 3 orgs in {t_endorse:.1f} s ({PLANT_EVERY} through "
        f"the endorsers, the rest hand-signed puts), {E2E_BLOCKS} blocks "
        f"ordered and committed in {span_s:.1f} s ({n_tx / span_s:.1f} "
        f"committed tx/s; {valid} VALID, every flag the construction's); "
        f"no RaceError; {edges} lock-order edges observed; no registered "
        f"worker left (live now: {len(concurrency.live_registered())}); "
        f"kernel launches {launched}")
    return ledger_dir, height, fp, launched


def tools_snapshot(root, ledger_dir, height, fp) -> None:
    """18 (c): `ledger snapshot` of (b)'s peer, `join-from-snapshot` into
    a new ledger: equal height and fingerprint."""
    from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
    t0 = time.perf_counter()
    snap, joined = os.path.join(root, "snap"), os.path.join(root, "joined")
    tools_cli(["ledger", "snapshot", "--ledger", ledger_dir, "--channel",
               TOOLS_CHANNEL, "--output", snap])
    tools_cli(["ledger", "join-from-snapshot", "--snapshot", snap,
               "--ledger", joined])
    led = KvLedger(TOOLS_CHANNEL, joined)
    try:
        got = (led.height, led.state_fingerprint())
    finally:
        led.close()
    if got != (height, fp):
        raise AssertionError(f"phase 18 (c): the joined peer is at "
                             f"{got[0]}, fingerprint "
                             f"{'equal' if got[1] == fp else 'different'}")
    log(f"phase 18 (c) ledger snapshot + join-from-snapshot: height "
        f"{height}, fingerprint equal ({fp[:16]}); "
        f"{time.perf_counter() - t0:.1f} s")


def tools_discover(p) -> None:
    """18 (d): `discover endorsers` over (a)'s genesis (the offline tool
    checks no signature, so the card has no part in it): the three
    2-of-3 layouts."""
    from fabric_mod_tpu_torch.cli import discover
    got = discover.query("endorsers", p["genesis"], chaincode="mycc")
    layouts = sorted(tuple(sorted(lo)) for lo in got["layouts"])
    want = [("Org1", "Org2"), ("Org1", "Org3"), ("Org2", "Org3")]
    if layouts != want or any(set(lo.values()) != {1}
                              for lo in got["layouts"]):
        raise AssertionError(f"phase 18 (d): layouts {got['layouts']}")
    log(f"phase 18 (d) discover endorsers: layouts {got['layouts']}")


def tools_idemix(root) -> dict:
    """18 (e): `idemixgen ca-keygen` and `signerconfig`, then
    TOOLS_PRESENTATIONS presentations under that key and one with Abar
    tampered, verified in one batch on the card: 1 + 1 pairing launches,
    the valid ones true, the tampered one false.  Returns the launches."""
    import json as _json
    from fabric_mod_tpu_torch.idemix import credential as cred
    from fabric_mod_tpu_torch.idemix.fp256bn import G1, g1_add
    t0 = time.perf_counter()
    d = os.path.join(root, "idemix")
    tools_cli(["idemixgen", "ca-keygen", "--output", d])
    tools_cli(["idemixgen", "signerconfig", "--ca-input", d, "--output", d,
               "--org-unit", "Org1", "--enrollment-id", "user0", "--role",
               "1"])
    with open(os.path.join(d, "IssuerPublicKey.json")) as f:
        ik = cred.IssuerKey.from_dict(_json.load(f))
    with open(os.path.join(d, "user", "SignerConfig.json")) as f:
        signer = _json.load(f)
    c = cred.Credential.from_dict(signer["credential"])
    sk = int(signer["sk"], 16)
    disclosed = {0: c.attrs[0], 1: c.attrs[1]}
    items = []
    for i in range(TOOLS_PRESENTATIONS + 1):
        msg = b"phase18|%d" % i
        sig = cred.sign(ik, c, sk, msg, disclosed)
        if i == TOOLS_PRESENTATIONS:
            sig.A_bar = g1_add(sig.A_bar, G1.generator())
        items.append((sig, msg, disclosed))
    t_sign = time.perf_counter() - t0
    before = kernel_counts()
    t1 = time.perf_counter()
    got = cred.batch_verify(ik, items)
    t_verify = time.perf_counter() - t1
    launched = pairing_launched(before, "phase 18 (e)")
    if got != [True] * TOOLS_PRESENTATIONS + [False]:
        raise AssertionError(f"phase 18 (e): verdicts {got}")
    log(f"phase 18 (e) idemixgen: issuer key and signer config, "
        f"{TOOLS_PRESENTATIONS} presentations true and one tampered false in "
        f"one batch on the card ({t_verify * 1e3:.1f} ms; keys and signing "
        f"{t_sign:.1f} s on the host); launches {launched}")
    return launched


def phase_tools(torch, dev) -> dict:
    """Phase 18: (a) the tools on the host, (b) a tool-built solo network
    committing on the card under armed guards, (c) a snapshot and a join
    of its peer, (d) discover endorsers, (e) idemixgen's key and 16
    presentations on the card.  Returns the launches of (b) and (e)."""
    from fabric_mod_tpu_torch.bccsp import gpu
    t_phase = time.perf_counter()
    verifier = gpu.GpuVerifier(device=dev)
    with tempfile.TemporaryDirectory() as root:
        p = tools_make(root, verifier)
        ledger_dir, height, fp, net_counts = tools_network(torch, p,
                                                           verifier, root)
        tools_snapshot(root, ledger_dir, height, fp)
        tools_discover(p)
        idemix_counts = tools_idemix(root)
    launched = {k: net_counts.get(k, 0) + idemix_counts.get(k, 0)
                for k in set(net_counts) | set(idemix_counts)}
    log(f"tools phase: {time.perf_counter() - t_phase:.1f} s wall; kernel "
        f"launches {launched}")
    return launched


# -- 19. the transport: comm/ over mutual TLS, the servers, Raft and gossip
# -- over the wire, deliver failover, node/chaincode as processes -----------

WIRE_CHANNEL = "wirechan"
WIRE_PEERS = ("Org1", "Org2")
# 19 (a): txs of block 1 endorsed over the wire (RemoteEndorser); the rest
# are hand-signed puts, as 18 (b)'s
WIRE_REMOTE = 50
WIRE_SUBMITTERS = 8
WIRE_ELECTION_TIMEOUT = (1.0, 2.0)
WIRE_HEARTBEAT_S = 0.1
WIRE_TIMEOUT_S = 300.0
# 19 (b): txs before and after the leader's SIGKILL, and the invokes of
# each that go through `chaincode invoke`
PROCS_PUTS = 24
PROCS_INVOKES = 3
PROCS_BATCH_TIMEOUT = "500ms"
PROCS_START_S = 420.0
# a GPU peer warms its four buckets with BUCKETS[-1] distinct items: the
# verdict cache's misses before any block
PROCS_WARM_MISSES = 2048


def wire_orderers(root, material, tca, csp, genesis_block) -> dict:
    """Three Raft orderers, each a Registrar whose RaftChain speaks
    Cluster/Step through a GRPCRaftTransport, and an OrdererServer, all
    over mutual TLS from `tca`."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.orderer.cluster import GRPCRaftTransport
    from fabric_mod_tpu_torch.orderer.raftchain import RaftChain
    from fabric_mod_tpu_torch.orderer.registrar import Registrar
    from fabric_mod_tpu_torch.orderer.server import OrdererServer
    ids = list(material.consenters)
    nodes = {}
    for oid in ids:
        sc, sk = tca.issue(f"{oid}.example.com", sans=("127.0.0.1",))
        cc, ck = tca.issue(f"{oid}.client", server=False)
        nodes[oid] = {"pems": (sc, sk), "tr": GRPCRaftTransport(
            oid, {j: "127.0.0.1:0" for j in ids},
            listen_address="127.0.0.1:0", server_cert=sc, server_key=sk,
            client_ca=tca.cert_pem, client_cert=cc, client_key=ck)}
    for n in nodes.values():
        for j, o in nodes.items():
            n["tr"].set_peer_address(j, f"127.0.0.1:{o['tr'].listen_port}")
        n["tr"].start()
    for oid, n in nodes.items():
        def factory(support, oid=oid, tr=n["tr"]):
            return RaftChain(
                oid, ids, tr, os.path.join(root, oid,
                                           f"{support.channel_id}.wal"),
                support, election_timeout=WIRE_ELECTION_TIMEOUT,
                heartbeat_s=WIRE_HEARTBEAT_S)
        n["reg"] = Registrar(os.path.join(root, oid),
                             e2e._signer(csp, material.consenters[oid]), csp,
                             consenters={"etcdraft": factory})
        n["sup"] = n["reg"].create_channel(genesis_block)
        sc, sk = n["pems"]
        n["srv"] = OrdererServer(n["reg"], "127.0.0.1:0", server_cert_pem=sc,
                                 server_key_pem=sk,
                                 client_root_pem=tca.cert_pem)
        n["srv"].start()
        n["addr"] = f"127.0.0.1:{n['srv'].port}"
    return nodes


def wire_peer(root, org, material, verifier, tca, csp, genesis_block,
              orderer_addrs) -> dict:
    """One committing peer over the wire: a FailoverDeliverSource over every
    orderer, an EndorserServer and an EventDeliverServer on one mTLS
    GRPCServer, and a GossipNode on a GRPCGossipNetwork with GossipAuth,
    its identity mapper and every verify on `verifier`."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
    from fabric_mod_tpu_torch.comm.grpc_comm import GRPCServer
    from fabric_mod_tpu_torch.gossip.comm import GossipAuth, GRPCGossipNetwork
    from fabric_mod_tpu_torch.gossip.identity import IdentityMapper
    from fabric_mod_tpu_torch.gossip.node import GossipNode
    from fabric_mod_tpu_torch.ledger.kvledger import LedgerManager
    from fabric_mod_tpu_torch.peer.aclmgmt import ACLProvider
    from fabric_mod_tpu_torch.peer.blocksprovider import (
        Endpoint, FailoverDeliverSource)
    from fabric_mod_tpu_torch.peer.channel import Channel
    from fabric_mod_tpu_torch.peer.deliverclient import DeliverClient
    from fabric_mod_tpu_torch.peer.deliverevents import EventDeliverServer
    from fabric_mod_tpu_torch.peer.endorser import Endorser
    from fabric_mod_tpu_torch.peer.endorserserver import EndorserServer
    from fabric_mod_tpu_torch.peer.scc import build_default_registry
    cid, config = config_from_block(genesis_block)
    p = {"org": org}
    p["mgr"] = LedgerManager(os.path.join(root, org))
    p["ledger"] = p["mgr"].create_or_open(cid)
    p["channel"] = Channel(cid, p["ledger"], verifier,
                           Bundle(cid, config, csp), csp)
    p["channel"].init_from_genesis(genesis_block)
    pc, pk = tca.issue(f"peer0.{org.lower()}.example.com",
                       sans=("127.0.0.1",))
    p["pems"] = (pc, pk)
    p["source"] = FailoverDeliverSource(
        [Endpoint(a, tca.cert_pem, pc, pk) for a in orderer_addrs], cid,
        base_backoff_s=0.05)
    p["dc"] = DeliverClient(p["channel"], p["source"])
    p["runner"] = threading.Thread(
        target=p["dc"].run, kwargs={"idle_timeout_s": WIRE_TIMEOUT_S},
        name=f"wire-deliver[{org}]", daemon=True)
    signer = e2e._signer(csp, material.peers[org])
    endorser = Endorser(p["channel"],
                        build_default_registry(p["channel"], p["ledger"]),
                        signer)
    p["server"] = GRPCServer("127.0.0.1:0", pc, pk, tca.cert_pem,
                             max_workers=64)
    EndorserServer(endorser, grpc=p["server"])
    p["events"] = EventDeliverServer(
        cid, p["ledger"], ACLProvider(p["channel"].bundle,
                                      verify_many=verifier.verify_many),
        grpc=p["server"])
    p["server"].start()
    p["addr"] = f"127.0.0.1:{p['server'].port}"
    mapper = IdentityMapper(p["channel"].bundle().msp_manager, verifier)
    p["gnet"] = GRPCGossipNetwork(
        "127.0.0.1:0", server_cert=pc, server_key=pk, client_ca=tca.cert_pem,
        client_cert=pc, client_key=pk,
        auth=GossipAuth(signer.serialize(), signer.sign_message, mapper.put,
                        mapper.verify))
    p["gnet"].start()
    p["node"] = GossipNode(p["gnet"].listen_endpoint, signer, p["channel"],
                           p["gnet"])
    p["runner"].start()
    return p


def wire_close(orderers, peers) -> None:
    for p in peers:
        p["dc"].stop()
    for p in peers:
        p["runner"].join(60)
        p["source"].close()
        p["node"].stop()
        p["gnet"].stop()
        p["events"].stop()
        p["server"].stop(1.0)
        p["channel"].close()
        p["mgr"].close()
    for n in orderers.values():
        n["srv"].stop(0)
        n["reg"].close()
        n["tr"].stop()


def wire_stream(material, n_blocks, block_txs) -> tuple:
    """19 (a)'s hand-signed envelopes: block 1 less WIRE_REMOTE (those are
    endorsed over the wire) and every later block, each with a tx whose
    Org2 endorsement signature is flipped (ENDORSEMENT_POLICY_FAILURE),
    and from block 2 on one that read key w0 absent (MVCC_READ_CONFLICT:
    block 1 wrote it).  Returns ([envelopes of each block], {txid: flag})."""
    import hashlib
    from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.utils import fixtures
    V = m.TxValidationCode
    world = fixtures.network_world(material)
    blocks, flags = [], {}
    for b in range(n_blocks):
        n_puts = block_txs - (WIRE_REMOTE if b == 0 else 0) - (
            1 if b == 0 else 2)
        envs = fixtures.make_put_txs(
            world, [(fixtures.NAMESPACE, f"w{i}" if b == 0 else f"x{b}.{i}",
                     b"v%d" % i, WIRE_PEERS) for i in range(n_puts)],
            b"phase19|%d" % b)
        flags.update({_txid(e): V.VALID for e in envs})
        planted = []
        rw = RWSetBuilder()
        rw.add_write(fixtures.NAMESPACE, f"bad{b}", b"v")
        planted.append((rw, V.ENDORSEMENT_POLICY_FAILURE, 1))
        if b > 0:
            rw = RWSetBuilder()
            rw.add_read(fixtures.NAMESPACE, "w0", None)
            rw.add_write(fixtures.NAMESPACE, f"mvcc{b}", b"v")
            planted.append((rw, V.MVCC_READ_CONFLICT, None))
        for k, (rw, flag, bad) in enumerate(planted):
            env = fixtures._signed_tx(
                world, rw.build().encode(), WIRE_PEERS,
                hashlib.sha256(b"phase19|planted|%d|%d" % (b, k)).digest()[:24],
                1_735_689_600_000_000_000 + b * 10_000 + k,
                bad_endorser=bad)
            flags[_txid(env)] = flag
            envs.insert(len(envs) // 2 + k, env)
        blocks.append(envs)
    return blocks, flags


def wire_submit(addr, tca, pems, envs, remote=None) -> list:
    """Broadcast `envs` to the orderer at `addr` from WIRE_SUBMITTERS
    GrpcBroadcaster streams (mTLS as `pems`); with `remote` (a callable
    taking a broadcaster, returning txids) one more stream runs it.
    Returns remote's txids; any error raises."""
    from fabric_mod_tpu_torch.comm.grpc_comm import GRPCClient
    from fabric_mod_tpu_torch.peer.grpcdeliver import GrpcBroadcaster
    errors, txids = [], []

    def run(part=None, fn=None):
        client = GRPCClient(addr, tca.cert_pem, *pems)
        bcast = GrpcBroadcaster(client)
        try:
            if fn is not None:
                txids.extend(fn(bcast))
            for env in part or ():
                bcast.submit(env)
        except Exception as e:
            errors.append(e)
        finally:
            bcast.close()
            client.close()
    threads = [threading.Thread(target=run, args=(envs[i::WIRE_SUBMITTERS],))
               for i in range(WIRE_SUBMITTERS)]
    if remote is not None:
        threads.append(threading.Thread(target=run, kwargs={"fn": remote}))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise AssertionError(f"phase 19: a broadcast failed: {errors[0]!r}")
    return txids


def wait_for(pred, timeout_s: float, what: str) -> float:
    """Poll `pred` every 10 ms; the seconds it took.  Raises on timeout."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"phase 19: timed out waiting for {what}")
        time.sleep(0.01)
    return time.perf_counter() - t0


def wire_leader(orderers, live) -> str:
    chains = {o: orderers[o]["sup"].chain for o in live}
    leaders = [o for o, c in chains.items() if c.is_leader]
    if len(leaders) == 1 and all(c.leader_id == leaders[0]
                                 for c in chains.values()):
        return leaders[0]
    return None


def transport_inprocess(torch, dev, verifier, n_blocks=E2E_BLOCKS,
                        block_txs=TX_PER_BLOCK) -> dict:
    """19 (a): three Raft orderers and two peers in this process over
    mutual-TLS sockets on loopback, BASELINE.md #2's width (3 orgs,
    1000-tx blocks, 2-of-3 endorsement).  Block 1: WIRE_REMOTE txs
    endorsed through RemoteEndorser, the rest hand-signed, with a flipped
    endorsement; block 2 after the Raft leader's server and transport
    stop, with a flipped endorsement and an MVCC conflict; everything
    through GrpcBroadcaster streams.  An EventDeliverClient over the wire
    waits for a block-2 txid.  Returns the launches."""
    from fabric_mod_tpu_torch import concurrency, e2e
    from fabric_mod_tpu_torch.bccsp.sw import SwCSP
    from fabric_mod_tpu_torch.comm.grpc_comm import GRPCClient
    from fabric_mod_tpu_torch.comm.tls import TlsCA
    from fabric_mod_tpu_torch.peer.deliverevents import EventDeliverClient
    from fabric_mod_tpu_torch.peer.endorserserver import (RemoteEndorser,
                                                          invoke_remote)
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    from fabric_mod_tpu_torch.utils import fixtures
    V = m.TxValidationCode
    t_phase = time.perf_counter()
    material = fixtures.make_network_material(
        SEED + 19, channel_id=WIRE_CHANNEL, consensus_type="etcdraft",
        orderers=3, max_message_count=block_txs,
        batch_timeout=E2E_BATCH_TIMEOUT,
        preferred_max_bytes=E2E_PREFERRED_MAX_BYTES)
    blocks, expected = wire_stream(material, n_blocks, block_txs)
    t_sign = time.perf_counter() - t_phase
    csp = SwCSP()
    tca = TlsCA(seed=b"phase19")
    client_pems = tca.issue("client.example.com", server=False)
    client_signer = e2e._signer(csp, material.client)
    genesis_block = m.Block.decode(material.genesis)
    before = set(concurrency.live_registered())
    orderers, peers = {}, []
    with tempfile.TemporaryDirectory() as root:
        try:
            orderers = wire_orderers(root, material, tca, csp, genesis_block)
            live = list(orderers)
            t_elect = wait_for(lambda: wire_leader(orderers, live),
                               WIRE_TIMEOUT_S, "a Raft leader")
            # the leader first: the peers stream from the orderer that
            # will fail, so their sources must rotate
            first = wire_leader(orderers, live)
            addrs = [orderers[o]["addr"] for o in
                     sorted(orderers, key=lambda o: o != first)]
            for org in WIRE_PEERS:
                peers.append(wire_peer(root, org, material, verifier, tca,
                                       csp, genesis_block, addrs))
            a, b = (p["node"] for p in peers)
            a.join([b.endpoint])
            b.join([a.endpoint])
            wait_for(lambda: b.endpoint in a.discovery.alive_endpoints()
                     and a.endpoint in b.discovery.alive_endpoints(),
                     60, "the gossip peers' signed alive messages")
            endorsers = [RemoteEndorser(GRPCClient(p["addr"], tca.cert_pem,
                                                   *client_pems))
                         for p in peers]

            def remote(bcast):
                return [invoke_remote(
                    WIRE_CHANNEL, fixtures.NAMESPACE,
                    [b"put", b"r%d" % i, b"v%d" % i], client_signer,
                    endorsers, bcast) for i in range(WIRE_REMOTE)]
            reset_kernel_counts()
            t0 = time.perf_counter()
            leader = wire_leader(orderers, live)
            txids = wire_submit(orderers[leader]["addr"], tca, client_pems,
                                blocks[0], remote=remote)
            expected.update({t: V.VALID for t in txids})
            wait_for(lambda: all(p["ledger"].height >= 2 for p in peers),
                     WIRE_TIMEOUT_S, "block 1 at both peers")
            t_block1 = time.perf_counter() - t0
            for e in endorsers:
                e._client.close()
            # the leader fails: its server and transport stop, its chain
            # halts; the survivors elect, the peers rotate away from it
            wait_for(lambda: wire_leader(orderers, live), WIRE_TIMEOUT_S,
                     "a Raft leader before the stop")
            leader = wire_leader(orderers, live)
            t_kill = time.perf_counter()
            dead = orderers[leader]
            dead["srv"].stop(0)
            dead["tr"].stop()
            dead["reg"].close()
            live = [o for o in orderers if o != leader]
            t_reelect = wait_for(lambda: wire_leader(orderers, live),
                                 WIRE_TIMEOUT_S, "a new Raft leader")
            new_leader = wire_leader(orderers, live)
            target = _txid(blocks[1][0])
            got_event = {}
            evc_client = GRPCClient(peers[0]["addr"], tca.cert_pem,
                                    *client_pems)
            evc = EventDeliverClient(evc_client, WIRE_CHANNEL, client_signer)

            def wait_event():
                try:
                    got_event["code"] = evc.wait_for_tx(
                        target, start=2, timeout_s=WIRE_TIMEOUT_S)
                except Exception as e:
                    got_event["error"] = e
            waiter = threading.Thread(target=wait_event, daemon=True)
            waiter.start()
            t1 = time.perf_counter()
            for envs in blocks[1:]:
                wire_submit(orderers[new_leader]["addr"], tca, client_pems,
                            envs)
            wait_for(lambda: all(p["ledger"].height >= 1 + n_blocks
                                 for p in peers), WIRE_TIMEOUT_S,
                     f"block {n_blocks} at both peers")
            t_rest = time.perf_counter() - t1
            t_kill_commit = time.perf_counter() - t_kill
            waiter.join(WIRE_TIMEOUT_S)
            evc_client.close()
            launched = kernel_counts()
            if got_event.get("code") != V.VALID:
                raise AssertionError(f"phase 19 (a): the event stream gave "
                                     f"{got_event}")
            # the gates
            flags_at = []
            for p in peers:
                led = p["ledger"]
                if led.height != 1 + n_blocks:
                    raise AssertionError(f"phase 19 (a): {p['org']} at "
                                         f"height {led.height}")
                by_tx = {}
                for n in range(1, led.height):
                    blk = led.get_block_by_number(n)
                    if len(blk.data.data) != block_txs:
                        raise AssertionError(f"phase 19 (a): block {n} holds "
                                             f"{len(blk.data.data)} txs")
                    for raw, f in zip(blk.data.data,
                                      protoutil.block_txflags(blk)):
                        by_tx[_txid(m.Envelope.decode(raw))] = f
                if by_tx != expected:
                    bad = sorted(t for t in expected
                                 if by_tx.get(t) != expected[t])[:3]
                    raise AssertionError(f"phase 19 (a): {p['org']}'s flags "
                                         f"differ from the construction at "
                                         f"{bad}")
                flags_at.append([protoutil.block_txflags(
                    led.get_block_by_number(n)) for n in range(led.height)])
            if flags_at[0] != flags_at[1]:
                raise AssertionError("phase 19 (a): the peers' txflags "
                                     "differ")
            fps = {p["ledger"].state_fingerprint() for p in peers}
            if len(fps) != 1:
                raise AssertionError("phase 19 (a): the peers' state "
                                     "fingerprints differ")
            heights = {o: orderers[o]["sup"].store.height for o in live}
            if len(set(heights.values())) != 1 or \
                    set(heights.values()) != {1 + n_blocks}:
                raise AssertionError(f"phase 19 (a): surviving orderers at "
                                     f"{heights}")
            rotations = [p["source"].rotations for p in peers]
            if leader == first and min(rotations) < 1:
                raise AssertionError(f"phase 19 (a): the peers' sources "
                                     f"did not rotate ({rotations})")
            sessions = [len(p["gnet"]._sessions) for p in peers]
        finally:
            wire_close(orderers, peers)
    leaked = []
    deadline = time.monotonic() + 30
    while True:
        leaked = [t.name for t in concurrency.live_registered()
                  if t not in before]
        if not leaked or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    if leaked:
        raise AssertionError(f"phase 19 (a): workers left after close: "
                             f"{leaked}")
    for k in CORE_KERNELS:
        if launched[k] < TOOLS_CORE_A_BLOCK * n_blocks:
            raise AssertionError(
                f"phase 19 (a): {k} launched {launched[k]} times for "
                f"{n_blocks} blocks, under {TOOLS_CORE_A_BLOCK} a block")
    n_tx = n_blocks * block_txs
    valid = sum(1 for f in expected.values() if f == V.VALID)
    log(f"phase 19 (a) in process over mutual TLS on loopback: 3 Raft "
        f"orderers (GRPCRaftTransport, first leader in {t_elect:.2f} s), 2 "
        f"peers on one verifier, each pulling through a FailoverDeliverSource "
        f"over the 3 orderers; {n_tx} txs ({WIRE_REMOTE} endorsed through "
        f"RemoteEndorser, the rest hand-signed in {t_sign:.1f} s; {valid} "
        f"VALID, the flipped endorsements and the MVCC conflict flagged) "
        f"through {WIRE_SUBMITTERS} GrpcBroadcaster streams; block 1 "
        f"submitted and committed at both peers in {t_block1:.2f} s "
        f"({block_txs / t_block1:.1f} committed tx/s); leader {leader} "
        f"stopped: new leader {new_leader} in {t_reelect:.2f} s, the rest "
        f"({n_tx - block_txs} txs) submitted and committed in {t_rest:.2f} s "
        f"({(n_tx - block_txs) / t_rest:.1f} committed tx/s), kill to the "
        f"last commit {t_kill_commit:.2f} s (the failover gap); deliver "
        f"rotations {rotations}; gossip sessions {sessions}; the event "
        f"stream saw {target[:12]} VALID; flags and fingerprints equal at "
        f"both peers, surviving orderers at height {1 + n_blocks}; "
        f"launches {launched}; {time.perf_counter() - t_phase:.1f} s")
    return launched


def _cc_out(argv) -> tuple:
    """`python -m fabric_mod_tpu_torch.cli.main argv` in process:
    (exit code, standard output with the binary part first)."""
    import contextlib
    import io
    from fabric_mod_tpu_torch.cli.main import main as cli
    out = io.StringIO()
    out.buffer = io.BytesIO()
    with contextlib.redirect_stdout(out):
        rc = cli(list(argv))
    return rc, out.buffer.getvalue().decode() + out.getvalue()


def procs_submit(net, oid, start, count) -> None:
    """`count` puts signed by Org1's user0 and endorsed by both peer orgs'
    peer0, through a GrpcBroadcaster to orderer `oid`."""
    from fabric_mod_tpu_torch.cli.chaincode import _load_identity
    from fabric_mod_tpu_torch.comm.grpc_comm import GRPCClient
    from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder
    from fabric_mod_tpu_torch.peer.grpcdeliver import GrpcBroadcaster
    from fabric_mod_tpu_torch.protos import protoutil
    client_id = _load_identity(net.crypto_dir, "Org1", "users", "user0")
    endorsers = [_load_identity(net.crypto_dir, org, "peers", "peer0")
                 for _, org in net.peers]
    conn = GRPCClient(f"127.0.0.1:{net.bports[oid]}",
                      server_root_pem=net.tls.cert_pem)
    bcast = GrpcBroadcaster(conn)
    try:
        for i in range(start, start + count):
            b = RWSetBuilder()
            b.add_write("mycc", f"pk{i}", b"pv%d" % i)
            bcast.submit(protoutil.create_signed_tx(
                net.channel, "mycc", b.build().encode(), client_id,
                endorsers))
    finally:
        bcast.close()
        conn.close()


def transport_processes(torch, dev) -> None:
    """19 (b): three `cli.main node --role orderer` processes and two
    `--role peer` processes (core.yaml: peer.BCCSP.Default GPU) from the
    tools' material (cryptogen, configtxgen) and TLS directories; txs
    through GrpcBroadcaster and `chaincode invoke`, the Raft leader
    SIGKILLed, more txs, `chaincode query` of the last value.  Every child
    is stopped in a `finally`; the logs print when a gate fails."""
    from fabric_mod_tpu_torch.utils.procnet import ProcNet
    t_phase = time.perf_counter()
    peers = ("p0", "p1")
    with tempfile.TemporaryDirectory() as root:
        net = ProcNet(root, channel="wireprocs", peer_orgs=TOOLS_ORGS,
                      orderers=3, batch_txs=TX_PER_BLOCK,
                      batch_timeout=PROCS_BATCH_TIMEOUT)
        t0 = time.perf_counter()
        net.start_all()
        try:
            wait_for(lambda: _quiet(lambda: all(
                net.channel_info(o)["height"] >= 1 for o in net.o_ids)
                and net.leader_known_by_all()), PROCS_START_S,
                "the orderer processes and their leader")
            t_up = wait_for(lambda: _quiet(lambda: all(
                net.peer_height(p) >= 1 for p in peers)), PROCS_START_S,
                "the peer processes")
            t_start = time.perf_counter() - t0
            startup = {p: re.search(r"start-up: (.*?);", net.log_text(p))
                       for p in peers}
            leader = net.leader()
            procs_submit(net, leader, 0, PROCS_PUTS)
            for i in range(PROCS_INVOKES):
                # the last waits for its commit on p0's event stream
                last = (["--wait-event", "--wait-timeout", "120"]
                        if i == PROCS_INVOKES - 1 else [])
                rc, out = _cc_out(net.cc_args("invoke", f"put,ck{i},cv{i}",
                                              orderer=leader, extra=last))
                if rc != 0:
                    raise AssertionError(f"phase 19 (b): chaincode invoke "
                                         f"exited {rc}: {out}")
            wait_for(lambda: _quiet(lambda: len({
                net.peer_height(p) for p in peers} | {
                net.channel_info(leader)["height"]}) == 1),
                WIRE_TIMEOUT_S, "the first txs at both peers")
            h_kill = net.peer_height(peers[0])
            t_kill = time.perf_counter()
            net.kill(leader)
            survivors = [o for o in net.o_ids if o != leader]
            t_elect = wait_for(lambda: _quiet(
                lambda: net.leader() in survivors
                and net.leader_known_by_all()), WIRE_TIMEOUT_S,
                "a new leader among the surviving processes")
            new_leader = net.leader()
            procs_submit(net, new_leader, PROCS_PUTS, PROCS_PUTS)
            rc, out = _cc_out(net.cc_args("invoke", "put,lastkey,lastvalue",
                                          orderer=new_leader,
                                          extra=["--wait-event",
                                                 "--wait-timeout", "120"]))
            if rc != 0:
                raise AssertionError(f"phase 19 (b): invoke --wait-event "
                                     f"exited {rc}: {out}")
            wait_for(lambda: _quiet(lambda: all(
                net.peer_height(p) > h_kill for p in peers)),
                WIRE_TIMEOUT_S, "a commit after the kill at both peers")
            t_commit = time.perf_counter() - t_kill
            wait_for(lambda: _quiet(lambda: len({
                net.peer_height(p) for p in peers} | {
                net.channel_info(new_leader)["height"]}) == 1),
                WIRE_TIMEOUT_S, "equal heights")
            heights = {p: net.peer_height(p) for p in peers}
            for p in peers:
                rc, out = _cc_out(net.cc_args("query", "get,lastkey",
                                              peers=[p]))
                if (rc, out) != (0, "lastvalue\n"):
                    raise AssertionError(f"phase 19 (b): query at {p} gave "
                                         f"{rc} {out!r}")
            misses = {p: net.peer_metric(
                p, "fabric_bccsp_verdict_cache_misses") for p in peers}
            builds = {p: net.peer_metric(
                p, "fabric_gpu_kernel_nvcc_builds_total") for p in peers}
            if any((v or 0) <= PROCS_WARM_MISSES for v in misses.values()):
                raise AssertionError(f"phase 19 (b): verdict-cache misses "
                                     f"{misses}: no item went to the card "
                                     f"after the warm-up")
            if any(v != 0 for v in builds.values()):
                raise AssertionError(f"phase 19 (b): kernel builds in the "
                                     f"peers {builds}: not phase 2's build")
            if any(v is None or "CUDA context" not in v.group(1)
                   for v in startup.values()):
                raise AssertionError("phase 19 (b): a peer logged no "
                                     "start-up line")
        except BaseException:
            for name in net.procs:
                log(f"--- phase 19 (b) log of {name} (tail):\n"
                    f"{net.log_text(name)[-4000:]}")
            raise
        finally:
            net.teardown()
    log(f"phase 19 (b) as OS processes: 3 orderers and 2 GPU peers up in "
        f"{t_start:.1f} s (peers serving {t_up:.1f} s after the orderers' "
        f"leader); peer start-up "
        f"{[(p, s and s.group(1)) for p, s in startup.items()]};"
        f" {PROCS_PUTS} puts and {PROCS_INVOKES} `chaincode invoke`s, leader "
        f"{leader} SIGKILLed at height {h_kill}: new leader {new_leader} in "
        f"{t_elect:.2f} s, kill to the next commit at both peers "
        f"{t_commit:.2f} s; {PROCS_PUTS} puts and an invoke --wait-event "
        f"after; heights {heights}; query lastvalue at both; verdict-cache "
        f"misses {misses} (the warm-up's {PROCS_WARM_MISSES} among them); "
        f"nvcc builds {builds}; {time.perf_counter() - t_phase:.1f} s")


def _quiet(pred) -> bool:
    """`pred()`, false where it raises (a node not yet serving)."""
    try:
        return bool(pred())
    except Exception:
        return False


def phase_transport(torch, dev) -> dict:
    """Phase 19: (a) the transport in process on the card's GpuVerifier,
    (b) the process network.  Returns (a)'s launches."""
    from fabric_mod_tpu_torch.bccsp import gpu
    t_phase = time.perf_counter()
    launched = transport_inprocess(torch, dev, gpu.GpuVerifier(device=dev))
    transport_processes(torch, dev)
    log(f"transport phase: {time.perf_counter() - t_phase:.1f} s wall")
    return launched


def main_phase11(torch, dev) -> int:
    """`--phase 11`: phase 11 alone, its (b) on a stream made here (phase 8
    arm (a)'s first GOSSIP_BLOCKS blocks' worth, endorsed as phase 8 does);
    no kernels line."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import sw
    from fabric_mod_tpu_torch.ops import _build
    from fabric_mod_tpu_torch.utils import fixtures
    t0 = time.perf_counter()
    _build.build_many()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    material = fixtures.make_network_material(
        SEED, max_message_count=TX_PER_BLOCK, batch_timeout=E2E_BATCH_TIMEOUT,
        preferred_max_bytes=E2E_PREFERRED_MAX_BYTES)
    with tempfile.TemporaryDirectory() as root:
        net = e2e.Network(root, material=material, verifier=sw.SwVerifier())
        try:
            stream = fixtures.make_e2e_stream(
                net, GOSSIP_BLOCKS * TX_PER_BLOCK, PLANT_EVERY)
        finally:
            net.close()
    log(f"phase 11 (b) stream: {GOSSIP_BLOCKS * TX_PER_BLOCK} txs endorsed in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_dissemination(torch, dev)
    phase_relay_gossip(torch, dev, stream, None, None)
    phase_fanout(torch, dev)
    log(f"dissemination phase: {time.perf_counter() - t0:.1f} s wall")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_phase12(torch, dev) -> int:
    """`--phase 12`: phase 12 alone; no kernels line."""
    from fabric_mod_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_many()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    phase_sharding(torch, dev)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_phase13(torch, dev) -> int:
    """`--phase 13`: phase 13 alone; no kernels line."""
    from fabric_mod_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_many()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    phase_durable(torch, dev)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_phase14(torch, dev) -> int:
    """`--phase 14`: phase 14 alone, its (f) on a state-scale stream made
    here; no kernels line."""
    from fabric_mod_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_many()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    phase_lifecycle(torch, dev)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_phase15(torch, dev) -> int:
    """`--phase 15`: phase 15 alone after phase 8 (a), which gives it the
    ordered blocks and the stream ((d) orders that stream twice); no
    kernels line."""
    from fabric_mod_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_many()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    obs_part("b", obs_lens, torch, dev)
    _counts, _block, stream, _fp = phase_e2e(torch, dev, arm="a",
                                             n_blocks=E2E_BLOCKS)
    obs_part("a", obs_traced_commit, torch)
    accepted = [env for env, ok in stream[0] if ok]
    phase_observability(torch, dev, accepted, accepted)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_phase16(torch, dev) -> int:
    """`--phase 16`: phase 16 alone after phase 8 (a), which gives it the
    stream and the fingerprint; no kernels line."""
    from fabric_mod_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_many()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    _counts, _block, full, solo_fp = phase_e2e(torch, dev, arm="a",
                                               n_blocks=E2E_BLOCKS)
    phase_services(torch, dev, full, solo_fp)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_phase17(torch, dev) -> int:
    """`--phase 17`: phase 17 alone after phase 8 (a), whose ordered
    blocks and fingerprint (b) commits again; no kernels line."""
    from fabric_mod_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_many()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    _counts, _block, _full, solo_fp = phase_e2e(torch, dev, arm="a",
                                                n_blocks=E2E_BLOCKS)
    phase_soak(torch, dev, solo_fp, sharded=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_phase18(torch, dev) -> int:
    """`--phase 18`: phase 18 alone; no kernels line."""
    from fabric_mod_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_many()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    phase_tools(torch, dev)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_phase7(torch, np, dev) -> int:
    """`--phase 7`: phase 7 alone with (d), the plain pairing's profile,
    which the whole script leaves out for its time limit; no kernels
    line."""
    from fabric_mod_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_many()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    _launched, _entries, pairing_profile = phase_idemix(torch, np)
    pairing_profile()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_phase19(torch, dev) -> int:
    """`--phase 19`: phase 19 alone; no kernels line."""
    from fabric_mod_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_many()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    phase_transport(torch, dev)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase",
                        choices=["7", "11", "12", "13", "14", "15", "16",
                                 "17", "18", "19"],
                        default=None,
                        help="run one phase alone (after the header)")
    only = parser.parse_args().phase
    import resource
    # hundreds of durable peers each hold a handful of store files open
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = 1 << 16 if hard == resource.RLIM_INFINITY else min(hard, 1 << 16)
    if soft != resource.RLIM_INFINITY and soft < want:
        resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from fabric_mod_tpu_torch import device as _device
    from fabric_mod_tpu_torch.ops import _build
    from fabric_mod_tpu_torch.utils import fixtures

    # 1. header
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {name}")
    log(smi)
    _device.require_exact_fp32()
    dev = _device.resolve(None)

    if only == "7":
        return main_phase7(torch, np, dev)
    if only == "11":
        return main_phase11(torch, dev)
    if only == "12":
        return main_phase12(torch, dev)
    if only == "13":
        return main_phase13(torch, dev)
    if only == "14":
        return main_phase14(torch, dev)
    if only == "15":
        return main_phase15(torch, dev)
    if only == "16":
        return main_phase16(torch, dev)
    if only == "17":
        return main_phase17(torch, dev)
    if only == "18":
        return main_phase18(torch, dev)
    if only == "19":
        return main_phase19(torch, dev)

    # each top-level step's wall, printed at the end beside the total
    walls, t_mark = {}, [time.perf_counter()]

    def mark(step: str) -> None:
        now = time.perf_counter()
        walls[step] = round(now - t_mark[0], 1)
        t_mark[0] = now

    # 2. build
    t0 = time.perf_counter()
    probe_build = start_probe_build()
    logs = _build.build_many()
    probe_fn = finish_probe_build(probe_build)
    log(f"build: {time.perf_counter() - t0:.1f} s for {list(_build.SOURCES)} "
        f"and {PROBE_SOURCE.name}")
    for src, out in logs.items():
        for line in out.splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"  ptxas[{src}]: {line.strip()}")
    probe = latency_probe(torch, dev, probe_fn)
    log(f"sha256_latency_probe (clock64 on one warp, cycles a link): SHF -> "
        f"LOP3 -> IADD3 {probe['alu']:.2f}, a shuffle and an add "
        f"{probe['shuffle']:.2f}, three SHF -> LOP3 -> IADD3 "
        f"{probe['round']:.2f}")
    mark("2 build")

    # 3. kernels against their plain versions; the SHA-256 kernel on the
    # block-commit fixture's real messages (made here, committed in 5)
    kernels = phase_kernels(torch, np, dev)
    # 15 (b), the device lens: the process's first GpuVerifier dispatch,
    # before any profiler window (see OBS_PARTS)
    obs_part("b", obs_lens, torch, dev)
    t0 = time.perf_counter()
    world = fixtures.make_commit_world()
    raw_world = fixtures.make_commit_world(raw_messages=True)
    commit_blocks, expected = fixtures.make_commit_blocks(
        world, N_BLOCKS, TX_PER_BLOCK, plant_every=PLANT_EVERY)
    log(f"fixtures: {N_BLOCKS} encoded blocks of {TX_PER_BLOCK} txs signed "
        f"in {time.perf_counter() - t0:.1f} s (pure-python signer)")
    kernels.update(phase_sha_kernel(
        torch, np, dev, sm_clock_hz(),
        torch.cuda.get_device_properties(0).multi_processor_count,
        commit_messages(commit_blocks, LANES), probe))
    mark("3 kernels, 15 (b), fixtures")

    # 4. the verify path
    t0 = time.perf_counter()
    blocks = [fixtures.make_block(b, n_tx=TX_PER_BLOCK,
                                  raw_endorsers=(b == N_BLOCKS - 1))
              for b in range(N_BLOCKS)]
    log(f"fixtures: {N_BLOCKS} blocks signed in "
        f"{time.perf_counter() - t0:.1f} s (pure-python signer)")
    counts = phase_main_path(torch, np, blocks)
    log(f"verify path kernel launches {counts}")
    mark("4 verify path")

    # 5. the block commit: the main path
    counts = phase_block_commit(torch, np, world, raw_world, commit_blocks,
                                expected)
    mark("5 block commit")

    # 8. the end-to-end network on a solo orderer, in turns: (a)
    # unstaged, (b) staged
    t0 = time.perf_counter()
    arms = {}
    arms["a"], e2e_block, full, solo_fp = phase_e2e(torch, dev, arm="a",
                                                    n_blocks=E2E_BLOCKS)
    arms["b"], _, order_free, _ = phase_e2e(torch, dev, arm="b",
                                            n_blocks=E2E_BLOCKS)
    # 15 (a), the traced commit of arm (a)'s blocks, before the profiled
    # block below and phases 6-14's windows (see OBS_PARTS)
    obs_part("a", obs_traced_commit, torch)
    profile_e2e_block(torch, *e2e_block)
    log(f"e2e phase: {time.perf_counter() - t0:.1f} s wall")
    mark("8 e2e, 15 (a)")

    # 9. the same streams through three Raft orderers: (c) unstaged via a
    # follower, (d) staged over every orderer
    t0 = time.perf_counter()
    arms["c"], _, _, raft_fp = phase_e2e(torch, dev, arm="c",
                                         n_blocks=E2E_BLOCKS, stream=full)
    if raft_fp != solo_fp:
        raise AssertionError("arm (c)'s state fingerprint differs from arm "
                             "(a)'s on the same stream in the same order")
    arms["d"], _, _, _ = phase_e2e(torch, dev, arm="d", n_blocks=E2E_BLOCKS,
                                   stream=order_free)
    log(f"Raft e2e phase: {time.perf_counter() - t0:.1f} s wall; arm (c)'s "
        f"fingerprint == arm (a)'s ({raft_fp[:16]})")
    mark("9 Raft e2e")

    # 6. where a block's time goes (after the counted runs)
    phase_profile(torch, blocks, world, commit_blocks)
    mark("6 profile")

    # 7. the idemix presentation verify
    arms["idemix"], idemix_kernels, _plain_profile = phase_idemix(torch, np)
    kernels.update(idemix_kernels)
    mark("7 idemix")

    # 10. gossip: (a) the 50-peer MCS storm, (b) 50 gossip peers over
    # one verifier around a solo network ordering arm (a)'s stream.  Run
    # last: after (b)'s long profiled window, later torch.profiler
    # windows on the card recorded none of the hand-written kernels
    t0 = time.perf_counter()
    arms["gossip_storm"] = phase_gossip_storm(torch, dev)
    arms["gossip_network"], gossip_figures = phase_gossip_network(
        torch, dev, full, solo_fp)
    log(f"gossip phase: {time.perf_counter() - t0:.1f} s wall")
    mark("10 gossip")

    # 11. deliver fan-out and dissemination trees: (a) 128 peers, relay
    # against all-pull; (b) phase 10 (b)'s world over the relay; (c) the
    # fan-out to 10,000 subscribers
    t0 = time.perf_counter()
    arms["dissemination"] = phase_dissemination(torch, dev)
    arms["relay_gossip"] = phase_relay_gossip(torch, dev, full, solo_fp,
                                              gossip_figures)
    arms["fanout"] = phase_fanout(torch, dev)
    log(f"dissemination phase: {time.perf_counter() - t0:.1f} s wall")
    mark("11 dissemination")

    # 12. channel sharding: (a) bench.py's multichannel curve at 1000-tx
    # blocks, (b) per-slice and per-channel isolation, (c) the mesh over
    # two or more cards
    arms["multichannel"] = phase_sharding(torch, dev)
    mark("12 sharding")

    # 13. the durable ledger and private data: (a) state scale at 10k,
    # 100k and 1M keys, (b) crash and recovery on phase 5's blocks, (c)
    # private data across three peers
    scale_blocks = make_scale_blocks()
    arms["durable"] = phase_durable(torch, dev, commit_blocks, expected,
                                    scale_blocks)
    mark("13 durable")

    # 14. lifecycle, system chaincodes, config updates, rich queries and
    # snapshots: (a)-(e) on a solo network beside a host oracle, (f) the
    # snapshot, a bootstrapped peer and the admin commands
    arms["lifecycle"] = phase_lifecycle(torch, dev, scale_blocks)
    mark("14 lifecycle")

    # 15. observability and the orderer's ingress: (a) phase 8 (a)'s
    # blocks committed traced and untraced, (b) the device lens, (c) the
    # broadcast storm, (d) a Raft join and a follower over phase 8's two
    # streams
    arms["observability"] = phase_observability(
        torch, dev, [env for env, ok in order_free[0] if ok],
        [env for env, ok in full[0] if ok])
    mark("15 (c), (d)")
    # 16. the service surface: (b) external chaincode and (a) discovery
    # on one network, (c) the broker consenter under (d) the operations
    # servers, over phase 8 (a)'s stream
    arms["services"] = phase_services(torch, dev, full, solo_fp)
    mark("16 services")
    # 17. the soak under churn: (a) the reference's acceptance soak on the
    # card, (b) fault seams against the card; (c), the sharded soak, runs
    # under --phase 17 only, for the whole script's time limit
    arms["soak"] = phase_soak(torch, dev, solo_fp, sharded=False)
    mark("17 soak")
    # 18. the offline tools and the lock discipline: a tool-built network
    # committing on the card under armed guards, its snapshot and join,
    # discover, and idemixgen's presentations on the card
    arms["tools"] = phase_tools(torch, dev)
    mark("18 tools")
    # 19. the transport: (a) three Raft orderers and two peers in this
    # process over mutual TLS, the leader stopped between the two blocks;
    # (b) the same as OS processes, the leader SIGKILLed
    arms["transport"] = phase_transport(torch, dev)
    mark("19 transport")
    # 7 (d), the plain pairing's profile (_plain_profile), runs under
    # --phase 7 only, for the script's time limit
    for k in kernels.values():
        k["launches"] = counts.get(k["name"], 0) + sum(
            c.get(k["name"], 0) for c in arms.values())

    log(f"walls (s) by step, the header's excluded: {json.dumps(walls)}; "
        f"sum {sum(walls.values()):.1f}")
    log(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
