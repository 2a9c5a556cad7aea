"""fabric_mod_tpu_torch — the PyTorch/CUDA port of fabric_mod_tpu's device half.

The JAX package (fabric_mod_tpu/) stays the reference; this package
imports torch and numpy, never jax, never a module of the reference and
never the `cryptography` wheel.  It keeps its own copy of whatever it
needs.  Entry points run on CUDA unless the caller passes device="cpu";
with no card and no such request they raise.

Slice 1 ported the batch ECDSA-P256 verify provider, with the Shamir
ladder as two hand-written CUDA kernels for Hopper (sm_90a); slice 2
redesigned both kernels.  Slice 3 ports the block-commit path around
it: an encoded block -> TxValidator (host unpack, MSP, one batch
collector) -> GpuVerifier (the CUDA ladders) -> the tensor-policy
evaluator on the device-resident verify mask -> txflags -> MVCC -> the
ledger -> state fingerprint.  Slice 4 ports the idemix
presentation verify: `batch_verify` (idemix/credential.py) sends every
presentation's pairing equation to the batched FP256BN pairing
(ops/fp256bn_dev.py) on the card as one check and keeps the Schnorr
remainder on the host.  Slice 5 ports the in-process end-to-end network
(e2e.py): channel config and the channel policy tree, the solo orderer,
the MCS, the pipelined deliver-and-commit path, endorsers and a
block-store ledger.  Slice 6 ports the verify core around the ladder
as two more CUDA kernels (csrc/p256_core.cu: the scalar prologue with
the key check, and the epilogue), so a verify call is three launches,
and staged broadcast ingress with the Writers check batched on the
card (BatchingVerifyService, orderer/stagedbroadcast.py).  Slice 7
redesigns that prologue for the card: s^-1 mod n by divsteps (safegcd)
on a lane of two threads, one inverting while the other checks the key.
Slice 14 makes the ledger durable (log-structured state and history,
O(delta) recovery, the incremental fingerprint) and ports private data
(transient and pvt stores, BTL purges, gossip's private-data paths).
Slice 15 ports the chaincode lifecycle (the ceremony and the write-aware
validation of org-local approvals), the system chaincodes, config
updates, rich queries, ledger snapshots and the admin commands.
Slice 16 puts the idemix pairing check on two hand-written CUDA kernels
(csrc/fp256bn_pairing.cu: the Miller loops, then the final
exponentiation with the verdict), two launches a check.  Slice 19
ports the service surface: discovery (its access check verified on
the card), the broker consenter, external chaincode (packages, the
ccaas protocol, platforms, builders) and the operations server with
logging specs, diagnostics and health.  Slice 20 ports the soak under
churn (every soak peer verifying through one shared GpuVerifier), the
fault seams with their plans, the retry policy, the worker-thread
registry and the event deliver service in process.  Slice 21 ports the
offline tools (cli/ less node and chaincode, protos/jsonpb.py, a
YAML-subset reader) and the lock discipline: every lock, queue and
ownership guard the reference builds, under its name and rank.

Counterparts (reference module -> port module):

==============================  ==========================================
fabric_mod_tpu/                 fabric_mod_tpu_torch/
==============================  ==========================================
bccsp/api.py (VerifyItem)       bccsp/api.py
bccsp/sw.py + _ecfallback.py    bccsp/sw.py (pure-python P-256, seeded;
                                DER/PEM/SPKI/PKCS#8; SwCSP, SwVerifier)
bccsp/_x509fallback.py          bccsp/x509.py (the only X.509 layer)
bccsp/der.py                    bccsp/der.py (verbatim copy)
bccsp/tpu.py (TpuVerifier,      bccsp/gpu.py (GpuVerifier, fused seam,
BatchingVerifyService)          BatchingVerifyService)
utils/fixtures.py               utils/fixtures.py (+ make_block,
                                make_commit_world, make_commit_blocks,
                                make_network_material, make_e2e_stream,
                                make_core_lanes)
ops/limbs9.py                   ops/limbs9.py (plain torch limb layer)
ops/sha256.py                   ops/sha256.py (torch ops, int64 words)
ops/p256.py                     ops/p256.py (plain ladders, plain
                                prologue and epilogue, batch_verify)
ops/p256.py _verify_core_impl   ops/p256_core.py + csrc/p256_core.cu
(prologue, epilogue)            (the packed buffer, two kernels)
ops/p256_pallas.py (kernels)    ops/p256_cuda.py + csrc/p256_ladder.cu
                                + csrc/p256_field.cuh (shared field
                                code) + ops/_build.py (nvcc -> ctypes)
protos/wire.py, messages.py,    protos/ (verbatim copies)
protoutil.py
msp/ca.py, identities.py,       msp/ (seeded CA; raw-message items an
mspimpl.py, cache.py            MSP constructor argument)
policy/policydsl.py,            policy/ (copies; the manager without
cauthdsl.py, application.py,    the reference's CSP lookup: host
manager.py                      verifies go through bccsp/sw.py)
policy/tensorpolicy.py          policy/tensorpolicy.py (the evaluator as
                                torch ops on the mask's device)
ledger/rwsetutil.py,            ledger/ (copies; the config history
statedb.py, mvcc.py, durable.py without its listeners)
confighistory.py, pvtdata.py,
richquery.py, snapshot.py,
admin.py
ledger/blkstorage.py            ledger/blkstorage.py (copy)
ledger/kvledger.py              ledger/kvledger.py (durable by default;
                                same files and state fingerprint)
channelconfig/bundle.py,        channelconfig/ (copies over bccsp/x509.py)
configtx.py, genesis.py,
update.py, capabilities.py
orderer/blockcutter.py,         orderer/ (solo only; no admission gate,
blockwriter.py, msgprocessor.py no follower; staged lanes a Broadcast
consensus.py, registrar.py,     constructor argument)
broadcast.py, deliver.py,
stagedbroadcast.py
peer/plugins.py, txvalidator.py peer/ (generic per-tx decode path;
                                tensor_policy a constructor argument)
peer/mcs.py, commitpipe.py,     peer/ (the reference's guards;
channel.py, deliverclient.py,   pipeline_depth a constructor argument)
chaincode.py, endorser.py,
lifecycle.py, scc.py
e2e.py                          e2e.py (Network from NetworkMaterial)
idemix/fp256bn.py               idemix/fp256bn.py (host reference copy)
ops/fp256bn_dev.py              ops/fp256bn_dev.py (the batched pairing;
                                on the card ops/fp256bn_cuda.py's two
                                kernels, csrc/fp256bn_pairing.cu; the
                                stacked torch-ops tower its plain twin)
idemix/credential.py,           idemix/ (copies; seeded `rng=`, the RA
revocation.py                   over bccsp/sw.py)
msp/idemixmsp.py                msp/idemixmsp.py (copy)
parallel/mesh.py                parallel/mesh.py (device tuples; the
                                lane split in place of NamedShardings)
sharding/shardmap.py, router.py sharding/ (copies; knobs as arguments,
verifyservice.py, multihost.py  no metrics; multihost a stub, as there)
discovery/service.py            discovery/service.py (copy; the
                                Readers check through the given
                                verify_many)
orderer/broker.py               orderer/broker.py (the same topic file
                                format)
peer/ccpackage.py,              peer/ (copies; python packages'
extbuilder.py, platforms.py     reference imports resolve to the port)
observability/opsserver.py,     observability/ (copies over the port's
logging.py, diag.py             metrics and tracer; health: commit
                                pipes only)
soak/ (plan, workload,          soak/ (copies; the FMT_SOAK_* knobs
invariants, world, harness)     SoakConfig arguments; one shared
                                GpuVerifier; the event stream in
                                process)
faults/ (points, core)          faults/ (copies less three points;
                                nothing armed at import)
utils/retry.py                  utils/retry.py (copy; defaults as
                                constants)
concurrency/ (threads, core,     concurrency/ (copies; armed by enable()
cancel, locks, queues,          or armed(), never by the environment)
ownership)
utils/racecheck.py,             utils/ (copies)
semaphore.py
cli/ (cryptogen, configtxgen,   cli/ (copies; node and chaincode exit 2;
configtxlator, idemixgen,       the YAML read by utils/yamlread.py;
discover, ledgerutil, main)     discover on the card's GpuVerifier)
protos/jsonpb.py                protos/jsonpb.py (copy)
peer/deliverevents.py           peer/deliverevents.py (in process; no
                                gRPC registration)
(none)                          convert.py (constants, layouts, a
                                world's bytes, a network's material and
                                idemix data across)
(none)                          device.py (device choice, exact fp32)
==============================  ==========================================

`python3 chip_smoke.py` at the repository root builds the kernels and
drives these paths on the card.
"""
