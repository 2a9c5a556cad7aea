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
in-memory ledger -> state fingerprint.  Slice 4 ports the idemix
presentation verify: `batch_verify` (idemix/credential.py) sends every
presentation's pairing equation to the batched FP256BN pairing
(ops/fp256bn_dev.py) on the card as one check and keeps the Schnorr
remainder on the host.  Slice 5 ports the in-process end-to-end network
(e2e.py): channel config and the channel policy tree, the solo orderer,
the MCS, the pipelined deliver-and-commit path, endorsers and a
block-store ledger.

Counterparts (reference module -> port module):

==============================  ==========================================
fabric_mod_tpu/                 fabric_mod_tpu_torch/
==============================  ==========================================
bccsp/api.py (VerifyItem)       bccsp/api.py
bccsp/sw.py + _ecfallback.py    bccsp/sw.py (pure-python P-256, seeded;
                                DER/PEM/SPKI/PKCS#8; SwCSP, SwVerifier)
bccsp/_x509fallback.py          bccsp/x509.py (the only X.509 layer)
bccsp/der.py                    bccsp/der.py (verbatim copy)
bccsp/tpu.py (TpuVerifier)      bccsp/gpu.py (GpuVerifier, fused seam)
utils/fixtures.py               utils/fixtures.py (+ make_block,
                                make_commit_world, make_commit_blocks,
                                make_network_material, make_e2e_stream)
ops/limbs9.py                   ops/limbs9.py (plain torch limb layer)
ops/sha256.py                   ops/sha256.py (torch ops, int64 words)
ops/p256.py                     ops/p256.py (plain ladders, verify core)
ops/p256_pallas.py (kernels)    ops/p256_cuda.py + csrc/p256_ladder.cu
                                + ops/_build.py (nvcc -> ctypes)
protos/wire.py, messages.py,    protos/ (verbatim copies)
protoutil.py
msp/ca.py, identities.py,       msp/ (seeded CA; raw-message items an
mspimpl.py, cache.py            MSP constructor argument)
policy/policydsl.py,            policy/ (copies; the manager without
cauthdsl.py, application.py,    the reference's CSP lookup: host
manager.py                      verifies go through bccsp/sw.py)
policy/tensorpolicy.py          policy/tensorpolicy.py (the evaluator as
                                torch ops on the mask's device)
ledger/rwsetutil.py,            ledger/ (copies, without private data)
statedb.py, mvcc.py
ledger/blkstorage.py            ledger/blkstorage.py (copy)
ledger/kvledger.py              ledger/kvledger.py (block store + state
                                in memory; same state fingerprint)
channelconfig/bundle.py,        channelconfig/ (copies over bccsp/x509.py)
configtx.py, genesis.py
orderer/blockcutter.py,         orderer/ (solo only; no admission gate,
blockwriter.py, msgprocessor.py no staged broadcast, no follower)
consensus.py, registrar.py,
broadcast.py, deliver.py
peer/plugins.py, txvalidator.py peer/ (generic per-tx decode path;
                                tensor_policy a constructor argument)
peer/mcs.py, commitpipe.py,     peer/ (plain threading objects;
channel.py, deliverclient.py,   pipeline_depth a constructor argument;
chaincode.py, endorser.py,      lifecycle: its names only)
lifecycle.py
e2e.py                          e2e.py (Network from NetworkMaterial)
idemix/fp256bn.py               idemix/fp256bn.py (host reference copy)
ops/fp256bn_dev.py              ops/fp256bn_dev.py (the batched pairing
                                as torch ops; stacked tower products)
idemix/credential.py,           idemix/ (copies; seeded `rng=`, the RA
revocation.py                   over bccsp/sw.py)
msp/idemixmsp.py                msp/idemixmsp.py (copy)
(none)                          convert.py (constants, layouts, a
                                world's bytes, a network's material and
                                idemix data across)
(none)                          device.py (device choice, exact fp32)
==============================  ==========================================

`python3 chip_smoke.py` at the repository root builds the kernels and
drives these paths on the card.
"""
