"""fabric_mod_tpu_torch — the PyTorch/CUDA port of fabric_mod_tpu's device half.

The JAX package (fabric_mod_tpu/) stays the reference; this package
imports torch and numpy, never jax and never a module of the reference.
It keeps its own copy of whatever it needs.  Entry points run on CUDA
unless the caller passes device="cpu"; with no card and no such request
they raise.

Slice 1 ports the batch ECDSA-P256 verify provider — the system's hot
path on the accelerator — with the Shamir ladder as two hand-written
CUDA kernels for Hopper (sm_90a).

Counterparts (reference module -> port module):

==============================  ==========================================
fabric_mod_tpu/                 fabric_mod_tpu_torch/
==============================  ==========================================
bccsp/api.py (VerifyItem)       bccsp/api.py
bccsp/sw.py + _ecfallback.py    bccsp/sw.py (pure-python P-256, seeded)
bccsp/der.py                    bccsp/der.py (verbatim copy)
bccsp/tpu.py (TpuVerifier)      bccsp/gpu.py (GpuVerifier)
utils/fixtures.py               utils/fixtures.py (+ make_block)
ops/limbs9.py                   ops/limbs9.py (plain torch limb layer)
ops/sha256.py                   ops/sha256.py (torch ops, int64 words)
ops/p256.py                     ops/p256.py (plain ladders, verify core)
ops/p256_pallas.py (kernels)    ops/p256_cuda.py + csrc/p256_ladder.cu
                                + ops/_build.py (nvcc -> ctypes)
(none)                          convert.py (constants/layouts across)
(none)                          device.py (device choice, exact fp32)
==============================  ==========================================

`python3 chip_smoke.py` at the repository root builds the kernels and
drives this path on the card.
"""
