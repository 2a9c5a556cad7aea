#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's device paths once on one CUDA card: the
block commit, the end-to-end network around it (the main path) and the
idemix presentation verify.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught):

1. header — the card's name, and its name and power limit from nvidia-smi;
2. build — both ladder kernels from fabric_mod_tpu_torch/csrc/ (nvcc),
   with ptxas' registers, stack and spills;
3. kernel against plain — each ladder kernel at 2048 lanes against its
   plain PyTorch version on the card (random windows, distinct keys
   (i+2)G, identity-adjacent edge lanes, an off-curve and a (0, 0) key):
   canonical X, Y, Z must be bit-equal, and the mixed ladder must equal
   the projective one in affine form on every valid-key lane.  Prints
   each kernel's threads per lane and block size, ms per call, the
   bound (32-bit multiply-adds the function needs over the card's
   integer multiply-add rate at its SM clock) and one lane's critical
   path in rounds;
4. verify path — 4 blocks of 1000 transactions (3000 signatures each,
   2-of-3 endorsement) through GpuVerifier.verify_many, once per ladder;
   the 4th block's endorser items are raw messages hashed on the card.
   Verdicts must equal the fixtures' expected masks bit for bit and, on
   256 sampled lanes per block, the pure-python software verify; both
   kernels' launch counts (zeroed just before) must have risen;
5. block commit — the system's main path: 4 encoded blocks of 1000
   transactions (utils/fixtures.make_commit_blocks: every planted invalid
   kind, a VALIDATION_PARAMETER pin) through the port's Committer
   (TxValidator, MVCC, in-memory ledger) into a fresh ledger per arm:
   (a) the projective ladder with the tensor-policy evaluator, which must
   receive a CUDA mask on every block; (b) the same with the policy
   closures; (c) the mixed ladder with the evaluator; (d) the host
   software verifier, the oracle.  Every arm's txflags must equal the
   fixture's and each other, every state fingerprint must be equal, and
   both kernels' launch counts (zeroed just before) must have risen.
   Prints ms per block by stage, committed tx/s and the evaluator's
   device ms;
8. e2e (run after 5) — the system's own end-to-end loop
   (fabric_mod_tpu_torch/e2e.py `Network`): one channel of 3 orgs from
   utils/fixtures.make_network_material, a solo orderer cutting 1000-tx
   blocks on count (batch timeout 10 s), one committing peer with the
   projective-ladder GpuVerifier and the tensor-policy evaluator.  4,000
   put txs are endorsed up front (2 of 3 orgs, MAJORITY) by
   fixtures.make_e2e_stream, with a planted kind of each sort every 50
   txs (one-org endorsement, a flipped endorsement, an MVCC read
   conflict, a resubmitted envelope, a setvp pin that drains the commit
   pipe at a barrier, and a tampered creator signature that Broadcast
   rejects).  Timed (e2e.commit_until, as e2e.run_pipeline): the
   deliver client starts, one thread broadcasts every envelope, and the
   span ends when the 4,000 txs are committed.  Every block must hold
   1000 txs with the construction's flags, the rejections must equal
   the planted count, the state fingerprint must equal that of a fresh
   ledger fed the ordered blocks with the expected flags, the MCS (one
   verify per block) and the validator (one fused verify per block)
   must each have launched the projective ladder at least once per
   block (launches counted by the calling path), and the evaluator
   must have received a CUDA mask on every block.  Prints committed
   tx/s, ingress seconds, the deliver client's stage/await/commit
   seconds, MCS ms per block, the evaluator's fallbacks, and
   torch.profiler over one block's MCS check and stage-and-commit on a
   fresh peer: launches, device busy, idle share;
7. idemix (run after 8, before the profile) — the batched FP256BN
   pairing (ops/fp256bn_dev.py, plain torch ops on the card): (a) a
   pairing check at 1024 lanes, a 1000-tx idemix block's width, from
   utils/fixtures.make_pairing_lanes (every 97th lane tampered): the
   mask stays a CUDA tensor until its one copy, must equal the
   construction's, and on 8 sampled lanes the host pairings' equality;
   ms per check (CUDA events and wall, warm); (b) 4 full pairings on the
   card, each equal to the host `pairing` exactly; (c) batch_verify of
   64 presentations (3 planted kinds): verdicts equal the expected ones
   and, on the first 16, the host path's; presentations/s of both paths
   and the pairing check's share of the device path; (d) for both
   checks, torch.profiler over one of each repeated piece (the line
   precompute, a Miller doubling step, an add step, a cyclotomic square,
   a multiply, and the rest once), scaled by the schedule's static
   counts: launches per check, device busy ms, idle share;
6. profile — torch.profiler over one verify of each block kind and over
   one whole block commit: wall time, device busy time and idle share,
   the heaviest device kernels; and over the policy evaluator's pass
   alone: its launches and device time per block.

It prints one JSON line describing each kernel (`launches` counts the
block-commit and e2e phases), and as its last line
{"ok": true, "device": {...}}.  Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

LANES = 2048
N_BLOCKS = 4
TX_PER_BLOCK = 1000
SAMPLE = 256
SEED = 20261016
# block-commit phase: a planted invalid tx of each kind every 50 txs
PLANT_EVERY = 50

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
    return results


def phase_main_path(torch, np, blocks):
    from fabric_mod_tpu_torch.bccsp import gpu, sw
    from fabric_mod_tpu_torch.ops import p256_cuda
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
    per_ladder = {}
    p256_cuda.reset_counts()
    for lad, v in verifiers.items():
        before = p256_cuda.counts()
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
        after = p256_cuda.counts()
        launched = {k: after[k] - before[k] for k in after}
        n_items = sum(len(b[0]) for b in blocks)
        per_ladder[lad] = launched
        log(f"verify path ({lad} ladder): {N_BLOCKS} blocks x {len(blocks[0][0])} "
            f"signatures, verdicts == expected masks and == sw on "
            f"{SAMPLE} sampled lanes/block; ms per block "
            f"{[round(m, 1) for m in block_ms]}; "
            f"{n_items / (sum(block_ms) / 1e3):.0f} verifies/s; "
            f"kernel launches {launched} "
            f"({sum(launched.values()) / N_BLOCKS:.1f} per 1000-tx block)")
    counts = p256_cuda.counts()
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "verify path")
    return counts


def device_profile(torch, fn):
    """Run fn() under torch.profiler: (wall ms, device kernels, device
    busy ms, [(name, count, ms)] heaviest first), or device figures None
    when the profiler recorded no device kernel."""
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


def log_profile(label, wall_ms, n_kernels, busy_ms, top) -> None:
    if n_kernels is None:
        log(f"profile {label}: wall {wall_ms:.1f} ms; device time not "
            "measured (the profiler recorded no device kernels)")
        return
    log(f"profile {label}: wall {wall_ms:.1f} ms, device kernels "
        f"{n_kernels}, device busy {busy_ms:.1f} ms, device idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    for name, c, t in top:
        log(f"  {t:9.2f} ms  x{c:<6d} {name[:90]}")


def phase_block_commit(torch, np, world, blocks, expected):
    """The block commit through the port's Committer, arm by arm, each
    into a fresh in-memory ledger.  Returns the kernel launch counts of
    the GPU arms."""
    from fabric_mod_tpu_torch.bccsp import gpu, sw
    from fabric_mod_tpu_torch.ops import p256_cuda
    from fabric_mod_tpu_torch.policy import tensorpolicy
    from fabric_mod_tpu_torch.protos import messages as m
    arms = (("a", "projective ladder, tensor policy", "projective", True),
            ("b", "projective ladder, policy closures", "projective", False),
            ("c", "mixed ladder, tensor policy", "mixed", True),
            ("d", "host software verifier (oracle)", None, False))
    n_tx = sum(len(f) for f in expected)
    n_valid = sum(f == m.TxValidationCode.VALID for b in expected for f in b)
    flags_by_arm, fps = {}, {}
    p256_cuda.reset_counts()
    for arm, label, ladder, tensor in arms:
        verifier = (gpu.GpuVerifier(ladder=ladder, cache_size=0)
                    if ladder else sw.SwVerifier())
        committer = world.committer(verifier, tensor_policy=tensor)
        tensorpolicy.reset_counts()
        flags_by_arm[arm] = []
        timings = []
        wall = 0.0
        for bi, raw in enumerate(blocks):
            block = m.Block.decode(raw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flags = committer.store_block(block)
            wall += time.perf_counter() - t0
            timings.append(committer.last_timings)
            if flags != expected[bi]:
                bad = [i for i, (g, w) in enumerate(zip(flags, expected[bi]))
                       if g != w][:8]
                raise AssertionError(f"arm {arm}: block {bi} txflags differ "
                                     f"from the expected flags at {bad}")
            flags_by_arm[arm].append(flags)
        fps[arm] = committer.ledger.state_fingerprint()
        passes = tensorpolicy.counts()
        want = {"cuda": len(blocks)} if tensor else {}
        if passes != want:
            raise AssertionError(f"arm {arm}: policy evaluator passes "
                                 f"{passes}, expected {want}")
        stages = ("stage", "verify", "policy", "commit")
        split = {k: [round(t[k] * 1e3, 1) for t in timings] for k in stages}
        total = [round(sum(t[k] for k in stages) * 1e3, 1) for t in timings]
        log(f"block commit arm ({arm}) {label}: {len(blocks)} blocks x "
            f"{len(expected[0])} txs, txflags == expected; ms per block "
            f"{total}: stage {split['stage']}, verify {split['verify']}, "
            f"policy {split['policy']}, mvcc+commit {split['commit']}; "
            f"{n_tx / wall:.1f} committed tx/s ({n_valid / wall:.1f} valid "
            f"tx/s); fingerprint {fps[arm][:16]}")
        if tensor:
            dev_ms = [round(t["policy_device_ms"], 3) for t in timings]
            log(f"  policy evaluator on the CUDA mask: {passes['cuda']} "
                f"passes, device ms per block {dev_ms} (CUDA events)")
    if len({tuple(map(tuple, f)) for f in flags_by_arm.values()}) != 1:
        raise AssertionError("arms disagree on txflags")
    if len(set(fps.values())) != 1:
        raise AssertionError(f"state fingerprints differ across arms: {fps}")
    counts = p256_cuda.counts()
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "block-commit path")
    log(f"block commit: all arms agree on txflags and state fingerprint "
        f"{fps['a']}; kernel launches {counts}")
    return counts


def phase_profile(torch, blocks, world, commit_blocks):
    """Where a block's time goes: torch.profiler over one verify_many
    per block kind (digest-only, raw endorsers) and over one whole
    block commit (projective ladder, tensor policy); then over the
    policy evaluator's pass alone, on the verify mask of the block."""
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.protos import messages as m
    v = gpu.GpuVerifier(ladder="projective", cache_size=0)
    for label, (items, _expect) in (("digest block", blocks[0]),
                                    ("raw-endorser block", blocks[-1])):
        log_profile(f"{label} ({len(items)} signatures)",
                    *device_profile(torch, lambda: v.verify_many(items)))
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


def phase_e2e(torch, dev, n_blocks=N_BLOCKS, block_txs=TX_PER_BLOCK,
              plant_every=PLANT_EVERY):
    """The end-to-end network (phase 8).  Returns the ladder kernels'
    launch counts of the timed run, and (material, block 1, its expected
    flags) for profile_e2e_block."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
    from fabric_mod_tpu_torch.ops import p256_cuda
    from fabric_mod_tpu_torch.orderer import BroadcastError
    from fabric_mod_tpu_torch.policy import tensorpolicy
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    from fabric_mod_tpu_torch.utils import fixtures
    n_tx = n_blocks * block_txs
    material = fixtures.make_network_material(
        SEED, max_message_count=block_txs, batch_timeout=E2E_BATCH_TIMEOUT,
        preferred_max_bytes=E2E_PREFERRED_MAX_BYTES)
    # no verdict cache: every block's mask is the device tensor
    verifier = gpu.GpuVerifier(device=dev, ladder="projective", cache_size=0)
    with tempfile.TemporaryDirectory() as root:
        net = e2e.Network(os.path.join(root, "timed"), material=material,
                          verifier=verifier, tensor_policy=True)
        try:
            t0 = time.perf_counter()
            submits, flat = fixtures.make_e2e_stream(net, n_tx, plant_every)
            planted = sum(not ok for _env, ok in submits)
            expected = [flat[b * block_txs:(b + 1) * block_txs]
                        for b in range(n_blocks)]
            log(f"e2e fixtures: {n_tx} txs endorsed by the network's "
                f"endorsers (+{planted} tampered) in "
                f"{time.perf_counter() - t0:.1f} s (pure-python signer)")

            # which path reached the verifier: the MCS calls verify_many,
            # the validator verify_many_fused_async.  Each call tags its
            # thread with its path, and each ladder call adds the
            # launches it made to its thread's path.  Each block's
            # tensor session is kept for its fallback count.
            calls = {"mcs": 0, "validator": 0}
            by_path = {"mcs": 0, "validator": 0}
            path = threading.local()
            sessions = []

            def counted(name, fn):
                def call(items):
                    calls[name] += 1
                    path.name = name
                    try:
                        return fn(items)
                    finally:
                        path.name = None
                return call
            verifier.verify_many = counted("mcs", verifier.verify_many)
            verifier.verify_many_fused_async = counted(
                "validator", verifier.verify_many_fused_async)
            ladder = p256_cuda.ladder

            def tagged_ladder(*args, **kw):
                # the verifier's enqueue lock keeps ladder calls apart
                before = sum(p256_cuda.counts().values())
                out = ladder(*args, **kw)
                key = getattr(path, "name", None) or "untagged"
                by_path[key] = by_path.get(key, 0) \
                    + sum(p256_cuda.counts().values()) - before
                return out
            commit_staged = net.channel.commit_staged

            def keep_session(staged):
                sessions.append(staged.session)
                return commit_staged(staged)
            net.channel.commit_staged = keep_session

            rejected = 0

            def feed():
                nonlocal rejected, ingress_s
                for env, ok in submits:
                    try:
                        net.broadcast.submit(env)
                    except BroadcastError:
                        if ok:
                            raise
                        rejected += 1
                        continue
                    if not ok:
                        raise AssertionError("Broadcast accepted a tampered "
                                             "creator signature")
                ingress_s = time.perf_counter() - t0
            ingress_s = 0.0
            p256_cuda.ladder = tagged_ladder
            try:
                p256_cuda.reset_counts()
                tensorpolicy.reset_counts()
                t0 = time.perf_counter()
                client, _committed, span_s = e2e.commit_until(
                    net, n_tx, E2E_TIMEOUT_S, feed=feed,
                    idle_timeout_s=E2E_TIMEOUT_S)
            finally:
                p256_cuda.ladder = ladder
            counts = p256_cuda.counts()
            passes = tensorpolicy.counts()

            # every block full, every flag the construction's
            if net.ledger.height != 1 + n_blocks:
                sizes = [len(net.ledger.get_block_by_number(b).data.data)
                         for b in range(1, net.ledger.height)]
                raise AssertionError(f"ledger height {net.ledger.height}, "
                                     f"expected {1 + n_blocks}; txs per "
                                     f"block {sizes}")
            if rejected != planted:
                raise AssertionError(f"{rejected} envelopes rejected at "
                                     f"ingress, {planted} planted")
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
                if flags != expected[b]:
                    bad = [i for i, (g, w) in enumerate(zip(flags, expected[b]))
                           if g != w][:8]
                    raise AssertionError(f"block {b + 1}: txflags differ "
                                         f"from the construction at {bad}")
                ordered = net.support.store.get_block_by_number(b + 1)
                if oracle.commit_block(ordered, expected[b]) != expected[b]:
                    raise AssertionError(f"oracle ledger changed block "
                                         f"{b + 1}'s flags")
            fp = net.ledger.state_fingerprint()
            oracle_fp = oracle.state_fingerprint()
            oracle.close()
            if fp != oracle_fp:
                raise AssertionError("state fingerprint differs from the "
                                     "construction oracle's")

            # the card: both device paths, a device mask on every block
            proj, mixed = (p256_cuda.KERNELS[False], p256_cuda.KERNELS[True])
            if calls != {"mcs": n_blocks, "validator": n_blocks}:
                raise AssertionError(f"verifier calls {calls}, expected one "
                                     f"MCS and one validator call per block")
            if sum(by_path.values()) != counts[proj] or counts[mixed] != 0 \
                    or by_path["mcs"] < n_blocks \
                    or by_path["validator"] < n_blocks:
                raise AssertionError(f"ladder launches {counts}, by path "
                                     f"{by_path}: expected at least one per "
                                     f"block from the MCS and from the "
                                     f"validator")
            if passes != {dev.type: n_blocks}:
                raise AssertionError(f"policy evaluator passes {passes}, "
                                     f"expected {n_blocks} on {dev.type}")
            if len(sessions) != n_blocks or not all(sessions):
                raise AssertionError("a block was committed without a "
                                     "tensor-policy session")
            fallbacks = sum(s.fallbacks for s in sessions)
            n_valid = sum(f == m.TxValidationCode.VALID for f in flat)
            log(f"e2e: {n_blocks} blocks x {block_txs} txs ordered, "
                f"MCS-verified and committed; txflags == construction "
                f"({n_valid} VALID); {rejected} ingress rejections == "
                f"planted; fingerprint == oracle ({fp[:16]}); "
                f"{n_tx / span_s:.1f} committed tx/s over the "
                f"ordering-and-commit span of {span_s:.2f} s; ingress "
                f"{ingress_s:.2f} s ({len(submits)} submits, "
                f"{ingress_s / len(submits) * 1e3:.2f} ms each); deliver "
                f"client stage {client.stage_secs:.2f} s, await "
                f"{client.await_secs:.2f} s, commit {client.commit_secs:.2f} "
                f"s; MCS {client.mcs_secs / n_blocks * 1e3:.1f} ms per "
                f"block; verifier calls {calls}; ladder launches {counts} "
                f"(by path {by_path}); "
                f"evaluator passes {passes}, fallbacks {fallbacks}")
            first = net.support.store.get_block_by_number(1)
        finally:
            net.close()
    return counts, (material, first, expected[0])


def profile_e2e_block(torch, material, block, expected):
    """torch.profiler over one ordered block on a fresh peer of the same
    network: its MCS check, then its stage and commit (one thread)."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.ops import p256_cuda
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
                before = p256_cuda.counts()
                wall_ms, n_k, busy_ms, top = device_profile(torch, fn)
                ladders = {k: v - before[k]
                           for k, v in p256_cuda.counts().items()}
                log_profile(f"e2e block {block.header.number} {label} "
                            f"({len(block.data.data)} txs; ladder launches "
                            f"{ladders})", wall_ms, n_k, busy_ms, top)
            if got["flags"] != expected:
                raise AssertionError("the profiled block's flags differ "
                                     "from the construction")
        finally:
            net.close()


def phase_idemix(torch, np):
    """The idemix presentation verify on the card (phase 7)."""
    from fabric_mod_tpu_torch.idemix import credential
    from fabric_mod_tpu_torch.idemix import fp256bn as host
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

    # (a) the full-width pairing check
    def check():
        return dev.pairing_check_batch(a_pts, ik.W, neg, ik.g2, lazy=True)
    t0 = time.perf_counter()
    mask_t = check()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
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
    mask_t = check()
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    event_ms = start.elapsed_time(end)
    if not np.array_equal(mask_t.cpu().numpy(), expect):
        raise AssertionError("warm pairing check differs from the construction")
    rng = np.random.default_rng(SEED + 7)
    tampered = np.nonzero(~expect)[0]
    sample = sorted(set(tampered[:2].tolist()) | set(
        rng.choice(IDEMIX_LANES, IDEMIX_SAMPLE - 2, replace=False).tolist()))
    for i in sample:
        want = host.pairing(a_pts[i], ik.W) == host.pairing(abar_pts[i], ik.g2)
        if bool(mask[i]) != want:
            raise AssertionError(f"lane {i}: card {bool(mask[i])}, host "
                                 f"pairings {want}")
    log(f"idemix (a) pairing check at {IDEMIX_LANES} lanes: mask (a CUDA "
        f"tensor) == construction ({int((~expect).sum())} tampered) and == "
        f"host pairings on lanes {sample}; {event_ms:.1f} ms per check by "
        f"CUDA events, {wall_ms:.1f} ms wall (warm; first {first_ms:.1f} ms)")

    # (b) full pairings against the host
    got = dev.pairing_batch(a_pts[:IDEMIX_PAIRINGS], ik.W)
    if got.device.type != "cuda":
        raise AssertionError(f"pairing_batch output on {got.device}")
    for i in range(IDEMIX_PAIRINGS):
        if dev.f12_to_host(got, i) != host.pairing(a_pts[i], ik.W):
            raise AssertionError(f"pairing {i} differs from the host's")
    log(f"idemix (b) {IDEMIX_PAIRINGS} full pairings on the card == host "
        "fp256bn.pairing exactly")

    # (c) batch_verify at bench.py's presentation width
    t0 = time.perf_counter()
    items, want = fixtures.make_presentations(
        world, IDEMIX_PRESENTATIONS, IDEMIX_PLANT_EVERY, seed=SEED)
    sign_s = time.perf_counter() - t0
    before = dev.counts().get("cuda", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = credential.batch_verify(ik, items)
    dev_s = time.perf_counter() - t0
    if dev.counts().get("cuda", 0) != before + 1:
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
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    dev.pairing_check_batch([s.A_prime for s in todo], ik.W,
                            [s.A_bar.neg() for s in todo], ik.g2)
    end.record()
    torch.cuda.synchronize()
    pair_s = time.perf_counter() - t0
    log(f"idemix (c) batch_verify of {IDEMIX_PRESENTATIONS} presentations "
        f"(signed in {sign_s:.1f} s; {len(want) - sum(want)} planted): "
        f"verdicts == expected, first {IDEMIX_HOST_CHECKED} == host path; "
        f"device path {IDEMIX_PRESENTATIONS / dev_s:.2f} presentations/s "
        f"({dev_s * 1e3:.1f} ms), host path "
        f"{IDEMIX_HOST_CHECKED / host_s:.2f} presentations/s; the "
        f"{len(todo)}-lane pairing check alone {pair_s * 1e3:.1f} ms wall "
        f"({start.elapsed_time(end):.1f} ms CUDA events), "
        f"{pair_s / dev_s:.3f} of the device path")

    # (d) bounded profiles of both checks, scaled to a whole check
    profile_pairing_check(torch, ik, a_pts, neg, wall_ms)
    profile_pairing_check(torch, ik, [s.A_prime for s in todo],
                          [s.A_bar.neg() for s in todo], pair_s * 1e3)
    log(f"idemix phase: {time.perf_counter() - t_phase:.1f} s wall; "
        f"pairing passes {dev.counts()}")


def profile_pairing_check(torch, ik, a_pts, b_pts, check_wall_ms):
    """torch.profiler over one of each repeated piece of a pairing check
    (the line precompute, a Miller doubling step, an add step, a
    cyclotomic square, a multiply) and over the rest once, scaled by the
    schedule's static counts: launches, device busy ms and idle share
    per check against the unprofiled check's wall."""
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
            f"device launches, busy {b_ms:.3f} ms, wall {w_ms:.2f} ms each")
        if launches is not None:
            launches += n * n_k
            busy += n * b_ms
    if launches is not None:
        log(f"idemix (d) per {lanes}-lane pairing check (scaled): "
            f"{launches:.0f} device launches, device busy {busy:.1f} ms; "
            f"device idle share {1 - busy / check_wall_ms:.3f} of the "
            f"unprofiled check's {check_wall_ms:.1f} ms wall (profiled "
            f"pieces sum to {wall:.1f} ms)")


def main() -> int:
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

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_many()
    log(f"build: {time.perf_counter() - t0:.1f} s for {list(_build.SOURCES)}")
    for src, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{src}]: {line.strip()}")

    # 3. kernels against their plain versions
    kernels = phase_kernels(torch, np, dev)

    # 4. the verify path
    t0 = time.perf_counter()
    blocks = [fixtures.make_block(b, n_tx=TX_PER_BLOCK,
                                  raw_endorsers=(b == N_BLOCKS - 1))
              for b in range(N_BLOCKS)]
    log(f"fixtures: {N_BLOCKS} blocks signed in "
        f"{time.perf_counter() - t0:.1f} s (pure-python signer)")
    counts = phase_main_path(torch, np, blocks)
    log(f"verify path kernel launches {counts}")

    # 5. the block commit: the main path
    t0 = time.perf_counter()
    world = fixtures.make_commit_world()
    commit_blocks, expected = fixtures.make_commit_blocks(
        world, N_BLOCKS, TX_PER_BLOCK, plant_every=PLANT_EVERY)
    log(f"fixtures: {N_BLOCKS} encoded blocks of {TX_PER_BLOCK} txs signed "
        f"in {time.perf_counter() - t0:.1f} s (pure-python signer)")
    counts = phase_block_commit(torch, np, world, commit_blocks, expected)

    # 8. the end-to-end network: ordered, MCS-verified and committed
    t0 = time.perf_counter()
    e2e_counts, e2e_block = phase_e2e(torch, dev)
    profile_e2e_block(torch, *e2e_block)
    log(f"e2e phase: {time.perf_counter() - t0:.1f} s wall")
    for k in kernels.values():
        k["launches"] = counts[k["name"]] + e2e_counts[k["name"]]

    # 7. the idemix presentation verify
    phase_idemix(torch, np)

    # 6. where a block's time goes (after the counted runs)
    phase_profile(torch, blocks, world, commit_blocks)

    log(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
