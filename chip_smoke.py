#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's block-commit path once on one CUDA card.

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
6. profile — torch.profiler over one verify of each block kind and over
   one whole block commit: wall time, device busy time and idle share,
   the heaviest device kernels; and over the policy evaluator's pass
   alone: its launches and device time per block.

It prints one JSON line describing each kernel (`launches` counts the
block-commit phase), and as its last line
{"ok": true, "device": {...}}.  Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

LANES = 2048
N_BLOCKS = 4
TX_PER_BLOCK = 1000
SAMPLE = 256
SEED = 20261016
# block-commit phase: a planted invalid tx of each kind every 50 txs
PLANT_EVERY = 50

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
    for k in kernels.values():
        k["launches"] = counts[k["name"]]

    # 6. where a block's time goes (after the counted runs)
    phase_profile(torch, blocks, world, commit_blocks)

    log(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
