// The idemix pairing check, written by hand for Hopper (sm_90a).  Two
// kernels replace the device program of fabric_mod_tpu/ops/fp256bn_dev.py
// that the JAX package jits whole as `_check_fn` (:440) around
// `pairing_check_batch` (:483), and that the port's plain version runs as
// ~143k torch ops a check:
//
//   fp256bn_miller_kernel     replaces `miller_batch` (:339): one Miller
//                             loop of the optimal-ate pairing for each
//                             (lane, schedule) against the G2 point's
//                             static line schedule (`_build_schedule`
//                             :290): per step the Fp12 square (not on an
//                             add step) and the sparse line multiply, then
//                             the conjugation (6u + 2 < 0) and the two
//                             Frobenius correction lines
//   fp256bn_final_exp_kernel  replaces `final_exp_batch` (:397), `f12_mul`
//                             (:179) and `f12_is_one` (:247): in check
//                             mode the product of a lane's two Miller
//                             values, f^((p^12 - 1)/r) (the easy part with
//                             the Fp12 inverse and Frobenius maps, three
//                             powers of |u| (`_pow_u` :391), the
//                             Devegili-Scott-Dominguez tail) and the
//                             verdict byte; in pairing mode (one schedule,
//                             no product) the canonical Fp12 words of the
//                             pairing
//
// Everything that crosses a kernel's boundary is canonical words, 8 x
// uint32 little-endian a value, in planes of n lanes (lane axis last): the
// G1 points (S, 2, 8, n); the schedules' line constants (S, n_main + 2, 4,
// 8) as A.a, A.b, B.a, B.b a step, the two correction lines last; is_add
// (n_main,) int32, shared by the S schedules; the Miller values (S, 12, 8,
// n), coefficient c = 6h + 2i + j of sum_h sum_i (c_hi0 + c_hi1 i) v^i w^h.
// Each kernel converts into its own Montgomery domain (R = 2^256,
// fp256bn_field.cuh) and back, so no value of the port's limb layer
// (Montgomery with R = 2^270) ever reaches it.
//
// What bounds them on this card: operations.  A lane of a check is 24,606
// Montgomery products in the reference's formulas (products_per_lane in
// ops/fp256bn_cuda.py, the bound's count), each 264 32-bit multiply-adds;
// bytes are under 1 KB a lane.  At 64 multiply-adds per SM per clock that
// is ~0.4 ms for 1024 lanes.  Far more binding is one lane's chain of
// dependent products, and too few lanes to hide it.  The design:
//
//  1. The product of carry chains (fp256bn_field.cuh), inlined once: the
//     interpreter's is the only one in the code.  One product's chain is
//     ~900 cycles on one warp.
//  2. A lane is a group of kGroup = 16 adjacent threads of one warp.  Each
//     Fp12 operation is a program (fp256bn_programs.cuh, generated by
//     ops/fp256bn_programs.py from the tower formulas): stages of
//     independent Fp products whose operands are linear forms over the
//     operation's inputs, its earlier products and the constants, then
//     the outputs as linear forms over the products.  Rank g runs items
//     g, g + 16, ... of a stage, and the group meets at __syncwarp, so the
//     Fp12 product is 4 rounds of up to 16 products, the square 3, the
//     line multiply 3, the Frobenius map 1, the cyclotomic square 2, each
//     then one round of output sums.  A form's terms load four at a time
//     and add into one accumulator with no reduction, reduced once; a
//     term finds its argument through the lane's argument table, which
//     each program call writes.  (Groups of 8 ran the 1024-lane check
//     ~1.5x slower, too few warps; groups of 32 ~1.15x slower, more idle
//     ranks in a round; `scripts/torch_pairing_ab.py` on copies.)
//  3. A lane's values live in shared memory: its Fp12 variables and its
//     program's products, 32-byte slots read and written as uint4.  A
//     thread holds one product's operands in registers, so nothing is
//     indexed in local memory.
//  4. A block is 4 lanes, 64 threads, so a 1024-lane check runs 512
//     Miller blocks (the two schedules in separate blocks) and 256 final
//     exponentiation blocks on all 132 SMs.  A block copies the programs'
//     tables and the constants into its shared memory, and the Miller
//     kernel its schedule's A values into the Montgomery domain, then
//     meets once at __syncthreads; from there on a lane's threads meet
//     only at their warp's __syncwarp.  A Miller lane takes the products
//     B x_P of all its steps up front (a canonical B times x_P R^2 gives
//     B x_P R), 12 rounds.
//  5. The hard part squares with Granger-Scott's cyclotomic square (18
//     products, against the generic square's 36): every value there is
//     in the cyclotomic subgroup, or 0, where both give 0.  |u|'s powers
//     start from f at its top bit.  The one inverse (of the easy part) is
//     by divsteps (divsteps.cuh) instead of ~410 products in series.
//
// No thread leaves early: lanes past n run on zeros and store nothing, so
// every thread of a warp reaches every __syncwarp.  The per-lane code is
// plain C++ under a host compiler (no __CUDACC__): a group's ranks run in
// turn (FOR_MY_RANKS), and the tests build it with g++ and hold it against
// the JAX reference.  Only the kernels and the launchers need nvcc.

#include "fp256bn_field.cuh"
#include "fp256bn_programs.cuh"

namespace {

// kGroup, the threads a lane, comes with the programs from the generator
// (fp256bn_programs.G), whose round counts rest on it.
// lanes a block, and its threads
constexpr int kLanes = 4;
constexpr int kThreads = kLanes * kGroup;
// a schedule's line constants (A.a, A.b, B.a, B.b), an Fp12's and a
// step's words
constexpr int kLineValues = 4;
constexpr int kF12Words = 96;
constexpr int kStepWords = kLineValues * 8;
static_assert(32 % kGroup == 0, "a group never straddles two warps");

#ifdef __CUDACC__
#define BN_NOINLINE __noinline__
#define BN_HOST_DEVICE __host__ __device__
#else
#define BN_NOINLINE
#define BN_HOST_DEVICE
#endif

#ifndef __CUDACC__
// product rounds run (the tests count a lane's)
unsigned long long bn_rounds = 0;
#endif

#ifdef __CUDA_ARCH__
#define FOR_MY_RANKS(ln, g) \
    for (int g = (ln).rank, g##_once = 1; g##_once; g##_once = 0)
__device__ __forceinline__ void group_sync() { __syncwarp(); }
#else
#define FOR_MY_RANKS(ln, g) for (int g = 0; g < kGroup; ++g)
__device__ __forceinline__ void group_sync() {}
#endif

// --- A block's shared memory, in 32-bit words ----------------------------------

// the programs' tables as 16-bit words, rounded to whole 16-byte units
constexpr int kTabHalves = 2 * kBnPrograms + 3 * kBnStages + 3 * kBnItems + kBnTerms;
constexpr int kTabWords = ((kTabHalves + 1) / 2 + 3) / 4 * 4;
constexpr int kConstOff = kTabWords;
constexpr int kBlockHeadWords = kConstOff + kBnConsts * 8;

// A lane's thread: its rank, the block's shared memory (the tables at
// word 0), and the word offset of the lane's own area: the argument table
// of the program it runs (kArgWords words: the word offsets of its output,
// its inputs x, y, z, w, its products and the constants, in a term's
// argument order), then the program's product slots
struct Lane {
    int rank;               // this thread's place in the group
    uint32_t* sm;           // the block's shared memory (a host array)
    uint32_t area;
};
constexpr int kArgWords = 8;

__device__ __forceinline__ Fp fp_ld(const uint32_t* src) {
    const uint4 lo = reinterpret_cast<const uint4*>(src)[0];
    const uint4 hi = reinterpret_cast<const uint4*>(src)[1];
    Fp r;
    r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
    r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
    return r;
}

__device__ __forceinline__ void fp_st(uint32_t* dst, const Fp& f) {
    uint4 lo, hi;
    lo.x = f.v[0]; lo.y = f.v[1]; lo.z = f.v[2]; lo.w = f.v[3];
    hi.x = f.v[4]; hi.y = f.v[5]; hi.z = f.v[6]; hi.w = f.v[7];
    reinterpret_cast<uint4*>(dst)[0] = lo;
    reinterpret_cast<uint4*>(dst)[1] = hi;
}

// the word offset of a term's slot (its low 12 bits: argument, index)
__device__ __forceinline__ uint32_t slot(const Lane& ln, uint32_t term) {
    return ln.sm[ln.area + ((term >> 9) & 7u)] + 8u * (term & 511u);
}

// A linear form's value: its n terms' values, each added |c| times (a
// negative coefficient adds the complement), one reduction.  Four terms
// at a time: their slots' loads are independent, so their latencies
// overlap; a term past n adds the zero constant.
__device__ __forceinline__ Fp eval_form(const Lane& ln, const uint16_t* t, int n) {
    if (n == 1 && (t[0] >> 12) == 1u) return fp_ld(ln.sm + slot(ln, t[0]));
    Acc acc = acc_zero();
#pragma unroll 1
    for (int i = 0; i < n; i += 4) {
        uint32_t term[4];
        Fp x[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) term[j] = i + j < n ? t[i + j] : kBnZeroTerm;
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = fp_ld(ln.sm + slot(ln, term[j]));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = (int32_t)(term[j] << 16) >> 28;
            const uint32_t s = c < 0 ? 0xFFFFFFFFu : 0u;
            const int k = c < 0 ? -c : c;
            acc_add(acc, x[j], s);
#pragma unroll 1
            for (int r = 1; r < k; ++r) acc_add(acc, x[j], s);
        }
    }
    return acc_reduce(acc);
}

// One program on the Fp12 (or smaller) variables at word offsets d (the
// output), x, y, z, w: rank 0 writes the lane's argument table, then the
// program's stages in turn, rank g taking items g, g + kGroup, ... of
// each, the group meeting after each.  The output may be the same
// variable as x (the generator checks that the outputs read x only at
// their own index, after every product).
__device__ BN_NOINLINE void run(Lane ln, int prog, uint32_t d, uint32_t x, uint32_t y = 0,
                                uint32_t z = 0, uint32_t w = 0) {
    FOR_MY_RANKS(ln, g) {
        if (g == 0) {
            uint32_t* at = ln.sm + ln.area;
            at[0] = d;
            at[1] = x;
            at[2] = y;
            at[3] = z;
            at[4] = w;
            at[5] = ln.area + kArgWords;
            at[6] = kConstOff;
        }
    }
    group_sync();
    const uint16_t* tab = reinterpret_cast<const uint16_t*>(ln.sm);
    const BnProgram* progs = reinterpret_cast<const BnProgram*>(tab);
    const BnStage* stages = reinterpret_cast<const BnStage*>(tab + 2 * kBnPrograms);
    const BnItem* items = reinterpret_cast<const BnItem*>(tab + 2 * kBnPrograms + 3 * kBnStages);
    const uint16_t* terms = tab + 2 * kBnPrograms + 3 * kBnStages + 3 * kBnItems;
    const BnProgram p = progs[prog];
#pragma unroll 1
    for (int s = p.first; s < p.first + p.count; ++s) {
        const BnStage st = stages[s];
        FOR_MY_RANKS(ln, g) {
#pragma unroll 1
            for (int i = g; i < st.count; i += kGroup) {
                const BnItem it = items[st.first + i];
                const uint16_t* t = terms + it.first;
                const int na = it.n & 255, nb = it.n >> 8;
                Fp r = eval_form(ln, t, na);
                if (st.kind == kBnMul)
                    r = fp_mul(r, eval_form(ln, t + na, nb));
                else if (st.kind == kBnSqr)
                    r = fp_sqr(r);
                else if (st.kind == kBnInv)
                    r = fp_inv(r);
                fp_st(ln.sm + slot(ln, it.dst), r);
            }
        }
#ifndef __CUDACC__
        if (st.kind == kBnMul || st.kind == kBnSqr) bn_rounds += (st.count + kGroup - 1) / kGroup;
#endif
        group_sync();
    }
}

// The block's head: the tables and the constants, threads tid, tid +
// nthreads, ... (the host runs tid 0 of 1)
__device__ __forceinline__ void block_head(uint32_t* sm, int tid, int nthreads) {
    uint16_t* tab = reinterpret_cast<uint16_t*>(sm);
    const uint16_t* parts[4] = {reinterpret_cast<const uint16_t*>(kBnProgramTable),
                                reinterpret_cast<const uint16_t*>(kBnStageTable),
                                reinterpret_cast<const uint16_t*>(kBnItemTable), kBnTermTable};
    const int sizes[4] = {2 * kBnPrograms, 3 * kBnStages, 3 * kBnItems, kBnTerms};
    int off = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        for (int i = tid; i < sizes[q]; i += nthreads) tab[off + i] = parts[q][i];
        off += sizes[q];
    }
    for (int i = tid; i < kBnConsts * 8; i += nthreads)
        sm[kConstOff + i] = (&kBnConstWords[0][0])[i];
}

__device__ __forceinline__ Lane make_lane(uint32_t* sm, int rank, uint32_t area) {
    Lane ln;
    ln.rank = rank;
    ln.sm = sm;
    ln.area = area;
    return ln;
}

// --- word planes -------------------------------------------------------------------

// the lane's canonical Fp12 planes (12, 8, n) into the slots at `dst`,
// word w by rank w % kGroup (zeros past n)
__device__ __forceinline__ void load_f12(const Lane& ln, uint32_t dst, const uint32_t* base,
                                         int n, int lane, bool live) {
    FOR_MY_RANKS(ln, g) {
        for (int w = g; w < kF12Words; w += kGroup)
            ln.sm[dst + w] = live ? base[(size_t)w * n + lane] : 0u;
    }
}

__device__ __forceinline__ void store_f12(const Lane& ln, uint32_t src, uint32_t* base, int n,
                                          int lane) {
    FOR_MY_RANKS(ln, g) {
        for (int w = g; w < kF12Words; w += kGroup) base[(size_t)w * n + lane] = ln.sm[src + w];
    }
}

// --- the Miller loop ---------------------------------------------------------------

// the Miller block's layout: the head, the schedule's A values (n_steps x
// 2 slots, Montgomery), then kLanes lanes of: the argument table and the
// program's products, f, the point (x, y, x R^2) and the steps' B x_P
// (n_steps x 2 slots)
struct MillerLayout {
    uint32_t amont, lane0, lane_words, f, pt, bxp;
    BN_HOST_DEVICE explicit MillerLayout(int n_steps) {
        amont = kBlockHeadWords;
        lane0 = amont + (uint32_t)n_steps * 16;
        f = kArgWords + kBnMillerTemps * 8;
        pt = f + kF12Words;
        bxp = pt + 3 * 8;
        lane_words = bxp + (uint32_t)n_steps * 16;
    }
    BN_HOST_DEVICE uint32_t lane(int slot) const {
        return lane0 + (uint32_t)slot * lane_words;
    }
    BN_HOST_DEVICE size_t bytes(int lanes) const {
        return 4 * ((size_t)lane0 + (size_t)lanes * lane_words);
    }
};

// A schedule's A values (canonical words in `lines`) into the Montgomery
// domain: values tid, tid + nthreads, ...
__device__ __forceinline__ void schedule_a_to_mont(uint32_t* sm, const MillerLayout& L,
                                                   const uint32_t* lines, int n_steps, int tid,
                                                   int nthreads) {
    const Fp r2 = fp_load_const(kBnR2);
    for (int e = tid; e < 2 * n_steps; e += nthreads) {
        const uint32_t* src = lines + (size_t)(e >> 1) * kStepWords + (e & 1) * 8;
        Fp x;
#pragma unroll
        for (int k = 0; k < 8; ++k) x.v[k] = src[k];
        fp_st(sm + L.amont + 8 * e, fp_mul(x, r2));
    }
}

// One Miller loop of a lane's group: the lane's canonical point (2, 8, n)
// planes against a schedule of n_main steps and two correction lines
// (`lines` canonical, the block's A values already in the Montgomery
// domain); the canonical Fp12 (12, 8, n) planes out.  A lane past n runs
// on zeros and writes nothing.
__device__ void miller_lane(const Lane& ln, const MillerLayout& L, uint32_t base, int lane,
                            int n, const uint32_t* pts, const uint32_t* lines,
                            const int32_t* is_add, int n_main, uint32_t* out) {
    const bool live = lane < n;
    const int n_steps = n_main + 2;
    const uint32_t f = base + L.f, pt = base + L.pt, bxp = base + L.bxp;
    FOR_MY_RANKS(ln, g) {
        for (int w = g; w < 16; w += kGroup)
            ln.sm[pt + w] = live ? pts[(size_t)w * n + lane] : 0u;
    }
    group_sync();
    run(ln, kProgG1ToMont, pt, pt);
    // B x_P for every step: a canonical B times x_P R^2
    FOR_MY_RANKS(ln, g) {
        const Fp x2 = fp_ld(ln.sm + pt + 16);
        for (int e = g; e < 2 * n_steps; e += kGroup) {
            const uint32_t* src = lines + (size_t)(e >> 1) * kStepWords + (2 + (e & 1)) * 8;
            Fp b;
#pragma unroll
            for (int k = 0; k < 8; ++k) b.v[k] = src[k];
            fp_st(ln.sm + bxp + 8 * e, fp_mul(b, x2));
        }
        for (int c = g; c < 12; c += kGroup)
            fp_st(ln.sm + f + 8 * c, c == 0 ? fp_load_const(kBnOneM) : fp_zero());
    }
#ifndef __CUDACC__
    bn_rounds += (2 * n_steps + kGroup - 1) / kGroup;
#endif
    group_sync();
    // the first step squares f = 1: skipped
#pragma unroll 1
    for (int s = 0; s < n_steps; ++s) {
        if (s == n_main) run(ln, kProgF12Conj, f, f);      // 6u + 2 < 0
        if (s > 0 && s < n_main && !is_add[s]) run(ln, kProgF12Sqr, f, f);
        run(ln, kProgF12MulLine, f, f, pt + 8, L.amont + 16 * s, bxp + 16 * s);
    }
    run(ln, kProgF12FromMont, f, f);
    if (live) store_f12(ln, f, out, n, lane);
}

// --- the final exponentiation ------------------------------------------------------

// The final exponentiation's lane: kFinalVars Fp12 variables after the
// argument table and the program's products
constexpr int kFinalVars = 11;
constexpr uint32_t kFinalVarsOff = kArgWords + kBnFinalExpTemps * 8;
constexpr uint32_t kFinalLaneWords = kFinalVarsOff + kFinalVars * kF12Words;
constexpr size_t kFinalBlockBytes = 4 * ((size_t)kBlockHeadWords + kLanes * kFinalLaneWords);

// f^|u| into `out` (not f), square-and-multiply from f at |u|'s top bit
// (f in the cyclotomic subgroup), then conjugated: f^u (u < 0)
__device__ __forceinline__ void pow_u(const Lane& ln, uint32_t out, uint32_t f) {
#pragma unroll 1
    for (int bit = 61; bit >= 0; --bit) {
        run(ln, kProgF12CyclotomicSqr, out, bit == 61 ? f : out);
        if ((kBnAbsU >> bit) & 1u) run(ln, kProgF12Mul, out, out, f);
    }
    run(ln, kProgF12Conj, out, out);
}

// Check mode: f_in holds two schedules' Miller values (2, 12, 8, n); ok[lane]
// = (f_0 * f_1)^((p^12 - 1)/r) == 1.  Pairing mode: f_in holds one; its
// final exponentiation's canonical (12, 8, n) planes go to out.  A lane
// past n runs on zeros and writes nothing.
__device__ void final_exp_lane(const Lane& ln, uint32_t base, int lane, int n, bool check,
                               const uint32_t* f_in, uint8_t* ok, uint32_t* out) {
    const bool live = lane < n;
    uint32_t v[kFinalVars];
#pragma unroll
    for (int i = 0; i < kFinalVars; ++i) v[i] = base + kFinalVarsOff + i * kF12Words;
    const uint32_t F = v[0], A = v[1], FU = v[2], FU2 = v[3], FU3 = v[4], B = v[5], Y0 = v[6],
                   Y2 = v[7], Y3 = v[8], Y4 = v[9], Y6 = v[10];
    load_f12(ln, F, f_in, n, lane, live);
    if (check) load_f12(ln, A, f_in + (size_t)kF12Words * n, n, lane, live);
    group_sync();
    run(ln, kProgF12ToMont, F, F);
    if (check) {
        run(ln, kProgF12ToMont, A, A);
        run(ln, kProgF12Mul, F, F, A);
    }
    // the easy part: f^(p^6 - 1) = conj(f) f^-1, then f^(p^2 + 1)
    run(ln, kProgF12Inv, A, F);
    run(ln, kProgF12Conj, F, F);
    run(ln, kProgF12Mul, F, F, A);
    run(ln, kProgF12Frobenius, A, F);
    run(ln, kProgF12Frobenius, A, A);
    run(ln, kProgF12Mul, F, F, A);
    // the hard part (Devegili-Scott-Dominguez)
    pow_u(ln, FU, F);
    pow_u(ln, FU2, FU);
    pow_u(ln, FU3, FU2);
    run(ln, kProgF12Frobenius, A, F);          // y0 = f^p f^(p^2) f^(p^3)
    run(ln, kProgF12Frobenius, B, A);
    run(ln, kProgF12Mul, A, A, B);
    run(ln, kProgF12Frobenius, B, B);
    run(ln, kProgF12Mul, Y0, A, B);
    run(ln, kProgF12Conj, F, F);               // y1 = conj(f)
    run(ln, kProgF12Frobenius, Y2, FU2);       // y2 = fu2^(p^2)
    run(ln, kProgF12Frobenius, Y2, Y2);
    run(ln, kProgF12Frobenius, Y3, FU);        // y3 = conj(fu^p)
    run(ln, kProgF12Conj, Y3, Y3);
    run(ln, kProgF12Frobenius, Y4, FU2);       // y4 = conj(fu fu2^p)
    run(ln, kProgF12Mul, Y4, Y4, FU);
    run(ln, kProgF12Conj, Y4, Y4);
    run(ln, kProgF12Conj, FU2, FU2);           // y5 = conj(fu2)
    run(ln, kProgF12Frobenius, Y6, FU3);       // y6 = conj(fu3 fu3^p)
    run(ln, kProgF12Mul, Y6, Y6, FU3);
    run(ln, kProgF12Conj, Y6, Y6);
    const uint32_t T0 = A, T1 = B, Y1 = F, Y5 = FU2, OUT = FU;
    run(ln, kProgF12CyclotomicSqr, T0, Y6);    // t0 = y6^2 y4 y5
    run(ln, kProgF12Mul, T0, T0, Y4);
    run(ln, kProgF12Mul, T0, T0, Y5);
    run(ln, kProgF12Mul, T1, Y3, Y5);          // t1 = y3 y5 t0
    run(ln, kProgF12Mul, T1, T1, T0);
    run(ln, kProgF12Mul, T0, T0, Y2);          // t0 = t0 y2
    run(ln, kProgF12CyclotomicSqr, T1, T1);    // t1 = (t1^2 t0)^2
    run(ln, kProgF12Mul, T1, T1, T0);
    run(ln, kProgF12CyclotomicSqr, T1, T1);
    run(ln, kProgF12Mul, T0, T1, Y1);          // t0 = t1 y1
    run(ln, kProgF12Mul, T1, T1, Y0);          // t1 = t1 y0
    run(ln, kProgF12CyclotomicSqr, T0, T0);    // t0 = t0^2
    run(ln, kProgF12Mul, OUT, T0, T1);
    if (check) {
        // OUT == 1: the Montgomery one in coefficient 0, zero elsewhere
        // (every value is fully reduced, so this compares words)
        if (live && ln.rank == 0) {
            uint32_t d = 0u;
            for (int w = 0; w < kF12Words; ++w)
                d |= ln.sm[OUT + w] ^ (w < 8 ? kBnOneM[w] : 0u);
            ok[lane] = d == 0u ? 1u : 0u;
        }
        return;
    }
    run(ln, kProgF12FromMont, OUT, OUT);
    if (live) store_f12(ln, OUT, out, n, lane);
}

}  // namespace

#ifdef __CUDACC__

namespace {

// grid (blocks of kLanes lanes, S schedules), kThreads threads a block;
// dynamic shared memory: MillerLayout
__global__ void __launch_bounds__(kThreads) fp256bn_miller_kernel(
        const uint32_t* __restrict__ pts, const uint32_t* __restrict__ lines,
        const int32_t* __restrict__ is_add, int n_main, uint32_t* __restrict__ out, int n) {
    extern __shared__ uint4 smem[];
    uint32_t* sm = reinterpret_cast<uint32_t*>(smem);
    const int s = blockIdx.y, n_steps = n_main + 2;
    const MillerLayout L(n_steps);
    const uint32_t* sched = lines + (size_t)s * n_steps * kStepWords;
    block_head(sm, threadIdx.x, kThreads);
    schedule_a_to_mont(sm, L, sched, n_steps, threadIdx.x, kThreads);
    __syncthreads();              // once: the lanes' barriers are their warps'
    const int slot = threadIdx.x / kGroup;
    const uint32_t base = L.lane(slot);
    const Lane ln = make_lane(sm, threadIdx.x % kGroup, base);
    miller_lane(ln, L, base, blockIdx.x * kLanes + slot, n, pts + (size_t)s * 16 * n, sched,
                is_add, n_main, out + (size_t)s * kF12Words * n);
}

__global__ void __launch_bounds__(kThreads) fp256bn_final_exp_kernel(
        const uint32_t* __restrict__ f, int check, uint8_t* __restrict__ ok,
        uint32_t* __restrict__ out, int n) {
    extern __shared__ uint4 smem[];
    uint32_t* sm = reinterpret_cast<uint32_t*>(smem);
    block_head(sm, threadIdx.x, kThreads);
    __syncthreads();
    const int slot = threadIdx.x / kGroup;
    const uint32_t base = kBlockHeadWords + slot * kFinalLaneWords;
    const Lane ln = make_lane(sm, threadIdx.x % kGroup, base);
    final_exp_lane(ln, base, blockIdx.x * kLanes + slot, n, check != 0, f, ok, out);
}

// dynamic shared memory above 48 KB needs the kernel's consent
int allow_smem(const void* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

}  // namespace

// Launch the Miller loops on `stream`: pts (S, 2, 8, n) and lines (S,
// n_main + 2, 4, 8) canonical words, is_add (n_main,) int32; out (S, 12, 8,
// n) canonical words.  Returns the launch's cudaError_t.
extern "C" int fp256bn_miller_launch(const void* pts, const void* lines, const void* is_add,
                                     int n_main, void* out, int n, int n_sched, void* stream) {
    if (n <= 0) return 0;
    const size_t smem = MillerLayout(n_main + 2).bytes(kLanes);
    const int err = allow_smem((const void*)fp256bn_miller_kernel, smem);
    if (err) return err;
    const dim3 grid((n + kLanes - 1) / kLanes, n_sched);
    fp256bn_miller_kernel<<<grid, kThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(pts), static_cast<const uint32_t*>(lines),
        static_cast<const int32_t*>(is_add), n_main, static_cast<uint32_t*>(out), n);
    return static_cast<int>(cudaGetLastError());
}

// Launch the final exponentiation on `stream`: f (2, 12, 8, n) in check
// mode (ok: (n,) bytes out), (1, 12, 8, n) in pairing mode (out: (12, 8, n)
// canonical words).  Returns the launch's cudaError_t.
extern "C" int fp256bn_final_exp_launch(const void* f, int check, void* ok, void* out, int n,
                                        void* stream) {
    if (n <= 0) return 0;
    const int err = allow_smem((const void*)fp256bn_final_exp_kernel, kFinalBlockBytes);
    if (err) return err;
    fp256bn_final_exp_kernel<<<(n + kLanes - 1) / kLanes, kThreads, kFinalBlockBytes,
                               reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(f), check, static_cast<uint8_t*>(ok),
        static_cast<uint32_t*>(out), n);
    return static_cast<int>(cudaGetLastError());
}

// The kernels' geometry for reports: threads a lane, lanes a block, and
// for each kernel its dynamic shared memory a block (the Miller kernel's
// at n_main main steps) and the blocks an SM can hold at once.
extern "C" int fp256bn_pairing_geometry(int n_main, int* group, int* lanes, int* miller_smem,
                                        int* miller_blocks_per_sm, int* final_smem,
                                        int* final_blocks_per_sm) {
    *group = kGroup;
    *lanes = kLanes;
    *miller_smem = (int)MillerLayout(n_main + 2).bytes(kLanes);
    *final_smem = (int)kFinalBlockBytes;
    int err = allow_smem((const void*)fp256bn_miller_kernel, *miller_smem);
    if (!err) err = allow_smem((const void*)fp256bn_final_exp_kernel, *final_smem);
    if (!err)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            miller_blocks_per_sm, fp256bn_miller_kernel, kThreads, *miller_smem);
    if (!err)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            final_blocks_per_sm, fp256bn_final_exp_kernel, kThreads, *final_smem);
    return err;
}

#endif  // __CUDACC__
