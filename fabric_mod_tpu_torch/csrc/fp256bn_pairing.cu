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
//                             `f12_inv` and `f12_frobenius`, three
//                             `_pow_u` (:391), the Devegili-Scott-Dominguez
//                             tail) and the verdict byte; in pairing mode
//                             (one schedule, no product) the canonical
//                             Fp12 words of the pairing
//
// Everything that crosses a kernel's boundary is canonical words, 8 x
// uint32 little-endian a value, in planes of n lanes (lane axis last, so a
// warp's loads of one word are contiguous): the G1 points (S, 2, 8, n); the
// schedules' line constants (S, n_main + 2, 4, 8) as A.a, A.b, B.a, B.b a
// step, the two correction lines last; is_add (n_main,) int32, shared by
// the S schedules; the Miller values (S, 12, 8, n), coefficient
// c = 6h + 2i + j of sum_h sum_i (c_hi0 + c_hi1 i) v^i w^h.  Each kernel
// converts into its own Montgomery domain (R = 2^256, fp256bn_field.cuh) and
// back, so no value of the port's limb layer (Montgomery with R = 2^270)
// ever reaches it.
//
// What bounds them on this card: operations.  A lane of a check is 24,606
// Montgomery products (fp256bn_cuda.products_per_lane counts them; the g++
// build of this file counts them too), each 136 word products = 264 32-bit
// multiply-adds; bytes are under 1 KB a lane.  At 64 multiply-adds per SM
// per clock that is ~0.4 ms for 1024 lanes.  Far more binding is one
// lane's chain of dependent products: 1024 lanes are only 64 Miller loops'
// and 32 final exponentiations' warps of lanes for 132 SMs, too few to hide
// the latency of dependent multiply-adds.  What the design does about it:
//
//  1. Two launches a check instead of ~143k: every intermediate Fp12 stays
//     in the thread (registers and local memory); device memory sees the
//     points, the schedules, one 384-byte Miller value per (lane,
//     schedule) and the verdict.
//  2. The two Miller loops of a lane run in two blocks (blockIdx.y picks
//     the schedule), twice the parallelism of running the pair stacked.
//  3. A lane is a group of kGroup = 3 threads (fp256bn_field.cuh Group):
//     the Fp12 product's three Fp6 products, the square's two and the
//     line multiply's two halves go to different ranks, which meet at a
//     barrier and exchange them through shared memory; everything else
//     (adds, the Frobenius map, the one inversion) runs on every rank.  A
//     square-and-multiply step of |u| is 36 products on one rank's chain
//     instead of 90, a Miller doubling step 41 instead of 80.  Rank r of
//     a block's 32 lanes is warp r, so a warp never diverges and its
//     exchange words are contiguous.
//  4. A block converts its schedule's line constants into the Montgomery
//     domain once, into shared memory (n_main + 2 steps x 4 values x 32
//     bytes = 11.6 KB for 89 + 2 steps); every thread reads the same step
//     at the same time, a broadcast.
//  5. The Fp product and the tower functions are calls (__noinline__ on
//     the card), not inlined copies, so the code a lane runs stays small
//     enough for the instruction cache and ptxas builds it in seconds.
//
// The per-lane code (schedule_to_mont, miller_lane, final_exp_lane) is
// plain C++ under a host compiler (no __CUDACC__; a group's ranks run in
// turn); only the kernels and the launchers need nvcc.

#include "fp256bn_field.cuh"

namespace {

// lanes a block: a warp of them for each rank of their groups
constexpr int kLanes = 32;
// a schedule's line constants: A.a, A.b, B.a, B.b
constexpr int kLineValues = 4;
// the words of an Fp12, and of a schedule step
constexpr int kF12Words = 96;
constexpr int kStepWords = kLineValues * 8;

// --- word planes ---------------------------------------------------------------

// the value whose word k of lane `lane` is base[k * n + lane]
__device__ __forceinline__ Fp load_plane(const uint32_t* base, int n, int lane) {
    Fp r;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.v[k] = base[(size_t)k * n + lane];
    return r;
}

__device__ __forceinline__ void store_plane(uint32_t* base, int n, int lane, const Fp& x) {
#pragma unroll
    for (int k = 0; k < 8; ++k) base[(size_t)k * n + lane] = x.v[k];
}

// canonical Fp12 planes (12, 8, n) -> the Montgomery domain
__device__ BN_NOINLINE Fp12 load_f12(const uint32_t* base, int n, int lane) {
    Fp12 f;
    for (int c = 0; c < 12; ++c)
        f.c[c / 6].c[(c / 2) % 3].c[c % 2] =
            fp_to_mont(load_plane(base + (size_t)c * 8 * n, n, lane));
    return f;
}

// the Montgomery domain -> canonical Fp12 planes (12, 8, n)
__device__ BN_NOINLINE void store_f12(uint32_t* base, int n, int lane, const Fp12& f) {
    for (int c = 0; c < 12; ++c)
        store_plane(base + (size_t)c * 8 * n, n, lane,
                    fp_from_mont(f.c[c / 6].c[(c / 2) % 3].c[c % 2]));
}

// --- the Miller loop -------------------------------------------------------------

// A schedule's canonical line constants (n_steps x 4 values of 8 words)
// into the Montgomery domain; the values rank, rank + stride, ... (a
// block's threads share the work; the host runs rank 0 of stride 1)
__device__ __forceinline__ void schedule_to_mont(const uint32_t* lines, int n_steps, Fp* out,
                                                 int rank, int stride) {
    for (int e = rank; e < n_steps * kLineValues; e += stride) {
        Fp x;
#pragma unroll
        for (int k = 0; k < 8; ++k) x.v[k] = lines[(size_t)e * 8 + k];
        out[e] = fp_to_mont(x);
    }
}

// f * l for step `line` (its A, B in the Montgomery domain): B*xP, 2
// products (every rank), then the sparse line multiply, 42 (split)
__device__ __forceinline__ Fp12 miller_line(Group& g, const Fp12& f, const Fp& xp,
                                            const Fp& yp, const Fp* line) {
    const Fp2 A{{line[0], line[1]}};
    const Fp2 Bxp{{fp_mul(line[2], xp), fp_mul(line[3], xp)}};
    return f12_mul_line(g, f, yp, A, Bxp);
}

// One Miller loop of a lane's group: the lane's canonical point (2, 8, n)
// planes against a schedule of n_main steps and two correction lines
// (lines_m, Montgomery); rank 0 writes the canonical Fp12 (12, 8, n)
// planes.  A lane past n runs on zeros and writes nothing (its group still
// meets its block's barriers).
__device__ void miller_lane(Group& g, int lane, int n, const uint32_t* pts,
                            const Fp* lines_m, const int32_t* is_add, int n_main,
                            uint32_t* out) {
    const bool live = lane < n;
    const Fp xp = live ? fp_to_mont(load_plane(pts, n, lane)) : fp_zero();
    const Fp yp = live ? fp_to_mont(load_plane(pts + 8 * (size_t)n, n, lane)) : fp_zero();
    Fp12 f = f12_one();
    for (int s = 0; s < n_main; ++s) {
        if (!is_add[s]) f = f12_sqr(g, f);
        f = miller_line(g, f, xp, yp, lines_m + kLineValues * s);
    }
    f = f12_conj(f);
    for (int s = n_main; s < n_main + 2; ++s)
        f = miller_line(g, f, xp, yp, lines_m + kLineValues * s);
    if (live && g.rank == 0) store_f12(out, n, lane, f);
}

// --- the final exponentiation ---------------------------------------------------

// f^|u|, square-and-multiply over the bits of |u| from the one (f in the
// cyclotomic subgroup)
__device__ BN_NOINLINE Fp12 pow_abs_u(Group& g, const Fp12& f) {
    Fp12 acc = f12_one();
    for (int bit = 62; bit >= 0; --bit) {
        acc = f12_sqr(g, acc);
        if ((kBnAbsU >> bit) & 1u) acc = f12_mul(g, acc, f);
    }
    return acc;
}

// f^u (u < 0): the conjugate of f^|u|
__device__ __forceinline__ Fp12 pow_u(Group& g, const Fp12& f) {
    return f12_conj(pow_abs_u(g, f));
}

// f^((p^12 - 1)/r): f^(p^6 - 1) then ^(p^2 + 1), then the DSD chain
__device__ BN_NOINLINE Fp12 final_exp(Group& g, Fp12 f) {
    f = f12_mul(g, f12_conj(f), f12_inv(f));
    f = f12_mul(g, f12_frobenius(f12_frobenius(f)), f);
    const Fp12 fu = pow_u(g, f);
    const Fp12 fu2 = pow_u(g, fu);
    const Fp12 fu3 = pow_u(g, fu2);
    const Fp12 fp = f12_frobenius(f);
    const Fp12 fp2 = f12_frobenius(fp);
    const Fp12 fp3 = f12_frobenius(fp2);
    const Fp12 y0 = f12_mul(g, f12_mul(g, fp, fp2), fp3);
    const Fp12 y1 = f12_conj(f);
    const Fp12 y2 = f12_frobenius(f12_frobenius(fu2));
    const Fp12 y3 = f12_conj(f12_frobenius(fu));
    const Fp12 y4 = f12_conj(f12_mul(g, fu, f12_frobenius(fu2)));
    const Fp12 y5 = f12_conj(fu2);
    const Fp12 y6 = f12_conj(f12_mul(g, fu3, f12_frobenius(fu3)));
    Fp12 t0 = f12_mul(g, f12_mul(g, f12_sqr(g, y6), y4), y5);
    Fp12 t1 = f12_mul(g, f12_mul(g, y3, y5), t0);
    t0 = f12_mul(g, t0, y2);
    t1 = f12_sqr(g, f12_mul(g, f12_sqr(g, t1), t0));
    t0 = f12_mul(g, t1, y1);
    t1 = f12_mul(g, t1, y0);
    t0 = f12_sqr(g, t0);
    return f12_mul(g, t0, t1);
}

// Check mode: f holds two schedules' Miller values (2, 12, 8, n); rank 0
// writes ok[lane] = (f_0 * f_1)^((p^12 - 1)/r) == 1.  Pairing mode: f holds
// one; rank 0 writes its final exponentiation's canonical (12, 8, n)
// planes to out.  A lane past n runs on zeros and writes nothing.
__device__ void final_exp_lane(Group& g, int lane, int n, bool check, const uint32_t* f_in,
                               uint8_t* ok, uint32_t* out) {
    const bool live = lane < n;
    Fp12 f = live ? load_f12(f_in, n, lane) : f12_one();
    if (check) f = f12_mul(g, f, live ? load_f12(f_in + (size_t)kF12Words * n, n, lane)
                                      : f12_one());
    f = final_exp(g, f);
    if (!live || g.rank != 0) return;
    if (check)
        ok[lane] = f12_is_one(f) ? 1u : 0u;
    else
        store_f12(out, n, lane, f);
}

}  // namespace

#ifdef __CUDACC__

namespace {

// grid (blocks of kLanes lanes, S schedules), kGroup warps a block (warp r
// holds rank r of the block's lanes); dynamic shared memory: the block's
// schedule in the Montgomery domain
__global__ void __launch_bounds__(kGroup * kLanes) fp256bn_miller_kernel(
        const uint32_t* __restrict__ pts, const uint32_t* __restrict__ lines,
        const int32_t* __restrict__ is_add, int n_main, uint32_t* __restrict__ out, int n) {
    extern __shared__ uint32_t smem[];
    __shared__ uint32_t xch[kXchWords * kLanes];
    Fp* lines_m = reinterpret_cast<Fp*>(smem);
    const int s = blockIdx.y;
    schedule_to_mont(lines + (size_t)s * (n_main + 2) * kStepWords, n_main + 2, lines_m,
                     threadIdx.x, blockDim.x);
    __syncthreads();
    const int slot = threadIdx.x % kLanes;
    Group g{(int)threadIdx.x / kLanes, xch + slot, kLanes, 0};
    miller_lane(g, blockIdx.x * kLanes + slot, n, pts + (size_t)s * 16 * n, lines_m, is_add,
                n_main, out + (size_t)s * kF12Words * n);
}

__global__ void __launch_bounds__(kGroup * kLanes) fp256bn_final_exp_kernel(
        const uint32_t* __restrict__ f, int check, uint8_t* __restrict__ ok,
        uint32_t* __restrict__ out, int n) {
    __shared__ uint32_t xch[kXchWords * kLanes];
    const int slot = threadIdx.x % kLanes;
    Group g{(int)threadIdx.x / kLanes, xch + slot, kLanes, 0};
    final_exp_lane(g, blockIdx.x * kLanes + slot, n, check != 0, f, ok, out);
}

}  // namespace

// Launch the Miller loops on `stream`: pts (S, 2, 8, n) and lines (S,
// n_main + 2, 4, 8) canonical words, is_add (n_main,) int32; out (S, 12, 8,
// n) canonical words.  Returns the launch's cudaError_t.
extern "C" int fp256bn_miller_launch(const void* pts, const void* lines, const void* is_add,
                                     int n_main, void* out, int n, int n_sched, void* stream) {
    if (n <= 0) return 0;
    const size_t smem = (size_t)(n_main + 2) * kLineValues * sizeof(Fp);
    const dim3 grid((n + kLanes - 1) / kLanes, n_sched);
    fp256bn_miller_kernel<<<grid, kGroup * kLanes, smem,
                            reinterpret_cast<cudaStream_t>(stream)>>>(
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
    fp256bn_final_exp_kernel<<<(n + kLanes - 1) / kLanes, kGroup * kLanes, 0,
                               reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(f), check, static_cast<uint8_t*>(ok),
        static_cast<uint32_t*>(out), n);
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
