// The windowed Shamir ladder u1*G + u2*Q of batched ECDSA-P256 verify,
// written by hand for Hopper (sm_90a).  Two kernels:
//
//   ladder_projective_kernel  replaces fabric_mod_tpu/ops/p256_pallas.py
//                             _ladder_kernel (via pallas_ladder)
//   ladder_mixed_kernel       replaces fabric_mod_tpu/ops/p256_pallas.py
//                             _ladder_kernel_mixed (via pallas_ladder_mixed)
//
// What they compute: u1*G + u2*Q by the RCB complete formulas (eprint
// 2015/1060 algorithms 4, 5, 6) over the Q-table schedule of
// ops/p256.build_q_table (7 doublings + 7 additions) and, for the mixed
// kernel, the window-0 normalisation (the p-2 addition chain of
// inv_mont_p_chain inside Montgomery's simultaneous inversion).  Each
// formula returns the same field values X3, Y3, Z3 as ops/p256.py; only
// the grouping of its multiplies and adds differs (below).  So X, Y, Z
// equal the plain ladders' exactly, although the limb representation
// differs.
//
// What bounds them on this card.  A verify's ladder is about 5.3k field
// multiplies against a few hundred bytes per lane: operations, never
// bytes.  At the main path's width (2048 lanes a call) there are too few
// lanes for one thread per lane to fill the card: the time is one lane's
// chain of field operations.  The design shortens that chain and spreads
// it over threads:
//
//  1. A field product made for P-256 (p256_field.cuh, shared with the
//     verify core's prologue and epilogue): carry chains of 64-bit
//     multiply-adds, a dedicated square, and a multiply-free reduction.
//  2. Several threads per lane.  A lane is a group of kGroup (8) adjacent
//     threads of one warp.  Each formula runs as three rounds of up to 8
//     independent multiplies (point_double {6, 8, 5}, point_add {8, 6, 6},
//     point_add_mixed {8, 4, 6}); thread g computes multiply g of a round,
//     and the products meet in a per-lane exchange area in shared memory
//     behind one __syncwarp.  A round of 8 costs what one multiply costs,
//     so the formulas' small constant factors (their doublings, triplings
//     and b) ride along as multiplies by constants, which removes most of
//     the adds and subtracts between rounds; the rest run in every thread
//     of the group, in lock step, on registers.  A window is 18 rounds
//     where one thread per lane ran 80 multiplies in sequence, and a
//     2048-lane call is 512 warps: about one per scheduler of 132 SMs.
//  3. Tables in shared memory: the per-lane Q table, the mixed kernel's
//     prefix products, inverses and affine table, the G table and the
//     rounds' constant operands.  Nothing is indexed in local memory.
//
// No thread leaves early: lanes past the ragged edge run on a clamped
// lane index and skip only their stores, and the mixed kernel's zero
// windows are a select after an unconditional add, so every thread of a
// warp reaches every __syncwarp.
//
// The point and per-lane code below, like the field code it includes, is
// plain C++ when compiled by a host compiler (no __CUDACC__): the inline
// PTX has a plain C++ twin that computes the same values, and on the host
// one call plays every thread of a group in turn.  Only the kernels and
// the launcher need nvcc.

#include "p256_field.cuh"

namespace {

// threads per lane: a round has at most this many multiplies
constexpr int kGroup = 8;

struct Pt {
    Fe x, y, z;
};

struct Aff {
    Fe x, y;
};

// 3 and 3b in Montgomery form (c * R mod p; b is the curve's b)
__constant__ uint32_t kC3[8] = {
    0x00000003u, 0x00000000u, 0x00000000u, 0xFFFFFFFDu,
    0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFCu, 0x00000002u};
__constant__ uint32_t kC3B[8] = {
    0x7D4E399Fu, 0x89D69E26u, 0x698C91B2u, 0x06D01166u,
    0xE5638C84u, 0xB0E66203u, 0x0D95D89Cu, 0x94901259u};

// The second operands of the rounds that multiply by constants only
// (c * R mod p), one row per multiply: point_double round 2 (rows 0-7),
// point_add round 2 (8-13), point_add_mixed round 2 (14-17).  Each thread
// reads its own row (from a copy in shared memory on the card), which
// needs no select.
constexpr int kConstRows = 18;
constexpr int kRowsDouble = 0, kRowsAdd = 8, kRowsMixed = 14;
__constant__ uint32_t kRoundConsts[kConstRows][8] = {
    {0x7D4E399Fu, 0x89D69E26u, 0x698C91B2u, 0x06D01166u,
     0xE5638C84u, 0xB0E66203u, 0x0D95D89Cu, 0x94901259u},  // 3b
    {0x00000006u, 0x00000000u, 0x00000000u, 0xFFFFFFFAu,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFF9u, 0x00000005u},  // 6
    {0xFA9C733Fu, 0x13AD3C4Cu, 0xD3192365u, 0x0DA022CBu,
     0xCAC71908u, 0x61CCC407u, 0x1B2BB138u, 0x292024B3u},  // 6b
    {0x00000009u, 0x00000000u, 0x00000000u, 0xFFFFFFF7u,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFF6u, 0x00000008u},  // 9
    {0x00000003u, 0x00000000u, 0x00000000u, 0xFFFFFFFDu,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFCu, 0x00000002u},  // 3
    {0x00000003u, 0x00000000u, 0x00000000u, 0xFFFFFFFDu,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFCu, 0x00000002u},  // 3
    {0x00000002u, 0x00000000u, 0x00000000u, 0xFFFFFFFEu,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFDu, 0x00000001u},  // 2
    {0x00000002u, 0x00000000u, 0x00000000u, 0xFFFFFFFEu,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFDu, 0x00000001u},  // 2
    {0x00000003u, 0x00000000u, 0x00000000u, 0xFFFFFFFDu,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFCu, 0x00000002u},  // 3
    {0x7D4E399Fu, 0x89D69E26u, 0x698C91B2u, 0x06D01166u,
     0xE5638C84u, 0xB0E66203u, 0x0D95D89Cu, 0x94901259u},  // 3b
    {0x7D4E399Fu, 0x89D69E26u, 0x698C91B2u, 0x06D01166u,
     0xE5638C84u, 0xB0E66203u, 0x0D95D89Cu, 0x94901259u},  // 3b
    {0x00000009u, 0x00000000u, 0x00000000u, 0xFFFFFFF7u,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFF6u, 0x00000008u},  // 9
    {0x00000003u, 0x00000000u, 0x00000000u, 0xFFFFFFFDu,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFCu, 0x00000002u},  // 3
    {0x00000003u, 0x00000000u, 0x00000000u, 0xFFFFFFFDu,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFCu, 0x00000002u},  // 3
    {0x00000003u, 0x00000000u, 0x00000000u, 0xFFFFFFFDu,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFCu, 0x00000002u},  // 3
    {0x7D4E399Fu, 0x89D69E26u, 0x698C91B2u, 0x06D01166u,
     0xE5638C84u, 0xB0E66203u, 0x0D95D89Cu, 0x94901259u},  // 3b
    {0x00000003u, 0x00000000u, 0x00000000u, 0xFFFFFFFDu,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFCu, 0x00000002u},  // 3
    {0x00000003u, 0x00000000u, 0x00000000u, 0xFFFFFFFDu,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFCu, 0x00000002u},  // 3
};

// --- A lane is a group of kGroup threads ----------------------------------
//
// Every thread of a group holds the lane's point in registers.  A round
// of K <= kGroup independent multiplies gives multiply j to the thread of
// rank j; the products go through the lane's exchange area in
// shared memory (two halves used in turn, so one __syncwarp a round is
// enough) and every thread reads them all back.  On the host, one call
// plays each rank in turn and group_sync is a no-op.

// The lane's shared-memory area, in 32-bit words; every Fe starts on a
// 16-byte boundary.
constexpr int kXchWords = 2 * kGroup * 8;    // the exchange area
constexpr int kQTabWords = 16 * 24;          // [inf, Q, .., 15Q] projective
constexpr int kPrefWords = 15 * 8;           // prefix products, then 1/Z
constexpr int kAffWords = 15 * 16;           // affine [Q, .., 15Q]

constexpr int kLaneWordsProjective = kXchWords + kQTabWords;
constexpr int kLaneWordsMixed = kLaneWordsProjective + kPrefWords + kAffWords;

struct Lane {
    int rank;        // this thread's place in the group (card only)
    int buf;         // which half of the exchange area the next round uses
    uint32_t* xch;
    uint32_t* qtab;
    uint32_t* pref;  // mixed only
    uint32_t* aff;   // mixed only
    const uint32_t* ctab;   // kRoundConsts (or its shared-memory copy)
};

__device__ __forceinline__ Lane make_lane(uint32_t* area, int rank, const uint32_t* ctab) {
    Lane ln;
    ln.rank = rank;
    ln.ctab = ctab;
    ln.buf = 0;
    ln.xch = area;
    ln.qtab = area + kXchWords;
    ln.pref = ln.qtab + kQTabWords;
    ln.aff = ln.pref + kPrefWords;
    return ln;
}

#ifdef __CUDA_ARCH__
#define FOR_MY_RANKS(ln, g) \
    for (int g = (ln).rank, g##_once = 1; g##_once; g##_once = 0)
__device__ __forceinline__ void group_sync() { __syncwarp(); }
#else
#define FOR_MY_RANKS(ln, g) for (int g = 0; g < kGroup; ++g)
__device__ __forceinline__ void group_sync() {}
#endif

__device__ __forceinline__ Fe fe_ld(const uint32_t* src) {
    const uint4 lo = reinterpret_cast<const uint4*>(src)[0];
    const uint4 hi = reinterpret_cast<const uint4*>(src)[1];
    Fe r;
    r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
    r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
    return r;
}

// one half (4 words) of an Fe
__device__ __forceinline__ void fe_st_half(uint32_t* dst, const Fe& f, int h) {
    uint4 q;
    q.x = f.v[4 * h];
    q.y = f.v[4 * h + 1];
    q.z = f.v[4 * h + 2];
    q.w = f.v[4 * h + 3];
    reinterpret_cast<uint4*>(dst)[h] = q;
}

// The lane's copy of f into shared memory, each half by one rank.
// Readers wait for a group_sync.
__device__ __forceinline__ void fe_put(const Lane& ln, uint32_t* dst, const Fe& f) {
    FOR_MY_RANKS(ln, g) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
            if (h == g) fe_st_half(dst, f, h);
    }
}

__device__ __forceinline__ void pt_put(const Lane& ln, uint32_t* dst, const Pt& p) {
    FOR_MY_RANKS(ln, g) {
#pragma unroll
        for (int q = 0; q < 6; ++q) {
            if (q % kGroup == g) {
                const Fe& f = q < 2 ? p.x : (q < 4 ? p.y : p.z);
                fe_st_half(dst + (q >> 1) * 8, f, q & 1);
            }
        }
    }
}

__device__ __forceinline__ Pt pt_ld(const uint32_t* src) {
    Pt p;
    p.x = fe_ld(src);
    p.y = fe_ld(src + 8);
    p.z = fe_ld(src + 16);
    return p;
}

// The operand of multiply g: vals[idx[g]].  idx is a list of literals,
// so the tests fold at compile time into one select per distinct value.
template <int K, int N>
__device__ __forceinline__ Fe pick(const Fe (&vals)[N], const int (&idx)[K], int g) {
    Fe r = vals[idx[0]];
#pragma unroll
    for (int d = 0; d < N; ++d) {
        if (d == idx[0]) continue;
        bool take = false;
#pragma unroll
        for (int j = 1; j < K; ++j)
            if (idx[j] == d) take = take || g == j;
        r = fe_sel(take, vals[d], r);
    }
    return r;
}

// out[j] = a(j) * b(j) for the K <= kGroup multiplies of a round: rank g
// computes multiply g (ranks past K compute a copy of multiply 0), then
// every rank reads all K products back.
template <int K, class OpA, class OpB>
__device__ __forceinline__ void mul_round_of(Lane& ln, OpA opa, OpB opb, Fe (&out)[K]) {
    static_assert(K <= kGroup, "one multiply per rank");
    uint32_t* slots = ln.xch + ln.buf * (kGroup * 8);
    FOR_MY_RANKS(ln, g) {
        const Fe prod = fe_mul(opa(g), opb(g));
        fe_st_half(slots + g * 8, prod, 0);
        fe_st_half(slots + g * 8, prod, 1);
    }
    group_sync();
#pragma unroll
    for (int j = 0; j < K; ++j) out[j] = fe_ld(slots + j * 8);
    ln.buf ^= 1;
}

// out[j] = va[ia[j]] * vb[ib[j]]
template <int K, int NA, int NB>
__device__ __forceinline__ void mul_round(Lane& ln, const Fe (&va)[NA], const int (&ia)[K],
                                          const Fe (&vb)[NB], const int (&ib)[K],
                                          Fe (&out)[K]) {
    mul_round_of(ln, [&](int g) { return pick(va, ia, g); },
                 [&](int g) { return pick(vb, ib, g); }, out);
}

// out[j] = va[ia[j]] * (row `row0 + j` of the constant table)
template <int K, int NA>
__device__ __forceinline__ void mul_round(Lane& ln, const Fe (&va)[NA], const int (&ia)[K],
                                          int row0, Fe (&out)[K]) {
    mul_round_of(ln, [&](int g) { return pick(va, ia, g); },
                 [&](int g) { return fe_ld(ln.ctab + (row0 + (g < K ? g : 0)) * 8); }, out);
}

// --- Complete formulas, a = -3, as rounds of independent multiplies -------
//
// Each formula gives the same X3, Y3, Z3 as ops/p256.py (the field values
// of eprint 2015/1060 algorithms 4, 5, 6), but regrouped for this card:
// a round holds up to kGroup multiplies at the cost of one, so small
// constant factors (the formulas' doublings and triplings, b) ride along
// as multiplies by constants in rounds that have room, which removes most
// of the adds and subtracts between rounds.  Three rounds each.

__device__ __forceinline__ Pt point_double(Lane& ln, const Pt& p) {
    Fe r1[6];
    mul_round(ln, {p.x, p.y, p.z}, {0, 1, 2, 0, 0, 1},
              {p.x, p.y, p.z}, {0, 1, 2, 1, 2, 2}, r1);
    // X^2, Y^2, Z^2, XY, XZ, YZ
    Fe r2[8];
    mul_round(ln, {r1[2], r1[4], r1[0], r1[3], r1[5]}, {0, 1, 1, 0, 2, 0, 3, 4},
              kRowsDouble, r2);
    // 3bZ^2, 6XZ, 6bXZ, 9Z^2, 3X^2, 3Z^2, 2XY, 2YZ
    const Fe y3a = fe_sub(r2[0], r2[1]);                    // 3(bZ^2 - 2XZ)
    const Fe x3a = fe_sub(r1[1], y3a);
    const Fe y3b = fe_add(r1[1], y3a);
    const Fe z3a = fe_sub(fe_sub(r2[2], r2[3]), r2[4]);     // 3(2bXZ - 3Z^2 - X^2)
    const Fe t0 = fe_sub(r2[4], r2[5]);                     // 3X^2 - 3Z^2
    Fe r3[5];
    mul_round(ln, {x3a, r2[7], t0}, {0, 1, 0, 2, 1},
              {r2[6], z3a, y3b, r1[1]}, {0, 1, 2, 1, 3}, r3);
    Pt r;
    r.x = fe_sub(r3[0], r3[1]);
    r.y = fe_add(r3[2], r3[3]);
    const Fe z2 = fe_add(r3[4], r3[4]);
    r.z = fe_add(z2, z2);                                   // 8 YZ Y^2
    return r;
}

// The last round and the sums of algorithms 4 and 5: with x3 = 3(Y3a - b
// t2), t1 = Y1Y2, y3 = 3(b Y3a - 3 t2 - t0), t0x3 = 3 t0 - 3 t2:
// X3 = t3 (t1 + x3) - t4 y3, Y3 = (t1 + x3)(t1 - x3) + t0x3 y3,
// Z3 = t4 (t1 - x3) + t3 t0x3.
__device__ __forceinline__ Pt add_last_round(Lane& ln, const Fe& t1, const Fe& t3,
                                             const Fe& t4, const Fe& x3, const Fe& y3,
                                             const Fe& t0x3) {
    const Fe z3p = fe_sub(t1, x3);
    const Fe x3p = fe_add(t1, x3);
    Fe r3[6];
    mul_round(ln, {t4, t0x3, x3p, t3}, {0, 1, 2, 3, 0, 3},
              {y3, z3p, x3p, t0x3}, {0, 0, 1, 2, 1, 3}, r3);
    Pt r;
    r.x = fe_sub(r3[3], r3[0]);
    r.y = fe_add(r3[2], r3[1]);
    r.z = fe_add(r3[4], r3[5]);
    return r;
}

__device__ __forceinline__ Pt point_add(Lane& ln, const Pt& p1, const Pt& p2) {
    Fe r1[8];
    mul_round(ln, {p1.x, p1.y, p1.z, fe_add(p1.x, p1.z)}, {0, 1, 2, 0, 1, 1, 2, 3},
              {p2.x, p2.y, p2.z, fe_add(p2.x, p2.z)}, {0, 1, 2, 1, 0, 2, 1, 3}, r1);
    // t0 = X1X2, t1 = Y1Y2, t2 = Z1Z2, X1Y2, Y1X2, Y1Z2, Z1Y2, (X1+Z1)(X2+Z2)
    const Fe t3 = fe_add(r1[3], r1[4]);
    const Fe t4 = fe_add(r1[5], r1[6]);
    const Fe y3a = fe_sub(r1[7], fe_add(r1[0], r1[2]));    // X1Z2 + Z1X2
    Fe r2[6];
    mul_round(ln, {y3a, r1[2], r1[0]}, {0, 1, 0, 1, 2, 1}, kRowsAdd, r2);
    // 3Y3a, 3b t2, 3b Y3a, 9 t2, 3 t0, 3 t2
    return add_last_round(ln, r1[1], t3, t4, fe_sub(r2[0], r2[1]),
                          fe_sub(fe_sub(r2[2], r2[3]), r2[4]), fe_sub(r2[4], r2[5]));
}

__device__ __forceinline__ Pt point_add_mixed(Lane& ln, const Pt& p1, const Aff& p2) {
    const Fe c3 = fe_load_const(kC3), c3b = fe_load_const(kC3B);
    Fe r1[8];
    mul_round(ln, {p1.x, p1.y, p2.y, p2.x, p1.z}, {0, 1, 0, 1, 2, 3, 4, 4},
              {p2.x, p2.y, p1.z, c3b, c3}, {0, 1, 1, 0, 2, 2, 3, 4}, r1);
    // t0 = X1x2, t1 = Y1y2, X1y2, Y1x2, y2Z1, x2Z1, 3b Z1, 3 Z1 (= t2)
    const Fe t3 = fe_add(r1[2], r1[3]);
    const Fe t4 = fe_add(r1[4], p1.y);
    const Fe y3a = fe_add(r1[5], p1.x);
    Fe r2[4];
    mul_round(ln, {y3a, r1[7], r1[0]}, {0, 0, 1, 2}, kRowsMixed, r2);
    // 3Y3a, 3b Y3a, 9 Z1, 3 t0
    return add_last_round(ln, r1[1], t3, t4, fe_sub(r2[0], r1[6]),
                          fe_sub(fe_sub(r2[1], r2[2]), r2[3]), fe_sub(r2[3], r1[7]));
}

__device__ __forceinline__ Pt point_infinity() {
    Pt r;
    r.x = fe_zero();
    r.y = fe_load_const(kOneM);
    r.z = fe_zero();
    return r;
}

// canonical key words (limb axis first: word k of lane at k*n + lane)
// -> Montgomery form, x and y in one round
__device__ __forceinline__ Pt load_key(Lane& ln, const uint32_t* qx, const uint32_t* qy,
                                       int lane, int n) {
    Fe x, y;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        x.v[k] = qx[(std::size_t)k * n + lane];
        y.v[k] = qy[(std::size_t)k * n + lane];
    }
    const Fe r2 = fe_load_const(kR2);
    Fe m[2];
    mul_round(ln, {x, y}, {0, 1}, {r2}, {0, 0}, m);
    Pt q;
    q.x = m[0];
    q.y = m[1];
    q.z = fe_load_const(kOneM);
    return q;
}

// out of Montgomery form (X, Y, Z in one round), then each rank stores
// its share of the 24 words; lanes past the edge store nothing
__device__ __forceinline__ void store_result(Lane& ln, const Pt& acc, bool live, int lane,
                                             int n, uint32_t* X, uint32_t* Y, uint32_t* Z) {
    Fe one = fe_zero();
    one.v[0] = 1u;
    Fe r[3];
    mul_round(ln, {acc.x, acc.y, acc.z}, {0, 1, 2}, {one}, {0, 0, 0}, r);
    if (!live) return;
    FOR_MY_RANKS(ln, g) {
#pragma unroll
        for (int w = 0; w < 24; ++w) {
            if (w % kGroup == g) {
                uint32_t* dst = w < 8 ? X : (w < 16 ? Y : Z);
                dst[(std::size_t)(w & 7) * n + lane] = r[w >> 3].v[w & 7];
            }
        }
    }
}

// [inf, Q, 2Q, ..., 15Q] into the lane's table: the schedule of
// ops/p256.build_q_table
__device__ __forceinline__ void build_q_table(Lane& ln, const Pt& q1) {
    pt_put(ln, ln.qtab, point_infinity());
    pt_put(ln, ln.qtab + 24, q1);
    group_sync();
    Pt cur = q1;
#pragma unroll 1
    for (int i = 2; i < 16; ++i) {
        if ((i & 1) == 0) cur = point_double(ln, pt_ld(ln.qtab + (i >> 1) * 24));
        else cur = point_add(ln, cur, q1);
        pt_put(ln, ln.qtab + i * 24, cur);
        group_sync();
    }
}

// One lane of the projective ladder.  gtab: 16 entries x (x, y, z)
// Montgomery words, the G table (shared memory on the card).
__device__ __forceinline__ void ladder_projective_lane(
        Lane& ln, int lane, bool live, int n, const int32_t* u1w, const int32_t* u2w,
        const uint32_t* qx, const uint32_t* qy, const uint32_t* gtab,
        uint32_t* X, uint32_t* Y, uint32_t* Z) {
    build_q_table(ln, load_key(ln, qx, qy, lane, n));
    Pt acc = point_infinity();
#pragma unroll 1
    for (int w = 0; w < 64; ++w) {
        const int i2 = u2w[(std::size_t)w * n + lane] & 15;
        const int i1 = u1w[(std::size_t)w * n + lane] & 15;
#pragma unroll 1
        for (int d = 0; d < 4; ++d) acc = point_double(ln, acc);
#pragma unroll 1
        for (int h = 0; h < 2; ++h) {
            const uint32_t* src = h == 0 ? ln.qtab + i2 * 24 : gtab + i1 * 24;
            acc = point_add(ln, acc, pt_ld(src));
        }
    }
    store_result(ln, acc, live, lane, n, X, Y, Z);
}

// One lane of the mixed ladder.  gtab: 15 entries x (x, y) affine
// Montgomery words for G..15G.
__device__ __forceinline__ void ladder_mixed_lane(
        Lane& ln, int lane, bool live, int n, const int32_t* u1w, const int32_t* u2w,
        const uint32_t* qx, const uint32_t* qy, const uint32_t* gtab,
        uint32_t* X, uint32_t* Y, uint32_t* Z) {
    build_q_table(ln, load_key(ln, qx, qy, lane, n));
    // Montgomery's simultaneous inversion of the Z of Q..15Q
    // (limbs9.inv_mont_many): one inversion + 3*14 multiplies.  A zero
    // Z (invalid key) zeroes the whole lane's table.  The prefix chain
    // and the inversion are sequential: every rank runs them.
    Fe run = fe_ld(ln.qtab + 24 + 16);
    fe_put(ln, ln.pref, run);
#pragma unroll 1
    for (int i = 1; i < 15; ++i) {
        run = fe_mul(run, fe_ld(ln.qtab + (i + 1) * 24 + 16));
        fe_put(ln, ln.pref + i * 8, run);
    }
    group_sync();
    run = fe_inv(run);
#pragma unroll 1
    for (int i = 14; i > 0; --i) {
        Fe r[2];
        mul_round(ln, {run}, {0, 0},
                  {fe_ld(ln.pref + (i - 1) * 8), fe_ld(ln.qtab + (i + 1) * 24 + 16)},
                  {0, 1}, r);
        fe_put(ln, ln.pref + i * 8, r[0]);         // 1/Z of (i+1)Q over prefix i
        run = r[1];
    }
    fe_put(ln, ln.pref, run);
    group_sync();
    // the affine table: 30 independent multiplies, rank g takes g, g+kGroup, ..
    FOR_MY_RANKS(ln, g) {
#pragma unroll 1
        for (int j = g; j < 30; j += kGroup) {
            const int e = j >> 1, c = j & 1;
            const Fe v = fe_mul(fe_ld(ln.qtab + (e + 1) * 24 + c * 8), fe_ld(ln.pref + e * 8));
            fe_st_half(ln.aff + e * 16 + c * 8, v, 0);
            fe_st_half(ln.aff + e * 16 + c * 8, v, 1);
        }
    }
    group_sync();
    Pt acc = point_infinity();
#pragma unroll 1
    for (int w = 0; w < 64; ++w) {
        const int i2 = u2w[(std::size_t)w * n + lane] & 15;
        const int i1 = u1w[(std::size_t)w * n + lane] & 15;
#pragma unroll 1
        for (int d = 0; d < 4; ++d) acc = point_double(ln, acc);
        // zero windows keep the accumulator (the affine tables have no
        // infinity row): an add of row 0, then a select, as the plain
        // ladder's torch.where does
#pragma unroll 1
        for (int h = 0; h < 2; ++h) {
            const int wv = h == 0 ? i2 : i1;
            const int row = (wv > 0 ? wv : 1) - 1;
            const uint32_t* src = h == 0 ? ln.aff + row * 16 : gtab + row * 16;
            Aff p2;
            p2.x = fe_ld(src);
            p2.y = fe_ld(src + 8);
            const Pt sum = point_add_mixed(ln, acc, p2);
            const bool keep = wv == 0;
            acc.x = fe_sel(keep, acc.x, sum.x);
            acc.y = fe_sel(keep, acc.y, sum.y);
            acc.z = fe_sel(keep, acc.z, sum.z);
        }
    }
    store_result(ln, acc, live, lane, n, X, Y, Z);
}

}  // namespace

#ifdef __CUDACC__

constexpr int kThreads = 64;
constexpr int kLanesPerBlock = kThreads / kGroup;

template <bool kMixed>
__device__ __forceinline__ void ladder_block(
        const int32_t* __restrict__ u1w, const int32_t* __restrict__ u2w,
        const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
        const uint32_t* __restrict__ gtab, uint32_t* __restrict__ X,
        uint32_t* __restrict__ Y, uint32_t* __restrict__ Z, int n) {
    extern __shared__ uint4 smem[];
    constexpr int kGWords = kMixed ? 15 * 2 * 8 : 16 * 3 * 8;
    uint32_t* sg = reinterpret_cast<uint32_t*>(smem);
    uint32_t* sc = sg + kGWords;
    for (int i = threadIdx.x; i < kGWords; i += kThreads) sg[i] = gtab[i];
    for (int i = threadIdx.x; i < kConstRows * 8; i += kThreads) sc[i] = (&kRoundConsts[0][0])[i];
    __syncthreads();
    const int slot = threadIdx.x / kGroup;
    const int lane = blockIdx.x * kLanesPerBlock + slot;
    const bool live = lane < n;
    constexpr int kLaneWords = kMixed ? kLaneWordsMixed : kLaneWordsProjective;
    Lane ln = make_lane(sc + kConstRows * 8 + slot * kLaneWords, threadIdx.x % kGroup, sc);
    const int l = live ? lane : n - 1;
    if constexpr (kMixed) ladder_mixed_lane(ln, l, live, n, u1w, u2w, qx, qy, sg, X, Y, Z);
    else ladder_projective_lane(ln, l, live, n, u1w, u2w, qx, qy, sg, X, Y, Z);
}

__global__ void __launch_bounds__(kThreads, 1) ladder_projective_kernel(
        const int32_t* __restrict__ u1w, const int32_t* __restrict__ u2w,
        const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
        const uint32_t* __restrict__ gtab, uint32_t* __restrict__ X,
        uint32_t* __restrict__ Y, uint32_t* __restrict__ Z, int n) {
    ladder_block<false>(u1w, u2w, qx, qy, gtab, X, Y, Z, n);
}

__global__ void __launch_bounds__(kThreads, 1) ladder_mixed_kernel(
        const int32_t* __restrict__ u1w, const int32_t* __restrict__ u2w,
        const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
        const uint32_t* __restrict__ gtab, uint32_t* __restrict__ X,
        uint32_t* __restrict__ Y, uint32_t* __restrict__ Z, int n) {
    ladder_block<true>(u1w, u2w, qx, qy, gtab, X, Y, Z, n);
}

constexpr std::size_t smem_bytes(bool mixed) {
    return 4 * ((mixed ? 15 * 2 * 8 : 16 * 3 * 8) + kConstRows * 8
                + (std::size_t)kLanesPerBlock
                      * (mixed ? kLaneWordsMixed : kLaneWordsProjective));
}

// Threads per lane and threads per block, for reports.
extern "C" int p256_ladder_geometry(int* threads_per_lane, int* block_threads) {
    *threads_per_lane = kGroup;
    *block_threads = kThreads;
    return 0;
}

// Launch one ladder on `stream`.  u1w, u2w: (64, n) int32 windows, MSB
// window first; qx, qy: (8, n) canonical affine key words; gtab: the G
// table words (16x3x8 projective or 15x2x8 affine, Montgomery R = 2^256);
// X, Y, Z: (8, n) canonical non-Montgomery output words.  Allocates
// nothing; returns the cudaError_t of the launch.
extern "C" int p256_ladder_launch(int mixed, const void* u1w, const void* u2w,
                                  const void* qx, const void* qy,
                                  const void* gtab, void* X, void* Y, void* Z,
                                  int n, void* stream) {
    if (n <= 0) return 0;
    const dim3 grid((n + kLanesPerBlock - 1) / kLanesPerBlock);
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const auto* a = static_cast<const int32_t*>(u1w);
    const auto* b = static_cast<const int32_t*>(u2w);
    const auto* x = static_cast<const uint32_t*>(qx);
    const auto* y = static_cast<const uint32_t*>(qy);
    const auto* g = static_cast<const uint32_t*>(gtab);
    auto* ox = static_cast<uint32_t*>(X);
    auto* oy = static_cast<uint32_t*>(Y);
    auto* oz = static_cast<uint32_t*>(Z);
    const std::size_t bytes = smem_bytes(mixed != 0);
    auto kernel = mixed ? ladder_mixed_kernel : ladder_projective_kernel;
    if (bytes > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<grid, kThreads, bytes, s>>>(a, b, x, y, g, ox, oy, oz, n);
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
