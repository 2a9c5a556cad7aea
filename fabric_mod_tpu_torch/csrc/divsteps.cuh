// The inverse modulo an odd 256-bit m by divsteps, shared by the verify
// core's inverse mod n (p256_core.cu) and the FP256BN field's inverse mod
// p (fp256bn_field.cuh).  Variable time: both run on public data.
//
// Bernstein-Yang safegcd in its variable-time form, as libsecp256k1's
// modinv32_var runs it: values as 9 signed 30-bit limbs; batches of 30
// divsteps on the low words alone, each giving a 2x2 transition matrix t
// (entries below 2^30 in magnitude); t applied to (f, g) exactly and to
// (d, e) mod m.  f = m, g = x, d = 0, e = 1 at the start; f = d*x and
// g = e*x mod m throughout; the loop stops at the first batch that leaves
// g = 0, and then f = +-1 and d = +-x^-1.  The limbs stay 9 wide (no
// length trimming), so every limb index is a constant and the values live
// in registers.  Right shifts of negative int32 and int64 values below are
// arithmetic: both g++ and nvcc define them so.

#pragma once

#include "carry_chain.cuh"

namespace {

constexpr int32_t kM30 = 0x3FFFFFFF;
// safegcd from delta = 1 reaches g = 0 within (49 * 256 + 57) / 17 = 741
// divsteps for 256-bit inputs, so 25 batches always suffice
constexpr int kMaxBatches = 25;

struct S30 {
    int32_t v[9];
};

struct Trans {
    int32_t u, v, q, r;
};

__device__ __forceinline__ int ctz32(uint32_t x) {
#ifdef __CUDA_ARCH__
    return __ffs(x) - 1;
#else
    return __builtin_ctz(x);
#endif
}

// 30 divsteps on the low words f0 (odd), g0 with eta = -delta; returns the
// new eta and the transition matrix (scaled by 2^30).  A run of zeros of
// g is one shift; otherwise one step cancels up to min(eta + 1, i, 8) low
// bits of g with a multiple of f.
__device__ __forceinline__ int32_t divsteps_30_var(int32_t eta, uint32_t f0, uint32_t g0,
                                                   Trans* t) {
    uint32_t u = 1u, v = 0u, q = 0u, r = 1u;
    uint32_t f = f0, g = g0;
    int i = 30;
#pragma unroll 1
    for (;;) {
        // the sentinel bit counts zeros only up to i
        const int zeros = ctz32(g | (0xFFFFFFFFu << i));
        g >>= zeros;
        u <<= zeros;
        v <<= zeros;
        eta -= zeros;
        i -= zeros;
        if (i == 0) break;
        if (eta < 0) {   // (f, g) <- (g, -f), and the matrix's rows alike
            eta = -eta;
            uint32_t tmp = f;
            f = g;
            g = 0u - tmp;
            tmp = u;
            u = q;
            q = 0u - tmp;
            tmp = v;
            v = r;
            r = 0u - tmp;
        }
        const int limit = (eta + 1) > i ? i : (eta + 1);
        const uint32_t m = (0xFFFFFFFFu >> (32 - limit)) & 255u;
        // f^-1 mod 2^10: (3f) xor 2 is exact mod 2^5, one Newton step doubles it
        uint32_t x = (3u * f) ^ 2u;
        x *= 2u - f * x;
        const uint32_t w = (0u - g * x) & m;
        g += f * w;
        q += u * w;
        r += v * w;
    }
    t->u = (int32_t)u;
    t->v = (int32_t)v;
    t->q = (int32_t)q;
    t->r = (int32_t)r;
    return eta;
}

// (f, g) <- t (f, g) / 2^30, exact (the low 30 bits are zero by t's making)
__device__ __forceinline__ void update_fg_30(S30& f, S30& g, const Trans& t) {
    int64_t cf = (int64_t)t.u * f.v[0] + (int64_t)t.v * g.v[0];
    int64_t cg = (int64_t)t.q * f.v[0] + (int64_t)t.r * g.v[0];
    cf >>= 30;
    cg >>= 30;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
        const int32_t fi = f.v[i], gi = g.v[i];
        cf += (int64_t)t.u * fi + (int64_t)t.v * gi;
        cg += (int64_t)t.q * fi + (int64_t)t.r * gi;
        f.v[i - 1] = (int32_t)cf & kM30;
        g.v[i - 1] = (int32_t)cg & kM30;
        cf >>= 30;
        cg >>= 30;
    }
    f.v[8] = (int32_t)cf;
    g.v[8] = (int32_t)cg;
}

// (d, e) <- (t (d, e) + m (md, me)) / 2^30 with md, me chosen to clear the
// low 30 bits; d, e stay in (-2m, m).  m30: the modulus m in 30-bit limbs,
// minv30 = m^-1 mod 2^30.
__device__ __forceinline__ void update_de_30(S30& d, S30& e, const Trans& t,
                                             const int32_t* m30, uint32_t minv30) {
    const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
    int32_t md = (t.u & sd) + (t.v & se);
    int32_t me = (t.q & sd) + (t.r & se);
    int64_t cd = (int64_t)t.u * d.v[0] + (int64_t)t.v * e.v[0];
    int64_t ce = (int64_t)t.q * d.v[0] + (int64_t)t.r * e.v[0];
    md -= (int32_t)((minv30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)kM30);
    me -= (int32_t)((minv30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)kM30);
    cd += (int64_t)m30[0] * md;
    ce += (int64_t)m30[0] * me;
    cd >>= 30;
    ce >>= 30;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
        const int32_t di = d.v[i], ei = e.v[i];
        cd += (int64_t)t.u * di + (int64_t)t.v * ei + (int64_t)m30[i] * md;
        ce += (int64_t)t.q * di + (int64_t)t.r * ei + (int64_t)m30[i] * me;
        d.v[i - 1] = (int32_t)cd & kM30;
        e.v[i - 1] = (int32_t)ce & kM30;
        cd >>= 30;
        ce >>= 30;
    }
    d.v[8] = (int32_t)cd;
    e.v[8] = (int32_t)ce;
}

// carry each limb's bits above 30 into the next
__device__ __forceinline__ void carry_30(S30& a) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        a.v[i + 1] += a.v[i] >> 30;
        a.v[i] &= kM30;
    }
}

// a in (-2m, m) -> a (sign >= 0) or -a (sign < 0), in [0, m)
__device__ __forceinline__ void normalize_30(S30& a, int32_t sign, const int32_t* m30) {
    int32_t add = a.v[8] >> 31;
#pragma unroll
    for (int i = 0; i < 9; ++i) a.v[i] += m30[i] & add;
    const int32_t neg = sign >> 31;
#pragma unroll
    for (int i = 0; i < 9; ++i) a.v[i] = (a.v[i] ^ neg) - neg;
    carry_30(a);
    add = a.v[8] >> 31;
#pragma unroll
    for (int i = 0; i < 9; ++i) a.v[i] += m30[i] & add;
    carry_30(a);
}

__device__ __forceinline__ S30 to_s30(const uint32_t* a) {
    S30 s;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        const int b = 30 * i, w = b >> 5, sh = b & 31;
        uint32_t x = a[w] >> sh;
        if (sh > 2 && w < 7) x |= a[w + 1] << (32 - sh);
        s.v[i] = (int32_t)(x & (uint32_t)kM30);
    }
    return s;
}

// limbs in [0, 2^30) of a value < 2^256 -> 8 words (word k is limb
// 32k / 30 from bit 32k mod 30 <= 14, and the next limb above it)
__device__ __forceinline__ void from_s30(const S30& s, uint32_t* a) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int i = (32 * k) / 30, sh = (32 * k) % 30;
        a[k] = ((uint32_t)s.v[i] >> sh) | ((uint32_t)s.v[i + 1] << (30 - sh));
    }
}

// out = x^-1 mod m for x < m, 8 words each (plain values; 0 -> 0)
__device__ __forceinline__ void modinv_var(const uint32_t* x, const int32_t* m30,
                                           uint32_t minv30, uint32_t* out) {
    S30 d, e, f, g;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        d.v[i] = 0;
        e.v[i] = 0;
        f.v[i] = m30[i];
    }
    e.v[0] = 1;
    g = to_s30(x);
    int32_t eta = -1;   // delta = 1
#pragma unroll 1
    for (int b = 0; b < kMaxBatches; ++b) {
        Trans t;
        eta = divsteps_30_var(eta, (uint32_t)f.v[0], (uint32_t)g.v[0], &t);
        update_de_30(d, e, t, m30, minv30);
        update_fg_30(f, g, t);
        int32_t any = 0;
#pragma unroll
        for (int i = 0; i < 9; ++i) any |= g.v[i];
        if (any == 0) break;
    }
    normalize_30(d, f.v[8], m30);   // f = +-1: its sign is its top limb's
    from_s30(d, out);
}

}  // namespace
