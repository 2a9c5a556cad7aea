// The windowed Shamir ladder u1*G + u2*Q of batched ECDSA-P256 verify,
// written by hand for Hopper (sm_90a).  Two kernels:
//
//   ladder_projective_kernel  replaces fabric_mod_tpu/ops/p256_pallas.py
//                             _ladder_kernel (via pallas_ladder)
//   ladder_mixed_kernel       replaces fabric_mod_tpu/ops/p256_pallas.py
//                             _ladder_kernel_mixed (via pallas_ladder_mixed)
//
// What they compute: the same RCB complete formulas (eprint 2015/1060
// algorithms 4, 5, 6) in the same operation order as ops/p256.py, the
// same Q-table schedule (build_q_table: 7 doublings + 7 additions) and,
// for the mixed kernel, the same window-0 normalisation (the p-2
// addition chain of inv_mont_p_chain inside Montgomery's simultaneous
// inversion).  So X, Y, Z equal the plain ladders' as field values,
// exactly, although the limb representation differs.
//
// Design.  The TPU kernel ran a sequential grid axis over the 64 windows
// with the accumulator in VMEM scratch.  Here one thread owns one
// signature lane and runs the whole 64-window loop itself; blocks of 128
// threads, grid ceil(B/128), the ragged edge masked in the kernel.  A
// field element is 8 x uint32 little-endian words in Montgomery form
// with R = 2^256 (not the plain layer's f32 radix-2^9 limbs, which exist
// for the TPU's matrix unit): products are 32x32->64-bit integer
// multiply-adds with carry chains.  For P-256's p, -p^-1 mod 2^32 = 1
// (p = -1 mod 2^32), so the CIOS reduction multiplier is the low word
// itself and needs no multiply.  The constant G table lives in shared
// memory, loaded at block start (constant memory would serialise the
// lanes' divergent indices); the per-lane Q table lives in local memory
// and is indexed directly, with no one-hot product.
//
// What bounds it on this card: integer multiply issue, not bytes.  A
// verify's ladder is about 5.3k field multiplies, each 128 32x32->64
// products (two IMAD-class instructions apiece), against a few hundred
// bytes of input and output per lane.  This first version keeps one lane
// per thread, so a 2048-lane call fills only 16 blocks: most SMs idle and
// each thread's dependent multiply chain exposed.  Spreading a lane over
// several threads is the next step (PERF.md).  wgmma has no integer
// path wide enough to help.
//
// The field and point arithmetic below is plain C++ when compiled by a
// host compiler (no __CUDACC__): only the kernels and the launcher need
// nvcc.

#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#define __device__
#define __forceinline__ inline
#define __constant__
#endif

namespace {

struct Fe {
    uint32_t v[8];
};

struct Pt {
    Fe x, y, z;
};

struct Aff {
    Fe x, y;
};

// p = 2^256 - 2^224 + 2^192 + 2^96 - 1, little-endian words
__constant__ uint32_t kP[8] = {
    0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000001u, 0xFFFFFFFFu};
// R^2 mod p (R = 2^256): to-Montgomery multiplier
__constant__ uint32_t kR2[8] = {
    0x00000003u, 0x00000000u, 0xFFFFFFFFu, 0xFFFFFFFBu,
    0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFDu, 0x00000004u};
// R mod p: Montgomery one
__constant__ uint32_t kOneM[8] = {
    0x00000001u, 0x00000000u, 0x00000000u, 0xFFFFFFFFu,
    0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFEu, 0x00000000u};
// b * R mod p: the curve's b in Montgomery form
__constant__ uint32_t kBM[8] = {
    0x29C4BDDFu, 0xD89CDF62u, 0x78843090u, 0xACF005CDu,
    0xF7212ED6u, 0xE5A220ABu, 0x04874834u, 0xDC30061Du};

__device__ __forceinline__ Fe fe_load_const(const uint32_t* c) {
    Fe r;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.v[k] = c[k];
    return r;
}

__device__ __forceinline__ Fe fe_zero() {
    Fe r;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.v[k] = 0u;
    return r;
}

// t (8 words + top word `hi`, value < 2p) -> t mod p
__device__ __forceinline__ Fe fe_reduce_once(const uint32_t* t, uint32_t hi) {
    Fe d;
    uint64_t borrow = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        uint64_t s = (uint64_t)t[k] - kP[k] - borrow;
        d.v[k] = (uint32_t)s;
        borrow = (s >> 63) & 1u;
    }
    const bool use_d = (hi != 0u) || (borrow == 0u);
    Fe r;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.v[k] = use_d ? d.v[k] : t[k];
    return r;
}

// Montgomery product a*b*R^-1 mod p (CIOS).  Needs a < 2^256, b < p;
// returns a value < p.
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
    uint32_t t[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) t[k] = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
            t[j] = (uint32_t)s;
            c = s >> 32;
        }
        uint64_t s = (uint64_t)t[8] + c;
        t[8] = (uint32_t)s;
        t[9] = (uint32_t)(s >> 32);
        // m = t[0] * (-p^-1 mod 2^32) = t[0] * 1
        const uint32_t m = t[0];
        s = (uint64_t)m * kP[0] + t[0];
        c = s >> 32;
#pragma unroll
        for (int j = 1; j < 8; ++j) {
            s = (uint64_t)m * kP[j] + t[j] + c;
            t[j - 1] = (uint32_t)s;
            c = s >> 32;
        }
        s = (uint64_t)t[8] + c;
        t[7] = (uint32_t)s;
        t[8] = t[9] + (uint32_t)(s >> 32);
    }
    return fe_reduce_once(t, t[8]);
}

__device__ __forceinline__ Fe fe_sqr(const Fe& a) { return fe_mul(a, a); }

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
    uint32_t t[8];
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        uint64_t s = (uint64_t)a.v[k] + b.v[k] + c;
        t[k] = (uint32_t)s;
        c = s >> 32;
    }
    return fe_reduce_once(t, (uint32_t)c);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
    Fe d;
    uint64_t borrow = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        uint64_t s = (uint64_t)a.v[k] - b.v[k] - borrow;
        d.v[k] = (uint32_t)s;
        borrow = (s >> 63) & 1u;
    }
    // a - b < 0: add p back
    const uint32_t mask = borrow ? 0xFFFFFFFFu : 0u;
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        uint64_t s = (uint64_t)d.v[k] + (kP[k] & mask) + c;
        d.v[k] = (uint32_t)s;
        c = s >> 32;
    }
    return d;
}

// --- Complete formulas, a = -3 (operation order of ops/p256.py) ----------

__device__ __forceinline__ Pt point_add(const Pt& p1, const Pt& p2) {
    const Fe bm = fe_load_const(kBM);
    Fe t0, t1, t2, t3, t4, X3, Y3, Z3;
    t0 = fe_mul(p1.x, p2.x);
    t1 = fe_mul(p1.y, p2.y);
    t2 = fe_mul(p1.z, p2.z);
    t3 = fe_add(p1.x, p1.y);
    t4 = fe_add(p2.x, p2.y);
    t3 = fe_mul(t3, t4);
    t4 = fe_add(t0, t1);
    t3 = fe_sub(t3, t4);
    t4 = fe_add(p1.y, p1.z);
    X3 = fe_add(p2.y, p2.z);
    t4 = fe_mul(t4, X3);
    X3 = fe_add(t1, t2);
    t4 = fe_sub(t4, X3);
    X3 = fe_add(p1.x, p1.z);
    Y3 = fe_add(p2.x, p2.z);
    X3 = fe_mul(X3, Y3);
    Y3 = fe_add(t0, t2);
    Y3 = fe_sub(X3, Y3);
    Z3 = fe_mul(bm, t2);
    X3 = fe_sub(Y3, Z3);
    Z3 = fe_add(X3, X3);
    X3 = fe_add(X3, Z3);
    Z3 = fe_sub(t1, X3);
    X3 = fe_add(t1, X3);
    Y3 = fe_mul(bm, Y3);
    t1 = fe_add(t2, t2);
    t2 = fe_add(t1, t2);
    Y3 = fe_sub(Y3, t2);
    Y3 = fe_sub(Y3, t0);
    t1 = fe_add(Y3, Y3);
    Y3 = fe_add(t1, Y3);
    t1 = fe_add(t0, t0);
    t0 = fe_add(t1, t0);
    t0 = fe_sub(t0, t2);
    t1 = fe_mul(t4, Y3);
    t2 = fe_mul(t0, Y3);
    Y3 = fe_mul(X3, Z3);
    Y3 = fe_add(Y3, t2);
    X3 = fe_mul(t3, X3);
    X3 = fe_sub(X3, t1);
    Z3 = fe_mul(t4, Z3);
    t1 = fe_mul(t3, t0);
    Z3 = fe_add(Z3, t1);
    Pt r;
    r.x = X3;
    r.y = Y3;
    r.z = Z3;
    return r;
}

__device__ __forceinline__ Pt point_add_mixed(const Pt& p1, const Aff& p2) {
    const Fe bm = fe_load_const(kBM);
    Fe t0, t1, t2, t3, t4, X3, Y3, Z3;
    t0 = fe_mul(p1.x, p2.x);
    t1 = fe_mul(p1.y, p2.y);
    t3 = fe_add(p2.x, p2.y);
    t4 = fe_add(p1.x, p1.y);
    t3 = fe_mul(t3, t4);
    t4 = fe_add(t0, t1);
    t3 = fe_sub(t3, t4);
    t4 = fe_mul(p2.y, p1.z);
    t4 = fe_add(t4, p1.y);
    Y3 = fe_mul(p2.x, p1.z);
    Y3 = fe_add(Y3, p1.x);
    Z3 = fe_mul(bm, p1.z);
    X3 = fe_sub(Y3, Z3);
    Z3 = fe_add(X3, X3);
    X3 = fe_add(X3, Z3);
    Z3 = fe_sub(t1, X3);
    X3 = fe_add(t1, X3);
    Y3 = fe_mul(bm, Y3);
    t1 = fe_add(p1.z, p1.z);
    t2 = fe_add(t1, p1.z);
    Y3 = fe_sub(Y3, t2);
    Y3 = fe_sub(Y3, t0);
    t1 = fe_add(Y3, Y3);
    Y3 = fe_add(t1, Y3);
    t1 = fe_add(t0, t0);
    t0 = fe_add(t1, t0);
    t0 = fe_sub(t0, t2);
    t1 = fe_mul(t4, Y3);
    t2 = fe_mul(t0, Y3);
    Y3 = fe_mul(X3, Z3);
    Y3 = fe_add(Y3, t2);
    X3 = fe_mul(t3, X3);
    X3 = fe_sub(X3, t1);
    Z3 = fe_mul(t4, Z3);
    t1 = fe_mul(t3, t0);
    Z3 = fe_add(Z3, t1);
    Pt r;
    r.x = X3;
    r.y = Y3;
    r.z = Z3;
    return r;
}

__device__ __forceinline__ Pt point_double(const Pt& p) {
    const Fe bm = fe_load_const(kBM);
    Fe t0, t1, t2, t3, X3, Y3, Z3;
    t0 = fe_sqr(p.x);
    t1 = fe_sqr(p.y);
    t2 = fe_sqr(p.z);
    t3 = fe_mul(p.x, p.y);
    t3 = fe_add(t3, t3);
    Z3 = fe_mul(p.x, p.z);
    Z3 = fe_add(Z3, Z3);
    Y3 = fe_mul(bm, t2);
    Y3 = fe_sub(Y3, Z3);
    X3 = fe_add(Y3, Y3);
    Y3 = fe_add(X3, Y3);
    X3 = fe_sub(t1, Y3);
    Y3 = fe_add(t1, Y3);
    Y3 = fe_mul(X3, Y3);
    X3 = fe_mul(X3, t3);
    t3 = fe_add(t2, t2);
    t2 = fe_add(t2, t3);
    Z3 = fe_mul(bm, Z3);
    Z3 = fe_sub(Z3, t2);
    Z3 = fe_sub(Z3, t0);
    t3 = fe_add(Z3, Z3);
    Z3 = fe_add(Z3, t3);
    t3 = fe_add(t0, t0);
    t0 = fe_add(t3, t0);
    t0 = fe_sub(t0, t2);
    t0 = fe_mul(t0, Z3);
    Y3 = fe_add(Y3, t0);
    t0 = fe_mul(p.y, p.z);
    t0 = fe_add(t0, t0);
    Z3 = fe_mul(t0, Z3);
    X3 = fe_sub(X3, Z3);
    Z3 = fe_mul(t0, t1);
    Z3 = fe_add(Z3, Z3);
    Z3 = fe_add(Z3, Z3);
    Pt r;
    r.x = X3;
    r.y = Y3;
    r.z = Z3;
    return r;
}

__device__ __forceinline__ Pt point_infinity() {
    Pt r;
    r.x = fe_zero();
    r.y = fe_load_const(kOneM);
    r.z = fe_zero();
    return r;
}

__device__ __forceinline__ Fe fe_sqr_n(Fe x, int n) {
#pragma unroll 1
    for (int i = 0; i < n; ++i) x = fe_sqr(x);
    return x;
}

// a^(p-2): the addition chain of ops/p256.inv_mont_p_chain (0 -> 0)
__device__ __forceinline__ Fe fe_inv(const Fe& a) {
    const Fe x2 = fe_mul(fe_sqr(a), a);
    const Fe x4 = fe_mul(fe_sqr_n(x2, 2), x2);
    const Fe x8 = fe_mul(fe_sqr_n(x4, 4), x4);
    const Fe x16 = fe_mul(fe_sqr_n(x8, 8), x8);
    const Fe x24 = fe_mul(fe_sqr_n(x16, 8), x8);
    const Fe x28 = fe_mul(fe_sqr_n(x24, 4), x4);
    const Fe x30 = fe_mul(fe_sqr_n(x28, 2), x2);
    const Fe x32 = fe_mul(fe_sqr_n(x30, 2), x2);
    Fe acc = fe_mul(fe_sqr_n(x32, 32), a);
    acc = fe_sqr_n(acc, 96);
    acc = fe_mul(fe_sqr_n(acc, 32), x32);
    acc = fe_mul(fe_sqr_n(acc, 32), x32);
    acc = fe_mul(fe_sqr_n(acc, 30), x30);
    acc = fe_mul(fe_sqr_n(acc, 2), a);
    return acc;
}

// canonical key words (limb axis first: word k of lane at k*n + lane)
// -> Montgomery form
__device__ __forceinline__ Fe load_to_mont(const uint32_t* src, int lane, int n) {
    Fe x;
#pragma unroll
    for (int k = 0; k < 8; ++k) x.v[k] = src[(std::size_t)k * n + lane];
    return fe_mul(x, fe_load_const(kR2));
}

__device__ __forceinline__ void store_from_mont(uint32_t* dst, const Fe& a, int lane, int n) {
    Fe one = fe_zero();
    one.v[0] = 1u;
    const Fe x = fe_mul(a, one);
#pragma unroll
    for (int k = 0; k < 8; ++k) dst[(std::size_t)k * n + lane] = x.v[k];
}

// [inf, Q, 2Q, ..., 15Q]: the schedule of ops/p256.build_q_table
__device__ __forceinline__ void build_q_table(Pt* tab, const Pt& q1) {
    tab[0] = point_infinity();
    tab[1] = q1;
#pragma unroll 1
    for (int i = 2; i < 16; ++i) {
        if ((i & 1) == 0) tab[i] = point_double(tab[i >> 1]);
        else tab[i] = point_add(tab[i - 1], q1);
    }
}

// One lane of the projective ladder.  gtab: 16 entries x (x, y, z)
// Montgomery words — the G table, in shared memory under nvcc.
__device__ __forceinline__ void ladder_projective_lane(
        int lane, int n, const int32_t* u1w, const int32_t* u2w,
        const uint32_t* qx, const uint32_t* qy, const Fe* gtab,
        uint32_t* X, uint32_t* Y, uint32_t* Z) {
    Pt q1;
    q1.x = load_to_mont(qx, lane, n);
    q1.y = load_to_mont(qy, lane, n);
    q1.z = fe_load_const(kOneM);
    Pt tab[16];
    build_q_table(tab, q1);
    Pt acc = point_infinity();
#pragma unroll 1
    for (int w = 0; w < 64; ++w) {
#pragma unroll 1
        for (int d = 0; d < 4; ++d) acc = point_double(acc);
        const int i2 = u2w[(std::size_t)w * n + lane] & 15;
        acc = point_add(acc, tab[i2]);
        const int i1 = u1w[(std::size_t)w * n + lane] & 15;
        Pt g;
        g.x = gtab[i1 * 3 + 0];
        g.y = gtab[i1 * 3 + 1];
        g.z = gtab[i1 * 3 + 2];
        acc = point_add(acc, g);
    }
    store_from_mont(X, acc.x, lane, n);
    store_from_mont(Y, acc.y, lane, n);
    store_from_mont(Z, acc.z, lane, n);
}

// One lane of the mixed ladder.  gtab: 15 entries x (x, y) affine
// Montgomery words for G..15G.
__device__ __forceinline__ void ladder_mixed_lane(
        int lane, int n, const int32_t* u1w, const int32_t* u2w,
        const uint32_t* qx, const uint32_t* qy, const Fe* gtab,
        uint32_t* X, uint32_t* Y, uint32_t* Z) {
    Pt q1;
    q1.x = load_to_mont(qx, lane, n);
    q1.y = load_to_mont(qy, lane, n);
    q1.z = fe_load_const(kOneM);
    Pt tab[16];
    build_q_table(tab, q1);
    // Montgomery's simultaneous inversion of the Z of Q..15Q
    // (limbs9.inv_mont_many): one inversion + 3*14 multiplies.  A zero
    // Z (invalid key) zeroes the whole lane's table.
    Fe prefix[15];
    prefix[0] = tab[1].z;
#pragma unroll 1
    for (int i = 1; i < 15; ++i) prefix[i] = fe_mul(prefix[i - 1], tab[i + 1].z);
    Fe running = fe_inv(prefix[14]);
    Fe zinv[15];
#pragma unroll 1
    for (int i = 14; i > 0; --i) {
        zinv[i] = fe_mul(running, prefix[i - 1]);
        running = fe_mul(running, tab[i + 1].z);
    }
    zinv[0] = running;
    Aff aff[15];
#pragma unroll 1
    for (int i = 0; i < 15; ++i) {
        aff[i].x = fe_mul(tab[i + 1].x, zinv[i]);
        aff[i].y = fe_mul(tab[i + 1].y, zinv[i]);
    }
    Pt acc = point_infinity();
#pragma unroll 1
    for (int w = 0; w < 64; ++w) {
#pragma unroll 1
        for (int d = 0; d < 4; ++d) acc = point_double(acc);
        // zero windows keep the accumulator (the affine tables have no
        // infinity row), as the plain ladder's select does
        const int i2 = u2w[(std::size_t)w * n + lane] & 15;
        if (i2 != 0) acc = point_add_mixed(acc, aff[i2 - 1]);
        const int i1 = u1w[(std::size_t)w * n + lane] & 15;
        if (i1 != 0) {
            Aff g;
            g.x = gtab[(i1 - 1) * 2 + 0];
            g.y = gtab[(i1 - 1) * 2 + 1];
            acc = point_add_mixed(acc, g);
        }
    }
    store_from_mont(X, acc.x, lane, n);
    store_from_mont(Y, acc.y, lane, n);
    store_from_mont(Z, acc.z, lane, n);
}

}  // namespace

#ifdef __CUDACC__

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) ladder_projective_kernel(
        const int32_t* __restrict__ u1w, const int32_t* __restrict__ u2w,
        const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
        const uint32_t* __restrict__ gtab, uint32_t* __restrict__ X,
        uint32_t* __restrict__ Y, uint32_t* __restrict__ Z, int n) {
    __shared__ Fe sg[16 * 3];
    uint32_t* sgw = reinterpret_cast<uint32_t*>(sg);
    for (int i = threadIdx.x; i < 16 * 3 * 8; i += blockDim.x) sgw[i] = gtab[i];
    __syncthreads();
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    ladder_projective_lane(lane, n, u1w, u2w, qx, qy, sg, X, Y, Z);
}

__global__ void __launch_bounds__(kThreads) ladder_mixed_kernel(
        const int32_t* __restrict__ u1w, const int32_t* __restrict__ u2w,
        const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
        const uint32_t* __restrict__ gtab, uint32_t* __restrict__ X,
        uint32_t* __restrict__ Y, uint32_t* __restrict__ Z, int n) {
    __shared__ Fe sg[15 * 2];
    uint32_t* sgw = reinterpret_cast<uint32_t*>(sg);
    for (int i = threadIdx.x; i < 15 * 2 * 8; i += blockDim.x) sgw[i] = gtab[i];
    __syncthreads();
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    ladder_mixed_lane(lane, n, u1w, u2w, qx, qy, sg, X, Y, Z);
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
    const dim3 grid((n + kThreads - 1) / kThreads);
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const auto* a = static_cast<const int32_t*>(u1w);
    const auto* b = static_cast<const int32_t*>(u2w);
    const auto* x = static_cast<const uint32_t*>(qx);
    const auto* y = static_cast<const uint32_t*>(qy);
    const auto* g = static_cast<const uint32_t*>(gtab);
    if (mixed) {
        ladder_mixed_kernel<<<grid, kThreads, 0, s>>>(
            a, b, x, y, g, static_cast<uint32_t*>(X), static_cast<uint32_t*>(Y),
            static_cast<uint32_t*>(Z), n);
    } else {
        ladder_projective_kernel<<<grid, kThreads, 0, s>>>(
            a, b, x, y, g, static_cast<uint32_t*>(X), static_cast<uint32_t*>(Y),
            static_cast<uint32_t*>(Z), n);
    }
    return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
