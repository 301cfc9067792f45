// PANOC's direction and candidates, one launch per masked iteration: for
// every lane the projected step, the L-BFGS two-loop recursion on the free
// coordinates, the trust cap and the candidate fan's inputs.
//
// Replaces no TPU kernel: the JAX package computes this block
// (mpc_tpu/solver/panoc.py:241-281, the two-loop at :89-110) in jnp, which
// XLA fuses into its while-loop body. In eager PyTorch the same block is
// some 340 small launches a trip at L-BFGS memory 12 (about 23 per ring
// slot: the gathers S[lanes, i], the ring arithmetic, two dots and the
// masked updates), plus about 18 to stack the candidates; on the H100 the
// host issued them slower than the card ran them, and the card sat idle.
// Same mathematics as the plain PyTorch version
// mpc_tpu_torch/solver/panoc.py:direction_reference, the CPU path and the
// oracle this kernel is held to.
//
// Per lane b, in float32 (fw and friends are (n,) vectors):
//   fw = u - gamma g; u_hat = clamp(fw, lo, hi); r = u - u_hat;
//   rn2 = r.r; crit = sqrt(rn2) / gamma; free = lo < fw < hi;
//   q = r * fmask; two-loop over the ring newest to oldest, slot
//   i = (head - 1 - j) mod M, masked by valid; q *= h0 (the newest slot's
//   s.y / y.y); back oldest to newest; d_free = -q;
//   d = free ? d_free * min(cap / max(|d_free|, 1e-30), 1) : -r with
//   cap = tr_mult sqrt(rn2);
//   cands[b, 0] = u_hat, cands[b, 1 + k] = u - (1 - tau_k) r + tau_k d.
// Every elementwise operation rounds as PyTorch's separate kernels do
// (-fmad=false, the operands in the plain version's order; torch.clamp's
// NaN propagation, not fminf/fmaxf, which drop a NaN). The dots sum in
// another order than torch's reductions, so a dot, and what follows from
// it, may differ from the plain version in the last bits.
//
// What bounds it on an H100: bytes. A lane reads its ring S, Y (M x n
// each), rho and valid (M), u and g (n), gamma and head, and writes
// (2 + T) n + 2 + n floats (T taus); its operations are about 8 M n. At
// the cells' shapes (B = 16,384, n = 24, M = 12; B = 32,768, n = 40,
// M = 20) the ring is 37.7 and 210 MB: about 11 and 63 us at 3.35 TB/s.
// But the two-loop is a chain of 2 M dependent dots per lane.
//
// What the design does about it:
// - one warp per lane, each thread holding K = ceil(n / 32) coordinates in
//   registers (K = 1 to 4, a template instance each), so a dot is K
//   multiply-adds per thread and a 5-step shuffle tree;
// - the tree is a butterfly (__shfl_xor_sync), which gives every thread of
//   the warp the same sum, in a fixed order: the same inputs give the same
//   bits;
// - the lane's whole ring is staged into shared memory first (16-byte
//   loads), every load independent of the recursion, so the warp pays the
//   memory latency once and both loops read the ring from shared memory:
//   one pass over the ring in device memory. The entry takes only rings
//   that fit the 48 KB a block has without opting in (M n <= 6144, the
//   port's largest is 40 x 128 = 5120) and whose floats come in fours;
// - the per-slot scalars a_j, rho_j and valid_j live in registers,
//   distributed over the warp (thread j mod 32 holds slot j in its register
//   j / 32) and fetched by a shuffle: M is bounded by 2 x 32 = PD_MAX_M;
// - the lanes of a block are independent warps: a warp past the batch
//   returns at once and no block-wide barrier is needed.
// Measured on the H100 (PERF.md, P1): 28-39% of the byte bound at the
// cells' shapes, and a variant that read the ring from device memory in
// place of shared memory timed the same, so the bytes are not what bounds
// it. Likelier it is the instructions issued: a lane's scalar work (slot
// indices, shuffles, the recursion's scalars) runs in all 32 threads of
// its warp, a quarter of which hold no coordinate at n = 24.
//
// Build (no PyTorch headers, a plain C entry point bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libpanoc_direction.so panoc_direction.cu

#include <cuda_runtime.h>

#define PD_MAX_M 64          // ring slots: 2 registers a thread per scalar
#define PD_MAX_N 128         // coordinates: K = ceil(n / 32) <= 4 a thread
#define PD_MAX_TAUS 8
#define PD_MAX_LANES 8       // lanes (warps) per block
#define PD_SMEM_BYTES (48 * 1024)
#define PD_MAX_RING (PD_SMEM_BYTES / (2 * sizeof(float)))  // M n: one lane

constexpr unsigned FULL = 0xffffffffu;

struct Taus {
    int count;
    float one_minus[PD_MAX_TAUS];   // (float)(1.0 - tau), as PyTorch rounds it
    float tau[PD_MAX_TAUS];
};

// torch.clamp(v, lo, hi) on the card: a NaN operand is returned as it is
// (v != v: NaN, the build has no fast math)
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
    if (v != v) return v;
    if (lo != lo) return lo;
    if (hi != hi) return hi;
    return fminf(fmaxf(v, lo), hi);
}

// torch.clamp(v, min=lo) and torch.clamp(v, max=hi)
__device__ __forceinline__ float clamp_min_t(float v, float lo) {
    return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max_t(float v, float hi) {
    return v != v ? v : fminf(v, hi);
}

// the warp's sum, the same bits in every thread
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    return v;
}

// slot j's scalar, held by thread j mod 32 in r0 (j < 32) or r1
__device__ __forceinline__ float slot_f(float r0, float r1, int j) {
    return __shfl_sync(FULL, j < 32 ? r0 : r1, j & 31);
}

template <int K>
__global__ void __launch_bounds__(PD_MAX_LANES * 32)
panoc_direction_kernel(const float* __restrict__ u, const float* __restrict__ g,
                       const float* __restrict__ gamma,
                       const float* __restrict__ lower,
                       const float* __restrict__ upper,
                       const float* __restrict__ S, const float* __restrict__ Y,
                       const float* __restrict__ rho,
                       const unsigned char* __restrict__ valid,
                       const long long* __restrict__ head,
                       float* __restrict__ cands, float* __restrict__ r_out,
                       float* __restrict__ rn2_out, float* __restrict__ crit_out,
                       float* __restrict__ fmask_out, int B, int n, int M,
                       float tr_mult, Taus taus) {
    extern __shared__ __align__(16) float smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * (blockDim.x >> 5) + warp;
    if (b >= B) return;     // the whole warp: nothing below waits on others

    // the lane's ring into shared memory, four floats a load (the entry
    // takes rings of a multiple of 4 floats from 16-byte aligned S and Y)
    const size_t ring = (size_t)M * n;
    float* Sl = smem + (size_t)warp * 2 * ring;
    float* Yl = Sl + ring;
    {
        const float4* S4 =
            reinterpret_cast<const float4*>(S + (size_t)b * ring);
        const float4* Y4 =
            reinterpret_cast<const float4*>(Y + (size_t)b * ring);
        float4* dS = reinterpret_cast<float4*>(Sl);
        float4* dY = reinterpret_cast<float4*>(Yl);
        const size_t r4 = ring >> 2;
#pragma unroll 4
        for (size_t k = lane; k < r4; k += 32) {
            dS[k] = S4[k];
            dY[k] = Y4[k];
        }
    }

    // the ring's per-slot scalars, slot j in thread j mod 32
    const float* rb = rho + (size_t)b * M;
    const unsigned char* vb = valid + (size_t)b * M;
    float rho0 = 0.f, rho1 = 0.f, val0 = 0.f, val1 = 0.f;
    if (lane < M) {
        rho0 = rb[lane];
        val0 = vb[lane] ? 1.f : 0.f;
    }
    if (lane + 32 < M) {
        rho1 = rb[lane + 32];
        val1 = vb[lane + 32] ? 1.f : 0.f;
    }
    long long hm = head[b] % M;
    if (hm < 0) hm += M;
    const int h = (int)hm;
    const float gm = gamma[b];

    // 1. the projected step, the residual, the criterion and the free mask
    const size_t row = (size_t)b * n;
    const int T = taus.count;
    float* cb = cands + (size_t)b * (T + 1) * n;
    float uu[K], r[K], q[K], fm[K];
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int c = lane + 32 * k;
        uu[k] = r[k] = q[k] = fm[k] = 0.f;
        if (c < n) {
            const float lo = lower[c], hi = upper[c];
            const float fw = u[row + c] - gm * g[row + c];
            const float uh = clamp_t(fw, lo, hi);
            uu[k] = u[row + c];
            r[k] = uu[k] - uh;
            fm[k] = (fw > lo && fw < hi) ? 1.f : 0.f;
            q[k] = r[k] * fm[k];
            part += r[k] * r[k];
            cb[c] = uh;
            r_out[row + c] = r[k];
            fmask_out[row + c] = fm[k];
        }
    }
    const float rn2 = warp_sum(part);
    if (lane == 0) {
        rn2_out[b] = rn2;
        crit_out[b] = sqrtf(rn2) / gm;
    }
    __syncwarp();

    // 2. the two-loop recursion: newest to oldest ...
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < M; ++j) {
        const int i = ((h - 1 - j) % M + M) % M;
        const float mf = slot_f(val0, val1, i);
        const float rh = slot_f(rho0, rho1, i);
        const float* s = Sl + (size_t)i * n;
        const float* y = Yl + (size_t)i * n;
        float p = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int c = lane + 32 * k;
            if (c < n) p += s[c] * q[k];
        }
        const float dot = warp_sum(p);
        const float a = mf != 0.f ? rh * dot : 0.f;
        const float am = a * mf;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int c = lane + 32 * k;
            if (c < n) q[k] = q[k] - am * y[c];
        }
        if (lane == (j & 31)) {
            if (j < 32) a0 = a;
            else a1 = a;
        }
    }

    // ... the initial scaling from the newest slot ...
    {
        const int i0 = ((h - 1) % M + M) % M;
        const float* s = Sl + (size_t)i0 * n;
        const float* y = Yl + (size_t)i0 * n;
        float pyy = 0.f, psy = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int c = lane + 32 * k;
            if (c < n) {
                pyy += y[c] * y[c];
                psy += s[c] * y[c];
            }
        }
        const float yy = warp_sum(pyy), sy = warp_sum(psy);
        const float h0 = (slot_f(val0, val1, i0) != 0.f && yy > 0.f)
                             ? sy / clamp_min_t(yy, 1e-30f)
                             : 1.f;
#pragma unroll
        for (int k = 0; k < K; ++k)
            if (lane + 32 * k < n) q[k] = q[k] * h0;
    }

    // ... and back, oldest to newest
    for (int j = M - 1; j >= 0; --j) {
        const int i = ((h - 1 - j) % M + M) % M;
        const float mf = slot_f(val0, val1, i);
        const float rh = slot_f(rho0, rho1, i);
        const float a = slot_f(a0, a1, j);
        const float* s = Sl + (size_t)i * n;
        const float* y = Yl + (size_t)i * n;
        float p = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int c = lane + 32 * k;
            if (c < n) p += y[c] * q[k];
        }
        const float dot = warp_sum(p);
        const float bb = mf != 0.f ? rh * dot : 0.f;
        const float coef = (a - bb) * mf;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int c = lane + 32 * k;
            if (c < n) q[k] = q[k] + coef * s[c];
        }
    }

    // 3. the trust cap and the direction (d_free = -q)
    float pdn = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        if (lane + 32 * k < n) {
            const float df = -q[k];
            pdn += df * df;
        }
    }
    const float dn = sqrtf(warp_sum(pdn));
    const float cap = tr_mult * sqrtf(rn2);
    const float scale = clamp_max_t(cap / clamp_min_t(dn, 1e-30f), 1.f);

    // 4. the candidates after u_hat
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int c = lane + 32 * k;
        if (c < n) {
            const float d = fm[k] != 0.f ? -q[k] * scale : -r[k];
#pragma unroll
            for (int t = 0; t < PD_MAX_TAUS; ++t)
                if (t < T)
                    cb[(size_t)(t + 1) * n + c] =
                        (uu[k] - taus.one_minus[t] * r[k]) + taus.tau[t] * d;
        }
    }
}

// ---------------------------------------------------------------------------
// Launcher
// ---------------------------------------------------------------------------

// Lanes per block: the largest L <= PD_MAX_LANES, a power of 2, whose L
// rings (S and Y) fit PD_SMEM_BYTES; the entry takes no ring that does not
// fit alone.
static int pd_lanes(int n, int M) {
    const size_t ring_bytes = (size_t)2 * M * n * sizeof(float);
    int L = PD_MAX_LANES;
    while (L > 1 && (size_t)L * ring_bytes > PD_SMEM_BYTES) L /= 2;
    return L;
}

template <int K>
static int launch(const float* u, const float* g, const float* gamma,
                  const float* lower, const float* upper, const float* S,
                  const float* Y, const float* rho, const unsigned char* valid,
                  const long long* head, float* cands, float* r, float* rn2,
                  float* crit, float* fmask, int B, int n, int M,
                  float tr_mult, const Taus& taus, void* stream) {
    const int L = pd_lanes(n, M);
    const size_t smem = (size_t)L * 2 * M * n * sizeof(float);
    const int grid = (B + L - 1) / L;
    // the most shared memory an SM can give, so that the staged rings do
    // not cap the blocks an SM holds (the default left the kinematic
    // cell's kernel 17% slower on the H100)
    static bool carveout = false;
    if (!carveout) {
        const int rc = (int)cudaFuncSetAttribute(
            panoc_direction_kernel<K>,
            cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
        if (rc != 0) return rc;
        carveout = true;
    }
    panoc_direction_kernel<K><<<grid, L * 32, smem, (cudaStream_t)stream>>>(
        u, g, gamma, lower, upper, S, Y, rho, valid, head, cands, r, rn2,
        crit, fmask, B, n, M, tr_mult, taus);
    return (int)cudaGetLastError();
}

extern "C" {

// Launch on ``stream``. Device pointers to contiguous arrays: u, g (B, n),
// gamma (B,), lower, upper (n,), S, Y (B, M, n), rho (B, M) float32, valid
// (B, M) bool (one byte), head (B,) int64; outputs cands (B, 1 + n_taus, n),
// r, fmask (B, n), rn2, crit (B,) float32. one_minus[k] = (float)(1 - tau_k)
// and tau[k] for the n_taus taus. Returns the cudaError_t of the launch.
// The kernel's limits, stated here alone: 1 <= n <= PD_MAX_N, 1 <= M <=
// PD_MAX_M, M n <= PD_MAX_RING and a multiple of 4, S and Y 16-byte
// aligned, B >= 1, 0 <= n_taus <= PD_MAX_TAUS; outside them it launches
// nothing and returns cudaErrorInvalidValue.
int mpc_panoc_direction(const float* u, const float* g, const float* gamma,
                        const float* lower, const float* upper, const float* S,
                        const float* Y, const float* rho,
                        const unsigned char* valid, const long long* head,
                        float* cands, float* r, float* rn2, float* crit,
                        float* fmask, int B, int n, int M, float tr_mult,
                        const float* one_minus, const float* tau, int n_taus,
                        void* stream) {
    const size_t ring = (size_t)M * n;
    if (B < 1 || n < 1 || n > PD_MAX_N || M < 1 || M > PD_MAX_M ||
        ring > PD_MAX_RING || (ring & 3) != 0 ||
        ((reinterpret_cast<size_t>(S) | reinterpret_cast<size_t>(Y)) & 15) ||
        n_taus < 0 || n_taus > PD_MAX_TAUS)
        return (int)cudaErrorInvalidValue;
    Taus t;
    t.count = n_taus;
    for (int k = 0; k < PD_MAX_TAUS; ++k) {
        t.one_minus[k] = k < n_taus ? one_minus[k] : 0.f;
        t.tau[k] = k < n_taus ? tau[k] : 0.f;
    }
#define PD_ARGS u, g, gamma, lower, upper, S, Y, rho, valid, head, cands, r, \
                rn2, crit, fmask, B, n, M, tr_mult, t, stream
    const int K = (n + 31) / 32;
    if (K <= 1) return launch<1>(PD_ARGS);
    if (K <= 2) return launch<2>(PD_ARGS);
    if (K <= 3) return launch<3>(PD_ARGS);
    return launch<4>(PD_ARGS);
#undef PD_ARGS
}

}  // extern "C"
