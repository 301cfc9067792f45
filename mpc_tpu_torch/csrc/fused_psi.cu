// Fused PANOC candidate fan for the vehicle OCP: value and gradient of the
// N-stage tracking cost at E independent evaluation lanes.
//
// Replaces: mpc_tpu/ops/fused_psi.py:_eval_pallas (the TPU Pallas kernel,
// K1: model="pacejka", no augmented-Lagrangian term). Same mathematics as
// the plain PyTorch version mpc_tpu_torch/ops/fused_psi.py:
// fan_value_and_grad_reference, and the same algorithm as the batched
// transcription _fan_adjoint_transcription, which the CPU tests hold
// against autograd.
//
// What bounds it on an H100: latency and registers, not bytes. Each lane
// reads 2N + 6 floats and writes 2N + 1, but runs a strictly sequential
// chain: N stages x substeps x 4 Pacejka ODE evaluations forward (each with
// two atan2f, two atanf and six sin/cos), an argmin over S-1 centerline
// points per stage, then a reverse sweep that recomputes every substep and
// pulls the adjoint back through it. There is no data reuse across lanes
// apart from the centerline table and the parameters, and no matrix product
// anywhere, so tensor cores and bandwidth are irrelevant.
//
// What this design does about it (the simple version; a later PR tunes it):
// - one thread per evaluation lane, the state in registers; the offsets
//   come from blockIdx and the ragged edge is a bounds check (the Pallas
//   kernel's block_e edge padding is dropped);
// - the centerline table (S-1 rows of [nearest, previous, next]) and the
//   24-float parameter vector are loaded into shared memory once per block;
// - the gradient is a hand-written adjoint: the forward sweep stores the N
//   stage-start states and argmin indices in per-thread local memory, and
//   the reverse sweep recomputes each stage's RK4 substeps from its start
//   state (keeping the four evaluation points of every substep) instead of
//   storing all 4 * substeps * N intermediate states;
// - small blocks (32 threads) spread the few thousand lanes of the main path
//   over as many SMs as possible.
//
// Numerics: native atan2f/atanf/sinf/cosf (no --use_fast_math: the kernel is
// held to psi rtol 2e-5 and grad rtol 2e-4 against the plain version). The
// forward sweep evaluates every expression in the plain version's order and
// is built with -fmad=false, so each operation rounds as PyTorch's separate
// elementwise kernels do: the states, and with them the nearest-point
// indices, follow the plain version on the card instead of drifting by a few
// ulps and flipping an argmin at a near-tie (a jump in the cost). The argmin
// compares dx*dx + dy*dy with strict <, scanning from index 0, so the first
// index wins a tie as torch.argmin / jnp.argmin do; the index is held
// constant in the reverse sweep (stop_gradient at
// mpc_tpu/ops/fused_psi.py:181). Derivatives: sign(vx) -> 0, wrap_to_pi -> 1,
// speed = sqrt(vx^2 + vy^2).
//
// Build (no PyTorch headers, plain C entry point bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libfused_psi.so fused_psi.cu

#include <cuda_runtime.h>
#include <stddef.h>

#define MAX_N 64        // horizon limit (ops/fused_psi.py KERNEL_MAX_HORIZON)
#define MAX_SUB 8       // RK4 substeps limit (KERNEL_MAX_SUBSTEPS)
#define N_PARAMS 24     // VehicleParams.to_kernel_vec length
#define BLOCK 32

// indices into the parameter vector (models/params.py KERNEL_PARAM_FIELDS)
#define P_AXIS_FRONT 1
#define P_AXIS_REAR 2
#define P_MASS 7
#define P_INERTIA 8
#define P_BF 11
#define P_CF 12
#define P_DF 13
#define P_BR 14
#define P_CR 15
#define P_DR 16
#define P_CM1 17
#define P_CM2 18
#define P_CR0 19
#define P_CR2 21

struct Par {
    float lf, lr, m, iz, bf, cf, df, br, cr, dr, cm1, cm2, cr0, cr2;
};

struct Cfg {
    int n_horiz, n_cl, substeps;
    float hh, h, h6;      // 0.5*h, h, h/6 (rounded from double, as in torch)
    float v_ref;
    float w[6];           // [v, cte, pos_err, heading_err, steer, drive]
};

__device__ __forceinline__ float wrap_to_pi(float a) {
    // floored mod, as jnp.mod / torch.remainder: result in [0, 2pi)
    const float pi = 3.14159265358979323846f;
    const float two_pi = 6.28318530717958647692f;
    float r = fmodf(a + pi, two_pi);
    if (r != 0.f && r < 0.f) r += two_pi;
    return r - pi;
}

// Pacejka single-track ODE: k = f(x, d, delta).
__device__ __forceinline__ void deriv(const float x[6], float d, float dl,
                                      const Par& p, float k[6]) {
    const float phi = x[2], vx = x[3], vy = x[4], om = x[5];
    const float af = -atan2f(om * p.lf + vy, vx) + dl;
    const float ar = atan2f(om * p.lr - vy, vx);
    const float sgn = (float)((vx > 0.f) - (vx < 0.f));
    const float frx = (p.cm1 - p.cm2 * vx) * d - p.cr0 * sgn - p.cr2 * vx * vx;
    const float ffy = p.df * sinf(p.cf * atanf(p.bf * af));
    const float fry = p.dr * sinf(p.cr * atanf(p.br * ar));
    const float cphi = cosf(phi), sphi = sinf(phi);
    const float cd = cosf(dl), sd = sinf(dl);
    k[0] = vx * cphi - vy * sphi;
    k[1] = vx * sphi + vy * cphi;
    k[2] = om;
    k[3] = (frx - ffy * sd + p.m * vy * om) / p.m;
    k[4] = (fry + ffy * cd - p.m * vx * om) / p.m;
    k[5] = (ffy * p.lf * cd - fry * p.lr) / p.iz;
}

// Pull the cotangent mu back through f at (x, d, delta): g += J_x^T mu,
// gd += df/dd . mu, gdl += df/ddelta . mu. Mirrors _pacejka_vjp.
__device__ __forceinline__ void deriv_vjp(const float x[6], float d, float dl,
                                          const Par& p, const float mu[6],
                                          float g[6], float& gd, float& gdl) {
    const float phi = x[2], vx = x[3], vy = x[4], w = x[5];
    const float a1 = w * p.lf + vy;
    const float a2 = w * p.lr - vy;
    const float af = -atan2f(a1, vx) + dl;
    const float ar = atan2f(a2, vx);
    const float bfa = p.bf * af;
    const float bra = p.br * ar;
    const float ta_f = atanf(bfa);
    const float ta_r = atanf(bra);
    const float ffy = p.df * sinf(p.cf * ta_f);
    const float cphi = cosf(phi), sphi = sinf(phi);
    const float cd = cosf(dl), sd = sinf(dl);

    const float q3 = mu[3] / p.m, q4 = mu[4] / p.m, q5 = mu[5] / p.iz;
    float g_phi = mu[0] * (-vx * sphi - vy * cphi) + mu[1] * (vx * cphi - vy * sphi);
    float g_vx = mu[0] * cphi + mu[1] * sphi;
    float g_vy = -mu[0] * sphi + mu[1] * cphi;
    float g_w = mu[2];
    const float g_frx = q3;
    const float g_ffy = -q3 * sd + q4 * cd + q5 * p.lf * cd;
    const float g_fry = q4 - q5 * p.lr;
    g_vy += q3 * p.m * w;
    g_w += q3 * p.m * vy - q4 * p.m * vx;
    g_vx -= q4 * p.m * w;
    float g_dl = -ffy * (q3 * cd + q4 * sd + q5 * p.lf * sd);
    const float g_d = g_frx * (p.cm1 - p.cm2 * vx);
    g_vx += g_frx * (-p.cm2 * d - 2.f * p.cr2 * vx);
    const float g_af = g_ffy * p.df * cosf(p.cf * ta_f) * p.cf * p.bf / (1.f + bfa * bfa);
    const float g_ar = g_fry * p.dr * cosf(p.cr * ta_r) * p.cr * p.br / (1.f + bra * bra);
    const float r1 = vx * vx + a1 * a1;
    const float r2 = vx * vx + a2 * a2;
    g_dl += g_af;
    const float g_a1 = -g_af * vx / r1;
    g_vx += g_af * a1 / r1;
    const float g_a2 = g_ar * vx / r2;
    g_vx -= g_ar * a2 / r2;
    g_w += g_a1 * p.lf + g_a2 * p.lr;
    g_vy += g_a1 - g_a2;

    g[2] += g_phi;
    g[3] += g_vx;
    g[4] += g_vy;
    g[5] += g_w;
    gd += g_d;
    gdl += g_dl;
}

// One classical RK4 step in place.
__device__ __forceinline__ void rk4_step(float x[6], float d, float dl,
                                         const Par& p, const Cfg& c) {
    float k1[6], k2[6], k3[6], k4[6], t[6];
    deriv(x, d, dl, p, k1);
#pragma unroll
    for (int i = 0; i < 6; ++i) t[i] = x[i] + c.hh * k1[i];
    deriv(t, d, dl, p, k2);
#pragma unroll
    for (int i = 0; i < 6; ++i) t[i] = x[i] + c.hh * k2[i];
    deriv(t, d, dl, p, k3);
#pragma unroll
    for (int i = 0; i < 6; ++i) t[i] = x[i] + c.h * k3[i];
    deriv(t, d, dl, p, k4);
#pragma unroll
    for (int i = 0; i < 6; ++i)
        x[i] = x[i] + c.h6 * (k1[i] + 2.f * k2[i] + 2.f * k3[i] + k4[i]);
}

// Nearest centerline candidate: first index wins a tie.
__device__ __forceinline__ int nearest(float px, float py, const float* cl,
                                       int n_cl) {
    float best = __int_as_float(0x7f800000);  // +inf
    int idx = 0;
    for (int j = 0; j < n_cl; ++j) {
        const float dx = px - cl[6 * j + 0];
        const float dy = py - cl[6 * j + 1];
        const float d2 = dx * dx + dy * dy;
        if (d2 < best) {
            best = d2;
            idx = j;
        }
    }
    return idx;
}

// Stage cost at the state after the stage; row = [nx, ny, pvx, pvy, nxx, nxy].
// With g != nullptr, also g += dL/dx, gd += dL/dd, gdl += dL/ddelta.
__device__ __forceinline__ float stage_cost(const float x[6], float d, float dl,
                                            const float* row, const Cfg& c,
                                            float* g, float* gd, float* gdl) {
    const float px = x[0], py = x[1], phi = x[2], vx = x[3], vy = x[4];
    const float nx = row[0], ny = row[1], pvx = row[2], pvy = row[3];
    const float nxx = row[4], nxy = row[5];
    const float cte = (px - pvx) * (ny - pvy) - (py - pvy) * (nx - pvx);
    const float desired = atan2f(nxy - ny, nxx - nx);
    const float he = wrap_to_pi(desired - phi);
    const float pe = (px - nx) * (nxy - ny) - (py - ny) * (nxx - nx);
    const float speed = sqrtf(vx * vx + vy * vy);
    const float sv = speed - c.v_ref;
    if (g != nullptr) {
        const float c_cte = 2.f * c.w[1] * cte;
        const float c_pe = 2.f * c.w[2] * pe;
        g[0] += c_cte * (ny - pvy) + c_pe * (nxy - ny);
        g[1] += -c_cte * (nx - pvx) - c_pe * (nxx - nx);
        g[2] += -2.f * c.w[3] * he;
        const float gs = 2.f * c.w[0] * sv / speed;
        g[3] += gs * vx;
        g[4] += gs * vy;
        *gd += 2.f * c.w[5] * d;
        *gdl += 2.f * c.w[4] * dl;
    }
    // each square rounded before its weight, as c[i] * t ** 2 in torch
    return c.w[0] * (sv * sv) + c.w[1] * (cte * cte) + c.w[2] * (pe * pe)
        + c.w[3] * (he * he) + c.w[4] * (dl * dl) + c.w[5] * (d * d);
}

__global__ void __launch_bounds__(BLOCK)
fused_psi_fan_kernel(const float* __restrict__ u, const float* __restrict__ y0,
                     const float* __restrict__ cltab,
                     const float* __restrict__ pvec, float* __restrict__ psi,
                     float* __restrict__ grad, int E, Cfg c) {
    extern __shared__ float smem[];
    float* s_cl = smem;                   // n_cl * 6
    float* s_p = smem + c.n_cl * 6;       // N_PARAMS
    for (int i = threadIdx.x; i < c.n_cl * 6; i += blockDim.x) s_cl[i] = cltab[i];
    for (int i = threadIdx.x; i < N_PARAMS; i += blockDim.x) s_p[i] = pvec[i];
    __syncthreads();

    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= E) return;

    Par p;
    p.lf = s_p[P_AXIS_FRONT];
    p.lr = s_p[P_AXIS_REAR];
    p.m = s_p[P_MASS];
    p.iz = s_p[P_INERTIA];
    p.bf = s_p[P_BF];
    p.cf = s_p[P_CF];
    p.df = s_p[P_DF];
    p.br = s_p[P_BR];
    p.cr = s_p[P_CR];
    p.dr = s_p[P_DR];
    p.cm1 = s_p[P_CM1];
    p.cm2 = s_p[P_CM2];
    p.cr0 = s_p[P_CR0];
    p.cr2 = s_p[P_CR2];

    const int n = 2 * c.n_horiz;
    const float* ue = u + (size_t)e * n;
    float* ge = grad + (size_t)e * n;

    // ---- forward sweep: stage-start states, argmin indices, psi ----------
    float starts[MAX_N][6];
    int idx[MAX_N];
    float x[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) x[i] = y0[(size_t)e * 6 + i];
    float tot = 0.f;
    for (int k = 0; k < c.n_horiz; ++k) {
        const float d = ue[2 * k], dl = ue[2 * k + 1];
#pragma unroll
        for (int i = 0; i < 6; ++i) starts[k][i] = x[i];
        for (int s = 0; s < c.substeps; ++s) rk4_step(x, d, dl, p, c);
        const int j = nearest(x[0], x[1], s_cl, c.n_cl);
        idx[k] = j;
        tot += stage_cost(x, d, dl, s_cl + 6 * j, c, nullptr, nullptr, nullptr);
    }
    psi[e] = tot;

    // ---- reverse sweep -----------------------------------------------------
    float lam[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = c.n_horiz - 1; k >= 0; --k) {
        const float d = ue[2 * k], dl = ue[2 * k + 1];
        // recompute the stage, keeping the 4 evaluation points of each substep
        float pts[MAX_SUB][4][6];
        float xs[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) xs[i] = starts[k][i];
        for (int s = 0; s < c.substeps; ++s) {
            float k1[6], k2[6], k3[6], k4[6];
#pragma unroll
            for (int i = 0; i < 6; ++i) pts[s][0][i] = xs[i];
            deriv(xs, d, dl, p, k1);
#pragma unroll
            for (int i = 0; i < 6; ++i) pts[s][1][i] = xs[i] + c.hh * k1[i];
            deriv(pts[s][1], d, dl, p, k2);
#pragma unroll
            for (int i = 0; i < 6; ++i) pts[s][2][i] = xs[i] + c.hh * k2[i];
            deriv(pts[s][2], d, dl, p, k3);
#pragma unroll
            for (int i = 0; i < 6; ++i) pts[s][3][i] = xs[i] + c.h * k3[i];
            deriv(pts[s][3], d, dl, p, k4);
#pragma unroll
            for (int i = 0; i < 6; ++i)
                xs[i] = xs[i] + c.h6 * (k1[i] + 2.f * k2[i] + 2.f * k3[i] + k4[i]);
        }
        float gd = 0.f, gdl = 0.f;
        stage_cost(xs, d, dl, s_cl + 6 * idx[k], c, lam, &gd, &gdl);

        for (int s = c.substeps - 1; s >= 0; --s) {
            // x_out = x + h/6 (k1 + 2 k2 + 2 k3 + k4), k_i = f(point_i)
            float lk1[6], lk2[6], lk3[6], lk4[6], lx[6], gx[6];
#pragma unroll
            for (int i = 0; i < 6; ++i) {
                lk1[i] = c.h6 * lam[i];
                lk4[i] = lk1[i];
                lk2[i] = 2.f * lk1[i];
                lk3[i] = lk2[i];
                lx[i] = lam[i];
            }
            // k4 = f(x4), x4 = x + h k3
#pragma unroll
            for (int i = 0; i < 6; ++i) gx[i] = 0.f;
            deriv_vjp(pts[s][3], d, dl, p, lk4, gx, gd, gdl);
#pragma unroll
            for (int i = 0; i < 6; ++i) { lx[i] += gx[i]; lk3[i] += c.h * gx[i]; }
            // k3 = f(x3), x3 = x + h/2 k2
#pragma unroll
            for (int i = 0; i < 6; ++i) gx[i] = 0.f;
            deriv_vjp(pts[s][2], d, dl, p, lk3, gx, gd, gdl);
#pragma unroll
            for (int i = 0; i < 6; ++i) { lx[i] += gx[i]; lk2[i] += c.hh * gx[i]; }
            // k2 = f(x2), x2 = x + h/2 k1
#pragma unroll
            for (int i = 0; i < 6; ++i) gx[i] = 0.f;
            deriv_vjp(pts[s][1], d, dl, p, lk2, gx, gd, gdl);
#pragma unroll
            for (int i = 0; i < 6; ++i) { lx[i] += gx[i]; lk1[i] += c.hh * gx[i]; }
            // k1 = f(x)
#pragma unroll
            for (int i = 0; i < 6; ++i) gx[i] = 0.f;
            deriv_vjp(pts[s][0], d, dl, p, lk1, gx, gd, gdl);
#pragma unroll
            for (int i = 0; i < 6; ++i) lam[i] = lx[i] + gx[i];
        }
        ge[2 * k] = gd;
        ge[2 * k + 1] = gdl;
    }
}

extern "C" {

// Launch the fan on ``stream``. Pointers are device pointers to contiguous
// float32 arrays: u (E, 2*n_horiz), y0 (E, 6), cltab (n_cl, 6), pvec (24,),
// psi (E,), grad (E, 2*n_horiz). Returns the cudaError_t of the launch.
int mpc_fused_psi_fan(const float* u, const float* y0, const float* cltab,
                      const float* pvec, float* psi, float* grad, int E,
                      int n_horiz, int n_cl, int substeps, double h,
                      float v_ref, float w0, float w1, float w2, float w3,
                      float w4, float w5, void* stream) {
    if (E <= 0 || n_horiz < 1 || n_horiz > MAX_N || substeps < 1 ||
        substeps > MAX_SUB || n_cl < 1)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(n_cl * 6 + N_PARAMS) * sizeof(float);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    Cfg c;
    c.n_horiz = n_horiz;
    c.n_cl = n_cl;
    c.substeps = substeps;
    c.hh = (float)(0.5 * h);
    c.h = (float)h;
    c.h6 = (float)(h / 6.0);
    c.v_ref = v_ref;
    c.w[0] = w0;
    c.w[1] = w1;
    c.w[2] = w2;
    c.w[3] = w3;
    c.w[4] = w4;
    c.w[5] = w5;
    const int grid = (E + BLOCK - 1) / BLOCK;
    fused_psi_fan_kernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
        u, y0, cltab, pvec, psi, grad, E, c);
    return (int)cudaGetLastError();
}

}  // extern "C"
