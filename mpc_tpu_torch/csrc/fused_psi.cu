// Fused PANOC candidate fan for the vehicle OCP: value and gradient of the
// N-stage tracking cost at E independent evaluation lanes.
//
// Replaces: mpc_tpu/ops/fused_psi.py:_eval_pallas (the TPU Pallas kernel) in
// its three variants, K1 and K2 instances of the phased kernel
// fused_psi_fan_phased<model>, K3 the same algorithm in three kernels
// that hand on through a device scratch (fused_psi_fan_rollout, _stages,
// _adjoint; see "K3 through a device scratch" below):
//   K1  model="pacejka", no augmented-Lagrangian term   (mpc_fused_psi_fan)
//   K2  model="simplified", the kinematic bicycle        (mpc_fused_psi_fan_kin)
//   K3  model="pacejka" with the AL term of the bounded  (mpc_fused_psi_fan_al)
//       state constraints, reached through make_vehicle_al_multi
// K1 also takes one road per scenario ("K1 roads"): the same instance with
// a runtime road stride K > 0, where lane e reads road e / K of an
// (R, n_cl, 6) table stack (the K candidates of a scenario are adjacent
// lanes). Stride 0 is the one shared road.
// Same mathematics as the plain PyTorch version mpc_tpu_torch/ops/
// fused_psi.py:fan_value_and_grad_reference; the algorithm is the batched
// transcription _fan_phased_transcription, held against autograd on the CPU.
//
// What bounds it on an H100: latency, not bytes or operations. Each lane
// reads 2N + sd floats (and, for K3, 2 sd N multipliers and penalties) and
// writes 2N + 1; its work is a few hundred thousand operations, most of them
// in transcendental functions. But a lane's forward rollout is a chain of
// N x substeps x 4 dependent ODE evaluations, and the few thousand lanes of
// the main path fill only a few warps per SM. There is no data reuse across
// lanes apart from the centerline table, the parameters and K3's constraint
// bounds, and no matrix product, so tensor cores are irrelevant.
//
// What the phased design does about it (K3 runs the same three phases as
// three kernels, below). One block holds L lanes (L picked by the launcher
// so that the grid has at least one block per SM) and PH_THREADS threads,
// and runs three phases, with everything a phase hands on in dynamic shared
// memory:
// 1. one thread per lane rolls out the states and stores the N + 1 stage
//    boundary states, nothing else: this is the only chain that is serial
//    by nature. The model's per-stage constants (M::Stage: cos and sin of
//    the steering for Pacejka; the slip angle beta, its sine, cosine and
//    d beta / d delta for the kinematic model) are computed once per stage
//    instead of in each of its 4 x substeps evaluations;
// 2. all threads of the block, over the block's (lane, stage) pairs, each
//    independent given the stored states: from the stage's end state the
//    nearest centerline point, the stage cost, its state gradient and, in
//    K3, the penalties and their gradient sigma r 2 x_i; from its start
//    state the stage recomputed with its Jacobian in forward mode: the
//    derivatives of the end state along sd columns, the start state's
//    components 2 .. sd-1 (Pacejka phi, vx, vy, omega; kinematic phi, v;
//    px and py move the end state one for one and enter nothing else) and
//    the inputs d, delta. Each evaluation point's transcendental terms are
//    computed once (M::point) and applied to all sd columns (M::tangent);
// 3. one thread per lane sums psi in the plain version's order and runs the
//    adjoint, a short linear recursion: with v = lam + g_k,
//    grad_k = B_k^T v + (2 c5 d_k, 2 c4 delta_k) and lam = A_k^T v, from
//    k = N-1 down to 0. The gradient goes out through shared memory in one
//    coalesced pass.
// Above 48 KB of shared memory the launcher opts in to the card's limit.
// The centerline tables a block reads are staged in its shared memory: the
// one shared table, or, at road stride K, the roads e0 / K .. (e0 + L - 1) / K
// of its lanes e0 .. e0 + L - 1, at most (L - 1) / K + 2 of them
// (ph_roads); lane e's table is slot e / K - e0 / K.
//
// Numerics: native atan2f/atanf/tanf/sinf/cosf (no --use_fast_math). Every
// state and every psi term is evaluated in the plain version's operation
// order and the library is built with -fmad=false, so each operation rounds
// as PyTorch's separate elementwise kernels do: the states, and with them
// the nearest-point indices, follow the plain version on the card instead of
// drifting by a few ulps and flipping an argmin at a near-tie (a jump in the
// cost), and psi is bit-identical to it. Tangents and adjoints, where no
// such identity is needed, use explicit fmaf. The argmin compares
// dx*dx + dy*dy with strict <, scanning from index 0, so the first index
// wins a tie as torch.argmin / jnp.argmin do; the index is held constant in
// the gradient (stop_gradient at mpc_tpu/ops/fused_psi.py:181).
// Derivatives: sign(vx) -> 0, wrap_to_pi -> 1, speed = sqrt(vx^2 + vy^2)
// (Pacejka) or |v| with d|v|/dv = sign(v), 0 at 0 (kinematic). The AL clip
// zhat = clip(zeta, d_lo, d_up) propagates NaN as torch.clamp does; its
// gradient enters only through sigma (zeta - zhat), which is 0 wherever the
// clip is inactive or at a tie.
//
// Build (no PyTorch headers, plain C entry points bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libfused_psi.so fused_psi.cu

#include <cuda_runtime.h>
#include <stddef.h>

#define MAX_N 64        // horizon limit (ops/fused_psi.py KERNEL_MAX_HORIZON)
#define N_PARAMS 24     // VehicleParams.to_kernel_vec length
#define PH_THREADS 128  // phased kernel: threads per block
#define PH_MAX_LANES 32 // phased kernel: most lanes per block

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
#define P_FRICTION 22
#define P_ACCELERATION 23

struct Par {
    float lf, lr, m, iz, bf, cf, df, br, cr, dr, cm1, cm2, cr0, cr2, fr, acc;
    float inv_m, inv_iz;  // for tangents only: a state divides by m, iz
};

__device__ __forceinline__ Par load_par(const float* s_p) {
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
    p.fr = s_p[P_FRICTION];
    p.acc = s_p[P_ACCELERATION];
    p.inv_m = 1.f / p.m;
    p.inv_iz = 1.f / p.iz;
    return p;
}

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

// ---- K1 / K3: the Pacejka single-track model, state [x, y, phi, vx, vy, w]
struct Pacejka {
    static constexpr int SD = 6;

    // The stage's constants: cos, sin of its steering delta. Mirrors
    // _pacejka_stage.
    struct Stage {
        float cd, sd;
    };

    static __device__ __forceinline__ Stage stage(float dl, const Par&) {
        return {cosf(dl), sinf(dl)};
    }

    // The ODE at one evaluation point, k = f(x, d, delta), and the partial
    // derivatives its tangents need beside the stage's constants: of ffy
    // (vx, vy, omega, delta), fry (vx, vy, omega) and frx (vx, d). Mirrors
    // _pacejka_point.
    struct Point {
        float k[6];
        float cphi, sphi, vx, vy, om, ffy;
        float f_vx, f_vy, f_om, f_dl, r_vx, r_vy, r_om, x_vx, x_d;
    };

    static __device__ __forceinline__ void point(const float x[6], float d,
                                                 float dl, const Stage& st,
                                                 const Par& p, Point& q) {
        const float cd = st.cd, sd = st.sd;
        const float phi = x[2], vx = x[3], vy = x[4], om = x[5];
        const float a1 = om * p.lf + vy;
        const float a2 = om * p.lr - vy;
        const float af = -atan2f(a1, vx) + dl;
        const float ar = atan2f(a2, vx);
        const float sgn = (float)((vx > 0.f) - (vx < 0.f));
        const float frx = (p.cm1 - p.cm2 * vx) * d - p.cr0 * sgn - p.cr2 * vx * vx;
        const float bfa = p.bf * af, bra = p.br * ar;
        const float ta_f = atanf(bfa), ta_r = atanf(bra);
        const float ffy = p.df * sinf(p.cf * ta_f);
        const float fry = p.dr * sinf(p.cr * ta_r);
        const float cphi = cosf(phi), sphi = sinf(phi);
        q.k[0] = vx * cphi - vy * sphi;
        q.k[1] = vx * sphi + vy * cphi;
        q.k[2] = om;
        q.k[3] = (frx - ffy * sd + p.m * vy * om) / p.m;
        q.k[4] = (fry + ffy * cd - p.m * vx * om) / p.m;
        q.k[5] = (ffy * p.lf * cd - fry * p.lr) / p.iz;
        // the tangents' terms (dead code where only k is used)
        q.cphi = cphi;
        q.sphi = sphi;
        q.vx = vx;
        q.vy = vy;
        q.om = om;
        q.ffy = ffy;
        q.f_dl = p.df * cosf(p.cf * ta_f) * p.cf * p.bf / (1.f + bfa * bfa);
        const float s1 = q.f_dl / (vx * vx + a1 * a1);
        const float s2 = p.dr * cosf(p.cr * ta_r) * p.cr * p.br / (1.f + bra * bra)
            / (vx * vx + a2 * a2);
        q.f_vx = s1 * a1;
        q.f_vy = -s1 * vx;
        q.f_om = q.f_vy * p.lf;
        q.r_vx = -s2 * a2;
        q.r_vy = -s2 * vx;
        q.r_om = -q.r_vy * p.lr;
        q.x_vx = -p.cm2 * d - 2.f * p.cr2 * vx;
        q.x_d = p.cm1 - p.cm2 * vx;
    }

    static __device__ __forceinline__ void deriv(const float x[6], float d,
                                                 float dl, const Stage& st,
                                                 const Par& p, float k[6]) {
        Point q;
        point(x, d, dl, st, p, q);
#pragma unroll
        for (int i = 0; i < 6; ++i) k[i] = q.k[i];
    }

    // dk = derivative of k at q, a point of the stage with constants st,
    // along tangent column j: t = d (phi, vx, vy, omega) of the point;
    // column 4 also moves d by 1, column 5 delta by 1. t[i] enters only
    // where bit i of mask is set: a stage's start tangents are unit and zero
    // columns, and a known 0 must not multiply a coefficient that is 0/0 at
    // a standstill (vx = vy = omega = 0). Mirrors _pacejka_tangent.
    static __device__ __forceinline__ void tangent(const Point& q,
                                                   const Stage& st,
                                                   const Par& p,
                                                   const float t[4], int j,
                                                   int mask, float dk[6]) {
        float tffy = 0.f, tfry = 0.f, tfrx = 0.f;
        float a0 = 0.f, a1 = 0.f, a3 = 0.f, a4 = 0.f;
        if (mask & 1) {
            a0 = -q.k[1] * t[0];
            a1 = q.k[0] * t[0];
        }
        if (mask & 2) {
            tffy = q.f_vx * t[1];
            tfry = q.r_vx * t[1];
            tfrx = q.x_vx * t[1];
            a0 = fmaf(q.cphi, t[1], a0);
            a1 = fmaf(q.sphi, t[1], a1);
            a4 = -q.om * t[1];
        }
        if (mask & 4) {
            tffy = fmaf(q.f_vy, t[2], tffy);
            tfry = fmaf(q.r_vy, t[2], tfry);
            a0 = fmaf(-q.sphi, t[2], a0);
            a1 = fmaf(q.cphi, t[2], a1);
            a3 = q.om * t[2];
        }
        if (mask & 8) {
            tffy = fmaf(q.f_om, t[3], tffy);
            tfry = fmaf(q.r_om, t[3], tfry);
            a3 = fmaf(q.vy, t[3], a3);
            a4 = fmaf(-q.vx, t[3], a4);
        }
        if (j == 4) tfrx += q.x_d;
        if (j == 5) tffy += q.f_dl;
        // k3 = (frx - ffy sd + m vy om) / m, k4 = (fry + ffy cd - m vx om) / m,
        // k5 = (ffy lf cd - fry lr) / iz
        float n3 = fmaf(-st.sd, tffy, tfrx);
        float n4 = fmaf(st.cd, tffy, tfry);
        float n5 = fmaf(p.lf * st.cd, tffy, -p.lr * tfry);
        if (j == 5) {
            n3 = fmaf(-q.ffy, st.cd, n3);
            n4 = fmaf(-q.ffy, st.sd, n4);
            n5 = fmaf(-p.lf * q.ffy, st.sd, n5);
        }
        dk[0] = a0;
        dk[1] = a1;
        dk[2] = (mask & 8) ? t[3] : 0.f;
        dk[3] = fmaf(n3, p.inv_m, a3);
        dk[4] = fmaf(n4, p.inv_m, a4);
        dk[5] = n5 * p.inv_iz;
    }

    static __device__ __forceinline__ float speed(const float x[6]) {
        return sqrtf(x[3] * x[3] + x[4] * x[4]);
    }

    // g += d(w0 (speed - v_ref)^2) / dx, with sv = speed - v_ref
    static __device__ __forceinline__ void speed_grad(const float x[6],
                                                      float w0, float sv,
                                                      float speed, float g[6]) {
        const float gs = 2.f * w0 * sv / speed;
        g[3] += gs * x[3];
        g[4] += gs * x[4];
    }
};

// ---- K2: the kinematic bicycle, state [x, y, phi, v]
struct Kinematic {
    static constexpr int SD = 4;

    // The stage's constants: the slip angle beta = atan2(lf tan(delta),
    // lf + lr), its sine and cosine, and (lf + lr > 0) its derivative
    //   db = d beta / d delta
    //      = lf (lf + lr) (1 + tan^2 delta) / ((lf + lr)^2 + lf^2 tan^2 delta).
    // beta and sin(beta) are the plain version's values, computed once per
    // stage instead of in every evaluation. Mirrors _kinematic_stage.
    struct Stage {
        float beta, sb, cb, db;
    };

    static __device__ __forceinline__ Stage stage(float dl, const Par& p) {
        const float ll = p.lf + p.lr;
        const float t = tanf(dl);
        const float ty = p.lf * t;
        Stage st;
        st.beta = atan2f(ty, ll);
        st.sb = sinf(st.beta);
        st.cb = cosf(st.beta);
        st.db = ll / (ll * ll + ty * ty) * p.lf * (1.f + t * t);
        return st;
    }

    // The ODE at one evaluation point, k = f(x, d, delta), in the plain
    // version's operation order, and the terms its tangents need beside the
    // stage's constants. Mirrors _kinematic_point.
    struct Point {
        float k[4];
        float cpb, spb, v;
    };

    static __device__ __forceinline__ void point(const float x[4], float d,
                                                 float dl, const Stage& st,
                                                 const Par& p, Point& q) {
        const float v = x[3];
        const float pb = x[2] + st.beta;
        q.cpb = cosf(pb);
        q.spb = sinf(pb);
        q.k[0] = v * q.cpb;
        q.k[1] = v * q.spb;
        q.k[2] = v * st.sb / p.lr;
        q.k[3] = p.acc * d - p.fr * v;
        q.v = v;
    }

    static __device__ __forceinline__ void deriv(const float x[4], float d,
                                                 float dl, const Stage& st,
                                                 const Par& p, float k[4]) {
        Point q;
        point(x, d, dl, st, p, q);
#pragma unroll
        for (int i = 0; i < 4; ++i) k[i] = q.k[i];
    }

    // dk = derivative of k at q, a point of the stage with constants st,
    // along tangent column j: t = d (phi, v) of the point; column 2 also
    // moves d by 1, column 3 delta by 1 and with it beta by db. t[i] enters
    // only where bit i of mask is set, as in Pacejka::tangent. With
    // pb = phi + beta:
    //   dk0 = cos(pb) t_v - v sin(pb) (t_phi + db),
    //   dk1 = sin(pb) t_v + v cos(pb) (t_phi + db),
    //   dk2 = (sin(beta) t_v + v cos(beta) db) / lr,   dk3 = -fr t_v + acc,
    // where db enters only column 3 and acc only column 2. Mirrors
    // _kinematic_tangent.
    static __device__ __forceinline__ void tangent(const Point& q,
                                                   const Stage& st,
                                                   const Par& p,
                                                   const float t[2], int j,
                                                   int mask, float dk[4]) {
        float tpb = (mask & 1) ? t[0] : 0.f;   // of the angle pb
        float n2 = 0.f, n3 = 0.f;
        if (j == 3) {
            tpb += st.db;
            n2 = q.v * st.cb * st.db;
        }
        float a0 = -q.k[1] * tpb, a1 = q.k[0] * tpb;
        if (mask & 2) {
            a0 = fmaf(q.cpb, t[1], a0);
            a1 = fmaf(q.spb, t[1], a1);
            n2 = fmaf(st.sb, t[1], n2);
            n3 = -p.fr * t[1];
        }
        if (j == 2) n3 += p.acc;
        dk[0] = a0;
        dk[1] = a1;
        dk[2] = n2 / p.lr;
        dk[3] = n3;
    }

    static __device__ __forceinline__ float speed(const float x[4]) {
        return fabsf(x[3]);
    }

    static __device__ __forceinline__ void speed_grad(const float x[4],
                                                      float w0, float sv,
                                                      float speed, float g[4]) {
        const float sgn = (float)((x[3] > 0.f) - (x[3] < 0.f));
        g[3] += 2.f * w0 * sv * sgn;
    }
};

// One classical RK4 step in place, with the stage's constants given.
template <class M>
__device__ __forceinline__ void rk4_step(float x[M::SD], float d, float dl,
                                         const typename M::Stage& st,
                                         const Par& p, const Cfg& c) {
    float k1[M::SD], k2[M::SD], k3[M::SD], k4[M::SD], t[M::SD];
    M::deriv(x, d, dl, st, p, k1);
#pragma unroll
    for (int i = 0; i < M::SD; ++i) t[i] = x[i] + c.hh * k1[i];
    M::deriv(t, d, dl, st, p, k2);
#pragma unroll
    for (int i = 0; i < M::SD; ++i) t[i] = x[i] + c.hh * k2[i];
    M::deriv(t, d, dl, st, p, k3);
#pragma unroll
    for (int i = 0; i < M::SD; ++i) t[i] = x[i] + c.h * k3[i];
    M::deriv(t, d, dl, st, p, k4);
#pragma unroll
    for (int i = 0; i < M::SD; ++i)
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
// Also g += dL/dx (the inputs' terms 2 c5 d, 2 c4 delta are phase 3's).
template <class M>
__device__ __forceinline__ float stage_cost(const float x[M::SD], float d,
                                            float dl, const float* row,
                                            const Cfg& c, float g[M::SD]) {
    const float px = x[0], py = x[1], phi = x[2];
    const float nx = row[0], ny = row[1], pvx = row[2], pvy = row[3];
    const float nxx = row[4], nxy = row[5];
    const float cte = (px - pvx) * (ny - pvy) - (py - pvy) * (nx - pvx);
    const float desired = atan2f(nxy - ny, nxx - nx);
    const float he = wrap_to_pi(desired - phi);
    const float pe = (px - nx) * (nxy - ny) - (py - ny) * (nxx - nx);
    const float speed = M::speed(x);
    const float sv = speed - c.v_ref;
    const float c_cte = 2.f * c.w[1] * cte;
    const float c_pe = 2.f * c.w[2] * pe;
    g[0] += c_cte * (ny - pvy) + c_pe * (nxy - ny);
    g[1] += -c_cte * (nx - pvx) - c_pe * (nxx - nx);
    g[2] += -2.f * c.w[3] * he;
    M::speed_grad(x, c.w[0], sv, speed, g);
    // each square rounded before its weight, as c[i] * t ** 2 in torch
    return c.w[0] * (sv * sv) + c.w[1] * (cte * cte) + c.w[2] * (pe * pe)
        + c.w[3] * (he * he) + c.w[4] * (dl * dl) + c.w[5] * (d * d);
}

// The AL residual zeta - clip(zeta, lo, up) of one constraint, zeta =
// x_i^2 - off_i + lam / sigma (true division); NaN propagates.
__device__ __forceinline__ float al_residual(float xi, float off, float lam,
                                             float sig, float lo, float up) {
    const float g = xi * xi - off;
    const float zeta = g + lam / sig;
    const float zhat = zeta < lo ? lo : (zeta > up ? up : zeta);
    return zeta - zhat;
}

// ---------------------------------------------------------------------------
// The phased kernel (K1, K2)
// ---------------------------------------------------------------------------

// Offsets (in floats) of one block's dynamic shared memory. A (lane, stage)
// pair's slot is l * np + k and a boundary state's l * xp + k, with np, xp
// odd so that the lanes of a warp in phases 1 and 3 hit distinct banks.
struct PhLayout {
    int np, xp;
    size_t cl, p, u, x, T, g, cost, total;
};

// The most roads a block of L lanes reads at road stride rs (0: shared).
__host__ __device__ __forceinline__ int ph_roads(int L, int rs) {
    return rs > 0 ? (L - 1) / rs + 2 : 1;
}

__host__ __device__ __forceinline__ PhLayout ph_layout(int sd, int L,
                                                       int n_horiz, int n_cl,
                                                       int rs) {
    PhLayout y;
    y.np = n_horiz | 1;
    y.xp = (n_horiz + 1) | 1;
    const size_t pairs = (size_t)L * y.np;
    y.cl = 0;                                   // centerline tables, n_cl x 6 each
    y.p = y.cl + (size_t)ph_roads(L, rs) * n_cl * 6;  // parameters
    y.u = y.p + N_PARAMS;                       // inputs, then the gradient
    y.x = y.u + (size_t)L * 2 * n_horiz;        // boundary states, sd planes
    y.T = y.x + (size_t)sd * L * y.xp;          // Jacobian columns, sd x sd planes
    y.g = y.T + (size_t)sd * sd * pairs;        // stage state gradients, sd planes
    y.cost = y.g + (size_t)sd * pairs;          // stage costs
    y.total = y.cost + pairs;
    return y;
}

// Phase 2's linearisation: the stage recomputed from its start state xs,
// with T[j][r] = d x_end[r] along column j (j < sd - 2: the start state's
// component j + 2; sd - 2: the input d; sd - 1: delta). Mirrors
// _stage_linearisation.
template <class M>
__device__ __forceinline__ void stage_jacobian(const float xs[M::SD], float d,
                                               float dl, const Par& p,
                                               const Cfg& c,
                                               float T[M::SD][M::SD]) {
    constexpr int SD = M::SD, NX = SD - 2;
    const typename M::Stage st = M::stage(dl, p);
    float x[SD];
#pragma unroll
    for (int i = 0; i < SD; ++i) x[i] = xs[i];
#pragma unroll
    for (int j = 0; j < SD; ++j)
#pragma unroll
        for (int r = 0; r < SD; ++r) T[j][r] = (j < NX && r == j + 2) ? 1.f : 0.f;
    for (int s = 0; s < c.substeps; ++s) {
        float P[SD][NX], S[SD][SD], acc[SD], xa[SD];
#pragma unroll
        for (int j = 0; j < SD; ++j)
#pragma unroll
            for (int r = 0; r < NX; ++r) P[j][r] = T[j][r + 2];
#pragma unroll
        for (int i = 0; i < SD; ++i) xa[i] = x[i];
#pragma unroll
        for (int ev = 0; ev < 4; ++ev) {
            typename M::Point q;
            M::point(xa, d, dl, st, p, q);
            const float w = (ev == 1 || ev == 2) ? 2.f : 1.f;
            const float cn = ev == 2 ? c.h : c.hh;
            const bool start = ev == 0 && s == 0;
#pragma unroll
            for (int j = 0; j < SD; ++j) {
                float dk[SD];
                if (start)
                    M::tangent(q, st, p, P[j], j, j < NX ? 1 << j : 0, dk);
                else
                    M::tangent(q, st, p, P[j], j, (1 << NX) - 1, dk);
#pragma unroll
                for (int r = 0; r < SD; ++r)
                    S[j][r] = ev == 0 ? dk[r] : fmaf(w, dk[r], S[j][r]);
                if (ev < 3) {
#pragma unroll
                    for (int r = 0; r < NX; ++r)
                        P[j][r] = fmaf(cn, dk[r + 2], T[j][r + 2]);
                }
            }
            // the state, in the plain version's order
#pragma unroll
            for (int i = 0; i < SD; ++i) {
                acc[i] = ev == 0 ? q.k[i] : acc[i] + w * q.k[i];
                if (ev < 3) xa[i] = x[i] + cn * q.k[i];
            }
        }
#pragma unroll
        for (int i = 0; i < SD; ++i) x[i] = x[i] + c.h6 * acc[i];
#pragma unroll
        for (int j = 0; j < SD; ++j)
#pragma unroll
            for (int r = 0; r < SD; ++r) T[j][r] = fmaf(c.h6, S[j][r], T[j][r]);
    }
}

// cltab is one (n_cl, 6) table at road stride rs = 0, else (R, n_cl, 6) with
// lane e on road e / rs.
template <class M>
__global__ void __launch_bounds__(PH_THREADS)
fused_psi_fan_phased(const float* __restrict__ u, const float* __restrict__ y0,
                     const float* __restrict__ cltab,
                     const float* __restrict__ pvec, float* __restrict__ psi,
                     float* __restrict__ grad, int E, Cfg c, int L, int rs) {
    constexpr int SD = M::SD, NX = SD - 2;
    const int N = c.n_horiz, n2 = 2 * N;
    const PhLayout y = ph_layout(SD, L, N, c.n_cl, rs);
    extern __shared__ float smem[];
    float* s_cl = smem + y.cl;
    float* s_p = smem + y.p;
    float* s_u = smem + y.u;
    float* s_x = smem + y.x;
    float* s_T = smem + y.T;
    float* s_g = smem + y.g;
    float* s_cost = smem + y.cost;
    const int LX = L * y.xp, LP = L * y.np;   // plane strides
    const int tid = threadIdx.x;
    const int e0 = blockIdx.x * L;
    const int nl = min(L, E - e0);            // lanes of this block
    const int tab = c.n_cl * 6;               // floats of one road's table
    const int r0 = rs > 0 ? e0 / rs : 0;      // the block's first road
    const int nr = rs > 0 ? (e0 + nl - 1) / rs - r0 + 1 : 1;

    for (int i = tid; i < nr * tab; i += PH_THREADS)
        s_cl[i] = cltab[(size_t)r0 * tab + i];
    for (int i = tid; i < N_PARAMS; i += PH_THREADS) s_p[i] = pvec[i];
    for (int i = tid; i < nl * n2; i += PH_THREADS) s_u[i] = u[(size_t)e0 * n2 + i];
    __syncthreads();
    const Par p = load_par(s_p);

    // ---- phase 1: the rollout, one thread per lane ------------------------
    if (tid < nl) {
        float x[SD];
#pragma unroll
        for (int i = 0; i < SD; ++i) x[i] = y0[(size_t)(e0 + tid) * SD + i];
        float* xo = s_x + tid * y.xp;
        const float* ul = s_u + tid * n2;
#pragma unroll
        for (int i = 0; i < SD; ++i) xo[i * LX] = x[i];
        for (int k = 0; k < N; ++k) {
            const float d = ul[2 * k], dl = ul[2 * k + 1];
            const typename M::Stage st = M::stage(dl, p);
            for (int s = 0; s < c.substeps; ++s) rk4_step<M>(x, d, dl, st, p, c);
#pragma unroll
            for (int i = 0; i < SD; ++i) xo[i * LX + k + 1] = x[i];
        }
    }
    __syncthreads();

    // ---- phase 2: every (lane, stage) pair, all threads --------------------
    for (int q = tid; q < nl * N; q += PH_THREADS) {
        const int l = q / N, k = q - l * N;
        const int pi = l * y.np + k;
        const float d = s_u[l * n2 + 2 * k], dl = s_u[l * n2 + 2 * k + 1];
        const float* xl = s_x + l * y.xp + k;
        float xs[SD], xe[SD], g[SD];
#pragma unroll
        for (int i = 0; i < SD; ++i) {
            xs[i] = xl[i * LX];
            xe[i] = xl[i * LX + 1];
            g[i] = 0.f;
        }
        // the stage cost and its gradient at the end state, on the lane's road
        const float* cl = rs > 0 ? s_cl + ((e0 + l) / rs - r0) * tab : s_cl;
        const int j = nearest(xe[0], xe[1], cl, c.n_cl);
        s_cost[pi] = stage_cost<M>(xe, d, dl, cl + 6 * j, c, g);
#pragma unroll
        for (int i = 0; i < SD; ++i) s_g[i * LP + pi] = g[i];
        // the stage's Jacobian from its start state
        float T[SD][SD];
        stage_jacobian<M>(xs, d, dl, p, c, T);
#pragma unroll
        for (int jj = 0; jj < SD; ++jj)
#pragma unroll
            for (int r = 0; r < SD; ++r) s_T[(jj * SD + r) * LP + pi] = T[jj][r];
    }
    __syncthreads();

    // ---- phase 3: psi and the adjoint, one thread per lane ----------------
    if (tid < nl) {
        const int l = tid;
        float tot = 0.f;
        for (int k = 0; k < N; ++k) tot += s_cost[l * y.np + k];
        psi[e0 + l] = tot;
        float* ul = s_u + l * n2;
        float a[SD];
#pragma unroll
        for (int i = 0; i < SD; ++i) a[i] = 0.f;
        for (int k = N - 1; k >= 0; --k) {
            const int pi = l * y.np + k;
            float v[SD];
#pragma unroll
            for (int r = 0; r < SD; ++r) v[r] = a[r] + s_g[r * LP + pi];
            float gd = 2.f * c.w[5] * ul[2 * k], gdl = 2.f * c.w[4] * ul[2 * k + 1];
#pragma unroll
            for (int r = 0; r < SD; ++r) {
                gd = fmaf(s_T[(NX * SD + r) * LP + pi], v[r], gd);
                gdl = fmaf(s_T[((NX + 1) * SD + r) * LP + pi], v[r], gdl);
            }
            a[0] = v[0];
            a[1] = v[1];
#pragma unroll
            for (int jj = 0; jj < NX; ++jj) {
                float t = 0.f;
#pragma unroll
                for (int r = 0; r < SD; ++r) t = fmaf(s_T[(jj * SD + r) * LP + pi], v[r], t);
                a[jj + 2] = t;
            }
            ul[2 * k] = gd;
            ul[2 * k + 1] = gdl;
        }
    }
    __syncthreads();
    for (int i = tid; i < nl * n2; i += PH_THREADS) grad[(size_t)e0 * n2 + i] = s_u[i];
}

// ---------------------------------------------------------------------------
// K3 through a device scratch: the rollout, the stage terms, the adjoint
// ---------------------------------------------------------------------------
//
// The phased kernel keeps what its phases hand on in shared memory. At K3's
// N = 40 that is 2,335 floats a lane, most of it the Jacobian planes, so a
// block would take 16 lanes and an SM one block: the card would run the fan
// as waves of 16 lanes an SM, each wave one lane's serial chain long. K3
// runs the phases as three kernels instead, launched in turn on one stream,
// that hand on through a scratch in device memory which the wrapper
// allocates: planes of `pitch` floats, one value a lane each (lane-minor,
// so that neighbouring threads touch neighbouring addresses). Residency
// then no longer caps the lanes in flight: every lane's rollout runs at
// once, and the stage terms run one thread a (lane, stage) pair over the
// whole card. Each kernel runs its phase's code as the phased kernel does,
// through the same device functions in the same order, so the values are
// the same bits.
//   fused_psi_fan_rollout  a warp a block, a thread a lane: the N + 1
//                          boundary states;
//   fused_psi_fan_stages   a thread a (lane, stage) pair, pair q = k E + e:
//                          the nearest point, the stage cost and its state
//                          gradient, the penalties and their gradient, the
//                          stage Jacobian; the road, the parameters and the
//                          bounds staged in its block's shared memory;
//   fused_psi_fan_adjoint  a warp a block, a thread a lane: psi in the
//                          plain version's order, the adjoint, the gradient.
// The two lane kernels stage their block's controls in shared memory, the
// rollout the parameters too, as the phased kernel's phases 1 and 3 read
// them; the adjoint loads a stage's Jacobian and state gradient while it
// works on the stage after, and writes the gradient out through shared
// memory in one coalesced pass.
// The scratch (scratch_layout): groups of planes in this order, with the
// plane index within each group:
//   x     (N + 1) sd   boundary state k, component i: k sd + i
//   T     N sd sd      stage k, column j, component r: (k sd + j) sd + r
//   g     N sd         stage k's state gradient, component i: k sd + i
//   cost  N            stage k's cost: k
//   pen   N sd         stage k's penalty of component i: k sd + i
// 55 N + 6 planes in all at sd = 6 (ops/fused_psi.py:al_scratch_floats).

#define FAN_LANES 32          // the lane kernels: a thread a lane, a warp a block
#define FAN_PAIR_THREADS 128  // the stage terms: a thread a (lane, stage) pair
// Blocks of the stage terms an SM must hold at once: a register cap of 168
// a thread, against 211 uncapped (two blocks an SM), for 12 warps an SM in
// place of 8; it spills a little and times 10-13% faster at E = 20,480 and
// 40,960 with the same bits (H100, 700 W).
#define FAN_PAIR_MIN_BLOCKS 3

struct Scratch {
    long long pitch;                      // floats from one plane to the next
    long long x, T, g, cost, pen, total;  // each group's first float; in all
};

// The scratch for E lanes at horizon N: a plane holds E floats rounded up
// to 32, so that each starts a multiple of 128 bytes from the first.
static Scratch scratch_layout(int sd, int E, int N) {
    Scratch s;
    s.pitch = ((long long)E + 31) / 32 * 32;
    s.x = 0;
    s.T = s.x + (long long)sd * (N + 1) * s.pitch;
    s.g = s.T + (long long)sd * sd * N * s.pitch;
    s.cost = s.g + (long long)sd * N * s.pitch;
    s.pen = s.cost + (long long)N * s.pitch;
    s.total = s.pen + (long long)sd * N * s.pitch;
    return s;
}

// A lane kernel's block of lanes e0 .. e0 + nl - 1: their controls (n2 a
// lane) into s_u, column i of lane l at i * (FAN_LANES + 1) + l, so that a
// warp reading one column for its lanes, or storing one lane's consecutive
// columns, touches 32 banks.
__device__ __forceinline__ void stage_controls(const float* __restrict__ u,
                                               int e0, int nl, int n2,
                                               float* s_u) {
    for (int i = threadIdx.x; i < nl * n2; i += FAN_LANES) {
        const int l = i / n2;
        s_u[(i - l * n2) * (FAN_LANES + 1) + l] = u[(size_t)e0 * n2 + i];
    }
}

template <class M>
__global__ void __launch_bounds__(FAN_LANES)
fused_psi_fan_rollout(const float* __restrict__ u, const float* __restrict__ y0,
                      const float* __restrict__ pvec, float* __restrict__ scr,
                      Scratch s, int E, Cfg c) {
    constexpr int SD = M::SD, UP = FAN_LANES + 1;
    const int N = c.n_horiz, n2 = 2 * N;
    extern __shared__ float smem[];
    float* s_p = smem;
    float* s_u = smem + N_PARAMS;
    const int l = threadIdx.x, e0 = blockIdx.x * FAN_LANES;
    const int nl = min(FAN_LANES, E - e0);
    for (int i = l; i < N_PARAMS; i += FAN_LANES) s_p[i] = pvec[i];
    stage_controls(u, e0, nl, n2, s_u);
    __syncthreads();
    if (l >= nl) return;
    const Par p = load_par(s_p);
    float x[SD];
#pragma unroll
    for (int i = 0; i < SD; ++i) x[i] = y0[(size_t)(e0 + l) * SD + i];
    float* xo = scr + s.x + e0 + l;
#pragma unroll
    for (int i = 0; i < SD; ++i) xo[i * s.pitch] = x[i];
    for (int k = 0; k < N; ++k) {
        const float d = s_u[2 * k * UP + l], dl = s_u[(2 * k + 1) * UP + l];
        const typename M::Stage st = M::stage(dl, p);
        for (int j = 0; j < c.substeps; ++j) rk4_step<M>(x, d, dl, st, p, c);
#pragma unroll
        for (int i = 0; i < SD; ++i) xo[((k + 1) * SD + i) * s.pitch] = x[i];
    }
}

// lam, sig (E, m), off (SD,), lo, up (m,): the penalties' operands.
template <class M>
__global__ void __launch_bounds__(FAN_PAIR_THREADS, FAN_PAIR_MIN_BLOCKS)
fused_psi_fan_stages(const float* __restrict__ u,
                     const float* __restrict__ cltab,
                     const float* __restrict__ pvec,
                     const float* __restrict__ lam,
                     const float* __restrict__ sig,
                     const float* __restrict__ off,
                     const float* __restrict__ lo,
                     const float* __restrict__ up, float* __restrict__ scr,
                     Scratch s, int E, Cfg c) {
    constexpr int SD = M::SD;
    const int N = c.n_horiz, n2 = 2 * N, m = SD * N;
    const int tab = c.n_cl * 6;
    extern __shared__ float smem[];
    float* s_cl = smem;
    float* s_p = s_cl + tab;
    float* s_off = s_p + N_PARAMS;
    float* s_lo = s_off + SD;
    float* s_up = s_lo + m;
    const int tid = threadIdx.x;
    for (int i = tid; i < tab; i += blockDim.x) s_cl[i] = cltab[i];
    for (int i = tid; i < N_PARAMS; i += blockDim.x) s_p[i] = pvec[i];
    for (int i = tid; i < SD; i += blockDim.x) s_off[i] = off[i];
    for (int i = tid; i < m; i += blockDim.x) {
        s_lo[i] = lo[i];
        s_up[i] = up[i];
    }
    __syncthreads();
    const long long q = (long long)blockIdx.x * blockDim.x + tid;
    if (q >= (long long)E * N) return;
    const Par p = load_par(s_p);
    const int k = (int)(q / E), e = (int)(q - (long long)k * E);
    const float d = u[(size_t)e * n2 + 2 * k], dl = u[(size_t)e * n2 + 2 * k + 1];
    const float* xl = scr + s.x + (long long)k * SD * s.pitch + e;
    float xs[SD], xe[SD], g[SD];
#pragma unroll
    for (int i = 0; i < SD; ++i) {
        xs[i] = xl[i * s.pitch];
        xe[i] = xl[(SD + i) * s.pitch];
        g[i] = 0.f;
    }
    // the stage cost and its gradient at the end state
    const int j = nearest(xe[0], xe[1], s_cl, c.n_cl);
    scr[s.cost + k * s.pitch + e] = stage_cost<M>(xe, d, dl, s_cl + 6 * j, c, g);
    // the penalties 0.5 sigma r^2, each rounded as the plain version rounds
    // it; d/dx_i = sigma r 2 x_i
    const size_t b = (size_t)e * m + (size_t)k * SD;
#pragma unroll
    for (int i = 0; i < SD; ++i) {
        const float sg = sig[b + i];
        const float r = al_residual(xe[i], s_off[i], lam[b + i], sg,
                                    s_lo[k * SD + i], s_up[k * SD + i]);
        scr[s.pen + (k * SD + i) * s.pitch + e] = (0.5f * sg) * (r * r);
        g[i] += sg * r * (2.f * xe[i]);
    }
#pragma unroll
    for (int i = 0; i < SD; ++i) scr[s.g + (k * SD + i) * s.pitch + e] = g[i];
    // the stage's Jacobian from its start state
    float T[SD][SD];
    stage_jacobian<M>(xs, d, dl, p, c, T);
    float* To = scr + s.T + (long long)k * SD * SD * s.pitch + e;
#pragma unroll
    for (int jj = 0; jj < SD; ++jj)
#pragma unroll
        for (int r = 0; r < SD; ++r) To[(jj * SD + r) * s.pitch] = T[jj][r];
}

// Stage k's Jacobian columns T[j sd + r] and state gradient g of the lane
// whose value of the scratch's first plane is at se.
template <int SD>
__device__ __forceinline__ void load_stage(const float* __restrict__ se,
                                           const Scratch& s, int k,
                                           float T[SD * SD], float g[SD]) {
#pragma unroll
    for (int i = 0; i < SD * SD; ++i) T[i] = se[s.T + (k * SD * SD + i) * s.pitch];
#pragma unroll
    for (int i = 0; i < SD; ++i) g[i] = se[s.g + (k * SD + i) * s.pitch];
}

template <class M>
__global__ void __launch_bounds__(FAN_LANES)
fused_psi_fan_adjoint(const float* __restrict__ u,
                      const float* __restrict__ scr, Scratch s,
                      float* __restrict__ psi, float* __restrict__ grad, int E,
                      Cfg c) {
    constexpr int SD = M::SD, NX = SD - 2, UP = FAN_LANES + 1;
    const int N = c.n_horiz, n2 = 2 * N;
    extern __shared__ float smem[];
    float* s_u = smem;
    const int l = threadIdx.x, e0 = blockIdx.x * FAN_LANES;
    const int nl = min(FAN_LANES, E - e0);
    stage_controls(u, e0, nl, n2, s_u);
    __syncthreads();
    if (l < nl) {
        const float* se = scr + e0 + l;
        float tot = 0.f;
#pragma unroll 8
        for (int k = 0; k < N; ++k) {
            tot += se[s.cost + k * s.pitch];
#pragma unroll
            for (int i = 0; i < SD; ++i) tot += se[s.pen + (k * SD + i) * s.pitch];
        }
        psi[e0 + l] = tot;
        float Tn[SD * SD], gn[SD], a[SD];
        load_stage<SD>(se, s, N - 1, Tn, gn);
#pragma unroll
        for (int i = 0; i < SD; ++i) a[i] = 0.f;
        for (int k = N - 1; k >= 0; --k) {
            float Tk[SD * SD], v[SD];
#pragma unroll
            for (int i = 0; i < SD * SD; ++i) Tk[i] = Tn[i];
#pragma unroll
            for (int r = 0; r < SD; ++r) v[r] = a[r] + gn[r];
            if (k > 0) load_stage<SD>(se, s, k - 1, Tn, gn);
            float* uk = s_u + 2 * k * UP + l;   // d_k; delta_k a row on
            float gd = 2.f * c.w[5] * uk[0], gdl = 2.f * c.w[4] * uk[UP];
#pragma unroll
            for (int r = 0; r < SD; ++r) {
                gd = fmaf(Tk[NX * SD + r], v[r], gd);
                gdl = fmaf(Tk[(NX + 1) * SD + r], v[r], gdl);
            }
            a[0] = v[0];
            a[1] = v[1];
#pragma unroll
            for (int jj = 0; jj < NX; ++jj) {
                float t = 0.f;
#pragma unroll
                for (int r = 0; r < SD; ++r) t = fmaf(Tk[jj * SD + r], v[r], t);
                a[jj + 2] = t;
            }
            uk[0] = gd;
            uk[UP] = gdl;
        }
    }
    __syncthreads();
    for (int i = l; i < nl * n2; i += FAN_LANES) {
        const int ll = i / n2;
        grad[(size_t)e0 * n2 + i] = s_u[(i - ll * n2) * UP + ll];
    }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

static Cfg make_cfg(int n_horiz, int n_cl, int substeps, double h, float v_ref,
                    float w0, float w1, float w2, float w3, float w4, float w5) {
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
    return c;
}

static bool valid_shape(int E, int n_horiz, int n_cl, int substeps) {
    return E > 0 && n_horiz >= 1 && n_horiz <= MAX_N && substeps >= 1 &&
           n_cl >= 1;
}

// The phased kernel's lanes per block and shared memory for a shape on the
// current device: the largest L <= PH_MAX_LANES whose grid has at least
// one block per SM (L = 1 where E is too small for that) and
// whose shared memory fits the device's opt-in limit.
static int ph_plan(int sd, int E, int n_horiz, int n_cl, int rs, int* lanes,
                   size_t* smem) {
    if (!valid_shape(E, n_horiz, n_cl, 1) || rs < 0) return (int)cudaErrorInvalidValue;
    int dev, n_sm, smem_max;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess)
        rc = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
        rc = cudaDeviceGetAttribute(&smem_max,
                                    cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (rc != cudaSuccess) return (int)rc;
    for (int L = PH_MAX_LANES; L >= 1; L /= 2) {
        const size_t bytes =
            ph_layout(sd, L, n_horiz, n_cl, rs).total * sizeof(float);
        if (bytes > (size_t)smem_max) continue;
        if ((E + L - 1) / L >= n_sm || L == 1) {
            *lanes = L;
            *smem = bytes;
            return 0;
        }
    }
    return (int)cudaErrorInvalidValue;
}

template <class M>
static int launch_phased(const float* u, const float* y0, const float* cltab,
                         const float* pvec, float* psi, float* grad, int E,
                         int n_horiz, int n_cl, int substeps, double h,
                         float v_ref, float w0, float w1, float w2, float w3,
                         float w4, float w5, int rs, void* stream) {
    if (!valid_shape(E, n_horiz, n_cl, substeps)) return (int)cudaErrorInvalidValue;
    int L;
    size_t smem;
    int rc = ph_plan(M::SD, E, n_horiz, n_cl, rs, &L, &smem);
    if (rc != 0) return rc;
    if (smem > 48 * 1024) {
        rc = (int)cudaFuncSetAttribute(fused_psi_fan_phased<M>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
        if (rc != 0) return rc;
    }
    const Cfg c = make_cfg(n_horiz, n_cl, substeps, h, v_ref, w0, w1, w2, w3, w4, w5);
    const int grid = (E + L - 1) / L;
    fused_psi_fan_phased<M><<<grid, PH_THREADS, smem, (cudaStream_t)stream>>>(
        u, y0, cltab, pvec, psi, grad, E, c, L, rs);
    return (int)cudaGetLastError();
}

// K3's three kernels in turn on one stream, through scr, a device buffer of
// scratch_floats floats. The stage terms' shared memory (the road table,
// the parameters, the bounds) is opted in above 48 KB; cudaErrorInvalidValue
// where it exceeds the device's limit, or where the buffer is smaller than
// scratch_layout's.
template <class M>
static int launch_scratch(const float* u, const float* y0, const float* cltab,
                          const float* pvec, const float* lam,
                          const float* sig, const float* off, const float* lo,
                          const float* up, float* psi, float* grad, float* scr,
                          long long scratch_floats, int E, int n_horiz,
                          int n_cl, int substeps, double h, float v_ref,
                          float w0, float w1, float w2, float w3, float w4,
                          float w5, void* stream) {
    constexpr int SD = M::SD;
    if (!valid_shape(E, n_horiz, n_cl, substeps)) return (int)cudaErrorInvalidValue;
    const Scratch s = scratch_layout(SD, E, n_horiz);
    const long long pairs = (long long)E * n_horiz;
    const long long pair_blocks = (pairs + FAN_PAIR_THREADS - 1) / FAN_PAIR_THREADS;
    if (scratch_floats < s.total || pair_blocks > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(n_cl * 6 + N_PARAMS + SD + 2 * SD * n_horiz)
        * sizeof(float);
    int rc = 0;
    if (smem > 48 * 1024) {
        int dev, smem_max;
        rc = (int)cudaGetDevice(&dev);
        if (rc == 0)
            rc = (int)cudaDeviceGetAttribute(
                &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (rc == 0 && smem > (size_t)smem_max) rc = (int)cudaErrorInvalidValue;
        if (rc == 0)
            rc = (int)cudaFuncSetAttribute(fused_psi_fan_stages<M>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
        if (rc != 0) return rc;
    }
    const Cfg c = make_cfg(n_horiz, n_cl, substeps, h, v_ref, w0, w1, w2, w3, w4, w5);
    const cudaStream_t st = (cudaStream_t)stream;
    const int lane_blocks = (E + FAN_LANES - 1) / FAN_LANES;
    const size_t u_bytes = (size_t)(FAN_LANES + 1) * 2 * n_horiz * sizeof(float);
    fused_psi_fan_rollout<M><<<lane_blocks, FAN_LANES,
                               N_PARAMS * sizeof(float) + u_bytes, st>>>(
        u, y0, pvec, scr, s, E, c);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    fused_psi_fan_stages<M><<<(int)pair_blocks, FAN_PAIR_THREADS, smem, st>>>(
        u, cltab, pvec, lam, sig, off, lo, up, scr, s, E, c);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    fused_psi_fan_adjoint<M><<<lane_blocks, FAN_LANES, u_bytes, st>>>(
        u, scr, s, psi, grad, E, c);
    return (int)cudaGetLastError();
}

extern "C" {

// Launch a fan on ``stream``. Pointers are device pointers to contiguous
// float32 arrays: u (E, 2*n_horiz), y0 (E, sd), cltab (n_cl, 6), pvec (24,),
// psi (E,), grad (E, 2*n_horiz); for the AL variant also lam, sigma (E, m),
// off (sd,), lo, up (m,), m = sd * n_horiz. Each returns the cudaError_t of
// the launch.

// K1: Pacejka, sd = 6. road_stride 0: one shared road; K >= 1: cltab is
// (R, n_cl, 6) and lane e reads road e / K.
int mpc_fused_psi_fan(const float* u, const float* y0, const float* cltab,
                      const float* pvec, float* psi, float* grad, int E,
                      int n_horiz, int n_cl, int substeps, double h,
                      float v_ref, float w0, float w1, float w2, float w3,
                      float w4, float w5, int road_stride, void* stream) {
    if (road_stride < 0) return (int)cudaErrorInvalidValue;
    return launch_phased<Pacejka>(u, y0, cltab, pvec, psi, grad, E, n_horiz,
                                  n_cl, substeps, h, v_ref, w0, w1, w2, w3,
                                  w4, w5, road_stride, stream);
}

// K2: kinematic bicycle, sd = 4.
int mpc_fused_psi_fan_kin(const float* u, const float* y0, const float* cltab,
                          const float* pvec, float* psi, float* grad, int E,
                          int n_horiz, int n_cl, int substeps, double h,
                          float v_ref, float w0, float w1, float w2, float w3,
                          float w4, float w5, void* stream) {
    return launch_phased<Kinematic>(u, y0, cltab, pvec, psi, grad, E, n_horiz,
                                    n_cl, substeps, h, v_ref, w0, w1, w2, w3,
                                    w4, w5, 0, stream);
}

// K3: Pacejka with the augmented-Lagrangian penalty, sd = 6, in three
// kernels through ``scratch``, a device buffer of ``scratch_floats``
// floats, at least (55 n_horiz + 6) planes of E rounded up to 32.
int mpc_fused_psi_fan_al(const float* u, const float* y0, const float* cltab,
                         const float* pvec, const float* lam,
                         const float* sig, const float* off, const float* lo,
                         const float* up, float* psi, float* grad,
                         float* scratch, long long scratch_floats, int E,
                         int n_horiz, int n_cl, int substeps, double h,
                         float v_ref, float w0, float w1, float w2, float w3,
                         float w4, float w5, void* stream) {
    return launch_scratch<Pacejka>(u, y0, cltab, pvec, lam, sig, off, lo, up,
                                   psi, grad, scratch, scratch_floats, E,
                                   n_horiz, n_cl, substeps, h, v_ref, w0, w1,
                                   w2, w3, w4, w5, stream);
}

// The phased kernel's lanes per block and shared memory bytes for E lanes
// of the model of state dimension sd (K1: sd = 6; K2: sd = 4) at road
// stride road_stride (0: one shared road) on the current device;
// cudaErrorInvalidValue for another sd or if the shape does not fit even at
// one lane per block.
int mpc_fused_psi_fan_plan(int sd, int E, int n_horiz, int n_cl,
                           int road_stride, int* lanes, int* smem_bytes) {
    if (sd != Pacejka::SD && sd != Kinematic::SD) return (int)cudaErrorInvalidValue;
    size_t smem = 0;
    const int rc = ph_plan(sd, E, n_horiz, n_cl, road_stride, lanes, &smem);
    *smem_bytes = (int)smem;
    return rc;
}

}  // extern "C"
