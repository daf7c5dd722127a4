// One policy step of T1 physics (10 substeps at 1 kHz) for every env in one
// launch: the Hopper (sm_90a) port of the Pallas TPU kernel
// ti5_isaacgym_tpu/physics/megakernel.py::run_decimation (pallas_call at :236).
//
// Per substep and env: the PD torque law on pre-resolved lagged actions
// (optional Coulomb/viscous friction and torque-noise multiplier, clipped to
// the torque limits), then engine_core.substep_stacked: FK over the bodies,
// contact-point kinematics, frozen-cell bilinear height and gradient, the
// implicit-rate normal spring-damper with the depenetration cap, anchor-spring
// Coulomb friction, per-body wrench sums (external wrench on substep 0 only),
// the joint-limit penalty and effort clamp, ABA with a 6x6 Cholesky base
// solve, and semi-implicit Euler with velocity caps, hard joint stops and
// quaternion integration.  It emits per-substep dof and IMU snapshots (newest
// last) and the post-step feet/knee rows of engine_core.ctx_stack_rows.
//
// Layout: every input and output is float32 row-major [rows, N] (env
// contiguous), so the loads and stores of a warp coalesce.  The row contracts
// are those of the JAX kernel (megakernel.py:53-91, engine_core.py:194-206).
// The anchor output doubles as the working anchor array across substeps.
//
// Design: one thread per env, blocks of 128 threads.  The model tree, limits
// and solver options sit in one __constant__ struct uploaded by the wrapper.
// The substep, body, contact-point and dof loops are real loops over those
// tables (#pragma unroll 1), so the source and ptxas's work stay small; the
// per-body temporaries live in small local arrays (local memory).
//
// Bound on an H100 SXM: the kernel must read 878 and write 518 float32 rows,
// 5,584 B per env (22.9 MB at 4096 envs, 6.8 us at 3.35 TB/s); its float32
// arithmetic is of the same order against 67 TFLOP/s, and chip_smoke.py
// computes both from each run's inputs.  At 4096 envs and 128 threads a block
// only 32 of the 132 SMs get work, and each thread walks a long serial chain
// through local memory; that, not the bound, sets this kernel's time.  Making
// it fast (several threads per env, shared-memory body state) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXB 16   // bodies
#define MAXD 15   // dof (MAXB - 1)
#define MAXP 40   // contact points
#define MAXK 4    // feet / knees

struct DecimConsts {
  // int32 block
  int nb, nd, ncp, dec, nfeet, nknees;
  int parent[MAXB];
  int jrot_identity[MAXB];
  int cp_body[MAXP];
  int feet[MAXK];
  int knees[MAXK];
  // float32 block
  float axis[MAXB][3];
  float jpos[MAXB][3];
  float jrot[MAXB][9];
  float cp_pos[MAXP][3];
  float dof_lower[MAXD], dof_upper[MAXD], dof_effort[MAXD];
  float default_q[MAXD], torque_limit[MAXD];
  float hscale;
  // contact options (kp_dt = kp*dt, kt_v = kt*dt + kdt, dt_kt_v = dt*kt_v)
  float kp, kd, kt, kp_dt, kt_v, dt_kt_v, max_depth, max_force, c_dt, max_depen_vel;
  // solver options
  float dt, gravity, limit_kp, limit_kd, max_qvel;
};

__constant__ DecimConsts C;

struct V3 { float x, y, z; };
struct M3 { float m[3][3]; };

__device__ __forceinline__ V3 v3(float x, float y, float z) { V3 r = {x, y, z}; return r; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 row(const M3& a, int i) { return v3(a.m[i][0], a.m[i][1], a.m[i][2]); }
__device__ __forceinline__ V3 col(const M3& a, int j) { return v3(a.m[0][j], a.m[1][j], a.m[2][j]); }
__device__ __forceinline__ V3 mv(const M3& a, V3 v) { return v3(dot(row(a, 0), v), dot(row(a, 1), v), dot(row(a, 2), v)); }
__device__ __forceinline__ V3 tmv(const M3& a, V3 v) {  // a^T v
  return v3(a.m[0][0] * v.x + a.m[1][0] * v.y + a.m[2][0] * v.z,
            a.m[0][1] * v.x + a.m[1][1] * v.y + a.m[2][1] * v.z,
            a.m[0][2] * v.x + a.m[1][2] * v.y + a.m[2][2] * v.z);
}
__device__ __forceinline__ M3 mm(const M3& a, const M3& b) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.m[i][j] = dot(row(a, i), col(b, j));
  return r;
}
__device__ __forceinline__ M3 mmt(const M3& a, const M3& b) {  // a b^T
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.m[i][j] = dot(row(a, i), row(b, j));
  return r;
}
__device__ __forceinline__ M3 skew(V3 v) {
  M3 r = {{{0.f, -v.z, v.y}, {v.z, 0.f, -v.x}, {-v.y, v.x, 0.f}}};
  return r;
}
__device__ __forceinline__ M3 q_to_m33(float w, float x, float y, float z) {
  M3 r = {{{1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)},
           {2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)},
           {2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)}}};
  return r;
}
__device__ __forceinline__ M3 cm3(const float* a) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 9; ++i) r.m[i / 3][i % 3] = a[i];
  return r;
}
__device__ __forceinline__ V3 cv3(const float* a) { return v3(a[0], a[1], a[2]); }

// symmetric 3x3 as (s00, s01, s02, s11, s12, s22)
struct S6 { float s[6]; };
__device__ __forceinline__ M3 s_full(const S6& s) {
  M3 r = {{{s.s[0], s.s[1], s.s[2]}, {s.s[1], s.s[3], s.s[4]}, {s.s[2], s.s[4], s.s[5]}}};
  return r;
}
__device__ __forceinline__ S6 s_of(const M3& m) {
  S6 r = {{m.m[0][0], m.m[0][1], m.m[0][2], m.m[1][1], m.m[1][2], m.m[2][2]}};
  return r;
}
__device__ __forceinline__ V3 s_mv(const S6& s, V3 v) {
  return v3(s.s[0] * v.x + s.s[1] * v.y + s.s[2] * v.z,
            s.s[1] * v.x + s.s[3] * v.y + s.s[4] * v.z,
            s.s[2] * v.x + s.s[4] * v.y + s.s[5] * v.z);
}
__device__ __forceinline__ S6 s_outer_scaled(V3 a, float k) {
  S6 r = {{a.x * a.x * k, a.x * a.y * k, a.x * a.z * k, a.y * a.y * k, a.y * a.z * k, a.z * a.z * k}};
  return r;
}
__device__ __forceinline__ S6 s_sub(const S6& a, const S6& b) {
  S6 r;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.s[i] = a.s[i] - b.s[i];
  return r;
}
__device__ __forceinline__ S6 s_congruence(const M3& R, const S6& s) {  // R S R^T
  M3 T = mm(R, s_full(s));
  S6 r = {{dot(row(T, 0), row(R, 0)), dot(row(T, 0), row(R, 1)), dot(row(T, 0), row(R, 2)),
           dot(row(T, 1), row(R, 1)), dot(row(T, 1), row(R, 2)), dot(row(T, 2), row(R, 2))}};
  return r;
}

// Component-form FK over the tree (engine_core.fk_components).
__device__ void fk(const float* bq, V3 bp, V3 bw, V3 bv, const float* qpos, const float* qvel,
                   V3* pos, M3* rot, V3* w, V3* v, M3* Rpc) {
  pos[0] = bp;
  rot[0] = q_to_m33(bq[0], bq[1], bq[2], bq[3]);
  w[0] = bw;
  v[0] = bv;
#pragma unroll 1
  for (int i = 1; i < C.nb; ++i) {
    const int p = C.parent[i], j = i - 1;
    const V3 ax = cv3(C.axis[i]), jp = cv3(C.jpos[i]);
    const float half = 0.5f * qpos[j];
    const float s = sinf(half), c = cosf(half);
    M3 R = q_to_m33(c, ax.x * s, ax.y * s, ax.z * s);
    if (!C.jrot_identity[i]) R = mm(cm3(C.jrot[i]), R);
    Rpc[i] = R;
    rot[i] = mm(rot[p], R);
    pos[i] = add(pos[p], mv(rot[p], jp));
    w[i] = add(tmv(R, w[p]), scale(ax, qvel[j]));
    v[i] = tmv(R, add(v[p], cross(w[p], jp)));
  }
}

struct Rows {  // row-major [rows, N] float32 arrays
  const float *st, *an, *cl, *dy, *ct, *la, *no, *ew, *me;
  float *st_out, *an_out, *fo_out, *tq_out, *ds_out, *is_out, *cx_out;
};

__global__ void __launch_bounds__(128) decimation_kernel(Rows R, int n, int use_coulomb,
                                                         int use_noise, int with_ctx) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int nb = C.nb, nd = C.nd, ncp = C.ncp;
#define AT(ptr, r) (ptr)[(size_t)(r) * n + e]

  V3 bp = v3(AT(R.st, 0), AT(R.st, 1), AT(R.st, 2));
  float bq[4] = {AT(R.st, 3), AT(R.st, 4), AT(R.st, 5), AT(R.st, 6)};
  V3 bw = v3(AT(R.st, 7), AT(R.st, 8), AT(R.st, 9));
  V3 bv = v3(AT(R.st, 10), AT(R.st, 11), AT(R.st, 12));
  float qpos[MAXD], qvel[MAXD], tau[MAXD], tau_t[MAXD], qdd[MAXD];
#pragma unroll 1
  for (int j = 0; j < nd; ++j) {
    qpos[j] = AT(R.st, 13 + j);
    qvel[j] = AT(R.st, 13 + nd + j);
  }
#pragma unroll 1
  for (int r = 0; r < 3 * ncp; ++r) AT(R.an_out, r) = AT(R.an, r);

  const int o_inert = 4 * nb, o_arma = 13 * nb;
  const float friction = AT(R.dy, o_arma + nd);
  const float rest = AT(R.dy, o_arma + nd + 1);
  const float k_v = C.kp_dt + C.kd * (1.0f - rest);

  V3 pos[MAXB], w[MAXB], v[MAXB], fb[MAXB], tb[MAXB];
  M3 rot[MAXB], Rpc[MAXB];
  S6 IA_A[MAXB], IA_D[MAXB];
  M3 IA_B[MAXB];
  V3 cb_a[MAXB], cb_l[MAXB], pA_a[MAXB], pA_l[MAXB], U_a[MAXB], U_l[MAXB], a_a[MAXB], a_l[MAXB];
  float d_[MAXB], u_[MAXB];

#pragma unroll 1
  for (int k = 0; k < C.dec; ++k) {
    // --- PD torque law on the lag-resolved action of this substep ---
#pragma unroll 1
    for (int j = 0; j < nd; ++j) {
      float t = AT(R.ct, j) * (AT(R.la, k * nd + j) + C.default_q[j] - qpos[j] + AT(R.ct, 2 * nd + j))
                - AT(R.ct, nd + j) * qvel[j];
      if (use_coulomb) {
        const float sg = (qvel[j] > 0.f) ? 1.f : ((qvel[j] < 0.f) ? -1.f : 0.f);
        t = t - AT(R.ct, 4 * nd + j) * qvel[j] - AT(R.ct, 3 * nd + j) * sg;
      }
      if (use_noise) t = t * AT(R.no, k * nd + j);
      tau[j] = fminf(fmaxf(t, -C.torque_limit[j]), C.torque_limit[j]);
    }

    // --- FK ---
    fk(bq, bp, bw, bv, qpos, qvel, pos, rot, w, v, Rpc);

    // --- contact: per point force, anchor update, per-body wrench sums ---
#pragma unroll 1
    for (int b = 0; b < nb; ++b) { fb[b] = v3(0.f, 0.f, 0.f); tb[b] = v3(0.f, 0.f, 0.f); }
#pragma unroll 1
    for (int c = 0; c < ncp; ++c) {
      const int b = C.cp_body[c];
      const V3 pl = cv3(C.cp_pos[c]);
      const V3 pw = add(pos[b], mv(rot[b], pl));
      const V3 vw = mv(rot[b], add(v[b], cross(w[b], pl)));
      const float x0 = AT(R.cl, c), y0 = AT(R.cl, ncp + c);
      const float c00 = AT(R.cl, 2 * ncp + c), c10 = AT(R.cl, 3 * ncp + c);
      const float c01 = AT(R.cl, 4 * ncp + c), c11 = AT(R.cl, 5 * ncp + c);
      const float fu = (pw.x - x0) / C.hscale, fv = (pw.y - y0) / C.hscale;
      const float gu = 1.0f - fu, gv = 1.0f - fv;
      const float h = c00 * gu * gv + c10 * fu * gv + c01 * gu * fv + c11 * fu * fv;
      const float dhdx = ((c10 - c00) * gv + (c11 - c01) * fv) / C.hscale;
      const float dhdy = ((c01 - c00) * gu + (c11 - c10) * fu) / C.hscale;
      const float n_norm = sqrtf(dhdx * dhdx + dhdy * dhdy + 1.0f);
      const float nx = -dhdx / n_norm, ny = -dhdy / n_norm, nz = 1.0f / n_norm;
      const float gap = h - pw.z;
      const float depth = fminf(fmaxf(gap * nz, 0.f), C.max_depth);
      const float act = gap > 0.f ? 1.f : 0.f;
      const float mn = AT(R.me, c), mt = AT(R.me, ncp + c);
      const float v_n = nx * vw.x + ny * vw.y + nz * vw.z;
      const float denom = 1.0f + C.c_dt * k_v / mn;
      float f_n = fminf(fmaxf((C.kp * depth - k_v * v_n) / denom, 0.f), C.max_force) * act;
      const float f_cap = fmaxf(mn * (C.max_depen_vel - v_n) / C.c_dt, 0.f);
      f_n = fminf(f_n, f_cap);
      const float vtx = vw.x - v_n * nx, vty = vw.y - v_n * ny, vtz = vw.z - v_n * nz;
      const float ax = AT(R.an_out, c), ay = AT(R.an_out, ncp + c), az = AT(R.an_out, 2 * ncp + c);
      float dtx = pw.x - ax, dty = pw.y - ay, dtz = pw.z - az;
      const float d_n = dtx * nx + dty * ny + dtz * nz;
      dtx = dtx - d_n * nx; dty = dty - d_n * ny; dtz = dtz - d_n * nz;
      const float denom_t = 1.0f + C.dt_kt_v / mt;
      float ftx = -(C.kt * dtx + C.kt_v * vtx) / denom_t;
      float fty = -(C.kt * dty + C.kt_v * vty) / denom_t;
      float ftz = -(C.kt * dtz + C.kt_v * vtz) / denom_t;
      const float ft_mag = sqrtf(ftx * ftx + fty * fty + ftz * ftz);
      const float cone = friction * f_n;
      const bool slip = ft_mag > cone;
      const float sc = (slip ? cone / (ft_mag + 1e-8f) : 1.0f) * act;
      ftx = ftx * sc; fty = fty * sc; ftz = ftz * sc;
      const V3 f = v3(nx * f_n + ftx, ny * f_n + fty, nz * f_n + ftz);
      if (gap > 0.f) {
        if (slip) {
          AT(R.an_out, c) = pw.x + ftx * denom_t / C.kt;
          AT(R.an_out, ncp + c) = pw.y + fty * denom_t / C.kt;
          AT(R.an_out, 2 * ncp + c) = pw.z + ftz * denom_t / C.kt;
        }
      } else {
        AT(R.an_out, c) = pw.x; AT(R.an_out, ncp + c) = pw.y; AT(R.an_out, 2 * ncp + c) = pw.z;
      }
      fb[b] = add(fb[b], f);
      tb[b] = add(tb[b], cross(sub(pw, pos[b]), f));
    }

    // --- joint-limit penalty + effort clamp ---
#pragma unroll 1
    for (int j = 0; j < nd; ++j) {
      const float over = fmaxf(qpos[j] - C.dof_upper[j], 0.f);
      const float under = fmaxf(C.dof_lower[j] - qpos[j], 0.f);
      float t_lim = -C.limit_kp * over + C.limit_kp * under;
      t_lim = t_lim - ((over > 0.f || under > 0.f) ? C.limit_kd * qvel[j] : 0.f);
      tau_t[j] = fminf(fmaxf(tau[j], -C.dof_effort[j]), C.dof_effort[j]) + t_lim;
    }

    // --- ABA pass 1: body inertias, bias forces, external wrenches ---
    const float on = (k == 0) ? 1.f : 0.f;
#pragma unroll 1
    for (int i = 0; i < nb; ++i) {
      const float m = AT(R.dy, i);
      const V3 c = v3(AT(R.dy, nb + 3 * i), AT(R.dy, nb + 3 * i + 1), AT(R.dy, nb + 3 * i + 2));
      const float cc = dot(c, c);
      const int oi = o_inert + 9 * i;
      S6 A = {{AT(R.dy, oi + 0) + (cc - c.x * c.x) * m, AT(R.dy, oi + 1) + (0.f - c.x * c.y) * m,
               AT(R.dy, oi + 2) + (0.f - c.x * c.z) * m, AT(R.dy, oi + 4) + (cc - c.y * c.y) * m,
               AT(R.dy, oi + 5) + (0.f - c.y * c.z) * m, AT(R.dy, oi + 8) + (cc - c.z * c.z) * m}};
      IA_A[i] = A;
      M3 B = skew(c);
#pragma unroll
      for (int r = 0; r < 9; ++r) B.m[r / 3][r % 3] = B.m[r / 3][r % 3] * m;
      IA_B[i] = B;
      S6 D = {{m, 0.f, 0.f, m, 0.f, m}};
      IA_D[i] = D;
      const V3 wi = w[i], vi = v[i];
      if (i == 0) {
        cb_a[i] = v3(0.f, 0.f, 0.f);
        cb_l[i] = v3(0.f, 0.f, 0.f);
      } else {
        const V3 sj = scale(cv3(C.axis[i]), qvel[i - 1]);
        cb_a[i] = cross(wi, sj);
        cb_l[i] = cross(vi, sj);
      }
      const V3 n_ = add(s_mv(A, wi), mv(B, vi));
      const V3 f_ = add(tmv(B, wi), scale(vi, m));
      V3 fx = fb[i], tx = tb[i];
      if (i == 0) {
        fx = add(fx, v3(AT(R.ew, 0) * on, AT(R.ew, 1) * on, AT(R.ew, 2) * on));
        tx = add(tx, v3(AT(R.ew, 3) * on, AT(R.ew, 4) * on, AT(R.ew, 5) * on));
      }
      pA_a[i] = sub(add(cross(wi, n_), cross(vi, f_)), tmv(rot[i], tx));
      pA_l[i] = sub(cross(wi, f_), tmv(rot[i], fx));
    }

    // --- ABA pass 2 (inward): articulated inertias ---
#pragma unroll 1
    for (int i = nb - 1; i > 0; --i) {
      const int p = C.parent[i];
      const V3 s = cv3(C.axis[i]), pp = cv3(C.jpos[i]);
      U_a[i] = s_mv(IA_A[i], s);
      U_l[i] = tmv(IA_B[i], s);
      d_[i] = dot(s, U_a[i]) + AT(R.dy, o_arma + i - 1);
      u_[i] = tau_t[i - 1] - dot(s, pA_a[i]);
      const float inv_d = 1.0f / d_[i];
      const S6 Ia_A = s_sub(IA_A[i], s_outer_scaled(U_a[i], inv_d));
      const S6 Ia_D = s_sub(IA_D[i], s_outer_scaled(U_l[i], inv_d));
      M3 Ia_B;
      {
        const float ua[3] = {U_a[i].x, U_a[i].y, U_a[i].z}, ul[3] = {U_l[i].x, U_l[i].y, U_l[i].z};
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int q = 0; q < 3; ++q) Ia_B.m[r][q] = IA_B[i].m[r][q] - ua[r] * ul[q] * inv_d;
      }
      const float ud = u_[i] * inv_d;
      const V3 pa_a = add(add(pA_a[i], s_mv(Ia_A, cb_a[i])), add(mv(Ia_B, cb_l[i]), scale(U_a[i], ud)));
      const V3 pa_l = add(add(pA_l[i], tmv(Ia_B, cb_a[i])), add(s_mv(Ia_D, cb_l[i]), scale(U_l[i], ud)));
      const M3 Rm = Rpc[i];
      const V3 f_par = mv(Rm, pa_l);
      pA_a[p] = add(pA_a[p], add(mv(Rm, pa_a), cross(pp, f_par)));
      pA_l[p] = add(pA_l[p], f_par);
      const M3 psk = skew(pp);
      const S6 RA = s_congruence(Rm, Ia_A);
      const M3 RB = mm(Rm, mmt(Ia_B, Rm));
      const S6 RD = s_congruence(Rm, Ia_D);
      const M3 Mx = mm(RB, psk);
      const S6 M2 = {{2 * Mx.m[0][0], Mx.m[0][1] + Mx.m[1][0], Mx.m[0][2] + Mx.m[2][0],
                      2 * Mx.m[1][1], Mx.m[1][2] + Mx.m[2][1], 2 * Mx.m[2][2]}};
      const S6 PSP = s_of(mm(mm(psk, s_full(RD)), psk));
      const S6 Y_A = s_sub(s_sub(RA, M2), PSP);
      const M3 PRD = mm(psk, s_full(RD));
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        IA_A[p].s[r] = IA_A[p].s[r] + Y_A.s[r];
        IA_D[p].s[r] = IA_D[p].s[r] + RD.s[r];
      }
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int q = 0; q < 3; ++q) IA_B[p].m[r][q] = IA_B[p].m[r][q] + (RB.m[r][q] + PRD.m[r][q]);
    }

    // --- base 6x6 SPD solve (unrolled Cholesky, spatial3.chol6_solve) ---
    float A6[6][6], L[6][6], y6[6], x6[6];
    {
      const M3 Af = s_full(IA_A[0]), Df = s_full(IA_D[0]);
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          A6[r][q] = Af.m[r][q];
          A6[r][3 + q] = IA_B[0].m[r][q];
          A6[3 + r][q] = IA_B[0].m[q][r];
          A6[3 + r][3 + q] = Df.m[r][q];
        }
#pragma unroll
      for (int r = 0; r < 6; ++r) A6[r][r] = A6[r][r] + 1e-9f;
      const float rhs[6] = {-pA_a[0].x, -pA_a[0].y, -pA_a[0].z, -pA_l[0].x, -pA_l[0].y, -pA_l[0].z};
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int q = 0; q <= r; ++q) {
          float s = A6[r][q];
#pragma unroll
          for (int t = 0; t < q; ++t) s = s - L[r][t] * L[q][t];
          L[r][q] = (r == q) ? sqrtf(fmaxf(s, 1e-12f)) : s / L[q][q];
        }
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        float s = rhs[r];
#pragma unroll
        for (int t = 0; t < r; ++t) s = s - L[r][t] * y6[t];
        y6[r] = s / L[r][r];
      }
#pragma unroll
      for (int r = 5; r >= 0; --r) {
        float s = y6[r];
#pragma unroll
        for (int t = r + 1; t < 6; ++t) s = s - L[t][r] * x6[t];
        x6[r] = s / L[r][r];
      }
    }
    a_a[0] = v3(x6[0], x6[1], x6[2]);
    a_l[0] = v3(x6[3], x6[4], x6[5]);

    // --- ABA pass 3 (outward): joint accelerations ---
#pragma unroll 1
    for (int i = 1; i < nb; ++i) {
      const int p = C.parent[i];
      const V3 pp = cv3(C.jpos[i]);
      const V3 ai_a = add(tmv(Rpc[i], a_a[p]), cb_a[i]);
      const V3 ai_l = add(tmv(Rpc[i], add(a_l[p], cross(a_a[p], pp))), cb_l[i]);
      qdd[i - 1] = (u_[i] - dot(U_a[i], ai_a) - dot(U_l[i], ai_l)) / d_[i];
      a_a[i] = add(ai_a, scale(cv3(C.axis[i]), qdd[i - 1]));
      a_l[i] = ai_l;
    }

    // --- semi-implicit Euler, velocity caps, hard joint stops ---
    const float dt = C.dt, vm = C.max_qvel;
    const V3 g_body = tmv(rot[0], v3(0.f, 0.f, C.gravity));
    const V3 a_lin = add(a_l[0], g_body);
    bw = add(bw, scale(a_a[0], dt));
    bv = add(bv, scale(a_lin, dt));
    bw = v3(fminf(fmaxf(bw.x, -vm), vm), fminf(fmaxf(bw.y, -vm), vm), fminf(fmaxf(bw.z, -vm), vm));
    bv = v3(fminf(fmaxf(bv.x, -vm), vm), fminf(fmaxf(bv.y, -vm), vm), fminf(fmaxf(bv.z, -vm), vm));
#pragma unroll 1
    for (int j = 0; j < nd; ++j) {
      float qv = fminf(fmaxf(qvel[j] + dt * qdd[j], -vm), vm);
      const float qp = qpos[j] + dt * qv;
      if (qp > C.dof_upper[j]) qv = fminf(qv, 0.f);
      else if (qp < C.dof_lower[j]) qv = fmaxf(qv, 0.f);
      qvel[j] = qv;
      qpos[j] = fminf(fmaxf(qp, C.dof_lower[j]), C.dof_upper[j]);
    }
    const float ang = sqrtf(dot(bw, bw)) + 1e-12f;
    const V3 axs = scale(bw, 1.0f / ang);
    const float half = 0.5f * (ang * dt);
    const float sh = sinf(half), dw = cosf(half);
    const float dx = axs.x * sh, dy = axs.y * sh, dz = axs.z * sh;
    const float aw = bq[0], ax_ = bq[1], ay_ = bq[2], az_ = bq[3];
    float qw = aw * dw - ax_ * dx - ay_ * dy - az_ * dz;
    float qx = aw * dx + ax_ * dw + ay_ * dz - az_ * dy;
    float qy = aw * dy - ax_ * dz + ay_ * dw + az_ * dx;
    float qz = aw * dz + ax_ * dy - ay_ * dx + az_ * dw;
    const float qn = sqrtf(qw * qw + qx * qx + qy * qy + qz * qz) + 1e-12f;
    bq[0] = qw / qn; bq[1] = qx / qn; bq[2] = qy / qn; bq[3] = qz / qn;
    {
      const V3 u = v3(bq[1], bq[2], bq[3]);
      const V3 uv = cross(u, bv);
      const V3 t = add(scale(uv, bq[0]), cross(u, uv));
      bp = add(bp, scale(add(bv, scale(t, 2.0f)), dt));
    }

    // --- per-substep snapshots, newest last ---
#pragma unroll 1
    for (int j = 0; j < nd; ++j) {
      AT(R.ds_out, k * 2 * nd + j) = qpos[j];
      AT(R.ds_out, k * 2 * nd + nd + j) = qvel[j];
    }
    AT(R.is_out, k * 7 + 0) = bw.x; AT(R.is_out, k * 7 + 1) = bw.y; AT(R.is_out, k * 7 + 2) = bw.z;
    AT(R.is_out, k * 7 + 3) = bq[0]; AT(R.is_out, k * 7 + 4) = bq[1];
    AT(R.is_out, k * 7 + 5) = bq[2]; AT(R.is_out, k * 7 + 6) = bq[3];
  }

  // --- outputs of the last substep and the final state ---
#pragma unroll 1
  for (int j = 0; j < nd; ++j) AT(R.tq_out, j) = tau[j];
#pragma unroll 1
  for (int b = 0; b < nb; ++b) {
    AT(R.fo_out, 3 * b) = fb[b].x; AT(R.fo_out, 3 * b + 1) = fb[b].y; AT(R.fo_out, 3 * b + 2) = fb[b].z;
  }
  AT(R.st_out, 0) = bp.x; AT(R.st_out, 1) = bp.y; AT(R.st_out, 2) = bp.z;
  AT(R.st_out, 3) = bq[0]; AT(R.st_out, 4) = bq[1]; AT(R.st_out, 5) = bq[2]; AT(R.st_out, 6) = bq[3];
  AT(R.st_out, 7) = bw.x; AT(R.st_out, 8) = bw.y; AT(R.st_out, 9) = bw.z;
  AT(R.st_out, 10) = bv.x; AT(R.st_out, 11) = bv.y; AT(R.st_out, 12) = bv.z;
#pragma unroll 1
  for (int j = 0; j < nd; ++j) {
    AT(R.st_out, 13 + j) = qpos[j];
    AT(R.st_out, 13 + nd + j) = qvel[j];
  }

  // --- ctx rows (engine_core.ctx_stack_rows) from FK of the final state ---
  if (with_ctx) {
    fk(bq, bp, bw, bv, qpos, qvel, pos, rot, w, v, Rpc);
    const int nf = C.nfeet, nk = C.nknees;
#pragma unroll 1
    for (int f = 0; f < nf; ++f) {
      const int b = C.feet[f];
      AT(R.cx_out, 3 * f) = pos[b].x; AT(R.cx_out, 3 * f + 1) = pos[b].y; AT(R.cx_out, 3 * f + 2) = pos[b].z;
      const int o = 3 * nf + 5 * f;
      AT(R.cx_out, o) = rot[b].m[0][0]; AT(R.cx_out, o + 1) = rot[b].m[1][0];
      AT(R.cx_out, o + 2) = rot[b].m[2][0]; AT(R.cx_out, o + 3) = rot[b].m[2][1];
      AT(R.cx_out, o + 4) = rot[b].m[2][2];
      const V3 ww = mv(rot[b], w[b]);
      AT(R.cx_out, 8 * nf + 2 * f) = ww.x; AT(R.cx_out, 8 * nf + 2 * f + 1) = ww.y;
    }
#pragma unroll 1
    for (int q = 0; q < nk; ++q) {
      const int b = C.knees[q];
      AT(R.cx_out, 10 * nf + 2 * q) = pos[b].x; AT(R.cx_out, 10 * nf + 2 * q + 1) = pos[b].y;
    }
  }
#undef AT
}

extern "C" {

int ti5_decim_consts_size() { return (int)sizeof(DecimConsts); }

int ti5_decim_set_consts(const void* host, int nbytes, void* stream) {
  if (nbytes != (int)sizeof(DecimConsts)) return -1;
  return (int)cudaMemcpyToSymbolAsync(C, host, sizeof(DecimConsts), 0, cudaMemcpyHostToDevice,
                                      (cudaStream_t)stream);
}

int ti5_decim_launch(const float* st, const float* an, const float* cl, const float* dy,
                     const float* ct, const float* la, const float* no, const float* ew,
                     const float* me, float* st_out, float* an_out, float* fo_out,
                     float* tq_out, float* ds_out, float* is_out, float* cx_out, int n,
                     int use_coulomb, int use_noise, int with_ctx, void* stream) {
  Rows r = {st, an, cl, dy, ct, la, no, ew, me, st_out, an_out, fo_out, tq_out, ds_out, is_out, cx_out};
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  decimation_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(r, n, use_coulomb, use_noise,
                                                                 with_ctx);
  return (int)cudaGetLastError();
}

}  // extern "C"
