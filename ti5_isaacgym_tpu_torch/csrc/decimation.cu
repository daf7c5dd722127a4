// One policy step of robot physics (10 substeps at 1 kHz) for every env in
// one launch: the Hopper (sm_90a) port of the Pallas TPU kernel
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
// contiguous).  The row contracts are those of the JAX kernel
// (megakernel.py:53-91, engine_core.py:194-206).
//
// Bound on an H100 SXM: the kernel must read 878 and write 518 float32 rows,
// 5,584 B per env (22.9 MB at 4096 envs, 6.8 us at 3.35 TB/s); it does about
// 210 k float32 operations per env (12.8 us at 67 TFLOP/s at 4096 envs), so
// operations bound it; chip_smoke.py computes both from each run's inputs.
// What sets its time is latency: each env is a chain of dependent steps
// (FK down the tree, ABA up and down it, the base solve) ten times over.
//
// Design:
// - LANES threads cooperate on one env, BLOCK / LANES envs share a block.
//   The lanes split the work along the axes the math has, striding by LANES:
//   dofs (torque law, limits, Euler step, snapshots; lane l takes dofs l,
//   l + LANES, ...), bodies (joint rotations, wrench sums, ABA pass 1),
//   contact points, and tree levels for the serial parts (FK, ABA passes 2
//   and 3; one lane per body of a level).  The 6x6 base solve runs on one
//   lane.  LANES = 8 was the fastest of 8, 16 and 32 on an H100
//   (scripts/lanes_sweep.py, PERF.md): 4 envs per warp keep the lanes that
//   the two-body tree levels leave idle few.  The schedule tables (bodies by level, children
//   in fold order, each body's points) come from the model in DecimConsts.
// - The env's body state lives in shared memory (structure of arrays, one
//   float per body and field), not in local memory; lanes of an env meet at
//   __syncwarp (LANES <= 32, an env never spans warps).  A point's anchor,
//   cell and apparent masses stay in its lane's registers for all substeps.
// - Each scalar is computed by the same expression as in the plain version,
//   in the same order, compiled with --fmad=false: lanes divide which
//   scalars are computed, not how.  A sum across lanes is taken by one lane
//   in the plain version's order: a body's points in ascending index, a
//   parent's children in descending index.  No atomics.
// - Global loads and stores go through the env's staging area in shared
//   memory with neighbouring threads on neighbouring envs of one row; only
//   the per-substep lagged-action and noise rows are read directly, in the
//   substep that uses them.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXB 16   // bodies
#define MAXD 15   // dof (MAXB - 1)
#define MAXP 40   // contact points
#define MAXK 4    // feet / knees

#define LANES 8                                   // threads per env (of 8, 16, 32: the fastest)
#define BLOCK 128                                 // threads per block
#define EPB (BLOCK / LANES)                       // envs per block
#define BPL ((MAXB + LANES - 1) / LANES)          // bodies per lane
#define DPL ((MAXD + LANES - 1) / LANES)          // dofs per lane
#define PPL ((MAXP + LANES - 1) / LANES)          // contact points per lane
// blocks per SM that the shared memory allows (32 envs a SM); for 32 lanes
// a lower floor keeps the register cap at 80
#define MIN_BLOCKS (LANES == 32 ? 6 : 32 / EPB)

struct DecimConsts {
  // int32 block
  int nb, nd, ncp, dec, nfeet, nknees, nlev;
  int parent[MAXB];
  int jrot_identity[MAXB];
  int cp_body[MAXP];
  int feet[MAXK];
  int knees[MAXK];
  // schedule: bodies by tree level (level l is lev_body[lev_start[l] ..
  // lev_start[l + 1]), ascending), each body's children in fold order
  // (descending), each body's contact points (ascending)
  int lev_start[MAXB + 1];
  int lev_body[MAXB];
  int ch_start[MAXB + 1];
  int ch_list[MAXB];
  int cp_start[MAXB + 1];
  int cp_order[MAXP];
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

// Shared memory of one env, in floats.  Body field f of body i is at
// f * MAXB + i (neighbouring lanes on neighbouring banks).
enum {
  B_POS = 0, B_ROT = 3, B_W = 12, B_V = 15, B_RPC = 18, B_IAA = 27, B_IAB = 33, B_IAD = 42,
  B_CBA = 48, B_CBL = 51, B_PAA = 54, B_PAL = 57, B_UA = 60, B_UL = 63, B_D = 66, B_U = 67,
  B_AA = 68, B_AL = 71, B_NF = 74
};
enum {
  OFF_PTS = B_NF * MAXB,            // per-point world position and force; staging rows
  P_PW = 0, P_F = 3 * MAXP, P_N = 6 * MAXP,
  OFF_DOF = OFF_PTS + P_N,          // per-dof qpos, qvel, limited torque, qdd, armature
  D_QPOS = 0, D_QVEL = 16, D_TAUT = 32, D_QDD = 48, D_ARMA = 64, D_N = 80,
  OFF_BASE = OFF_DOF + D_N,         // bp3 bq4 bw3 bv3
  // + pad: two envs in one warp land on opposite bank halves (stride = 16 mod 32)
  ENV_STRIDE = OFF_BASE + 16 + ((OFF_BASE + 16) % 32 == 16 ? 0 : 16)
};
static_assert(ENV_STRIDE % 32 == 16, "env stride must be 16 mod 32 floats");
static_assert(LANES == 8 || LANES == 16 || LANES == 32, "LANES is 8, 16 or 32");
static_assert(MAXD < 16, "dof arrays hold 16 floats");
#define SMEM_BYTES (EPB * ENV_STRIDE * (int)sizeof(float))

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

// Body fields in shared memory (S points at the env's area).
__device__ __forceinline__ V3 ldv(const float* S, int f, int i) {
  return v3(S[f * MAXB + i], S[(f + 1) * MAXB + i], S[(f + 2) * MAXB + i]);
}
__device__ __forceinline__ void stv(float* S, int f, int i, V3 a) {
  S[f * MAXB + i] = a.x; S[(f + 1) * MAXB + i] = a.y; S[(f + 2) * MAXB + i] = a.z;
}
__device__ __forceinline__ M3 ldm(const float* S, int f, int i) {
  M3 r;
#pragma unroll
  for (int q = 0; q < 9; ++q) r.m[q / 3][q % 3] = S[(f + q) * MAXB + i];
  return r;
}
__device__ __forceinline__ void stm(float* S, int f, int i, const M3& a) {
#pragma unroll
  for (int q = 0; q < 9; ++q) S[(f + q) * MAXB + i] = a.m[q / 3][q % 3];
}
__device__ __forceinline__ S6 lds(const float* S, int f, int i) {
  S6 r;
#pragma unroll
  for (int q = 0; q < 6; ++q) r.s[q] = S[(f + q) * MAXB + i];
  return r;
}
__device__ __forceinline__ void sts(float* S, int f, int i, const S6& a) {
#pragma unroll
  for (int q = 0; q < 6; ++q) S[(f + q) * MAXB + i] = a.s[q];
}

struct Rows {  // row-major [rows, N] float32 arrays
  const float *st, *an, *cl, *dy, *ct, *la, *no, *ew, *me;
  float *st_out, *an_out, *fo_out, *tq_out, *ds_out, *is_out, *cx_out;
};

// Block-wide: rows [0, nrows) of src for the block's envs into each env's
// staging area (thread t on env t % EPB of row t / EPB).  Envs past n read
// env n - 1 and are never written back.
__device__ __forceinline__ void stage_in(float* smem, const float* src, int nrows, int n, int e0) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrows * EPB; idx += BLOCK) {
    const int r = idx / EPB, q = idx % EPB;
    smem[q * ENV_STRIDE + OFF_PTS + r] = __ldg(src + (size_t)r * n + min(e0 + q, n - 1));
  }
  __syncthreads();
}

// Block-wide: staging rows [p_off, p_off + nrows) of each env to rows
// [row0, row0 + nrows) of dst.  Callers put __syncthreads around a group.
__device__ __forceinline__ void flush_rows(const float* smem, float* dst, int row0, int nrows,
                                           int p_off, int n, int e0) {
  for (int idx = threadIdx.x; idx < nrows * EPB; idx += BLOCK) {
    const int r = idx / EPB, q = idx % EPB;
    if (e0 + q < n) dst[(size_t)(row0 + r) * n + e0 + q] = smem[q * ENV_STRIDE + OFF_PTS + p_off + r];
  }
}

// FK (engine_core.fk_components): the joint rotations body-parallel, then
// the composition down the tree one level at a time.  Ends synced.
__device__ __forceinline__ void fk(float* S, int lane) {
  const float* D = S + OFF_DOF;
  const float* Bs = S + OFF_BASE;
#pragma unroll
  for (int s = 0; s < BPL; ++s) {
    const int i = lane + s * LANES;
    if (i == 0) {
      stv(S, B_POS, 0, v3(Bs[0], Bs[1], Bs[2]));
      stm(S, B_ROT, 0, q_to_m33(Bs[3], Bs[4], Bs[5], Bs[6]));
      stv(S, B_W, 0, v3(Bs[7], Bs[8], Bs[9]));
      stv(S, B_V, 0, v3(Bs[10], Bs[11], Bs[12]));
    } else if (i < C.nb) {
      const V3 ax = cv3(C.axis[i]);
      const float half = 0.5f * D[D_QPOS + i - 1];
      const float s_ = sinf(half), c_ = cosf(half);
      M3 R = q_to_m33(c_, ax.x * s_, ax.y * s_, ax.z * s_);
      if (!C.jrot_identity[i]) R = mm(cm3(C.jrot[i]), R);
      stm(S, B_RPC, i, R);
    }
  }
  __syncwarp();
#pragma unroll 1
  for (int l = 1; l < C.nlev; ++l) {
#pragma unroll 1
    for (int q = C.lev_start[l] + lane; q < C.lev_start[l + 1]; q += LANES) {
      const int i = C.lev_body[q], p = C.parent[i];
      const V3 ax = cv3(C.axis[i]), jp = cv3(C.jpos[i]);
      const M3 R = ldm(S, B_RPC, i), rp = ldm(S, B_ROT, p);
      const V3 wp = ldv(S, B_W, p);
      stm(S, B_ROT, i, mm(rp, R));
      stv(S, B_POS, i, add(ldv(S, B_POS, p), mv(rp, jp)));
      stv(S, B_W, i, add(tmv(R, wp), scale(ax, D[D_QVEL + i - 1])));
      stv(S, B_V, i, tmv(R, add(ldv(S, B_V, p), cross(wp, jp))));
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
decimation_kernel(Rows R, int n, int use_coulomb, int use_noise, int with_ctx) {
  extern __shared__ float smem[];
  const int el = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int e0 = blockIdx.x * EPB;
  const int e = min(e0 + el, n - 1);     // envs past n repeat env n - 1, unstored
  float* S = smem + el * ENV_STRIDE;
  float* P = S + OFF_PTS;
  float* D = S + OFF_DOF;
  float* Bs = S + OFF_BASE;
  const int nb = C.nb, nd = C.nd, ncp = C.ncp;
#define AT(ptr, r) __ldg((ptr) + (size_t)(r) * n + e)

  // --- inputs, staged row by row ---
  stage_in(smem, R.st, 13 + 2 * nd, n, e0);
  for (int r = lane; r < 13; r += LANES) Bs[r] = P[r];
#pragma unroll
  for (int s = 0; s < DPL; ++s) {
    const int j = lane + s * LANES;
    if (j < nd) { D[D_QPOS + j] = P[13 + j]; D[D_QVEL + j] = P[13 + nd + j]; }
  }
  float ax[PPL], ay[PPL], az[PPL], cell[PPL][6], mn[PPL], mt[PPL];
  stage_in(smem, R.an, 3 * ncp, n, e0);
#pragma unroll
  for (int s = 0; s < PPL; ++s) {
    const int c = min(lane + s * LANES, ncp - 1);
    ax[s] = P[c]; ay[s] = P[ncp + c]; az[s] = P[2 * ncp + c];
  }
  stage_in(smem, R.cl, 6 * ncp, n, e0);
#pragma unroll
  for (int s = 0; s < PPL; ++s) {
    const int c = min(lane + s * LANES, ncp - 1);
#pragma unroll
    for (int q = 0; q < 6; ++q) cell[s][q] = P[q * ncp + c];
  }
  stage_in(smem, R.me, 2 * ncp, n, e0);
#pragma unroll
  for (int s = 0; s < PPL; ++s) {
    const int c = min(lane + s * LANES, ncp - 1);
    mn[s] = P[c]; mt[s] = P[ncp + c];
  }
  // body mass, com and inertia (6 of 9) stay in the owner lane's registers
  float bm[BPL], bc[BPL][3], bI[BPL][6];
  const int o_inert = 4 * nb, o_arma = 13 * nb;
  stage_in(smem, R.dy, 13 * nb + nd + 2, n, e0);
#pragma unroll
  for (int s = 0; s < BPL; ++s) {
    const int i = min(lane + s * LANES, nb - 1);
    bm[s] = P[i];
    bc[s][0] = P[nb + 3 * i]; bc[s][1] = P[nb + 3 * i + 1]; bc[s][2] = P[nb + 3 * i + 2];
    const int oi = o_inert + 9 * i;
    bI[s][0] = P[oi + 0]; bI[s][1] = P[oi + 1]; bI[s][2] = P[oi + 2];
    bI[s][3] = P[oi + 4]; bI[s][4] = P[oi + 5]; bI[s][5] = P[oi + 8];
  }
  for (int j = lane; j < nd; j += LANES) D[D_ARMA + j] = P[o_arma + j];
  const float friction = P[o_arma + nd];
  const float rest = P[o_arma + nd + 1];
  const float k_v = C.kp_dt + C.kd * (1.0f - rest);
  float kp_[DPL], kd_[DPL], offs[DPL], coul[DPL], visc[DPL], tau[DPL];
  stage_in(smem, R.ct, 5 * nd, n, e0);
#pragma unroll
  for (int s = 0; s < DPL; ++s) {
    const int j = min(lane + s * LANES, nd - 1);
    kp_[s] = P[j]; kd_[s] = P[nd + j]; offs[s] = P[2 * nd + j];
    coul[s] = P[3 * nd + j]; visc[s] = P[4 * nd + j];
    tau[s] = 0.f;
  }
  V3 fb[BPL];
#pragma unroll
  for (int s = 0; s < BPL; ++s) fb[s] = v3(0.f, 0.f, 0.f);
  __syncthreads();   // the staging area becomes the point area

#pragma unroll 1
  for (int k = 0; k < C.dec; ++k) {
    // --- dofs: PD torque law, joint-limit penalty and effort clamp ---
#pragma unroll
    for (int s = 0; s < DPL; ++s) {
      const int j = lane + s * LANES;
      if (j < nd) {
        const float qp = D[D_QPOS + j], qv = D[D_QVEL + j];
        float t = kp_[s] * (AT(R.la, k * nd + j) + C.default_q[j] - qp + offs[s]) - kd_[s] * qv;
        if (use_coulomb) {
          const float sg = (qv > 0.f) ? 1.f : ((qv < 0.f) ? -1.f : 0.f);
          t = t - visc[s] * qv - coul[s] * sg;
        }
        if (use_noise) t = t * AT(R.no, k * nd + j);
        tau[s] = fminf(fmaxf(t, -C.torque_limit[j]), C.torque_limit[j]);
        const float over = fmaxf(qp - C.dof_upper[j], 0.f);
        const float under = fmaxf(C.dof_lower[j] - qp, 0.f);
        float t_lim = -C.limit_kp * over + C.limit_kp * under;
        t_lim = t_lim - ((over > 0.f || under > 0.f) ? C.limit_kd * qv : 0.f);
        D[D_TAUT + j] = fminf(fmaxf(tau[s], -C.dof_effort[j]), C.dof_effort[j]) + t_lim;
      }
    }

    // --- FK ---
    fk(S, lane);

    // --- contact points: force and anchor update ---
#pragma unroll
    for (int s = 0; s < PPL; ++s) {
      const int c = lane + s * LANES;
      if (c < ncp) {
        const int b = C.cp_body[c];
        const V3 pl = cv3(C.cp_pos[c]);
        const M3 rb = ldm(S, B_ROT, b);
        const V3 pw = add(ldv(S, B_POS, b), mv(rb, pl));
        const V3 vw = mv(rb, add(ldv(S, B_V, b), cross(ldv(S, B_W, b), pl)));
        const float x0 = cell[s][0], y0 = cell[s][1];
        const float c00 = cell[s][2], c10 = cell[s][3], c01 = cell[s][4], c11 = cell[s][5];
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
        const float v_n = nx * vw.x + ny * vw.y + nz * vw.z;
        const float denom = 1.0f + C.c_dt * k_v / mn[s];
        float f_n = fminf(fmaxf((C.kp * depth - k_v * v_n) / denom, 0.f), C.max_force) * act;
        const float f_cap = fmaxf(mn[s] * (C.max_depen_vel - v_n) / C.c_dt, 0.f);
        f_n = fminf(f_n, f_cap);
        const float vtx = vw.x - v_n * nx, vty = vw.y - v_n * ny, vtz = vw.z - v_n * nz;
        float dtx = pw.x - ax[s], dty = pw.y - ay[s], dtz = pw.z - az[s];
        const float d_n = dtx * nx + dty * ny + dtz * nz;
        dtx = dtx - d_n * nx; dty = dty - d_n * ny; dtz = dtz - d_n * nz;
        const float denom_t = 1.0f + C.dt_kt_v / mt[s];
        float ftx = -(C.kt * dtx + C.kt_v * vtx) / denom_t;
        float fty = -(C.kt * dty + C.kt_v * vty) / denom_t;
        float ftz = -(C.kt * dtz + C.kt_v * vtz) / denom_t;
        const float ft_mag = sqrtf(ftx * ftx + fty * fty + ftz * ftz);
        const float cone = friction * f_n;
        const bool slip = ft_mag > cone;
        const float sc = (slip ? cone / (ft_mag + 1e-8f) : 1.0f) * act;
        ftx = ftx * sc; fty = fty * sc; ftz = ftz * sc;
        if (gap > 0.f) {
          if (slip) {
            ax[s] = pw.x + ftx * denom_t / C.kt;
            ay[s] = pw.y + fty * denom_t / C.kt;
            az[s] = pw.z + ftz * denom_t / C.kt;
          }
        } else {
          ax[s] = pw.x; ay[s] = pw.y; az[s] = pw.z;
        }
        P[P_PW + c] = pw.x; P[P_PW + MAXP + c] = pw.y; P[P_PW + 2 * MAXP + c] = pw.z;
        P[P_F + c] = nx * f_n + ftx;
        P[P_F + MAXP + c] = ny * f_n + fty;
        P[P_F + 2 * MAXP + c] = nz * f_n + ftz;
      }
    }
    __syncwarp();

    // --- bodies: wrench sums over their points, ABA pass 1 ---
    const float on = (k == 0) ? 1.f : 0.f;
#pragma unroll
    for (int s = 0; s < BPL; ++s) {
      const int i = lane + s * LANES;
      if (i < nb) {
        const V3 pb = ldv(S, B_POS, i);
        V3 f_sum = v3(0.f, 0.f, 0.f), t_sum = v3(0.f, 0.f, 0.f);
#pragma unroll 1
        for (int q = C.cp_start[i]; q < C.cp_start[i + 1]; ++q) {
          const int c = C.cp_order[q];
          const V3 f = v3(P[P_F + c], P[P_F + MAXP + c], P[P_F + 2 * MAXP + c]);
          const V3 pw = v3(P[P_PW + c], P[P_PW + MAXP + c], P[P_PW + 2 * MAXP + c]);
          f_sum = add(f_sum, f);
          t_sum = add(t_sum, cross(sub(pw, pb), f));
        }
        fb[s] = f_sum;
        const float m = bm[s];
        const V3 c = v3(bc[s][0], bc[s][1], bc[s][2]);
        const float cc = dot(c, c);
        const S6 A = {{bI[s][0] + (cc - c.x * c.x) * m, bI[s][1] + (0.f - c.x * c.y) * m,
                       bI[s][2] + (0.f - c.x * c.z) * m, bI[s][3] + (cc - c.y * c.y) * m,
                       bI[s][4] + (0.f - c.y * c.z) * m, bI[s][5] + (cc - c.z * c.z) * m}};
        M3 B = skew(c);
#pragma unroll
        for (int r = 0; r < 9; ++r) B.m[r / 3][r % 3] = B.m[r / 3][r % 3] * m;
        const S6 Dm = {{m, 0.f, 0.f, m, 0.f, m}};
        sts(S, B_IAA, i, A);
        stm(S, B_IAB, i, B);
        sts(S, B_IAD, i, Dm);
        const V3 wi = ldv(S, B_W, i), vi = ldv(S, B_V, i);
        V3 cba = v3(0.f, 0.f, 0.f), cbl = v3(0.f, 0.f, 0.f);
        if (i > 0) {
          const V3 sj = scale(cv3(C.axis[i]), D[D_QVEL + i - 1]);
          cba = cross(wi, sj);
          cbl = cross(vi, sj);
        }
        stv(S, B_CBA, i, cba);
        stv(S, B_CBL, i, cbl);
        const V3 n_ = add(s_mv(A, wi), mv(B, vi));
        const V3 f_ = add(tmv(B, wi), scale(vi, m));
        V3 fx = f_sum, tx = t_sum;
        if (i == 0) {
          fx = add(fx, v3(AT(R.ew, 0) * on, AT(R.ew, 1) * on, AT(R.ew, 2) * on));
          tx = add(tx, v3(AT(R.ew, 3) * on, AT(R.ew, 4) * on, AT(R.ew, 5) * on));
        }
        const M3 rot = ldm(S, B_ROT, i);
        stv(S, B_PAA, i, sub(add(cross(wi, n_), cross(vi, f_)), tmv(rot, tx)));
        stv(S, B_PAL, i, sub(cross(wi, f_), tmv(rot, fx)));
      }
    }
    __syncwarp();

    // --- ABA pass 2, inward one level at a time: each body of the level
    // computes its articulated terms and leaves its contribution to the
    // parent in its own slots; then each parent folds its children in ---
#pragma unroll 1
    for (int l = C.nlev - 1; l > 0; --l) {
#pragma unroll 1
      for (int q = C.lev_start[l] + lane; q < C.lev_start[l + 1]; q += LANES) {
        const int i = C.lev_body[q];
        const V3 s_ = cv3(C.axis[i]), pp = cv3(C.jpos[i]);
        const S6 IAi = lds(S, B_IAA, i), IDi = lds(S, B_IAD, i);
        const M3 IBi = ldm(S, B_IAB, i);
        const V3 pAa = ldv(S, B_PAA, i), pAl = ldv(S, B_PAL, i);
        const V3 cba = ldv(S, B_CBA, i), cbl = ldv(S, B_CBL, i);
        const V3 Ua = s_mv(IAi, s_);
        const V3 Ul = tmv(IBi, s_);
        const float d_ = dot(s_, Ua) + D[D_ARMA + i - 1];
        const float u_ = D[D_TAUT + i - 1] - dot(s_, pAa);
        stv(S, B_UA, i, Ua);
        stv(S, B_UL, i, Ul);
        S[B_D * MAXB + i] = d_;
        S[B_U * MAXB + i] = u_;
        const float inv_d = 1.0f / d_;
        const S6 Ia_A = s_sub(IAi, s_outer_scaled(Ua, inv_d));
        const S6 Ia_D = s_sub(IDi, s_outer_scaled(Ul, inv_d));
        M3 Ia_B;
        {
          const float ua[3] = {Ua.x, Ua.y, Ua.z}, ul[3] = {Ul.x, Ul.y, Ul.z};
#pragma unroll
          for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int c = 0; c < 3; ++c) Ia_B.m[r][c] = IBi.m[r][c] - ua[r] * ul[c] * inv_d;
        }
        const float ud = u_ * inv_d;
        const V3 pa_a = add(add(pAa, s_mv(Ia_A, cba)), add(mv(Ia_B, cbl), scale(Ua, ud)));
        const V3 pa_l = add(add(pAl, tmv(Ia_B, cba)), add(s_mv(Ia_D, cbl), scale(Ul, ud)));
        const M3 Rm = ldm(S, B_RPC, i);
        const V3 f_par = mv(Rm, pa_l);
        stv(S, B_PAA, i, add(mv(Rm, pa_a), cross(pp, f_par)));
        stv(S, B_PAL, i, f_par);
        const M3 psk = skew(pp);
        const S6 RA = s_congruence(Rm, Ia_A);
        const M3 RB = mm(Rm, mmt(Ia_B, Rm));
        const S6 RD = s_congruence(Rm, Ia_D);
        const M3 Mx = mm(RB, psk);
        const S6 M2 = {{2 * Mx.m[0][0], Mx.m[0][1] + Mx.m[1][0], Mx.m[0][2] + Mx.m[2][0],
                        2 * Mx.m[1][1], Mx.m[1][2] + Mx.m[2][1], 2 * Mx.m[2][2]}};
        const S6 PSP = s_of(mm(mm(psk, s_full(RD)), psk));
        sts(S, B_IAA, i, s_sub(s_sub(RA, M2), PSP));
        sts(S, B_IAD, i, RD);
        const M3 PRD = mm(psk, s_full(RD));
        M3 YB;
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int c = 0; c < 3; ++c) YB.m[r][c] = RB.m[r][c] + PRD.m[r][c];
        stm(S, B_IAB, i, YB);
      }
      __syncwarp();
#pragma unroll 1
      for (int q = C.lev_start[l - 1] + lane; q < C.lev_start[l]; q += LANES) {
        const int p = C.lev_body[q];
        if (C.ch_start[p] == C.ch_start[p + 1]) continue;
        V3 pAa = ldv(S, B_PAA, p), pAl = ldv(S, B_PAL, p);
        S6 IAp = lds(S, B_IAA, p), IDp = lds(S, B_IAD, p);
        M3 IBp = ldm(S, B_IAB, p);
#pragma unroll 1
        for (int h = C.ch_start[p]; h < C.ch_start[p + 1]; ++h) {
          const int ch = C.ch_list[h];
          pAa = add(pAa, ldv(S, B_PAA, ch));
          pAl = add(pAl, ldv(S, B_PAL, ch));
          const S6 YA = lds(S, B_IAA, ch), RD = lds(S, B_IAD, ch);
          const M3 YB = ldm(S, B_IAB, ch);
#pragma unroll
          for (int r = 0; r < 6; ++r) {
            IAp.s[r] = IAp.s[r] + YA.s[r];
            IDp.s[r] = IDp.s[r] + RD.s[r];
          }
#pragma unroll
          for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int c = 0; c < 3; ++c) IBp.m[r][c] = IBp.m[r][c] + YB.m[r][c];
        }
        stv(S, B_PAA, p, pAa);
        stv(S, B_PAL, p, pAl);
        sts(S, B_IAA, p, IAp);
        sts(S, B_IAD, p, IDp);
        stm(S, B_IAB, p, IBp);
      }
      __syncwarp();
    }

    // --- base 6x6 SPD solve on one lane (unrolled Cholesky, spatial3.chol6_solve) ---
    if (lane == 0) {
      float A6[6][6], L[6][6], y6[6], x6[6];
      const M3 Af = s_full(lds(S, B_IAA, 0)), Df = s_full(lds(S, B_IAD, 0));
      const M3 Bf = ldm(S, B_IAB, 0);
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          A6[r][q] = Af.m[r][q];
          A6[r][3 + q] = Bf.m[r][q];
          A6[3 + r][q] = Bf.m[q][r];
          A6[3 + r][3 + q] = Df.m[r][q];
        }
#pragma unroll
      for (int r = 0; r < 6; ++r) A6[r][r] = A6[r][r] + 1e-9f;
      const V3 pa = ldv(S, B_PAA, 0), pl = ldv(S, B_PAL, 0);
      const float rhs[6] = {-pa.x, -pa.y, -pa.z, -pl.x, -pl.y, -pl.z};
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
      stv(S, B_AA, 0, v3(x6[0], x6[1], x6[2]));
      stv(S, B_AL, 0, v3(x6[3], x6[4], x6[5]));
    }
    __syncwarp();

    // --- ABA pass 3, outward one level at a time: joint accelerations ---
#pragma unroll 1
    for (int l = 1; l < C.nlev; ++l) {
#pragma unroll 1
      for (int q = C.lev_start[l] + lane; q < C.lev_start[l + 1]; q += LANES) {
        const int i = C.lev_body[q], p = C.parent[i];
        const V3 pp = cv3(C.jpos[i]);
        const M3 Rm = ldm(S, B_RPC, i);
        const V3 aap = ldv(S, B_AA, p), alp = ldv(S, B_AL, p);
        const V3 ai_a = add(tmv(Rm, aap), ldv(S, B_CBA, i));
        const V3 ai_l = add(tmv(Rm, add(alp, cross(aap, pp))), ldv(S, B_CBL, i));
        const float qdd = (S[B_U * MAXB + i] - dot(ldv(S, B_UA, i), ai_a) -
                           dot(ldv(S, B_UL, i), ai_l)) / S[B_D * MAXB + i];
        D[D_QDD + i - 1] = qdd;
        stv(S, B_AA, i, add(ai_a, scale(cv3(C.axis[i]), qdd)));
        stv(S, B_AL, i, ai_l);
      }
      __syncwarp();
    }

    // --- semi-implicit Euler, velocity caps, hard joint stops; snapshots
    // of this substep into the staging rows (dof 2*nd, then IMU 7) ---
    const float dt = C.dt, vm = C.max_qvel;
#pragma unroll
    for (int s = 0; s < DPL; ++s) {
      const int j = lane + s * LANES;
      if (j < nd) {
        float qv = fminf(fmaxf(D[D_QVEL + j] + dt * D[D_QDD + j], -vm), vm);
        const float qp = D[D_QPOS + j] + dt * qv;
        if (qp > C.dof_upper[j]) qv = fminf(qv, 0.f);
        else if (qp < C.dof_lower[j]) qv = fmaxf(qv, 0.f);
        const float qn = fminf(fmaxf(qp, C.dof_lower[j]), C.dof_upper[j]);
        D[D_QVEL + j] = qv;
        D[D_QPOS + j] = qn;
        P[j] = qn;
        P[nd + j] = qv;
      }
    }
    if (lane == 0) {
      V3 bw = v3(Bs[7], Bs[8], Bs[9]), bv = v3(Bs[10], Bs[11], Bs[12]);
      const V3 g_body = tmv(ldm(S, B_ROT, 0), v3(0.f, 0.f, C.gravity));
      const V3 a_lin = add(ldv(S, B_AL, 0), g_body);
      bw = add(bw, scale(ldv(S, B_AA, 0), dt));
      bv = add(bv, scale(a_lin, dt));
      bw = v3(fminf(fmaxf(bw.x, -vm), vm), fminf(fmaxf(bw.y, -vm), vm), fminf(fmaxf(bw.z, -vm), vm));
      bv = v3(fminf(fmaxf(bv.x, -vm), vm), fminf(fmaxf(bv.y, -vm), vm), fminf(fmaxf(bv.z, -vm), vm));
      const float ang = sqrtf(dot(bw, bw)) + 1e-12f;
      const V3 axs = scale(bw, 1.0f / ang);
      const float half = 0.5f * (ang * dt);
      const float sh = sinf(half), dw = cosf(half);
      const float dx = axs.x * sh, dy = axs.y * sh, dz = axs.z * sh;
      const float aw = Bs[3], ax_ = Bs[4], ay_ = Bs[5], az_ = Bs[6];
      const float qw = aw * dw - ax_ * dx - ay_ * dy - az_ * dz;
      const float qx = aw * dx + ax_ * dw + ay_ * dz - az_ * dy;
      const float qy = aw * dy - ax_ * dz + ay_ * dw + az_ * dx;
      const float qz = aw * dz + ax_ * dy - ay_ * dx + az_ * dw;
      const float qn = sqrtf(qw * qw + qx * qx + qy * qy + qz * qz) + 1e-12f;
      const float bq[4] = {qw / qn, qx / qn, qy / qn, qz / qn};
      const V3 u = v3(bq[1], bq[2], bq[3]);
      const V3 uv = cross(u, bv);
      const V3 t = add(scale(uv, bq[0]), cross(u, uv));
      const V3 bp = add(v3(Bs[0], Bs[1], Bs[2]), scale(add(bv, scale(t, 2.0f)), dt));
      Bs[0] = bp.x; Bs[1] = bp.y; Bs[2] = bp.z;
      Bs[3] = bq[0]; Bs[4] = bq[1]; Bs[5] = bq[2]; Bs[6] = bq[3];
      Bs[7] = bw.x; Bs[8] = bw.y; Bs[9] = bw.z;
      Bs[10] = bv.x; Bs[11] = bv.y; Bs[12] = bv.z;
      P[2 * nd + 0] = bw.x; P[2 * nd + 1] = bw.y; P[2 * nd + 2] = bw.z;
      P[2 * nd + 3] = bq[0]; P[2 * nd + 4] = bq[1]; P[2 * nd + 5] = bq[2]; P[2 * nd + 6] = bq[3];
    }
    __syncthreads();
    flush_rows(smem, R.ds_out, k * 2 * nd, 2 * nd, 0, n, e0);
    flush_rows(smem, R.is_out, k * 7, 7, 2 * nd, n, e0);
    __syncthreads();
  }

  // --- outputs: final state, anchors, last substep's body forces and torques ---
  const int o_an = 13 + 2 * nd, o_fo = o_an + 3 * ncp, o_tq = o_fo + 3 * nb;
  for (int r = lane; r < 13; r += LANES) P[r] = Bs[r];
#pragma unroll
  for (int s = 0; s < DPL; ++s) {
    const int j = lane + s * LANES;
    if (j < nd) {
      P[13 + j] = D[D_QPOS + j];
      P[13 + nd + j] = D[D_QVEL + j];
      P[o_tq + j] = tau[s];
    }
  }
#pragma unroll
  for (int s = 0; s < PPL; ++s) {
    const int c = lane + s * LANES;
    if (c < ncp) { P[o_an + c] = ax[s]; P[o_an + ncp + c] = ay[s]; P[o_an + 2 * ncp + c] = az[s]; }
  }
#pragma unroll
  for (int s = 0; s < BPL; ++s) {
    const int i = lane + s * LANES;
    if (i < nb) { P[o_fo + 3 * i] = fb[s].x; P[o_fo + 3 * i + 1] = fb[s].y; P[o_fo + 3 * i + 2] = fb[s].z; }
  }
  __syncthreads();
  flush_rows(smem, R.st_out, 0, 13 + 2 * nd, 0, n, e0);
  flush_rows(smem, R.an_out, 0, 3 * ncp, o_an, n, e0);
  flush_rows(smem, R.fo_out, 0, 3 * nb, o_fo, n, e0);
  flush_rows(smem, R.tq_out, 0, nd, o_tq, n, e0);

  // --- ctx rows (engine_core.ctx_stack_rows) from FK of the final state ---
  if (with_ctx) {
    fk(S, lane);
    const int nf = C.nfeet, nk = C.nknees;
    __syncthreads();   // the flushes above have read the staging rows
    for (int f = lane; f < nf; f += LANES) {
      const int b = C.feet[f];
      const V3 pb = ldv(S, B_POS, b);
      const M3 rb = ldm(S, B_ROT, b);
      P[3 * f] = pb.x; P[3 * f + 1] = pb.y; P[3 * f + 2] = pb.z;
      const int o = 3 * nf + 5 * f;
      P[o] = rb.m[0][0]; P[o + 1] = rb.m[1][0]; P[o + 2] = rb.m[2][0];
      P[o + 3] = rb.m[2][1]; P[o + 4] = rb.m[2][2];
      const V3 ww = mv(rb, ldv(S, B_W, b));
      P[8 * nf + 2 * f] = ww.x; P[8 * nf + 2 * f + 1] = ww.y;
    }
    for (int q = lane; q < nk; q += LANES) {
      const int b = C.knees[q];
      P[10 * nf + 2 * q] = S[B_POS * MAXB + b]; P[10 * nf + 2 * q + 1] = S[(B_POS + 1) * MAXB + b];
    }
    __syncthreads();
    flush_rows(smem, R.cx_out, 0, 10 * nf + 2 * nk, 0, n, e0);
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

int ti5_decim_lanes() { return LANES; }

int ti5_decim_launch(const float* st, const float* an, const float* cl, const float* dy,
                     const float* ct, const float* la, const float* no, const float* ew,
                     const float* me, float* st_out, float* an_out, float* fo_out,
                     float* tq_out, float* ds_out, float* is_out, float* cx_out, int n,
                     int use_coulomb, int use_noise, int with_ctx, void* stream) {
  // the dynamic shared memory is above the 48 KB default
  const cudaError_t err = cudaFuncSetAttribute(
      decimation_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  Rows r = {st, an, cl, dy, ct, la, no, ew, me, st_out, an_out, fo_out, tq_out, ds_out, is_out, cx_out};
  const int blocks = (n + EPB - 1) / EPB;
  decimation_kernel<<<blocks, BLOCK, SMEM_BYTES, (cudaStream_t)stream>>>(r, n, use_coulomb,
                                                                         use_noise, with_ctx);
  return (int)cudaGetLastError();
}

}  // extern "C"
