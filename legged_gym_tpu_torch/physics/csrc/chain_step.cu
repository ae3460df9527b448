// Fused chain physics: one policy step (decimation x substeps) of the Go1
// chain model for N envs, kernel variant K1 (position drive, contact plane
// sampled once per policy step, no friction anchors, no trimesh wall rule).
//
// Replaces the TPU kernel legged_gym_tpu/physics/pallas_step.py
// (run_decimation_pallas, body `kernel`), whose body is
// legged_gym_tpu/physics/chain_step.py::one_sim_dt. The plain PyTorch
// version of the same function is legged_gym_tpu_torch/physics/chain_step.py
// ::run_decimation_chain; chain_kernel.py binds this file and documents the
// argument contract.
//
// Bound: about 3.4 KB move per env and launch (the 24x24 contact patch is
// most of it), about 6 MB at 1800 envs: 2 us at 3.35 TB/s. The arithmetic
// is a long serial chain of 3x3 / 6x6 algebra per env (FK, contacts, ABA),
// so the launch is bounded by latency, not by bytes or peak FLOP/s.
// Design: one thread per env, state in registers / thread-local memory for
// the whole decimation loop, the constant table read through the cache,
// blocks of 32 threads so the ~57 warps at 1800 envs spread over the SMs.
// Four cooperating threads per env (one per leg, shuffles for the base
// sums) is the next step for speed.
//
// The same file compiles as plain C++ (g++ -x c++) into a
// host loop over envs with the identical per-env arithmetic; the CPU tests
// use that build to check this source without a card.

#include <math.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD static inline
#endif

// ---------------------------------------------------------------- layout
// The model shape this kernel is built for (Go1): L levels x K chains,
// a base point group and one group per level. chain_kernel.py reads this
// through chain_step_layout() and refuses any other model.
#define L_LVL 3
#define K_CH 4
#define NG 4
#define NB 17
#define S_BASE 8
#define S_L0 4
#define S_L1 8
#define S_L2 9
#define NPTS (S_BASE + K_CH * (S_L0 + S_L1 + S_L2))   // 92

// constant table: scalars, then one record per joint (l, k), then one per
// contact point (base group slots, then level groups slot-major, chain-minor)
#define N_SCALAR 32
#define JSTRIDE 42
#define PSTRIDE 11
#define JOFF N_SCALAR
#define POFF (JOFF + L_LVL * K_CH * JSTRIDE)
#define N_CONST (POFF + NPTS * PSTRIDE)

// scalar slots
#define C_DT 0
#define C_GX 1
#define C_GY 2
#define C_GZ 3
#define C_LIM_K 4
#define C_LIM_D 5
#define C_ANG_CAP 6
#define C_LIN_CAP 7
#define C_MU_T 8
#define C_SLIP 9
#define C_BAUM 10
#define C_BORDER 11
#define C_HS 12
#define C_INV_HS 13
#define C_LIM_EXTRA 14
#define C_HAS_DAMP 15
#define C_HALF_DT 16
#define C_S_CLAMP 17

// joint record fields
#define J_RJA 0
#define J_RJB 9
#define J_RJC 18
#define J_AX 27
#define J_PJ 30
#define J_KP 33
#define J_KD 34
#define J_EFF 35
#define J_IMP 36
#define J_LO 37
#define J_HI 38
#define J_QDCAP 39
#define J_DAMP 40
#define J_ARM 41

// point record fields
#define P_OFF 0
#define P_RAD 3
#define P_IMN 4
#define P_IMT 5
#define P_MET 6
#define P_VP 7
#define P_KS 8
#define P_ACT 9
#define P_BODY 10

// slots per chain of group g, and the first point index of group g
HD int group_size(int g) {
  return g == 0 ? S_BASE : g == 1 ? S_L0 : g == 2 ? S_L1 : S_L2;
}
HD int group_base(int g) {
  return g == 0 ? 0
       : g == 1 ? S_BASE
       : g == 2 ? S_BASE + K_CH * S_L0
                : S_BASE + K_CH * (S_L0 + S_L1);
}

// ------------------------------------------------------------ small algebra
struct V3 { float x, y, z; };
struct M3 { float a[3][3]; };

HD V3 v3(float x, float y, float z) { V3 r; r.x = x; r.y = y; r.z = z; return r; }
HD V3 vadd(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
HD V3 vsub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
HD V3 vscale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
HD V3 vneg(V3 a) { return v3(-a.x, -a.y, -a.z); }
HD float vdot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
HD V3 vcross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
HD V3 vload(const float* p) { return v3(p[0], p[1], p[2]); }

HD V3 mv(const M3& A, V3 v) {
  return v3(A.a[0][0] * v.x + A.a[0][1] * v.y + A.a[0][2] * v.z,
            A.a[1][0] * v.x + A.a[1][1] * v.y + A.a[1][2] * v.z,
            A.a[2][0] * v.x + A.a[2][1] * v.y + A.a[2][2] * v.z);
}
HD V3 mtv(const M3& A, V3 v) {
  return v3(A.a[0][0] * v.x + A.a[1][0] * v.y + A.a[2][0] * v.z,
            A.a[0][1] * v.x + A.a[1][1] * v.y + A.a[2][1] * v.z,
            A.a[0][2] * v.x + A.a[1][2] * v.y + A.a[2][2] * v.z);
}
HD M3 mm(const M3& A, const M3& B) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r.a[i][j] = A.a[i][0] * B.a[0][j] + A.a[i][1] * B.a[1][j]
                + A.a[i][2] * B.a[2][j];
  return r;
}
// A @ B^T
HD M3 mmt(const M3& A, const M3& B) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r.a[i][j] = A.a[i][0] * B.a[j][0] + A.a[i][1] * B.a[j][1]
                + A.a[i][2] * B.a[j][2];
  return r;
}
HD M3 mtrans(const M3& A) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.a[i][j] = A.a[j][i];
  return r;
}
HD M3 madd(const M3& A, const M3& B) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.a[i][j] = A.a[i][j] + B.a[i][j];
  return r;
}
HD M3 msub(const M3& A, const M3& B) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.a[i][j] = A.a[i][j] - B.a[i][j];
  return r;
}
HD M3 skew(V3 v) {
  M3 r;
  r.a[0][0] = 0.f;  r.a[0][1] = -v.z; r.a[0][2] = v.y;
  r.a[1][0] = v.z;  r.a[1][1] = 0.f;  r.a[1][2] = -v.x;
  r.a[2][0] = -v.y; r.a[2][1] = v.x;  r.a[2][2] = 0.f;
  return r;
}
// X @ skew(v)
HD M3 mm_skew(const M3& X, V3 v) {
  M3 r;
  for (int i = 0; i < 3; ++i) {
    r.a[i][0] = X.a[i][1] * v.z - X.a[i][2] * v.y;
    r.a[i][1] = X.a[i][2] * v.x - X.a[i][0] * v.z;
    r.a[i][2] = X.a[i][0] * v.y - X.a[i][1] * v.x;
  }
  return r;
}
// skew(v) @ X
HD M3 skew_mm(V3 v, const M3& X) {
  M3 r;
  for (int j = 0; j < 3; ++j) {
    r.a[0][j] = v.y * X.a[2][j] - v.z * X.a[1][j];
    r.a[1][j] = v.z * X.a[0][j] - v.x * X.a[2][j];
    r.a[2][j] = v.x * X.a[1][j] - v.y * X.a[0][j];
  }
  return r;
}
// R @ S @ R^T for symmetric S (upper triangle computed, mirrored)
HD M3 congruence_sym(const M3& R, const M3& S) {
  M3 T = mmt(S, R);
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = i; j < 3; ++j) {
      float v = R.a[i][0] * T.a[0][j] + R.a[i][1] * T.a[1][j]
              + R.a[i][2] * T.a[2][j];
      r.a[i][j] = v;
      r.a[j][i] = v;
    }
  return r;
}
// scale * a a^T
HD M3 outer_sym(V3 a, float scale) {
  float d0 = a.x * scale, d1 = a.y * scale, d2 = a.z * scale;
  float o01 = d0 * a.y, o02 = d0 * a.z, o12 = d1 * a.z;
  M3 r;
  r.a[0][0] = d0 * a.x; r.a[0][1] = o01;      r.a[0][2] = o02;
  r.a[1][0] = o01;      r.a[1][1] = d1 * a.y; r.a[1][2] = o12;
  r.a[2][0] = o02;      r.a[2][1] = o12;      r.a[2][2] = d2 * a.z;
  return r;
}
// s * (a b^T)
HD M3 outer_scaled(V3 a, V3 b, float s) {
  float av[3] = {a.x, a.y, a.z}, bv[3] = {b.x, b.y, b.z};
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.a[i][j] = s * (av[i] * bv[j]);
  return r;
}
HD void cofactors(const M3& A, float c[9], float* det) {
  c[0] = A.a[1][1] * A.a[2][2] - A.a[1][2] * A.a[2][1];
  c[1] = A.a[1][2] * A.a[2][0] - A.a[1][0] * A.a[2][2];
  c[2] = A.a[1][0] * A.a[2][1] - A.a[1][1] * A.a[2][0];
  c[3] = A.a[0][2] * A.a[2][1] - A.a[0][1] * A.a[2][2];
  c[4] = A.a[0][0] * A.a[2][2] - A.a[0][2] * A.a[2][0];
  c[5] = A.a[0][1] * A.a[2][0] - A.a[0][0] * A.a[2][1];
  c[6] = A.a[0][1] * A.a[1][2] - A.a[0][2] * A.a[1][1];
  c[7] = A.a[0][2] * A.a[1][0] - A.a[0][0] * A.a[1][2];
  c[8] = A.a[0][0] * A.a[1][1] - A.a[0][1] * A.a[1][0];
  *det = A.a[0][0] * c[0] + A.a[0][1] * c[1] + A.a[0][2] * c[2];
}
HD M3 inv33(const M3& A) {
  float c[9], det;
  cofactors(A, c, &det);
  float id = 1.0f / det;
  M3 r;
  r.a[0][0] = c[0] * id; r.a[0][1] = c[3] * id; r.a[0][2] = c[6] * id;
  r.a[1][0] = c[1] * id; r.a[1][1] = c[4] * id; r.a[1][2] = c[7] * id;
  r.a[2][0] = c[2] * id; r.a[2][1] = c[5] * id; r.a[2][2] = c[8] * id;
  return r;
}
HD V3 solve33(const M3& A, V3 b) {
  float c[9], det;
  cofactors(A, c, &det);
  float id = 1.0f / det;
  return v3((c[0] * b.x + c[3] * b.y + c[6] * b.z) * id,
            (c[1] * b.x + c[4] * b.y + c[7] * b.z) * id,
            (c[2] * b.x + c[5] * b.y + c[8] * b.z) * id);
}
// symmetric 6x6 block system [[AA, AB], [AB^T, BB]] x = b by the Schur
// complement of BB
HD void solve66_sym(const M3& AA, const M3& AB, const M3& BB, V3 b_top,
                    V3 b_bot, V3* x_top, V3* x_bot) {
  M3 BBinv = inv33(BB);
  M3 ABBinv = mm(AB, BBinv);
  M3 S = msub(AA, mmt(ABBinv, AB));
  V3 rhs = vsub(b_top, mv(ABBinv, b_bot));
  *x_top = solve33(S, rhs);
  *x_bot = mv(BBinv, vsub(b_bot, mtv(AB, *x_top)));
}
HD M3 quat_to_matrix(const float qt[4]) {
  float x = qt[0], y = qt[1], z = qt[2], w = qt[3];
  float xx = x * x, yy = y * y, zz = z * z;
  float xy = x * y, xz = x * z, yz = y * z;
  float wx = w * x, wy = w * y, wz = w * z;
  M3 r;
  r.a[0][0] = 1.f - 2.f * (yy + zz); r.a[0][1] = 2.f * (xy - wz);
  r.a[0][2] = 2.f * (xz + wy);
  r.a[1][0] = 2.f * (xy + wz); r.a[1][1] = 1.f - 2.f * (xx + zz);
  r.a[1][2] = 2.f * (yz - wx);
  r.a[2][0] = 2.f * (xz - wy); r.a[2][1] = 2.f * (yz + wx);
  r.a[2][2] = 1.f - 2.f * (xx + yy);
  return r;
}
HD float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// --------------------------------------------------------------- arguments
struct Args {
  const float* lp_base;   // (10, N)
  const float* lp_lvl;    // (L, 10, K, N)
  const float* mu;        // (N)
  const float* targets;   // (L, K, N)
  const float* ph;        // (S, S, N)
  const int* r0;          // (N)
  const int* c0;          // (N)
  const float* pos;       // (3, N)
  const float* quat;      // (4, N)
  const float* vel;       // (6, N)
  const float* q;         // (L, K, N)
  const float* qd;        // (L, K, N)
  const float* cst;       // (N_CONST)
  float* pos_o;
  float* quat_o;
  float* vel_o;
  float* q_o;
  float* qd_o;
  float* tau_o;           // (L, K, N)
  float* body_f_o;        // (3, NB, N)
  int n;
  int S;                  // contact patch size
  int decimation;
  int substeps;
};

// plane record per point: c0, dhdx, dhdy, nx, ny, nz, gain
#define PL 7

// bilinear height + gradient against the env's patch, then the plane
// constants with the direction-aware apparent mass
HD void make_plane(const Args& A, int e, const float* P, float x, float y,
                   float r0f, float c0f, float* pl) {
  const float* C = A.cst;
  const int S = A.S;
  const int n = A.n;
  float hs = C[C_HS], inv_hs = C[C_INV_HS], smax = C[C_S_CLAMP];
  float fx = clampf((x + C[C_BORDER]) / hs - r0f, 0.f, smax);
  float fy = clampf((y + C[C_BORDER]) / hs - c0f, 0.f, smax);
  float ixf = floorf(fx), iyf = floorf(fy);
  float tx = fx - ixf, ty = fy - iyf;
  int ix = (int)ixf, iy = (int)iyf;
  const float* ph = A.ph;
  float h00 = ph[(size_t)(ix * S + iy) * n + e];
  float h01 = ph[(size_t)(ix * S + iy + 1) * n + e];
  float h10 = ph[(size_t)((ix + 1) * S + iy) * n + e];
  float h11 = ph[(size_t)((ix + 1) * S + iy + 1) * n + e];
  float txp0 = (1.f - tx) * h00 + tx * h10;
  float txp1 = (1.f - tx) * h01 + tx * h11;
  float gxp0 = -inv_hs * h00 + inv_hs * h10;
  float gxp1 = -inv_hs * h01 + inv_hs * h11;
  float h = txp0 * (1.f - ty) + txp1 * ty;
  float dhdy = txp0 * -inv_hs + txp1 * inv_hs;
  float dhdx = gxp0 * (1.f - ty) + gxp1 * ty;
  float inv_norm = 1.f / sqrtf(1.f + dhdx * dhdx + dhdy * dhdy);
  float nz = inv_norm;
  float nz2 = nz * nz;
  pl[0] = h - dhdx * x - dhdy * y;
  pl[1] = dhdx;
  pl[2] = dhdy;
  pl[3] = -dhdx * inv_norm;
  pl[4] = -dhdy * inv_norm;
  pl[5] = nz;
  pl[6] = (1.f / (nz2 * P[P_IMN] + (1.f - nz2) * P[P_IMT]) / C[C_DT])
        * P[P_ACT];
}

// implicit impulse contact force at one point against its cached plane
HD V3 contact_force(const float* C, const float* P, const float* pl, V3 p,
                    V3 v, float mu_env) {
  float dt = C[C_DT];
  float nx = pl[3], ny = pl[4], nz = pl[5];
  float h = pl[0] + pl[1] * p.x + pl[2] * p.y;
  float depth = P[P_RAD] + (h - p.z) * nz;
  float v_n = v.x * nx + v.y * ny + v.z * nz;
  float v_push = fminf(C[C_BAUM] * depth / dt, P[P_VP]);
  float fn_raw = pl[6] * fmaxf(v_push - v_n, 0.f)
               + P[P_KS] * P[P_ACT] * fminf(depth, 0.015f)
                 * (v_n < 0.05f ? 1.f : 0.f);
  float fn = depth > 0.f ? fn_raw : 0.f;
  float vtx = v.x - v_n * nx, vty = v.y - v_n * ny, vtz = v.z - v_n * nz;
  float mu = 0.5f * (mu_env + C[C_MU_T]);
  float vt = sqrtf(vtx * vtx + vty * vty + vtz * vtz);
  float ft = fminf(mu * fn / (vt + C[C_SLIP]), P[P_MET] / dt);
  return v3(fn * nx - ft * vtx, fn * ny - ft * vty, fn * nz - ft * vtz);
}

// joint rotation R(q) = RjA cos q + RjB sin q + RjC
HD M3 joint_rot(const float* J, float qv) {
  float cq = cosf(qv), sq = sinf(qv);
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r.a[i][j] = J[J_RJA + i * 3 + j] * cq + J[J_RJB + i * 3 + j] * sq
                + J[J_RJC + i * 3 + j];
  return r;
}

// articulated-body pass 1 for one link: inertia blocks and bias wrench
HD void pass1(const float par[10], const M3& Rw, V3 w, V3 v, V3 g, V3 f_ext,
              V3 n_ext, M3* IA_A, M3* IA_B, M3* IA_C, V3* pn, V3* pf) {
  float m = par[0];
  V3 h = v3(par[1], par[2], par[3]);
  M3 A;
  A.a[0][0] = par[4]; A.a[0][1] = par[5]; A.a[0][2] = par[6];
  A.a[1][0] = par[5]; A.a[1][1] = par[7]; A.a[1][2] = par[8];
  A.a[2][0] = par[6]; A.a[2][1] = par[8]; A.a[2][2] = par[9];
  *IA_A = A;
  *IA_B = skew(h);
  M3 Cm;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Cm.a[i][j] = (i == j) ? m : 0.f;
  *IA_C = Cm;
  V3 n_m = vadd(mv(A, w), vcross(h, v));
  V3 f_m = vsub(vscale(v, m), vcross(h, w));
  V3 pA_n = vadd(vcross(w, n_m), vcross(v, f_m));
  V3 pA_f = vcross(w, f_m);
  V3 gl = mtv(Rw, g);
  V3 f_tot = vadd(vscale(gl, m), mtv(Rw, f_ext));
  V3 n_tot = vadd(vcross(h, gl), mtv(Rw, n_ext));
  *pn = vsub(pA_n, n_tot);
  *pf = vsub(pA_f, f_tot);
}

// what pass 3 needs of one joint
struct Joint3 {
  M3 R;
  V3 Ua, Ul, ca, cl;
  float di, u;
};

// ------------------------------------------------------------- per env
HD void chain_env(const Args& A, int e) {
  const float* C = A.cst;
  const int n = A.n;
  const float dt = C[C_DT];
  const V3 g = v3(C[C_GX], C[C_GY], C[C_GZ]);

  float pos[3], qt[4], vel[6], q[L_LVL][K_CH], qd[L_LVL][K_CH];
  float tgt[L_LVL][K_CH], tau_pd[L_LVL][K_CH];
  for (int i = 0; i < 3; ++i) pos[i] = A.pos[i * n + e];
  for (int i = 0; i < 4; ++i) qt[i] = A.quat[i * n + e];
  for (int i = 0; i < 6; ++i) vel[i] = A.vel[i * n + e];
  for (int l = 0; l < L_LVL; ++l)
    for (int k = 0; k < K_CH; ++k) {
      int idx = (l * K_CH + k) * n + e;
      q[l][k] = A.q[idx];
      qd[l][k] = A.qd[idx];
      tgt[l][k] = A.targets[idx];
      tau_pd[l][k] = 0.f;
    }
  const float mu_env = A.mu[e];
  const float r0f = (float)A.r0[e], c0f = (float)A.c0[e];
  float lpb[10];
  for (int i = 0; i < 10; ++i) lpb[i] = A.lp_base[i * n + e];

  // ---- contact planes, sampled once from the entry state ----
  float plane[NPTS][PL];
  {
    M3 R0 = quat_to_matrix(qt);
    V3 p0 = vload(pos);
    for (int s = 0; s < S_BASE; ++s) {
      const float* P = C + POFF + s * PSTRIDE;
      V3 pp = vadd(p0, mv(R0, vload(P + P_OFF)));
      make_plane(A, e, P, pp.x, pp.y, r0f, c0f, plane[s]);
    }
    for (int k = 0; k < K_CH; ++k) {
      M3 Rp = R0;
      V3 pp = p0;
      for (int l = 0; l < L_LVL; ++l) {
        const float* J = C + JOFF + (l * K_CH + k) * JSTRIDE;
        M3 R = joint_rot(J, q[l][k]);
        V3 pw = vadd(pp, mv(Rp, vload(J + J_PJ)));
        M3 Rw = mm(Rp, R);
        int gi = l + 1;
        for (int s = 0; s < group_size(gi); ++s) {
          int pidx = group_base(gi) + s * K_CH + k;
          const float* P = C + POFF + pidx * PSTRIDE;
          V3 cp = vadd(pw, mv(Rw, vload(P + P_OFF)));
          make_plane(A, e, P, cp.x, cp.y, r0f, c0f, plane[pidx]);
        }
        Rp = Rw;
        pp = pw;
      }
    }
  }

  float bf[NB][3];
  const int n_sub = A.decimation * A.substeps;
  for (int it = 0; it < n_sub; ++it) {
    for (int b = 0; b < NB; ++b) bf[b][0] = bf[b][1] = bf[b][2] = 0.f;
    M3 R0 = quat_to_matrix(qt);
    V3 p0 = vload(pos);
    V3 w0 = v3(vel[0], vel[1], vel[2]);
    V3 v0 = v3(vel[3], vel[4], vel[5]);

    // ---- base point group -> base wrench ----
    V3 f_base = v3(0.f, 0.f, 0.f), n_base = v3(0.f, 0.f, 0.f);
    for (int s = 0; s < S_BASE; ++s) {
      const float* P = C + POFF + s * PSTRIDE;
      V3 off = vload(P + P_OFF);
      V3 pp = vadd(p0, mv(R0, off));
      V3 pv = mv(R0, vadd(v0, vcross(w0, off)));
      V3 f = contact_force(C, P, plane[s], pp, pv, mu_env);
      f_base = vadd(f_base, f);
      n_base = vadd(n_base, vcross(vsub(pp, p0), f));
      int b = (int)P[P_BODY];
      bf[b][0] += f.x; bf[b][1] += f.y; bf[b][2] += f.z;
    }
    M3 bA, bB, bC;
    V3 bpn, bpf;
    pass1(lpb, R0, w0, v0, g, f_base, n_base, &bA, &bB, &bC, &bpn, &bpf);

    // ---- per chain: FK, contacts, pass 1, pass 2 into the base ----
    Joint3 jt[K_CH][L_LVL];
    float tau_tot[L_LVL];
    for (int k = 0; k < K_CH; ++k) {
      M3 Rw[L_LVL], Rl[L_LVL];
      V3 pw[L_LVL], wl[L_LVL], vl[L_LVL];
      M3 IAa[L_LVL], IAb[L_LVL], IAc[L_LVL];
      V3 pAn[L_LVL], pAf[L_LVL];
      float imp[L_LVL];
      for (int l = 0; l < L_LVL; ++l) {
        const float* J = C + JOFF + (l * K_CH + k) * JSTRIDE;
        M3 Rp = l == 0 ? R0 : Rw[l - 1];
        V3 pp = l == 0 ? p0 : pw[l - 1];
        V3 wp = l == 0 ? w0 : wl[l - 1];
        V3 vp = l == 0 ? v0 : vl[l - 1];
        V3 pj = vload(J + J_PJ);
        V3 ax = vload(J + J_AX);
        M3 R = joint_rot(J, q[l][k]);
        Rl[l] = R;
        Rw[l] = mm(Rp, R);
        pw[l] = vadd(pp, mv(Rp, pj));
        wl[l] = vadd(mtv(R, wp), vscale(ax, qd[l][k]));
        vl[l] = mtv(R, vadd(vp, vcross(wp, pj)));

        // contacts of this link
        V3 fl = v3(0.f, 0.f, 0.f), nl = v3(0.f, 0.f, 0.f);
        int gi = l + 1;
        for (int s = 0; s < group_size(gi); ++s) {
          int pidx = group_base(gi) + s * K_CH + k;
          const float* P = C + POFF + pidx * PSTRIDE;
          V3 off = vload(P + P_OFF);
          V3 cp = vadd(pw[l], mv(Rw[l], off));
          V3 cv = mv(Rw[l], vadd(vl[l], vcross(wl[l], off)));
          V3 f = contact_force(C, P, plane[pidx], cp, cv, mu_env);
          fl = vadd(fl, f);
          nl = vadd(nl, vcross(vsub(cp, pw[l]), f));
          if (P[P_ACT] != 0.f) {
            int b = (int)P[P_BODY];
            bf[b][0] += f.x; bf[b][1] += f.y; bf[b][2] += f.z;
          }
        }

        // joint torque: PD + limit spring (+ URDF damping)
        float qv = q[l][k], qdv = qd[l][k];
        float tau = clampf(J[J_KP] * (tgt[l][k] - qv) - J[J_KD] * qdv,
                           -J[J_EFF], J[J_EFF]);
        tau_pd[l][k] = tau;
        float over = fmaxf(qv - J[J_HI], 0.f);
        float under = fmaxf(J[J_LO] - qv, 0.f);
        float active = (over > 0.f || under > 0.f) ? 1.f : 0.f;
        float tau_lim = C[C_LIM_K] * (under - over)
                      - C[C_LIM_D] * active * qdv;
        float tt = tau + tau_lim;
        if (C[C_HAS_DAMP] != 0.f) tt = tt - J[J_DAMP] * qdv;
        tau_tot[l] = tt;
        imp[l] = J[J_IMP] + C[C_LIM_EXTRA] * active;

        float par[10];
        for (int i = 0; i < 10; ++i)
          par[i] = A.lp_lvl[((l * 10 + i) * K_CH + k) * n + e];
        pass1(par, Rw[l], wl[l], vl[l], g, fl, nl, &IAa[l], &IAb[l],
              &IAc[l], &pAn[l], &pAf[l]);
      }

      // pass 2: tips -> base
      for (int l = L_LVL - 1; l >= 0; --l) {
        const float* J = C + JOFF + (l * K_CH + k) * JSTRIDE;
        V3 ax = vload(J + J_AX);
        V3 pj = vload(J + J_PJ);
        V3 Sqd = vscale(ax, qd[l][k]);
        V3 ca = vcross(wl[l], Sqd);
        V3 cl = vcross(vl[l], Sqd);
        V3 Ua = mv(IAa[l], ax);
        V3 Ul = mtv(IAb[l], ax);
        float D = vdot(ax, Ua) + J[J_ARM] + imp[l];
        float u = tau_tot[l] - vdot(ax, pAn[l]);
        float di = 1.0f / D;
        Joint3& js = jt[k][l];
        js.R = Rl[l]; js.Ua = Ua; js.Ul = Ul; js.ca = ca; js.cl = cl;
        js.di = di; js.u = u;

        M3 Ia_A = msub(IAa[l], outer_sym(Ua, di));
        M3 Ia_B = msub(IAb[l], outer_scaled(Ua, Ul, di));
        M3 Ia_C = msub(IAc[l], outer_sym(Ul, di));
        float du = di * u;
        V3 pa_n = vadd(vadd(vadd(pAn[l], mv(Ia_A, ca)), mv(Ia_B, cl)),
                       vscale(Ua, du));
        V3 pa_f = vadd(vadd(vadd(pAf[l], mtv(Ia_B, ca)), mv(Ia_C, cl)),
                       vscale(Ul, du));
        const M3& R = Rl[l];
        M3 RA = congruence_sym(R, Ia_A);
        M3 RB = mm(R, mmt(Ia_B, R));
        M3 RC = congruence_sym(R, Ia_C);
        M3 RBp = mm_skew(RB, pj);
        M3 pRC = skew_mm(pj, RC);
        M3 A_p = msub(msub(msub(RA, RBp), mtrans(RBp)),
                      skew_mm(pj, mm_skew(RC, pj)));
        M3 B_p = madd(RB, pRC);
        V3 Rf = mv(R, pa_f);
        V3 n_p = vadd(mv(R, pa_n), vcross(pj, Rf));
        if (l > 0) {
          IAa[l - 1] = madd(IAa[l - 1], A_p);
          IAb[l - 1] = madd(IAb[l - 1], B_p);
          IAc[l - 1] = madd(IAc[l - 1], RC);
          pAn[l - 1] = vadd(pAn[l - 1], n_p);
          pAf[l - 1] = vadd(pAf[l - 1], Rf);
        } else {
          bA = madd(bA, A_p);
          bB = madd(bB, B_p);
          bC = madd(bC, RC);
          bpn = vadd(bpn, n_p);
          bpf = vadd(bpf, Rf);
        }
      }
    }

    // ---- base solve ----
    V3 a0a, a0l;
    solve66_sym(bA, bB, bC, vneg(bpn), vneg(bpf), &a0a, &a0l);

    // ---- pass 3 + joint integration ----
    for (int k = 0; k < K_CH; ++k) {
      V3 aa = a0a, al = a0l;
      for (int l = 0; l < L_LVL; ++l) {
        const float* J = C + JOFF + (l * K_CH + k) * JSTRIDE;
        const Joint3& js = jt[k][l];
        V3 pj = vload(J + J_PJ);
        V3 ax = vload(J + J_AX);
        V3 ap_ang = vadd(mtv(js.R, aa), js.ca);
        V3 ap_lin = vadd(mtv(js.R, vadd(al, vcross(aa, pj))), js.cl);
        float qdd = js.di * (js.u - vdot(js.Ua, ap_ang)
                             - vdot(js.Ul, ap_lin));
        aa = vadd(ap_ang, vscale(ax, qdd));
        al = ap_lin;
        float cap = J[J_QDCAP];
        float qdn = clampf(qd[l][k] + dt * qdd, -cap, cap);
        float qn = q[l][k] + dt * qdn;
        float lo = J[J_LO], hi = J[J_HI];
        if (qn > hi && qdn > 0.f) qdn = 0.f;
        if (qn < lo && qdn < 0.f) qdn = 0.f;
        q[l][k] = clampf(qn, lo, hi);
        qd[l][k] = qdn;
      }
    }

    // ---- base integration ----
    float ac = C[C_ANG_CAP], lc = C[C_LIN_CAP];
    vel[0] = clampf(vel[0] + dt * a0a.x, -ac, ac);
    vel[1] = clampf(vel[1] + dt * a0a.y, -ac, ac);
    vel[2] = clampf(vel[2] + dt * a0a.z, -ac, ac);
    vel[3] = clampf(vel[3] + dt * a0l.x, -lc, lc);
    vel[4] = clampf(vel[4] + dt * a0l.y, -lc, lc);
    vel[5] = clampf(vel[5] + dt * a0l.z, -lc, lc);
    {
      V3 qv = v3(qt[0], qt[1], qt[2]);
      V3 vb = v3(vel[3], vel[4], vel[5]);
      V3 t = vscale(vcross(qv, vb), 2.f);
      V3 rot = vadd(vadd(vb, vscale(t, qt[3])), vcross(qv, t));
      pos[0] = pos[0] + dt * rot.x;
      pos[1] = pos[1] + dt * rot.y;
      pos[2] = pos[2] + dt * rot.z;
      float hd = C[C_HALF_DT];
      float bx = vel[0] * hd, by = vel[1] * hd, bz = vel[2] * hd, bw = 1.f;
      float ax_ = qt[0], ay = qt[1], az = qt[2], aw = qt[3];
      float nq0 = aw * bx + ax_ * bw + ay * bz - az * by;
      float nq1 = aw * by - ax_ * bz + ay * bw + az * bx;
      float nq2 = aw * bz + ax_ * by - ay * bx + az * bw;
      float nq3 = aw * bw - ax_ * bx - ay * by - az * bz;
      float ss = nq0 * nq0 + nq1 * nq1 + nq2 * nq2 + nq3 * nq3;
      float inv = 1.f / sqrtf(fmaxf(ss, 1e-18f));
      qt[0] = nq0 * inv; qt[1] = nq1 * inv; qt[2] = nq2 * inv;
      qt[3] = nq3 * inv;
    }
  }

  for (int i = 0; i < 3; ++i) A.pos_o[i * n + e] = pos[i];
  for (int i = 0; i < 4; ++i) A.quat_o[i * n + e] = qt[i];
  for (int i = 0; i < 6; ++i) A.vel_o[i * n + e] = vel[i];
  for (int l = 0; l < L_LVL; ++l)
    for (int k = 0; k < K_CH; ++k) {
      int idx = (l * K_CH + k) * n + e;
      A.q_o[idx] = q[l][k];
      A.qd_o[idx] = qd[l][k];
      A.tau_o[idx] = tau_pd[l][k];
    }
  for (int b = 0; b < NB; ++b)
    for (int i = 0; i < 3; ++i) A.body_f_o[(i * NB + b) * n + e] = bf[b][i];
}

// ------------------------------------------------------------ entry points
#if defined(__CUDACC__)
__global__ void __launch_bounds__(32)
chain_step_kernel(Args a) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < a.n) chain_env(a, e);
}
#define EXPORT extern "C" __attribute__((visibility("default")))
#else
#define EXPORT extern "C"
#endif

// layout of the model this file is built for:
// [L, K, NG, S_0..S_{NG-1}, NB, N_CONST, N_SCALAR, JSTRIDE, PSTRIDE]
EXPORT int chain_step_layout(int* out, int cap) {
  int v[] = {L_LVL, K_CH, NG, S_BASE, S_L0, S_L1, S_L2, NB, N_CONST,
             N_SCALAR, JSTRIDE, PSTRIDE};
  int m = (int)(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < m && i < cap; ++i) out[i] = v[i];
  return m;
}

// One policy step for n envs. On the card: launches on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted). In the host
// build: runs the envs in a loop and returns 0.
EXPORT int chain_step_run(
    const float* lp_base, const float* lp_lvl, const float* mu,
    const float* targets, const float* ph, const int* r0, const int* c0,
    const float* pos, const float* quat, const float* vel, const float* q,
    const float* qd, const float* cst, float* pos_o, float* quat_o,
    float* vel_o, float* q_o, float* qd_o, float* tau_o, float* body_f_o,
    int n, int S, int decimation, int substeps, void* stream) {
  Args a;
  a.lp_base = lp_base; a.lp_lvl = lp_lvl; a.mu = mu; a.targets = targets;
  a.ph = ph; a.r0 = r0; a.c0 = c0; a.pos = pos; a.quat = quat; a.vel = vel;
  a.q = q; a.qd = qd; a.cst = cst; a.pos_o = pos_o; a.quat_o = quat_o;
  a.vel_o = vel_o; a.q_o = q_o; a.qd_o = qd_o; a.tau_o = tau_o;
  a.body_f_o = body_f_o; a.n = n; a.S = S; a.decimation = decimation;
  a.substeps = substeps;
  if (n <= 0) return 0;
#if defined(__CUDACC__)
  const int threads = 32;
  const int blocks = (n + threads - 1) / threads;
  chain_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
#else
  (void)stream;
  for (int e = 0; e < n; ++e) chain_env(a, e);
  return 0;
#endif
}
