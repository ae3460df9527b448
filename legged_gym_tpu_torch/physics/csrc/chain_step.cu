// Fused chain physics: one policy step (decimation x substeps) of a chain
// model (a floating base with K serial chains of L joints; Go1 by default,
// other shapes by -D) for N envs, in the four configurations of the TPU
// kernel it replaces:
//   K1  position drive, contact plane sampled once per launch, no wall rule;
//   K4  (FLAG_WARM) per-point static-friction anchors carried in and out,
//       the tangential contact force being the implicit anchored law
//       (legged_gym_tpu/physics/contact.py::anchored_tangential);
//   K2  (FLAG_PLANE_PER_DT) the plane re-sampled at the first substep of
//       every sim dt from that substep's kinematics, and / or (a wall
//       threshold > 0 in the constant table) the trimesh wall rule: a query
//       cell whose four corners spread more than the threshold collides as
//       a flat floor at its min corner;
//   K3  (FLAG_TORQUE) `targets` is a held torque clipped to the effort
//       limit in place of the PD law; the caller passes decimation = 1 and
//       the passive impedance in the table's J_IMP.
// The flags combine (ANYmal runs K3 + K4 + the wall rule in one launch).
//
// Replaces the TPU kernel legged_gym_tpu/physics/pallas_step.py
// (run_decimation_pallas, body `kernel`), whose body is
// legged_gym_tpu/physics/chain_step.py::one_sim_dt. The plain PyTorch
// version of the same function is legged_gym_tpu_torch/physics/chain_step.py
// ::run_decimation_chain; chain_kernel.py binds this file and documents the
// argument contract.
//
// Bound: a launch must move about 2.6 KB per env on Go1 (1.1 KB of state,
// link parameters and outputs, and of the 24x24 contact patch the four
// corners of each of the 92 contact points' query cells), about 4.7 MB at
// 1800 envs: 1.4 us at 3.35 TB/s, and its float operations take about 3 us
// at the card's float32 peak. Neither binds: per env the work is a long
// chain of dependent 3x3 / 6x6 algebra (FK down each chain, 92 contact
// points, three ABA passes, a 6x6 solve) repeated for every substep, so
// the launch is bounded by the latency of that chain and by how many envs
// the SMs hold at once to hide it.
// Design: a group of G_LANES consecutive lanes of a warp runs one env (a -D
// define; chain_kernel.py builds 8 and 16 and picks, per launch, the larger
// whose warps the card holds at once: chain_step_fit). Inside each substep the
// work is split by owner (see "lane group" below): a chain's FK and ABA
// passes 2 and 3 on one lane per chain, a contact point on the lane that
// owns it, a link's point sums and ABA pass 1 on the lane that owns the
// link, the base's state and its 6x6 solve on every lane alike. So one
// env's serial path per substep is ~NPTS/G points, one chain's L levels
// and a few exchanges instead of all of it, and 1800 Go1 envs fill every
// SM with several warps (57 warps at one thread per env, 900 at G = 16).
// Exchange goes through a per-env record in shared memory, with a warp
// barrier between phases: link frames fan out from a chain's lane to the
// lanes that own the link's points, point forces come back to the link's
// owner, the chains' inertias to every lane. Each sum runs on one lane in
// a fixed order (the order of the one-thread-per-env kernel before it),
// with no atomics, so a launch gives the same bits on every run, and every
// lane that needs the base's acceleration computes it from the same inputs
// in the same order. A point's contact plane (7 floats) and, with K4, its
// friction anchor (3 floats) stay in its owner lane's registers for the
// whole launch: the anchors are read once from `anc` and written once to
// `anc_o`. WARM is a template parameter (it adds the anchors and a second
// force law to every point: two instantiations keep K1 free of both). The
// torque drive, the per-sim-dt plane and the wall rule are run-time flags:
// each is one warp-uniform test per joint, per point and substep, or per
// plane; as template parameters they would multiply the instantiations
// (and the compile time of every layout's library) by eight.
//
// The same file compiles as plain C++ (g++ -x c++) into a host loop over
// envs in which each phase is a loop over the G lanes of one env and a
// local record stands in for shared memory: the arithmetic and its order
// are the card's, so the CPU tests check this source without a card.

#include <math.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD static inline
#endif

// ---------------------------------------------------------------- layout
// The model shape this kernel is built for: L_LVL levels x K_CH chains, a
// base point group of S_BASE slots and one group per level, level l with
// S_L<l> slots per chain; a size may be zero (A1 has no points on its hips,
// Cassie only on its last level). The sizes and the number of report bodies
// are -D defines (defaults: Go1; levels at and beyond L_LVL must be 0);
// chain_kernel.py builds one library per layout, reads it back through
// chain_step_layout() and refuses a model that does not match.
#ifndef L_LVL
#define L_LVL 3
#endif
#ifndef K_CH
#define K_CH 4
#endif
#ifndef NB
#define NB 17
#endif
#ifndef S_BASE
#define S_BASE 8
#endif
#ifndef S_L0
#define S_L0 4
#endif
#ifndef S_L1
#define S_L1 8
#endif
#ifndef S_L2
#define S_L2 9
#endif
#ifndef S_L3
#define S_L3 0
#endif
#ifndef S_L4
#define S_L4 0
#endif
#ifndef S_L5
#define S_L5 0
#endif
#ifndef S_L6
#define S_L6 0
#endif
#ifndef S_L7
#define S_L7 0
#endif
#define MAX_LVL 8
#define S_SUM (S_L0 + S_L1 + S_L2 + S_L3 + S_L4 + S_L5 + S_L6 + S_L7)
static_assert(L_LVL >= 1 && L_LVL <= MAX_LVL, "L_LVL out of range");
#define NG (1 + L_LVL)
#define NPTS (S_BASE + K_CH * S_SUM)          // Go1: 92
// arrays sized by these need at least one element
#define NPTS1 (NPTS > 0 ? NPTS : 1)
#define NB1 (NB > 0 ? NB : 1)

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
#define C_ANC_BETA 18
#define C_ANC_VMAX 19
#define C_ANC_STALE2 20
#define C_ANC_REL 21
#define C_WALL 22

// run-time flags of chain_step_run
#define FLAG_WARM 1
#define FLAG_TORQUE 2
#define FLAG_PLANE_PER_DT 4

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

// slots per chain of group g (0: the base group, 1 + l: level l), and the
// first point index of group g. The chains stop at the model's last level:
// compared against all MAX_LVL levels, a Go1 launch took measurably longer
// (scripts/kernel_numerics.py times a launch).
#define GB1 S_BASE
#define GB2 (GB1 + K_CH * S_L0)
#define GB3 (GB2 + K_CH * S_L1)
#define GB4 (GB3 + K_CH * S_L2)
#define GB5 (GB4 + K_CH * S_L3)
#define GB6 (GB5 + K_CH * S_L4)
#define GB7 (GB6 + K_CH * S_L5)
#define GB8 (GB7 + K_CH * S_L6)
#if L_LVL == 1
#define GS_LAST S_L0
#define GB_LAST GB1
#elif L_LVL == 2
#define GS_LAST S_L1
#define GB_LAST GB2
#elif L_LVL == 3
#define GS_LAST S_L2
#define GB_LAST GB3
#elif L_LVL == 4
#define GS_LAST S_L3
#define GB_LAST GB4
#elif L_LVL == 5
#define GS_LAST S_L4
#define GB_LAST GB5
#elif L_LVL == 6
#define GS_LAST S_L5
#define GB_LAST GB6
#elif L_LVL == 7
#define GS_LAST S_L6
#define GB_LAST GB7
#else
#define GS_LAST S_L7
#define GB_LAST GB8
#endif
HD int group_size(int g) {
  return g == 0 ? S_BASE
#if L_LVL > 1
       : g == 1 ? S_L0
#endif
#if L_LVL > 2
       : g == 2 ? S_L1
#endif
#if L_LVL > 3
       : g == 3 ? S_L2
#endif
#if L_LVL > 4
       : g == 4 ? S_L3
#endif
#if L_LVL > 5
       : g == 5 ? S_L4
#endif
#if L_LVL > 6
       : g == 6 ? S_L5
#endif
#if L_LVL > 7
       : g == 7 ? S_L6
#endif
       : GS_LAST;
}
HD int group_base(int g) {
  return g == 0 ? 0
#if L_LVL > 1
       : g == 1 ? GB1
#endif
#if L_LVL > 2
       : g == 2 ? GB2
#endif
#if L_LVL > 3
       : g == 3 ? GB3
#endif
#if L_LVL > 4
       : g == 4 ? GB4
#endif
#if L_LVL > 5
       : g == 5 ? GB5
#endif
#if L_LVL > 6
       : g == 6 ? GB6
#endif
#if L_LVL > 7
       : g == 7 ? GB7
#endif
       : GB_LAST;
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
  const float* anc;       // (3, NPTS, N) anchors in (K4), else null
  float* anc_o;           // (3, NPTS, N) anchors out (K4), else null
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
  int torque;             // FLAG_TORQUE: targets are held torques
  int plane_per_dt;       // FLAG_PLANE_PER_DT: plane sampled every sim dt
};

// plane record per point: c0, dhdx, dhdy, nx, ny, nz, gain
#define PL 7

// bilinear height + gradient against the env's patch (with the trimesh wall
// rule when the table's wall threshold is > 0), then the plane constants
// with the direction-aware apparent mass
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
  const float wall = C[C_WALL];
  if (wall > 0.f) {
    // the query cell is clamped to S - 2, so its four corners are the
    // cell's own; strictly below the bilinear height only
    float m4 = fminf(fminf(h00, h10), fminf(h01, h11));
    float big4 = fmaxf(fmaxf(h00, h10), fmaxf(h01, h11));
    float mq = (big4 - m4 > wall) ? m4 : 1e9f;
    if (mq < h) { h = mq; dhdx = 0.f; dhdy = 0.f; }
  }
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

// implicit impulse contact force at one point against its cached plane.
// WARM: the tangential term is the anchored static-friction law; the
// point's anchor is read from `anc` and the new one written to `anc_new`.
template <bool WARM>
HD V3 contact_force(const float* C, const float* P, const float* pl, V3 p,
                    V3 v, float mu_env, V3 anc, V3* anc_new) {
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
  if (WARM) {
    // inactive (padding) points sit 1e9 m clear: their anchors stay fresh
    float depth_a = depth - (1.f - P[P_ACT]) * 1e9f;
    float dxa = p.x - anc.x, dya = p.y - anc.y, dza = p.z - anc.z;
    bool is_near = depth_a > -C[C_ANC_REL];
    bool stale = (dxa * dxa + dya * dya + dza * dza) > C[C_ANC_STALE2];
    bool fresh = !is_near || stale;
    // nothing but the stale test may see the un-zeroed offset (a sentinel
    // anchor is 1e6 m away)
    if (fresh) { dxa = 0.f; dya = 0.f; dza = 0.f; }
    float dn = dxa * nx + dya * ny + dza * nz;
    dxa = dxa - dn * nx; dya = dya - dn * ny; dza = dza - dn * nz;
    float d_mag = sqrtf(dxa * dxa + dya * dya + dza * dza) + 1e-12f;
    float v_pull = fminf(C[C_ANC_BETA] * d_mag / dt, C[C_ANC_VMAX]);
    float g = P[P_MET] / dt;
    float ftx = g * (-v_pull * dxa / d_mag - vtx);
    float fty = g * (-v_pull * dya / d_mag - vty);
    float ftz = g * (-v_pull * dza / d_mag - vtz);
    float ft_mag = sqrtf(ftx * ftx + fty * fty + ftz * ftz) + 1e-9f;
    float scale = fminf(1.f, mu * fn / ft_mag);
    // sliding drags the anchor (return mapping); an unloaded but near
    // point keeps it; a fresh one snaps to the point
    if (fresh) {
      *anc_new = p;
    } else if (fn > 1e-3f) {
      *anc_new = v3(p.x - dxa * scale, p.y - dya * scale, p.z - dza * scale);
    } else {
      *anc_new = anc;
    }
    return v3(fn * nx + ftx * scale, fn * ny + fty * scale,
              fn * nz + ftz * scale);
  }
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

// a link's spatial inertia as the blocks [[A, skew(h)], [skew(h)^T, m I]]
// of its 10 parameters (m, h, the upper triangle of A)
HD void inertia_blocks(const float par[10], M3* IA_A, M3* IA_B, M3* IA_C) {
  float m = par[0];
  M3 A;
  A.a[0][0] = par[4]; A.a[0][1] = par[5]; A.a[0][2] = par[6];
  A.a[1][0] = par[5]; A.a[1][1] = par[7]; A.a[1][2] = par[8];
  A.a[2][0] = par[6]; A.a[2][1] = par[8]; A.a[2][2] = par[9];
  *IA_A = A;
  *IA_B = skew(v3(par[1], par[2], par[3]));
  M3 Cm;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Cm.a[i][j] = (i == j) ? m : 0.f;
  *IA_C = Cm;
}

// articulated-body pass 1 for one link: inertia blocks and bias wrench
HD void pass1(const float par[10], const M3& Rw, V3 w, V3 v, V3 g, V3 f_ext,
              V3 n_ext, M3* IA_A, M3* IA_B, M3* IA_C, V3* pn, V3* pf) {
  float m = par[0];
  V3 h = v3(par[1], par[2], par[3]);
  inertia_blocks(par, IA_A, IA_B, IA_C);
  const M3& A = *IA_A;
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

// ------------------------------------------------------------- lane group
// G_LANES consecutive lanes of a warp run one env. Owners, per substep:
//   chain k       lane k          FK, joint torques, ABA passes 2 and 3,
//                                 the state of its joints
//   link j        lane j % G      the sums of its points' wrenches and ABA
//                                 pass 1 (j = l * K + k; the base is j = NJ)
//   point p       lane p % G      its plane, anchor and contact force
//   body b        lane b % G      its contact-sensor sum (last substep)
//   every lane                    the base state, the base sums and the
//                                 6x6 solve, the same arithmetic in each
#ifndef G_LANES
#define G_LANES 16
#endif
static_assert(G_LANES >= 1 && G_LANES <= 32
              && (G_LANES & (G_LANES - 1)) == 0,
              "G_LANES must be a power of two of at most 32");
static_assert(G_LANES >= K_CH, "a lane group needs one lane per chain");
#define NJ (L_LVL * K_CH)
#define PPL ((NPTS1 + G_LANES - 1) / G_LANES)   // points per lane
#define JPL ((NJ + 1 + G_LANES - 1) / G_LANES)  // links per lane, base too
#define BPL ((NB1 + G_LANES - 1) / G_LANES)     // report bodies per lane

#if defined(__CUDACC__)
#define UNROLL _Pragma("unroll")
#else
#define UNROLL
#endif
// loops that index a Lane's arrays are unrolled, so the arrays stay in
// registers

HD void mstore(float* d, const M3& A) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) d[i * 3 + j] = A.a[i][j];
}
HD M3 mload(const float* s) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.a[i][j] = s[i * 3 + j];
  return r;
}
HD void vstore(float* d, V3 v) { d[0] = v.x; d[1] = v.y; d[2] = v.z; }

// the link (j = l * K + k, or NJ for the base) that point `pidx` rides on
HD int point_link(int pidx) {
  if (pidx < S_BASE) return NJ;
  for (int l = 0; l < L_LVL; ++l) {
    const int gb = group_base(l + 1);
    if (pidx < gb + K_CH * group_size(l + 1))
      return l * K_CH + (pidx - gb) % K_CH;
  }
  return NJ;
}

// A link's frame: world rotation and origin, angular and linear velocity in
// the link frame.
struct Frame {
  float R[9], p[3], w[3], v[3];
};

// articulated inertia blocks A, B, C and bias (n, f): the base's own after
// pass 1, or a chain's contribution to the base after pass 2
#define AB_A 0
#define AB_B 9
#define AB_C 18
#define AB_N 27
#define AB_F 30
#define AB_W 33

// What the lanes of one env exchange (shared memory on the card).
struct EnvShared {
  Frame fr[NJ];            // FK -> point owners, pass 1, pass 2
  float Rl[NJ][9];         // joint rotations R(q): FK -> passes 2 and 3
  float pt[NPTS1][6];      // point force and its moment about the link
                           // origin -> link sums, body sums
  float lk[NJ][16];        // pass-1 bias (n, f) and the 10 inertia
                           // parameters of each link -> pass 2
  float jt[NJ][14];        // Ua, Ul, ca, cl, 1/D, u: pass 2 -> pass 3
  float cb[K_CH][AB_W];    // each chain's contribution to the base
  float base[AB_W];        // the base's pass-1 blocks
};

// What one lane keeps in registers across the launch.
struct Lane {
  float pos[3], qt[4], vel[6];        // base state, alike in every lane
  float q[L_LVL], qd[L_LVL];          // chain `lane`'s joints (lane < K)
  float tgt[L_LVL], tau[L_LVL];
  float pl[PPL][PL];                  // planes of the lane's points
  float anc[PPL][3];                  // their anchors (WARM)
  int plink[PPL];                     // their links
  float mu, r0f, c0f;
  int e;                              // env (the last one past the end)
};

HD V3 base_w(const Lane& me) { return v3(me.vel[0], me.vel[1], me.vel[2]); }
HD V3 base_v(const Lane& me) { return v3(me.vel[3], me.vel[4], me.vel[5]); }

template <bool WARM>
HD void lane_init(const Args& A, Lane& me, int e, int lane) {
  const int n = A.n;
  me.e = e;
  for (int i = 0; i < 3; ++i) me.pos[i] = A.pos[i * n + e];
  for (int i = 0; i < 4; ++i) me.qt[i] = A.quat[i * n + e];
  for (int i = 0; i < 6; ++i) me.vel[i] = A.vel[i * n + e];
  UNROLL
  for (int l = 0; l < L_LVL; ++l) {
    const int idx = (l * K_CH + lane) * n + e;
    const bool mine = lane < K_CH;
    me.q[l] = mine ? A.q[idx] : 0.f;
    me.qd[l] = mine ? A.qd[idx] : 0.f;
    me.tgt[l] = mine ? A.targets[idx] : 0.f;
    me.tau[l] = 0.f;
  }
  me.mu = A.mu[e];
  me.r0f = (float)A.r0[e];
  me.c0f = (float)A.c0[e];
  UNROLL
  for (int i = 0; i < PPL; ++i) {
    const int pidx = lane + i * G_LANES;
    me.plink[i] = point_link(pidx);
    if (WARM && pidx < NPTS) {
      const size_t nn = (size_t)n;
      me.anc[i][0] = A.anc[(size_t)pidx * nn + e];
      me.anc[i][1] = A.anc[(size_t)(NPTS + pidx) * nn + e];
      me.anc[i][2] = A.anc[(size_t)(2 * NPTS + pidx) * nn + e];
    }
  }
}

// (a) FK of chain k on lane k: each link's frame into the record
HD void phase_fk(const Args& A, Lane& me, EnvShared& sh, int lane) {
  if (lane >= K_CH) return;
  const int k = lane;
  const float* C = A.cst;
  M3 Rp = quat_to_matrix(me.qt);
  V3 pp = vload(me.pos), wp = base_w(me), vp = base_v(me);
  UNROLL
  for (int l = 0; l < L_LVL; ++l) {
    const int j = l * K_CH + k;
    const float* J = C + JOFF + j * JSTRIDE;
    V3 pj = vload(J + J_PJ);
    V3 ax = vload(J + J_AX);
    M3 R = joint_rot(J, me.q[l]);
    M3 Rw = mm(Rp, R);
    V3 pw = vadd(pp, mv(Rp, pj));
    V3 wl = vadd(mtv(R, wp), vscale(ax, me.qd[l]));
    V3 vl = mtv(R, vadd(vp, vcross(wp, pj)));
    Frame& f = sh.fr[j];
    mstore(f.R, Rw); vstore(f.p, pw); vstore(f.w, wl); vstore(f.v, vl);
    mstore(sh.Rl[j], R);
    Rp = Rw; pp = pw; wp = wl; vp = vl;
  }
}

// (b) the lane's contact points: plane (at `resample`), force, moment
template <bool WARM>
HD void phase_points(const Args& A, Lane& me, EnvShared& sh, int lane,
                     bool resample) {
  const float* C = A.cst;
  const M3 R0 = quat_to_matrix(me.qt);
  UNROLL
  for (int i = 0; i < PPL; ++i) {
    const int pidx = lane + i * G_LANES;
    if (pidx >= NPTS) continue;
    const int j = me.plink[i];
    M3 R;
    V3 p, w, v;
    if (j == NJ) {
      R = R0; p = vload(me.pos); w = base_w(me); v = base_v(me);
    } else {
      const Frame& f = sh.fr[j];
      R = mload(f.R); p = vload(f.p); w = vload(f.w); v = vload(f.v);
    }
    const float* P = C + POFF + pidx * PSTRIDE;
    V3 off = vload(P + P_OFF);
    V3 cp = vadd(p, mv(R, off));
    V3 cv = mv(R, vadd(v, vcross(w, off)));
    if (resample) make_plane(A, me.e, P, cp.x, cp.y, me.r0f, me.c0f, me.pl[i]);
    V3 anc = v3(0.f, 0.f, 0.f), anc_new = anc;
    if (WARM) anc = v3(me.anc[i][0], me.anc[i][1], me.anc[i][2]);
    V3 fc = contact_force<WARM>(C, P, me.pl[i], cp, cv, me.mu, anc, &anc_new);
    if (WARM) {
      me.anc[i][0] = anc_new.x; me.anc[i][1] = anc_new.y;
      me.anc[i][2] = anc_new.z;
    }
    float* out = sh.pt[pidx];
    vstore(out, fc);
    vstore(out + 3, vcross(vsub(cp, p), fc));
  }
}

// (c) a link's point sums and ABA pass 1; at the last substep also the
// contact sensor of the lane's report bodies, written out
HD void phase_links(const Args& A, Lane& me, EnvShared& sh, int lane,
                    bool last, bool valid) {
  const float* C = A.cst;
  const int n = A.n, e = me.e;
  const V3 g = v3(C[C_GX], C[C_GY], C[C_GZ]);
  for (int m = 0; m < JPL; ++m) {
    const int j = lane + m * G_LANES;
    if (j > NJ) break;
    V3 fl = v3(0.f, 0.f, 0.f), nl = v3(0.f, 0.f, 0.f);
    M3 Rw;
    V3 w, v;
    float par[10];
    if (j == NJ) {
      for (int s = 0; s < S_BASE; ++s) {
        fl = vadd(fl, vload(sh.pt[s]));
        nl = vadd(nl, vload(sh.pt[s] + 3));
      }
      Rw = quat_to_matrix(me.qt); w = base_w(me); v = base_v(me);
      for (int i = 0; i < 10; ++i) par[i] = A.lp_base[i * n + e];
    } else {
      const int l = j / K_CH, k = j % K_CH;
      const int gb = group_base(l + 1), gs = group_size(l + 1);
      for (int s = 0; s < gs; ++s) {
        const float* pt = sh.pt[gb + s * K_CH + k];
        fl = vadd(fl, vload(pt));
        nl = vadd(nl, vload(pt + 3));
      }
      const Frame& f = sh.fr[j];
      Rw = mload(f.R); w = vload(f.w); v = vload(f.v);
      for (int i = 0; i < 10; ++i)
        par[i] = A.lp_lvl[((l * 10 + i) * K_CH + k) * n + e];
    }
    M3 IA, IB, IC;
    V3 pn, pf;
    pass1(par, Rw, w, v, g, fl, nl, &IA, &IB, &IC, &pn, &pf);
    if (j == NJ) {
      mstore(sh.base + AB_A, IA); mstore(sh.base + AB_B, IB);
      mstore(sh.base + AB_C, IC);
      vstore(sh.base + AB_N, pn); vstore(sh.base + AB_F, pf);
    } else {
      vstore(sh.lk[j], pn); vstore(sh.lk[j] + 3, pf);
      for (int i = 0; i < 10; ++i) sh.lk[j][6 + i] = par[i];
    }
  }
  if (!last) return;
  // per body, in the order of the points: the base group, then chain by
  // chain from the hip down (padding points report nothing)
  for (int m = 0; m < BPL; ++m) {
    const int b = lane + m * G_LANES;
    if (b >= NB) break;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int s = 0; s < S_BASE; ++s) {
      if ((int)C[POFF + s * PSTRIDE + P_BODY] != b) continue;
      s0 += sh.pt[s][0]; s1 += sh.pt[s][1]; s2 += sh.pt[s][2];
    }
    for (int k = 0; k < K_CH; ++k)
      for (int l = 0; l < L_LVL; ++l)
        for (int s = 0; s < group_size(l + 1); ++s) {
          const int pidx = group_base(l + 1) + s * K_CH + k;
          const float* P = C + POFF + pidx * PSTRIDE;
          if (P[P_ACT] == 0.f || (int)P[P_BODY] != b) continue;
          s0 += sh.pt[pidx][0]; s1 += sh.pt[pidx][1]; s2 += sh.pt[pidx][2];
        }
    if (valid) {
      A.body_f_o[(0 * NB + b) * n + e] = s0;
      A.body_f_o[(1 * NB + b) * n + e] = s1;
      A.body_f_o[(2 * NB + b) * n + e] = s2;
    }
  }
}

// (d, e) chain k on lane k: joint torques, then ABA pass 2 tips -> base;
// the chain's contribution to the base into the record
HD void phase_pass2(const Args& A, Lane& me, EnvShared& sh, int lane) {
  if (lane >= K_CH) return;
  const int k = lane;
  const float* C = A.cst;
  float tau_tot[L_LVL], imp[L_LVL];
  UNROLL
  for (int l = 0; l < L_LVL; ++l) {
    // PD (or the held torque) + limit spring (+ URDF damping)
    const float* J = C + JOFF + (l * K_CH + k) * JSTRIDE;
    float qv = me.q[l], qdv = me.qd[l];
    float tau_raw = A.torque
        ? me.tgt[l] : J[J_KP] * (me.tgt[l] - qv) - J[J_KD] * qdv;
    float tau = clampf(tau_raw, -J[J_EFF], J[J_EFF]);
    me.tau[l] = tau;
    float over = fmaxf(qv - J[J_HI], 0.f);
    float under = fmaxf(J[J_LO] - qv, 0.f);
    float active = (over > 0.f || under > 0.f) ? 1.f : 0.f;
    float tau_lim = C[C_LIM_K] * (under - over) - C[C_LIM_D] * active * qdv;
    float tt = tau + tau_lim;
    if (C[C_HAS_DAMP] != 0.f) tt = tt - J[J_DAMP] * qdv;
    tau_tot[l] = tt;
    imp[l] = J[J_IMP] + C[C_LIM_EXTRA] * active;
  }
  // the child link's articulated inertia and bias, seen from its parent
  M3 cA, cB, cC;
  V3 cn = v3(0.f, 0.f, 0.f), cf = cn;
  UNROLL
  for (int l = L_LVL - 1; l >= 0; --l) {
    const int j = l * K_CH + k;
    const float* J = C + JOFF + j * JSTRIDE;
    V3 ax = vload(J + J_AX);
    V3 pj = vload(J + J_PJ);
    const float* lk = sh.lk[j];
    M3 IAa, IAb, IAc;
    inertia_blocks(lk + 6, &IAa, &IAb, &IAc);
    V3 pAn = vload(lk), pAf = vload(lk + 3);
    if (l < L_LVL - 1) {
      IAa = madd(IAa, cA); IAb = madd(IAb, cB); IAc = madd(IAc, cC);
      pAn = vadd(pAn, cn); pAf = vadd(pAf, cf);
    }
    const Frame& fr = sh.fr[j];
    V3 Sqd = vscale(ax, me.qd[l]);
    V3 ca = vcross(vload(fr.w), Sqd);
    V3 cl = vcross(vload(fr.v), Sqd);
    V3 Ua = mv(IAa, ax);
    V3 Ul = mtv(IAb, ax);
    float D = vdot(ax, Ua) + J[J_ARM] + imp[l];
    float u = tau_tot[l] - vdot(ax, pAn);
    float di = 1.0f / D;
    float* js = sh.jt[j];
    vstore(js, Ua); vstore(js + 3, Ul); vstore(js + 6, ca); vstore(js + 9, cl);
    js[12] = di; js[13] = u;

    M3 Ia_A = msub(IAa, outer_sym(Ua, di));
    M3 Ia_B = msub(IAb, outer_scaled(Ua, Ul, di));
    M3 Ia_C = msub(IAc, outer_sym(Ul, di));
    float du = di * u;
    V3 pa_n = vadd(vadd(vadd(pAn, mv(Ia_A, ca)), mv(Ia_B, cl)),
                   vscale(Ua, du));
    V3 pa_f = vadd(vadd(vadd(pAf, mtv(Ia_B, ca)), mv(Ia_C, cl)),
                   vscale(Ul, du));
    const M3 R = mload(sh.Rl[j]);
    M3 RA = congruence_sym(R, Ia_A);
    M3 RB = mm(R, mmt(Ia_B, R));
    M3 RC = congruence_sym(R, Ia_C);
    M3 RBp = mm_skew(RB, pj);
    M3 pRC = skew_mm(pj, RC);
    cA = msub(msub(msub(RA, RBp), mtrans(RBp)),
              skew_mm(pj, mm_skew(RC, pj)));
    cB = madd(RB, pRC);
    cC = RC;
    cf = mv(R, pa_f);
    cn = vadd(mv(R, pa_n), vcross(pj, cf));
  }
  float* cb = sh.cb[k];
  mstore(cb + AB_A, cA); mstore(cb + AB_B, cB); mstore(cb + AB_C, cC);
  vstore(cb + AB_N, cn); vstore(cb + AB_F, cf);
}

// (f, g) every lane: the base sums and the 6x6 solve; chain k's pass 3 and
// joint integration on lane k; the base integration on every lane
HD void phase_solve(const Args& A, Lane& me, EnvShared& sh, int lane) {
  const float* C = A.cst;
  const float dt = C[C_DT];
  M3 bA = mload(sh.base + AB_A), bB = mload(sh.base + AB_B);
  M3 bC = mload(sh.base + AB_C);
  V3 bpn = vload(sh.base + AB_N), bpf = vload(sh.base + AB_F);
  for (int k = 0; k < K_CH; ++k) {
    const float* cb = sh.cb[k];
    bA = madd(bA, mload(cb + AB_A));
    bB = madd(bB, mload(cb + AB_B));
    bC = madd(bC, mload(cb + AB_C));
    bpn = vadd(bpn, vload(cb + AB_N));
    bpf = vadd(bpf, vload(cb + AB_F));
  }
  V3 a0a, a0l;
  solve66_sym(bA, bB, bC, vneg(bpn), vneg(bpf), &a0a, &a0l);

  if (lane < K_CH) {
    const int k = lane;
    V3 aa = a0a, al = a0l;
    UNROLL
    for (int l = 0; l < L_LVL; ++l) {
      const int j = l * K_CH + k;
      const float* J = C + JOFF + j * JSTRIDE;
      const float* js = sh.jt[j];
      const M3 R = mload(sh.Rl[j]);
      V3 pj = vload(J + J_PJ);
      V3 ax = vload(J + J_AX);
      V3 ap_ang = vadd(mtv(R, aa), vload(js + 6));
      V3 ap_lin = vadd(mtv(R, vadd(al, vcross(aa, pj))), vload(js + 9));
      float qdd = js[12] * (js[13] - vdot(vload(js), ap_ang)
                            - vdot(vload(js + 3), ap_lin));
      aa = vadd(ap_ang, vscale(ax, qdd));
      al = ap_lin;
      float cap = J[J_QDCAP];
      float qdn = clampf(me.qd[l] + dt * qdd, -cap, cap);
      float qn = me.q[l] + dt * qdn;
      float lo = J[J_LO], hi = J[J_HI];
      if (qn > hi && qdn > 0.f) qdn = 0.f;
      if (qn < lo && qdn < 0.f) qdn = 0.f;
      me.q[l] = clampf(qn, lo, hi);
      me.qd[l] = qdn;
    }
  }

  float* vel = me.vel;
  float* qt = me.qt;
  float ac = C[C_ANG_CAP], lc = C[C_LIN_CAP];
  vel[0] = clampf(vel[0] + dt * a0a.x, -ac, ac);
  vel[1] = clampf(vel[1] + dt * a0a.y, -ac, ac);
  vel[2] = clampf(vel[2] + dt * a0a.z, -ac, ac);
  vel[3] = clampf(vel[3] + dt * a0l.x, -lc, lc);
  vel[4] = clampf(vel[4] + dt * a0l.y, -lc, lc);
  vel[5] = clampf(vel[5] + dt * a0l.z, -lc, lc);
  V3 qv = v3(qt[0], qt[1], qt[2]);
  V3 vb = v3(vel[3], vel[4], vel[5]);
  V3 t = vscale(vcross(qv, vb), 2.f);
  V3 rot = vadd(vadd(vb, vscale(t, qt[3])), vcross(qv, t));
  me.pos[0] = me.pos[0] + dt * rot.x;
  me.pos[1] = me.pos[1] + dt * rot.y;
  me.pos[2] = me.pos[2] + dt * rot.z;
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

template <bool WARM>
HD void lane_store(const Args& A, const Lane& me, int lane, bool valid) {
  if (!valid) return;
  const int n = A.n, e = me.e;
  if (lane == 0) {
    for (int i = 0; i < 3; ++i) A.pos_o[i * n + e] = me.pos[i];
    for (int i = 0; i < 4; ++i) A.quat_o[i * n + e] = me.qt[i];
    for (int i = 0; i < 6; ++i) A.vel_o[i * n + e] = me.vel[i];
  }
  if (lane < K_CH) {
    UNROLL
    for (int l = 0; l < L_LVL; ++l) {
      const int idx = (l * K_CH + lane) * n + e;
      A.q_o[idx] = me.q[l];
      A.qd_o[idx] = me.qd[l];
      A.tau_o[idx] = me.tau[l];
    }
  }
  if (WARM) {
    const size_t nn = (size_t)n;
    UNROLL
    for (int i = 0; i < PPL; ++i) {
      const int pidx = lane + i * G_LANES;
      if (pidx >= NPTS) continue;
      A.anc_o[(size_t)pidx * nn + e] = me.anc[i][0];
      A.anc_o[(size_t)(NPTS + pidx) * nn + e] = me.anc[i][1];
      A.anc_o[(size_t)(2 * NPTS + pidx) * nn + e] = me.anc[i][2];
    }
  }
}

// ------------------------------------------------------------- per env
// PHASE(call) runs `call` on every lane of the env's group, then the group
// waits for all of its lanes. On the card a lane is a thread (`lanes`
// holds its one Lane) and the wait a warp barrier; in the host build a
// loop over the G lanes stands in for them, in lane order.
#if defined(__CUDACC__)
#define GROUP_FN __device__ __forceinline__
#define GROUP_LOOP 1
#define GROUP_SYNC() __syncwarp()
#else
#define GROUP_FN static inline
#define GROUP_LOOP G_LANES
#define GROUP_SYNC()
#endif
#define PHASE(call)                                       \
  do {                                                    \
    for (int i_ = 0; i_ < GROUP_LOOP; ++i_) {             \
      Lane& me = lanes[i_];                               \
      const int lane = lane0 + i_;                        \
      call;                                               \
    }                                                     \
    GROUP_SYNC();                                         \
  } while (0)

// env `e` (clamped to n - 1 past the end, where `valid` is false and
// nothing is written) on lanes lane0 .. lane0 + GROUP_LOOP - 1
template <bool WARM>
GROUP_FN void run_env(const Args& A, int e, bool valid, EnvShared& sh, Lane* lanes,
                int lane0) {
  PHASE(lane_init<WARM>(A, me, e, lane));
  const int n_sub = A.decimation * A.substeps;
  for (int it = 0; it < n_sub; ++it) {
    // the plane: from the first substep's kinematics (the entry state), or
    // with plane_per_dt from the first substep of every sim dt
    const bool resample = A.plane_per_dt ? (it % A.substeps == 0) : (it == 0);
    const bool last = it == n_sub - 1;
    PHASE(phase_fk(A, me, sh, lane));
    PHASE(phase_points<WARM>(A, me, sh, lane, resample));
    PHASE(phase_links(A, me, sh, lane, last, valid));
    PHASE(phase_pass2(A, me, sh, lane));
    PHASE(phase_solve(A, me, sh, lane));
  }
  PHASE(lane_store<WARM>(A, me, lane, valid));
}

// ------------------------------------------------------------ entry points
#if defined(__CUDACC__)
template <bool WARM>
__global__ void __launch_bounds__(128)
chain_step_kernel(Args a) {
  extern __shared__ float smem[];
  EnvShared* sh = reinterpret_cast<EnvShared*>(smem);
  const int per_block = blockDim.x / G_LANES;
  const int slot = threadIdx.x / G_LANES;
  // a warp whose envs all lie past the end leaves as a whole
  const int warp_first = blockIdx.x * per_block
                         + (threadIdx.x / 32) * (32 / G_LANES);
  if (warp_first >= a.n) return;
  const int e = blockIdx.x * per_block + slot;
  Lane me;
  run_env<WARM>(a, e < a.n ? e : a.n - 1, e < a.n, sh[slot], &me,
                threadIdx.x % G_LANES);
}
#define EXPORT extern "C" __attribute__((visibility("default")))
#else
#define EXPORT extern "C"
#endif

#if defined(__CUDACC__)
// Warps a block, blocks and shared bytes of a launch for n envs: up to 4
// warps a block, fewer where their records would pass 48 KB of shared
// memory (a block may take more only after an opt-in, made here).
static int launch_shape(int n, int warm, int* warps, int* blocks,
                        size_t* smem) {
  const int per_warp = 32 / G_LANES;
  const size_t env_bytes = sizeof(EnvShared);
  int w = 4;
  while (w > 1 && (size_t)(w * per_warp) * env_bytes > 48 * 1024) --w;
  const int per_block = w * per_warp;
  *warps = w;
  *smem = (size_t)per_block * env_bytes;
  *blocks = (n + per_block - 1) / per_block;
  if (*smem > 48 * 1024) {
    cudaError_t err = warm
        ? cudaFuncSetAttribute(chain_step_kernel<true>,
              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem)
        : cudaFuncSetAttribute(chain_step_kernel<false>,
              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
#endif

// out[0]: warps a launch for n envs starts (FLAG_WARM of flags picks the
// instantiation); out[1]: warps of that launch the current device holds at
// once (resident blocks per SM x warps a block x SMs), 0 in the host build.
// chain_kernel.py picks G_LANES by these: the launch should fit one wave.
// Returns 0 or a CUDA error.
EXPORT int chain_step_fit(int n, int flags, int* out) {
  const int per_warp = 32 / G_LANES;
  out[0] = (n + per_warp - 1) / per_warp;
  out[1] = 0;
#if defined(__CUDACC__)
  const int warm = flags & FLAG_WARM;
  int warps, blocks, per_sm, dev, sms;
  size_t smem;
  int err = launch_shape(n, warm, &warps, &blocks, &smem);
  if (err != 0) return err;
  cudaError_t e = warm
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, chain_step_kernel<true>, warps * 32, smem)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, chain_step_kernel<false>, warps * 32, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  out[1] = per_sm * warps * sms;
#else
  (void)flags;
#endif
  return 0;
}

// layout of the model this file is built for:
// [L, K, NG, S_0..S_{NG-1}, NB, N_CONST, N_SCALAR, JSTRIDE, PSTRIDE, NPTS,
//  G_LANES, bytes of shared memory per env]
EXPORT int chain_step_layout(int* out, int cap) {
  const int rest[] = {NB, N_CONST, N_SCALAR, JSTRIDE, PSTRIDE, NPTS,
                      G_LANES, (int)sizeof(EnvShared)};
  const int n_rest = (int)(sizeof(rest) / sizeof(rest[0]));
  int v[3 + NG + 8] = {L_LVL, K_CH, NG};
  for (int g = 0; g < NG; ++g) v[3 + g] = group_size(g);
  for (int i = 0; i < n_rest; ++i) v[3 + NG + i] = rest[i];
  const int m = 3 + NG + n_rest;
  for (int i = 0; i < m && i < cap; ++i) out[i] = v[i];
  return m;
}

// One policy step for n envs. flags: FLAG_WARM (anc / anc_o are the
// (3, NPTS, n) anchors in and out, two buffers; without it they are not
// touched), FLAG_TORQUE, FLAG_PLANE_PER_DT. On the card: launches on `stream`
// and returns cudaGetLastError() (0 when the launch was accepted). In the
// host build: runs the envs in a loop and returns 0.
EXPORT int chain_step_run(
    const float* lp_base, const float* lp_lvl, const float* mu,
    const float* targets, const float* ph, const int* r0, const int* c0,
    const float* pos, const float* quat, const float* vel, const float* q,
    const float* qd, const float* cst, float* pos_o, float* quat_o,
    float* vel_o, float* q_o, float* qd_o, float* tau_o, float* body_f_o,
    const float* anc, float* anc_o, int n, int S, int decimation,
    int substeps, int flags, void* stream) {
  const int warm = flags & FLAG_WARM;
  Args a;
  a.lp_base = lp_base; a.lp_lvl = lp_lvl; a.mu = mu; a.targets = targets;
  a.ph = ph; a.r0 = r0; a.c0 = c0; a.pos = pos; a.quat = quat; a.vel = vel;
  a.q = q; a.qd = qd; a.cst = cst; a.pos_o = pos_o; a.quat_o = quat_o;
  a.vel_o = vel_o; a.q_o = q_o; a.qd_o = qd_o; a.tau_o = tau_o;
  a.body_f_o = body_f_o; a.n = n; a.S = S; a.decimation = decimation;
  a.substeps = substeps;
  a.torque = (flags & FLAG_TORQUE) ? 1 : 0;
  a.plane_per_dt = (flags & FLAG_PLANE_PER_DT) ? 1 : 0;
  a.anc = warm ? anc : nullptr;
  a.anc_o = warm ? anc_o : nullptr;
  if (n <= 0) return 0;
#if defined(__CUDACC__)
  int warps, blocks;
  size_t smem;
  const int err = launch_shape(n, warm, &warps, &blocks, &smem);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (warm)
    chain_step_kernel<true><<<blocks, warps * 32, smem, s>>>(a);
  else
    chain_step_kernel<false><<<blocks, warps * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
#else
  (void)stream;
  EnvShared sh;
  Lane lanes[G_LANES];
  for (int e = 0; e < n; ++e) {
    if (warm) run_env<true>(a, e, true, sh, lanes, 0);
    else run_env<false>(a, e, true, sh, lanes, 0);
  }
  return 0;
#endif
}
