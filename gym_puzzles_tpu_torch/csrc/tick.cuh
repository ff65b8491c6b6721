// Static world table and the contact-solve phases of one engine tick, as
// per-thread device functions (one thread = one env).
//
// The phases here -- warm start, velocity sweep, clamped position
// integration, position sweep -- are the CUDA counterparts of the solver
// phase generators in gym_puzzles_tpu/engine/solver_pallas.py
// (_warm_start, _vel_sweep, _integrate, _pos_sweep), which the two TPU
// kernels share.  The fused tick kernel (step_fused.cu) and the staged
// contact-solve kernel (solve_contacts.cu) both call them.
//
// The sweeps walk a per-env list of live rows, not the pair table: each
// kernel compacts the constraint rows of the pairs a sweep can change, in
// table order, into VelRow / PosRow arrays (row k is the k-th live pair),
// with the per-pair and per-body constants the sweeps read copied into the
// row.  So a sweep reads row k at the same local-memory offset in every
// lane, never indexes __constant__ memory with a lane-dependent index, and
// costs what the env's contacts cost.  Skipping a pair that is not live
// changes no value but the sign of a zero: it would apply exact zero
// impulses (velocity: ``cnt == 0``; position: not ``solve``, or no manifold
// point, so it neither lowers ``min_sep`` nor moves a body).
//
// Arithmetic follows the plain PyTorch version
// (gym_puzzles_tpu_torch/engine/solver.py) operation for operation: same
// sweep order over the pairs, friction before normal, the block solve's cases
// in the order ok1 -> ok2 -> ok3 -> ok4, the two normal impulses applied as
// one sum.  Each visit loads its two bodies into registers once and stores
// them once.  A static body enters a velocity visit as exact zeros and is
// never stored, which equals the plain version's dropping of its terms up to
// the sign of a zero.
#pragma once

#include <math.h>
#include <stdint.h>

#ifndef __CUDACC__
// Without nvcc the kernel bodies compile as host C++ (g++ -x c++), which is
// how the CPU tests hold their arithmetic against the plain versions.  The
// port itself never runs this build.
#include <algorithm>
#define __device__
#define __forceinline__ inline
#define __align__(n) alignas(n)
using std::min;
static inline float __fmul_rn(float a, float b) { return a * b; }
#endif

#define GPT_MAX_B 16  // bodies per world
#define GPT_MAX_F 32  // fixtures per world
#define GPT_MAX_P 64  // contact pairs per world
#define GPT_MAX_V 8   // vertices per fixture (Box2D's b2_maxPolygonVertices)

// Size classes: the per-env arrays are sized by compile-time ceilings of the
// body and pair counts, and each kernel is instantiated once per class.  The
// wrapper picks the smallest class the table fits (engine/_cuda_build.py
// SIZE_CLASSES mirrors this list; gpt_size_classes() lets it check).
#define GPT_SMALL_B 8   // v0, v3 with 2 agents: 7 bodies, 21 pairs
#define GPT_SMALL_P 24
#define GPT_LARGE_B GPT_MAX_B  // Heavy-v0, v2, v3 with 3-5 agents: 7-10 bodies, 29-53 pairs
#define GPT_LARGE_P GPT_MAX_P

// Envs per warp: each block is one warp of this many env lanes, so 4096 envs
// are 512 warps, which all fit the card's 528 schedulers at once.  Measured
// (gym_puzzles_tpu_torch/bench_kernels.py envs_per_warp; PERF.md): 8 is the
// fastest of 32, 16, 8 and 4 on v0 and v2 for both kernels but one cell,
// where 16 and 32 lead by under 1%; 4 makes warps share schedulers.  The
// definition on the nvcc command line is for that measurement only.
#ifndef GPT_ENVS_PER_WARP
#define GPT_ENVS_PER_WARP 8
#endif

// Everything static about one world variant, copied into __constant__
// memory by the host wrapper (engine/_cuda_build.py builds the same layout
// with ctypes; gpt_world_bytes() lets it check the size).  Every field is
// 4 bytes wide, so the C and ctypes layouts have no padding to disagree on.
// The scalar constants are float32-rounded on the host, exactly as PyTorch
// rounds the Python floats of the plain version.  The kernels index it only
// with indices that are the same in every lane of a warp.
struct World {
  int B, F, P, n_dyn, n_dd;
  int dyn[GPT_MAX_B];         // 1 for dynamic bodies
  int dyn_bodies[GPT_MAX_B];  // indices of the dynamic bodies
  float inv_m[GPT_MAX_B], inv_i[GPT_MAX_B];
  float lcx[GPT_MAX_B], lcy[GPT_MAX_B];  // local center of mass
  float lin_damp[GPT_MAX_B], ang_damp[GPT_MAX_B];
  int fix_count[GPT_MAX_F];
  float fix_verts[GPT_MAX_F][GPT_MAX_V][2];
  float fix_normals[GPT_MAX_F][GPT_MAX_V][2];
  int ia[GPT_MAX_P], ib[GPT_MAX_P];  // pair bodies
  int fa[GPT_MAX_P], fb[GPT_MAX_P];  // pair fixtures
  int rep[GPT_MAX_P];                // first dynamic endpoint: the pair's island
  int dd_pairs[GPT_MAX_P];           // pairs whose two bodies are dynamic
  float fric[GPT_MAX_P], rest[GPT_MAX_P], m_sum[GPT_MAX_P];
  // solver and sleep constants (b2Settings)
  float total_radius, clip_tol, polygon_radius, linear_slop, baumgarte;
  float max_linear_correction, max_translation, max_translation_sq;
  float max_rotation, max_rotation_sq, velocity_threshold, max_condition;
  float lin_sleep_tol_sq, ang_sleep_tol_sq, time_to_sleep, pos_done_sep;
  float rot_c2, rot_c4, rot_s3, rot_s5;  // 1/2, 1/24, 1/6, 1/120
};

// Per-env body state, in the thread's local memory (indexed by body).
template <int MB>
struct BodyState {
  float px[MB], py[MB], an[MB];
  float vx[MB], vy[MB], om[MB];
};

// The two bodies of a pair and their constants.  The rows are 16-byte
// aligned so a visit loads them with vector loads.
struct __align__(16) PairBodies {
  int p, a, b;
  int da, db;  // 1 where the body is dynamic
  float ima, iia, imb, iib;  // inverse mass and inertia (0 for a static body)
};

__device__ __forceinline__ void pair_bodies(const World& W, int p, PairBodies& r) {
  const int a = W.ia[p], b = W.ib[p];
  r.p = p;
  r.a = a;
  r.b = b;
  r.da = W.dyn[a];
  r.db = W.dyn[b];
  r.ima = W.inv_m[a];
  r.iia = W.inv_i[a];
  r.imb = W.inv_m[b];
  r.iib = W.inv_i[b];
}

// One live pair's velocity constraint row (b2ContactVelocityConstraint) and
// accumulated impulses; ``cnt`` is the effective point count, > 0.
struct __align__(16) VelRow : PairBodies {
  int cnt;
  float fric, nx, ny;
  float rax[2], ray[2], rbx[2], rby[2];
  float nm[2], tm[2], bias[2];
  float k11, k12, k22, im11, im12, im22;
  float ni[2], ti[2];
};

// One live pair's position constraint row: the manifold in local frames,
// the manifold's point count, the island (a label) and the constants.
struct __align__(16) PosRow : PairBodies {
  int flip, mcnt, isl;
  float m_sum, lcxa, lcya, lcxb, lcyb;
  float lnx, lny, lpx, lpy, mpx[2], mpy[2];
};

__device__ __forceinline__ void pos_consts(const World& W, PosRow& r) {
  r.m_sum = W.m_sum[r.p];
  r.lcxa = W.lcx[r.a];
  r.lcya = W.lcy[r.a];
  r.lcxb = W.lcx[r.b];
  r.lcyb = W.lcy[r.b];
}

// A pair's two bodies' velocities, in registers for one visit.  A static
// body's are exact zeros and are never stored.
struct Vel2 {
  float vxa, vya, oma, vxb, vyb, omb;
};

template <int MB>
__device__ __forceinline__ Vel2 load_vel(const BodyState<MB>& s, const PairBodies& r) {
  Vel2 v;
  v.vxa = r.da ? s.vx[r.a] : 0.0f;
  v.vya = r.da ? s.vy[r.a] : 0.0f;
  v.oma = r.da ? s.om[r.a] : 0.0f;
  v.vxb = r.db ? s.vx[r.b] : 0.0f;
  v.vyb = r.db ? s.vy[r.b] : 0.0f;
  v.omb = r.db ? s.om[r.b] : 0.0f;
  return v;
}

template <int MB>
__device__ __forceinline__ void store_vel(BodyState<MB>& s, const PairBodies& r, const Vel2& v) {
  if (r.da) {
    s.vx[r.a] = v.vxa;
    s.vy[r.a] = v.vya;
    s.om[r.a] = v.oma;
  }
  if (r.db) {
    s.vx[r.b] = v.vxb;
    s.vy[r.b] = v.vyb;
    s.om[r.b] = v.omb;
  }
}

// Impulse (px, py) at lever arms r_a / r_b: -P on body a, +P on body b.
__device__ __forceinline__ void apply_impulse(const PairBodies& r, Vel2& v, float rax, float ray,
                                              float rbx, float rby, float px, float py) {
  if (r.da) {
    v.vxa = v.vxa - r.ima * px;
    v.vya = v.vya - r.ima * py;
    v.oma = v.oma - r.iia * (rax * py - ray * px);
  }
  if (r.db) {
    v.vxb = v.vxb + r.imb * px;
    v.vyb = v.vyb + r.imb * py;
    v.omb = v.omb + r.iib * (rbx * py - rby * px);
  }
}

// v_b + w_b x r_b - v_a - w_a x r_a (a static body's terms are zeros).
__device__ __forceinline__ void rel_vel(const Vel2& v, float rax, float ray, float rbx, float rby,
                                        float& dvx, float& dvy) {
  dvx = v.vxb - v.omb * rby - v.vxa + v.oma * ray;
  dvy = v.vyb + v.omb * rbx - v.vya - v.oma * rax;
}

// b2ContactSolver::WarmStart over the live rows.
template <int MB>
__device__ __forceinline__ void warm_start(BodyState<MB>& s, const VelRow* rows, int n) {
  for (int k = 0; k < n; ++k) {
    const VelRow& r = rows[k];
    const float nx = r.nx, ny = r.ny, tx = ny, ty = -nx;
    Vel2 v = load_vel(s, r);
    for (int j = 0; j < 2; ++j) {
      const bool mask = j < r.cnt;
      const float imp = mask ? r.ni[j] : 0.0f;
      const float timp = mask ? r.ti[j] : 0.0f;
      apply_impulse(r, v, r.rax[j], r.ray[j], r.rbx[j], r.rby[j], imp * nx + timp * tx,
                    imp * ny + timp * ty);
    }
    store_vel(s, r, v);
  }
}

// One pair's b2ContactSolver::SolveVelocityConstraints visit on registers:
// friction per point, then the normal impulse with the 2x2 block solve.
__device__ __forceinline__ void vel_visit(VelRow& r, Vel2& v) {
  const float nx = r.nx, ny = r.ny, tx = ny, ty = -nx;
  const int cnt = r.cnt;
  float dvx, dvy;

  for (int j = 0; j < 2; ++j) {
    rel_vel(v, r.rax[j], r.ray[j], r.rbx[j], r.rby[j], dvx, dvy);
    const float vt = dvx * tx + dvy * ty;
    float lam = r.tm[j] * (-vt);
    const float max_f = r.fric * r.ni[j];
    const float new_imp = fminf(fmaxf(r.ti[j] + lam, -max_f), max_f);
    lam = (j < cnt) ? new_imp - r.ti[j] : 0.0f;
    r.ti[j] = r.ti[j] + lam;
    apply_impulse(r, v, r.rax[j], r.ray[j], r.rbx[j], r.rby[j], lam * tx, lam * ty);
  }

  // normal: single point
  rel_vel(v, r.rax[0], r.ray[0], r.rbx[0], r.rby[0], dvx, dvy);
  const float vn0 = dvx * nx + dvy * ny;
  const float n0 = r.ni[0], n1 = r.ni[1];
  const float lam0 = -r.nm[0] * (vn0 - r.bias[0]);
  const float d_single = fmaxf(n0 + lam0, 0.0f) - n0;

  // normal: 2x2 block solve, Box2D's cases in order
  rel_vel(v, r.rax[1], r.ray[1], r.rbx[1], r.rby[1], dvx, dvy);
  const float vn2 = dvx * nx + dvy * ny;
  const float k11 = r.k11, k12 = r.k12, k22 = r.k22;
  const float b1 = vn0 - r.bias[0] - (k11 * n0 + k12 * n1);
  const float b2 = vn2 - r.bias[1] - (k12 * n0 + k22 * n1);
  const float x1_1 = -(r.im11 * b1 + r.im12 * b2);
  const float x2_1 = -(r.im12 * b1 + r.im22 * b2);
  const bool ok1 = (x1_1 >= 0.0f) && (x2_1 >= 0.0f);
  const float x1_2 = -r.nm[0] * b1;
  const bool ok2 = (x1_2 >= 0.0f) && (k12 * x1_2 + b2 >= 0.0f);
  const float x2_3 = -r.nm[1] * b2;
  const bool ok3 = (x2_3 >= 0.0f) && (k12 * x2_3 + b1 >= 0.0f);
  const bool ok4 = (b1 >= 0.0f) && (b2 >= 0.0f);
  const float x1 = ok1 ? x1_1 : (ok2 ? x1_2 : 0.0f);
  const float x2 = ok1 ? x2_1 : (ok3 ? x2_3 : 0.0f);
  const bool applied = ok1 || ok2 || ok3 || ok4;
  const float d1_blk = applied ? x1 - n0 : 0.0f;
  const float d2_blk = applied ? x2 - n1 : 0.0f;
  const float d1 = (cnt == 2) ? d1_blk : ((cnt == 1) ? d_single : 0.0f);
  const float d2 = (cnt == 2) ? d2_blk : 0.0f;
  r.ni[0] = n0 + d1;
  r.ni[1] = n1 + d2;

  const float p1x = d1 * nx, p1y = d1 * ny, p2x = d2 * nx, p2y = d2 * ny;
  const float sx = p1x + p2x, sy = p1y + p2y;
  if (r.da) {
    v.vxa = v.vxa - r.ima * sx;
    v.vya = v.vya - r.ima * sy;
    v.oma = v.oma - r.iia * ((r.rax[0] * p1y - r.ray[0] * p1x) +
                             (r.rax[1] * p2y - r.ray[1] * p2x));
  }
  if (r.db) {
    v.vxb = v.vxb + r.imb * sx;
    v.vyb = v.vyb + r.imb * sy;
    v.omb = v.omb + r.iib * ((r.rbx[0] * p1y - r.rby[0] * p1x) +
                             (r.rbx[1] * p2y - r.rby[1] * p2x));
  }
}

// One velocity sweep over the live rows, in table order.  Row k + 1 is
// loaded into registers while row k is visited, so its loads do not wait
// for the visit's chain of dependent operations.
template <int MB>
__device__ __forceinline__ void vel_sweep(BodyState<MB>& s, VelRow* rows, int n) {
  if (n == 0) return;
  VelRow r = rows[0];
  for (int k = 0; k < n; ++k) {
    const VelRow next = rows[k + 1 < n ? k + 1 : k];
    Vel2 v = load_vel(s, r);
    vel_visit(r, v);
    store_vel(s, r, v);
    for (int j = 0; j < 2; ++j) {
      rows[k].ni[j] = r.ni[j];
      rows[k].ti[j] = r.ti[j];
    }
    r = next;
  }
}

// b2Island position integration for the dynamic bodies, with the
// translation / rotation clamps written back into the velocities.
template <int MB>
__device__ __forceinline__ void integrate(const World& W, BodyState<MB>& s, const bool* active,
                                          float dt) {
  for (int k = 0; k < W.n_dyn; ++k) {
    const int b = W.dyn_bodies[k];
    const float tx = dt * s.vx[b], ty = dt * s.vy[b];
    const float t2 = tx * tx + ty * ty;
    const float scale =
        t2 > W.max_translation_sq ? W.max_translation / sqrtf(fmaxf(t2, 1e-30f)) : 1.0f;
    s.vx[b] = s.vx[b] * scale;
    s.vy[b] = s.vy[b] * scale;
    const float rot = dt * s.om[b];
    const float rscale = rot * rot > W.max_rotation_sq ? W.max_rotation / fabsf(rot) : 1.0f;
    s.om[b] = s.om[b] * rscale;
    if (active[b]) {
      s.px[b] = s.px[b] + dt * s.vx[b];
      s.py[b] = s.py[b] + dt * s.vy[b];
      s.an[b] = s.an[b] + dt * s.om[b];
    }
  }
}

// Advance a cached rotation (c, s) by the small angle dA: 5th-order
// small-angle rotation, truncation ~dA^6/720 (solver_pallas.rot_step).
__device__ __forceinline__ void rot_step(const World& W, float& c, float& s, float dA) {
  const float dA2 = dA * dA;
  const float c2 = 1.0f - dA2 * (W.rot_c2 - dA2 * W.rot_c4);
  const float s2 = dA * (1.0f - dA2 * (W.rot_s3 - dA2 * W.rot_s5));
  const float c0 = c, s0 = s;
  c = c0 * c2 - s0 * s2;
  s = s0 * c2 + c0 * s2;
}

// One pair's b2ContactSolver::SolvePositionConstraints visit, on its two
// bodies' positions, angles and cached rotations held in registers.
// ``cc``/``cs`` hold every static body's rotation (constant through the
// pass) and, with ``incremental``, the dynamic bodies' cached rotations,
// advanced by rot_step at every angle update; otherwise a dynamic body's
// cos/sin is recomputed at every visit.
template <int MB>
__device__ __forceinline__ void pos_visit(const World& W, BodyState<MB>& s, const PosRow& r,
                                          const bool* done, float* min_sep, float* cc,
                                          float* cs, bool incremental) {
  const int a = r.a, b = r.b;
  const bool pair_done = done[r.isl];
  float pxa = s.px[a], pya = s.py[a], ana = s.an[a];
  float pxb = s.px[b], pyb = s.py[b], anb = s.an[b];
  float cca = cc[a], csa = cs[a], ccb = cc[b], csb = cs[b];

  // transforms once per contact (b2 semantics): point 1 reuses the
  // pre-point-0 transform; only the COM lever arms see the update
  float ca = cca, sa = csa, cb = ccb, sb = csb;
  if (r.da && !incremental) { ca = cosf(ana); sa = sinf(ana); }
  if (r.db && !incremental) { cb = cosf(anb); sb = sinf(anb); }
  const float oax = pxa - (ca * r.lcxa - sa * r.lcya);
  const float oay = pya - (sa * r.lcxa + ca * r.lcya);
  const float obx = pxb - (cb * r.lcxb - sb * r.lcyb);
  const float oby = pyb - (sb * r.lcxb + cb * r.lcyb);
  const bool f = r.flip;
  const float cr = f ? cb : ca, sr = f ? sb : sa;
  const float orx = f ? obx : oax, ory = f ? oby : oay;
  const float ci = f ? ca : cb, si = f ? sa : sb;
  const float oix = f ? oax : obx, oiy = f ? oay : oby;
  const float nwx = cr * r.lnx - sr * r.lny;
  const float nwy = sr * r.lnx + cr * r.lny;
  const float ppx = (cr * r.lpx - sr * r.lpy) + orx;
  const float ppy = (sr * r.lpx + cr * r.lpy) + ory;
  const float nx = f ? -nwx : nwx, ny = f ? -nwy : nwy;

  for (int j = 0; j < 2; ++j) {
    const bool has = j < r.mcnt;
    const bool active = has && !pair_done;
    const float mpx = r.mpx[j], mpy = r.mpy[j];
    const float cpx = (ci * mpx - si * mpy) + oix;
    const float cpy = (si * mpx + ci * mpy) + oiy;
    const float sep = (cpx - ppx) * nwx + (cpy - ppy) * nwy - W.total_radius;
    if (has) min_sep[r.isl] = fminf(min_sep[r.isl], sep);
    const float corr = fminf(fmaxf(W.baumgarte * (sep + W.linear_slop),
                                   -W.max_linear_correction), 0.0f);
    const float rax = cpx - pxa, ray = cpy - pya;
    const float rbx = cpx - pxb, rby = cpy - pyb;
    float k = r.m_sum;
    if (r.da) { const float rn = rax * ny - ray * nx; k = k + r.iia * (rn * rn); }
    if (r.db) { const float rn = rbx * ny - rby * nx; k = k + r.iib * (rn * rn); }
    const float impulse = (k > 0.0f && active) ? -corr / k : 0.0f;
    const float pix = impulse * nx, piy = impulse * ny;
    if (r.da) {
      pxa = pxa - r.ima * pix;
      pya = pya - r.ima * piy;
      const float dA = -(r.iia * (rax * piy - ray * pix));
      ana = ana + dA;
      if (incremental) rot_step(W, cca, csa, dA);
    }
    if (r.db) {
      pxb = pxb + r.imb * pix;
      pyb = pyb + r.imb * piy;
      const float dB = r.iib * (rbx * piy - rby * pix);
      anb = anb + dB;
      if (incremental) rot_step(W, ccb, csb, dB);
    }
  }
  if (r.da) {
    s.px[a] = pxa; s.py[a] = pya; s.an[a] = ana;
    if (incremental) { cc[a] = cca; cs[a] = csa; }
  }
  if (r.db) {
    s.px[b] = pxb; s.py[b] = pyb; s.an[b] = anb;
    if (incremental) { cc[b] = ccb; cs[b] = csb; }
  }
}

// One position sweep over the live rows, with b2Island's early exit kept
// per island: ``done`` and ``min_sep`` are indexed by island label.  A row
// whose island is done still lowers its island's minimum separation and
// applies no impulse.
template <int MB>
__device__ __forceinline__ void pos_sweep(const World& W, BodyState<MB>& s, const PosRow* rows,
                                          int n, const bool* done, float* min_sep, float* cc,
                                          float* cs, bool incremental) {
  if (incremental && n > 0) {
    for (int k = 0; k < W.n_dyn; ++k) {
      const int b = W.dyn_bodies[k];
      cc[b] = cosf(s.an[b]);
      cs[b] = sinf(s.an[b]);
    }
  }
  if (n == 0) return;
  PosRow r = rows[0];
  for (int k = 0; k < n; ++k) {  // row k + 1 loaded during visit k, as in vel_sweep
    const PosRow next = rows[k + 1 < n ? k + 1 : k];
    pos_visit(W, s, r, done, min_sep, cc, cs, incremental);
    r = next;
  }
}

// The position pass: ``pos_iters`` sweeps, each followed by the islands'
// done test.  ``cc``/``cs`` come in holding the static bodies' rotations.
template <int MB>
__device__ __forceinline__ void pos_pass(const World& W, BodyState<MB>& s, const PosRow* rows,
                                         int n, int pos_iters, bool* done, float* cc, float* cs,
                                         bool incremental) {
  float min_sep[MB];
  for (int b = 0; b < W.B; ++b) done[b] = false;
  for (int it = 0; it < pos_iters; ++it) {
    for (int b = 0; b < W.B; ++b) min_sep[b] = 0.0f;
    pos_sweep(W, s, rows, n, done, min_sep, cc, cs, incremental);
    for (int b = 0; b < W.B; ++b) done[b] = done[b] || (min_sep[b] >= W.pos_done_sep);
  }
}

// What each kernel library tells its wrapper about its build.
extern "C" {

int gpt_world_bytes(void) { return (int)sizeof(World); }

int gpt_envs_per_warp(void) { return GPT_ENVS_PER_WARP; }

// The size classes' (bodies, pairs) ceilings, in class order, into out[0..3].
int gpt_size_classes(int* out) {
  out[0] = GPT_SMALL_B;
  out[1] = GPT_SMALL_P;
  out[2] = GPT_LARGE_B;
  out[3] = GPT_LARGE_P;
  return 2;
}

}  // extern "C"
