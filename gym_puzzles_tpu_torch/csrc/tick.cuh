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
// Arithmetic follows the plain PyTorch version
// (gym_puzzles_tpu_torch/engine/solver.py) operation for operation: same
// sweep order over the static pair list, friction before normal, the block
// solve's cases in the order ok1 -> ok2 -> ok3 -> ok4, the two normal
// impulses applied as one sum.  Terms with a static body's velocity or
// position are skipped, which is exact (they are zero / never updated).
#pragma once

#include <math.h>

#ifndef __CUDACC__
// Without nvcc the kernel bodies compile as host C++ (g++ -x c++), which is
// how the CPU tests hold their arithmetic against the plain versions.  The
// port itself never runs this build.
#include <algorithm>
#define __device__
#define __forceinline__ inline
using std::min;
static inline float __fmul_rn(float a, float b) { return a * b; }
#endif

#define GPT_MAX_B 16  // bodies per world
#define GPT_MAX_F 32  // fixtures per world
#define GPT_MAX_P 64  // contact pairs per world
#define GPT_MAX_V 8   // vertices per fixture (Box2D's b2_maxPolygonVertices)

// Everything static about one world variant, copied into __constant__
// memory by the host wrapper (engine/_cuda_build.py builds the same layout
// with ctypes; gpt_world_bytes() lets it check the size).  Every field is
// 4 bytes wide, so the C and ctypes layouts have no padding to disagree on.
// The scalar constants are float32-rounded on the host, exactly as PyTorch
// rounds the Python floats of the plain version.
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

// Per-env body state, kept in the thread's local memory.
struct BodyState {
  float px[GPT_MAX_B], py[GPT_MAX_B], an[GPT_MAX_B];
  float vx[GPT_MAX_B], vy[GPT_MAX_B], om[GPT_MAX_B];
};

// Per-pair constraint rows of one env (b2ContactVelocityConstraint plus the
// manifold the position pass reads), and the accumulated impulses.
struct PairState {
  float nx[GPT_MAX_P], ny[GPT_MAX_P];
  float rax[GPT_MAX_P][2], ray[GPT_MAX_P][2], rbx[GPT_MAX_P][2], rby[GPT_MAX_P][2];
  float nm[GPT_MAX_P][2], tm[GPT_MAX_P][2], bias[GPT_MAX_P][2];
  float k11[GPT_MAX_P], k12[GPT_MAX_P], k22[GPT_MAX_P];
  float im11[GPT_MAX_P], im12[GPT_MAX_P], im22[GPT_MAX_P];
  int cnt[GPT_MAX_P];  // effective point count, 0 where the pair is not solved
  bool solve[GPT_MAX_P];
  bool flip[GPT_MAX_P];
  float lnx[GPT_MAX_P], lny[GPT_MAX_P], lpx[GPT_MAX_P], lpy[GPT_MAX_P];
  float mpx[GPT_MAX_P][2], mpy[GPT_MAX_P][2];
  int mcnt[GPT_MAX_P];  // manifold point count (not the degraded one)
  float ni[GPT_MAX_P][2], ti[GPT_MAX_P][2];
};

// Impulse (px, py) at lever arms r_a / r_b: -P on body a, +P on body b.
__device__ __forceinline__ void apply_impulse(const World& W, BodyState& s, int a, int b,
                                              float rax, float ray, float rbx, float rby,
                                              float px, float py) {
  if (W.dyn[a]) {
    s.vx[a] = s.vx[a] - W.inv_m[a] * px;
    s.vy[a] = s.vy[a] - W.inv_m[a] * py;
    s.om[a] = s.om[a] - W.inv_i[a] * (rax * py - ray * px);
  }
  if (W.dyn[b]) {
    s.vx[b] = s.vx[b] + W.inv_m[b] * px;
    s.vy[b] = s.vy[b] + W.inv_m[b] * py;
    s.om[b] = s.om[b] + W.inv_i[b] * (rbx * py - rby * px);
  }
}

// v_b + w_b x r_b - v_a - w_a x r_a, without the static (zero) terms.
__device__ __forceinline__ void rel_vel(const World& W, const BodyState& s, int a, int b,
                                        float rax, float ray, float rbx, float rby,
                                        float& dvx, float& dvy) {
  if (W.dyn[a] && W.dyn[b]) {
    dvx = s.vx[b] - s.om[b] * rby - s.vx[a] + s.om[a] * ray;
    dvy = s.vy[b] + s.om[b] * rbx - s.vy[a] - s.om[a] * rax;
  } else if (W.dyn[b]) {
    dvx = s.vx[b] - s.om[b] * rby;
    dvy = s.vy[b] + s.om[b] * rbx;
  } else {
    dvx = s.om[a] * ray - s.vx[a];
    dvy = -s.vy[a] - s.om[a] * rax;
  }
}

// b2ContactSolver::WarmStart.
__device__ __forceinline__ void warm_start(const World& W, BodyState& s, const PairState& c) {
  for (int p = 0; p < W.P; ++p) {
    const int a = W.ia[p], b = W.ib[p];
    const float nx = c.nx[p], ny = c.ny[p], tx = ny, ty = -nx;
    for (int j = 0; j < 2; ++j) {
      const bool mask = j < c.cnt[p];
      const float imp = mask ? c.ni[p][j] : 0.0f;
      const float timp = mask ? c.ti[p][j] : 0.0f;
      apply_impulse(W, s, a, b, c.rax[p][j], c.ray[p][j], c.rbx[p][j], c.rby[p][j],
                    imp * nx + timp * tx, imp * ny + timp * ty);
    }
  }
}

// One b2ContactSolver::SolveVelocityConstraints sweep over the static pair
// list: per pair, friction per point, then the normal impulse with the
// 2x2 block solve.
__device__ __forceinline__ void vel_sweep(const World& W, BodyState& s, PairState& c) {
  for (int p = 0; p < W.P; ++p) {
    const int a = W.ia[p], b = W.ib[p];
    const float nx = c.nx[p], ny = c.ny[p], tx = ny, ty = -nx;
    const int cnt = c.cnt[p];
    float dvx, dvy;

    for (int j = 0; j < 2; ++j) {
      rel_vel(W, s, a, b, c.rax[p][j], c.ray[p][j], c.rbx[p][j], c.rby[p][j], dvx, dvy);
      const float vt = dvx * tx + dvy * ty;
      float lam = c.tm[p][j] * (-vt);
      const float max_f = W.fric[p] * c.ni[p][j];
      const float new_imp = fminf(fmaxf(c.ti[p][j] + lam, -max_f), max_f);
      lam = (j < cnt) ? new_imp - c.ti[p][j] : 0.0f;
      c.ti[p][j] = c.ti[p][j] + lam;
      apply_impulse(W, s, a, b, c.rax[p][j], c.ray[p][j], c.rbx[p][j], c.rby[p][j],
                    lam * tx, lam * ty);
    }

    // normal: single point
    rel_vel(W, s, a, b, c.rax[p][0], c.ray[p][0], c.rbx[p][0], c.rby[p][0], dvx, dvy);
    const float vn0 = dvx * nx + dvy * ny;
    const float n0 = c.ni[p][0], n1 = c.ni[p][1];
    const float lam0 = -c.nm[p][0] * (vn0 - c.bias[p][0]);
    const float d_single = fmaxf(n0 + lam0, 0.0f) - n0;

    // normal: 2x2 block solve, Box2D's cases in order
    rel_vel(W, s, a, b, c.rax[p][1], c.ray[p][1], c.rbx[p][1], c.rby[p][1], dvx, dvy);
    const float vn2 = dvx * nx + dvy * ny;
    const float k11 = c.k11[p], k12 = c.k12[p], k22 = c.k22[p];
    const float b1 = vn0 - c.bias[p][0] - (k11 * n0 + k12 * n1);
    const float b2 = vn2 - c.bias[p][1] - (k12 * n0 + k22 * n1);
    const float x1_1 = -(c.im11[p] * b1 + c.im12[p] * b2);
    const float x2_1 = -(c.im12[p] * b1 + c.im22[p] * b2);
    const bool ok1 = (x1_1 >= 0.0f) && (x2_1 >= 0.0f);
    const float x1_2 = -c.nm[p][0] * b1;
    const bool ok2 = (x1_2 >= 0.0f) && (k12 * x1_2 + b2 >= 0.0f);
    const float x2_3 = -c.nm[p][1] * b2;
    const bool ok3 = (x2_3 >= 0.0f) && (k12 * x2_3 + b1 >= 0.0f);
    const bool ok4 = (b1 >= 0.0f) && (b2 >= 0.0f);
    const float x1 = ok1 ? x1_1 : (ok2 ? x1_2 : 0.0f);
    const float x2 = ok1 ? x2_1 : (ok3 ? x2_3 : 0.0f);
    const bool applied = ok1 || ok2 || ok3 || ok4;
    const float d1_blk = applied ? x1 - n0 : 0.0f;
    const float d2_blk = applied ? x2 - n1 : 0.0f;
    const float d1 = (cnt == 2) ? d1_blk : ((cnt == 1) ? d_single : 0.0f);
    const float d2 = (cnt == 2) ? d2_blk : 0.0f;
    c.ni[p][0] = n0 + d1;
    c.ni[p][1] = n1 + d2;

    const float p1x = d1 * nx, p1y = d1 * ny, p2x = d2 * nx, p2y = d2 * ny;
    const float sx = p1x + p2x, sy = p1y + p2y;
    if (W.dyn[a]) {
      s.vx[a] = s.vx[a] - W.inv_m[a] * sx;
      s.vy[a] = s.vy[a] - W.inv_m[a] * sy;
      s.om[a] = s.om[a] - W.inv_i[a] * ((c.rax[p][0] * p1y - c.ray[p][0] * p1x) +
                                        (c.rax[p][1] * p2y - c.ray[p][1] * p2x));
    }
    if (W.dyn[b]) {
      s.vx[b] = s.vx[b] + W.inv_m[b] * sx;
      s.vy[b] = s.vy[b] + W.inv_m[b] * sy;
      s.om[b] = s.om[b] + W.inv_i[b] * ((c.rbx[p][0] * p1y - c.rby[p][0] * p1x) +
                                        (c.rbx[p][1] * p2y - c.rby[p][1] * p2x));
    }
  }
}

// b2Island position integration for the dynamic bodies, with the
// translation / rotation clamps written back into the velocities.
__device__ __forceinline__ void integrate(const World& W, BodyState& s, const bool* active,
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

// One b2ContactSolver::SolvePositionConstraints sweep, with b2Island's
// early exit kept per island: ``done`` and ``min_sep`` are indexed by island
// label, and a pair belongs to the island of its first dynamic endpoint
// (W.rep).  ``stc``/``sts``/``sox``/``soy`` hold the static bodies'
// rotations and origins, constant through the pass.  With ``incremental``
// the dynamic bodies' cos/sin are computed once per sweep and advanced by
// rot_step at every angle update; otherwise recomputed at every pair visit.
__device__ __forceinline__ void pos_sweep(const World& W, BodyState& s, const PairState& c,
                                          const int* label, const bool* done, float* min_sep,
                                          const float* stc, const float* sts,
                                          const float* sox, const float* soy,
                                          float* cc, float* cs, bool incremental) {
  if (incremental) {
    for (int k = 0; k < W.n_dyn; ++k) {
      const int b = W.dyn_bodies[k];
      cc[b] = cosf(s.an[b]);
      cs[b] = sinf(s.an[b]);
    }
  }
  for (int p = 0; p < W.P; ++p) {
    const int a = W.ia[p], b = W.ib[p];
    const bool solve = c.solve[p];
    const int isl = label[W.rep[p]];
    const bool pair_done = done[isl] || !solve;

    // transforms once per contact (b2 semantics): point 1 reuses the
    // pre-point-0 transform; only the COM lever arms see the update
    float ca, sa, oax, oay, cb, sb, obx, oby;
    if (W.dyn[a]) {
      if (incremental) { ca = cc[a]; sa = cs[a]; } else { ca = cosf(s.an[a]); sa = sinf(s.an[a]); }
      oax = s.px[a] - (ca * W.lcx[a] - sa * W.lcy[a]);
      oay = s.py[a] - (sa * W.lcx[a] + ca * W.lcy[a]);
    } else {
      ca = stc[a]; sa = sts[a]; oax = sox[a]; oay = soy[a];
    }
    if (W.dyn[b]) {
      if (incremental) { cb = cc[b]; sb = cs[b]; } else { cb = cosf(s.an[b]); sb = sinf(s.an[b]); }
      obx = s.px[b] - (cb * W.lcx[b] - sb * W.lcy[b]);
      oby = s.py[b] - (sb * W.lcx[b] + cb * W.lcy[b]);
    } else {
      cb = stc[b]; sb = sts[b]; obx = sox[b]; oby = soy[b];
    }
    const bool f = c.flip[p];
    const float cr = f ? cb : ca, sr = f ? sb : sa;
    const float orx = f ? obx : oax, ory = f ? oby : oay;
    const float ci = f ? ca : cb, si = f ? sa : sb;
    const float oix = f ? oax : obx, oiy = f ? oay : oby;
    const float nwx = cr * c.lnx[p] - sr * c.lny[p];
    const float nwy = sr * c.lnx[p] + cr * c.lny[p];
    const float ppx = (cr * c.lpx[p] - sr * c.lpy[p]) + orx;
    const float ppy = (sr * c.lpx[p] + cr * c.lpy[p]) + ory;
    const float nx = f ? -nwx : nwx, ny = f ? -nwy : nwy;

    for (int j = 0; j < 2; ++j) {
      const bool has = j < c.mcnt[p];
      const bool active = has && !pair_done;
      const float mpx = c.mpx[p][j], mpy = c.mpy[p][j];
      const float cpx = (ci * mpx - si * mpy) + oix;
      const float cpy = (si * mpx + ci * mpy) + oiy;
      const float sep = (cpx - ppx) * nwx + (cpy - ppy) * nwy - W.total_radius;
      if (has && solve) min_sep[isl] = fminf(min_sep[isl], sep);
      const float corr = fminf(fmaxf(W.baumgarte * (sep + W.linear_slop),
                                     -W.max_linear_correction), 0.0f);
      const float rax = cpx - s.px[a], ray = cpy - s.py[a];
      const float rbx = cpx - s.px[b], rby = cpy - s.py[b];
      float k = W.m_sum[p];
      if (W.dyn[a]) { const float rn = rax * ny - ray * nx; k = k + W.inv_i[a] * (rn * rn); }
      if (W.dyn[b]) { const float rn = rbx * ny - rby * nx; k = k + W.inv_i[b] * (rn * rn); }
      const float impulse = (k > 0.0f && active) ? -corr / k : 0.0f;
      const float pix = impulse * nx, piy = impulse * ny;
      if (W.dyn[a]) {
        s.px[a] = s.px[a] - W.inv_m[a] * pix;
        s.py[a] = s.py[a] - W.inv_m[a] * piy;
        const float dA = -(W.inv_i[a] * (rax * piy - ray * pix));
        s.an[a] = s.an[a] + dA;
        if (incremental) rot_step(W, cc[a], cs[a], dA);
      }
      if (W.dyn[b]) {
        s.px[b] = s.px[b] + W.inv_m[b] * pix;
        s.py[b] = s.py[b] + W.inv_m[b] * piy;
        const float dB = W.inv_i[b] * (rbx * piy - rby * pix);
        s.an[b] = s.an[b] + dB;
        if (incremental) rot_step(W, cc[b], cs[b], dB);
      }
    }
  }
}
