// Fused whole-tick kernel: one Box2D-style engine tick per env, in one launch.
//
// Replaces the TPU kernel gym_puzzles_tpu/engine/step_pallas.py
// _build_fused_kernel (pallas_call at step_pallas.py:916, entry step_fused).
// Computes what gym_puzzles_tpu_torch/engine/world.py::step computes, in the
// same order:
//   1. control wakes;
//   2. SAT + clip narrow phase over the static pair list (b2CollidePolygons);
//   3. manifold select, touch begin/end, contact-id impulse matching;
//   4. island labels (max(1, n_dyn) min-propagation rounds) and wake
//      propagation;
//   5. damped velocity integration and constraint setup of the live pairs;
//   6. warm start, velocity sweeps (friction, then normal with the 2-point
//      block solve);
//   7. position integration, position sweeps with the per-island early exit;
//   8. sleep bookkeeping and storing the impulses.
//
// Layout: one thread per env, reading and writing the JAX kernel's plane
// layout [planes, E] (step_pallas.py:81-95).  The static world (geometry,
// mass, pair list) sits in __constant__ memory; dt and the iteration counts
// are runtime arguments.
//
// What bounds it: not bytes.  A v0 tick moves ~455 words in and ~455 out per
// env (~15 MB at 4096 envs, ~4.5 us at 3.35 TB/s), but runs 180 velocity and
// 60 position sweeps: chains of dependent float32 operations, sequential
// within the env (Gauss-Seidel: the order is the result).  The design:
// * the sweeps visit only the env's live pairs (manifold points and an
//   active body, which here is the same as an effective count > 0),
//   compacted in table order into rows that carry the constants the sweeps
//   read (tick.cuh); the narrow phase and the setup still visit every pair,
//   uniformly across the warp;
// * each visit holds its two bodies in registers (one load, one store);
// * the per-env arrays are sized by the world's size class (templated on
//   the body and pair ceilings), not by the largest world;
// * a warp runs GPT_ENVS_PER_WARP envs (tick.cuh), so every warp of 4096
//   envs runs at once.
// What bounds it now is the latency of the most loaded env's chain: the
// launch lasts as long as the env with the most live pairs, about 0.08-0.09
// ms per live pair of that env at 180/60, plus 0.09 ms (v0) to 0.19 ms (v2)
// of narrow phase, setup and planes (H100; PERF.md).
//
// Floating point: no fast-math; cosf/sinf/sqrtf.  nvcc contracts a*b+c into
// FMA by default, so results differ from the plain PyTorch version (which
// rounds every product) in the last bits.
// Without nvcc this file compiles as host C++ (see tick.cuh), exporting
// gpt_step_fused_host.
#include "tick.cuh"

namespace {

// body input planes (x B), output planes (x B)
enum { BI_VELX, BI_VELY, BI_OM, BI_POSX, BI_POSY, BI_ANG, BI_AWAKE, BI_SLEEP, BI_WAKE,
       BI_FX, BI_FY, BI_TQ };
enum { BO_VELX, BO_VELY, BO_OM, BO_POSX, BO_POSY, BO_ANG, BO_AWAKE, BO_SLEEP };
// pair input planes (x P); the outputs add BEGIN and END
enum { PI_FLIP, PI_LNX, PI_LNY, PI_LPX, PI_LPY, PI_MPX0, PI_MPY0, PI_MPX1, PI_MPY1,
       PI_MCNT, PI_TOUCH, PI_NI0, PI_NI1, PI_TI0, PI_TI1, PI_N };
enum { PO_BEGIN = PI_N, PO_END };

constexpr int kVertex = 0;
constexpr int kFace = 1;

__device__ __forceinline__ int make_id(int index_a, int index_b, int type_a, int type_b) {
  return index_a | (index_b << 8) | (type_a << 16) | (type_b << 24);
}

__device__ __forceinline__ int flip_id(int cid) {
  const int index_a = cid & 0xFF, index_b = (cid >> 8) & 0xFF;
  const int type_a = (cid >> 16) & 0xFF, type_b = (cid >> 24) & 0xFF;
  return index_b | (index_a << 8) | (type_b << 16) | (type_a << 24);
}

struct Manifold {
  bool flip;
  float lnx, lny, lpx, lpy, mpx[2], mpy[2];
  int ids[2];
  int cnt;
};

typedef const float (*Poly)[2];

// b2FindMaxSeparation: best separating edge of poly1 against poly2; the
// first maximum wins ties (C++ scan order).
__device__ __forceinline__ void max_separation(Poly v1, Poly n1, int c1, float p1x, float p1y,
                                               float q1c, float q1s, Poly v2, int c2,
                                               float p2x, float p2y, float q2c, float q2s,
                                               float& sep, int& edge) {
  const float qc = q1c * q2c + q1s * q2s;  // rot_mul_t(q2, q1)
  const float qs = q1s * q2c - q1c * q2s;
  const float dx = p1x - p2x, dy = p1y - p2y;
  const float px = q2c * dx + q2s * dy;  // rot_vec_t(q2, p1 - p2)
  const float py = -q2s * dx + q2c * dy;
  float best = 0.0f;
  int bi = 0;
  for (int i = 0; i < c1; ++i) {
    const float nx = qc * n1[i][0] - qs * n1[i][1];
    const float ny = qs * n1[i][0] + qc * n1[i][1];
    const float vx = (qc * v1[i][0] - qs * v1[i][1]) + px;
    const float vy = (qs * v1[i][0] + qc * v1[i][1]) + py;
    float d = INFINITY;
    for (int j = 0; j < c2; ++j) d = fminf(d, nx * v2[j][0] + ny * v2[j][1]);
    const float s = d - (nx * vx + ny * vy);
    if (i == 0 || s > best) { best = s; bi = i; }
  }
  sep = best;
  edge = bi;
}

// b2ClipSegmentToLine on a fixed 2-point segment; ``two`` is false when
// fewer than 2 points survive.  ``t`` may be inf or NaN on the branch the
// selects throw away.
__device__ __forceinline__ void clip_segment(float& v0x, float& v0y, float& v1x, float& v1y,
                                             int& id0, int& id1, float cnx, float cny,
                                             float off, int vertex_index_a, bool& two) {
  const float d0 = (cnx * v0x + cny * v0y) - off;
  const float d1 = (cnx * v1x + cny * v1y) - off;
  const bool keep0 = d0 <= 0.0f, keep1 = d1 <= 0.0f;
  const float t = d0 / (d0 - d1);
  const float vix = v0x + t * (v1x - v0x);
  const float viy = v0y + t * (v1y - v0y);
  const int id_i = make_id(vertex_index_a, (id0 >> 8) & 0xFF, kVertex, kFace);
  const float o0x = keep0 ? v0x : v1x, o0y = keep0 ? v0y : v1y;
  const int oid0 = keep0 ? id0 : id1;
  const bool both = keep0 && keep1;
  const float o1x = both ? v1x : vix, o1y = both ? v1y : viy;
  const int oid1 = both ? id1 : id_i;
  two = both || (d0 * d1 < 0.0f);
  v0x = o0x; v0y = o0y; v1x = o1x; v1y = o1y; id0 = oid0; id1 = oid1;
}

// b2CollidePolygons for pair p at the given body-origin transforms.
__device__ __forceinline__ Manifold collide(const World& W, int p, const float* ox, const float* oy,
                            const float* qc, const float* qs) {
  const int a = W.ia[p], b = W.ib[p], fa = W.fa[p], fb = W.fb[p];
  const int ca = W.fix_count[fa], cb = W.fix_count[fb];
  const float TR = W.total_radius;
  float sep_a, sep_b;
  int edge_a, edge_b;
  max_separation(W.fix_verts[fa], W.fix_normals[fa], ca, ox[a], oy[a], qc[a], qs[a],
                 W.fix_verts[fb], cb, ox[b], oy[b], qc[b], qs[b], sep_a, edge_a);
  max_separation(W.fix_verts[fb], W.fix_normals[fb], cb, ox[b], oy[b], qc[b], qs[b],
                 W.fix_verts[fa], ca, ox[a], oy[a], qc[a], qs[a], sep_b, edge_b);
  const bool separated = (sep_a > TR) || (sep_b > TR);
  const bool flip = sep_b > sep_a + W.clip_tol;

  // reference (1) and incident (2) polygons
  const int r = flip ? b : a, n = flip ? a : b;
  Poly v1 = W.fix_verts[flip ? fb : fa];
  Poly n1 = W.fix_normals[flip ? fb : fa];
  Poly v2 = W.fix_verts[flip ? fa : fb];
  Poly n2 = W.fix_normals[flip ? fa : fb];
  const int c1 = flip ? cb : ca, c2 = flip ? ca : cb;
  const int edge1 = flip ? edge_b : edge_a;
  const float p1x = ox[r], p1y = oy[r], q1c = qc[r], q1s = qs[r];
  const float p2x = ox[n], p2y = oy[n], q2c = qc[n], q2s = qs[n];

  // b2FindIncidentEdge: poly2's edge most anti-parallel to the reference edge
  const float wnx = q1c * n1[edge1][0] - q1s * n1[edge1][1];
  const float wny = q1s * n1[edge1][0] + q1c * n1[edge1][1];
  const float rnx = q2c * wnx + q2s * wny;  // in poly2's frame
  const float rny = -q2s * wnx + q2c * wny;
  int i1 = 0;
  float dmin = 0.0f;
  for (int i = 0; i < c2; ++i) {
    const float d = n2[i][0] * rnx + n2[i][1] * rny;
    if (i == 0 || d < dmin) { dmin = d; i1 = i; }
  }
  const int i2 = i1 + 1 < c2 ? i1 + 1 : 0;
  float c0x = (q2c * v2[i1][0] - q2s * v2[i1][1]) + p2x;
  float c0y = (q2s * v2[i1][0] + q2c * v2[i1][1]) + p2y;
  float c1x = (q2c * v2[i2][0] - q2s * v2[i2][1]) + p2x;
  float c1y = (q2s * v2[i2][0] + q2c * v2[i2][1]) + p2y;
  int cid0 = make_id(edge1, i1, kFace, kVertex);
  int cid1 = make_id(edge1, i2, kFace, kVertex);

  // reference edge geometry
  const int iv1 = edge1, iv2 = edge1 + 1 < c1 ? edge1 + 1 : 0;
  const float v11x = v1[iv1][0], v11y = v1[iv1][1];
  const float v12x = v1[iv2][0], v12y = v1[iv2][1];
  float ltx = v12x - v11x, lty = v12y - v11y;
  const float norm = sqrtf(ltx * ltx + lty * lty);
  ltx = ltx / norm;
  lty = lty / norm;
  Manifold m;
  m.lnx = lty;
  m.lny = -ltx;
  m.lpx = 0.5f * (v11x + v12x);
  m.lpy = 0.5f * (v11y + v12y);
  const float tx = q1c * ltx - q1s * lty, ty = q1s * ltx + q1c * lty;  // world tangent
  const float nx = ty, ny = -tx;
  const float w11x = (q1c * v11x - q1s * v11y) + p1x, w11y = (q1s * v11x + q1c * v11y) + p1y;
  const float w12x = (q1c * v12x - q1s * v12y) + p1x, w12y = (q1s * v12x + q1c * v12y) + p1y;
  const float front = nx * w11x + ny * w11y;
  const float side1 = -(tx * w11x + ty * w11y) + TR;
  const float side2 = (tx * w12x + ty * w12y) + TR;

  bool ok1, ok2;
  clip_segment(c0x, c0y, c1x, c1y, cid0, cid1, -tx, -ty, side1, iv1, ok1);
  clip_segment(c0x, c0y, c1x, c1y, cid0, cid1, tx, ty, side2, iv2, ok2);

  // final separation filter with slot compaction
  const bool keep0 = (c0x * nx + c0y * ny) - front <= TR;
  const bool keep1 = (c1x * nx + c1y * ny) - front <= TR;
  const float d0x = c0x - p2x, d0y = c0y - p2y, d1x = c1x - p2x, d1y = c1y - p2y;
  const float l0x = q2c * d0x + q2s * d0y, l0y = -q2s * d0x + q2c * d0y;
  const float l1x = q2c * d1x + q2s * d1y, l1y = -q2s * d1x + q2c * d1y;
  const int oid0 = flip ? flip_id(cid0) : cid0;
  const int oid1 = flip ? flip_id(cid1) : cid1;
  int cnt = (int)keep0 + (int)keep1;
  if (separated || !ok1 || !ok2) cnt = 0;
  m.flip = flip;
  m.cnt = cnt;
  // slot 0 takes the first kept point; dead slots are zeroed / id -1
  m.mpx[0] = cnt > 0 ? (keep0 ? l0x : l1x) : 0.0f;
  m.mpy[0] = cnt > 0 ? (keep0 ? l0y : l1y) : 0.0f;
  m.ids[0] = cnt > 0 ? (keep0 ? oid0 : oid1) : -1;
  m.mpx[1] = cnt > 1 ? l1x : 0.0f;
  m.mpy[1] = cnt > 1 ? l1y : 0.0f;
  m.ids[1] = cnt > 1 ? oid1 : -1;
  return m;
}


// The whole tick of env ``e``: plain C++ on one thread's registers and
// local memory, with per-env arrays sized for MB bodies and MP pairs.
template <int MB, int MP>
__device__ __forceinline__ void tick_env(const World& W, int e, const float* __restrict__ bf,
                                         const float* __restrict__ pf,
                                         const int* __restrict__ pi, float* __restrict__ bfo,
                                         float* __restrict__ pfo, int* __restrict__ pio,
                                         int E, float dt, int vel_iters, int pos_iters,
                                         int incremental) {
  const int B = W.B, P = W.P;
  const size_t sE = (size_t)E;
#define BIN(plane, b) bf[((plane) * B + (b)) * sE + e]
#define BOUT(plane, b) bfo[((plane) * B + (b)) * sE + e]
#define PIN(plane, p) pf[((plane) * P + (p)) * sE + e]
#define POUT(plane, p) pfo[((plane) * P + (p)) * sE + e]

  BodyState<MB> s;
  float sl[MB];
  bool aw[MB], act[MB];
  float qc[MB], qs[MB], ox[MB], oy[MB];
  int label[MB];
  uint64_t touch = 0;  // bit p: pair p touches
  // Rows of the live pairs, row k the k-th in table order.  Until the setup
  // they hold the candidates (pairs with manifold points): manifold in pr,
  // matched impulses in vr.
  VelRow vr[MP];
  PosRow pr[MP];

  // ---- 1. read state; control wakes ---------------------------------------
  for (int b = 0; b < B; ++b) {
    s.vx[b] = BIN(BI_VELX, b);
    s.vy[b] = BIN(BI_VELY, b);
    s.om[b] = BIN(BI_OM, b);
    s.px[b] = BIN(BI_POSX, b);
    s.py[b] = BIN(BI_POSY, b);
    s.an[b] = BIN(BI_ANG, b);
    const bool awake0 = BIN(BI_AWAKE, b) > 0.5f, wake = BIN(BI_WAKE, b) > 0.5f;
    aw[b] = awake0 || wake;
    sl[b] = (wake && !awake0) ? 0.0f : BIN(BI_SLEEP, b);
    qc[b] = cosf(s.an[b]);
    qs[b] = sinf(s.an[b]);
    ox[b] = s.px[b] - (qc[b] * W.lcx[b] - qs[b] * W.lcy[b]);
    oy[b] = s.py[b] - (qs[b] * W.lcx[b] + qc[b] * W.lcy[b]);
  }

  // ---- 2-3. narrow phase, manifold select, touch events, matching --------
  // Every output plane of a pair is written here; the impulses of the live
  // slots are written again after the solve.
  int n_cand = 0;
  for (int p = 0; p < P; ++p) {
    const int a = W.ia[p], b = W.ib[p];
    const Manifold m = collide(W, p, ox, oy, qc, qs);
    // contacts update unless every dynamic endpoint sleeps
    const bool upd = (aw[a] || !W.dyn[a]) || (aw[b] || !W.dyn[b]);
    const bool old_touch = PIN(PI_TOUCH, p) > 0.5f;
    const int old_id0 = pi[(2 * p) * sE + e], old_id1 = pi[(2 * p + 1) * sE + e];
    const float old_n[2] = {PIN(PI_NI0, p), PIN(PI_NI1, p)};
    const float old_t[2] = {PIN(PI_TI0, p), PIN(PI_TI1, p)};
    bool flip, t;
    float lnx, lny, lpx, lpy, mpx[2], mpy[2], ni[2], ti[2];
    int mcnt;
    if (upd) {
      flip = m.flip;
      lnx = m.lnx; lny = m.lny; lpx = m.lpx; lpy = m.lpy;
      for (int j = 0; j < 2; ++j) { mpx[j] = m.mpx[j]; mpy[j] = m.mpy[j]; }
      mcnt = m.cnt;
      t = m.cnt > 0;
      pio[(2 * p) * sE + e] = m.ids[0];
      pio[(2 * p + 1) * sE + e] = m.ids[1];
      for (int j = 0; j < 2; ++j) {  // b2Contact::Update impulse matching
        const int nid = m.ids[j];
        const bool hit0 = nid == old_id0 && nid >= 0 && old_id0 >= 0;
        const bool hit1 = nid == old_id1 && nid >= 0 && old_id1 >= 0;
        ni[j] = hit0 ? old_n[0] : (hit1 ? old_n[1] : 0.0f);
        ti[j] = hit0 ? old_t[0] : (hit1 ? old_t[1] : 0.0f);
      }
    } else {
      flip = PIN(PI_FLIP, p) > 0.5f;
      lnx = PIN(PI_LNX, p); lny = PIN(PI_LNY, p);
      lpx = PIN(PI_LPX, p); lpy = PIN(PI_LPY, p);
      mpx[0] = PIN(PI_MPX0, p); mpy[0] = PIN(PI_MPY0, p);
      mpx[1] = PIN(PI_MPX1, p); mpy[1] = PIN(PI_MPY1, p);
      mcnt = (int)PIN(PI_MCNT, p);
      t = old_touch;
      pio[(2 * p) * sE + e] = old_id0;
      pio[(2 * p + 1) * sE + e] = old_id1;
      for (int j = 0; j < 2; ++j) { ni[j] = old_n[j]; ti[j] = old_t[j]; }
    }
    POUT(PI_FLIP, p) = flip ? 1.0f : 0.0f;
    POUT(PI_LNX, p) = lnx;
    POUT(PI_LNY, p) = lny;
    POUT(PI_LPX, p) = lpx;
    POUT(PI_LPY, p) = lpy;
    POUT(PI_MPX0, p) = mpx[0];
    POUT(PI_MPY0, p) = mpy[0];
    POUT(PI_MPX1, p) = mpx[1];
    POUT(PI_MPY1, p) = mpy[1];
    POUT(PI_MCNT, p) = (float)mcnt;
    POUT(PI_TOUCH, p) = t ? 1.0f : 0.0f;
    POUT(PO_BEGIN, p) = (upd && t && !old_touch) ? 1.0f : 0.0f;
    POUT(PO_END, p) = (upd && !t && old_touch) ? 1.0f : 0.0f;
    POUT(PI_NI0, p) = ni[0];
    POUT(PI_NI1, p) = ni[1];
    POUT(PI_TI0, p) = ti[0];
    POUT(PI_TI1, p) = ti[1];
    if (t) touch |= (uint64_t)1 << p;
    if (mcnt > 0) {  // a candidate: live if one of its bodies is active
      PosRow& r = pr[n_cand];
      r.p = p;
      r.flip = flip;
      r.mcnt = mcnt;
      r.lnx = lnx; r.lny = lny; r.lpx = lpx; r.lpy = lpy;
      for (int j = 0; j < 2; ++j) {
        r.mpx[j] = mpx[j];
        r.mpy[j] = mpy[j];
        vr[n_cand].ni[j] = ni[j];
        vr[n_cand].ti[j] = ti[j];
      }
      ++n_cand;
    }
  }

  // ---- 4. islands (min-label propagation) and wake propagation -----------
  for (int b = 0; b < B; ++b) label[b] = b;
  const int rounds = W.n_dyn > 1 ? W.n_dyn : 1;
  for (int r = 0; r < rounds; ++r) {
    for (int k = 0; k < W.n_dd; ++k) {
      const int p = W.dd_pairs[k];
      if ((touch >> p) & 1) {
        const int a = W.ia[p], b = W.ib[p];
        const int m = min(label[a], label[b]);
        label[a] = m;
        label[b] = m;
      }
    }
  }
  for (int b = 0; b < B; ++b) {
    bool any = false;
    for (int b2 = 0; b2 < B; ++b2) any = any || (label[b2] == label[b] && aw[b2]);
    act[b] = any && W.dyn[b];
  }
  for (int b = 0; b < B; ++b) {
    if (act[b] && !aw[b]) sl[b] = 0.0f;  // woken: timer reset
    aw[b] = act[b];
  }

  // ---- 5. damped velocity integration; constraint setup ------------------
  for (int k = 0; k < W.n_dyn; ++k) {
    const int b = W.dyn_bodies[k];
    if (!act[b]) continue;
    // float32 coefficients rounded as the host rounds them (no FMA)
    const float dt_im = __fmul_rn(dt, W.inv_m[b]), dt_ii = __fmul_rn(dt, W.inv_i[b]);
    const float lin_k = fminf(fmaxf(1.0f - __fmul_rn(dt, W.lin_damp[b]), 0.0f), 1.0f);
    const float ang_k = fminf(fmaxf(1.0f - __fmul_rn(dt, W.ang_damp[b]), 0.0f), 1.0f);
    s.vx[b] = (s.vx[b] + dt_im * BIN(BI_FX, b)) * lin_k;
    s.vy[b] = (s.vy[b] + dt_im * BIN(BI_FY, b)) * lin_k;
    s.om[b] = (s.om[b] + dt_ii * BIN(BI_TQ, b)) * ang_k;
  }
  // b2ContactSolver::InitializeVelocityConstraints for the live pairs: walk
  // the table (uniform across the warp) with a cursor over this env's
  // candidates, compacting the live ones to rows 0..n-1 (n <= cursor, so a
  // row is read before it is overwritten).
  int n = 0;
  for (int p = 0, k = 0; p < P; ++p) {
    if (k >= n_cand || pr[k].p != p) continue;
    const int a = W.ia[p], b = W.ib[p];
    const PosRow m = pr[k];
    const float ni0[2] = {vr[k].ni[0], vr[k].ni[1]}, ti0[2] = {vr[k].ti[0], vr[k].ti[1]};
    ++k;
    // solve = manifold points && an active body; then the effective count is > 0
    if (!(act[a] || act[b])) continue;
    VelRow& v = vr[n];
    PosRow& q = pr[n];
    q = m;
    pair_bodies(W, p, q);
    pos_consts(W, q);
    q.isl = label[W.rep[p]];
    pair_bodies(W, p, v);
    v.fric = W.fric[p];
    const bool f = m.flip;
    const int r = f ? b : a, o = f ? a : b;
    const float nrx = qc[r] * m.lnx - qs[r] * m.lny;
    const float nry = qs[r] * m.lnx + qc[r] * m.lny;
    const float ppx = (qc[r] * m.lpx - qs[r] * m.lpy) + ox[r];
    const float ppy = (qs[r] * m.lpx + qc[r] * m.lpy) + oy[r];
    const float nx = f ? -nrx : nrx, ny = f ? -nry : nry;
    const float tx = ny, ty = -nx;
    v.nx = nx;
    v.ny = ny;
    float rn_a[2], rn_b[2], kn[2];
    for (int j = 0; j < 2; ++j) {
      const float cx = (qc[o] * m.mpx[j] - qs[o] * m.mpy[j]) + ox[o];
      const float cy = (qs[o] * m.mpx[j] + qc[o] * m.mpy[j]) + oy[o];
      const float d = (cx - ppx) * nrx + (cy - ppy) * nry;
      const float crx = cx + (W.polygon_radius - d) * nrx;
      const float cry = cy + (W.polygon_radius - d) * nry;
      const float cix = cx - W.polygon_radius * nrx;
      const float ciy = cy - W.polygon_radius * nry;
      const float wx = 0.5f * (crx + cix), wy = 0.5f * (cry + ciy);
      const float rax = wx - s.px[a], ray = wy - s.py[a];
      const float rbx = wx - s.px[b], rby = wy - s.py[b];
      v.rax[j] = rax; v.ray[j] = ray; v.rbx[j] = rbx; v.rby[j] = rby;
      rn_a[j] = rax * ny - ray * nx;
      rn_b[j] = rbx * ny - rby * nx;
      kn[j] = W.m_sum[p] + W.inv_i[a] * (rn_a[j] * rn_a[j]) + W.inv_i[b] * (rn_b[j] * rn_b[j]);
      v.nm[j] = kn[j] > 0.0f ? 1.0f / kn[j] : 0.0f;
      const float rt_a = rax * ty - ray * tx, rt_b = rbx * ty - rby * tx;
      const float kt = W.m_sum[p] + W.inv_i[a] * (rt_a * rt_a) + W.inv_i[b] * (rt_b * rt_b);
      v.tm[j] = kt > 0.0f ? 1.0f / kt : 0.0f;
      // relative normal velocity for the restitution bias (statics: v = 0)
      const float dvx = s.vx[b] - s.om[b] * rby - s.vx[a] + s.om[a] * ray;
      const float dvy = s.vy[b] + s.om[b] * rbx - s.vy[a] - s.om[a] * rax;
      const float v_rel = dvx * nx + dvy * ny;
      v.bias[j] = v_rel < -W.velocity_threshold ? -W.rest[p] * v_rel : 0.0f;
      v.ni[j] = ni0[j];
      v.ti[j] = ti0[j];
    }
    const float k11 = kn[0], k22 = kn[1];
    const float k12 = W.m_sum[p] + W.inv_i[a] * rn_a[0] * rn_a[1] + W.inv_i[b] * rn_b[0] * rn_b[1];
    const float det = k11 * k22 - k12 * k12;
    const bool cond_ok = k11 * k11 < W.max_condition * det;
    const float inv_det = det != 0.0f ? 1.0f / det : 0.0f;
    v.k11 = k11; v.k12 = k12; v.k22 = k22;
    v.im11 = inv_det * k22;
    v.im12 = -inv_det * k12;
    v.im22 = inv_det * k11;
    v.cnt = (m.mcnt == 2 && !cond_ok) ? 1 : m.mcnt;
    ++n;
  }

  // ---- 6. warm start, velocity iterations ---------------------------------
  warm_start(s, vr, n);
  for (int it = 0; it < vel_iters; ++it) vel_sweep(s, vr, n);

  // ---- 7. integrate positions, position iterations -----------------------
  integrate(W, s, act, dt);
  // static bodies never move: their rotations are the tick-start ones
  float cc[MB], cs[MB];
  bool done[MB];
  for (int b = 0; b < B; ++b) { cc[b] = qc[b]; cs[b] = qs[b]; }
  pos_pass(W, s, pr, n, pos_iters, done, cc, cs, incremental != 0);
  if (P == 0)
    for (int b = 0; b < B; ++b) done[b] = true;

  // ---- 8. sleep bookkeeping, outputs --------------------------------------
  for (int k = 0; k < W.n_dyn; ++k) {
    const int b = W.dyn_bodies[k];
    if (!act[b]) continue;
    const bool fast = (s.vx[b] * s.vx[b] + s.vy[b] * s.vy[b] > W.lin_sleep_tol_sq) ||
                      (s.om[b] * s.om[b] > W.ang_sleep_tol_sq);
    sl[b] = fast ? 0.0f : sl[b] + dt;
  }
  for (int b = 0; b < B; ++b) {
    bool sleeps = false;
    if (act[b]) {
      float island_min = INFINITY;
      for (int b2 = 0; b2 < B; ++b2)
        if (label[b2] == label[b] && act[b2]) island_min = fminf(island_min, sl[b2]);
      sleeps = island_min >= W.time_to_sleep && done[label[b]];
    }
    BOUT(BO_VELX, b) = sleeps ? 0.0f : s.vx[b];
    BOUT(BO_VELY, b) = sleeps ? 0.0f : s.vy[b];
    BOUT(BO_OM, b) = sleeps ? 0.0f : s.om[b];
    BOUT(BO_POSX, b) = s.px[b];
    BOUT(BO_POSY, b) = s.py[b];
    BOUT(BO_ANG, b) = s.an[b];
    BOUT(BO_AWAKE, b) = (aw[b] && !sleeps) ? 1.0f : 0.0f;
    BOUT(BO_SLEEP, b) = sleeps ? 0.0f : sl[b];
  }
  // the solved impulses of the live slots (the others keep the matched ones)
  for (int k = 0; k < n; ++k) {
    const VelRow& v = vr[k];
    const int p = v.p;
    POUT(PI_NI0, p) = v.ni[0];
    POUT(PI_TI0, p) = v.ti[0];
    if (v.cnt > 1) {
      POUT(PI_NI1, p) = v.ni[1];
      POUT(PI_TI1, p) = v.ti[1];
    }
  }
#undef BIN
#undef BOUT
#undef PIN
#undef POUT
}

}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

__constant__ World c_world;

template <int MB, int MP>
__global__ void __launch_bounds__(GPT_ENVS_PER_WARP)
step_fused_kernel(const float* __restrict__ bf, const float* __restrict__ pf,
                  const int* __restrict__ pi, float* __restrict__ bfo,
                  float* __restrict__ pfo, int* __restrict__ pio, int E, float dt,
                  int vel_iters, int pos_iters, int incremental) {
  const int e = blockIdx.x * GPT_ENVS_PER_WARP + threadIdx.x;
  if (e >= E) return;  // ragged edge
  // the wrapper picks a size class the table fits; a world beyond it fails
  // the launch (and the context) rather than overrun the arrays
  if (c_world.B > MB || c_world.P > MP) __trap();
  tick_env<MB, MP>(c_world, e, bf, pf, pi, bfo, pfo, pio, E, dt, vel_iters, pos_iters,
                   incremental);
}

template <int MB, int MP>
static void launch(const float* bf, const float* pf, const int* pi, float* bfo, float* pfo,
                   int* pio, int E, float dt, int vel_iters, int pos_iters, int incremental,
                   cudaStream_t stream) {
  const int blocks = (E + GPT_ENVS_PER_WARP - 1) / GPT_ENVS_PER_WARP;
  step_fused_kernel<MB, MP><<<blocks, GPT_ENVS_PER_WARP, 0, stream>>>(
      bf, pf, pi, bfo, pfo, pio, E, dt, vel_iters, pos_iters, incremental);
}

extern "C" {

// Copy a world table into constant memory, ordered on ``stream``.
int gpt_set_world(const void* world, void* stream) {
  const cudaError_t err = cudaMemcpyToSymbolAsync(c_world, world, sizeof(World), 0,
                                                  cudaMemcpyHostToDevice, (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// One tick for E envs.  Planes: bf [12B, E], pf [15P, E], pi [2P, E] in;
// bfo [8B, E], pfo [17P, E], pio [2P, E] out.  ``size_class`` indexes
// gpt_size_classes().  Returns cudaGetLastError().
int gpt_step_fused(const float* bf, const float* pf, const int* pi, float* bfo, float* pfo,
                   int* pio, int E, float dt, int vel_iters, int pos_iters, int incremental,
                   int size_class, void* stream) {
  if (E <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (size_class == 0)
    launch<GPT_SMALL_B, GPT_SMALL_P>(bf, pf, pi, bfo, pfo, pio, E, dt, vel_iters, pos_iters,
                                     incremental, st);
  else if (size_class == 1)
    launch<GPT_LARGE_B, GPT_LARGE_P>(bf, pf, pi, bfo, pfo, pio, E, dt, vel_iters, pos_iters,
                                     incremental, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"

#else  // host C++ build, for the CPU check

// Returns 0, or 1 when the world does not fit ``size_class``.
extern "C" int gpt_step_fused_host(const World* world, const float* bf, const float* pf,
                                   const int* pi, float* bfo, float* pfo, int* pio, int E,
                                   float dt, int vel_iters, int pos_iters, int incremental,
                                   int size_class) {
  const World& W = *world;
  if (size_class == 0 && W.B <= GPT_SMALL_B && W.P <= GPT_SMALL_P) {
    for (int e = 0; e < E; ++e)
      tick_env<GPT_SMALL_B, GPT_SMALL_P>(W, e, bf, pf, pi, bfo, pfo, pio, E, dt, vel_iters,
                                         pos_iters, incremental);
  } else if (size_class == 1 && W.B <= GPT_LARGE_B && W.P <= GPT_LARGE_P) {
    for (int e = 0; e < E; ++e)
      tick_env<GPT_LARGE_B, GPT_LARGE_P>(W, e, bf, pf, pi, bfo, pfo, pio, E, dt, vel_iters,
                                         pos_iters, incremental);
  } else {
    return 1;
  }
  return 0;
}

#endif  // __CUDACC__
