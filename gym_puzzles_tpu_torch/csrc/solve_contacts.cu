// Staged contact-solve kernel: the sequential-impulse solve of one engine
// tick per env, in one launch, around which world.step_batched runs the
// narrow phase, islands, constraint setup and sleep bookkeeping as plain
// PyTorch ops.
//
// Replaces the TPU kernel gym_puzzles_tpu/engine/solver_pallas.py
// _build_kernel (pallas_call at solver_pallas.py:780, entry solve_contacts).
// Computes what gym_puzzles_tpu_torch/engine/solver_cuda.py
// solve_contacts_plain computes, in the same order:
//   1. warm start with the accumulated impulses;
//   2. vel_iters velocity sweeps (friction, then the 1-point or 2-point
//      block normal solve), then the impulses are stored;
//   3. clamped position integration of the active bodies;
//   4. the static bodies' transforms, once;
//   5. pos_iters position sweeps with the per-island early exit: an island
//      is done when its minimum separation reaches -3 * linear_slop.
// The phases are the device functions of tick.cuh, shared with the fused
// tick kernel (step_fused.cu); this file only loads the constraint rows that
// kernel computes for itself.
//
// Islands: the caller passes ``link`` (pair touching and both bodies
// dynamic), as the TPU kernel's caller does, and the kernel labels islands
// from it by min-label propagation over the dynamic-dynamic pairs -- the
// labels solver.compute_islands gives.  ``done`` comes back per body: the
// flag of the body's island for a dynamic body, 0 for a static one.
//
// Layout: one thread per env over the TPU kernel's plane layout
// (solver_pallas.py:79-83, 718-746), env axis last.  The world table sits in
// __constant__ memory; dt and the iteration counts are runtime arguments.
//
// What bounds it: not bytes.  The planes are (43 P + 14 B) floats per env,
// read or written once; the sweeps are chains of dependent float32
// operations, sequential within the env.  The design (tick.cuh, as in the
// fused kernel): the loader compacts two lists of live rows in table order --
// the velocity phase's (effective count > 0) and the position phase's (solve
// and manifold points; the same pairs for every caller in this repo, but the
// planes allow them to differ) -- reading the row planes of those pairs only;
// the sweeps walk the lists with each visit's two bodies in registers; the
// per-env arrays are sized by the world's size class; a warp runs
// GPT_ENVS_PER_WARP envs, so every warp of 4096 envs runs at once.  What
// bounds it now is the latency of the most loaded env's chain: about
// 0.08-0.09 ms per live pair of that env at 180/60, plus ~0.045 ms of
// loading (H100; PERF.md).
//
// Floating point: no fast-math; nvcc contracts a*b+c into FMA, so results
// differ from the plain version in the last bits.
#include "tick.cuh"

namespace {

// pairA planes (x P), pairB planes (x P x 2 points), body planes (x B)
enum { A_NX, A_NY, A_K11, A_K12, A_K22, A_IM11, A_IM12, A_IM22, A_CNT, A_SOLVE, A_FLIP,
       A_LNX, A_LNY, A_LPX, A_LPY, A_LINK, A_MCNT };
enum { B_BIAS, B_NMASS, B_TMASS, B_RAX, B_RAY, B_RBX, B_RBY, B_MPX, B_MPY };
enum { S_VELX, S_VELY, S_OM, S_POSX, S_POSY, S_ANG };

template <int MB, int MP>
__device__ __forceinline__ void solve_env(const World& W, int e,
                                          const float* __restrict__ pair_a,
                                          const float* __restrict__ pair_b,
                                          const float* __restrict__ active,
                                          const float* __restrict__ body_in,
                                          const float* __restrict__ imp_in,
                                          float* __restrict__ body_out,
                                          float* __restrict__ imp_out,
                                          float* __restrict__ done_out, int E, float dt,
                                          int vel_iters, int pos_iters, int incremental) {
  const int B = W.B, P = W.P;
  const size_t sE = (size_t)E;
#define PA(plane, p) pair_a[((plane) * P + (p)) * sE + e]
#define PB(plane, p, j) pair_b[(((plane) * P + (p)) * 2 + (j)) * sE + e]
#define BODY(buf, plane, b) buf[((plane) * B + (b)) * sE + e]
#define NI(buf, p, j) buf[((p) * 2 + (j)) * sE + e]
#define TI(buf, p, j) buf[((P + (p)) * 2 + (j)) * sE + e]

  BodyState<MB> s;
  bool act[MB];
  int label[MB];
  uint64_t link = 0;  // bit p: pair p links two dynamic bodies
  VelRow vr[MP];      // the velocity phase's live rows, in table order
  PosRow pr[MP];      // the position phase's
  int nv = 0, np = 0;

  // ---- load body state and the live constraint rows -----------------------
  for (int b = 0; b < B; ++b) {
    s.vx[b] = BODY(body_in, S_VELX, b);
    s.vy[b] = BODY(body_in, S_VELY, b);
    s.om[b] = BODY(body_in, S_OM, b);
    s.px[b] = BODY(body_in, S_POSX, b);
    s.py[b] = BODY(body_in, S_POSY, b);
    s.an[b] = BODY(body_in, S_ANG, b);
    act[b] = active[b * sE + e] > 0.5f;
  }
  for (int p = 0; p < P; ++p) {
    const bool solve = PA(A_SOLVE, p) > 0.5f;
    const int cnt = solve ? (int)PA(A_CNT, p) : 0;  // effective count, 0 when not solved
    const int mcnt = (int)PA(A_MCNT, p);  // the position pass reads the manifold's count
    if (PA(A_LINK, p) > 0.5f) link |= (uint64_t)1 << p;
    // a pair the sweeps do not visit keeps its impulses
    float ni[2], ti[2];
    for (int j = 0; j < 2; ++j) {
      ni[j] = NI(imp_in, p, j);
      ti[j] = TI(imp_in, p, j);
      NI(imp_out, p, j) = ni[j];
      TI(imp_out, p, j) = ti[j];
    }
    if (cnt > 0) {
      VelRow& r = vr[nv++];
      pair_bodies(W, p, r);
      r.cnt = cnt;
      r.fric = W.fric[p];
      r.nx = PA(A_NX, p);
      r.ny = PA(A_NY, p);
      r.k11 = PA(A_K11, p);
      r.k12 = PA(A_K12, p);
      r.k22 = PA(A_K22, p);
      r.im11 = PA(A_IM11, p);
      r.im12 = PA(A_IM12, p);
      r.im22 = PA(A_IM22, p);
      for (int j = 0; j < 2; ++j) {
        r.bias[j] = PB(B_BIAS, p, j);
        r.nm[j] = PB(B_NMASS, p, j);
        r.tm[j] = PB(B_TMASS, p, j);
        r.rax[j] = PB(B_RAX, p, j);
        r.ray[j] = PB(B_RAY, p, j);
        r.rbx[j] = PB(B_RBX, p, j);
        r.rby[j] = PB(B_RBY, p, j);
        r.ni[j] = ni[j];
        r.ti[j] = ti[j];
      }
    }
    if (solve && mcnt > 0) {
      PosRow& r = pr[np++];
      pair_bodies(W, p, r);
      pos_consts(W, r);
      r.isl = W.rep[p];  // a body until the labels are known
      r.flip = PA(A_FLIP, p) > 0.5f;
      r.mcnt = mcnt;
      r.lnx = PA(A_LNX, p);
      r.lny = PA(A_LNY, p);
      r.lpx = PA(A_LPX, p);
      r.lpy = PA(A_LPY, p);
      for (int j = 0; j < 2; ++j) {
        r.mpx[j] = PB(B_MPX, p, j);
        r.mpy[j] = PB(B_MPY, p, j);
      }
    }
  }

  // ---- island labels from the links (min-label propagation) ---------------
  for (int b = 0; b < B; ++b) label[b] = b;
  const int rounds = W.n_dyn > 1 ? W.n_dyn : 1;
  for (int r = 0; r < rounds; ++r) {
    for (int k = 0; k < W.n_dd; ++k) {
      const int p = W.dd_pairs[k];
      if ((link >> p) & 1) {
        const int a = W.ia[p], b = W.ib[p];
        const int m = min(label[a], label[b]);
        label[a] = m;
        label[b] = m;
      }
    }
  }
  for (int k = 0; k < np; ++k) pr[k].isl = label[pr[k].isl];

  // ---- 1-2. warm start, velocity iterations, store impulses ----------------
  warm_start(s, vr, nv);
  for (int it = 0; it < vel_iters; ++it) vel_sweep(s, vr, nv);
  for (int k = 0; k < nv; ++k) {
    const VelRow& r = vr[k];
    for (int j = 0; j < 2; ++j) {
      NI(imp_out, r.p, j) = r.ni[j];
      TI(imp_out, r.p, j) = r.ti[j];
    }
  }

  // ---- 3-5. integrate positions, static rotations, position iterations -----
  integrate(W, s, act, dt);
  float cc[MB], cs[MB];
  bool done[MB];
  for (int b = 0; b < B; ++b) {
    // a dynamic body's entry is set by the position pass before it is read
    cc[b] = W.dyn[b] ? 1.0f : cosf(s.an[b]);
    cs[b] = W.dyn[b] ? 0.0f : sinf(s.an[b]);
  }
  pos_pass(W, s, pr, np, pos_iters, done, cc, cs, incremental != 0);

  // ---- outputs ---------------------------------------------------------------
  for (int b = 0; b < B; ++b) {
    BODY(body_out, S_VELX, b) = s.vx[b];
    BODY(body_out, S_VELY, b) = s.vy[b];
    BODY(body_out, S_OM, b) = s.om[b];
    BODY(body_out, S_POSX, b) = s.px[b];
    BODY(body_out, S_POSY, b) = s.py[b];
    BODY(body_out, S_ANG, b) = s.an[b];
    done_out[b * sE + e] = (W.dyn[b] && done[label[b]]) ? 1.0f : 0.0f;
  }
#undef PA
#undef PB
#undef BODY
#undef NI
#undef TI
}

}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

__constant__ World c_world;

template <int MB, int MP>
__global__ void __launch_bounds__(GPT_ENVS_PER_WARP)
solve_contacts_kernel(const float* __restrict__ pair_a, const float* __restrict__ pair_b,
                      const float* __restrict__ active, const float* __restrict__ body_in,
                      const float* __restrict__ imp_in, float* __restrict__ body_out,
                      float* __restrict__ imp_out, float* __restrict__ done_out, int E,
                      float dt, int vel_iters, int pos_iters, int incremental) {
  const int e = blockIdx.x * GPT_ENVS_PER_WARP + threadIdx.x;
  if (e >= E) return;  // ragged edge
  // the wrapper picks a size class the table fits; a world beyond it fails
  // the launch (and the context) rather than overrun the arrays
  if (c_world.B > MB || c_world.P > MP) __trap();
  solve_env<MB, MP>(c_world, e, pair_a, pair_b, active, body_in, imp_in, body_out, imp_out,
                    done_out, E, dt, vel_iters, pos_iters, incremental);
}

template <int MB, int MP>
static void launch(const float* pair_a, const float* pair_b, const float* active,
                   const float* body_in, const float* imp_in, float* body_out, float* imp_out,
                   float* done_out, int E, float dt, int vel_iters, int pos_iters,
                   int incremental, cudaStream_t stream) {
  const int blocks = (E + GPT_ENVS_PER_WARP - 1) / GPT_ENVS_PER_WARP;
  solve_contacts_kernel<MB, MP><<<blocks, GPT_ENVS_PER_WARP, 0, stream>>>(
      pair_a, pair_b, active, body_in, imp_in, body_out, imp_out, done_out, E, dt, vel_iters,
      pos_iters, incremental);
}

extern "C" {

// Copy a world table into this library's constant memory, ordered on ``stream``.
int gpt_set_world(const void* world, void* stream) {
  const cudaError_t err = cudaMemcpyToSymbolAsync(c_world, world, sizeof(World), 0,
                                                  cudaMemcpyHostToDevice, (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// One contact solve for E envs.  Planes in: pair_a [17P, E], pair_b [18P, E],
// active [B, E], body_in [6B, E], imp_in [4P, E]; out: body_out [6B, E],
// imp_out [4P, E], done_out [B, E].  ``size_class`` indexes
// gpt_size_classes().  Returns cudaGetLastError().
int gpt_solve_contacts(const float* pair_a, const float* pair_b, const float* active,
                       const float* body_in, const float* imp_in, float* body_out,
                       float* imp_out, float* done_out, int E, float dt, int vel_iters,
                       int pos_iters, int incremental, int size_class, void* stream) {
  if (E <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (size_class == 0)
    launch<GPT_SMALL_B, GPT_SMALL_P>(pair_a, pair_b, active, body_in, imp_in, body_out,
                                     imp_out, done_out, E, dt, vel_iters, pos_iters,
                                     incremental, st);
  else if (size_class == 1)
    launch<GPT_LARGE_B, GPT_LARGE_P>(pair_a, pair_b, active, body_in, imp_in, body_out,
                                     imp_out, done_out, E, dt, vel_iters, pos_iters,
                                     incremental, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"

#else  // host C++ build, for the CPU check

// Returns 0, or 1 when the world does not fit ``size_class``.
extern "C" int gpt_solve_contacts_host(const World* world, const float* pair_a,
                                       const float* pair_b, const float* active,
                                       const float* body_in, const float* imp_in,
                                       float* body_out, float* imp_out, float* done_out,
                                       int E, float dt, int vel_iters, int pos_iters,
                                       int incremental, int size_class) {
  const World& W = *world;
  if (size_class == 0 && W.B <= GPT_SMALL_B && W.P <= GPT_SMALL_P) {
    for (int e = 0; e < E; ++e)
      solve_env<GPT_SMALL_B, GPT_SMALL_P>(W, e, pair_a, pair_b, active, body_in, imp_in,
                                          body_out, imp_out, done_out, E, dt, vel_iters,
                                          pos_iters, incremental);
  } else if (size_class == 1 && W.B <= GPT_LARGE_B && W.P <= GPT_LARGE_P) {
    for (int e = 0; e < E; ++e)
      solve_env<GPT_LARGE_B, GPT_LARGE_P>(W, e, pair_a, pair_b, active, body_in, imp_in,
                                          body_out, imp_out, done_out, E, dt, vel_iters,
                                          pos_iters, incremental);
  } else {
    return 1;
  }
  return 0;
}

#endif  // __CUDACC__
