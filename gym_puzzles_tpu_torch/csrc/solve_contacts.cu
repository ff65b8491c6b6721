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
// Design: one thread per env over the TPU kernel's plane layout
// (solver_pallas.py:79-83, 718-746), env axis last, so a warp's 32 threads
// touch 32 neighbouring floats of each plane.  The world table sits in
// __constant__ memory; dt and the iteration counts are runtime arguments.
//
// What bounds it: not bytes.  The planes are (43 P + 14 B) floats per env,
// read or written once; the sweeps are a few hundred thousand dependent
// float32 operations per env on constraint rows indexed at run time, which
// live in local memory.  Like the fused kernel it is latency-bound at 4096
// envs (one warp per SM); making it fast is later work.
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

  BodyState s;
  PairState c;
  bool act[GPT_MAX_B], link[GPT_MAX_P];
  int label[GPT_MAX_B];

  // ---- load body state and constraint rows --------------------------------
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
    c.nx[p] = PA(A_NX, p);
    c.ny[p] = PA(A_NY, p);
    c.k11[p] = PA(A_K11, p);
    c.k12[p] = PA(A_K12, p);
    c.k22[p] = PA(A_K22, p);
    c.im11[p] = PA(A_IM11, p);
    c.im12[p] = PA(A_IM12, p);
    c.im22[p] = PA(A_IM22, p);
    c.solve[p] = PA(A_SOLVE, p) > 0.5f;
    c.cnt[p] = c.solve[p] ? (int)PA(A_CNT, p) : 0;  // effective count, 0 when not solved
    c.flip[p] = PA(A_FLIP, p) > 0.5f;
    c.lnx[p] = PA(A_LNX, p);
    c.lny[p] = PA(A_LNY, p);
    c.lpx[p] = PA(A_LPX, p);
    c.lpy[p] = PA(A_LPY, p);
    link[p] = PA(A_LINK, p) > 0.5f;
    c.mcnt[p] = (int)PA(A_MCNT, p);  // the position pass reads the manifold's count
    for (int j = 0; j < 2; ++j) {
      c.bias[p][j] = PB(B_BIAS, p, j);
      c.nm[p][j] = PB(B_NMASS, p, j);
      c.tm[p][j] = PB(B_TMASS, p, j);
      c.rax[p][j] = PB(B_RAX, p, j);
      c.ray[p][j] = PB(B_RAY, p, j);
      c.rbx[p][j] = PB(B_RBX, p, j);
      c.rby[p][j] = PB(B_RBY, p, j);
      c.mpx[p][j] = PB(B_MPX, p, j);
      c.mpy[p][j] = PB(B_MPY, p, j);
      c.ni[p][j] = imp_in[(p * 2 + j) * sE + e];
      c.ti[p][j] = imp_in[((P + p) * 2 + j) * sE + e];
    }
  }

  // ---- island labels from the links (min-label propagation) ---------------
  for (int b = 0; b < B; ++b) label[b] = b;
  const int rounds = W.n_dyn > 1 ? W.n_dyn : 1;
  for (int r = 0; r < rounds; ++r) {
    for (int k = 0; k < W.n_dd; ++k) {
      const int p = W.dd_pairs[k];
      if (link[p]) {
        const int a = W.ia[p], b = W.ib[p];
        const int m = min(label[a], label[b]);
        label[a] = m;
        label[b] = m;
      }
    }
  }

  // ---- 1-2. warm start, velocity iterations, store impulses ----------------
  warm_start(W, s, c);
  for (int it = 0; it < vel_iters; ++it) vel_sweep(W, s, c);
  for (int p = 0; p < P; ++p) {
    for (int j = 0; j < 2; ++j) {
      imp_out[(p * 2 + j) * sE + e] = c.ni[p][j];
      imp_out[((P + p) * 2 + j) * sE + e] = c.ti[p][j];
    }
  }

  // ---- 3-5. integrate positions, static transforms, position iterations ----
  integrate(W, s, act, dt);
  float stc[GPT_MAX_B], sts[GPT_MAX_B], sox[GPT_MAX_B], soy[GPT_MAX_B];
  float cc[GPT_MAX_B], cs[GPT_MAX_B], min_sep[GPT_MAX_B];
  bool done[GPT_MAX_B];
  for (int b = 0; b < B; ++b) {
    done[b] = false;
    if (W.dyn[b]) continue;
    stc[b] = cosf(s.an[b]);
    sts[b] = sinf(s.an[b]);
    sox[b] = s.px[b] - (stc[b] * W.lcx[b] - sts[b] * W.lcy[b]);
    soy[b] = s.py[b] - (sts[b] * W.lcx[b] + stc[b] * W.lcy[b]);
  }
  for (int it = 0; it < pos_iters; ++it) {
    for (int b = 0; b < B; ++b) min_sep[b] = 0.0f;
    pos_sweep(W, s, c, label, done, min_sep, stc, sts, sox, soy, cc, cs, incremental != 0);
    for (int b = 0; b < B; ++b) done[b] = done[b] || (min_sep[b] >= W.pos_done_sep);
  }

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
}

}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

__constant__ World c_world;

__global__ void __launch_bounds__(32)
solve_contacts_kernel(const float* __restrict__ pair_a, const float* __restrict__ pair_b,
                      const float* __restrict__ active, const float* __restrict__ body_in,
                      const float* __restrict__ imp_in, float* __restrict__ body_out,
                      float* __restrict__ imp_out, float* __restrict__ done_out, int E,
                      float dt, int vel_iters, int pos_iters, int incremental) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;  // ragged edge
  solve_env(c_world, e, pair_a, pair_b, active, body_in, imp_in, body_out, imp_out, done_out,
            E, dt, vel_iters, pos_iters, incremental);
}

extern "C" {

int gpt_world_bytes(void) { return (int)sizeof(World); }

// Copy a world table into this library's constant memory, ordered on ``stream``.
int gpt_set_world(const void* world, void* stream) {
  const cudaError_t err = cudaMemcpyToSymbolAsync(c_world, world, sizeof(World), 0,
                                                  cudaMemcpyHostToDevice, (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// One contact solve for E envs.  Planes in: pair_a [17P, E], pair_b [18P, E],
// active [B, E], body_in [6B, E], imp_in [4P, E]; out: body_out [6B, E],
// imp_out [4P, E], done_out [B, E].  Returns cudaGetLastError().
int gpt_solve_contacts(const float* pair_a, const float* pair_b, const float* active,
                       const float* body_in, const float* imp_in, float* body_out,
                       float* imp_out, float* done_out, int E, float dt, int vel_iters,
                       int pos_iters, int incremental, void* stream) {
  if (E <= 0) return 0;
  const int threads = 32;
  const int blocks = (E + threads - 1) / threads;
  solve_contacts_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      pair_a, pair_b, active, body_in, imp_in, body_out, imp_out, done_out, E, dt, vel_iters,
      pos_iters, incremental);
  return (int)cudaGetLastError();
}

}  // extern "C"

#else  // host C++ build, for the CPU check

extern "C" void gpt_solve_contacts_host(const World* world, const float* pair_a,
                                        const float* pair_b, const float* active,
                                        const float* body_in, const float* imp_in,
                                        float* body_out, float* imp_out, float* done_out,
                                        int E, float dt, int vel_iters, int pos_iters,
                                        int incremental) {
  for (int e = 0; e < E; ++e)
    solve_env(*world, e, pair_a, pair_b, active, body_in, imp_in, body_out, imp_out, done_out,
              E, dt, vel_iters, pos_iters, incremental);
}

extern "C" int gpt_world_bytes(void) { return (int)sizeof(World); }

#endif  // __CUDACC__
