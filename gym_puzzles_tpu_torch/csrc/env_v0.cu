// The v0 env's per-step logic around the engine tick (gym_puzzles_tpu_torch/
// envs/v0.py V0Env._control_plain, envs/base.py PuzzleEnvLogic._finish with
// V0Env._score, and api/vector.py's fast autoreset; wrapper envs/v0_cuda.py)
// as two kernels, one thread per env:
//   1. control:       the agents' velocity and omega rows set from the action,
//                     the block's soft force (1.1^-d along the Chebyshev unit
//                     vector from each agent, summed over the agents), the
//                     torque and the wake mask;
//   2. score_respawn: for every env the distances, the observation, the
//                     reward, done, done_status, blks, t and truncation; and
//                     only where an env is done or truncated, a fresh spawn
//                     from this step's uniforms (drawn for every env by the
//                     wrapper's caller, as the plain autoreset draws them)
//                     written over that env's column: bodies, contacts, the
//                     contact flags, the episode scalars, and the spawn's
//                     observation.  Nothing is written over the other envs'
//                     state.
//
// Replaces no TPU kernel: the JAX package's env logic is XLA's (vmapped jnp in
// gym_puzzles_tpu/envs/v0.py and api/vector.py).  It was added because the
// same work as PyTorch ops ran as ~150 small launches per step, a whole spawn
// and a select of every state tensor among them, on every env at every step,
// though about one env step in 2000 ends an episode: ~0.54 ms per step of
// 4096 v0 envs where its bytes need ~1 us.
//
// What bounds it: launches and bytes.  Per v0 env, control reads ~0.1 kB and
// writes ~0.2 kB, score_respawn reads ~0.1 kB and writes ~0.2 kB, and ~1.6 kB
// more for an env it respawns (mostly the 21 contact pairs' planes).  At 4096
// envs that is ~1.5 MB a step, under 1 us at 3.35 TB/s: each launch costs
// about what a launch costs.  The design:
// * every plane is [rows, E] with the env axis last, so each row is read and
//   written coalesced, one float (or byte) a thread;
// * an env's bodies, distances and observation stay in its thread's
//   registers from the loads to the stores; the world's constants (local
//   centres, walls, the block's vertices, the spawn's bounds) come by value in
//   the launch's parameters, so a CUDA graph captures them as they are;
// * the respawn is a branch that about one env in 2000 takes, so a warp pays
//   for it only on the steps where one of its envs ends;
// * the reward weights are read from the graph's 0-d device views where the
//   wrapper passes them, else taken by value;
// * with tracing on the wrapper passes a device counter of the envs respawned
//   and the env-steps scored (utils/profiling.py RESPAWNS), to which each warp
//   adds once; with tracing off the pointer is null and no atomic runs.
//
// Arithmetic: every operation is the plain version's, in its order, rounded
// where the plain version rounds: products, sums and differences as
// __fmul_rn / __fadd_rn / __fsub_rn (never contracted into an FMA), IEEE
// division and square root, the accurate cosf / sinf / powf, torch.remainder
// as a floored fmodf, torch.maximum's and clamp_min's NaN propagation, and the
// sums over the agents in the order of ATen's CUDA reduction over a leading
// axis (four accumulators, agent i into accumulator i mod 4, then combined in
// order).  So a respawned env's state equals the plain spawn's bit for bit.
//
// Without nvcc the per-env functions compile as host C++ (g++ -x c++
// -ffp-contract=off) with gpt_v0_control_host / gpt_v0_score_respawn_host,
// loops over the envs, which is how the CPU tests hold them against the plain
// version.  The port never runs that build.

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define GPT_FN __device__ __forceinline__
#else
#define GPT_FN static inline
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fsqrt_rn(float a) { return sqrtf(a); }
#endif

#define GPT_V0_THREADS 128    // envs/v0_cuda.py THREADS: envs a block
#define GPT_V0_MAX_BODIES 16  // envs/v0_cuda.py MAX_BODIES
#define GPT_V0_MAX_VERTS 8    // envs/v0_cuda.py MAX_VERTS: the block's observed vertices
#define GPT_V0_WALLS 4        // walls take slots 0-3, the block 4, the agents the rest
// the (agents, bodies) instantiated: MultiRobotPuzzle-v0, MultiRobotPuzzleHeavy-v0
// (envs/v0_cuda.py WORLDS)
#define GPT_V0_WORLDS(X) X(2, 7) X(5, 10)

// The world's constants, the same for every env and step (envs/v0_cuda.py
// Layout mirrors it).  Floats are the plain version's Python constants
// rounded to float32 on the host, as PyTorch rounds them against a float32
// tensor.
struct Layout {
  int P;          // contact pairs
  int n_verts;    // the block's vertices in the observation
  int max_steps;  // the episode limit (gym's TimeLimit)
  float scale;    // V0_SCALE, px per m
  float speed;    // V0_SPEED, m/s per unit of action
  float two_pi;   // torch.remainder's divisor, TWO_PI
  float epsilon;  // V0_EPSILON, px: in place within it
  float ds;       // DS
  float block_reward, final_reward, contact_reward;
  float pow_base;    // the soft force's base, 1.1
  float unit_floor;  // the Chebyshev unit's floor on its divisor
  float lcx[GPT_V0_MAX_BODIES], lcy[GPT_V0_MAX_BODIES];  // local centres of mass
  float wall_x[GPT_V0_WALLS], wall_y[GPT_V0_WALLS];      // wall origins
  float vert_x[GPT_V0_MAX_VERTS], vert_y[GPT_V0_MAX_VERTS];  // block vertices, local
  float goal[3];  // the spawn's goal (x px, y px, angle)
  // the spawn: lo + range * u for the block's x, y and angle, the agents' x, y
  float lo[5], range[5];
};

// reward weights where no device pointer is given: delta_agent, agent_dist,
// delta_block, blk_dist (RewardParams' names, envs/v0_cuda.py WEIGHTS)
struct Weights {
  float v[4];
};

// control's planes ([rows, E] each; envs/v0_cuda.py CONTROL_PTRS)
enum ControlPtr {
  C_ACTION,      // [3A, E] f32 at the strides given
  C_POS,         // [B, 2, E] f32
  C_VEL,         // [B, 2, E] f32
  C_OMEGA,       // [B, E] f32
  C_AGENT_DIST,  // [A, E] f32
  C_VEL_OUT,     // [B, 2, E] f32
  C_OMEGA_OUT,   // [B, E] f32
  C_FORCE,       // [B, 2, E] f32
  C_TORQUE,      // [B, E] f32
  C_WAKE,        // [B, E] bool
  C_NPTRS
};

// score_respawn's planes (envs/v0_cuda.py SCORE_PTRS)
enum ScorePtr {
  // the ticked world
  S_POS,           // [B, 2, E] f32; a respawned env's column is written
  S_ANGLE,         // [B, E] f32; written likewise
  S_GOAL_CONTACT,  // [A, E] bool; cleared where respawned
  // the state before the step
  S_GOAL,        // [3, E] f32
  S_PREV_AGENT_DIST, S_PREV_BLOCK_DISTANCE,  // [A, E], [E] f32
  S_PREV_BLKS, S_PREV_T,                 // [E] int32
  // the reward weights' 0-d device views, or null for Weights' values
  S_WEIGHT_DELTA_AGENT, S_WEIGHT_AGENT_DIST, S_WEIGHT_DELTA_BLOCK, S_WEIGHT_BLK_DIST,
  // the spawn's uniforms: [E] block x, y, angle; [A, 2, E] agents.  Null:
  // respawn off (the state's outputs below are then the info's)
  S_U_BX, S_U_BY, S_U_ANG, S_U_AXY,
  // written for every env
  S_OBS,                         // [obs_dim, E] f32
  S_REWARD,                      // [E] f32
  S_DONE, S_TRUNCATED,               // [E] bool: done | truncated, truncated
  S_INFO_T, S_INFO_STATUS,       // [E] int32: t + 1, done_status before the respawn
  S_AGENT_DIST, S_BLOCK_DISTANCE, S_BLOCK_ANGLE,  // [A, E], [E], [E] f32
  S_BLKS,                        // [E] int32
  S_T, S_STATUS,                 // [E] int32: the state's (0 where respawned)
  S_GOAL_OUT,                    // [3, E] f32: the state's goal
  // written only where respawned
  S_VEL, S_OMEGA, S_AWAKE, S_SLEEP_TIME,  // [B, 2, E] f32, [B, E] f32 / bool / f32
  S_WALL_CONTACT,                    // [E] bool
  S_FLIP,                            // [P, E] bool
  S_LOCAL_NORMAL, S_LOCAL_POINT,     // [P, 2, E] f32
  S_POINTS,                          // [P, 2, 2, E] f32
  S_IDS,                             // [P, 2, E] int32
  S_COUNT,                           // [P, E] int32
  S_NORMAL_IMPULSE, S_TANGENT_IMPULSE,  // [P, 2, E] f32
  S_TOUCHING,                        // [P, E] bool
  // int64 [2]: envs respawned, env-steps scored (null: not counted)
  S_COUNTS,
  S_NPTRS
};

struct ControlPtrs {
  void* p[C_NPTRS];
};

struct ScorePtrs {
  void* p[S_NPTRS];
};

#define F32(P, i) ((float*)(P).p[i])
#define I32(P, i) ((int32_t*)(P).p[i])
#define U8(P, i) ((uint8_t*)(P).p[i])

// torch.remainder: fmod, moved into the divisor's sign
GPT_FN float floor_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m = __fadd_rn(m, b);
  return m;
}

// torch.maximum (NaN propagates)
GPT_FN float maximum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// torch.clamp_min with a scalar (NaN propagates)
GPT_FN float clamp_min(float a, float lo) { return (a != a) ? a : (a < lo ? lo : a); }

// common.distance of one (dx, dy)
GPT_FN float norm2(float dx, float dy) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
}

// sum over the agents' axis, in ATen's CUDA reduction order
template <int A>
GPT_FN float sum_agents(const float* v) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int a = 0; a < A; ++a) acc[a % 4] = __fadd_rn(acc[a % 4], v[a]);
  return __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
}

// V0Env._distances: each agent's distance to the block, the block's to the
// goal (px), and |remainder(goal angle) - remainder(|block angle|)|
template <int A>
GPT_FN void distances(const Layout& L, float bcx, float bcy, float bang, const float* acx,
                      const float* acy, float gx, float gy, float gang, float* ad, float& bd,
                      float& bangle) {
  const float s = L.scale;
  const float x = __fmul_rn(bcx, s), y = __fmul_rn(bcy, s);
  bd = norm2(__fsub_rn(x, gx), __fsub_rn(y, gy));
  bangle = fabsf(__fsub_rn(floor_mod(gang, L.two_pi), floor_mod(fabsf(bang), L.two_pi)));
#pragma unroll
  for (int a = 0; a < A; ++a)
    ad[a] = norm2(__fsub_rn(__fmul_rn(acx[a], s), x), __fsub_rn(__fmul_rn(acy[a], s), y));
}

// V0Env._score's observation, written to column e of obs [obs_dim, E]
template <int A>
GPT_FN void observe(const Layout& L, int blk, float bcx, float bcy, float bang, const float* acx,
                    const float* acy, const float* ad, const bool* contact, float gx, float gy,
                    float gang, float* obs, long long E, long long e) {
  const float s = L.scale;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    obs[(4 * a + 0) * E + e] = __fmul_rn(__fsub_rn(acx[a], bcx), s);
    obs[(4 * a + 1) * E + e] = __fmul_rn(__fsub_rn(acy[a], bcy), s);
    obs[(4 * a + 2) * E + e] = ad[a];
    obs[(4 * a + 3) * E + e] = contact[a] ? 1.0f : 0.0f;
  }
  const float x = __fmul_rn(bcx, s), y = __fmul_rn(bcy, s);
  const float dx = __fsub_rn(x, gx), dy = __fsub_rn(y, gy);
  float* o = obs + (long long)(4 * A) * E + e;
  o[0] = dx;
  o[E] = dy;
  o[2 * E] = __fsub_rn(floor_mod(gang, L.two_pi), floor_mod(bang, L.two_pi));
  o[3 * E] = norm2(dx, dy);
  // common.block_world_vertices: the block's origin from its centre of mass,
  // then each vertex rotated and moved there
  const float c = cosf(bang), sn = sinf(bang);
  const float lx = L.lcx[blk], ly = L.lcy[blk];
  const float ox = __fsub_rn(bcx, __fsub_rn(__fmul_rn(c, lx), __fmul_rn(sn, ly)));
  const float oy = __fsub_rn(bcy, __fadd_rn(__fmul_rn(sn, lx), __fmul_rn(c, ly)));
  o += 4 * E;
  for (int v = 0; v < L.n_verts; ++v) {
    const float vx = L.vert_x[v], vy = L.vert_y[v];
    const float wx = __fadd_rn(__fsub_rn(__fmul_rn(c, vx), __fmul_rn(sn, vy)), ox);
    const float wy = __fadd_rn(__fadd_rn(__fmul_rn(sn, vx), __fmul_rn(c, vy)), oy);
    o[(2 * v) * E] = __fmul_rn(wx, s);
    o[(2 * v + 1) * E] = __fmul_rn(wy, s);
  }
}

// control for env e: V0Env._control_plain
template <int A, int B>
GPT_FN void control_env(const Layout& L, const ControlPtrs& P, long long E, long long row,
                        long long col, long long e) {
  constexpr int a0 = B - A, blk = a0 - 1;
  const float* act = F32(P, C_ACTION);
  const float* pos = F32(P, C_POS);
  const float* vel = F32(P, C_VEL);
  const float* omega = F32(P, C_OMEGA);
  const float* dist = F32(P, C_AGENT_DIST);
  float* vel_out = F32(P, C_VEL_OUT);
  float* omega_out = F32(P, C_OMEGA_OUT);
  float* force = F32(P, C_FORCE);
  float* torque = F32(P, C_TORQUE);
  uint8_t* wake = U8(P, C_WAKE);
  // the walls and the block keep their velocities; none of them is commanded
  for (int b = 0; b < a0; ++b) {
    vel_out[(2 * b) * E + e] = vel[(2 * b) * E + e];
    vel_out[(2 * b + 1) * E + e] = vel[(2 * b + 1) * E + e];
    omega_out[b * E + e] = omega[b * E + e];
    force[(2 * b) * E + e] = 0.0f;
    force[(2 * b + 1) * E + e] = 0.0f;
    torque[b * E + e] = 0.0f;
    wake[b * E + e] = b == blk;  // ApplyForce(wake=True) always wakes the block
  }
  const float bcx = pos[(2 * blk) * E + e], bcy = pos[(2 * blk + 1) * E + e];
  float fx[A], fy[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int b = a0 + a;
    const float vx = __fmul_rn(act[(3 * a) * row + e * col], L.speed);
    const float vy = __fmul_rn(act[(3 * a + 1) * row + e * col], L.speed);
    const float w = act[(3 * a + 2) * row + e * col];
    vel_out[(2 * b) * E + e] = vx;
    vel_out[(2 * b + 1) * E + e] = vy;
    omega_out[b * E + e] = w;
    force[(2 * b) * E + e] = 0.0f;
    force[(2 * b + 1) * E + e] = 0.0f;
    torque[b * E + e] = 0.0f;
    wake[b * E + e] =
        (__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)) > 0.0f) | (__fmul_rn(w, w) > 0.0f);
    // 1.1^(-agent_dist) along the Chebyshev unit vector agent -> block
    const float mag = powf(L.pow_base, -dist[a * E + e]);
    const float dx = __fsub_rn(bcx, pos[(2 * b) * E + e]);
    const float dy = __fsub_rn(bcy, pos[(2 * b + 1) * E + e]);
    const float denom = clamp_min(maximum(fabsf(dx), fabsf(dy)), L.unit_floor);
    fx[a] = __fmul_rn(mag, __fdiv_rn(dx, denom));
    fy[a] = __fmul_rn(mag, __fdiv_rn(dy, denom));
  }
  force[(2 * blk) * E + e] = sum_agents<A>(fx);
  force[(2 * blk + 1) * E + e] = sum_agents<A>(fy);
}

// score_respawn for env e; returns whether the env was respawned
template <int A, int B>
GPT_FN bool score_env(const Layout& L, const ScorePtrs& P, const Weights& W, long long E,
                      long long e) {
  constexpr int a0 = B - A, blk = a0 - 1;
  float* pos = F32(P, S_POS);
  float* angle = F32(P, S_ANGLE);
  uint8_t* gc = U8(P, S_GOAL_CONTACT);
  const float* goal = F32(P, S_GOAL);
  const float* prev_ad = F32(P, S_PREV_AGENT_DIST);

  // the ticked world
  const float bcx = pos[(2 * blk) * E + e], bcy = pos[(2 * blk + 1) * E + e];
  const float bang = angle[blk * E + e];
  float acx[A], acy[A];
  bool contact[A];
  int n_contact = 0;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    acx[a] = pos[(2 * (a0 + a)) * E + e];
    acy[a] = pos[(2 * (a0 + a) + 1) * E + e];
    contact[a] = gc[a * E + e] != 0;
    n_contact += contact[a];
  }
  const float gx = goal[e], gy = goal[E + e], gang = goal[2 * E + e];
  float ad[A], bd, bangle;
  distances<A>(L, bcx, bcy, bang, acx, acy, gx, gy, gang, ad, bd, bangle);
  float* obs = F32(P, S_OBS);
  observe<A>(L, blk, bcx, bcy, bang, acx, acy, ad, contact, gx, gy, gang, obs, E, e);

  // the reward (V0Env._score, in its order)
  const float* wp[4] = {F32(P, S_WEIGHT_DELTA_AGENT), F32(P, S_WEIGHT_AGENT_DIST),
                        F32(P, S_WEIGHT_DELTA_BLOCK), F32(P, S_WEIGHT_BLK_DIST)};
  float w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = wp[i] != nullptr ? *wp[i] : W.v[i];
  const float x = __fmul_rn(bcx, L.scale), y = __fmul_rn(bcy, L.scale);
  const bool in_place = fabsf(__fsub_rn(gx, x)) <= L.epsilon && fabsf(__fsub_rn(gy, y)) <= L.epsilon;
  const int blks = in_place ? 1 : 0;
  const bool done = blks == 1;
  float r = __fdiv_rn(__fmul_rn(__fmul_rn(__fsub_rn(F32(P, S_PREV_BLOCK_DISTANCE)[e], bd), w[2]),
                                L.ds), 4.0f);
  r = __fsub_rn(r, __fdiv_rn(__fmul_rn(__fmul_rn(w[3], bd), L.ds), 4.0f));
  float terms[A];
#pragma unroll
  for (int a = 0; a < A; ++a)
    terms[a] = __fdiv_rn(__fmul_rn(__fmul_rn(__fsub_rn(prev_ad[a * E + e], ad[a]), w[0]), L.ds),
                         4.0f);
  r = __fadd_rn(r, sum_agents<A>(terms));
#pragma unroll
  for (int a = 0; a < A; ++a) terms[a] = __fdiv_rn(__fmul_rn(__fmul_rn(w[1], ad[a]), L.ds), 4.0f);
  r = __fsub_rn(r, sum_agents<A>(terms));
  r = __fadd_rn(r, __fmul_rn((float)n_contact, L.contact_reward));
  r = __fadd_rn(r, __fmul_rn((float)(blks - I32(P, S_PREV_BLKS)[e]), L.block_reward));
  r = __fadd_rn(r, done ? L.final_reward : 0.0f);
  const int status = done ? 3 : 0;
  const int t = I32(P, S_PREV_T)[e] + 1;
  const bool truncated = t >= L.max_steps;
  F32(P, S_REWARD)[e] = r;
  U8(P, S_DONE)[e] = done | truncated;
  U8(P, S_TRUNCATED)[e] = truncated;
  I32(P, S_INFO_T)[e] = t;
  I32(P, S_INFO_STATUS)[e] = status;

  const bool respawn = P.p[S_U_BX] != nullptr && (done || truncated);
  if (respawn) {
    // V0Env._spawn_from: walls at their origins, the block and the agents
    // where the uniforms put them, every angle but the block's 0
    float ox[B], oy[B], an[B];
#pragma unroll
    for (int b = 0; b < B; ++b) an[b] = 0.0f;
#pragma unroll
    for (int b = 0; b < GPT_V0_WALLS; ++b) {
      ox[b] = L.wall_x[b];
      oy[b] = L.wall_y[b];
    }
    ox[blk] = __fadd_rn(L.lo[0], __fmul_rn(L.range[0], F32(P, S_U_BX)[e]));
    oy[blk] = __fadd_rn(L.lo[1], __fmul_rn(L.range[1], F32(P, S_U_BY)[e]));
    an[blk] = __fadd_rn(L.lo[2], __fmul_rn(L.range[2], F32(P, S_U_ANG)[e]));
    const float* u = F32(P, S_U_AXY);
#pragma unroll
    for (int a = 0; a < A; ++a) {
      ox[a0 + a] = __fadd_rn(L.lo[3], __fmul_rn(L.range[3], u[(2 * a) * E + e]));
      oy[a0 + a] = __fadd_rn(L.lo[4], __fmul_rn(L.range[4], u[(2 * a + 1) * E + e]));
    }
    // world.init_bodies: centres of mass from the origins, at rest, awake
    float* vel = F32(P, S_VEL);
    float* omega = F32(P, S_OMEGA);
    uint8_t* awake = U8(P, S_AWAKE);
    float* sleep = F32(P, S_SLEEP_TIME);
    float cx[B], cy[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const float c = cosf(an[b]), sn = sinf(an[b]);
      cx[b] = __fadd_rn(ox[b], __fsub_rn(__fmul_rn(c, L.lcx[b]), __fmul_rn(sn, L.lcy[b])));
      cy[b] = __fadd_rn(oy[b], __fadd_rn(__fmul_rn(sn, L.lcx[b]), __fmul_rn(c, L.lcy[b])));
      pos[(2 * b) * E + e] = cx[b];
      pos[(2 * b + 1) * E + e] = cy[b];
      angle[b * E + e] = an[b];
      vel[(2 * b) * E + e] = 0.0f;
      vel[(2 * b + 1) * E + e] = 0.0f;
      omega[b * E + e] = 0.0f;
      awake[b * E + e] = 1;
      sleep[b * E + e] = 0.0f;
    }
    // world.init_contacts: no manifold, no impulse, not touching
    for (int p = 0; p < L.P; ++p) {
      U8(P, S_FLIP)[p * E + e] = 0;
      I32(P, S_COUNT)[p * E + e] = 0;
      U8(P, S_TOUCHING)[p * E + e] = 0;
      for (int k = 0; k < 2; ++k) {
        const long long i = (2 * p + k) * E + e;
        F32(P, S_LOCAL_NORMAL)[i] = 0.0f;
        F32(P, S_LOCAL_POINT)[i] = 0.0f;
        F32(P, S_NORMAL_IMPULSE)[i] = 0.0f;
        F32(P, S_TANGENT_IMPULSE)[i] = 0.0f;
        I32(P, S_IDS)[i] = -1;
        F32(P, S_POINTS)[(4 * p + 2 * k) * E + e] = 0.0f;
        F32(P, S_POINTS)[(4 * p + 2 * k + 1) * E + e] = 0.0f;
      }
    }
    // PuzzleEnvLogic.state_from_bodies: flags off, distances to the goal,
    // then observe's observation of that state over the ticked one
#pragma unroll
    for (int a = 0; a < A; ++a) {
      gc[a * E + e] = 0;
      acx[a] = cx[a0 + a];
      acy[a] = cy[a0 + a];
      contact[a] = false;
    }
    U8(P, S_WALL_CONTACT)[e] = 0;
    distances<A>(L, cx[blk], cy[blk], an[blk], acx, acy, L.goal[0], L.goal[1], L.goal[2], ad, bd,
                 bangle);
    observe<A>(L, blk, cx[blk], cy[blk], an[blk], acx, acy, ad, contact, L.goal[0], L.goal[1],
               L.goal[2], obs, E, e);
  }

  float* dist = F32(P, S_AGENT_DIST);
#pragma unroll
  for (int a = 0; a < A; ++a) dist[a * E + e] = ad[a];
  F32(P, S_BLOCK_DISTANCE)[e] = bd;
  F32(P, S_BLOCK_ANGLE)[e] = bangle;
  I32(P, S_BLKS)[e] = respawn ? 0 : blks;
  if (P.p[S_U_BX] != nullptr) {
    I32(P, S_T)[e] = respawn ? 0 : t;
    I32(P, S_STATUS)[e] = respawn ? 0 : status;
    float* goal_out = F32(P, S_GOAL_OUT);
    goal_out[e] = respawn ? L.goal[0] : gx;
    goal_out[E + e] = respawn ? L.goal[1] : gy;
    goal_out[2 * E + e] = respawn ? L.goal[2] : gang;
  }
  return respawn;
}

// the constants the wrapper must share: GPT_V0_THREADS, GPT_V0_MAX_BODIES,
// GPT_V0_MAX_VERTS, sizeof(Layout), sizeof(Weights), C_NPTRS, S_NPTRS, the
// number of worlds, then each world's (agents, bodies).  Returns the count
// written (at most 16).
extern "C" int gpt_v0_constants(int* out) {
  int n = 0;
  out[n++] = GPT_V0_THREADS;
  out[n++] = GPT_V0_MAX_BODIES;
  out[n++] = GPT_V0_MAX_VERTS;
  out[n++] = (int)sizeof(Layout);
  out[n++] = (int)sizeof(Weights);
  out[n++] = C_NPTRS;
  out[n++] = S_NPTRS;
  int* worlds = out + n++;
  *worlds = 0;
#define GPT_V0_WORLD(a, b) \
  out[n++] = a;            \
  out[n++] = b;            \
  ++*worlds;
  GPT_V0_WORLDS(GPT_V0_WORLD)
#undef GPT_V0_WORLD
  return n;
}

#ifdef __CUDACC__

template <int A, int B>
__global__ void __launch_bounds__(GPT_V0_THREADS)
    gpt_v0_control_kernel(Layout L, ControlPtrs P, long long E, long long row, long long col) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < E) control_env<A, B>(L, P, E, row, col, e);
}

template <int A, int B>
__global__ void __launch_bounds__(GPT_V0_THREADS)
    gpt_v0_score_respawn_kernel(Layout L, ScorePtrs P, Weights W, long long E) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = e < E;
  bool respawned = false;
  if (live) respawned = score_env<A, B>(L, P, W, E, e);
  unsigned long long* counts = (unsigned long long*)P.p[S_COUNTS];
  if (counts != nullptr) {  // the same for every thread: the whole warp is here
    const unsigned resets = __ballot_sync(0xffffffffu, respawned);
    const unsigned lives = __ballot_sync(0xffffffffu, live);
    if ((threadIdx.x & 31) == 0 && lives != 0u) {
      if (resets != 0u) atomicAdd(counts, (unsigned long long)__popc(resets));
      atomicAdd(counts + 1, (unsigned long long)__popc(lives));
    }
  }
}

// dims: E, then the action's row and env strides (elements).  Returns
// cudaGetLastError() after the launch, or -1 for a world not instantiated.
extern "C" int gpt_v0_control(int A, int B, const Layout* L, void* const* ptrs,
                              const long long* dims, void* stream) {
  ControlPtrs P;
  memcpy(P.p, ptrs, sizeof(P.p));
  const long long E = dims[0];
  const unsigned grid = (unsigned)((E + GPT_V0_THREADS - 1) / GPT_V0_THREADS);
#define GPT_V0_LAUNCH(a, b)                                                             \
  if (A == a && B == b) {                                                               \
    if (E > 0)                                                                          \
      gpt_v0_control_kernel<a, b><<<grid, GPT_V0_THREADS, 0, (cudaStream_t)stream>>>(  \
          *L, P, E, dims[1], dims[2]);                                                  \
    return (int)cudaGetLastError();                                                     \
  }
  GPT_V0_WORLDS(GPT_V0_LAUNCH)
#undef GPT_V0_LAUNCH
  return -1;
}

// dims: E.  weights: Weights' values.  Returns as gpt_v0_control.
extern "C" int gpt_v0_score_respawn(int A, int B, const Layout* L, void* const* ptrs,
                                    const long long* dims, const float* weights, void* stream) {
  ScorePtrs P;
  memcpy(P.p, ptrs, sizeof(P.p));
  Weights W;
  memcpy(W.v, weights, sizeof(W.v));
  const long long E = dims[0];
  const unsigned grid = (unsigned)((E + GPT_V0_THREADS - 1) / GPT_V0_THREADS);
#define GPT_V0_LAUNCH(a, b)                                                                   \
  if (A == a && B == b) {                                                                     \
    if (E > 0)                                                                                \
      gpt_v0_score_respawn_kernel<a, b><<<grid, GPT_V0_THREADS, 0, (cudaStream_t)stream>>>(  \
          *L, P, W, E);                                                                       \
    return (int)cudaGetLastError();                                                           \
  }
  GPT_V0_WORLDS(GPT_V0_LAUNCH)
#undef GPT_V0_LAUNCH
  return -1;
}

#else

// The host build: the same per-env functions over every env in turn.
extern "C" int gpt_v0_control_host(int A, int B, const Layout* L, void* const* ptrs,
                                   const long long* dims) {
  ControlPtrs P;
  memcpy(P.p, ptrs, sizeof(P.p));
#define GPT_V0_RUN(a, b)                                                             \
  if (A == a && B == b) {                                                            \
    for (long long e = 0; e < dims[0]; ++e) control_env<a, b>(*L, P, dims[0], dims[1], dims[2], e); \
    return 0;                                                                        \
  }
  GPT_V0_WORLDS(GPT_V0_RUN)
#undef GPT_V0_RUN
  return -1;
}

extern "C" int gpt_v0_score_respawn_host(int A, int B, const Layout* L, void* const* ptrs,
                                         const long long* dims, const float* weights) {
  ScorePtrs P;
  memcpy(P.p, ptrs, sizeof(P.p));
  Weights W;
  memcpy(W.v, weights, sizeof(W.v));
  long long* counts = (long long*)P.p[S_COUNTS];
#define GPT_V0_RUN(a, b)                                                \
  if (A == a && B == b) {                                               \
    for (long long e = 0; e < dims[0]; ++e) {                           \
      const bool respawned = score_env<a, b>(*L, P, W, dims[0], e);     \
      if (counts != nullptr) {                                          \
        counts[0] += respawned;                                         \
        counts[1] += 1;                                                 \
      }                                                                 \
    }                                                                   \
    return 0;                                                           \
  }
  GPT_V0_WORLDS(GPT_V0_RUN)
#undef GPT_V0_RUN
  return -1;
}

#endif
