// The learner's per-minibatch optimizer step (gym_puzzles_tpu_torch/train/ppo.py
// adam_freeze_step; wrapper train/adam_fused.py) as one pair of kernels:
//   1. global-norm clip of the gradients to max_grad_norm;
//   2. optax's scale_by_adam (b1, b2, eps added after the square root, the
//      bias corrections 1 - b ** count from a float64 power rounded once to
//      float32) and a -lr step;
//   3. the target-KL freeze: a minibatch after the stop leaves params, both
//      moments and the count as they were;
//   4. the stop and the last applied minibatch's KL.
//
// Replaces no TPU kernel: Adam is XLA's in the JAX package.  It was added
// because the same step as PyTorch ops (ppo.py adam_freeze_plain) ran as some
// 60-90 launches of ~3 us per minibatch, ~250 us where the bytes need ~1 us.
//
// What bounds it: bytes.  Per parameter, 7 float32 words: p, g, mu, nu read
// once, p', mu', nu' written once (g is read a second time, for the norm).
// The v0 MLP's 75k parameters are 2.1 MB (0.6 us at 3.35 TB/s, mostly in L2),
// so there the launches are the cost; the pixel CNN's 21.6M are 604 MB
// (0.18 ms), so there the bandwidth is.  The design:
// * multi-tensor, no change of layout: the leaves' pointers and sizes go by
//   value in the kernels' arguments (a CUDA graph captures them as they are);
//   the work is the leaves' quads (4 consecutive elements of a leaf, in leaf
//   order), each read in row-major order as a float4 where the leaf's seven
//   pointers are 16-byte aligned, a leaf's ragged tail one float at a time;
// * kernel 1 writes one float64 sum of squares per block, each block over a
//   fixed share of the quads, and the bias corrections (two float64 powers,
//   one lane of one warp, while the others wait on their loads); kernel 2's
//   threads load their first quad, then each block reduces all the partials
//   in the same fixed order while those loads are in flight (no atomics: the
//   norm is the same bits on every launch), forms the clip and applies the
//   step elementwise; one thread writes count', stop' and kl_last' out of
//   place, so that no block reads a stop another block has written;
// * the grid follows the element count (train/adam_fused.py grids): one quad
//   a thread up to as many blocks as the SMs hold at once
//   (gpt_adam_occupancy), so a few dozen blocks at v0, each thread one round
//   of loads, and every SM full at the CNN, grid-striding;
// * each elementwise operation is the rounded intrinsic in adam_update's
//   order, so that no FMA contraction changes a bit: with the clip inactive
//   the step equals the plain version's bit for bit; the norm's order of
//   summation is the only difference.
//
// Without nvcc the elementwise functions compile as host C++ (g++ -x c++
// -ffp-contract=off) with gpt_adam_fused_host, which is how the CPU tests hold
// their arithmetic against the plain version.  The port never runs that build.

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#define __device__
#define __forceinline__ inline
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fsqrt_rn(float a) { return sqrtf(a); }
#endif

#define GPT_ADAM_MAX_LEAVES 32    // train/adam_fused.py MAX_LEAVES
#define GPT_ADAM_NORM_THREADS 512  // train/adam_fused.py NORM_THREADS
#define GPT_ADAM_STEP_THREADS 256  // train/adam_fused.py STEP_THREADS
#define GPT_ADAM_PTRS 7            // per leaf: p, g, mu, nu in; p', mu', nu' out

struct Leaves {
  const float* p[GPT_ADAM_MAX_LEAVES];
  const float* g[GPT_ADAM_MAX_LEAVES];
  const float* m[GPT_ADAM_MAX_LEAVES];
  const float* v[GPT_ADAM_MAX_LEAVES];
  float* p_out[GPT_ADAM_MAX_LEAVES];
  float* m_out[GPT_ADAM_MAX_LEAVES];
  float* v_out[GPT_ADAM_MAX_LEAVES];
  long long n[GPT_ADAM_MAX_LEAVES];
  long long q0[GPT_ADAM_MAX_LEAVES + 1];  // leaf k's quads (4 elements) are q0[k] .. q0[k + 1] - 1
  int vec[GPT_ADAM_MAX_LEAVES];  // 1: all seven pointers 16-byte aligned
  int count;
};

// 0-d tensors on the card: read and written there, never on the host
struct Scalars {
  const float* lr;
  const float* max_norm;
  const float* target_kl;
  const int* count;
  const unsigned char* stop;  // torch.bool
  const float* kl;
  const float* kl_last;
  int* count_out;
  unsigned char* stop_out;
  float* kl_last_out;
};

// the plain version's Python constants, rounded to float32 on the host as
// PyTorch rounds them against a float32 tensor; the decays as float64 values
// of their float32 roundings (ppo.py _ADAM_DECAYS)
struct Consts {
  float c1, b1, c2, b2, eps, norm_eps, kl_factor;
  double b1d, b2d;
};

struct Step {
  float clip, bc1, bc2, neg_lr;
  int use;
};

// optax's bias corrections at count + 1 (ppo.py bias_corrections)
__device__ __forceinline__ void bias_corrections(const Scalars& s, const Consts& k, float& bc1,
                                                 float& bc2) {
  const double t = (double)(*s.count + 1);
  bc1 = __fsub_rn(1.0f, (float)pow(k.b1d, t));
  bc2 = __fsub_rn(1.0f, (float)pow(k.b2d, t));
}

// the clip and the frozen flag from the sum of squares, with the bias corrections
__device__ __forceinline__ Step step_of(double sumsq, float bc1, float bc2, const Scalars& s,
                                        const Consts& k) {
  Step c;
  const float norm = (float)sqrt(sumsq);
  const float clip = __fdiv_rn(*s.max_norm, __fadd_rn(norm, k.norm_eps));
  c.clip = clip > 1.0f ? 1.0f : clip;  // torch.clamp(max=1.0): NaN stays NaN
  c.bc1 = bc1;
  c.bc2 = bc2;
  c.neg_lr = -*s.lr;
  c.use = *s.stop == 0;
  return c;
}

// one element of adam_step: the clip, then adam_update's operations in order
__device__ __forceinline__ void adam_elem(float p, float g, float m, float v, const Step& c,
                                          const Consts& k, float& p_out, float& m_out,
                                          float& v_out) {
  const float gc = __fmul_rn(g, c.clip);
  m_out = __fadd_rn(__fmul_rn(gc, k.c1), __fmul_rn(m, k.b1));
  v_out = __fadd_rn(__fmul_rn(__fmul_rn(gc, gc), k.c2), __fmul_rn(v, k.b2));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v_out, c.bc2)), k.eps);
  const float step = __fdiv_rn(__fdiv_rn(m_out, c.bc1), denom);
  p_out = __fadd_rn(p, __fmul_rn(step, c.neg_lr));
}

// count', stop' and kl_last' (the freeze's scalars), out of place
__device__ __forceinline__ void write_scalars(const Step& c, const Scalars& s, const Consts& k) {
  const float kl = *s.kl, target = *s.target_kl;
  const bool fires = target > 0.0f && kl > __fmul_rn(k.kl_factor, target);
  *s.count_out = c.use ? *s.count + 1 : *s.count;
  *s.stop_out = (unsigned char)(!c.use || fires);
  *s.kl_last_out = c.use ? kl : *s.kl_last;
}

static int fill(int leaves, const long long* n, void* const* ptrs, void* const* scalars,
                const float* consts, const double* decays, Leaves* L, Scalars* s, Consts* k) {
  if (leaves < 1 || leaves > GPT_ADAM_MAX_LEAVES) return 0;
  L->count = leaves;
  L->q0[0] = 0;
  for (int i = 0; i < leaves; ++i) {
    void* const* q = ptrs + GPT_ADAM_PTRS * i;
    uintptr_t any = 0;
    for (int j = 0; j < GPT_ADAM_PTRS; ++j) any |= (uintptr_t)q[j];
    L->p[i] = (const float*)q[0];
    L->g[i] = (const float*)q[1];
    L->m[i] = (const float*)q[2];
    L->v[i] = (const float*)q[3];
    L->p_out[i] = (float*)q[4];
    L->m_out[i] = (float*)q[5];
    L->v_out[i] = (float*)q[6];
    L->n[i] = n[i];
    L->q0[i + 1] = L->q0[i] + (n[i] + 3) / 4;
    L->vec[i] = (any & 15) == 0;
  }
  s->lr = (const float*)scalars[0];
  s->max_norm = (const float*)scalars[1];
  s->target_kl = (const float*)scalars[2];
  s->count = (const int*)scalars[3];
  s->stop = (const unsigned char*)scalars[4];
  s->kl = (const float*)scalars[5];
  s->kl_last = (const float*)scalars[6];
  s->count_out = (int*)scalars[7];
  s->stop_out = (unsigned char*)scalars[8];
  s->kl_last_out = (float*)scalars[9];
  k->c1 = consts[0];
  k->b1 = consts[1];
  k->c2 = consts[2];
  k->b2 = consts[3];
  k->eps = consts[4];
  k->norm_eps = consts[5];
  k->kl_factor = consts[6];
  k->b1d = decays[0];
  k->b2d = decays[1];
  return 1;
}

#ifdef __CUDACC__

// One quad: four consecutive elements of a leaf, from element e = 4 * (q -
// q0[k]) of leaf k; a float4 where the leaf is aligned and the quad whole,
// else element by element (a leaf's tail, zeros past its end).
__device__ __forceinline__ float load1(const float* x, long long i, long long n) {
  return i < n ? __ldg(x + i) : 0.0f;
}

__device__ __forceinline__ float4 load4(const float* x, long long e, long long n, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(x + e));
  return make_float4(load1(x, e, n), load1(x, e + 1, n), load1(x, e + 2, n), load1(x, e + 3, n));
}

__device__ __forceinline__ void store4(float* x, long long e, long long n, bool vec, float4 a) {
  if (vec) {
    *reinterpret_cast<float4*>(x + e) = a;
    return;
  }
  if (e < n) x[e] = a.x;
  if (e + 1 < n) x[e + 1] = a.y;
  if (e + 2 < n) x[e + 2] = a.z;
  if (e + 3 < n) x[e + 3] = a.w;
}

struct Quad {
  float4 p, g, m, v;
  long long e;
  int leaf;
  bool vec;
};

// the leaf of quad q, from the leaf of an earlier quad (quads run in leaf order)
__device__ __forceinline__ void locate(const Leaves& L, long long q, Quad& d) {
  while (q >= L.q0[d.leaf + 1]) ++d.leaf;
  d.e = 4 * (q - L.q0[d.leaf]);
  d.vec = L.vec[d.leaf] && d.e + 4 <= L.n[d.leaf];
}

// the block's sum, in thread 0, in a fixed order (warp shuffles, then the
// warps' sums); blockDim.x == THREADS
template <int THREADS>
__device__ __forceinline__ double block_sum(double x, double* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  x = threadIdx.x < THREADS / 32 ? warp_sums[threadIdx.x] : 0.0;
  if (warp == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

// kernel 1: one partial sum of squares of the gradients per block into
// scratch[block]; and, in one lane of block 0's last warp while the other
// warps wait on their loads, the bias corrections into scratch[gridDim.x + 0, 1]
__global__ void __launch_bounds__(GPT_ADAM_NORM_THREADS)
    gpt_adam_norm_kernel(const Leaves L, const Scalars s, const Consts k,
                         double* __restrict__ scratch) {
  __shared__ double warp_sums[GPT_ADAM_NORM_THREADS / 32];
  if (blockIdx.x == 0 && threadIdx.x == GPT_ADAM_NORM_THREADS - 32) {
    float bc1, bc2;
    bias_corrections(s, k, bc1, bc2);
    scratch[gridDim.x] = bc1;
    scratch[gridDim.x + 1] = bc2;
  }
  const long long Q = L.q0[L.count];
  const long long T = (long long)gridDim.x * blockDim.x;
  Quad d;
  d.leaf = 0;
  double acc = 0.0;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < Q; q += T) {
    locate(L, q, d);
    const float4 g = load4(L.g[d.leaf], d.e, L.n[d.leaf], d.vec);
    acc += (double)g.x * g.x;
    acc += (double)g.y * g.y;
    acc += (double)g.z * g.z;
    acc += (double)g.w * g.w;
  }
  acc = block_sum<GPT_ADAM_NORM_THREADS>(acc, warp_sums);
  if (threadIdx.x == 0) scratch[blockIdx.x] = acc;
}

__device__ __forceinline__ void load_quad(const Leaves& L, Quad& d) {
  const int j = d.leaf;
  const long long n = L.n[j];
  d.p = load4(L.p[j], d.e, n, d.vec);
  d.g = load4(L.g[j], d.e, n, d.vec);
  d.m = load4(L.m[j], d.e, n, d.vec);
  d.v = load4(L.v[j], d.e, n, d.vec);
}

__device__ __forceinline__ void step_quad(const Leaves& L, const Quad& d, const Step& c,
                                          const Consts& k) {
  const int j = d.leaf;
  const long long n = L.n[j];
  float4 p = d.p, m = d.m, v = d.v;  // frozen: every input bit as it was
  if (c.use) {
    adam_elem(d.p.x, d.g.x, d.m.x, d.v.x, c, k, p.x, m.x, v.x);
    adam_elem(d.p.y, d.g.y, d.m.y, d.v.y, c, k, p.y, m.y, v.y);
    adam_elem(d.p.z, d.g.z, d.m.z, d.v.z, c, k, p.z, m.z, v.z);
    adam_elem(d.p.w, d.g.w, d.m.w, d.v.w, c, k, p.w, m.w, v.w);
  }
  store4(L.p_out[j], d.e, n, d.vec, p);
  store4(L.m_out[j], d.e, n, d.vec, m);
  store4(L.v_out[j], d.e, n, d.vec, v);
}

// kernel 2: each thread's first quad loaded, then the norm from kernel 1's
// partials while those loads are in flight; then clip, Adam and the freeze
__global__ void __launch_bounds__(GPT_ADAM_STEP_THREADS)
    gpt_adam_step_kernel(const Leaves L, const Scalars s, const Consts k,
                         const double* __restrict__ scratch, int n_partials) {
  __shared__ double warp_sums[GPT_ADAM_STEP_THREADS / 32];
  __shared__ Step shared;
  const long long Q = L.q0[L.count];
  const long long T = (long long)gridDim.x * blockDim.x;
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  Quad d;
  d.leaf = 0;
  if (q < Q) {
    locate(L, q, d);
    load_quad(L, d);
  }
  double x = 0.0;
  for (int i = threadIdx.x; i < n_partials; i += GPT_ADAM_STEP_THREADS) x += scratch[i];
  x = block_sum<GPT_ADAM_STEP_THREADS>(x, warp_sums);
  if (threadIdx.x == 0) {
    shared = step_of(x, (float)scratch[n_partials], (float)scratch[n_partials + 1], s, k);
    if (blockIdx.x == 0) write_scalars(shared, s, k);
  }
  __syncthreads();
  const Step c = shared;
  while (q < Q) {
    step_quad(L, d, c, k);
    q += T;
    if (q < Q) {
      locate(L, q, d);
      load_quad(L, d);
    }
  }
}

// Blocks of each kernel that one SM holds at once: [0] kernel 1, [1] kernel 2.
extern "C" int gpt_adam_occupancy(int* per_sm) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, gpt_adam_norm_kernel, GPT_ADAM_NORM_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm + 1, gpt_adam_step_kernel, GPT_ADAM_STEP_THREADS, 0);
}

// ptrs: GPT_ADAM_PTRS per leaf; scalars: lr, max_norm, target_kl, count,
// stop, kl, kl_last in, count', stop', kl_last' out; scratch: norm_blocks + 2
// float64.  Returns cudaGetLastError() after the first launch that fails, or
// after both.
extern "C" int gpt_adam_fused(int leaves, const long long* n, void* const* ptrs,
                              void* const* scalars, const float* consts, const double* decays,
                              void* scratch, int norm_blocks, int step_blocks, void* stream) {
  Leaves L;
  Scalars s;
  Consts k;
  if (!fill(leaves, n, ptrs, scalars, consts, decays, &L, &s, &k) || norm_blocks < 1 ||
      step_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  gpt_adam_norm_kernel<<<norm_blocks, GPT_ADAM_NORM_THREADS, 0, st>>>(L, s, k, (double*)scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gpt_adam_step_kernel<<<step_blocks, GPT_ADAM_STEP_THREADS, 0, st>>>(
      L, s, k, (const double*)scratch, norm_blocks);
  return (int)cudaGetLastError();
}

#else

// The host build: the same step, the sum of squares in one pass in leaf
// order.  Returns 1 for a leaf count the kernels do not take.
extern "C" int gpt_adam_fused_host(int leaves, const long long* n, void* const* ptrs,
                                   void* const* scalars, const float* consts,
                                   const double* decays) {
  Leaves L;
  Scalars s;
  Consts k;
  if (!fill(leaves, n, ptrs, scalars, consts, decays, &L, &s, &k)) return 1;
  double sumsq = 0.0;
  for (int j = 0; j < L.count; ++j)
    for (long long i = 0; i < L.n[j]; ++i) sumsq += (double)L.g[j][i] * L.g[j][i];
  float bc1, bc2;
  bias_corrections(s, k, bc1, bc2);
  const Step c = step_of(sumsq, bc1, bc2, s, k);
  for (int j = 0; j < L.count; ++j)
    for (long long i = 0; i < L.n[j]; ++i) {
      if (c.use) {
        adam_elem(L.p[j][i], L.g[j][i], L.m[j][i], L.v[j][i], c, k, L.p_out[j][i],
                  L.m_out[j][i], L.v_out[j][i]);
      } else {
        L.p_out[j][i] = L.p[j][i];
        L.m_out[j][i] = L.m[j][i];
        L.v_out[j][i] = L.v[j][i];
      }
    }
  write_scalars(c, s, k);
  return 0;
}

#endif
