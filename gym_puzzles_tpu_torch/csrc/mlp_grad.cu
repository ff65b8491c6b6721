// The MLP learner's per-minibatch gather, forward, PPO loss and backward
// (gym_puzzles_tpu_torch/train/ppo.py PPO.loss + torch.autograd.grad for an
// ActorCritic with a two-layer tanh trunk; wrapper train/mlp_grad.py) as four
// kernels around the trunk's three large GEMMs, which stay cuBLAS's
// (torch.mm, float32, TF32 off):
//   1. fwd:    the minibatch rows' observations gathered, h1 = tanh(x W1^T + b1)
//              with W1 in shared memory (K = obs_dim, too small for a GEMM),
//              and per-block sums of the advantages (shifted) and their squares;
//      GEMM:   z2 = h1 W2^T;
//   2. head:   h2 = tanh(z2 + b2); the mean and value heads as dot products
//              with the head rows in shared memory; the advantages normalized
//              with the minibatch mean and population std, which every block
//              reduces from kernel 1's sums in one fixed order; the log-prob,
//              ratio, clipped surrogate, value error and KL term of each row
//              and the row's dL/dmean, dL/dvalue and dL/dlog_std; then
//              dz2 = (dmean Wm + dvalue wv) * (1 - h2^2), and per-block partial
//              sums of dWm, dbm, dwv, dbv, dlog_std, db2 and the loss terms;
//      GEMMs:  dW2 = dz2^T h1, dh1 = dz2 W2;
//   3. back:   dz1 = dh1 * (1 - h1^2) and per-block partial sums of dW1 and db1;
//   4. reduce: every partial summed over the blocks in one fixed order, in
//              float64, into the gradient leaves, the four losses and approx_kl.
//
// Replaces no TPU kernel: the learner's loss and its gradient are XLA's in
// the JAX package.  It was added because PPO.loss + autograd ran as ~115 small
// ATen kernels per minibatch around the three GEMMs (elementwise ops, the
// bias and mean reductions, the tanh backward, the minibatch gathers), three
// quarters of the layer's time in launches and tails on vectors of 8192 or
// 16384 rows.
//
// What bounds it: the minibatch is ~2 M H (3 H + 2 D + 3 (A + 1)) float32
// operations with M rows, widths H, obs_dim D and act_dim A, nearly all of
// them the three H x H GEMMs, which cuBLAS runs at about half of float32's
// peak.  The four kernels here do the small products (K = D, A + 1), the
// tanhs and the loss, and move the [M, H] planes: h1 written, z2 read, dz2
// written, dh1 and h1 read, five passes of 4 M H bytes; on the card they run
// at the pace of those passes and of the memory latency between their
// phases, not of their operations.  The design:
// * float32 throughout on the CUDA cores, as the configurations state (no
//   TF32, no reduced precision); sums of many rows are per-block float32
//   partials reduced across blocks in float64;
// * no float atomics: every reduction runs over fixed per-block partials in a
//   fixed order, so a launch gives the same bits every time (a CUDA graph's
//   replay equals its eager launch);
// * one thread per hidden unit, so each [M, H] plane is read and written
//   coalesced, a thread keeps its unit's column of the small weights in
//   registers, and the small products read their other operand as float4
//   broadcasts from shared memory;
// * persistent blocks: the rows come in tiles (GPT_MLP_R1 / R2 / R3 rows),
//   and each of a kernel's blocks (two per SM, what the SMs hold of each at
//   the recipes' shapes; the wrapper passes them) takes the tiles
//   blockIdx.x, blockIdx.x + gridDim.x, ... in order: the weights are staged
//   into shared memory once per block, a thread's sums run on in registers
//   from tile to tile, and the partials are one row per block, not per tile;
// * a thread's global loads are issued many at a time into registers before
//   any is used, and the next tile's are issued before the current tile's
//   last work, so that a block waits on few memory latencies;
// * the hyperparameters (clip_range, vf_coef, ent_coef) are read from 0-d
//   device tensors, so a new value needs no new capture.
//
// Without nvcc the stages compile as host C++ (g++ -x c++ -ffp-contract=off)
// as gpt_mlp_{fwd,head,back,reduce}_host, loops over the same blocks, rows and
// partials with the same per-row and per-element functions, which is how the
// CPU tests hold the chain against PPO.loss + autograd.  The port never runs
// that build.

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define GPT_HD __host__ __device__ __forceinline__
#else
#define GPT_HD static inline
#endif

#define GPT_MLP_MAX_D 64    // train/mlp_grad.py MAX_OBS
#define GPT_MLP_MAX_A 32    // train/mlp_grad.py MAX_ACT
#define GPT_MLP_MAX_H 512   // train/mlp_grad.py MAX_WIDTH
#define GPT_MLP_R1 32       // rows per tile: fwd
#define GPT_MLP_R2 32       // rows per tile: head (one warp's lanes in its dot products)
#define GPT_MLP_R3 64       // rows per tile: back
#define GPT_MLP_RED_WARPS 8 // reduce: warps per block, each over every 8th partial row
#define GPT_MLP_CHUNK 8     // back: rows of dh1 and h1 loaded ahead
#define GPT_MLP_INFLIGHT 16 // gathers: loads a thread issues before it waits

// the pointers' order in the wrapper's list (train/mlp_grad.py PTRS)
enum Ptr {
  P_OBS, P_ACT, P_OLP, P_ADV, P_RET, P_IDX,
  P_LOG_STD, P_W1, P_B1, P_B2, P_WM, P_BM, P_WV, P_BV,
  P_CLIP, P_VF, P_ENT,
  P_H1, P_Z2, P_DZ2, P_DH1, P_PART1, P_PART2, P_PART3,
  P_G_LOG_STD, P_G_W1, P_G_B1, P_G_B2, P_G_WM, P_G_BM, P_G_WV, P_G_BV, P_LOSSES, P_KL,
  P_COUNT
};

struct Ptrs {
  const float *obs, *act, *olp, *adv, *ret;
  const long long* idx;
  const float *log_std, *W1, *b1, *b2, *Wm, *bm, *wv, *bv;
  const float *clip, *vf, *ent;
  float *h1;
  const float* z2;
  float* dz2;
  const float* dh1;
  double* part1;
  float *part2, *part3;
  float *g_log_std, *g_W1, *g_b1, *g_b2, *g_Wm, *g_bm, *g_wv, *g_bv, *losses, *kl;
  float log_2pi, half_log_2pie, adv_eps;  // PPO.loss's constants as float32
};

// the shapes and everything derived from them
struct Dims {
  int M, D, H1, H2, A;  // rows, obs_dim, the trunk's widths, act_dim
  int D4, A1, A1P, T1, T2;  // D to 4; A + 1 heads; A1 to its class; threads (widths to 32)
  int nb1, nb2, nb3;  // row tiles of fwd, head, back
  int g1, g2, g3;  // blocks of fwd, head, back (each <= its tiles)
  int o_db2, o_dbh, o_dls, o_loss, L2;  // a head partial's row: dWh [A1][H2], db2, dbh, dlog_std, 3 loss sums
  int L3;  // a back partial's row: dW1 as [D][H1], db1
  int nbr2, nbr3;  // reduce blocks of 32 elements over the head's and the back's gradients
};

GPT_HD int up(int x, int m) { return (x + m - 1) / m * m; }

// the head's size class: A + 1 rounded up to 8, 16 or 36 (the template of
// the head kernel, so that a thread's A + 1 columns live in registers)
GPT_HD int a1_class(int a1) { return a1 <= 8 ? 8 : a1 <= 16 ? 16 : 36; }

// the back kernel's class: obs_dim rounded up to 32, 48 or 64
GPT_HD int d_class(int d4) { return d4 <= 32 ? 32 : d4 <= 48 ? 48 : 64; }

// dims[0..7] = M, D, H1, H2, A, then the blocks of fwd, head and back (each
// cut to its kernel's tiles) -> 1 and *d filled, or 0 for shapes the
// kernels do not take
static int make_dims(const int* in, Dims* d) {
  d->M = in[0];
  d->D = in[1];
  d->H1 = in[2];
  d->H2 = in[3];
  d->A = in[4];
  if (d->M < 1 || d->D < 1 || d->D > GPT_MLP_MAX_D || d->A < 1 || d->A > GPT_MLP_MAX_A ||
      d->H1 < 1 || d->H1 > GPT_MLP_MAX_H || d->H2 < 1 || d->H2 > GPT_MLP_MAX_H || in[5] < 1 ||
      in[6] < 1 || in[7] < 1)
    return 0;
  d->D4 = up(d->D, 4);
  d->A1 = d->A + 1;
  d->A1P = a1_class(d->A1);
  d->T1 = up(d->H1, 32);
  d->T2 = up(d->H2, 32);
  d->nb1 = (d->M + GPT_MLP_R1 - 1) / GPT_MLP_R1;
  d->nb2 = (d->M + GPT_MLP_R2 - 1) / GPT_MLP_R2;
  d->nb3 = (d->M + GPT_MLP_R3 - 1) / GPT_MLP_R3;
  d->g1 = in[5] < d->nb1 ? in[5] : d->nb1;
  d->g2 = in[6] < d->nb2 ? in[6] : d->nb2;
  d->g3 = in[7] < d->nb3 ? in[7] : d->nb3;
  d->o_db2 = d->A1 * d->H2;
  d->o_dbh = d->o_db2 + d->H2;
  d->o_dls = d->o_dbh + d->A1;
  d->o_loss = d->o_dls + d->A;
  d->L2 = up(d->o_loss + 3, 4);
  d->L3 = up(d->D * d->H1 + d->H1, 4);
  d->nbr2 = (d->o_loss + 31) / 32;
  d->nbr3 = (d->D * d->H1 + d->H1 + 31) / 32;
  return 1;
}

static void fill(void* const* p, const float* consts, Ptrs* q) {
  q->obs = (const float*)p[P_OBS];
  q->act = (const float*)p[P_ACT];
  q->olp = (const float*)p[P_OLP];
  q->adv = (const float*)p[P_ADV];
  q->ret = (const float*)p[P_RET];
  q->idx = (const long long*)p[P_IDX];
  q->log_std = (const float*)p[P_LOG_STD];
  q->W1 = (const float*)p[P_W1];
  q->b1 = (const float*)p[P_B1];
  q->b2 = (const float*)p[P_B2];
  q->Wm = (const float*)p[P_WM];
  q->bm = (const float*)p[P_BM];
  q->wv = (const float*)p[P_WV];
  q->bv = (const float*)p[P_BV];
  q->clip = (const float*)p[P_CLIP];
  q->vf = (const float*)p[P_VF];
  q->ent = (const float*)p[P_ENT];
  q->h1 = (float*)p[P_H1];
  q->z2 = (const float*)p[P_Z2];
  q->dz2 = (float*)p[P_DZ2];
  q->dh1 = (const float*)p[P_DH1];
  q->part1 = (double*)p[P_PART1];
  q->part2 = (float*)p[P_PART2];
  q->part3 = (float*)p[P_PART3];
  q->g_log_std = (float*)p[P_G_LOG_STD];
  q->g_W1 = (float*)p[P_G_W1];
  q->g_b1 = (float*)p[P_G_B1];
  q->g_b2 = (float*)p[P_G_B2];
  q->g_Wm = (float*)p[P_G_WM];
  q->g_bm = (float*)p[P_G_BM];
  q->g_wv = (float*)p[P_G_WV];
  q->g_bv = (float*)p[P_G_BV];
  q->losses = (float*)p[P_LOSSES];
  q->kl = (float*)p[P_KL];
  q->log_2pi = consts[0];
  q->half_log_2pie = consts[1];
  q->adv_eps = consts[2];
}

// tanh's derivative from its output, 1 - h^2, as one rounded FMA
GPT_HD float dtanh(float h) { return fmaf(-h, h, 1.0f); }

// the minibatch mean and population std of the advantages from the sums of
// (adv - shift) and its square over the M rows (float64), rounded to float32
GPT_HD void adv_stats(double s1, double s2, double shift, int M, float* mean, float* std) {
  const double n = (double)M;
  double var = (s2 - s1 * s1 / n) / n;
  var = var > 0.0 ? var : 0.0;
  *mean = (float)(shift + s1 / n);
  *std = (float)sqrt(var);
}

struct RowTerms {
  float s, vsq, kl, dvalue, glp;  // surrogate min, squared value error, KL term, dL/dvalue, dL/dlog_prob
};

// One row of PPO.loss and its gradient, in PPO.loss's float32 operations, in
// three steps.  1: one action dim's term of the log-prob, from the action,
// the mean head, var = exp(2 log_std) and two_ls = 2 log_std; *d and *q keep
// action - mean and its square over var for step 3.
GPT_HD float lp_term(float act, float mean, float var, float two_ls, float log_2pi, float* d,
                     float* q) {
  *d = act - mean;
  *q = (*d * *d) / var;
  return -0.5f * ((*q + two_ls) + log_2pi);
}

// 2: from the row's log-prob (its terms summed in order), the ratio, the
// clipped surrogate, the value error and the KL term, and dL/dlog_prob and
// dL/dvalue.  lo, hi = 1 -+ clip_range; gs = -1 / M, the surrogate mean's
// gradient; gv = vf_coef / M.
GPT_HD RowTerms row_loss(float lp, float olp, float adv, float ret, float value, float adv_mean,
                         float adv_std, float adv_eps, float lo, float hi, float gs, float gv) {
  const float ratio = expf(lp - olp);
  const float an = (adv - adv_mean) / (adv_std + adv_eps);
  const float cl = fminf(fmaxf(ratio, lo), hi);
  const float s1 = an * ratio, s2 = an * cl;
  // torch.minimum's gradient: to the smaller, halved on a tie; the clipped
  // side passes torch.clamp's gradient only inside [lo, hi]
  const float w1 = s1 == s2 ? 0.5f : (s1 < s2 ? 1.0f : 0.0f);
  const float w2 = s1 == s2 ? 0.5f : (s1 > s2 ? 1.0f : 0.0f);
  const float pass = (ratio >= lo && ratio <= hi) ? 1.0f : 0.0f;
  RowTerms o;
  const float vres = ret - value;
  o.glp = ((gs * w1) * an + ((gs * w2) * an) * pass) * ratio;
  o.s = fminf(s1, s2);
  o.vsq = vres * vres;
  o.kl = (ratio - 1.0f) - logf(ratio);
  o.dvalue = -((gv * 2.0f) * vres);
  return o;
}

// 3: one action dim's dL/dmean (into *d) and the row's dL/dlog_std (into *q)
GPT_HD void row_grad(float glp, float var, float* d, float* q) {
  *d = (glp * *d) / var;
  *q = glp * (*q - 1.0f);
}

// where reduced element e of the head's (region 0) or the back's (region 1)
// partial row goes; *add is what PPO.loss adds to it besides the rows (the
// entropy bonus's -ent_coef on dlog_std)
GPT_HD float* dest(const Dims& d, const Ptrs& p, int region, int e, float* add) {
  *add = 0.0f;
  if (region == 1) {
    if (e < d.D * d.H1) return p.g_W1 + (e % d.H1) * d.D + e / d.H1;  // [k][j] -> [j][k]
    return p.g_b1 + (e - d.D * d.H1);
  }
  if (e < d.A * d.H2) return p.g_Wm + e;
  if (e < d.o_db2) return p.g_wv + (e - d.A * d.H2);
  if (e < d.o_dbh) return p.g_b2 + (e - d.o_db2);
  if (e < d.o_dbh + d.A) return p.g_bm + (e - d.o_dbh);
  if (e == d.o_dbh + d.A) return p.g_bv;
  *add = -*p.ent;
  return p.g_log_std + (e - d.o_dls);
}

// the four losses (total, policy, value, entropy) and approx_kl from the
// three loss sums over the M rows
GPT_HD void finish_losses(const Dims& d, const Ptrs& p, double s, double vsq, double kl) {
  const float pg = -(float)(s / d.M);
  const float vl = (float)(vsq / d.M);
  float ent = 0.0f;
  for (int a = 0; a < d.A; ++a) ent += p.log_std[a] + p.half_log_2pie;
  p.losses[0] = (pg + *p.vf * vl) - *p.ent * ent;
  p.losses[1] = pg;
  p.losses[2] = vl;
  p.losses[3] = ent;
  *p.kl = (float)(kl / d.M);
}

#ifdef __CUDACC__

// ---------------------------------------------------------------------------
// Loads.  A thread's global loads are issued GPT_MLP_INFLIGHT at a time into
// registers before any of them is stored.
// ---------------------------------------------------------------------------

// a tile's rows' indices into the flat batch: ridx[r] = idx[row0 + r], -1 past M
template <int R>
__device__ __forceinline__ void load_rows(const Dims& d, const Ptrs& p, int row0, long long* ridx) {
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    ridx[r] = row0 + r < d.M ? __ldg(p.idx + row0 + r) : -1;
}

// rows ridx of src [*, width] into dst [R][stride], zeros past width and for missing rows
template <int R>
__device__ __forceinline__ void gather(const float* __restrict__ src, int width, int stride,
                                       const long long* ridx, float* dst) {
  const int n = R * stride, T = blockDim.x;
  for (int base = threadIdx.x; base < n; base += GPT_MLP_INFLIGHT * T) {
    float v[GPT_MLP_INFLIGHT];
#pragma unroll
    for (int u = 0; u < GPT_MLP_INFLIGHT; ++u) {
      const int e = base + u * T, r = e / stride, k = e - r * stride;
      v[u] = (e < n && k < width && ridx[r] >= 0) ? __ldg(src + ridx[r] * width + k) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < GPT_MLP_INFLIGHT; ++u)
      if (base + u * T < n) dst[base + u * T] = v[u];
  }
}

// ---------------------------------------------------------------------------
// 1. fwd: one thread per unit of h1; tiles of GPT_MLP_R1 rows
// ---------------------------------------------------------------------------

// the float32 words of the fwd kernel's dynamic shared memory
GPT_HD int fwd_smem_words(const Dims& d) { return GPT_MLP_R1 * d.D4 + d.D4 * (d.T1 + 1); }

// shared: the tile's observations xs [R1][D4]; W1 transposed w1t [D4][T1 + 1]
// (the odd row stride: W1's coalesced rows go in, and each thread's column
// comes out, without bank conflicts), zeros past D
__global__ void __launch_bounds__(GPT_MLP_MAX_H) gpt_mlp_fwd_kernel(const Dims d, const Ptrs p) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* w1t = xs + GPT_MLP_R1 * d.D4;
  __shared__ long long ridx[GPT_MLP_R1];
  __shared__ double advs[GPT_MLP_R1];
  const int t = threadIdx.x, T = blockDim.x, WS = T + 1;
  load_rows<GPT_MLP_R1>(d, p, blockIdx.x * GPT_MLP_R1, ridx);
  const int n = d.H1 * d.D;
  for (int base = t; base < n; base += GPT_MLP_INFLIGHT * T) {
    float v[GPT_MLP_INFLIGHT];
#pragma unroll
    for (int u = 0; u < GPT_MLP_INFLIGHT; ++u)
      v[u] = base + u * T < n ? __ldg(p.W1 + base + u * T) : 0.0f;
#pragma unroll
    for (int u = 0; u < GPT_MLP_INFLIGHT; ++u) {
      const int e = base + u * T, j = e / d.D;
      if (e < n) w1t[(e - j * d.D) * WS + j] = v[u];
    }
  }
  for (int e = t; e < (d.D4 - d.D) * WS; e += T) w1t[d.D * WS + e] = 0.0f;
  const double shift = (double)__ldg(p.adv + __ldg(p.idx));
  const float b = t < d.H1 ? __ldg(p.b1 + t) : 0.0f;
  const int KQ = d.D4 / 4;
  const float4* x4 = reinterpret_cast<const float4*>(xs);
  double s1 = 0.0, s2 = 0.0;
  for (int tile = blockIdx.x; tile < d.nb1; tile += gridDim.x) {
    const int row0 = tile * GPT_MLP_R1;
    __syncthreads();  // ridx of this tile written; the last tile's xs read
    gather<GPT_MLP_R1>(p.obs, d.D, d.D4, ridx, xs);
    if (t < GPT_MLP_R1) advs[t] = ridx[t] >= 0 ? (double)__ldg(p.adv + ridx[t]) - shift : 0.0;
    __syncthreads();
    if (t == 0)
      for (int r = 0; r < GPT_MLP_R1; ++r) {
        s1 += advs[r];
        s2 += advs[r] * advs[r];
      }
    const int next = (tile + gridDim.x) * GPT_MLP_R1 + t;
    const long long nidx = t < GPT_MLP_R1 && next < d.M ? __ldg(p.idx + next) : -1;
    float acc[GPT_MLP_R1];
#pragma unroll
    for (int r = 0; r < GPT_MLP_R1; ++r) acc[r] = 0.0f;
    for (int kq = 0; kq < KQ; ++kq) {
      const float w0 = w1t[(4 * kq) * WS + t], w1 = w1t[(4 * kq + 1) * WS + t];
      const float w2 = w1t[(4 * kq + 2) * WS + t], w3 = w1t[(4 * kq + 3) * WS + t];
#pragma unroll
      for (int r = 0; r < GPT_MLP_R1; ++r) {
        const float4 x = x4[r * KQ + kq];
        acc[r] = fmaf(x.x, w0, acc[r]);
        acc[r] = fmaf(x.y, w1, acc[r]);
        acc[r] = fmaf(x.z, w2, acc[r]);
        acc[r] = fmaf(x.w, w3, acc[r]);
      }
    }
    if (t < d.H1) {
#pragma unroll
      for (int r = 0; r < GPT_MLP_R1; ++r)
        if (row0 + r < d.M) p.h1[(long long)(row0 + r) * d.H1 + t] = tanhf(acc[r] + b);
    }
    __syncthreads();  // every ridx read
    if (t < GPT_MLP_R1) ridx[t] = nidx;
  }
  if (t == 0) {
    p.part1[2 * blockIdx.x] = s1;
    p.part1[2 * blockIdx.x + 1] = s2;
  }
}

// ---------------------------------------------------------------------------
// 2. head: one thread per unit of h2; tiles of GPT_MLP_R2 (= 32) rows
// ---------------------------------------------------------------------------

// the float32 words of the head kernel's red region: the dot products'
// partials, then lpt and dls
GPT_HD int head_red_words(int T2, int A1P) {
  return T2 * A1P > 2 * GPT_MLP_R2 * A1P ? T2 * A1P : 2 * GPT_MLP_R2 * A1P;
}

// the float32 words of the head kernel's dynamic shared memory
GPT_HD int head_smem_words(const Dims& d) {
  return d.A1P * d.T2 + GPT_MLP_R2 * (d.T2 + 4) + head_red_words(d.T2, d.A1P) +
         3 * GPT_MLP_R2 * d.A1P + 9 * GPT_MLP_R2 + 2 * d.A1P;
}

// the block's sum of x over its threads, in thread 0, in a fixed order
__device__ __forceinline__ double block_sum(double x, double* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < warps; ++w) x += warp_sums[w];
  return x;
}

// shared: head rows whs [A1P][T2] (Wm's rows, wv, zeros); h2 [R2][T2 + 4];
// the dot products' partials red [T2 / 32][A1P][32], whose words the
// log-prob terms lpt and dls (the squared term, then the row's dlog_std),
// each [R2][A1P], take over once the heads are summed; each [R2][A1P]: the
// heads' outputs ys, the rows' actions acts, dys (action - mean, then dmean;
// dvalue at A); [R2][4]: the loss terms lt and the rows' old log-prob,
// advantage and return rin; dL/dlog_prob glp [R2]; exp(2 log_std) and
// 2 log_std [A1P].  h2 stays in shared memory from its tanh to dz2, and a
// thread's registers hold the next tile's z2 from the end of a tile to the
// next tile's tanh.
template <int A1P>
__global__ void __launch_bounds__(GPT_MLP_MAX_H) gpt_mlp_head_kernel(const Dims d, const Ptrs p) {
  extern __shared__ float4 smem4[];
  const int t = threadIdx.x, T = blockDim.x, lane = t & 31, warp = t >> 5;
  const int RS = d.T2 + 4, RA = GPT_MLP_R2 * A1P, NQ = d.A1 + d.A + 3;
  float* whs = reinterpret_cast<float*>(smem4);
  float* h2s = whs + A1P * d.T2;
  float* red = h2s + GPT_MLP_R2 * RS;
  float* lpt = red;
  float* dls = red + RA;
  float* ys = red + head_red_words(d.T2, A1P);
  float* acts = ys + RA;
  float* dys = acts + RA;
  float* lt = dys + RA;
  float* rin = lt + GPT_MLP_R2 * 4;
  float* glp = rin + GPT_MLP_R2 * 4;
  float* var = glp + GPT_MLP_R2;
  float* two_ls = var + A1P;
  __shared__ long long ridx[GPT_MLP_R2];
  __shared__ double warp_sums[GPT_MLP_MAX_H / 32];
  __shared__ float stats[2];

  // the first tile's z2, the head rows and fwd's sums, all in flight at once
  float hreg[GPT_MLP_R2];
  const int first = blockIdx.x * GPT_MLP_R2;
#pragma unroll
  for (int r = 0; r < GPT_MLP_R2; ++r)
    hreg[r] = (t < d.H2 && first + r < d.M) ? __ldg(p.z2 + (long long)(first + r) * d.H2 + t) : 0.0f;
#pragma unroll
  for (int a = 0; a < A1P; ++a)
    whs[a * d.T2 + t] = t >= d.H2 || a > d.A ? 0.0f
                        : a < d.A            ? __ldg(p.Wm + a * d.H2 + t)
                                             : __ldg(p.wv + t);
  load_rows<GPT_MLP_R2>(d, p, first, ridx);
  if (t < A1P) {
    const float two = t < d.A ? 2.0f * __ldg(p.log_std + t) : 0.0f;
    two_ls[t] = two;
    var[t] = t < d.A ? expf(two) : 1.0f;
  }
  double s1 = 0.0, s2 = 0.0;
  for (int b = t; b < d.g1; b += T) {
    s1 += p.part1[2 * b];
    s2 += p.part1[2 * b + 1];
  }
  for (int e = t; e < RA; e += T) dys[e] = 0.0f;
  const double shift = (double)__ldg(p.adv + __ldg(p.idx));
  const float b2 = t < d.H2 ? __ldg(p.b2 + t) : 0.0f;
  s1 = block_sum(s1, warp_sums);
  s2 = block_sum(s2, warp_sums);
  if (t == 0) adv_stats(s1, s2, shift, d.M, stats, stats + 1);
  const float clip = *p.clip, mf = (float)d.M, gv = *p.vf / mf;

  // a thread's sums over every tile: dWh's and db2's column, and (thread q <
  // NQ) one of dbh, dlog_std and the three loss terms
  float dwh[A1P], db2 = 0.0f, small[3] = {0.0f, 0.0f, 0.0f};  // NQ <= 68 <= 3 T
#pragma unroll
  for (int a = 0; a < A1P; ++a) dwh[a] = 0.0f;
  for (int tile = blockIdx.x; tile < d.nb2; tile += gridDim.x) {
    const int row0 = tile * GPT_MLP_R2;
    __syncthreads();  // ridx of this tile written; the last tile's shared data read
    gather<GPT_MLP_R2>(p.act, d.A, A1P, ridx, acts);
    if (t < GPT_MLP_R2 && ridx[t] >= 0) {
      rin[4 * t] = __ldg(p.olp + ridx[t]);
      rin[4 * t + 1] = __ldg(p.adv + ridx[t]);
      rin[4 * t + 2] = __ldg(p.ret + ridx[t]);
    }
#pragma unroll
    for (int r = 0; r < GPT_MLP_R2; ++r)
      h2s[r * RS + t] = t < d.H2 && row0 + r < d.M ? tanhf(hreg[r] + b2) : 0.0f;
    __syncthreads();

    // the heads: lane = row, warp = a slice of 32 units; then the slices in order
    {
      float acc[A1P];
#pragma unroll
      for (int a = 0; a < A1P; ++a) acc[a] = 0.0f;
      const float* hrow = h2s + lane * RS + 32 * warp;
      const float* wrow = whs + 32 * warp;
#pragma unroll
      for (int jq = 0; jq < 8; ++jq) {
        const float4 h = *reinterpret_cast<const float4*>(hrow + 4 * jq);
#pragma unroll
        for (int a = 0; a < A1P; ++a) {
          const float4 w = *reinterpret_cast<const float4*>(wrow + a * d.T2 + 4 * jq);
          acc[a] = fmaf(h.x, w.x, acc[a]);
          acc[a] = fmaf(h.y, w.y, acc[a]);
          acc[a] = fmaf(h.z, w.z, acc[a]);
          acc[a] = fmaf(h.w, w.w, acc[a]);
        }
      }
#pragma unroll
      for (int a = 0; a < A1P; ++a) red[(warp * A1P + a) * 32 + lane] = acc[a];
    }
    __syncthreads();
    for (int o = t; o < GPT_MLP_R2 * d.A1; o += T) {
      const int r = o % 32, a = o / 32;
      float y = 0.0f;
      for (int s = 0; s < d.T2 / 32; ++s) y += red[(s * A1P + a) * 32 + r];
      ys[r * A1P + a] = y + (a < d.A ? __ldg(p.bm + a) : __ldg(p.bv));
    }
    __syncthreads();  // red summed: lpt and dls take its words

    // the rows' loss and gradient: each (row, action dim), then each row,
    // then each (row, action dim) again
    for (int o = t; o < GPT_MLP_R2 * d.A; o += T) {
      const int r = o / d.A, a = o - r * d.A, e = r * A1P + a;
      lpt[e] = lp_term(acts[e], ys[e], var[a], two_ls[a], p.log_2pi, dys + e, dls + e);
    }
    __syncthreads();
    if (t < GPT_MLP_R2) {
      RowTerms o = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (ridx[t] >= 0) {
        float lp = 0.0f;
        for (int a = 0; a < d.A; ++a) lp += lpt[t * A1P + a];
        o = row_loss(lp, rin[4 * t], rin[4 * t + 1], rin[4 * t + 2], ys[t * A1P + d.A],
                     stats[0], stats[1], p.adv_eps, 1.0f - clip, 1.0f + clip, -1.0f / mf, gv);
      }
      glp[t] = o.glp;
      dys[t * A1P + d.A] = o.dvalue;
      lt[t * 4] = o.s;
      lt[t * 4 + 1] = o.vsq;
      lt[t * 4 + 2] = o.kl;
    }
    __syncthreads();
    for (int o = t; o < GPT_MLP_R2 * d.A; o += T) {
      const int r = o / d.A, a = o - r * d.A, e = r * A1P + a;
      row_grad(glp[r], var[a], dys + e, dls + e);
    }
    __syncthreads();

    // dz2 = (dmean Wm + dvalue wv) * (1 - h2^2); dWh and db2 summed on
    {
      float wcol[A1P];
#pragma unroll
      for (int a = 0; a < A1P; ++a) wcol[a] = whs[a * d.T2 + t];
#pragma unroll
      for (int r = 0; r < GPT_MLP_R2; ++r) {
        const float4* dy4 = reinterpret_cast<const float4*>(dys + r * A1P);
        const float h = h2s[r * RS + t];
        float pre = 0.0f;
#pragma unroll
        for (int aq = 0; aq < A1P / 4; ++aq) {
          const float4 y = dy4[aq];
          pre = fmaf(y.x, wcol[4 * aq], pre);
          pre = fmaf(y.y, wcol[4 * aq + 1], pre);
          pre = fmaf(y.z, wcol[4 * aq + 2], pre);
          pre = fmaf(y.w, wcol[4 * aq + 3], pre);
          dwh[4 * aq] = fmaf(y.x, h, dwh[4 * aq]);
          dwh[4 * aq + 1] = fmaf(y.y, h, dwh[4 * aq + 1]);
          dwh[4 * aq + 2] = fmaf(y.z, h, dwh[4 * aq + 2]);
          dwh[4 * aq + 3] = fmaf(y.w, h, dwh[4 * aq + 3]);
        }
        const float dz = pre * dtanh(h);
        if (t < d.H2 && row0 + r < d.M) p.dz2[(long long)(row0 + r) * d.H2 + t] = dz;
        db2 += dz;
      }
    }
    // the next tile's z2 in flight while this tile's small sums are taken
    const int next = row0 + gridDim.x * GPT_MLP_R2;
#pragma unroll
    for (int r = 0; r < GPT_MLP_R2; ++r)
      hreg[r] = (t < d.H2 && next + r < d.M) ? __ldg(p.z2 + (long long)(next + r) * d.H2 + t) : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int q = t + k * T;
      if (q < d.A1)
        for (int r = 0; r < GPT_MLP_R2; ++r) small[k] += dys[r * A1P + q];
      else if (q < d.A1 + d.A)
        for (int r = 0; r < GPT_MLP_R2; ++r) small[k] += dls[r * A1P + q - d.A1];
      else if (q < NQ)
        for (int r = 0; r < GPT_MLP_R2; ++r) small[k] += lt[r * 4 + q - d.A1 - d.A];
    }
    __syncthreads();  // every ridx read
    if (t < GPT_MLP_R2) ridx[t] = next + t < d.M ? __ldg(p.idx + next + t) : -1;
  }
  float* part = p.part2 + (long long)blockIdx.x * d.L2;
  if (t < d.H2) {
#pragma unroll
    for (int a = 0; a < A1P; ++a)
      if (a < d.A1) part[a * d.H2 + t] = dwh[a];
    part[d.o_db2 + t] = db2;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)  // dbh, dlog_std and the loss terms follow one another
    if (t + k * T < NQ) part[d.o_dbh + t + k * T] = small[k];
}

// ---------------------------------------------------------------------------
// 3. back: one thread per unit of h1; tiles of GPT_MLP_R3 rows; each
// thread's next GPT_MLP_CHUNK rows of dh1 and h1 are loaded while it works
// on these
// ---------------------------------------------------------------------------

template <int DMAX>
__global__ void __launch_bounds__(GPT_MLP_MAX_H) gpt_mlp_back_kernel(const Dims d, const Ptrs p) {
  __shared__ float4 xs4[GPT_MLP_R3 * DMAX / 4];  // the tile's observations [R3][DMAX]
  __shared__ long long ridx[GPT_MLP_R3];
  float* xs = reinterpret_cast<float*>(xs4);
  const int t = threadIdx.x;
  float g[GPT_MLP_CHUNK], h[GPT_MLP_CHUNK];
  auto load = [&](int row0, int c, int rows, float* gg, float* hh) {
#pragma unroll
    for (int u = 0; u < GPT_MLP_CHUNK; ++u) {
      const long long at = (long long)(row0 + c + u) * d.H1 + t;
      const bool in = t < d.H1 && c + u < rows;
      gg[u] = in ? __ldg(p.dh1 + at) : 0.0f;
      hh[u] = in ? __ldg(p.h1 + at) : 0.0f;
    }
  };
  float acc[DMAX], db1 = 0.0f;
#pragma unroll
  for (int k = 0; k < DMAX; ++k) acc[k] = 0.0f;
  for (int tile = blockIdx.x; tile < d.nb3; tile += gridDim.x) {
    const int row0 = tile * GPT_MLP_R3;
    const int rows = d.M - row0 < GPT_MLP_R3 ? d.M - row0 : GPT_MLP_R3;
    load(row0, 0, rows, g, h);
    __syncthreads();  // the last tile's xs read
    load_rows<GPT_MLP_R3>(d, p, row0, ridx);
    __syncthreads();
    gather<GPT_MLP_R3>(p.obs, d.D, DMAX, ridx, xs);
    __syncthreads();
    if (t < d.H1) {
      for (int c = 0; c < rows; c += GPT_MLP_CHUNK) {
        float gn[GPT_MLP_CHUNK], hn[GPT_MLP_CHUNK];
        load(row0, c + GPT_MLP_CHUNK, rows, gn, hn);
#pragma unroll
        for (int u = 0; u < GPT_MLP_CHUNK; ++u) {
          if (c + u >= rows) break;
          const float dz = g[u] * dtanh(h[u]);
          db1 += dz;
          const float4* x4 = reinterpret_cast<const float4*>(xs + (c + u) * DMAX);
#pragma unroll
          for (int kq = 0; kq < DMAX / 4; ++kq) {
            const float4 x = x4[kq];
            acc[4 * kq] = fmaf(dz, x.x, acc[4 * kq]);
            acc[4 * kq + 1] = fmaf(dz, x.y, acc[4 * kq + 1]);
            acc[4 * kq + 2] = fmaf(dz, x.z, acc[4 * kq + 2]);
            acc[4 * kq + 3] = fmaf(dz, x.w, acc[4 * kq + 3]);
          }
        }
#pragma unroll
        for (int u = 0; u < GPT_MLP_CHUNK; ++u) {
          g[u] = gn[u];
          h[u] = hn[u];
        }
      }
    }
  }
  if (t >= d.H1) return;
  float* part = p.part3 + (long long)blockIdx.x * d.L3;
#pragma unroll
  for (int k = 0; k < DMAX; ++k)
    if (k < d.D) part[k * d.H1 + t] = acc[k];
  part[d.D * d.H1 + t] = db1;
}

// ---------------------------------------------------------------------------
// 4. reduce: 32 elements a block; warp w sums every 8th partial row from w
// in row order (GPT_MLP_INFLIGHT loads at a time), then warp 0 the warps'
// sums in order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32 * GPT_MLP_RED_WARPS) gpt_mlp_reduce_kernel(const Dims d, const Ptrs p) {
  __shared__ double sh[GPT_MLP_RED_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int bi = blockIdx.x, region, e, E, rows, L;
  const float* part;
  if (bi < d.nbr2) {
    region = 0, e = bi * 32 + lane, E = d.o_loss, part = p.part2, rows = d.g2, L = d.L2;
  } else if (bi < d.nbr2 + d.nbr3) {
    region = 1, e = (bi - d.nbr2) * 32 + lane, E = d.D * d.H1 + d.H1, part = p.part3, rows = d.g3,
    L = d.L3;
  } else {
    region = 2, e = d.o_loss + lane, E = d.o_loss + 3, part = p.part2, rows = d.g2, L = d.L2;
  }
  double acc = 0.0;
  if (e < E) {
    for (int b0 = warp; b0 < rows; b0 += GPT_MLP_RED_WARPS * GPT_MLP_INFLIGHT) {
      float v[GPT_MLP_INFLIGHT];
#pragma unroll
      for (int u = 0; u < GPT_MLP_INFLIGHT; ++u) {
        const int b = b0 + u * GPT_MLP_RED_WARPS;
        v[u] = b < rows ? part[(long long)b * L + e] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < GPT_MLP_INFLIGHT; ++u)
        if (b0 + u * GPT_MLP_RED_WARPS < rows) acc += (double)v[u];
    }
  }
  sh[warp][lane] = acc;
  __syncthreads();
  if (warp != 0) return;
  double tot = 0.0;
  for (int w = 0; w < GPT_MLP_RED_WARPS; ++w) tot += sh[w][lane];
  if (region == 2) {
    const double s = __shfl_sync(0xffffffffu, tot, 0), v = __shfl_sync(0xffffffffu, tot, 1);
    const double kl = __shfl_sync(0xffffffffu, tot, 2);
    if (lane == 0) finish_losses(d, p, s, v, kl);
  } else if (e < E) {
    float add;
    float* out = dest(d, p, region, e, &add);
    *out = (float)tot + add;
  }
}

// the most dynamic shared memory a block of `kernel` may take: the device's
// opt-in maximum less the kernel's static shared memory
template <typename K>
static cudaError_t allow_smem(K* kernel) {
  int dev, optin;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin - (int)attr.sharedSizeBytes);
}

// Lets the fwd and head kernels take more than 48 KB of dynamic shared memory
// on the current device (once per device, before any launch or capture).
extern "C" int gpt_mlp_setup() {
  cudaError_t err = allow_smem(gpt_mlp_fwd_kernel);
  if (err == cudaSuccess) err = allow_smem(gpt_mlp_head_kernel<8>);
  if (err == cudaSuccess) err = allow_smem(gpt_mlp_head_kernel<16>);
  if (err == cudaSuccess) err = allow_smem(gpt_mlp_head_kernel<36>);
  return (int)err;
}

#define GPT_MLP_ENTRY(name)                                                                   \
  extern "C" int name(const int* dims, void* const* ptrs, const float* consts, void* stream) { \
    Dims d;                                                                                   \
    Ptrs p;                                                                                   \
    if (!make_dims(dims, &d)) return (int)cudaErrorInvalidValue;                              \
    fill(ptrs, consts, &p);                                                                   \
    cudaStream_t st = (cudaStream_t)stream;

GPT_MLP_ENTRY(gpt_mlp_fwd)
  const size_t smem = sizeof(float) * (size_t)fwd_smem_words(d);
  gpt_mlp_fwd_kernel<<<d.g1, d.T1, smem, st>>>(d, p);
  return (int)cudaGetLastError();
}

GPT_MLP_ENTRY(gpt_mlp_head)
  const size_t smem = sizeof(float) * (size_t)head_smem_words(d);
  if (d.A1P == 8) gpt_mlp_head_kernel<8><<<d.g2, d.T2, smem, st>>>(d, p);
  else if (d.A1P == 16) gpt_mlp_head_kernel<16><<<d.g2, d.T2, smem, st>>>(d, p);
  else gpt_mlp_head_kernel<36><<<d.g2, d.T2, smem, st>>>(d, p);
  return (int)cudaGetLastError();
}

GPT_MLP_ENTRY(gpt_mlp_back)
  const int c = d_class(d.D4);
  if (c == 32) gpt_mlp_back_kernel<32><<<d.g3, d.T1, 0, st>>>(d, p);
  else if (c == 48) gpt_mlp_back_kernel<48><<<d.g3, d.T1, 0, st>>>(d, p);
  else gpt_mlp_back_kernel<64><<<d.g3, d.T1, 0, st>>>(d, p);
  return (int)cudaGetLastError();
}

GPT_MLP_ENTRY(gpt_mlp_reduce)
  gpt_mlp_reduce_kernel<<<d.nbr2 + d.nbr3 + 1, 32 * GPT_MLP_RED_WARPS, 0, st>>>(d, p);
  return (int)cudaGetLastError();
}

#else

// ---------------------------------------------------------------------------
// The host build: each stage as loops over the device's blocks, their tiles
// in order, rows and partials, with the same per-row and per-element
// functions.  Each returns 1 for shapes the kernels do not take.
// ---------------------------------------------------------------------------

#define GPT_MLP_HOST(name)                                                       \
  extern "C" int name(const int* dims, void* const* ptrs, const float* consts) { \
    Dims d;                                                                      \
    Ptrs p;                                                                      \
    if (!make_dims(dims, &d)) return 1;                                          \
    fill(ptrs, consts, &p);

static float obs_at(const Dims& d, const Ptrs& p, int row, int k) {
  return (row < d.M && k < d.D) ? p.obs[p.idx[row] * d.D + k] : 0.0f;
}

GPT_MLP_HOST(gpt_mlp_fwd_host)
  const double shift = (double)p.adv[p.idx[0]];
  for (int g = 0; g < d.g1; ++g) {
    double s1 = 0.0, s2 = 0.0;
    for (int tile = g; tile < d.nb1; tile += d.g1) {
      const int row0 = tile * GPT_MLP_R1;
      for (int r = 0; r < GPT_MLP_R1; ++r) {
        const double v = row0 + r < d.M ? (double)p.adv[p.idx[row0 + r]] - shift : 0.0;
        s1 += v;
        s2 += v * v;
      }
      for (int r = 0; r < GPT_MLP_R1 && row0 + r < d.M; ++r)
        for (int j = 0; j < d.H1; ++j) {
          float acc = 0.0f;
          for (int k = 0; k < d.D4; ++k)
            acc = fmaf(obs_at(d, p, row0 + r, k), k < d.D ? p.W1[j * d.D + k] : 0.0f, acc);
          p.h1[(long long)(row0 + r) * d.H1 + j] = tanhf(acc + p.b1[j]);
        }
    }
    p.part1[2 * g] = s1;
    p.part1[2 * g + 1] = s2;
  }
  return 0;
}

GPT_MLP_HOST(gpt_mlp_head_host)
  const int A1P = d.A1P, NQ = d.A1 + d.A + 3;
  double s1 = 0.0, s2 = 0.0;
  for (int b = 0; b < d.g1; ++b) {
    s1 += p.part1[2 * b];
    s2 += p.part1[2 * b + 1];
  }
  float stats[2], var[GPT_MLP_MAX_A], two_ls[GPT_MLP_MAX_A];
  adv_stats(s1, s2, (double)p.adv[p.idx[0]], d.M, stats, stats + 1);
  for (int a = 0; a < d.A; ++a) {
    two_ls[a] = 2.0f * p.log_std[a];
    var[a] = expf(two_ls[a]);
  }
  const float clip = *p.clip, mf = (float)d.M;
  static float h2[GPT_MLP_R2][GPT_MLP_MAX_H], ys[GPT_MLP_R2][36], dys[GPT_MLP_R2][36],
      dls[GPT_MLP_R2][36], lt[GPT_MLP_R2][3], dwh[GPT_MLP_MAX_H][36], db2[GPT_MLP_MAX_H];
  for (int g = 0; g < d.g2; ++g) {
    float small[GPT_MLP_MAX_A * 2 + 4] = {0.0f};
    for (int j = 0; j < d.H2; ++j) {
      db2[j] = 0.0f;
      for (int a = 0; a < A1P; ++a) dwh[j][a] = 0.0f;
    }
    for (int tile = g; tile < d.nb2; tile += d.g2) {
      const int row0 = tile * GPT_MLP_R2;
      for (int r = 0; r < GPT_MLP_R2; ++r)
        for (int j = 0; j < d.T2; ++j)
          h2[r][j] = (j < d.H2 && row0 + r < d.M)
                         ? tanhf(p.z2[(long long)(row0 + r) * d.H2 + j] + p.b2[j]) : 0.0f;
      // the heads, as the device's slices of 32 units summed in order
      for (int r = 0; r < GPT_MLP_R2; ++r)
        for (int a = 0; a < d.A1; ++a) {
          float y = 0.0f;
          for (int s = 0; s < d.T2 / 32; ++s) {
            float acc = 0.0f;
            for (int j = 32 * s; j < 32 * s + 32; ++j) {
              const float w = j >= d.H2 ? 0.0f : a < d.A ? p.Wm[a * d.H2 + j] : p.wv[j];
              acc = fmaf(h2[r][j], w, acc);
            }
            y += acc;
          }
          ys[r][a] = y + (a < d.A ? p.bm[a] : *p.bv);
        }
      for (int r = 0; r < GPT_MLP_R2; ++r) {
        const int row = row0 + r;
        RowTerms o = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int a = 0; a < A1P; ++a) dys[r][a] = dls[r][a] = 0.0f;
        if (row < d.M) {
          const long long i = p.idx[row];
          float lp = 0.0f;
          for (int a = 0; a < d.A; ++a)
            lp += lp_term(p.act[i * d.A + a], ys[r][a], var[a], two_ls[a], p.log_2pi, &dys[r][a],
                          &dls[r][a]);
          o = row_loss(lp, p.olp[i], p.adv[i], p.ret[i], ys[r][d.A], stats[0], stats[1],
                       p.adv_eps, 1.0f - clip, 1.0f + clip, -1.0f / mf, *p.vf / mf);
          for (int a = 0; a < d.A; ++a) row_grad(o.glp, var[a], &dys[r][a], &dls[r][a]);
        }
        dys[r][d.A] = o.dvalue;
        lt[r][0] = o.s;
        lt[r][1] = o.vsq;
        lt[r][2] = o.kl;
      }
      for (int j = 0; j < d.H2; ++j)
        for (int r = 0; r < GPT_MLP_R2; ++r) {
          float pre = 0.0f;
          for (int a = 0; a < A1P; ++a) {
            const float w = a > d.A ? 0.0f : a < d.A ? p.Wm[a * d.H2 + j] : p.wv[j];
            pre = fmaf(dys[r][a], w, pre);
            dwh[j][a] = fmaf(dys[r][a], h2[r][j], dwh[j][a]);
          }
          const float dz = pre * dtanh(h2[r][j]);
          if (row0 + r < d.M) p.dz2[(long long)(row0 + r) * d.H2 + j] = dz;
          db2[j] += dz;
        }
      for (int q = 0; q < NQ; ++q)
        for (int r = 0; r < GPT_MLP_R2; ++r)
          small[q] += q < d.A1          ? dys[r][q]
                      : q < d.A1 + d.A ? dls[r][q - d.A1]
                                       : lt[r][q - d.A1 - d.A];
    }
    float* part = p.part2 + (long long)g * d.L2;
    for (int j = 0; j < d.H2; ++j) {
      for (int a = 0; a < d.A1; ++a) part[a * d.H2 + j] = dwh[j][a];
      part[d.o_db2 + j] = db2[j];
    }
    for (int q = 0; q < NQ; ++q) part[d.o_dbh + q] = small[q];
  }
  return 0;
}

GPT_MLP_HOST(gpt_mlp_back_host)
  static float acc[GPT_MLP_MAX_H][GPT_MLP_MAX_D], db1[GPT_MLP_MAX_H];
  for (int g = 0; g < d.g3; ++g) {
    for (int j = 0; j < d.H1; ++j) {
      db1[j] = 0.0f;
      for (int k = 0; k < d.D; ++k) acc[j][k] = 0.0f;
    }
    for (int tile = g; tile < d.nb3; tile += d.g3) {
      const int row0 = tile * GPT_MLP_R3;
      for (int j = 0; j < d.H1; ++j)
        for (int r = 0; r < GPT_MLP_R3 && row0 + r < d.M; ++r) {
          const long long at = (long long)(row0 + r) * d.H1 + j;
          const float dz = p.dh1[at] * dtanh(p.h1[at]);
          db1[j] += dz;
          for (int k = 0; k < d.D; ++k) acc[j][k] = fmaf(dz, obs_at(d, p, row0 + r, k), acc[j][k]);
        }
    }
    float* part = p.part3 + (long long)g * d.L3;
    for (int j = 0; j < d.H1; ++j) {
      for (int k = 0; k < d.D; ++k) part[k * d.H1 + j] = acc[j][k];
      part[d.D * d.H1 + j] = db1[j];
    }
  }
  return 0;
}

// element e of the partial rows summed as the reduce kernel sums it: warp w
// over every GPT_MLP_RED_WARPS-th row from w, in row order, then the warps'
// sums in order
static double reduced(const float* part, int rows, int L, int e) {
  double tot = 0.0;
  for (int w = 0; w < GPT_MLP_RED_WARPS; ++w) {
    double acc = 0.0;
    for (int b = w; b < rows; b += GPT_MLP_RED_WARPS) acc += (double)part[(long long)b * L + e];
    tot += acc;
  }
  return tot;
}

GPT_MLP_HOST(gpt_mlp_reduce_host)
  float add;
  for (int e = 0; e < d.o_loss; ++e) {
    float* out = dest(d, p, 0, e, &add);
    *out = (float)reduced(p.part2, d.g2, d.L2, e) + add;
  }
  for (int e = 0; e < d.D * d.H1 + d.H1; ++e) {
    float* out = dest(d, p, 1, e, &add);
    *out = (float)reduced(p.part3, d.g3, d.L3, e) + add;
  }
  finish_losses(d, p, reduced(p.part2, d.g2, d.L2, d.o_loss),
                reduced(p.part2, d.g2, d.L2, d.o_loss + 1),
                reduced(p.part2, d.g2, d.L2, d.o_loss + 2));
  return 0;
}

#endif

// The scratch a minibatch needs, for the wrapper's allocations: out[0] the
// fwd kernel's float64 partials, out[1] and out[2] the head's and the back's
// float32 partials (one row per block).  Returns 0 for shapes the kernels do
// not take.
extern "C" int gpt_mlp_scratch(const int* dims, long long* out) {
  Dims d;
  if (!make_dims(dims, &d)) return 0;
  out[0] = 2LL * d.g1;
  out[1] = (long long)d.g2 * d.L2;
  out[2] = (long long)d.g3 * d.L3;
  return 1;
}
