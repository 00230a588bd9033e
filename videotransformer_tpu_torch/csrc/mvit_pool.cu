// MViT's pooling convolutions, forward and backward, for Hopper (sm_90a):
// the q, k and v pools of one attention block in one call each way.
//
// A pool is pytorchvideo's depthwise Conv3d(C, C, k, s, k // 2, groups=C,
// bias=False) whose (head_dim, 1, kT, kH, kW) weight is tiled over the
// heads (models/mvit.py::MultiScaleAttention). It replaces no TPU kernel:
// the JAX package left these convolutions to XLA, outside Pallas. On the
// card cuDNN ran them as one launch a channel on a permuted copy of each
// slice, with NHWC <-> NCHW transposes around a non-tensor-core grouped
// path (26k launches and ~280 ms a MaskFeat step at 32 clips).
//
// The kernels work on the token layout the block holds: the input is Q's,
// K's or V's C columns of the fused qkv activation (B, L, 3C), L = T·H·W
// rows of 3C, read in place with its row stride; a pooled output is (B,
// T'·H'·W', C) contiguous token rows. A thread owns 8 channels (16 bytes)
// of a run of tokens; the weight, rounded to bf16 (the working type, as
// weight.to(x.dtype) did), sits in shared memory as [tap][head_dim] and is
// indexed by c mod head_dim, so it is never tiled. Every sum is fp32 in a
// fixed order, with no atomics, so a step repeats to the bit:
//
//   forward   y[o, c] = bf16(sum over the window's taps in (t, h, w)
//             row-major order of x[tap(o), c] · w[c mod hd, tap])
//   dgrad     dx[i, c] = bf16(sum over the windows covering i, by output
//             frame and then (h, w) row-major, of dy[o, c] · w[c mod hd,
//             tap]); 0 where no window reaches. One launch writes all 3C
//             columns of d_qkv once: a slice without a pool copies its
//             gradient.
//   wgrad     dw[j, tap] = sum over a fixed range of output tokens (a chunk)
//             and over the heads of dy[o, c] · x[tap(o), c] (c mod hd = j):
//             fp32 partials a chunk, added in chunk order by another launch.
//
// Bound: bytes. The FLOPs are 2·taps a channel of an output, ~2 GFLOP a
// MaskFeat step at 32 clips; the bytes are the input positions the windows
// read and the outputs, and in the backward the whole d_qkv, the output
// gradients and those input positions again: ~3.0 ms a step at 3.35 TB/s,
// each byte counted once. The rows are read in place (no transposes, no
// copies). The loads are gathers that a thread issues a few at a time, so
// what holds the kernels back is load latency at the occupancy their
// registers allow: on an H100 they take ~11 ms of a MaskFeat step at 32
// clips, a quarter of the bound's speed (PERF.md). A forward or dgrad
// thread owns a run of frames at one (h, w) and loads each row its run's
// windows share once for all of them (where T is pooled at stride 1, as in
// MViT's schedules, neighbouring frames share most rows); a wgrad thread owns
// three taps along t and loads each dy row once for them. A block loads its
// weight table once and walks its runs grid-stride; grid indices are
// divided out once a run. Launches: one forward and three backward (d_qkv,
// the wgrad partials, their sum) for a block's three pools.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace vt {

using bf16 = __nv_bfloat16;

constexpr int kJobs = 3;             // q, k, v
constexpr int kRowThreads = 384;     // threads a block aims at
constexpr int kSumThreads = 1024;
constexpr int kFwdRunT = 2;          // output frames a forward run holds
constexpr int kDgradRunT = 2;        // input frames a dgrad run holds
constexpr int kMaxSmem = 232448;     // an H100 block's shared memory
constexpr long long kWgradThreads = 1 << 18;  // wgrad threads aimed at a job
constexpr int kMinChunk = 64;                 // tokens a wgrad chunk, at least

enum Mode { kCopy = 1, kPool = 2 };

struct Job {
  int mode;
  int kT, kH, kW, sT, sH, sW, pT, pH, pW;
  int To, Ho, Wo, taps;
  int npos;  // output tokens, B · T'·H'·W'
  int fwd_block0, fwd_blocks, dg_block0, dg_blocks;
  int chunk, chunks, ty, groups;  // wgrad: tokens a chunk, chunks, window
                                  // positions a block, blocks a chunk
  int wg_block0;
  int partial0;  // this job's first fp32 partial
  const float* w;  // (hd, taps) fp32 parameter
  const bf16* dy;  // (B, T'·H'·W', C); for kCopy (B, L, C)
  bf16* out;       // (B, T'·H'·W', C)
  float* dw;       // (hd, taps) fp32
};

struct Args {
  const bf16* qkv;
  bf16* dqkv;
  float* partial;
  int B, T, H, W, C, hd, L, cv;  // cv = C / 8
  int rows;  // runs a forward or dgrad block, cv threads each
  Job job[kJobs];
  int fwd_blocks, dg_blocks, wg_blocks, wg_threads, smem, smem_wgrad,
      max_taps, partial_floats;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// acc[e] += x[e] · w[e], e < 8 (the bf16 products are exact in fp32)
__device__ __forceinline__ void fma8(float* acc, uint4 xv, const float* w) {
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
  const float4 w0 = *reinterpret_cast<const float4*>(w);
  const float4 w1 = *reinterpret_cast<const float4*>(w + 4);
  const float ws[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(x2[e]);
    acc[2 * e] = fmaf(f.x, ws[2 * e], acc[2 * e]);
    acc[2 * e + 1] = fmaf(f.y, ws[2 * e + 1], acc[2 * e + 1]);
  }
}

__device__ __forceinline__ void fma8(float* acc, uint4 av, uint4 bv) {
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&av);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bv);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 fa = __bfloat1622float2(a2[e]);
    const float2 fb = __bfloat1622float2(b2[e]);
    acc[2 * e] = fmaf(fa.x, fb.x, acc[2 * e]);
    acc[2 * e + 1] = fmaf(fa.y, fb.y, acc[2 * e + 1]);
  }
}

__device__ __forceinline__ uint4 pack8(const float* acc) {
  uint4 o;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    o2[e] = __floats2bfloat162_rn(acc[2 * e], acc[2 * e + 1]);
  return o;
}

// The (hd, taps) fp32 weight as a [tap][hd] table of bf16-rounded floats.
__device__ __forceinline__ void load_weight(float* table, const float* w,
                                            int taps, int hd) {
  for (int idx = threadIdx.x; idx < taps * hd; idx += blockDim.x) {
    const int i = idx / taps, tap = idx - i * taps;
    table[tap * hd + i] = bf16_round(w[idx]);
  }
}

// A token's place on a (B, T, H, W) grid, carried to the next token.
struct Walk {
  int b, t, h, w;
  __device__ __forceinline__ Walk(int p, int T, int H, int W) {
    w = p % W;
    p /= W;
    h = p % H;
    p /= H;
    t = p % T;
    b = p / T;
  }
  // returns the outermost axis that moved: 0 w, 1 h, 2 t, 3 b
  __device__ __forceinline__ int next(int T, int H, int W) {
    if (++w < W) return 0;
    w = 0;
    if (++h < H) return 1;
    h = 0;
    if (++t < T) return 2;
    t = 0;
    ++b;
    return 3;
  }
};

// The job whose block range holds `bid`: `end(job)` is one past its last.
template <typename End>
__device__ __forceinline__ int job_of(const Args& a, int bid, End end) {
  int j = 0;
  while (j < kJobs - 1 && !(a.job[j].mode == kPool && bid < end(a.job[j])))
    ++j;
  return j;
}

// ---------------------------------------------------------------- forward

// Blocks of rows runs, cv threads a run; a run is kFwdRunT consecutive
// output frames at one (clip, h', w'): each input row its windows read is
// loaded once for the run and added into every output of the run whose
// window holds it. A job's blocks walk its runs grid-stride.
__global__ void __launch_bounds__(kRowThreads)
    mvit_pool_fwd(const __grid_constant__ Args a) {
  extern __shared__ float table[];
  const int j = job_of(a, blockIdx.x, [](const Job& jb) {
    return jb.fwd_block0 + jb.fwd_blocks;
  });
  const Job jb = a.job[j];
  const int hd = a.hd, C = a.C, cv = a.cv;
  load_weight(table, jb.w, jb.taps, hd);
  __syncthreads();
  const int run = threadIdx.x / cv, c0 = (threadIdx.x - run * cv) * 8;
  const long long row = 3LL * C;
  const bf16* x0 = a.qkv + j * C + c0;
  const float* wt = table + c0 % hd;
  const int nT = (jb.To + kFwdRunT - 1) / kFwdRunT;
  const int runs = jb.npos / jb.To * nT;
  for (int r = (blockIdx.x - jb.fwd_block0) * a.rows + run; r < runs;
       r += jb.fwd_blocks * a.rows) {
    int s = r / nT;
    const int to0 = (r - s * nT) * kFwdRunT, nto = min(kFwdRunT, jb.To - to0);
    const int wo = s % jb.Wo;
    s /= jb.Wo;
    const int ho = s % jb.Ho, b = s / jb.Ho;
    const bf16* xb = x0 + (long long)b * a.L * row;
    const int h0 = ho * jb.sH - jb.pH, w0 = wo * jb.sW - jb.pW;
    const int ti0 = max(to0 * jb.sT - jb.pT, 0);
    const int ti1 = min((to0 + nto - 1) * jb.sT - jb.pT + jb.kT, a.T);
    float acc[kFwdRunT][8] = {};
    // input frames in order, then the window's rows and three taps of a
    // row at a time: each output adds its taps in (t, h, w) row-major order
    for (int ti = ti0; ti < ti1; ++ti) {
      for (int kh = 0; kh < jb.kH; ++kh) {
        const int hi = h0 + kh;
        if (hi < 0 || hi >= a.H) continue;
        const bf16* xr = xb + ((long long)ti * a.H + hi) * a.W * row;
        for (int kw0 = 0; kw0 < jb.kW; kw0 += 3) {
          uint4 xv[3];
#pragma unroll
          for (int u = 0; u < 3; ++u) {
            const int wi = w0 + kw0 + u;
            xv[u] = (kw0 + u < jb.kW && wi >= 0 && wi < a.W)
                        ? load16(xr + (long long)wi * row)
                        : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
          for (int k = 0; k < kFwdRunT; ++k) {
            const int kt = ti - (to0 + k) * jb.sT + jb.pT;
            if (k >= nto || kt < 0 || kt >= jb.kT) continue;
            const float* wr = wt + ((kt * jb.kH + kh) * jb.kW + kw0) * hd;
#pragma unroll
            for (int u = 0; u < 3; ++u)
              if (kw0 + u < jb.kW) fma8(acc[k], xv[u], wr + u * hd);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kFwdRunT; ++k)
      if (k < nto)
        *reinterpret_cast<uint4*>(
            jb.out + ((((long long)b * jb.To + to0 + k) * jb.Ho + ho) *
                          jb.Wo + wo) * C + c0) = pack8(acc[k]);
  }
}

// --------------------------------------------------------------- backward

// One axis of an input token for the dgrad: the windows covering index i
// are those at taps k = r, r + s, ... (< kernel) with outputs o = q, q - 1,
// ... (0 <= o < out), r and q the remainder and quotient of i + pad by s.
struct Phase {
  int r, q;
  __device__ __forceinline__ Phase(int i, int pad, int s)
      : r((i + pad) % s), q((i + pad) / s) {}
};

// d_qkv, a slice's C columns a block range: blocks of rows runs, cv
// threads a run, grid-stride over the slice's runs; a run is kDgradRunT
// consecutive input frames at one (clip, h, w), and each output gradient
// row of the windows covering them is loaded once for the run. A slice
// without a pool copies its gradient.
__global__ void __launch_bounds__(kRowThreads, 3)
    mvit_pool_dgrad(const __grid_constant__ Args a) {
  extern __shared__ float table[];
  int j = 0;
  while (j < kJobs - 1 &&
         (int)blockIdx.x >= a.job[j].dg_block0 + a.job[j].dg_blocks)
    ++j;
  const Job jb = a.job[j];
  const int C = a.C, cv = a.cv, hd = a.hd;
  if (jb.mode == kPool) load_weight(table, jb.w, jb.taps, hd);
  __syncthreads();
  const int run = threadIdx.x / cv, c0 = (threadIdx.x - run * cv) * 8;
  const long long row = 3LL * C;
  bf16* dx = a.dqkv + j * C + c0;
  const float* wt = table + c0 % hd;
  const int nT = (a.T + kDgradRunT - 1) / kDgradRunT;
  const int runs = a.B * a.H * a.W * nT;
  const long long frame = (long long)a.H * a.W;
  for (int r = (blockIdx.x - jb.dg_block0) * a.rows + run; r < runs;
       r += jb.dg_blocks * a.rows) {
    int s = r / nT;
    const int t0 = (r - s * nT) * kDgradRunT, nt = min(kDgradRunT, a.T - t0);
    const int w = s % a.W;
    s /= a.W;
    const int h = s % a.H, b = s / a.H;
    // token (b, t0 + k, h, w) of the (B, L) rows
    const long long p0 = ((long long)b * a.T + t0) * frame + h * a.W + w;
    if (jb.mode == kCopy) {
#pragma unroll
      for (int k = 0; k < kDgradRunT; ++k)
        if (k < nt)
          *reinterpret_cast<uint4*>(dx + (p0 + k * frame) * row) =
              load16(jb.dy + (p0 + k * frame) * C + c0);
      continue;
    }
    const Phase ph(h, jb.pH, jb.sH), pw(w, jb.pW, jb.sW);
    // the output frames whose windows reach an input frame of the run
    const int lo = t0 + jb.pT - jb.kT + 1;
    const int to0 = lo <= 0 ? 0 : (lo + jb.sT - 1) / jb.sT;
    const int to1 = min((t0 + nt - 1 + jb.pT) / jb.sT + 1, jb.To);
    const bf16* dyb =
        jb.dy + (long long)b * jb.To * jb.Ho * jb.Wo * C + c0;
    float acc[kDgradRunT][8] = {};
    // output frames in order, then the covering windows by (h, w): a fixed
    // order for every input token
    for (int to = to0; to < to1; ++to) {
      for (int kh = ph.r, ho = ph.q; kh < jb.kH && ho >= 0;
           kh += jb.sH, --ho) {
        if (ho >= jb.Ho) continue;
        for (int kw = pw.r, wo = pw.q; kw < jb.kW && wo >= 0;
             kw += jb.sW, --wo) {
          if (wo >= jb.Wo) continue;
          const uint4 g = load16(
              dyb + (((long long)to * jb.Ho + ho) * jb.Wo + wo) * C);
#pragma unroll
          for (int k = 0; k < kDgradRunT; ++k) {
            const int kt = t0 + k + jb.pT - to * jb.sT;
            if (k < nt && kt >= 0 && kt < jb.kT)
              fma8(acc[k], g, wt + ((kt * jb.kH + kh) * jb.kW + kw) * hd);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kDgradRunT; ++k)
      if (k < nt)
        *reinterpret_cast<uint4*>(dx + (p0 + k * frame) * row) =
            pack8(acc[k]);
  }
}

// acc[e] += g[e] · x[e], e < 8, g already in fp32
__device__ __forceinline__ void fma8(float* acc, const float* g, uint4 xv) {
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(x2[e]);
    acc[2 * e] = fmaf(g[2 * e], f.x, acc[2 * e]);
    acc[2 * e + 1] = fmaf(g[2 * e + 1], f.y, acc[2 * e + 1]);
  }
}

// One chunk of output tokens and one group of a job's window positions
// (kh, kw, three taps along t): each thread (8 channels, one position) sums
// dy · x over the chunk in token order for its up to three taps, loading
// each dy row once; the block adds its heads in order into the chunk's fp32
// partial [tap][hd].
__global__ void __launch_bounds__(kRowThreads)
    mvit_pool_wgrad(const __grid_constant__ Args a) {
  extern __shared__ float red[];
  const int bid = blockIdx.x;
  const int j = job_of(a, bid, [](const Job& jb) {
    return jb.wg_block0 + jb.chunks * jb.groups;
  });
  const Job jb = a.job[j];
  const int local = bid - jb.wg_block0;
  const int chunk = local / jb.groups, group = local - chunk * jb.groups;
  const int C = a.C, cv = a.cv, hd = a.hd;
  const int ty = threadIdx.x / cv, c0 = (threadIdx.x - ty * cv) * 8;
  const int ktg = (jb.kT + 2) / 3;  // groups of three taps along t
  const int pos = group * jb.ty + ty;  // (kh, kw, t group)
  const bool active = ty < jb.ty && pos < jb.kH * jb.kW * ktg;
  const int kw = pos % jb.kW, kh = pos / jb.kW % jb.kH;
  const int kt0 = pos / (jb.kW * jb.kH) * 3;
  float acc[3][8] = {};
  if (active) {
    const long long row = 3LL * C;
    int q = chunk * jb.chunk;
    const int q1 = min(q + jb.chunk, jb.npos);
    const bf16* x0 = a.qkv + j * C + c0;
    const bf16* g0 = jb.dy + c0;
    Walk o(q, jb.To, jb.Ho, jb.Wo);
    // the input row under tap (kt0, kh, kw) and whether its h and w lie
    // inside the grid (outside: zero padding)
    int ti = o.t * jb.sT - jb.pT + kt0, hi = o.h * jb.sH - jb.pH + kh,
        wi = o.w * jb.sW - jb.pW + kw;
    bool hv = hi >= 0 && hi < a.H;
    for (; q < q1; ++q) {
      if (hv && wi >= 0 && wi < a.W) {
        uint4 xv[3];
        const long long xrow =
            ((long long)o.b * a.T + ti) * a.H * a.W + hi * a.W + wi;
#pragma unroll
        for (int u = 0; u < 3; ++u)
          xv[u] = kt0 + u < jb.kT && ti + u >= 0 && ti + u < a.T
                      ? load16(x0 + (xrow + u * a.H * a.W) * row)
                      : make_uint4(0, 0, 0, 0);
        const uint4 gv = load16(g0 + (long long)q * C);
        float g[8];
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(g2[e]);
          g[2 * e] = f.x, g[2 * e + 1] = f.y;
        }
#pragma unroll
        for (int u = 0; u < 3; ++u) fma8(acc[u], g, xv[u]);
      }
      const int moved = o.next(jb.To, jb.Ho, jb.Wo);
      if (moved == 0) {
        wi += jb.sW;
      } else {
        wi = kw - jb.pW;
        if (moved == 1) {
          hi += jb.sH;
        } else {
          hi = kh - jb.pH;
          ti = moved == 2 ? ti + jb.sT : kt0 - jb.pT;
        }
        hv = hi >= 0 && hi < a.H;
      }
    }
  }
  if (ty < jb.ty) {
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[(ty * 3 + u) * C + c0 + e] = acc[u][e];
  }
  __syncthreads();
  const int heads = C / hd;
  for (int idx = threadIdx.x; idx < jb.ty * 3 * hd; idx += blockDim.x) {
    const int tu = idx / hd, i = idx - tu * hd;
    const int t2 = tu / 3, u = tu - t2 * 3;
    const int p2 = group * jb.ty + t2;
    const int kt = p2 / (jb.kW * jb.kH) * 3 + u;
    if (p2 >= jb.kH * jb.kW * ktg || kt >= jb.kT) continue;
    const int tap = (kt * jb.kH + p2 / jb.kW % jb.kH) * jb.kW + p2 % jb.kW;
    float s = 0.f;
    for (int h = 0; h < heads; ++h) s += red[tu * C + h * hd + i];
    a.partial[jb.partial0 + (chunk * jb.taps + tap) * hd + i] = s;
  }
}

// dw[i, tap] = the chunks' partials added in chunk order: a block a (job,
// tap), threads (i, g) over the chunks g, g + G, ..., then g in order.
__global__ void __launch_bounds__(kSumThreads)
    mvit_pool_wgrad_sum(const __grid_constant__ Args a) {
  __shared__ float red[kSumThreads];
  const Job& jb = a.job[blockIdx.y];
  const int tap = blockIdx.x;
  if (jb.mode != kPool || tap >= jb.taps) return;
  const int hd = a.hd, G = blockDim.x / hd;
  const int i = threadIdx.x % hd, g = threadIdx.x / hd;
  if (g < G) {
    float s = 0.f;
    const float* p = a.partial + jb.partial0 + tap * hd + i;
    for (int c = g; c < jb.chunks; c += G) s += p[c * jb.taps * hd];
    red[g * hd + i] = s;
  }
  __syncthreads();
  if (g == 0) {
    float s = 0.f;
    for (int k = 0; k < G; ++k) s += red[k * hd + i];
    jb.dw[i * jb.taps + tap] = s;
  }
}

// ------------------------------------------------------------------- host

static long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// geom: B, T, H, W, C, hd, then for q, k, v: mode, kT, kH, kW, sT, sH, sW.
// Fills the grids and the launch plan; false for a geometry the kernels do
// not take (kernels/mvit_pool.py::check_geometry says the same in Python).
static bool plan(const int* g, Args* a) {
  *a = Args{};
  const int B = g[0], T = g[1], H = g[2], W = g[3], C = g[4], hd = g[5];
  if (B < 1 || T < 1 || H < 1 || W < 1 || C < 8 || hd < 8 || C % 8 ||
      hd % 8 || C % hd || C / 8 > kRowThreads || hd > kSumThreads)
    return false;
  // tokens and 16-byte vectors are indexed in 32 bits; an output grid is at
  // most the input's plus one a side (even kernels)
  if ((long long)B * (T + 1) * (H + 1) * (W + 1) * 3 * (C / 8) >= 0x7fffffffLL)
    return false;
  a->B = B, a->T = T, a->H = H, a->W = W, a->C = C, a->hd = hd;
  a->L = T * H * W;
  a->cv = C / 8;
  a->rows = std::max(1, kRowThreads / a->cv);
  const long long dg_runs = (long long)B * H * W * cdiv(T, kDgradRunT);
  long long partial = 0;
  for (int j = 0; j < kJobs; ++j) {
    const int* q = g + 6 + 7 * j;
    Job& jb = a->job[j];
    jb.mode = q[0];
    jb.dg_block0 = a->dg_blocks;
    jb.dg_blocks = (int)cdiv(dg_runs, a->rows);
    a->dg_blocks += jb.dg_blocks;
    if (jb.mode == kCopy) continue;
    if (jb.mode != kPool) return false;
    jb.kT = q[1], jb.kH = q[2], jb.kW = q[3], jb.sT = q[4], jb.sH = q[5],
    jb.sW = q[6];
    if (jb.kT < 1 || jb.kH < 1 || jb.kW < 1 || jb.sT < 1 || jb.sH < 1 ||
        jb.sW < 1)
      return false;
    jb.pT = jb.kT / 2, jb.pH = jb.kH / 2, jb.pW = jb.kW / 2;
    jb.To = (T + 2 * jb.pT - jb.kT) / jb.sT + 1;
    jb.Ho = (H + 2 * jb.pH - jb.kH) / jb.sH + 1;
    jb.Wo = (W + 2 * jb.pW - jb.kW) / jb.sW + 1;
    jb.taps = jb.kT * jb.kH * jb.kW;
    jb.npos = B * jb.To * jb.Ho * jb.Wo;
    a->smem = (int)std::max<long long>(a->smem, (long long)jb.taps * hd * 4);
    jb.fwd_block0 = a->fwd_blocks;
    jb.fwd_blocks = (int)cdiv((long long)B * jb.Ho * jb.Wo *
                                  cdiv(jb.To, kFwdRunT), a->rows);
    a->fwd_blocks += jb.fwd_blocks;
    // wgrad: about kWgradThreads threads, a chunk of at least kMinChunk
    // tokens; the window positions (kh, kw, three taps along t) shared out
    // evenly over blocks of at most kRowThreads threads
    const int positions = jb.kH * jb.kW * (int)cdiv(jb.kT, 3);
    const long long chunks = std::max<long long>(
        1, kWgradThreads / ((long long)a->cv * positions));
    jb.chunk = (int)std::max<long long>(kMinChunk, cdiv(jb.npos, chunks));
    jb.chunks = (int)cdiv(jb.npos, jb.chunk);
    jb.groups = (int)cdiv(positions, std::max(1, kRowThreads / a->cv));
    jb.ty = (int)cdiv(positions, jb.groups);
    jb.wg_block0 = a->wg_blocks;
    a->wg_blocks += jb.chunks * jb.groups;
    jb.partial0 = (int)partial;
    partial += (long long)jb.chunks * jb.taps * hd;
    a->wg_threads = std::max(a->wg_threads, jb.ty * a->cv);
    a->max_taps = std::max(a->max_taps, jb.taps);
  }
  if (partial >= 0x7fffffffLL) return false;
  a->partial_floats = (int)partial;
  a->smem_wgrad = a->wg_threads * 3 * 8 * 4;
  return a->smem <= kMaxSmem;
}

template <typename K>
static cudaError_t smem_limit(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Blocks of `threads` threads and `smem` bytes that the card holds at once,
// asked once for each (kernel, threads, smem, device).
template <typename K>
static int resident(K kernel, int threads, int smem) {
  struct Seen {
    const void* kernel;
    int threads, smem, device, blocks;
  };
  static std::mutex mu;
  static Seen seen[64];
  static int count = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const void* k = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < count; ++i)
    if (seen[i].kernel == k && seen[i].threads == threads &&
        seen[i].smem == smem && seen[i].device == dev)
      return seen[i].blocks;
  int sms = 0, per = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads, smem);
  const int blocks = std::max(sms, 1) * std::max(per, 1);
  if (count < 64) seen[count++] = {k, threads, smem, dev, blocks};
  return blocks;
}

// At most `most` blocks over the jobs' block ranges `block0`/`blocks` (of
// jobs that `take`), shared out by what each asked for; each block walks
// its runs grid-stride, so it loads its weight table once.
template <typename Take>
static int share_blocks(Args* a, int most, int Job::*block0, int Job::*blocks,
                        Take take) {
  long long need = 0;
  for (int j = 0; j < kJobs; ++j)
    if (take(a->job[j])) need += a->job[j].*blocks;
  if (need <= most) return (int)need;
  int total = 0;
  for (int j = 0; j < kJobs; ++j) {
    Job& jb = a->job[j];
    if (!take(jb)) continue;
    jb.*block0 = total;
    jb.*blocks = (int)std::max<long long>(1, most * (jb.*blocks) / need);
    total += jb.*blocks;
  }
  return total;
}

static cudaError_t forward(Args& a, cudaStream_t st) {
  cudaError_t err = smem_limit(mvit_pool_fwd, a.smem);
  if (err != cudaSuccess) return err;
  const int threads = a.rows * a.cv;
  a.fwd_blocks = share_blocks(
      &a, 2 * resident(mvit_pool_fwd, threads, a.smem), &Job::fwd_block0,
      &Job::fwd_blocks, [](const Job& jb) { return jb.mode == kPool; });
  mvit_pool_fwd<<<a.fwd_blocks, threads, a.smem, st>>>(a);
  return cudaGetLastError();
}

static cudaError_t backward(Args& a, cudaStream_t st) {
  cudaError_t err = smem_limit(mvit_pool_dgrad, a.smem);
  if (err != cudaSuccess) return err;
  const int threads = a.rows * a.cv;
  a.dg_blocks = share_blocks(
      &a, 2 * resident(mvit_pool_dgrad, threads, a.smem), &Job::dg_block0,
      &Job::dg_blocks, [](const Job&) { return true; });
  mvit_pool_dgrad<<<a.dg_blocks, threads, a.smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.wg_blocks == 0) return err;
  mvit_pool_wgrad<<<a.wg_blocks, a.wg_threads, a.smem_wgrad, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int G = kSumThreads / a.hd;
  mvit_pool_wgrad_sum<<<dim3(a.max_taps, kJobs), G * a.hd, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace vt

extern "C" {

// qkv (B, L, 3C) bf16, 16-byte aligned; w_j the (hd, 1, kT, kH, kW) fp32
// weight and o_j the (B, T'·H'·W', C) bf16 output of each pooled slice
// (null for a slice without a pool). Returns a CUDA error code.
int vt_mvit_pool_fwd(const void* qkv, const int* geom, const void* w0,
                     const void* w1, const void* w2, void* o0, void* o1,
                     void* o2, void* stream) {
  vt::Args a;
  if (!vt::plan(geom, &a) || a.fwd_blocks == 0) return cudaErrorInvalidValue;
  const void* w[3] = {w0, w1, w2};
  void* o[3] = {o0, o1, o2};
  for (int j = 0; j < vt::kJobs; ++j) {
    if (a.job[j].mode != vt::kPool) continue;
    if (!w[j] || !o[j]) return cudaErrorInvalidValue;
    a.job[j].w = static_cast<const float*>(w[j]);
    a.job[j].out = static_cast<vt::bf16*>(o[j]);
  }
  a.qkv = static_cast<const vt::bf16*>(qkv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vt::forward(a, st);
}

// fp32 floats of the backward's scratch (the wgrad partials); -1 for a
// geometry the kernels do not take.
int vt_mvit_pool_scratch_floats(const int* geom) {
  vt::Args a;
  if (!vt::plan(geom, &a)) return -1;
  return a.partial_floats;
}

// dqkv (B, L, 3C) bf16 is written whole; dy_j the gradient of slice j's
// output ((B, T'·H'·W', C) for a pooled slice, (B, L, C) for one without a
// pool), contiguous bf16; w_j and dw_j (fp32, (hd, 1, kT, kH, kW)) of each
// pooled slice, null for one without; partial: the scratch.
int vt_mvit_pool_bwd(const void* qkv, void* dqkv, const int* geom,
                     const void* w0, const void* w1, const void* w2,
                     const void* dy0, const void* dy1, const void* dy2,
                     void* partial, void* dw0, void* dw1, void* dw2,
                     void* stream) {
  vt::Args a;
  if (!vt::plan(geom, &a)) return cudaErrorInvalidValue;
  const void* w[3] = {w0, w1, w2};
  const void* dy[3] = {dy0, dy1, dy2};
  void* dw[3] = {dw0, dw1, dw2};
  for (int j = 0; j < vt::kJobs; ++j) {
    if (!dy[j]) return cudaErrorInvalidValue;
    a.job[j].dy = static_cast<const vt::bf16*>(dy[j]);
    if (a.job[j].mode != vt::kPool) continue;
    if (!w[j] || !dw[j]) return cudaErrorInvalidValue;
    a.job[j].w = static_cast<const float*>(w[j]);
    a.job[j].dw = static_cast<float*>(dw[j]);
  }
  a.qkv = static_cast<const vt::bf16*>(qkv);
  a.dqkv = static_cast<vt::bf16*>(dqkv);
  a.partial = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vt::backward(a, st);
}

}  // extern "C"
