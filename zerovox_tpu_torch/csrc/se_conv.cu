// Fused speaker-encoder stage-1 conv pass for Hopper (sm_90a), forward and
// backward, float32, canonical NCHW layout with C = 32 channels.
//
// Replaces the TPU kernels of zerovox_tpu/ops/pallas/se_fused.py::se_conv:
// _fwd_kernel (pallas_call in _fwd_call) and _bwd_kernel (pallas_call in
// _bwd_call). One pass of ResNetSE34V2 stage 1:
//
//   forward   u = x*s + t inside the image, 0 outside (padding in u-space:
//             the affine is applied first, then the SAME conv pads u with
//             zeros, so a t != 0 never leaks into the border)
//             y = relu?(conv3x3(u)); sum[c] = S y, sq[c] = S y^2 over
//             (b, h, w); m[b, c] = S y over (h, w)
//   backward  g  = (dy + dsum[c] + 2 y dsq[c] + dm[b, c]) * relu'(y)
//             du = conv3x3 of g with the flipped, transposed taps (dgrad)
//             dx = du*s; ds = S du*x; dt = S du; dW = S g (x) u_shifted
//
// What bounds it on an H100: arithmetic. At the training shape
// [24, 32, 80, 500] the forward does 17.7 GFLOP against 246 MB (72 FLOP per
// byte, above the card's ~20 FLOP/byte float32 ridge), the backward twice
// the FLOPs against twice the bytes.
//
// Design, forward: persistent blocks of 256 threads walk tiles of 8 x 32
// output positions. A tile's input window (10 x 34 per channel, u-space
// padded) and all 32x32x9 taps sit in shared memory; each thread keeps a
// 4-row x 8-channel register tile, so a (channel, tap column) step is 6
// input loads and 6 float4 weight loads (warp-broadcast) for 96 FMAs. The
// epilogue writes y once and reduces the tile's per-channel sums in a fixed
// order into a per-tile row; a second one-block pass sums the rows in a
// fixed order (per sample for m, then over samples), so the BN statistics
// are the same on every run, with no float atomics.
//
// Design, backward: one persistent pass. Per tile it builds the g window
// (with halo) and the u window in shared memory, then runs dgrad on the
// same register tiling as the forward (dx written once, ds/dt accumulated
// in registers) and wgrad with one thread per (input channel, 4 output
// channels): a sliding 3x3 window of u in registers, 7 shared loads per 36
// FMAs. Each block keeps its dW/ds/dt sums in registers across its tiles and
// writes one partial row; a second pass sums the rows in a fixed order.
#include <cuda_runtime.h>

namespace {

constexpr int C = 32;
constexpr int TH = 8, TW = 32;           // output tile
constexpr int HR = TH + 2, WR = TW + 2;  // tile window with a 1-pixel halo
constexpr int PL = 341;                  // window plane pitch: >= HR*WR, odd mod 32
constexpr int NT = 256;
constexpr int NTAP = C * C * 9;          // 9216 weights
constexpr int NPART = NTAP + 2 * C;      // per-block backward partial: dW, ds, dt

struct Shape {
  int B, H, W, nth, ntw, ntiles;
};

__device__ inline void tile_origin(const Shape& sh, int i, int* b, int* h0, int* w0) {
  *w0 = (i % sh.ntw) * TW;
  i /= sh.ntw;
  *h0 = (i % sh.nth) * TH;
  *b = i / sh.nth;
}

// u = x*s + t inside the image, 0 outside, for the tile's window.
__device__ inline void load_u_window(float* Us, const float* __restrict__ x,
                                     const float* __restrict__ s, const float* __restrict__ t,
                                     const Shape& sh, int b, int h0, int w0) {
  for (int idx = threadIdx.x; idx < C * HR * WR; idx += NT) {
    const int ci = idx / (HR * WR), rem = idx % (HR * WR);
    const int r = rem / WR, c = rem % WR;
    const int h = h0 + r - 1, w = w0 + c - 1;
    float v = 0.f;
    if ((unsigned)h < (unsigned)sh.H && (unsigned)w < (unsigned)sh.W)
      v = __ldg(x + (((size_t)b * C + ci) * sh.H + h) * sh.W + w) * __ldg(s + ci) + __ldg(t + ci);
    Us[ci * PL + r * WR + c] = v;
  }
}

// acc[r][k] = sum over (ci, kh, kw) of In[ci][4*rg + r + kh][lane + kw] *
// Wt[((ci*3 + kh)*3 + kw)*C + 8*og + k]: a 3x3 cross-correlation of the
// window for this thread's 4 rows x 8 output channels.
__device__ inline void conv_tile(const float* In, const float* Wt, int lane, int rg, int og,
                                 float acc[4][8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[r][k] = 0.f;
#pragma unroll 2
  for (int ci = 0; ci < C; ++ci) {
    const float* in = In + ci * PL + (4 * rg) * WR + lane;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      float v[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) v[j] = in[j * WR + kw];
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const float4* wp =
            reinterpret_cast<const float4*>(Wt + ((ci * 3 + kh) * 3 + kw) * C + 8 * og);
        const float4 a = wp[0], bq = wp[1];
        const float wv[8] = {a.x, a.y, a.z, a.w, bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[r][k] = fmaf(v[r + kh], wv[k], acc[r][k]);
      }
    }
  }
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------------ forward

__global__ void __launch_bounds__(NT, 2)
se_conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ s, const float* __restrict__ t,
                   float* __restrict__ y, float* __restrict__ part, Shape sh, int relu) {
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;           // [ci][kh][kw][co]
  float* Us = Ws + NTAP;      // [ci][HR][WR] at pitch PL
  float* red = Us + C * PL;   // [2 row groups][2][C]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int og = warp & 3, rg = warp >> 2;

  for (int i = threadIdx.x; i < NTAP; i += NT) {  // w[co][ci][kh][kw]
    const int co = i / (C * 9), rem = i % (C * 9);
    Ws[rem * C + co] = __ldg(w + i);
  }

  for (int tile = blockIdx.x; tile < sh.ntiles; tile += gridDim.x) {
    int b, h0, w0;
    tile_origin(sh, tile, &b, &h0, &w0);
    __syncthreads();  // the previous tile is done with Us and red
    load_u_window(Us, x, s, t, sh, b, h0, w0);
    __syncthreads();

    float acc[4][8];
    conv_tile(Us, Ws, lane, rg, og, acc);

    const int wq = w0 + lane;
    float s1[8], s2[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s1[k] = s2[k] = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h = h0 + 4 * rg + r;
      if (h < sh.H && wq < sh.W) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float v = relu ? fmaxf(acc[r][k], 0.f) : acc[r][k];
          y[(((size_t)b * C + 8 * og + k) * sh.H + h) * sh.W + wq] = v;
          s1[k] += v;
          s2[k] = fmaf(v, v, s2[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s1[k] = warp_sum(s1[k]);
      s2[k] = warp_sum(s2[k]);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        red[(rg * 2 + 0) * C + 8 * og + k] = s1[k];
        red[(rg * 2 + 1) * C + 8 * og + k] = s2[k];
      }
    }
    __syncthreads();
    if (threadIdx.x < 2 * C) {  // row [tile]: C sums, then C sums of squares
      const int q = threadIdx.x / C, c = threadIdx.x % C;
      part[(size_t)tile * 2 * C + threadIdx.x] = red[q * C + c] + red[(2 + q) * C + c];
    }
  }
}

// One block of (32 channels x 32 slices): m[b, c] = sum of sample b's tile
// rows, sum[c] = S_b m[b, c], sq[c] likewise; every order is fixed.
__global__ void se_conv_fwd_finish(const float* __restrict__ part, float* __restrict__ ssum,
                                   float* __restrict__ ssq, float* __restrict__ m, int B,
                                   int tiles_per_sample) {
  __shared__ float r1[32][C], r2[32][C];
  const int c = threadIdx.x, sl = threadIdx.y;
  float tot1 = 0.f, tot2 = 0.f;
  for (int b = 0; b < B; ++b) {
    float a1 = 0.f, a2 = 0.f;
    for (int j = sl; j < tiles_per_sample; j += 32) {
      const float* row = part + ((size_t)b * tiles_per_sample + j) * 2 * C;
      a1 += row[c];
      a2 += row[C + c];
    }
    r1[sl][c] = a1;
    r2[sl][c] = a2;
    __syncthreads();
    if (sl == 0) {
      float m1 = 0.f, m2 = 0.f;
      for (int k = 0; k < 32; ++k) {
        m1 += r1[k][c];
        m2 += r2[k][c];
      }
      m[(size_t)b * C + c] = m1;
      tot1 += m1;
      tot2 += m2;
    }
    __syncthreads();
  }
  if (sl == 0) {
    ssum[c] = tot1;
    ssq[c] = tot2;
  }
}

// ----------------------------------------------------------------- backward

__global__ void __launch_bounds__(NT, 1)
se_conv_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ dy, const float* __restrict__ w,
                   const float* __restrict__ s, const float* __restrict__ t,
                   const float* __restrict__ dsum, const float* __restrict__ dsq,
                   const float* __restrict__ dm, float* __restrict__ dx,
                   float* __restrict__ part, Shape sh, int relu) {
  extern __shared__ __align__(16) float smem[];
  float* Wd = smem;          // dgrad taps [co][kh'][kw'][ci] = w[co][ci][2-kh'][2-kw']
  float* Gs = Wd + NTAP;     // g window [co][HR][WR] at pitch PL
  float* Us = Gs + C * PL;   // u window [ci][HR][WR] at pitch PL
  float* red = Us + C * PL;  // [2 row groups][2][C]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int og = warp & 3, rg = warp >> 2;

  for (int i = threadIdx.x; i < NTAP; i += NT) {
    const int co = i / (C * 9), ci = (i / 9) % C, kh = (i % 9) / 3, kw = i % 3;
    Wd[((co * 3 + (2 - kh)) * 3 + (2 - kw)) * C + ci] = __ldg(w + i);
  }

  // wgrad: this thread owns dW[4*warp + j][lane][kh][kw]
  float dw[4][9];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 9; ++q) dw[j][q] = 0.f;
  // ds, dt of input channels 8*og + k, over this thread's positions
  float dsa[8], dta[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) dsa[k] = dta[k] = 0.f;

  for (int tile = blockIdx.x; tile < sh.ntiles; tile += gridDim.x) {
    int b, h0, w0;
    tile_origin(sh, tile, &b, &h0, &w0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < C * HR * WR; idx += NT) {
      const int co = idx / (HR * WR), rem = idx % (HR * WR);
      const int r = rem / WR, c = rem % WR;
      const int h = h0 + r - 1, wc = w0 + c - 1;
      float g = 0.f;
      if ((unsigned)h < (unsigned)sh.H && (unsigned)wc < (unsigned)sh.W) {
        const size_t o = (((size_t)b * C + co) * sh.H + h) * sh.W + wc;
        const float yv = __ldg(y + o);
        g = __ldg(dy + o) + __ldg(dsum + co) + 2.f * yv * __ldg(dsq + co) +
            __ldg(dm + (size_t)b * C + co);
        if (relu && !(yv > 0.f)) g = 0.f;
      }
      Gs[co * PL + r * WR + c] = g;
    }
    load_u_window(Us, x, s, t, sh, b, h0, w0);
    __syncthreads();

    // dgrad: du for input channels 8*og + k at rows 4*rg + r, column lane
    float acc[4][8];
    conv_tile(Gs, Wd, lane, rg, og, acc);
    const int wq = w0 + lane;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h = h0 + 4 * rg + r;
      if (h < sh.H && wq < sh.W) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int ci = 8 * og + k;
          const size_t o = (((size_t)b * C + ci) * sh.H + h) * sh.W + wq;
          const float du = acc[r][k];
          dx[o] = du * __ldg(s + ci);
          dsa[k] = fmaf(du, __ldg(x + o), dsa[k]);
          dta[k] += du;
        }
      }
    }

    // wgrad over the tile's positions (g is 0 outside the image)
    const float* ub = Us + lane * PL;
    const float* gb = Gs + (4 * warp) * PL;
#pragma unroll 1
    for (int r = 0; r < TH; ++r) {
      float u0[3], u1[3], u2[3];  // window columns c, c+1, c+2 of rows r..r+2
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        u0[kh] = ub[(r + kh) * WR + 0];
        u1[kh] = ub[(r + kh) * WR + 1];
      }
#pragma unroll 4
      for (int c = 0; c < TW; ++c) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) u2[kh] = ub[(r + kh) * WR + c + 2];
        const int gp = (r + 1) * WR + c + 1;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float g = gb[j * PL + gp];
#pragma unroll
          for (int kh = 0; kh < 3; ++kh) {
            dw[j][kh * 3 + 0] = fmaf(g, u0[kh], dw[j][kh * 3 + 0]);
            dw[j][kh * 3 + 1] = fmaf(g, u1[kh], dw[j][kh * 3 + 1]);
            dw[j][kh * 3 + 2] = fmaf(g, u2[kh], dw[j][kh * 3 + 2]);
          }
        }
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          u0[kh] = u1[kh];
          u1[kh] = u2[kh];
        }
      }
    }
  }

  // this block's partial row: dW in w's layout [co][ci][kh][kw], then ds, dt
  float* row = part + (size_t)blockIdx.x * NPART;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 9; ++q) row[((4 * warp + j) * C + lane) * 9 + q] = dw[j][q];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    dsa[k] = warp_sum(dsa[k]);
    dta[k] = warp_sum(dta[k]);
  }
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      red[(rg * 2 + 0) * C + 8 * og + k] = dsa[k];
      red[(rg * 2 + 1) * C + 8 * og + k] = dta[k];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * C) {
    const int q = threadIdx.x / C, c = threadIdx.x % C;
    row[NTAP + threadIdx.x] = red[q * C + c] + red[(2 + q) * C + c];
  }
}

// out[i] = S over blocks of part[blk][i], in block order.
__global__ void se_conv_bwd_finish(const float* __restrict__ part, float* __restrict__ out,
                                   int nblocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NPART) return;
  float a = 0.f;
  for (int k = 0; k < nblocks; ++k) a += part[(size_t)k * NPART + i];
  out[i] = a;
}

Shape make_shape(int B, int H, int W) {
  Shape sh;
  sh.B = B;
  sh.H = H;
  sh.W = W;
  sh.nth = (H + TH - 1) / TH;
  sh.ntw = (W + TW - 1) / TW;
  sh.ntiles = B * sh.nth * sh.ntw;
  return sh;
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

constexpr size_t FWD_SMEM = (size_t)(NTAP + C * PL + 4 * C) * sizeof(float);
constexpr size_t BWD_SMEM = (size_t)(NTAP + 2 * C * PL + 4 * C) * sizeof(float);

}  // namespace

extern "C" {

// Rows of scratch the forward needs: one per tile, 2*C floats each.
int zv_se_conv_fwd_tiles(int B, int H, int W) { return make_shape(B, H, W).ntiles; }

// Blocks of the backward pass: its scratch holds NPART floats per block.
int zv_se_conv_bwd_blocks(int B, int H, int W) {
  const int n = make_shape(B, H, W).ntiles, g = sm_count();
  return n < g ? n : g;
}

// x, y [B, 32, H, W]; w [32, 32, 3, 3]; s, t [32]; ssum, ssq [32]; m [B, 32];
// part: zv_se_conv_fwd_tiles(B, H, W) * 64 floats of scratch.
int zv_se_conv_fwd_f32(const float* x, const float* w, const float* s, const float* t,
                       float* y, float* ssum, float* ssq, float* m, float* part, int B, int H,
                       int W, int relu, void* stream) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(B, H, W);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(se_conv_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  int grid = 2 * sm_count();
  if (grid > sh.ntiles) grid = sh.ntiles;
  se_conv_fwd_kernel<<<grid, NT, FWD_SMEM, st>>>(x, w, s, t, y, part, sh, relu);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  se_conv_fwd_finish<<<1, dim3(C, 32), 0, st>>>(part, ssum, ssq, m, B, sh.nth * sh.ntw);
  return (int)cudaGetLastError();
}

// x, y, dy, dx [B, 32, H, W]; w [32, 32, 3, 3]; s, t, dsum, dsq [32];
// dm [B, 32]; out: dW (9216) then ds (32) then dt (32);
// part: zv_se_conv_bwd_blocks(B, H, W) * 9280 floats of scratch.
int zv_se_conv_bwd_f32(const float* x, const float* y, const float* dy, const float* w,
                       const float* s, const float* t, const float* dsum, const float* dsq,
                       const float* dm, float* dx, float* out, float* part, int B, int H,
                       int W, int relu, void* stream) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(B, H, W);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(se_conv_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = zv_se_conv_bwd_blocks(B, H, W);
  se_conv_bwd_kernel<<<grid, NT, BWD_SMEM, st>>>(x, y, dy, w, s, t, dsum, dsq, dm, dx, part,
                                                 sh, relu);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  se_conv_bwd_finish<<<(NPART + 255) / 256, 256, 0, st>>>(part, out, grid);
  return (int)cudaGetLastError();
}

}  // extern "C"
