// Fused HiFi-GAN upsample stage for Hopper (sm_90a): leaky(0.1) ->
// ConvTranspose1d (stride s, padding p) -> mean of ResBlock1 towers, and on
// the last stage leaky(0.01) -> conv_post (C_out -> 1) -> tanh, float32 in
// and out, or bf16 in and out with float32 inside (zv_upsample_stage_bf16,
// bf16 inference). x [B, T_in, C_in] -> [B, T_out, C_out], or the waveform
// [B, T_out].
//
// Replaces the TPU kernel zerovox_tpu/ops/pallas/packed.py::
// fused_packed_stage (_packed_stage_kernel). The TPU kernel's lane packing
// and banded shift matrices only fill the TPU's 128-wide matrix unit; here
// the stage is computed directly in its own channel width.
//
// What bounds it on an H100: tensor-core operations. At the main path's
// shapes the 128 -> 64 stage does ~94 GFLOP and the 64 -> 32 stage with
// conv_post ~47 GFLOP, run by 3xTF32 as three times that in TF32 MMAs,
// against 45-68 MB of activations.
//
// Design: the tensor-core tile of mrf_tc.cuh (see mrf.cu), with the tower
// input produced in place: for each tower the tile's input rows (from L2
// after the first tower) are staged into buffer B with the leaky relu
// applied, and the transposed conv writes the upsampled window into A.
// The transposed conv is a polyphase GEMM on the same core: the output rows
// of phase ph = (t + p) mod s take only the taps ph, ph + s, ..., each a
// plain shift of the staged input, so each phase is one GEMM over every
// s-th output row (2 taps a row at the main path's k=4, s=2); the wrapper
// orders the taps by phase. Recomputing the upsampler per tower costs ~3%
// of the stage's arithmetic and saves a third window buffer. Without
// conv_post the tower sum is kept in the output rows the block owns; with
// it, the towers' mean is kept in shared memory over the tile plus
// conv_post's halo, and one warp per output sample reduces conv_post over
// taps and channels on the CUDA cores. The tile comes from the same cost
// model as mrf.cu's (halo recompute against wave fill), with the
// upsampler's GEMMs counted in.
//
// bf16 (zv_upsample_stage_bf16): the same stage in the bf16x2 arithmetic of
// mrf_bf16.cuh (bf16 mma.sync.m16n8k16, each activation as two bf16 terms,
// two MMAs a product): x widened and leaky'd when it is staged, and staged
// split, for the transposed conv's ldmatrix loads; the tower sum float32 (a
// scratch of the output's shape, or the shared buffer with conv_post),
// conv_post's weights widened, and only the stage's output rounded to bf16.
#include <type_traits>

#include "mrf_bf16.cuh"

namespace {

using zv::tc::NT;

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Input rows the transposed conv (kernel up_k, stride s) reads for W
// consecutive output rows.
__host__ __device__ inline int up_rows_in(int W, int up_k, int s) { return (W + up_k - 2) / s + 2; }

// Taps of phase ph: ph, ph + s, ... below up_k.
__host__ __device__ inline int phase_taps(int ph, int up_k, int s) {
  return ph < up_k ? (up_k - ph + s - 1) / s : 0;
}

// conv_post over the towers' mean, to the waveform: acc holds leaky(mean,
// 0.01) for window rows [HW - P, HW + TT + P) in rows of CO + 4 floats; a
// warp reduces one sample, lane l over channels l, l + 32, ... (at C_out of
// 8 and 16 the lanes past C_out add nothing).
template <int CO, class E>
__device__ void post_conv(const float* acc, const E* __restrict__ post_w,
                          const E* __restrict__ post_b, E* out, int post_k, int TT, int HW,
                          int tbase, int T_out) {
  constexpr int LD = CO + 4;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float pb = zv::ldg1(post_b);
  for (int r = HW + warp; r < HW + TT; r += NT / 32) {
    const int t = tbase + r;
    if ((unsigned)t >= (unsigned)T_out) continue;
    float y = 0.f;
    for (int tap = 0; tap < post_k; ++tap) {
      const float* a = acc + (r - HW + tap) * LD;
      const E* wt = post_w + tap * CO;
      for (int ci = lane; ci < CO; ci += 32) y = fmaf(a[ci], zv::ldg1(wt + ci), y);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) y += __shfl_xor_sync(0xffffffffu, y, s);
    if (lane == 0) zv::store1(out + (size_t)blockIdx.y * T_out + t, tanhf(y + pb));
  }
}

// The float32 kernel; without conv_post the tower sums are kept in out.
template <int CI, int CO>
__global__ void __launch_bounds__(NT, 1)
stage_kernel(const float* __restrict__ x, float* out, const float* __restrict__ up_w,
             const float* __restrict__ up_b, zv::MrfParams p, const float* __restrict__ post_w,
             const float* __restrict__ post_b, int T_in, int T_out, int up_k, int stride,
             int up_pad, int post_k, int TT, int HW, int bf_floats) {
  constexpr int LD = CO + 4;
  constexpr int LDI = CI + 4;
  extern __shared__ __align__(16) float smem[];
  const int W = TT + 2 * HW;
  const int P = post_k > 0 ? (post_k - 1) / 2 : 0;
  float* A = smem;
  float* Bf = A + W * LD;
  float* acc = Bf + bf_floats;
  const int b = blockIdx.y;
  const int tbase = blockIdx.x * TT - HW;
  const float* xb = x + (size_t)b * T_in * CI;

  auto load = [&](int lo, int hi) {
    // stage leaky(x) rows [i_min, i_max] into B
    const int i_min = floor_div(tbase + lo + up_pad - (up_k - 1), stride);
    const int i_max = floor_div(tbase + hi - 1 + up_pad, stride);
    constexpr int C4 = CI / 4;
    for (int idx = threadIdx.x; idx < (i_max - i_min + 1) * C4; idx += NT) {
      const int i = i_min + idx / C4, c = (idx % C4) * 4;
      zv::at4(Bf + (i - i_min) * LDI + c) =
          (unsigned)i < (unsigned)T_in ? zv::leaky4(zv::ldg4(xb + (size_t)i * CI + c), 0.1f)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    // transposed conv, torch semantics: out[t] += x[i] * w[tap] where
    // t = i * stride - up_pad + tap. Output row r of phase ph reads staged
    // row (t + up_pad - ph) / stride - j - i_min for its tap ph + stride j;
    // rows outside [0, T_out) stay zero
    const float* wph = up_w;
    for (int ph = 0; ph < stride; ++ph) {
      const int nt = phase_taps(ph, up_k, stride);
      const int r0 = lo + ((ph - (tbase + lo + up_pad)) % stride + stride) % stride;
      if (r0 < hi) {
        const zv::tc::Rows rw{(hi - r0 + stride - 1) / stride, r0, stride,
                              (tbase + r0 + up_pad - ph) / stride - i_min, 0, -1};
        zv::tc::conv_tc<CI, CO, false>(Bf, zv::tc::l2_weights(wph), up_b, nt, rw,
                                       [&](int r, int co, float2 v) {
          zv::tc::at2(A + r * LD + co) =
              (unsigned)(tbase + r) < (unsigned)T_out ? v : make_float2(0.f, 0.f);
        });
      }
      wph += (size_t)nt * CI * CO;
    }
  };

  zv::tc::mrf_tile<CO>(A, Bf, p, HW, TT, P, tbase, T_out, (size_t)b * T_out,
                       zv::tc::TileOut<float>{post_k > 0 ? nullptr : out, acc, 0.01f, out}, load);
  if (post_k > 0) post_conv<CO>(acc, post_w, post_b, out, post_k, TT, HW, tbase, T_out);
}

// The bf16 kernel (mrf_bf16.cuh): A of lda(C_out) floats a row, B of bf16
// rows (ldb(C_in) while x is staged, ldb(C_out) in the towers); sum: the
// float32 tower sums without conv_post.
template <int CI, int CO>
__global__ void __launch_bounds__(NT, 1)
stage_kernel_bf16(const zv::bf16* __restrict__ x, zv::bf16* out, float* sum,
                  const zv::bf16* __restrict__ up_w, const zv::bf16* __restrict__ up_b,
                  zv::MrfParamsT<zv::bf16> p, const zv::bf16* __restrict__ post_w,
                  const zv::bf16* __restrict__ post_b, int T_in, int T_out, int up_k, int stride,
                  int up_pad, int post_k, int TT, int HW, int bf_floats) {
  constexpr int LA = zv::bf16x2::lda(CO);
  constexpr int LBI = zv::bf16x2::ldb(CI);
  extern __shared__ __align__(16) float smem[];
  const int W = TT + 2 * HW;
  const int P = post_k > 0 ? (post_k - 1) / 2 : 0;
  float* A = smem;
  zv::bf16* Bs = reinterpret_cast<zv::bf16*>(A + W * LA);
  float* acc = A + W * LA + bf_floats;
  const int b = blockIdx.y;
  const int tbase = blockIdx.x * TT - HW;
  const zv::bf16* xb = x + (size_t)b * T_in * CI;

  auto load = [&](int lo, int hi) {
    // stage leaky(x) rows [i_min, i_max] into B, split
    const int i_min = floor_div(tbase + lo + up_pad - (up_k - 1), stride);
    const int i_max = floor_div(tbase + hi - 1 + up_pad, stride);
    constexpr int C4 = CI / 4;
    for (int idx = threadIdx.x; idx < (i_max - i_min + 1) * C4; idx += NT) {
      const int i = i_min + idx / C4, c = (idx % C4) * 4;
      const float4 v = (unsigned)i < (unsigned)T_in
                           ? zv::leaky4(zv::ldg4(xb + (size_t)i * CI + c), 0.1f)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      uint2 h, l;
      zv::bf16x2::split2(make_float2(v.x, v.y), h.x, l.x);
      zv::bf16x2::split2(make_float2(v.z, v.w), h.y, l.y);
      zv::bf16* row = Bs + (i - i_min) * LBI;
      *reinterpret_cast<uint2*>(row + c) = h;
      *reinterpret_cast<uint2*>(row + CI + c) = l;
    }
    __syncthreads();
    // the transposed conv as in stage_kernel
    const uint2* wph = reinterpret_cast<const uint2*>(up_w);
    for (int ph = 0; ph < stride; ++ph) {
      const int nt = phase_taps(ph, up_k, stride);
      const int r0 = lo + ((ph - (tbase + lo + up_pad)) % stride + stride) % stride;
      if (r0 < hi) {
        const zv::tc::Rows rw{(hi - r0 + stride - 1) / stride, r0, stride,
                              (tbase + r0 + up_pad - ph) / stride - i_min, 0, -1};
        zv::bf16x2::conv<CI, CO>(zv::bf16x2::ASplit<CI>{Bs}, zv::bf16x2::BL2{wph}, up_b, nt, rw,
                                 [&](int r, int co, float2 v) {
          zv::tc::at2(A + r * LA + co) =
              (unsigned)(tbase + r) < (unsigned)T_out ? v : make_float2(0.f, 0.f);
        });
      }
      wph += (size_t)nt * zv::bf16x2::k16(CI) * CO / 4;
    }
  };

  zv::bf16x2::mrf_tile<CO>(A, Bs, p, HW, TT, P, tbase, T_out, (size_t)b * T_out,
                           zv::tc::TileOut<zv::bf16>{post_k > 0 ? nullptr : out, acc, 0.01f, sum},
                           load);
  if (post_k > 0) post_conv<CO>(acc, post_w, post_b, out, post_k, TT, HW, tbase, T_out);
}

// A launch's geometry: the tile (zv::tc::choose_tile), the window's halo,
// the size of buffer B (floats) and the shared memory bytes.
struct Plan {
  int TT, HW, bf_floats, smem;
};

// float32: two windows of C + 4 floats a row, the cost in k-steps of 8;
// bf16: A of lda(C_out) floats a row and B of the same bytes as float32's,
// the cost in k-steps of 16.
template <int CI, int CO, class E>
int plan(const zv::MrfParamsT<E>& p, int B, int T_out, int up_k, int stride, int post_k,
         Plan* pl) {
  constexpr bool bf = std::is_same_v<E, zv::bf16>;
  constexpr int LD = CO + 4;
  constexpr int LDI = CI + 4;
  constexpr int LA = bf ? zv::bf16x2::lda(CO) : LD;
  constexpr int kstep = bf ? 16 : 8;
  const int P = post_k > 0 ? (post_k - 1) / 2 : 0;
  const int HW = zv::mrf_halo(p) + P;
  auto bf_floats = [&](int tt) {
    const int W = tt + 2 * HW;
    const int staged = up_rows_in(W, up_k, stride) * LDI;
    return W * LD > staged ? W * LD : staged;
  };
  auto smem_of = [&](int tt) {
    return 4L * ((long)(tt + 2 * HW) * LA + bf_floats(tt) + (P > 0 ? (long)(tt + 2 * P) * LD : 0));
  };
  auto cost_of = [&](int tt) {
    long up = 0;  // the upsampler, once per tower over the rows the tower reads
    for (int j = 0; j < p.n_towers; ++j) {
      const int rows = tt + 2 * P + 2 * zv::tower_halo(p.ks[j], p);
      for (int ph = 0; ph < stride; ++ph)
        up += zv::tc::gemm_rounds((rows + stride - 1) / stride, CO) * phase_taps(ph, up_k, stride);
    }
    return up * ((CI + kstep - 1) / kstep) + zv::tc::towers_cost(p, CO, tt, P, zv::tc::NWARP, kstep);
  };
  int sms = 0;
  const int e = zv::tc::sm_count(&sms);
  if (e != 0) return e;
  pl->TT = zv::tc::choose_tile(T_out, B, sms, smem_of, cost_of, &pl->smem);
  if (pl->TT == 0) return (int)cudaErrorInvalidConfiguration;
  pl->HW = HW;
  pl->bf_floats = bf_floats(pl->TT);
  return 0;
}

template <int CI, int CO, class E>
int launch(const E* x, E* out, float* sum, const E* up_w, const E* up_b,
           const zv::MrfParamsT<E>& p, const E* post_w, const E* post_b, int B, int T_in,
           int T_out, int up_k, int stride, int up_pad, int post_k, cudaStream_t s) {
  Plan pl{};
  int e = plan<CI, CO>(p, B, T_out, up_k, stride, post_k, &pl);
  if (e != 0) return e;
  dim3 grid((T_out + pl.TT - 1) / pl.TT, B);
  if constexpr (std::is_same_v<E, zv::bf16>) {
    e = (int)cudaFuncSetAttribute(stage_kernel_bf16<CI, CO>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (e != 0) return e;
    stage_kernel_bf16<CI, CO><<<grid, NT, pl.smem, s>>>(x, out, sum, up_w, up_b, p, post_w,
                                                         post_b, T_in, T_out, up_k, stride, up_pad,
                                                         post_k, pl.TT, pl.HW, pl.bf_floats);
  } else {
    e = (int)cudaFuncSetAttribute(stage_kernel<CI, CO>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (e != 0) return e;
    stage_kernel<CI, CO><<<grid, NT, pl.smem, s>>>(x, out, up_w, up_b, p, post_w, post_b, T_in,
                                                    T_out, up_k, stride, up_pad, post_k, pl.TT,
                                                    pl.HW, pl.bf_floats);
  }
  return (int)cudaGetLastError();
}

template <class E>
int tile_widths(const zv::MrfParamsT<E>& p, int B, int C_in, int C_out, int T_out, int up_k,
                int stride, int post_k) {
  Plan pl{};
  int e = (int)cudaErrorInvalidValue;
  if (C_in == 128 && C_out == 64) e = plan<128, 64>(p, B, T_out, up_k, stride, post_k, &pl);
  if (C_in == 64 && C_out == 32) e = plan<64, 32>(p, B, T_out, up_k, stride, post_k, &pl);
  if (C_in == 32 && C_out == 16) e = plan<32, 16>(p, B, T_out, up_k, stride, post_k, &pl);
  if (C_in == 16 && C_out == 8) e = plan<16, 8>(p, B, T_out, up_k, stride, post_k, &pl);
  return e != 0 ? -e : pl.TT;
}

template <class E>
int launch_widths(const E* x, E* out, float* sum, const E* up_w, const E* up_b,
                  const zv::MrfParamsT<E>& p, const E* post_w, const E* post_b, int B, int T_in,
                  int C_in, int C_out, int T_out, int up_k, int stride, int up_pad, int post_k,
                  cudaStream_t s) {
  if (C_in == 128 && C_out == 64)
    return launch<128, 64>(x, out, sum, up_w, up_b, p, post_w, post_b, B, T_in, T_out, up_k,
                           stride, up_pad, post_k, s);
  if (C_in == 64 && C_out == 32)
    return launch<64, 32>(x, out, sum, up_w, up_b, p, post_w, post_b, B, T_in, T_out, up_k,
                          stride, up_pad, post_k, s);
  if (C_in == 32 && C_out == 16)
    return launch<32, 16>(x, out, sum, up_w, up_b, p, post_w, post_b, B, T_in, T_out, up_k,
                          stride, up_pad, post_k, s);
  if (C_in == 16 && C_out == 8)
    return launch<16, 8>(x, out, sum, up_w, up_b, p, post_w, post_b, B, T_in, T_out, up_k,
                         stride, up_pad, post_k, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

static int check_args(int B, int T_in, int up_k, int stride, int up_pad, int post_k,
                      int n_towers, int n_pairs, int* T_out) {
  *T_out = (T_in - 1) * stride + up_k - 2 * up_pad;
  if (n_towers < 1 || n_towers > zv::MAX_TOWERS || n_pairs < 1 || n_pairs > zv::MAX_PAIRS ||
      stride < 1 || up_k < 1 || post_k < 0 || (post_k > 0 && post_k % 2 == 0) || B < 1 ||
      T_in < 1)
    return (int)cudaErrorInvalidValue;
  return *T_out > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// x [B, T_in, C_in]; up_w: the transposed conv's taps (torch's, not
// flipped) grouped by phase (taps ph, ph + stride, ... for ph = 0, 1, ...),
// each tap [C_in][C_out] in mma fragment order (mrf_tc.cuh); up_b [C_out];
// w, b: the towers' weights and biases as zv_mrf_f32 takes them; post_w
// [post_k][C_out] and post_b [1] when post_k > 0 (else ignored). out is
// [B, T_out, C_out], or [B, T_out] with post. Returns a cudaError_t;
// (C_in, C_out) must be (128, 64), (64, 32), (32, 16) or (16, 8).
extern "C" int zv_upsample_stage_f32(const float* x, float* out, const float* up_w,
                                     const float* up_b, const float* w, const float* b,
                                     const float* post_w, const float* post_b, int B, int T_in,
                                     int C_in, int C_out, int up_k, int stride, int up_pad,
                                     int post_k, int n_towers, int k0, int k1, int k2,
                                     int n_pairs, int d0, int d1, int d2, void* stream) {
  int T_out = 0;
  if (int e = check_args(B, T_in, up_k, stride, up_pad, post_k, n_towers, n_pairs, &T_out))
    return e;
  zv::MrfParams p{n_towers, {k0, k1, k2}, n_pairs, {d0, d1, d2}, w, b};
  return launch_widths(x, out, out, up_w, up_b, p, post_w, post_b, B, T_in, C_in, C_out, T_out,
                       up_k, stride, up_pad, post_k, static_cast<cudaStream_t>(stream));
}

// zv_upsample_stage_f32 on bf16 x, out and weights, up_w and w in m16n8k16
// fragment order (mrf_bf16.cuh; the same order of taps and convs); sum:
// float32 scratch [B, T_out, C_out] for the tower sums, used only without
// post and with more than one tower (may be null otherwise).
extern "C" int zv_upsample_stage_bf16(const zv::bf16* x, zv::bf16* out, float* sum,
                                      const zv::bf16* up_w, const zv::bf16* up_b,
                                      const zv::bf16* w, const zv::bf16* b,
                                      const zv::bf16* post_w, const zv::bf16* post_b, int B,
                                      int T_in, int C_in, int C_out, int up_k, int stride,
                                      int up_pad, int post_k, int n_towers, int k0, int k1,
                                      int k2, int n_pairs, int d0, int d1, int d2,
                                      void* stream) {
  int T_out = 0;
  if (int e = check_args(B, T_in, up_k, stride, up_pad, post_k, n_towers, n_pairs, &T_out))
    return e;
  if (post_k == 0 && n_towers > 1 && sum == nullptr) return (int)cudaErrorInvalidValue;
  zv::MrfParamsT<zv::bf16> p{n_towers, {k0, k1, k2}, n_pairs, {d0, d1, d2}, w, b};
  return launch_widths(x, out, sum, up_w, up_b, p, post_w, post_b, B, T_in, C_in, C_out, T_out,
                       up_k, stride, up_pad, post_k, static_cast<cudaStream_t>(stream));
}

// The time tile zv_upsample_stage_f32 takes for these arguments (output
// rows), or minus a cudaError_t.
extern "C" int zv_upsample_stage_tile(int B, int T_in, int C_in, int C_out, int up_k, int stride,
                                      int up_pad, int post_k, int n_towers, int k0, int k1,
                                      int k2, int n_pairs, int d0, int d1, int d2) {
  int T_out = 0;
  if (int e = check_args(B, T_in, up_k, stride, up_pad, post_k, n_towers, n_pairs, &T_out))
    return -e;
  zv::MrfParams p{n_towers, {k0, k1, k2}, n_pairs, {d0, d1, d2}, nullptr, nullptr};
  return tile_widths(p, B, C_in, C_out, T_out, up_k, stride, post_k);
}

// The time tile zv_upsample_stage_bf16 takes, likewise.
extern "C" int zv_upsample_stage_bf16_tile(int B, int T_in, int C_in, int C_out, int up_k,
                                           int stride, int up_pad, int post_k, int n_towers,
                                           int k0, int k1, int k2, int n_pairs, int d0, int d1,
                                           int d2) {
  int T_out = 0;
  if (int e = check_args(B, T_in, up_k, stride, up_pad, post_k, n_towers, n_pairs, &T_out))
    return -e;
  zv::MrfParamsT<zv::bf16> p{n_towers, {k0, k1, k2}, n_pairs, {d0, d1, d2}, nullptr, nullptr};
  return tile_widths(p, B, C_in, C_out, T_out, up_k, stride, post_k);
}
