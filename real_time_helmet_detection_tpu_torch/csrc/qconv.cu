// int8 inference convolutions and the activation quantizer.
//
// Replaces: XLA's int8 x int8 -> int32 convolution of the quantized model
// twin, `lax.conv_general_dilated(..., preferred_element_type=int32)` then
// the rescale `acc.astype(dt) * (s_a * s_w).astype(dt) + bias` in
// real_time_helmet_detection_tpu/models/hourglass.py:287-298 (`QuantConv`),
// and `quantize_activations` in real_time_helmet_detection_tpu/ops/quant.py
// (the TPU package has no Pallas kernel for either).
//
// Three kernels, stride 1 and NHWC (channels-last) tensors throughout:
//
// * qconv_dense_kernel: a dense k x k conv (k = 1 or 3, zero padding k/2)
//   as an implicit GEMM, M = N*H*W output pixels, N = Cout, K = k*k*Cin,
//   on the tensor cores with mma.sync.m16n8k32.s32.s8.s8.s32. A tile is
//   128 pixels x 64 output channels; a block's 4 warps each own 32 pixels
//   (two m16 tiles) x all 64 channels (eight n8 tiles). K runs in stages
//   of one tap x up to 128 input channels: the stage's 128 input rows
//   (the tap's pixel, gathered from NHWC with zero fill at the border and
//   past the last pixel: no im2col in memory) and 64 weight rows go to
//   shared memory by cp.async, two stages in flight, in rows as long as
//   the conv's K needs (at most 128 + 16 bytes, 80 at K = 64: more blocks
//   an SM for the narrow 1x1 convs); a thread stages one
//   fixed 16-byte column of 8 rows, their pixels from a table made once
//   a block by multiply-high division. Fragments come by ldmatrix.x4 (a
//   16 x 32-byte A tile, or two n8 B tiles, per instruction); shared rows
//   are padded by 16 bytes, so each 8-row phase of an ldmatrix hits 32
//   distinct banks. The epilogue rounds each column's mult and bias once
//   a block and converts two channels at a time.
// * qconv_dw_kernel: a 3 x 3 depthwise conv (groups = C); a thread takes
//   8 channels of one pixel (one 8-byte load per tap) and keeps 8 int32
//   sums; the 3 x 3 neighbourhood is re-read from L1/L2.
// * quantize_kernel: int8(clip(rint(x / s_a), -127, 127)), 8 elements a
//   thread (16 or 32 bytes in, 8 bytes out); NaN gives 0, the value XLA's
//   float -> int8 conversion gives.
//
// The convs' epilogue repeats the JAX rescale with one rounding per
// operation: f32(acc) rounded to the output type, times mult[c] (the f32
// s_a * s_w, rounded to the output type), rounded, plus bias[c] (rounded
// to the output type), rounded, then ReLU or Linear. __fmul_rn/__fadd_rn
// keep nvcc from contracting to an FMA, and __fdiv_rn/rintf keep the
// quantizer's division and round-half-even exact (no fast math), so the
// plain PyTorch versions (ops/qconv.py) agree bit for bit. With
// out_dtype kI32 the convs write the raw int32 sums.
//
// Bound on the H100: bytes at the throughput tier's widths (1x1, 96 -> 48
// at b16 256^2: 96 MB of int8 in, 96 MB of bf16 out, 9.7 GOP), operations
// only for the 3x3 128 -> 128 convs of the flagship (K = 1152).
#include "common.cuh"

#include <stdint.h>

namespace helmet {

enum QOut : int { kQF32 = 0, kQBF16 = 1, kQI32 = 2 };

constexpr int kBM = 128;       // output pixels a block
constexpr int kBN = 64;        // output channels a block
constexpr int kMaxBK = 128;    // input channels (bytes) a stage
constexpr int kPadB = 16;      // shared-memory row padding
constexpr int kQThreads = 128;  // 4 warps
// shared rows: the stage's K bytes (at most kMaxBK) + kPadB
__host__ __device__ constexpr int dense_stride(int cin) {
  return (cin < kMaxBK ? (cin + 31) / 32 * 32 : kMaxBK) + kPadB;
}
__host__ __device__ constexpr int dense_smem(int cin) {
  // two stages, then each tile row's packed (image, y, x); all dynamic
  // shared memory (static shared memory would count against the
  // kMaxDynamicSmem the kernel opts into)
  return 2 * (kBM + kBN) * dense_stride(cin) + kBM * (int)sizeof(int);
}
// the input rows a thread stages: rows (tid / 8) + 16 k, k < kRowsPerThread
constexpr int kRowsPerThread = kBM / (kQThreads / 8);

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31 by a multiply-high and a
// shift (Granlund and Montgomery's round-up method, as CUTLASS's
// FastDivmod): the loads' pixel coordinates without an integer division.
struct FastDiv {
  unsigned mul = 0, shift = 0;
  bool one;
  __device__ explicit FastDiv(int divisor) : one(divisor == 1) {
    if (one) return;
    const unsigned d = (unsigned)divisor;
    unsigned l = 0;  // ceil(log2 d)
    while ((1u << l) < d) ++l;
    mul = (unsigned)(((1ull << (31 + l)) + d - 1) / d);
    shift = l - 1;
  }
  __device__ __forceinline__ int div(int n) const {
    return one ? n : (int)(__umulhi((unsigned)n, mul) >> shift);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0 source bytes: 16 zero bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32 -> T -> f32: the value a T storage would hold
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// the rescale of one int32 sum, in the plain version's operation order
template <typename T, int ACT>
__device__ __forceinline__ T rescale(int acc, float mult, float bias) {
  const float a = round_to<T>(__int2float_rn(acc));
  const float p = round_to<T>(__fmul_rn(a, round_to<T>(mult)));
  float s = round_to<T>(__fadd_rn(p, round_to<T>(bias)));
  if (ACT == kReLU) s = s < 0.f ? 0.f : s;
  return from_f32<T>(s);
}

// The rescale of two neighbouring channels (c, c + 1) of one output
// pixel: `Cols` holds their mult and bias, rounded to the output type
// once a tile; `put` stores the pair (8 or 4 bytes).
struct Cols {
  float m0, m1, b0, b1;
};

template <typename OutT, int ACT>
struct Store2;
template <int ACT>
struct Store2<int, ACT> {
  __device__ static Cols cols(const float*, const float*) { return Cols{}; }
  __device__ static void put(int* p, int a, int b, const Cols&) {
    *reinterpret_cast<int2*>(p) = make_int2(a, b);
  }
};
template <int ACT>
struct Store2<float, ACT> {
  __device__ static Cols cols(const float* m, const float* c) {
    return Cols{m[0], m[1], c[0], c[1]};
  }
  __device__ static void put(float* p, int a, int b, const Cols& k) {
    float s0 = __fadd_rn(__fmul_rn(__int2float_rn(a), k.m0), k.b0);
    float s1 = __fadd_rn(__fmul_rn(__int2float_rn(b), k.m1), k.b1);
    if (ACT == kReLU) {
      s0 = s0 < 0.f ? 0.f : s0;
      s1 = s1 < 0.f ? 0.f : s1;
    }
    *reinterpret_cast<float2*>(p) = make_float2(s0, s1);
  }
};
template <int ACT>
struct Store2<__nv_bfloat16, ACT> {
  __device__ static Cols cols(const float* m, const float* c) {
    return Cols{round_to<__nv_bfloat16>(m[0]), round_to<__nv_bfloat16>(m[1]),
                round_to<__nv_bfloat16>(c[0]), round_to<__nv_bfloat16>(c[1])};
  }
  // each step rounded to bf16 on its own, two channels a conversion
  __device__ static void put(__nv_bfloat16* p, int a, int b, const Cols& k) {
    const float2 v = __bfloat1622float2(
        __floats2bfloat162_rn(__int2float_rn(a), __int2float_rn(b)));
    const float2 q = __bfloat1622float2(
        __floats2bfloat162_rn(__fmul_rn(v.x, k.m0), __fmul_rn(v.y, k.m1)));
    float s0 = __fadd_rn(q.x, k.b0), s1 = __fadd_rn(q.y, k.b1);
    if (ACT == kReLU) {  // on the rounded sum: ReLU commutes with rounding
      s0 = s0 < 0.f ? 0.f : s0;
      s1 = s1 < 0.f ? 0.f : s1;
    }
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(s0, s1);
  }
};

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const unsigned char* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// One block a tile: blockIdx.y the pixel block, blockIdx.x the channel
// block (the channel blocks of one pixel block run side by side, so
// their shared input rows come from L2).
template <typename OutT, int ACT>
__global__ void __launch_bounds__(kQThreads)
    qconv_dense_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ mult,
                       const float* __restrict__ bias, OutT* __restrict__ out,
                       int N, int H, int W, int Cin, int Cout, int ks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = dense_stride(Cin);
  const int stage_bytes = (kBM + kBN) * stride;
  int* rows = reinterpret_cast<int*>(smem + 2 * stage_bytes);
  const int HW = H * W;
  const int M = N * HW;  // < 2^31, checked by the host
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int nt = min(kBN, Cout - n0) / 8;  // n8 tiles of this block
  const int cchunks = (Cin + kMaxBK - 1) / kMaxBK;
  const int stages = ks * ks * cchunks;
  const int pad = ks / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // a thread stages 16-byte column lq of rows lr + 16 k of both operands
  const int lq = tid & 7, lr = tid >> 3;

  // each tile row's packed (image, y, x), or -1 past the last pixel
  {
    const FastDiv div_hw(HW), div_w(W);
    for (int r = tid; r < kBM; r += kQThreads) {
      const int m = m0 + r;
      int v = -1;
      if (m < M) {
        const int n = div_hw.div(m);
        const int rem = m - n * HW;
        const int y = div_w.div(rem);
        v = (n << 22) | (y << 11) | (rem - y * W);
      }
      rows[r] = v;
    }
  }
  __syncthreads();

  auto load_stage = [&](int s, unsigned char* sa) {
    unsigned char* sb = sa + kBM * stride;
    const int tap = s / cchunks;
    const int c0 = (s - tap * cchunks) * kMaxBK;
    const int dy = tap / ks - pad, dx = tap % ks - pad;
    const int width = min(kMaxBK, Cin - c0);  // a multiple of 16
    const int q16 = ((width + 31) & ~31) >> 4;
    if (lq >= q16) return;  // past the staged width: never read
    const bool in_k = lq * 16 < width;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int v = rows[lr + 16 * k];
      const int yy = ((v >> 11) & 2047) + dy, xx = (v & 2047) + dx;
      const bool ok = v >= 0 && in_k && yy >= 0 && yy < H && xx >= 0 &&
                      xx < W;
      const int8_t* src =
          ok ? x + ((((long long)(v >> 22) * H + yy) * W + xx) * Cin + c0 +
                    lq * 16)
             : x;
      cp_async16(sa + (lr + 16 * k) * stride + lq * 16, src, ok);
    }
#pragma unroll
    for (int k = 0; k < kBN / 16; ++k) {
      const int r = lr + 16 * k;
      if (r < nt * 8)
        cp_async16(sb + r * stride + lq * 16,
                   in_k ? w + (((long long)(n0 + r) * ks * ks + tap) * Cin +
                               c0 + lq * 16)
                        : w,
                   in_k);
    }
  };

  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

  // ldmatrix rows: A (lanes 0-7, 8-15, 16-23, 24-31 -> rows 0-7 / 8-15
  // at byte 0, rows 0-7 / 8-15 at byte 16: a0..a3); B (-> channels 0-7
  // at byte 0 / 16, channels 8-15 at byte 0 / 16: b0, b1 of two n8 tiles)
  const int a_row = warp * 32 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 16;

  load_stage(0, smem);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    const unsigned char* sa = smem + (s & 1) * stage_bytes;
    const unsigned char* sb = sa + kBM * stride;
    if (s + 1 < stages) {
      load_stage(s + 1, smem + ((s + 1) & 1) * stage_bytes);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int c0 = (s % cchunks) * kMaxBK;
    const int kw = (min(kMaxBK, Cin - c0) + 31) & ~31;
    for (int kk = 0; kk < kw; kk += 32) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], sa + (a_row + mt * 16) * stride + kk + a_col);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (2 * jp < nt) {
          unsigned b[4];
          ldmatrix_x4(b, sb + (jp * 16 + b_row) * stride + kk + b_col);
          mma_s8(acc[0][2 * jp], a[0], b[0], b[1]);
          mma_s8(acc[1][2 * jp], a[1], b[0], b[1]);
          mma_s8(acc[0][2 * jp + 1], a[0], b[2], b[3]);
          mma_s8(acc[1][2 * jp + 1], a[1], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= nt) continue;
    const int c = n0 + j * 8 + t * 2;
    const Cols k = Store2<OutT, ACT>::cols(mult + c, bias + c);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {  // rows g and g + 8
        const int row = m0 + warp * 32 + mt * 16 + g + hi * 8;
        if (row < M)
          Store2<OutT, ACT>::put(out + (long long)row * Cout + c,
                                 acc[mt][j][2 * hi], acc[mt][j][2 * hi + 1],
                                 k);
      }
    }
  }
}

// 8 channels of one output pixel
template <typename OutT, int ACT>
struct Store8;
template <int ACT>
struct Store8<int, ACT> {
  __device__ static void put(int* p, const int* a, const float*,
                             const float*) {
    reinterpret_cast<int4*>(p)[0] = make_int4(a[0], a[1], a[2], a[3]);
    reinterpret_cast<int4*>(p)[1] = make_int4(a[4], a[5], a[6], a[7]);
  }
};
template <int ACT>
struct Store8<float, ACT> {
  __device__ static void put(float* p, const int* a, const float* m,
                             const float* c) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = rescale<float, ACT>(a[e], m[e], c[e]);
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};
template <int ACT>
struct Store8<__nv_bfloat16, ACT> {
  __device__ static void put(__nv_bfloat16* p, const int* a, const float* m,
                             const float* c) {
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = rescale<__nv_bfloat16, ACT>(a[e], m[e], c[e]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
  }
};

template <typename OutT, int ACT>
__global__ void qconv_dw_kernel(const int8_t* __restrict__ x,
                                const int8_t* __restrict__ w,
                                const float* __restrict__ mult,
                                const float* __restrict__ bias,
                                OutT* __restrict__ out, int N, int H, int W,
                                int C) {
  const int groups = C / 8;
  const int total = N * H * W * groups;  // < 2^31, checked by the host
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int cg = i % groups;
    const int m = i / groups;
    const int px = m % W;
    const int py = (m / W) % H;
    const int n = m / (W * H);
    const int c = cg * 8;
    int acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int yy = py + ky - 1;
      if (yy < 0 || yy >= H) continue;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int xx = px + kx - 1;
        if (xx < 0 || xx >= W) continue;
        const int2 xv = *reinterpret_cast<const int2*>(
            x + (((long long)n * H + yy) * W + xx) * C + c);
        const int2 wv = *reinterpret_cast<const int2*>(
            w + (long long)(ky * 3 + kx) * C + c);
        const int8_t* xb = reinterpret_cast<const int8_t*>(&xv);
        const int8_t* wb = reinterpret_cast<const int8_t*>(&wv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += (int)xb[e] * (int)wb[e];
      }
    }
    Store8<OutT, ACT>::put(out + (long long)m * C + c, acc, mult + c,
                           bias + c);
  }
}

__device__ __forceinline__ int8_t quant1(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));  // round half to even
  if (r != r) return 0;              // NaN
  r = fminf(fmaxf(r, -127.f), 127.f);
  return (int8_t)__float2int_rn(r);
}

template <typename T>
struct Load8;
template <>
struct Load8<float> {
  __device__ static void get(const float* p, float* v) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};
template <>
struct Load8<__nv_bfloat16> {
  __device__ static void get(const __nv_bfloat16* p, float* v) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&a);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
  }
};

template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x,
                                const float* __restrict__ step,
                                int8_t* __restrict__ out, long long n) {
  const float s = *step;
  const long long n8 = n / 8;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = first; i < n8; i += stride) {
    float v[8];
    Load8<T>::get(x + 8 * i, v);
    __align__(8) int8_t q[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) q[e] = quant1(v[e], s);
    *reinterpret_cast<int2*>(out + 8 * i) = *reinterpret_cast<const int2*>(q);
  }
  for (long long i = 8 * n8 + first; i < n; i += stride)
    out[i] = quant1(to_f32(x[i]), s);
}

template <typename OutT, int ACT>
cudaError_t launch_dense(const void* x, const void* w, const void* mult,
                         const void* bias, void* out, int N, int H, int W,
                         int Cin, int Cout, int ks, cudaStream_t stream) {
  const void* fn = (const void*)qconv_dense_kernel<OutT, ACT>;
  int per_sm = 0;
  const int smem = dense_smem(Cin);
  cudaError_t e = launch_setup(fn, kQThreads, smem, &per_sm);
  if (e != cudaSuccess) return e;
  const long long M = (long long)N * H * W;
  const dim3 grid((unsigned)((Cout + kBN - 1) / kBN),
                  (unsigned)((M + kBM - 1) / kBM));
  qconv_dense_kernel<OutT, ACT><<<grid, kQThreads, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(mult), static_cast<const float*>(bias),
      static_cast<OutT*>(out), N, H, W, Cin, Cout, ks);
  return cudaGetLastError();
}

template <typename OutT, int ACT>
cudaError_t launch_dw(const void* x, const void* w, const void* mult,
                      const void* bias, void* out, int N, int H, int W, int C,
                      cudaStream_t stream) {
  const int threads = 256;
  const long long total = (long long)N * H * W * (C / 8);
  qconv_dw_kernel<OutT, ACT><<<grid_for(total, threads), threads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(mult), static_cast<const float*>(bias),
      static_cast<OutT*>(out), N, H, W, C);
  return cudaGetLastError();
}

}  // namespace helmet

// out dtype x activation -> one instantiation of LAUNCH (int32 sums take
// no activation)
#define HELMET_QDISPATCH(LAUNCH, ...)                                       \
  do {                                                                      \
    if (act != helmet::kReLU && act != helmet::kLinear)                     \
      return (int)cudaErrorInvalidValue;                                    \
    const bool relu = act == helmet::kReLU;                                 \
    if (dtype == helmet::kQI32)                                             \
      return (int)helmet::LAUNCH<int, helmet::kLinear>(__VA_ARGS__);        \
    if (dtype == helmet::kQF32)                                             \
      return (int)(relu ? helmet::LAUNCH<float, helmet::kReLU>(__VA_ARGS__) \
                        : helmet::LAUNCH<float, helmet::kLinear>(          \
                              __VA_ARGS__));                                \
    if (dtype == helmet::kQBF16)                                            \
      return (int)(relu ? helmet::LAUNCH<__nv_bfloat16, helmet::kReLU>(     \
                              __VA_ARGS__)                                  \
                        : helmet::LAUNCH<__nv_bfloat16, helmet::kLinear>(   \
                              __VA_ARGS__));                                \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

extern "C" int helmet_qconv_dense(const void* x, const void* w,
                                  const void* mult, const void* bias,
                                  void* out, int N, int H, int W, int Cin,
                                  int Cout, int ks, int dtype, int act,
                                  void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin % 16 || Cout <= 0 ||
      Cout % 8 || (ks != 1 && ks != 3) || N >= 512 || H >= 2048 ||
      W >= 2048 || (long long)N * H * W >= (1LL << 31) - helmet::kBM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HELMET_QDISPATCH(launch_dense, x, w, mult, bias, out, N, H, W, Cin, Cout,
                   ks, s);
}

extern "C" int helmet_qconv_dw(const void* x, const void* w, const void* mult,
                               const void* bias, void* out, int N, int H,
                               int W, int C, int dtype, int act,
                               void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 ||
      (long long)N * H * W * (C / 8) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HELMET_QDISPATCH(launch_dw, x, w, mult, bias, out, N, H, W, C, s);
}

extern "C" int helmet_quantize(const void* x, const void* step, void* out,
                               long long n, int dtype, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const unsigned blocks = helmet::grid_for((n + 7) / 8, threads);
  if (dtype == helmet::kF32)
    helmet::quantize_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(step),
        static_cast<int8_t*>(out), n);
  else if (dtype == helmet::kBF16)
    helmet::quantize_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(step),
        static_cast<int8_t*>(out), n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
