// int8 inference convolutions and the activation quantizer.
//
// Replaces: XLA's int8 x int8 -> int32 convolution of the quantized model
// twin, `lax.conv_general_dilated(..., preferred_element_type=int32)` then
// the rescale `acc.astype(dt) * (s_a * s_w).astype(dt) + bias` in
// real_time_helmet_detection_tpu/models/hourglass.py:287-298 (`QuantConv`),
// and `quantize_activations` in real_time_helmet_detection_tpu/ops/quant.py
// (the TPU package has no Pallas kernel for either).
//
// Stride 1 and NHWC (channels-last) tensors throughout. ops/qconv.py
// picks a conv's kernel by shape (`dense_plan`, `dw_plan`) and passes the
// plan in; a kernel that fails to build or launch raises, never falls back.
//
// * qconv_wgmma_kernel (the dense k x k conv, k = 1 or 3, zero padding
//   k/2): an implicit GEMM, M = N*H*W output pixels, N = Cout, K =
//   k*k*Cin, both operands K-major as they lie (NHWC input, (Cout, k, k,
//   Cin) weights), on wgmma.mma_async.m64nNk32.s32.s8.s8 with A and B
//   from shared memory, the only route to the int8 tensor-core rate. A
//   tile is a spatial box of 128 output pixels (8 x bh x bn: 8 x 16 x 1,
//   or 8 x 8 x 2 at 8^2) x N = all of Cout (a legal integer wgmma width
//   >= Cout, at most 256). The tile's input with its one-pixel halo is
//   one TMA box (a 4-D map (C, W, H, N), one load a 16-channel plane),
//   loaded once and read by all k * k taps at shifted offsets: without
//   swizzle a plane holds 8-row x 16-byte core matrices whose 8-row
//   groups lie one halo row apart, so tap (dy, dx) is the same descriptor
//   moved by dy * (8 + k - 1) + dx pixels. TMA zero-fills out-of-range
//   coordinates: the conv's zero padding, the ragged edge, channels past
//   Cin, never a neighbouring image (N is a dimension of its own). The
//   channel block's weights (k * k x Cin x N bytes, 147 KB at 3x3 128 ->
//   128) are loaded once a block and stay, so a 3x3 tile takes 23 KB
//   into shared memory, not the ~290 KB of restaging each tap's rows and
//   weights. No thread computes a gather address. A persistent block has
//   one producer warp, whose one lane keeps a ring of input boxes full
//   across tile boundaries (mbarrier full/empty pairs), and two consumer
//   warpgroups, 64 rows each, all k * k * Cin / 32 wgmmas of a tile in
//   one group, taking turns to issue so that one's epilogue runs under
//   the other's wgmmas. Persistent because a 1x1 conv has one K pass a
//   tile: only the next tiles' loads can overlap a tile's epilogue. The
//   epilogue takes each column's mult and bias, rounded once a block,
//   from shared memory (loads from global between its stores each wait a
//   round trip, which took most of the kernel's time), rescales in the
//   fragment layout, writes a warp's 16 rows to padded staging rows and
//   stores whole 16-byte row pieces: at the 1x1 sites the bf16 output is
//   most of the bytes bound. What holds the 3x3 convs near half of the
//   int8 peak: an m64n128k32 reads 6 KB of operands from shared memory,
//   96 bytes a clock at that peak, three quarters of what an SM's shared
//   memory delivers.
// * qconv_dense_kernel (the first design, kept beside it and timed with
//   it): the same conv on mma.sync.m16n8k32 from 4 warps, a 128 px x 64
//   ch tile, rows gathered by cp.async from a per-block pixel table in
//   two stages; `dense_plan` sends it only shapes whose weights do not
//   fit shared memory (Cin 256 at 3x3).
// * qconv_dw_tile_kernel (the 3 x 3 depthwise conv, groups = C, C % 16
//   == 0): a persistent block stages a 32 x 16 pixel tile with its
//   one-pixel halo and up to 64 channels into shared memory by one TMA
//   load (the halo past the image arrives as zeros), the next tile's
//   load in flight while it computes, so each input byte comes from HBM
//   about once. A thread takes one channel word (4 channels) of a column
//   of 8 output pixels and slides down it: each input row's three
//   neighbours of a channel are packed into one word (two __byte_perm)
//   and each row of taps is one __dp4a against the tap-packed weights,
//   3 instructions for 9 products; a warp reads consecutive words (no
//   bank conflict). Lane pairs swap halves, so each stores 8 channels (16
//   bytes of bf16) of one pixel, each pair's mult and bias rounded once
//   an item (Store2's rescale).
// * qconv_dw_kernel (the first design): a thread takes 8 channels of one
//   pixel and makes nine 8-byte loads; kept for C % 16 != 0 (TMA needs
//   16-byte strides) and beside the tiled kernel in the timings.
// * quantize_kernel: int8(clip(rint(x / s_a), -127, 127)), NaN gives 0,
//   the value XLA's float -> int8 conversion gives; 16 elements a thread
//   (32 or 64 bytes in, one 16-byte store out) in a grid-stride loop over
//   one wave of resident blocks (the SM count times the occupancy), and
//   at one or two steps a launch: a block's input that its first conv and
//   its 1x1 projection both quantize is read once for both.
// * absmax_kernel: max |x| over a whole tensor (the dynamic step of the
//   int8 train forward), one launch: each block folds its part of a
//   grid-stride loop to one partial, and the block that takes the last
//   ticket folds the partials (the counter wraps back to 0 itself, as in
//   loss.cu). No float atomics, no temporary of x's size; NaN-aware, as
//   torch.amax of abs is (fmaxf alone drops a NaN).
//
// The int8 outputs of the convs (`QCodes`): every conv kernel can also
// write, beside or instead of its float output, the int8 codes that the
// next int8 conv reads, quant1 of each value it stores (after its last
// rounding to the output type), at that conv's step, up to two of them a
// launch, each at its own channel offset and channel stride (a half of
// the ghost tail's concatenation). So on the int8 predict a tensor that
// one int8 conv writes and another one alone reads never lands in HBM as
// bf16 only to be read back by the quantizer.
//
// A code costs what the conv's epilogue can afford only without the
// division: `quant_fast` takes the product with the step's reciprocal and
// falls back to the exact quotient only near a tie or the saturation edge
// (or for NaN), so every code equals quant1's; codes are packed into words
// by byte permutes, never through an array in local memory. With a
// division a code, the fused 1x1 of the throughput tier took 0.75 ms where
// the conv alone takes 0.12 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
// qtiming).
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
// Bound on the H100: bytes at the throughput tier's widths (1x1, 64 -> 96
// at b16 256^2: 67 MB of int8 in, 201 MB of bf16 out) and for the
// depthwise conv (1 byte in, 2 out a channel); operations for the
// flagship's 3x3 128 -> 128 convs (K = 1152: 309 GOP at 256^2, 0.156 ms
// at 1979 TOP/s). The quantizer and the abs-max: bytes (3 and 2 a bf16
// element).
#include "common.cuh"

#include <cuda.h>
#include <stdint.h>

#include <type_traits>

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

__device__ __forceinline__ int8_t quant1(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));  // round half to even
  if (r != r) return 0;              // NaN
  r = fminf(fmaxf(r, -127.f), 127.f);
  return (int8_t)__float2int_rn(r);
}

// A step's quantizer: the step and its reciprocal (NaN where the
// reciprocal is not a normal float: every value then takes the quotient)
struct Step {
  float s, inv;
  __device__ explicit Step(float step) : s(step) {
    const float r = __frcp_rn(step);
    inv = fabsf(r) >= 1.17549435e-38f && fabsf(r) < 3.0e38f
              ? r
              : __int_as_float(0x7fc00000);
  }
};

// |x * inv - x / s| <= 2^-22.4 |x / s| (two roundings of the product, one
// of the quotient): below 127.25 an error under 2^-15; a product at least
// this far from a tie rounds to the quotient's integer
constexpr float kTieGuard = 1.0f / 8192;

// quant1(v, st.s), bit for bit, mostly by a product: where |v * inv| <
// 127.25 and it lies more than kTieGuard from a tie, its nearest integer;
// where |v * inv| >= 128 (so |v / s| > 127.5), the saturated code; else
// (near a tie, at the saturation edge, NaN) the quotient
__device__ __forceinline__ int quant_fast(float v, const Step& st) {
  const float r = __fmul_rn(v, st.inv);
  const float a = fabsf(r);
  if (a < 127.25f) {
    if (fabsf(__fsub_rn(__fsub_rn(r, floorf(r)), 0.5f)) > kTieGuard)
      return __float2int_rn(r);
  } else if (a >= 128.f) {
    return r > 0.f ? 127 : -127;
  }
  return quant1(v, st.s);
}

// four codes (in [-127, 127]) as the bytes of one word, first lowest
__device__ __forceinline__ unsigned pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// the codes of V (2, 4, 8 or 16) values at one step, packed
template <int V>
__device__ __forceinline__ void codes_of(const float* v, const Step& st,
                                         unsigned* w) {
  if constexpr (V == 2) {
    w[0] = __byte_perm(quant_fast(v[0], st), quant_fast(v[1], st), 0x0040);
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      w[i] = pack4(quant_fast(v[4 * i], st), quant_fast(v[4 * i + 1], st),
                   quant_fast(v[4 * i + 2], st),
                   quant_fast(v[4 * i + 3], st));
  }
}

// Up to two int8 code outputs of a conv launch: output i (p[i] non-null)
// gets quant1(v, *step[i]) of the value v stored for channel c of output
// pixel m at p[i] + m * stride[i] + off[i] + c (checked by the C entries:
// 16-byte aligned p, off and stride multiples of 8, off + Cout <= stride).
struct QCodes {
  int8_t* p[2];
  const float* step[2];
  int off[2], stride[2];
};

// The steps of a launch's code outputs, read once a thread; the rest of
// QCodes stays in the kernel's parameter space (no registers).
struct CodeSteps {
  Step st[2];
  __device__ CodeSteps() : st{Step(1.f), Step(1.f)} {}  // a plain launch
  __device__ explicit CodeSteps(const QCodes& c)
      : st{Step(c.p[0] != nullptr ? *c.step[0] : 1.f),
           Step(c.p[1] != nullptr ? *c.step[1] : 1.f)} {}
};

// the codes of the V stored values v of channels ch .. ch + V - 1 of
// output pixel m, one V-byte store an output
template <int V>
__device__ __forceinline__ void put_codes(const QCodes& c,
                                          const CodeSteps& steps,
                                          long long m, int ch,
                                          const float* v) {
  static_assert(V == 2 || V == 4 || V == 8, "2, 4 or 8 codes a store");
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (c.p[i] == nullptr) continue;
    unsigned w[V < 4 ? 1 : V / 4];
    codes_of<V>(v, steps.st[i], w);
    int8_t* dst = c.p[i] + m * c.stride[i] + c.off[i] + ch;
    if constexpr (V == 8)
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    else if constexpr (V == 4)
      *reinterpret_cast<unsigned*>(dst) = w[0];
    else
      *reinterpret_cast<unsigned short*>(dst) = (unsigned short)w[0];
  }
}

template <typename T>
constexpr bool kHasCodes = !std::is_same<T, int>::value;  // float outputs

// V stored values of type T as floats (the values their codes quantize)
template <typename T, int V>
__device__ __forceinline__ void floats_of(const T* v, float* f) {
#pragma unroll
  for (int e = 0; e < V; ++e) f[e] = to_f32(v[e]);
}

// the 16 / sizeof(T) values of a 16-byte piece of T as floats, from its
// words (a bf16 is the high half of its float)
template <typename T>
__device__ __forceinline__ void floats_of_piece(const uint4& p, float* f) {
  const unsigned w[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 2) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      f[i] = __uint_as_float(w[i]);
    }
  }
}

// 8 values of one pixel's channels in 16-byte stores (32 bytes for 4-byte
// types)
template <typename T>
__device__ __forceinline__ void store8(T* p, const T* v) {
#pragma unroll
  for (int i = 0; i < 8 * (int)sizeof(T) / 16; ++i)
    reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(v)[i];
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
// once a tile; `value` gives the pair as stored (rounded to the output
// type), `put` stores it (8 or 4 bytes).
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
  __device__ static float2 value(int a, int b, const Cols& k) {
    float s0 = __fadd_rn(__fmul_rn(__int2float_rn(a), k.m0), k.b0);
    float s1 = __fadd_rn(__fmul_rn(__int2float_rn(b), k.m1), k.b1);
    if (ACT == kReLU) {
      s0 = s0 < 0.f ? 0.f : s0;
      s1 = s1 < 0.f ? 0.f : s1;
    }
    return make_float2(s0, s1);
  }
  __device__ static void put(float* p, int a, int b, const Cols& k) {
    *reinterpret_cast<float2*>(p) = value(a, b, k);
  }
};
template <int ACT>
struct Store2<__nv_bfloat16, ACT> {
  __device__ static Cols cols(const float* m, const float* c) {
    return Cols{round_to<__nv_bfloat16>(m[0]), round_to<__nv_bfloat16>(m[1]),
                round_to<__nv_bfloat16>(c[0]), round_to<__nv_bfloat16>(c[1])};
  }
  // each step rounded to bf16 on its own, two channels a conversion
  __device__ static __nv_bfloat162 pair(int a, int b, const Cols& k) {
    const float2 v = __bfloat1622float2(
        __floats2bfloat162_rn(__int2float_rn(a), __int2float_rn(b)));
    const float2 q = __bfloat1622float2(
        __floats2bfloat162_rn(__fmul_rn(v.x, k.m0), __fmul_rn(v.y, k.m1)));
    float s0 = __fadd_rn(q.x, k.b0), s1 = __fadd_rn(q.y, k.b1);
    if (ACT == kReLU) {  // on the rounded sum: ReLU commutes with rounding
      s0 = s0 < 0.f ? 0.f : s0;
      s1 = s1 < 0.f ? 0.f : s1;
    }
    return __floats2bfloat162_rn(s0, s1);
  }
  __device__ static float2 value(int a, int b, const Cols& k) {
    return __bfloat1622float2(pair(a, b, k));
  }
  __device__ static void put(__nv_bfloat16* p, int a, int b, const Cols& k) {
    *reinterpret_cast<__nv_bfloat162*>(p) = pair(a, b, k);
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
template <typename OutT, int ACT, bool CODES>
__global__ void __launch_bounds__(kQThreads)
    qconv_dense_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ mult,
                       const float* __restrict__ bias, OutT* __restrict__ out,
                       int N, int H, int W, int Cin, int Cout, int ks,
                       const __grid_constant__ QCodes codes) {
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

  const CodeSteps steps = CODES ? CodeSteps(codes) : CodeSteps();
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
        if (row >= M) continue;
        const int a = acc[mt][j][2 * hi], b = acc[mt][j][2 * hi + 1];
        if (!CODES || out != nullptr)
          Store2<OutT, ACT>::put(out + (long long)row * Cout + c, a, b, k);
        if constexpr (CODES) {
          const float2 v = Store2<OutT, ACT>::value(a, b, k);
          const float f[2] = {v.x, v.y};
          put_codes<2>(codes, steps, row, c, f);
        }
      }
    }
  }
}

// 8 channels of one output pixel: the rescaled values (the int32 sums as
// they are), stored where there is a float output, their codes where asked
template <typename OutT, int ACT, bool CODES>
__device__ __forceinline__ void store8_rescaled(OutT* p, const int* a,
                                                const float* m,
                                                const float* c,
                                                const QCodes& codes,
                                                const CodeSteps& steps,
                                                long long px, int ch) {
  __align__(16) OutT v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if constexpr (kHasCodes<OutT>)
      v[e] = rescale<OutT, ACT>(a[e], m[e], c[e]);
    else
      v[e] = a[e];
  }
  if (!CODES || p != nullptr) store8(p, v);
  if constexpr (CODES) {
    float f[8];
    floats_of<OutT, 8>(v, f);
    put_codes<8>(codes, steps, px, ch, f);
  }
}

template <typename OutT, int ACT, bool CODES>
__global__ void qconv_dw_kernel(const int8_t* __restrict__ x,
                                const int8_t* __restrict__ w,
                                const float* __restrict__ mult,
                                const float* __restrict__ bias,
                                OutT* __restrict__ out, int N, int H, int W,
                                int C,
                                const __grid_constant__ QCodes codes) {
  const CodeSteps steps = CODES ? CodeSteps(codes) : CodeSteps();
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
    store8_rescaled<OutT, ACT, CODES>(
        out != nullptr ? out + (long long)m * C + c : nullptr, acc,
        mult + c, bias + c, codes, steps, m, c);
  }
}

template <typename T>
struct Load16;
template <>
struct Load16<float> {
  __device__ static void get(const float* p, float* v) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = a.x;
      v[4 * i + 1] = a.y;
      v[4 * i + 2] = a.z;
      v[4 * i + 3] = a.w;
    }
  }
};
template <>
struct Load16<__nv_bfloat16> {
  __device__ static void get(const __nv_bfloat16* p, float* v) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      floats_of_piece<__nv_bfloat16>(reinterpret_cast<const uint4*>(p)[i],
                                     v + 8 * i);
  }
};

constexpr int kQuantThreads = 256;

// out0 = codes of x at *step0 and, where out1 is not null, out1 = codes
// of x at *step1: x read once for both. A grid-stride loop of 16 elements
// a step over one wave of resident blocks; the last n % 16 elements one a
// thread.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads, 6)
    quantize_kernel(const T* __restrict__ x, const float* __restrict__ step0,
                    int8_t* __restrict__ out0,
                    const float* __restrict__ step1,
                    int8_t* __restrict__ out1, long long n) {
  const Step s0(*step0);
  const Step s1(out1 != nullptr ? *step1 : 1.f);
  const long long n16 = n / 16;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = first; i < n16; i += stride) {
    float v[16];
    Load16<T>::get(x + 16 * i, v);
    unsigned w[4];
    codes_of<16>(v, s0, w);
    *reinterpret_cast<uint4*>(out0 + 16 * i) = make_uint4(w[0], w[1], w[2],
                                                          w[3]);
    if (out1 != nullptr) {
      codes_of<16>(v, s1, w);
      *reinterpret_cast<uint4*>(out1 + 16 * i) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  for (long long i = 16 * n16 + first; i < n; i += stride) {
    const float v = to_f32(x[i]);
    out0[i] = (int8_t)quant_fast(v, s0);
    if (out1 != nullptr) out1[i] = (int8_t)quant_fast(v, s1);
  }
}

// ------------------------------------------------------------------------
// absmax_kernel: max |x| in one launch (see the note at the top)

constexpr int kAbsThreads = 256;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// the NaN-aware max of the block's values, in thread 0; `red` holds a
// float a warp
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kAbsThreads / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = nan_max(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

// *out = max |x| (NaN if any x is NaN); part holds a float a block,
// *ticket is 0 before and after the launch
template <typename T>
__global__ void __launch_bounds__(kAbsThreads)
    absmax_kernel(const T* __restrict__ x, long long n,
                  float* __restrict__ part, unsigned* __restrict__ ticket,
                  float* __restrict__ out) {
  __shared__ float red[kAbsThreads / 32];
  __shared__ bool last;
  float m = 0.f;
  bool nan = false;
  const long long n16 = n / 16;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = first; i < n16; i += stride) {
    float v[16];
    Load16<T>::get(x + 16 * i, v);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float a = fabsf(v[e]);
      nan |= a != a;
      m = fmaxf(m, a);  // drops a NaN: the flag keeps it
    }
  }
  for (long long i = 16 * n16 + first; i < n; i += stride) {
    const float a = fabsf(to_f32(x[i]));
    nan |= a != a;
    m = fmaxf(m, a);
  }
  const float r = block_max(nan ? __int_as_float(0x7fc00000) : m, red);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = r;
    __threadfence();  // the partial is visible before the ticket
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float t = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kAbsThreads)
    t = nan_max(t, __ldcg(part + i));
  t = block_max(t, red);
  if (threadIdx.x == 0) *out = t;
}

// a launch with code outputs takes the kernels instantiated with CODES =
// true; one without, the instantiation without them, so a plain launch
// keeps its registers (the code path cost the plain 1x1 and 3x3 convs
// 16-22% when every launch carried it)
inline bool host_codes(const QCodes& c) {
  return c.p[0] != nullptr || c.p[1] != nullptr;
}

template <typename OutT, int ACT, bool CODES>
cudaError_t launch_dense_c(const void* x, const void* w, const void* mult,
                           const void* bias, void* out, int N, int H, int W,
                           int Cin, int Cout, int ks, const QCodes& codes,
                           cudaStream_t stream) {
  const void* fn = (const void*)qconv_dense_kernel<OutT, ACT, CODES>;
  int per_sm = 0;
  const int smem = dense_smem(Cin);
  cudaError_t e = launch_setup(fn, kQThreads, smem, &per_sm);
  if (e != cudaSuccess) return e;
  const long long M = (long long)N * H * W;
  const dim3 grid((unsigned)((Cout + kBN - 1) / kBN),
                  (unsigned)((M + kBM - 1) / kBM));
  qconv_dense_kernel<OutT, ACT, CODES><<<grid, kQThreads, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(mult), static_cast<const float*>(bias),
      static_cast<OutT*>(out), N, H, W, Cin, Cout, ks, codes);
  return cudaGetLastError();
}

template <typename OutT, int ACT, bool CODES>
cudaError_t launch_dw_c(const void* x, const void* w, const void* mult,
                        const void* bias, void* out, int N, int H, int W,
                        int C, const QCodes& codes, cudaStream_t stream) {
  const int threads = 256;
  const long long total = (long long)N * H * W * (C / 8);
  qconv_dw_kernel<OutT, ACT, CODES>
      <<<grid_for(total, threads), threads, 0, stream>>>(
          static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
          static_cast<const float*>(mult), static_cast<const float*>(bias),
          static_cast<OutT*>(out), N, H, W, C, codes);
  return cudaGetLastError();
}

template <typename OutT, int ACT>
cudaError_t launch_dense(const void* x, const void* w, const void* mult,
                         const void* bias, void* out, int N, int H, int W,
                         int Cin, int Cout, int ks, const QCodes& codes,
                         cudaStream_t stream) {
  if constexpr (kHasCodes<OutT>)
    if (host_codes(codes))
      return launch_dense_c<OutT, ACT, true>(x, w, mult, bias, out, N, H, W,
                                             Cin, Cout, ks, codes, stream);
  return launch_dense_c<OutT, ACT, false>(x, w, mult, bias, out, N, H, W,
                                          Cin, Cout, ks, codes, stream);
}

template <typename OutT, int ACT>
cudaError_t launch_dw(const void* x, const void* w, const void* mult,
                      const void* bias, void* out, int N, int H, int W, int C,
                      const QCodes& codes, cudaStream_t stream) {
  if constexpr (kHasCodes<OutT>)
    if (host_codes(codes))
      return launch_dw_c<OutT, ACT, true>(x, w, mult, bias, out, N, H, W, C,
                                          codes, stream);
  return launch_dw_c<OutT, ACT, false>(x, w, mult, bias, out, N, H, W, C,
                                       codes, stream);
}

template <typename T>
cudaError_t launch_quantize(const void* x, const void* step0, void* out0,
                            const void* step1, void* out1, long long n,
                            cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t e = launch_setup((const void*)quantize_kernel<T>,
                               kQuantThreads, 0, &per_sm);
  if (e != cudaSuccess) return e;
  const long long needed = (n / 16 + kQuantThreads - 1) / kQuantThreads;
  quantize_kernel<T><<<wave_grid(per_sm, needed), kQuantThreads, 0,
                       stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(step0),
      static_cast<int8_t*>(out0), static_cast<const float*>(step1),
      static_cast<int8_t*>(out1), n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_absmax(const void* x, long long n, void* part,
                          int part_cap, void* ticket, void* out,
                          cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t e = launch_setup((const void*)absmax_kernel<T>, kAbsThreads, 0,
                               &per_sm);
  if (e != cudaSuccess) return e;
  const long long needed = (n / 16 + kAbsThreads - 1) / kAbsThreads;
  unsigned grid = wave_grid(per_sm, needed);
  if (grid > (unsigned)part_cap) grid = (unsigned)part_cap;
  absmax_kernel<T><<<grid, kAbsThreads, 0, stream>>>(
      static_cast<const T*>(x), n, static_cast<float*>(part),
      static_cast<unsigned*>(ticket), static_cast<float*>(out));
  return cudaGetLastError();
}


// ------------------------------------------------------------------------
// qconv_wgmma_kernel: the dense conv on wgmma, fed by TMA (see the note at
// the top). The geometry below is mirrored by ops/qconv.py `dense_plan`.

constexpr int kWgRows = 128;       // output pixels a tile: 8 x bh x bn
constexpr int kWgBoxW = 8;         // box width: one 8-row core matrix
constexpr int kWgConsumers = 256;  // two consumer warpgroups, 64 rows each
constexpr int kWgThreads = 288;    // + one producer warp
constexpr int kWgMaxStages = 6;
constexpr int kWgAlign = 128;      // a TMA destination's alignment

// 16-channel planes a tap: Cin rounded up to wgmma's 32-byte K step
__host__ __device__ constexpr int wg_planes(int cin) {
  return (cin + 31) / 32 * 2;
}
// one plane of the input box and its halo: bn x (bh + k - 1) x (8 + k -
// 1) pixels of 16 bytes, padded to kWgAlign
__host__ __device__ constexpr int wg_plane_bytes(int bh, int bn, int ks) {
  return (bn * (bh + ks - 1) * (kWgBoxW + ks - 1) * 16 + kWgAlign - 1) /
         kWgAlign * kWgAlign;
}
// the weights, resident: k * k taps x planes x n rows of 16 bytes
__host__ __device__ constexpr int wg_b_bytes(int cin, int ks, int n) {
  return ks * ks * wg_planes(cin) * n * 16;
}
// a consumer warp's staging row: 128 bytes of output (64 bf16 or 32
// 4-byte channels), padded so that a warp's 4- or 8-byte fragment
// stores and its 16-byte row reads hit 32 distinct banks
__host__ __device__ constexpr int wg_row_bytes(int out_bytes) {
  return 128 + (out_bytes == 2 ? 16 : 32);
}
// alignment slack, the weights, the ring of input boxes, 8 warps x 16
// staging rows, the channel block's rounded mult and bias (a Cols of 16
// bytes a column pair), a full and an empty mbarrier a stage and for the
// weights
__host__ __device__ constexpr int wg_smem(int cin, int ks, int bh, int bn,
                                          int n, int stages, int out_bytes) {
  return kWgAlign + wg_b_bytes(cin, ks, n) +
         stages * wg_planes(cin) * wg_plane_bytes(bh, bn, ks) +
         (kWgConsumers / 32) * 16 * wg_row_bytes(out_bytes) + n * 8 +
         16 * stages + 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a TMA tiled load of one box into shared memory, completing on `bar`;
// coordinates innermost first, out-of-range elements zero-filled
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a wgmma shared-memory matrix descriptor of a K-major operand without
// swizzle: core matrices of 8 rows x 16 bytes, rows 16 bytes apart; `lbo`
// bytes from the first to the second core matrix of a 32-byte K step,
// `sbo` bytes from one 8-row group to the next
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of the sums above a wgmma wait
__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// wgmma.mma_async m64nNk32, int8 x int8 -> int32, A and B from shared
// memory (both K-major, the only order .s8 takes); scale 0 overwrites
// the sums, 1 adds to them. One specialisation a width (the legal
// integer widths that dense_plan uses: WGMMA_N in ops/qconv.py).
template <int N>
struct Wgmma;
template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(int (&d)[16], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(scale));
  }
};
template <>
struct Wgmma<48> {
  __device__ __forceinline__ static void mma(int (&d)[24], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
          "+r"(d[22]), "+r"(d[23])
        : "l"(a), "l"(b), "r"(scale));
  }
};
template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
          "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(scale));
  }
};
template <>
struct Wgmma<96> {
  __device__ __forceinline__ static void mma(int (&d)[48], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
          "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]),
          "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
          "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
          "+r"(d[46]), "+r"(d[47])
        : "l"(a), "l"(b), "r"(scale));
  }
};
template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
          "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]),
          "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
          "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
          "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]),
          "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
          "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(scale));
  }
};
template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(int (&d)[128], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
          "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]),
          "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
          "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
          "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]),
          "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
          "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
          "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
          "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
          "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]),
          "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
          "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]),
          "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
          "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
          "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]),
          "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
          "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
          "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]),
          "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
          "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
          "+r"(d[126]), "+r"(d[127])
        : "l"(a), "l"(b), "r"(scale));
  }
};

// What one launch of qconv_wgmma_kernel covers: the problem, the box
// (8 x bh x bn output pixels, bh and bn powers of two, 128 in all) and the
// K walk (k * k taps x `planes` 16-channel planes, two a wgmma).
struct WgParams {
  const float* mult;
  const float* bias;
  void* out;  // null: codes only
  QCodes codes;
  int N, H, W, Cin, Cout, ks;
  int bh_log, bn_log, planes, plane_bytes, stages;
  int tiles_x, tiles_y, tiles_n, tiles;
};

// tile t -> its box origin (x0, y0, n0) and channel block; x fastest, so
// the tiles in flight at once share their halos in L2, the channel block
// slowest, so a block reloads its weights at most once a channel block
struct WgTile {
  int x0, y0, n0, cb;
};
__device__ __forceinline__ WgTile wg_tile(const WgParams& p, int t) {
  WgTile r;
  const int xt = t % p.tiles_x;
  t /= p.tiles_x;
  const int yt = t % p.tiles_y;
  t /= p.tiles_y;
  r.x0 = xt * kWgBoxW;
  r.y0 = yt << p.bh_log;
  r.n0 = (t % p.tiles_n) << p.bn_log;
  r.cb = t / p.tiles_n;
  return r;
}

// A persistent block walks tiles blockIdx.x, + gridDim.x, ... Warp 8 (the
// producer; one lane) loads the channel block's weights once into shared
// memory, where they stay, and keeps a ring of `stages` input boxes full
// across tile boundaries: each box is the tile with its halo, loaded once
// and read by all k * k taps at shifted offsets. Warps 0-3 and 4-7 (two
// consumer warpgroups) each multiply their 64 rows of the tile by all BN
// columns, k * k * planes / 2 wgmmas in one group, taking turns to issue
// (named barriers 2 and 3), then rescale and store their rows through
// per-warp staging rows in shared memory while the other warpgroup's
// wgmmas run.
template <int BN, typename OutT, int ACT, bool CODES>
__global__ void __launch_bounds__(kWgThreads, BN <= 96 ? 2 : 1)
    qconv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ WgParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kWgAlign - 1) &
      ~(uintptr_t)(kWgAlign - 1));
  const int hw = kWgBoxW + p.ks - 1;           // halo box width
  const int hh = (1 << p.bh_log) + p.ks - 1;  // and height
  const int taps = p.ks * p.ks;
  const int b_bytes = taps * p.planes * BN * 16;
  const int stage_bytes = p.planes * p.plane_bytes;
  constexpr int kRowB = wg_row_bytes(sizeof(OutT));
  unsigned char* ring = smem + b_bytes;
  unsigned char* staging = ring + p.stages * stage_bytes;
  Cols* cols = reinterpret_cast<Cols*>(staging +
                                       (kWgConsumers / 32) * 16 * kRowB);
  const uint32_t full0 = smem_u32(cols + BN / 2);
  const uint32_t empty0 = full0 + 8 * p.stages;
  const uint32_t bfull = empty0 + 8 * p.stages, bempty = bfull + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);                   // the producer
      mbar_init(empty0 + 8 * s, kWgConsumers / 32);  // each consumer warp
    }
    mbar_init(bfull, 1);
    mbar_init(bempty, kWgConsumers / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWgConsumers / 32) {  // the producer
    if (lane != 0) return;
    const uint32_t atx =
        (uint32_t)(p.planes * 16 * hw * hh) << p.bn_log;  // bytes a box
    const int pad = p.ks / 2;
    int slot = 0, loaded = -1, bloads = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const WgTile tile = wg_tile(p, t);
      if (tile.cb != loaded) {  // this channel block's weights, resident
        if (bloads > 0) mbar_wait(bempty, (bloads - 1) & 1);
        mbar_expect_tx(bfull, (uint32_t)b_bytes);
        for (int tap = 0; tap < taps; ++tap)
          for (int g = 0; g < p.planes; ++g)
            tma_load(smem_u32(smem + (tap * p.planes + g) * BN * 16), &wmap,
                     bfull, 16 * g, tap, tile.cb * BN);
        loaded = tile.cb;
        ++bloads;
      }
      // the tile's input box with its halo, one plane of 16 channels a
      // load: padding, the ragged edge and channels past Cin come back as
      // zeros
      const uint32_t a = smem_u32(ring + slot * stage_bytes);
      mbar_wait(empty0 + 8 * slot, phase ^ 1);
      mbar_expect_tx(full0 + 8 * slot, atx);
      for (int g = 0; g < p.planes; ++g)
        tma_load(a + g * p.plane_bytes, &xmap, full0 + 8 * slot, 16 * g,
                 tile.x0 - pad, tile.y0 - pad, tile.n0);
      if (++slot == p.stages) {
        slot = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // this warpgroup's 64 rows are 8 box rows of 8 pixels: their first
  // pixel in the halo box, as a byte offset into a plane
  const int wg = warp >> 2;
  const int box_row = wg * 64 / kWgBoxW;
  const uint32_t wg_off =
      (uint32_t)(((box_row >> p.bh_log) * hh +
                  (box_row & ((1 << p.bh_log) - 1))) *
                 hw * 16);
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const CodeSteps steps = CODES ? CodeSteps(p.codes) : CodeSteps();
  unsigned char* stg = staging + warp * 16 * kRowB;
  const uint32_t bsm = smem_u32(smem);
  // the block's columns, rounded once: the epilogue reads them from shared
  // memory (loads from global between its stores would each wait a round
  // trip)
  auto load_cols = [&](int cb) {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWgConsumers) : "memory");
    for (int i = threadIdx.x; i < BN / 2; i += kWgConsumers) {
      const int c = cb * BN + 2 * i;
      cols[i] = c < p.Cout ? Store2<OutT, ACT>::cols(p.mult + c, p.bias + c)
                           : Cols{};
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWgConsumers) : "memory");
  };
  int slot = 0, cur = -1, bloads = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x, i = 0; t < p.tiles; t += gridDim.x, ++i) {
    const WgTile tile = wg_tile(p, t);
    if (tile.cb != cur) {
      if (cur >= 0 && lane == 0) mbar_arrive(bempty);
      load_cols(tile.cb);
      mbar_wait(bfull, bloads & 1);
      ++bloads;
      cur = tile.cb;
    }
    mbar_wait(full0 + 8 * slot, phase);
    const uint32_t a = smem_u32(ring + slot * stage_bytes) + wg_off;
    // the warpgroups take turns to issue (0, 1, 0, 1, ...), so one's
    // epilogue runs while the other's wgmmas do
    if (wg == 1)
      asm volatile("bar.sync 3, %0;\n" ::"n"(kWgConsumers) : "memory");
    else if (i > 0)
      asm volatile("bar.sync 2, %0;\n" ::"n"(kWgConsumers) : "memory");
    wgmma_fence();
    for (int tap = 0; tap < taps; ++tap) {
      // tap (dy, dx) reads the box shifted by (dy, dx) pixels: 8-row
      // groups one halo row (hw pixels) apart
      const uint32_t at = a + ((tap / p.ks) * hw + tap % p.ks) * 16;
      const uint32_t bt = bsm + tap * p.planes * BN * 16;
      for (int kk = 0; kk < p.planes / 2; ++kk)
        Wgmma<BN>::mma(
            acc,
            gmma_desc(at + 2 * kk * p.plane_bytes, p.plane_bytes, hw * 16),
            gmma_desc(bt + 2 * kk * BN * 16, BN * 16, 128), (tap | kk) != 0);
    }
    wgmma_commit();
    if (wg == 0)
      asm volatile("bar.arrive 3, %0;\n" ::"n"(kWgConsumers) : "memory");
    else if (t + (int)gridDim.x < p.tiles)
      asm volatile("bar.arrive 2, %0;\n" ::"n"(kWgConsumers) : "memory");
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);
    if (++slot == p.stages) {
      slot = 0;
      phase ^= 1;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);

    // epilogue, 128 bytes of each row at a time: fragments -> rescale ->
    // this warp's 16 staging rows -> 16-byte stores of whole row pieces
    constexpr int kCols = 128 / (int)sizeof(OutT);  // channels a pass
    const int c0 = tile.cb * BN;
#pragma unroll
    for (int cg = 0; cg < (BN + kCols - 1) / kCols; ++cg) {
#pragma unroll
      for (int jj = 0; jj < kCols / 8; ++jj) {
        const int j = cg * (kCols / 8) + jj;  // the n8 block
        if (j < BN / 8) {
          const int col = jj * 8 + 2 * (lane & 3);
          const Cols kc = cols[4 * j + (lane & 3)];
          OutT* r0 = reinterpret_cast<OutT*>(stg + (lane >> 2) * kRowB) + col;
          OutT* r1 = reinterpret_cast<OutT*>(stg + ((lane >> 2) + 8) * kRowB) +
                     col;
          Store2<OutT, ACT>::put(r0, acc[4 * j], acc[4 * j + 1], kc);
          Store2<OutT, ACT>::put(r1, acc[4 * j + 2], acc[4 * j + 3], kc);
        }
      }
      __syncwarp();
      const int ncols = min(kCols, BN - cg * kCols);
      const int vpr = ncols * (int)sizeof(OutT) / 16;  // 16-byte pieces a row
      for (int v = lane; v < 16 * vpr; v += 32) {
        const int row = v / vpr, q = v - row * vpr;
        const int r = wg * 64 + (warp & 3) * 16 + row;  // the tile's row
        const int x = tile.x0 + (r & (kWgBoxW - 1));
        const int y = tile.y0 + ((r >> 3) & ((1 << p.bh_log) - 1));
        const int n = tile.n0 + (r >> (3 + p.bh_log));
        const int c = c0 + cg * kCols + q * (16 / (int)sizeof(OutT));
        if (x >= p.W || y >= p.H || n >= p.N || c >= p.Cout) continue;
        const long long m = ((long long)n * p.H + y) * p.W + x;
        const uint4 piece =
            *reinterpret_cast<const uint4*>(stg + row * kRowB + q * 16);
        if (!CODES || p.out != nullptr)
          *reinterpret_cast<uint4*>(static_cast<OutT*>(p.out) +
                                    m * p.Cout + c) = piece;
        if constexpr (CODES) {  // the piece's stored values' codes
          constexpr int V = 16 / (int)sizeof(OutT);
          float f[V];
          floats_of_piece<OutT>(piece, f);
          put_codes<V>(p.codes, steps, m, c, f);
        }
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------------------
// qconv_dw_tile_kernel: the depthwise conv staged once a tile (see the
// note at the top). The geometry is ops/qconv.py `dw_plan`'s.

constexpr int kDwThreads = 256;
constexpr int kDwStrip = 8;    // output rows a thread slides down
constexpr int kDwAlign = 128;  // a TMA destination's alignment

// one input box: ct channels of (tw + 2) x (th + 2) pixels, padded
__host__ __device__ constexpr int dw_box_bytes(int tw, int th, int ct) {
  return (ct * (tw + 2) * (th + 2) + kDwAlign - 1) / kDwAlign * kDwAlign;
}
// alignment slack, two input boxes (the one read, the next one loading)
// and their mbarriers
__host__ __device__ constexpr int dw_tile_smem(int tw, int th, int ct) {
  return kDwAlign + 2 * dw_box_bytes(tw, th, ct) + 16;
}

// bytes e of a, b and c in bytes 0-2 of a word (byte 3: a's byte 0)
__device__ __forceinline__ int pack3(int a, int b, int c, int e) {
  const int ab = __byte_perm(a, b, e | ((e + 4) << 4));
  return __byte_perm(ab, c, 0x0010 | ((e + 4) << 8));
}

// 8 channels of one output pixel: each pair's mult and bias rounded to
// the output type once (Store2's rescale, the plain version's rounding);
// stored where there is a float output, their codes where asked
template <typename OutT, int ACT, bool CODES>
struct Store8Cols {
  Cols k[4];
  __device__ void load(const float* m, const float* b) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      k[i] = Store2<OutT, ACT>::cols(m + 2 * i, b + 2 * i);
  }
  __device__ void put(OutT* p, const int* a, const QCodes& codes,
                      const CodeSteps& steps, long long px, int ch) const {
    __align__(16) OutT v[8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      Store2<OutT, ACT>::put(v + 2 * i, a[2 * i], a[2 * i + 1], k[i]);
    if (!CODES || p != nullptr) store8(p, v);
    if constexpr (CODES) {
      float f[8];
      floats_of<OutT, 8>(v, f);
      put_codes<8>(codes, steps, px, ch, f);
    }
  }
};

// A persistent block walks tiles blockIdx.x, + gridDim.x, ...; thread 0
// loads the next tile's box by TMA while the block computes this one.
template <typename OutT, int ACT, bool CODES>
__global__ void __launch_bounds__(kDwThreads, 3)
    qconv_dw_tile_kernel(const __grid_constant__ CUtensorMap xmap,
                         const int8_t* __restrict__ w,
                         const float* __restrict__ mult,
                         const float* __restrict__ bias,
                         OutT* __restrict__ out, int N, int H, int W, int C,
                         int tw, int th, int ct, int tiles_x, int tiles_y,
                         int tiles, const __grid_constant__ QCodes codes) {
  extern __shared__ unsigned char dw_raw[];
  unsigned char* boxes = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dw_raw) + kDwAlign - 1) &
      ~(uintptr_t)(kDwAlign - 1));
  const int box_bytes = dw_box_bytes(tw, th, ct);
  const uint32_t bar0 = smem_u32(boxes + 2 * box_bytes);
  struct Tile {
    int x0, y0, n, c0;
  };
  auto tile_of = [&](int t) {
    Tile r;
    r.x0 = (t % tiles_x) * tw;
    t /= tiles_x;
    r.y0 = (t % tiles_y) * th;
    t /= tiles_y;
    r.n = t % N;
    r.c0 = (t / N) * ct;
    return r;
  };
  // the tile and its one-pixel halo, ct channels: the halo past the
  // image's edge (and channels past C) arrive as zeros
  auto load = [&](int t, int b) {
    const Tile r = tile_of(t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar0 + 8 * b, (uint32_t)(ct * (tw + 2) * (th + 2)));
    tma_load(smem_u32(boxes + b * box_bytes), &xmap, bar0 + 8 * b, r.c0,
             r.x0 - 1, r.y0 - 1, r.n);
  };
  if (threadIdx.x == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && (int)blockIdx.x < tiles) load(blockIdx.x, 0);

  const bool odd = threadIdx.x & 1;
  const int rowb = (tw + 2) * ct;
  const CodeSteps steps = CODES ? CodeSteps(codes) : CodeSteps();
  int i = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int b = i & 1;
    // the other box was read in the previous round, which every thread
    // has left (the __syncthreads below)
    if (threadIdx.x == 0 && t + (int)gridDim.x < tiles)
      load(t + gridDim.x, b ^ 1);
    const Tile tile = tile_of(t);
    mbar_wait(bar0 + 8 * b, (i >> 1) & 1);
    const unsigned char* tile_in = boxes + b * box_bytes;

    // an item: 4 channels (one word) of one column of kDwStrip output
    // pixels; items run channel word fastest, so a warp reads consecutive
    // words of shared memory, and lanes 2i, 2i + 1 hold 8 channels of one
    // pixel (C % 16 == 0)
    const int words = min(ct, C - tile.c0) / 4;
    const int items = words * tw * (th / kDwStrip);
    for (int base = 0; base < items; base += kDwThreads) {
      const int it = base + threadIdx.x;
      const bool ok = it < items;  // pairs are both in or both out
      const int cw = ok ? it % words : 0;
      const int px = ok ? (it / words) % tw : 0;
      const int strip = ok ? it / (words * tw) : 0;
      const int c = tile.c0 + 4 * cw;
      // the three taps of row ky of channel c + e, packed for __dp4a
      int wk[3][4];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int* wr = reinterpret_cast<const int*>(w + 3 * ky * C + c);
        const int w0 = wr[0], w1 = wr[C / 4], w2 = wr[C / 2];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wk[ky][e] = pack3(w0, w1, w2, e) & 0xFFFFFF;
      }
      int acc[kDwStrip][4];
#pragma unroll
      for (int o = 0; o < kDwStrip; ++o)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[o][e] = 0;
      // input row r of the strip feeds output rows r - 2 .. r: its three
      // neighbours of each channel are packed once and each __dp4a takes
      // one row of taps
      const unsigned char* col =
          tile_in + strip * kDwStrip * rowb + px * ct + 4 * cw;
#pragma unroll
      for (int r = 0; r < kDwStrip + 2; ++r) {
        const int* in = reinterpret_cast<const int*>(col + r * rowb);
        const int v0 = in[0], v1 = in[ct / 4], v2 = in[ct / 2];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int xw = pack3(v0, v1, v2, e);
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            const int o = r - ky;
            if (o >= 0 && o < kDwStrip)
              acc[o][e] = __dp4a(xw, wk[ky][e], acc[o][e]);
          }
        }
      }
      // pairs swap halves: the even lane stores rows 0, 2, .., the odd one
      // rows 1, 3, .., each all 8 channels, 16 bytes of bf16 a store
      const int c8 = tile.c0 + 4 * (cw & ~1);
      const int x = tile.x0 + px;
      Store8Cols<OutT, ACT, CODES> cols;
      cols.load(mult + c8, bias + c8);
#pragma unroll
      for (int pr = 0; pr < kDwStrip / 2; ++pr) {
        int v8[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int mine = odd ? acc[2 * pr + 1][e] : acc[2 * pr][e];
          const int theirs = __shfl_xor_sync(
              0xffffffffu, odd ? acc[2 * pr][e] : acc[2 * pr + 1][e], 1);
          v8[e] = odd ? theirs : mine;
          v8[e + 4] = odd ? mine : theirs;
        }
        const int y = tile.y0 + strip * kDwStrip + 2 * pr + (odd ? 1 : 0);
        if (ok && x < W && y < H) {
          const long long m = ((long long)tile.n * H + y) * W + x;
          cols.put(out != nullptr ? out + m * C + c8 : nullptr, v8, codes,
                   steps, m, c8);
        }
      }
    }
    __syncthreads();
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point (no link against libcuda); null where the driver lacks it
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// a tiled int8 tensor map: dims and box innermost first, strides (bytes)
// of dims 1.. (multiples of 16: the wrappers' Cin % 16 / C % 16), zero
// fill out of range
inline cudaError_t encode_map(CUtensorMap* map, const void* base, int rank,
                              const cuuint64_t* dims,
                              const cuuint64_t* strides,
                              const cuuint32_t* box, int swizzle_bytes) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16) return cudaErrorInvalidValue;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz =
      swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : swizzle_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                            : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, (cuuint32_t)rank,
         const_cast<void*>(base), dims, strides, box, ones,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the plan of one wgmma launch (ops/qconv.py `dense_plan`): the box is 8
// x bh x bn pixels
struct WgPlan {
  int bh, bn, wn, stages;
};

inline int log2_exact(int v) {  // -1 unless v is a power of two
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

template <int BN, typename OutT, int ACT, bool CODES>
cudaError_t launch_wgmma_n(const void* x, const void* w, const void* mult,
                           const void* bias, void* out, int N, int H, int W,
                           int Cin, int Cout, int ks, const WgPlan& pl,
                           const QCodes& codes, cudaStream_t stream) {
  WgParams p;
  p.mult = static_cast<const float*>(mult);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.codes = codes;
  p.N = N, p.H = H, p.W = W, p.Cin = Cin, p.Cout = Cout, p.ks = ks;
  p.bh_log = log2_exact(pl.bh), p.bn_log = log2_exact(pl.bn);
  p.planes = wg_planes(Cin);
  p.plane_bytes = wg_plane_bytes(pl.bh, pl.bn, ks);
  p.stages = pl.stages;
  p.tiles_x = (W + kWgBoxW - 1) / kWgBoxW;
  p.tiles_y = (H + pl.bh - 1) / pl.bh;
  p.tiles_n = (N + pl.bn - 1) / pl.bn;
  const long long tiles =
      (long long)p.tiles_x * p.tiles_y * p.tiles_n * ((Cout + BN - 1) / BN);
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  p.tiles = (int)tiles;

  // the input as (C, W, H, N), a box of one 16-channel plane of the tile
  // with its halo; the weights as (Cin, k * k, Cout), a box of one plane
  // of one tap for BN output channels
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)N};
  const cuuint64_t xstrides[3] = {(cuuint64_t)Cin, (cuuint64_t)W * Cin,
                                  (cuuint64_t)H * W * Cin};
  const cuuint32_t xbox[4] = {16, (cuuint32_t)(kWgBoxW + ks - 1),
                              (cuuint32_t)(pl.bh + ks - 1),
                              (cuuint32_t)pl.bn};
  cudaError_t e = encode_map(&xmap, x, 4, xdims, xstrides, xbox, 0);
  if (e != cudaSuccess) return e;
  const cuuint64_t wdims[3] = {(cuuint64_t)Cin, (cuuint64_t)(ks * ks),
                               (cuuint64_t)Cout};
  const cuuint64_t wstrides[2] = {(cuuint64_t)Cin, (cuuint64_t)ks * ks * Cin};
  const cuuint32_t wbox[3] = {16, 1, (cuuint32_t)BN};
  e = encode_map(&wmap, w, 3, wdims, wstrides, wbox, 0);
  if (e != cudaSuccess) return e;

  const int smem =
      wg_smem(Cin, ks, pl.bh, pl.bn, BN, pl.stages, (int)sizeof(OutT));
  if (smem > kMaxDynamicSmem) return cudaErrorInvalidValue;
  const void* fn = (const void*)qconv_wgmma_kernel<BN, OutT, ACT, CODES>;
  int per_sm = 0;
  e = launch_setup(fn, kWgThreads, smem, &per_sm);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  qconv_wgmma_kernel<BN, OutT, ACT, CODES>
      <<<wave_grid(per_sm, p.tiles), kWgThreads, smem, stream>>>(xmap, wmap,
                                                                 p);
  return cudaGetLastError();
}

template <typename OutT, int ACT, bool CODES>
cudaError_t launch_wgmma_c(const void* x, const void* w, const void* mult,
                           const void* bias, void* out, int N, int H, int W,
                           int Cin, int Cout, int ks, const WgPlan& pl,
                           const QCodes& codes, cudaStream_t stream) {
  switch (pl.wn) {
#define HELMET_WGMMA_CASE(BN)                                              \
  case BN:                                                                 \
    return launch_wgmma_n<BN, OutT, ACT, CODES>(x, w, mult, bias, out, N, \
                                                H, W, Cin, Cout, ks, pl,   \
                                                codes, stream);
    HELMET_WGMMA_CASE(32)
    HELMET_WGMMA_CASE(48)
    HELMET_WGMMA_CASE(64)
    HELMET_WGMMA_CASE(96)
    HELMET_WGMMA_CASE(128)
    HELMET_WGMMA_CASE(256)
#undef HELMET_WGMMA_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename OutT, int ACT>
cudaError_t launch_wgmma(const void* x, const void* w, const void* mult,
                         const void* bias, void* out, int N, int H, int W,
                         int Cin, int Cout, int ks, const WgPlan& pl,
                         const QCodes& codes, cudaStream_t stream) {
  if constexpr (kHasCodes<OutT>)
    if (host_codes(codes))
      return launch_wgmma_c<OutT, ACT, true>(x, w, mult, bias, out, N, H, W,
                                             Cin, Cout, ks, pl, codes,
                                             stream);
  return launch_wgmma_c<OutT, ACT, false>(x, w, mult, bias, out, N, H, W,
                                          Cin, Cout, ks, pl, codes, stream);
}

// the plan of one tiled depthwise launch (ops/qconv.py `dw_plan`)
template <typename OutT, int ACT, bool CODES>
cudaError_t launch_dw_tile_c(const void* x, const void* w, const void* mult,
                             const void* bias, void* out, int N, int H,
                             int W, int C, int tw, int th, int ct,
                             const QCodes& codes, cudaStream_t stream) {
  CUtensorMap xmap;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C, (cuuint64_t)W * C,
                                 (cuuint64_t)H * W * C};
  const cuuint32_t box[4] = {(cuuint32_t)ct, (cuuint32_t)(tw + 2),
                             (cuuint32_t)(th + 2), 1};
  cudaError_t e = encode_map(&xmap, x, 4, dims, strides, box, 0);
  if (e != cudaSuccess) return e;
  const int smem = dw_tile_smem(tw, th, ct);
  const void* fn = (const void*)qconv_dw_tile_kernel<OutT, ACT, CODES>;
  int per_sm = 0;
  e = launch_setup(fn, kDwThreads, smem, &per_sm);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles_x = (W + tw - 1) / tw, tiles_y = (H + th - 1) / th;
  const long long tiles =
      (long long)tiles_x * tiles_y * N * ((C + ct - 1) / ct);
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  qconv_dw_tile_kernel<OutT, ACT, CODES>
      <<<wave_grid(per_sm, tiles), kDwThreads, smem, stream>>>(
          xmap, static_cast<const int8_t*>(w),
          static_cast<const float*>(mult), static_cast<const float*>(bias),
          static_cast<OutT*>(out), N, H, W, C, tw, th, ct, tiles_x, tiles_y,
          (int)tiles, codes);
  return cudaGetLastError();
}

template <typename OutT, int ACT>
cudaError_t launch_dw_tile(const void* x, const void* w, const void* mult,
                           const void* bias, void* out, int N, int H, int W,
                           int C, int tw, int th, int ct,
                           const QCodes& codes, cudaStream_t stream) {
  if constexpr (kHasCodes<OutT>)
    if (host_codes(codes))
      return launch_dw_tile_c<OutT, ACT, true>(x, w, mult, bias, out, N, H,
                                               W, C, tw, th, ct, codes,
                                               stream);
  return launch_dw_tile_c<OutT, ACT, false>(x, w, mult, bias, out, N, H, W,
                                            C, tw, th, ct, codes, stream);
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

// Every entry below refuses an int8 input or weight pointer (the
// quantizer and the abs-max: their input) that is not 16-byte aligned,
// and a code output that is not, with cudaErrorMisalignedAddress: the
// kernels read them by 16-byte loads and TMA. The check is made here, so
// the Python op and the C++ op library run the same one.
static inline bool helmet_misaligned(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) %
             16 != 0;
}

// A conv entry's code outputs: `codes` null (none) or 8 values {p0, step0,
// off0, stride0, p1, step1, off1, stride1}, p = 0 where there is no such
// output. A code output takes a float output type, a step, a 16-byte
// aligned base, an offset and a stride that are multiples of 8, and room
// for Cout channels; without any, the float output must be there.
static inline int helmet_codes(const long long* a, int cout, int dtype,
                               const void* out, helmet::QCodes* c) {
  *c = helmet::QCodes{};
  bool any = false;
  for (int i = 0; a != nullptr && i < 2; ++i) {
    const long long* d = a + 4 * i;
    if (d[0] == 0) continue;
    const long long off = d[2], stride = d[3];
    if (dtype == helmet::kQI32 || d[1] == 0 || off < 0 || off % 8 ||
        stride % 8 || off + cout > stride || stride >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    if (d[0] % 16) return (int)cudaErrorMisalignedAddress;
    c->p[i] = reinterpret_cast<int8_t*>(d[0]);
    c->step[i] = reinterpret_cast<const float*>(d[1]);
    c->off[i] = (int)off;
    c->stride[i] = (int)stride;
    any = true;
  }
  return out == nullptr && !any ? (int)cudaErrorInvalidValue : 0;
}

extern "C" int helmet_qconv_dense(const void* x, const void* w,
                                  const void* mult, const void* bias,
                                  void* out, int N, int H, int W, int Cin,
                                  int Cout, int ks, int dtype, int act,
                                  const long long* codes, void* stream) {
  if (helmet_misaligned(x, w)) return (int)cudaErrorMisalignedAddress;
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin % 16 || Cout <= 0 ||
      Cout % 8 || (ks != 1 && ks != 3) || N >= 512 || H >= 2048 ||
      W >= 2048 || (long long)N * H * W >= (1LL << 31) - helmet::kBM)
    return (int)cudaErrorInvalidValue;
  helmet::QCodes c;
  const int err = helmet_codes(codes, Cout, dtype, out, &c);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HELMET_QDISPATCH(launch_dense, x, w, mult, bias, out, N, H, W, Cin, Cout,
                   ks, c, s);
}

extern "C" int helmet_qconv_dw(const void* x, const void* w, const void* mult,
                               const void* bias, void* out, int N, int H,
                               int W, int C, int dtype, int act,
                               const long long* codes, void* stream) {
  if (helmet_misaligned(x, w)) return (int)cudaErrorMisalignedAddress;
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 ||
      (long long)N * H * W * (C / 8) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  helmet::QCodes c;
  const int err = helmet_codes(codes, C, dtype, out, &c);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HELMET_QDISPATCH(launch_dw, x, w, mult, bias, out, N, H, W, C, c, s);
}

// out0 = the codes of x at *step0; out1, where not null, at *step1
extern "C" int helmet_quantize(const void* x, const void* step0, void* out0,
                               const void* step1, void* out1, long long n,
                               int dtype, void* stream) {
  if (helmet_misaligned(x, out0) ||
      (out1 != nullptr && helmet_misaligned(out1, out1)))
    return (int)cudaErrorMisalignedAddress;
  if (n <= 0 || (out1 != nullptr && step1 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == helmet::kF32)
    return (int)helmet::launch_quantize<float>(x, step0, out0, step1, out1,
                                                n, s);
  if (dtype == helmet::kBF16)
    return (int)helmet::launch_quantize<__nv_bfloat16>(x, step0, out0, step1,
                                                        out1, n, s);
  return (int)cudaErrorInvalidValue;
}

// *out (a float) = max |x|; part: part_cap floats of scratch, ticket: an
// unsigned counter that is 0 (and left at 0)
extern "C" int helmet_abs_max(const void* x, long long n, int dtype,
                              void* part, int part_cap, void* ticket,
                              void* out, void* stream) {
  if (helmet_misaligned(x, x)) return (int)cudaErrorMisalignedAddress;
  if (n <= 0 || part_cap < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == helmet::kF32)
    return (int)helmet::launch_absmax<float>(x, n, part, part_cap, ticket,
                                              out, s);
  if (dtype == helmet::kBF16)
    return (int)helmet::launch_absmax<__nv_bfloat16>(x, n, part, part_cap,
                                                      ticket, out, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int helmet_qconv_wgmma(const void* x, const void* w,
                                  const void* mult, const void* bias,
                                  void* out, int N, int H, int W, int Cin,
                                  int Cout, int ks, int bh, int bn, int wn,
                                  int stages, int dtype, int act,
                                  const long long* codes, void* stream) {
  if (helmet_misaligned(x, w)) return (int)cudaErrorMisalignedAddress;
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin % 16 || Cout <= 0 ||
      Cout % 8 || (ks != 1 && ks != 3) ||
      (long long)N * H * W >= (1LL << 31) || (bh != 8 && bh != 16) ||
      helmet::log2_exact(bn) < 0 ||
      helmet::kWgBoxW * bh * bn != helmet::kWgRows || stages < 1 ||
      stages > helmet::kWgMaxStages)
    return (int)cudaErrorInvalidValue;
  helmet::QCodes c;
  const int err = helmet_codes(codes, Cout, dtype, out, &c);
  if (err) return err;
  const helmet::WgPlan plan{bh, bn, wn, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HELMET_QDISPATCH(launch_wgmma, x, w, mult, bias, out, N, H, W, Cin, Cout,
                   ks, plan, c, s);
}

extern "C" int helmet_qconv_dw_tile(const void* x, const void* w,
                                    const void* mult, const void* bias,
                                    void* out, int N, int H, int W, int C,
                                    int tw, int th, int ct, int dtype,
                                    int act, const long long* codes,
                                    void* stream) {
  if (helmet_misaligned(x, w)) return (int)cudaErrorMisalignedAddress;
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 || ct <= 0 ||
      ct % 16 || ct > 256 || tw < 1 || tw + 2 > 256 || th < 1 ||
      th % helmet::kDwStrip || th + 2 > 256 ||
      helmet::dw_tile_smem(tw, th, ct) > helmet::kMaxDynamicSmem)
    return (int)cudaErrorInvalidValue;
  helmet::QCodes c;
  const int err = helmet_codes(codes, C, dtype, out, &c);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HELMET_QDISPATCH(launch_dw_tile, x, w, mult, bias, out, N, H, W, C, tw, th,
                   ct, c, s);
}
