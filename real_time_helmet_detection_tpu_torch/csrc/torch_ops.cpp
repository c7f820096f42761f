// The `helmet` operator library for programs that run without Python: the
// eval path's hand-written kernels as dispatcher operators, for the
// AOTInductor runner (cpp/runner.cc) that loads an exported predict.
//
// Replaces: the JAX package's export runs its program through PJRT
// (real_time_helmet_detection_tpu/export.py:60 `export_predict`,
// cpp/pjrt_runner/runner.cc), with the Pallas kernels forced off at export
// (export.py:80). The port's program keeps its kernels: an exported graph
// calls `helmet::peak_scores`, `helmet::bn_act`, `helmet::bn_add_act`,
// `helmet::quantize_act`, `helmet::qconv_dense` and `helmet::qconv_dw`, and
// this library gives each its CUDA implementation, which calls the same C
// entry of csrc/*.cu as the Python op (ops/library.py) does, on the current
// CUDA stream (the one AOTInductor runs the program on). The int8 convs'
// code-writing forms (`helmet::qconv_dense_codes`, `qconv_dw_codes`)
// write their codes into the tensors they are given (`Tensor(a!)`
// arguments), as the Python ops do; `helmet::quantize_act2` quantizes at
// two steps in one launch.
//
// * The schema strings are the Python ones, character for character
//   (tests/test_torch_export.py parses them out of this file).
// * Everything a plan needs that depends only on shapes comes in as the
//   op's arguments, computed by the Python wrapper at trace time; the
//   choices that depend on pointers (the vector or scalar variant of the
//   peak test and the epilogue, the 16-byte checks of the int8 kernels) are
//   made inside the C entries, one decision for both processes.
// * Every launch adds one to an atomic counter of its op (and variant);
//   `helmet_op_counts` reads them. A failed launch throws; nothing falls
//   back to a plain version.
// * The Python process never loads this library: it registers the same
//   namespace itself, and a namespace is defined once a process.
//
// Built by ops/_build.py with g++ against the installed torch, linked to the
// kernel libraries it calls.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <atomic>
#include <optional>
#include <string>
#include <tuple>
#include <vector>

#ifndef HELMET_OPS_DIGEST
#error "build with -DHELMET_OPS_DIGEST (ops/_build.py)"
#endif
#ifndef HELMET_KERNEL_DIGESTS
#error "build with -DHELMET_KERNEL_DIGESTS (ops/_build.py)"
#endif

extern "C" {
int helmet_peak_pick(const void*, const void*, int, int, int);
int helmet_peak_scores(const void*, void*, int, int, int, int, int, int,
                       long long, int, void*);
int helmet_bn_act_pick(const void*, const void*, int, int);
int helmet_bn_act(const void*, const void*, const void*, void*, long long,
                  int, int, int, void*);
int helmet_bn_act_vec(const void*, const void*, const void*, void*,
                      long long, int, int, int, void*);
int helmet_bn_add_act(const void*, const void*, const void*, const void*,
                      void*, long long, int, int, int, void*);
int helmet_quantize(const void*, const void*, void*, const void*, void*,
                    long long, int, void*);
int helmet_qconv_dense(const void*, const void*, const void*, const void*,
                       void*, int, int, int, int, int, int, int, int,
                       const long long*, void*);
int helmet_qconv_wgmma(const void*, const void*, const void*, const void*,
                       void*, int, int, int, int, int, int, int, int, int,
                       int, int, int, const long long*, void*);
int helmet_qconv_dw(const void*, const void*, const void*, const void*,
                    void*, int, int, int, int, int, int, const long long*,
                    void*);
int helmet_qconv_dw_tile(const void*, const void*, const void*, const void*,
                         void*, int, int, int, int, int, int, int, int, int,
                         const long long*, void*);
}

namespace {

// the launch counters, in the order of kCounterNames (the names of
// chip_smoke.py's COUNTERS)
enum Counter {
  kPeak, kPeakVec, kPeakScalar, kBnAct, kBnActVec, kBnActScalar, kBnAddAct,
  kQuant, kQuantDual, kDense, kDenseWgmma, kDenseMma, kDenseCodes, kDw,
  kDwTiled, kDwGather, kDwCodes, kCounters
};
const char* const kCounterNames =
    "peak_scores,peak_vec,peak_scalar,bn_act,bn_act_vec,bn_act_scalar,"
    "bn_add_act,quantize_act,quantize_act_dual,qconv_dense,"
    "qconv_dense_wgmma,qconv_dense_mma,qconv_dense_codes,qconv_dw,"
    "qconv_dw_tiled,qconv_dw_gather,qconv_dw_codes";
std::atomic<long long> counts[kCounters];

void count(Counter a, Counter b = kCounters) {
  counts[a].fetch_add(1, std::memory_order_relaxed);
  if (b != kCounters) counts[b].fetch_add(1, std::memory_order_relaxed);
}

// cudaErrorMisalignedAddress: the int8 entries' refusal of an operand that
// is not 16-byte aligned
constexpr int kMisaligned = 716;

void check(int err, const std::string& what) {
  TORCH_CHECK(err != kMisaligned, what,
              ": an int8 operand is not 16-byte aligned");
  TORCH_CHECK(err == 0, what, ": CUDA error ", err, " at launch");
}

void* stream_of(const at::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

int dtype_code(const at::Tensor& t) {  // common.cuh Dtype
  if (t.scalar_type() == at::kFloat) return 0;
  TORCH_CHECK(t.scalar_type() == at::kBFloat16,
              "helmet ops take float32 or bfloat16, got ", t.scalar_type());
  return 1;
}

int act_code(c10::string_view act) {  // common.cuh Act
  if (act == "ReLU") return 0;
  if (act == "Mish") return 1;
  TORCH_CHECK(act == "Linear", "activation ", std::string(act),
              " has no kernel");
  return 2;
}

at::ScalarType out_dtype(int64_t code) {  // qconv.cu's output codes
  TORCH_CHECK(code >= 0 && code <= 2, "out_dtype code ", code);
  return code == 0 ? at::kFloat : code == 1 ? at::kBFloat16 : at::kInt;
}

at::Tensor channels_last(at::IntArrayRef sizes, const at::Tensor& like,
                         at::ScalarType dtype) {
  return at::empty(sizes, like.options().dtype(dtype).memory_format(
                              at::MemoryFormat::ChannelsLast));
}

void check_cuda(const at::Tensor& t, const char* what) {
  TORCH_CHECK(t.is_cuda(), what, ": the helmet op library runs on CUDA");
}

at::Tensor peak_scores(const at::Tensor& logits, int64_t num_cls,
                       int64_t pool_size, int64_t tiles,
                       c10::string_view variant) {
  check_cuda(logits, "helmet::peak_scores");
  TORCH_CHECK(logits.dim() == 5 && logits.scalar_type() == at::kFloat &&
                  logits.is_contiguous(),
              "helmet::peak_scores: contiguous (B, S, h, w, K) float32");
  const c10::cuda::CUDAGuard guard(logits.device());
  const int64_t b = logits.size(0), s = logits.size(1), h = logits.size(2),
                w = logits.size(3), k = logits.size(4);
  at::Tensor out = at::empty({b, s, num_cls, h, w}, logits.options());
  if (out.numel() == 0) return out;
  const int vec =
      variant == "auto"
          ? helmet_peak_pick(logits.data_ptr(), out.data_ptr(), num_cls, k, w)
          : variant == "vector";
  check(helmet_peak_scores(logits.data_ptr(), out.data_ptr(), b * s, num_cls,
                           h, w, k, (pool_size - 1) / 2, tiles, vec,
                           stream_of(logits)),
        vec ? "helmet::peak_scores (vector variant)"
            : "helmet::peak_scores (scalar variant)");
  count(kPeak, vec ? kPeakVec : kPeakScalar);
  return out;
}

at::Tensor bn_act(const at::Tensor& x, const at::Tensor& eff_scale,
                  const at::Tensor& eff_bias, c10::string_view activation,
                  c10::string_view variant) {
  check_cuda(x, "helmet::bn_act");
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = at::empty_like(x);
  if (x.numel() == 0) return out;
  const int dt = dtype_code(x), c = x.size(1);
  const int vec = variant == "auto"
                      ? helmet_bn_act_pick(x.data_ptr(), out.data_ptr(), c, dt)
                      : variant == "vector";
  const auto entry = vec ? helmet_bn_act_vec : helmet_bn_act;
  check(entry(x.data_ptr(), eff_scale.data_ptr(), eff_bias.data_ptr(),
              out.data_ptr(), x.numel(), c, dt, act_code(activation),
              stream_of(x)),
        vec ? "helmet::bn_act (vector kernel)" : "helmet::bn_act (scalar kernel)");
  count(kBnAct, vec ? kBnActVec : kBnActScalar);
  return out;
}

at::Tensor bn_add_act(const at::Tensor& y, const at::Tensor& eff_scale,
                      const at::Tensor& eff_bias, const at::Tensor& skip,
                      c10::string_view activation) {
  check_cuda(y, "helmet::bn_add_act");
  const c10::cuda::CUDAGuard guard(y.device());
  at::Tensor out = at::empty_like(y);
  if (y.numel() == 0) return out;
  check(helmet_bn_add_act(y.data_ptr(), eff_scale.data_ptr(),
                          eff_bias.data_ptr(), skip.data_ptr(), out.data_ptr(),
                          y.numel(), y.size(1), dtype_code(y),
                          act_code(activation), stream_of(y)),
        "helmet::bn_add_act");
  count(kBnAddAct);
  return out;
}

std::vector<at::Tensor> quantize(const at::Tensor& x,
                                 std::vector<at::Tensor> steps) {
  check_cuda(x, "helmet::quantize_act");
  const c10::cuda::CUDAGuard guard(x.device());
  std::vector<at::Tensor> outs;
  for (size_t i = 0; i < steps.size(); ++i)
    outs.push_back(channels_last(x.sizes(), x, at::kChar));
  if (x.numel() == 0) return outs;
  const bool dual = steps.size() == 2;
  check(helmet_quantize(x.data_ptr(), steps[0].data_ptr(),
                        outs[0].data_ptr(),
                        dual ? steps[1].data_ptr() : nullptr,
                        dual ? outs[1].data_ptr() : nullptr, x.numel(),
                        dtype_code(x), stream_of(x)),
        "helmet::quantize_act");
  count(kQuant, dual ? kQuantDual : kCounters);
  return outs;
}

at::Tensor quantize_act(const at::Tensor& x, const at::Tensor& step) {
  return quantize(x, {step})[0];
}

std::tuple<at::Tensor, at::Tensor> quantize_act2(const at::Tensor& x,
                                                 const at::Tensor& step,
                                                 const at::Tensor& step2) {
  const std::vector<at::Tensor> outs = quantize(x, {step, step2});
  return {outs[0], outs[1]};
}

// A conv op's code outputs as its C entry's array (ops/library.py
// `_code_array`): false where there is none.
struct Codes {
  long long v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  bool any = false;
  Codes() = default;  // none: the plain ops
  Codes(const at::Tensor& c0, const at::Tensor& s0, int64_t o0,
        const std::optional<at::Tensor>& c1,
        const std::optional<at::Tensor>& s1, int64_t o1) {
    set(0, c0, s0, o0);
    set(1, c1, s1, o1);
  }
  void set(int i, const std::optional<at::Tensor>& c,
           const std::optional<at::Tensor>& s, int64_t off) {
    if (!c.has_value()) return;
    TORCH_CHECK(s.has_value(), "helmet: a code output without its step");
    v[4 * i] = reinterpret_cast<long long>(c->data_ptr());
    v[4 * i + 1] = reinterpret_cast<long long>(s->data_ptr());
    v[4 * i + 2] = off;
    v[4 * i + 3] = c->size(1);
    any = true;
  }
  const long long* ptr() const { return any ? v : nullptr; }
};

at::Tensor conv_out(at::IntArrayRef sizes, const at::Tensor& q,
                    int64_t dtype, bool store) {
  if (!store) return at::empty({0}, q.options().dtype(out_dtype(dtype)));
  return channels_last(sizes, q, out_dtype(dtype));
}

at::Tensor dense(const at::Tensor& q, const at::Tensor& w,
                 const at::Tensor& mult, const at::Tensor& bias,
                 int64_t dtype, c10::string_view activation,
                 c10::string_view variant, int64_t bh, int64_t bn,
                 int64_t wn, int64_t stages, bool store, const Codes& c) {
  check_cuda(q, "helmet::qconv_dense");
  const c10::cuda::CUDAGuard guard(q.device());
  const int n = q.size(0), cin = q.size(1), h = q.size(2), wd = q.size(3);
  const int cout = w.size(0), k = w.size(1);
  at::Tensor out = conv_out({n, cout, h, wd}, q, dtype, store);
  if ((long long)n * h * wd * cout == 0) return out;
  void* o = store ? out.data_ptr() : nullptr;
  const bool wgmma = variant == "wgmma";
  const int act = act_code(activation);
  const int err =
      wgmma ? helmet_qconv_wgmma(q.data_ptr(), w.data_ptr(), mult.data_ptr(),
                                 bias.data_ptr(), o, n, h, wd, cin, cout, k,
                                 bh, bn, wn, stages, dtype, act, c.ptr(),
                                 stream_of(q))
            : helmet_qconv_dense(q.data_ptr(), w.data_ptr(), mult.data_ptr(),
                                 bias.data_ptr(), o, n, h, wd, cin, cout, k,
                                 dtype, act, c.ptr(), stream_of(q));
  check(err, wgmma ? "helmet::qconv_dense (wgmma kernel)"
                   : "helmet::qconv_dense (mma kernel)");
  count(kDense, wgmma ? kDenseWgmma : kDenseMma);
  if (c.any) count(kDenseCodes);
  return out;
}

at::Tensor qconv_dense(const at::Tensor& q, const at::Tensor& w,
                       const at::Tensor& mult, const at::Tensor& bias,
                       int64_t dtype, c10::string_view activation,
                       c10::string_view variant, int64_t bh, int64_t bn,
                       int64_t wn, int64_t stages) {
  return dense(q, w, mult, bias, dtype, activation, variant, bh, bn, wn,
               stages, true, Codes());
}

at::Tensor qconv_dense_codes(const at::Tensor& q, const at::Tensor& w,
                             const at::Tensor& mult, const at::Tensor& bias,
                             int64_t dtype, c10::string_view activation,
                             c10::string_view variant, int64_t bh,
                             int64_t bn, int64_t wn, int64_t stages,
                             bool store, const at::Tensor& codes,
                             const at::Tensor& code_step,
                             int64_t code_offset,
                             const std::optional<at::Tensor>& codes2,
                             const std::optional<at::Tensor>& code_step2,
                             int64_t code_offset2) {
  return dense(q, w, mult, bias, dtype, activation, variant, bh, bn, wn,
               stages, store,
               Codes(codes, code_step, code_offset, codes2, code_step2,
                     code_offset2));
}

at::Tensor dw(const at::Tensor& q, const at::Tensor& w,
              const at::Tensor& mult, const at::Tensor& bias, int64_t dtype,
              c10::string_view activation, c10::string_view variant,
              int64_t tw, int64_t th, int64_t ct, bool store,
              const Codes& cs) {
  check_cuda(q, "helmet::qconv_dw");
  const c10::cuda::CUDAGuard guard(q.device());
  const int n = q.size(0), c = q.size(1), h = q.size(2), wd = q.size(3);
  at::Tensor out = conv_out(q.sizes(), q, dtype, store);
  if (q.numel() == 0) return out;
  void* o = store ? out.data_ptr() : nullptr;
  const bool tiled = variant == "tiled";
  const int act = act_code(activation);
  const int err =
      tiled ? helmet_qconv_dw_tile(q.data_ptr(), w.data_ptr(), mult.data_ptr(),
                                   bias.data_ptr(), o, n, h, wd, c, tw, th, ct,
                                   dtype, act, cs.ptr(), stream_of(q))
            : helmet_qconv_dw(q.data_ptr(), w.data_ptr(), mult.data_ptr(),
                              bias.data_ptr(), o, n, h, wd, c, dtype, act,
                              cs.ptr(), stream_of(q));
  check(err, tiled ? "helmet::qconv_dw (tiled kernel)"
                   : "helmet::qconv_dw (gather kernel)");
  count(kDw, tiled ? kDwTiled : kDwGather);
  if (cs.any) count(kDwCodes);
  return out;
}

at::Tensor qconv_dw(const at::Tensor& q, const at::Tensor& w,
                    const at::Tensor& mult, const at::Tensor& bias,
                    int64_t dtype, c10::string_view activation,
                    c10::string_view variant, int64_t tw, int64_t th,
                    int64_t ct) {
  return dw(q, w, mult, bias, dtype, activation, variant, tw, th, ct, true,
            Codes());
}

at::Tensor qconv_dw_codes(const at::Tensor& q, const at::Tensor& w,
                          const at::Tensor& mult, const at::Tensor& bias,
                          int64_t dtype, c10::string_view activation,
                          c10::string_view variant, int64_t tw, int64_t th,
                          int64_t ct, bool store, const at::Tensor& codes,
                          const at::Tensor& code_step, int64_t code_offset,
                          const std::optional<at::Tensor>& codes2,
                          const std::optional<at::Tensor>& code_step2,
                          int64_t code_offset2) {
  return dw(q, w, mult, bias, dtype, activation, variant, tw, th, ct, store,
            Codes(codes, code_step, code_offset, codes2, code_step2,
                  code_offset2));
}

}  // namespace

TORCH_LIBRARY(helmet, m) {
  m.def("peak_scores(Tensor logits, int num_cls, int pool_size, int tiles, "
        "str variant) -> Tensor");
  m.def("bn_act(Tensor x, Tensor eff_scale, Tensor eff_bias, "
        "str activation, str variant) -> Tensor");
  m.def("bn_add_act(Tensor y, Tensor eff_scale, Tensor eff_bias, "
        "Tensor skip, str activation) -> Tensor");
  m.def("quantize_act(Tensor x, Tensor step) -> Tensor");
  m.def("quantize_act2(Tensor x, Tensor step, Tensor step2) "
        "-> (Tensor, Tensor)");
  m.def("qconv_dense(Tensor q, Tensor w, Tensor mult, Tensor bias, "
        "int out_dtype, str activation, str variant, int bh, int bn, "
        "int wn, int stages) -> Tensor");
  m.def("qconv_dense_codes(Tensor q, Tensor w, Tensor mult, Tensor bias, "
        "int out_dtype, str activation, str variant, int bh, int bn, "
        "int wn, int stages, bool store, Tensor(a!) codes, "
        "Tensor code_step, int code_offset, Tensor(b!)? codes2=None, "
        "Tensor? code_step2=None, int code_offset2=0) -> Tensor");
  m.def("qconv_dw(Tensor q, Tensor w, Tensor mult, Tensor bias, "
        "int out_dtype, str activation, str variant, int tw, int th, "
        "int ct) -> Tensor");
  m.def("qconv_dw_codes(Tensor q, Tensor w, Tensor mult, Tensor bias, "
        "int out_dtype, str activation, str variant, int tw, int th, "
        "int ct, bool store, Tensor(a!) codes, Tensor code_step, "
        "int code_offset, Tensor(b!)? codes2=None, "
        "Tensor? code_step2=None, int code_offset2=0) -> Tensor");
}

TORCH_LIBRARY_IMPL(helmet, CUDA, m) {
  m.impl("peak_scores", &peak_scores);
  m.impl("bn_act", &bn_act);
  m.impl("bn_add_act", &bn_add_act);
  m.impl("quantize_act", &quantize_act);
  m.impl("quantize_act2", &quantize_act2);
  m.impl("qconv_dense", &qconv_dense);
  m.impl("qconv_dense_codes", &qconv_dense_codes);
  m.impl("qconv_dw", &qconv_dw);
  m.impl("qconv_dw_codes", &qconv_dw_codes);
}

// The build's identity, which the runner holds against the exported
// program's meta.json: this library's digest and the digests of the
// kernel libraries it is linked to ("peak=...,epilogue=...,...").
extern "C" const char* helmet_ops_digest() { return HELMET_OPS_DIGEST; }
extern "C" const char* helmet_kernel_digests() { return HELMET_KERNEL_DIGESTS; }

// The counter names, comma-separated, in the order helmet_op_counts writes
// them.
extern "C" const char* helmet_op_names() { return kCounterNames; }

// Writes up to n launch counters into out; returns how many there are.
extern "C" int helmet_op_counts(long long* out, int n) {
  for (int i = 0; i < n && i < kCounters; ++i)
    out[i] = counts[i].load(std::memory_order_relaxed);
  return kCounters;
}
