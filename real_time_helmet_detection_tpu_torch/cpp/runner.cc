// torch_runner: runs an exported predict program with no Python.
//
//   torch_runner <export_dir> [--image FILE] [--iters N] [--depth D]
//                [--lib-dir DIR]
//
// The counterpart of the JAX package's PJRT runner
// (cpp/pjrt_runner/runner.cc, which runs exported_predict.stablehlo.mlir
// written by real_time_helmet_detection_tpu/export.py:60), and of the
// reference's C++ libtorch app that runs a TorchScript trace. It
//
// 1. reads <export_dir>/meta.json (written by the port's export.py) and
//    refuses a program exported by another torch or for other kernel or op
//    libraries than the ones it finds;
// 2. dlopens the op library torch_ops-<digest>.so (csrc/torch_ops.cpp: the
//    `helmet` operators, linked to the kernel libraries) from --lib-dir
//    (default: the directory this executable lies in), and checks the
//    digests it was built with against meta.json;
// 3. loads exported_predict.aoti.pt2 with AOTIModelPackageLoader, whose
//    program calls the `helmet` operators through the dispatcher, so the
//    same hand-written kernels run as in the Python process;
// 4. feeds it --image (raw bytes of one image or of the whole batch, in
//    the program's input dtype and (B, H, W, 3) layout; default: a fixed
//    pseudo-random pattern): each frame copies the input from pinned host
//    memory, runs the program and copies the outputs back, on its own
//    stream; after the first frame and up to 10 frames of warm-up,
//    `--iters` frames at depth 1 (per-frame latency, frames/s), then
//    `--iters` frames with up to `--depth` in flight on as many streams
//    (frames/s);
// 5. prints one JSON line with the valid detections of the first frame
//    (per image: [x1, y1, x2, y2, class, score]) and one with the numbers
//    and the op library's launch counters (per frame, from the first
//    frame, and in total).
//
// Exit status: 0 on success; 1 when meta.json, a library, a digest, the
// package or a run fails; 2 on bad arguments.
//
// Built by ops/_build.py with g++ against the installed torch.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/core/Event.h>
#include <c10/core/StreamGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <dlfcn.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

#ifndef HELMET_TORCH_VERSION
#error "build with -DHELMET_TORCH_VERSION (ops/_build.py)"
#endif

namespace {

[[noreturn]] void fail(const std::string& why) {
  std::fprintf(stderr, "torch_runner: %s\n", why.c_str());
  std::exit(1);
}

std::string read_file(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) fail("cannot read " + path);
  std::ostringstream s;
  s << f.rdbuf();
  return s.str();
}

// The value after "key": in meta.json, whose keys are unique: a string's
// contents, an array's text with its brackets, or a number or null as
// written. False when the key is absent.
bool json_value(const std::string& doc, const std::string& key,
                std::string* out) {
  size_t p = doc.find("\"" + key + "\"");
  if (p == std::string::npos) return false;
  p = doc.find(':', p + key.size() + 2);
  if (p == std::string::npos) return false;
  p = doc.find_first_not_of(" \t\r\n", p + 1);
  if (p == std::string::npos) return false;
  if (doc[p] == '"') {
    const size_t e = doc.find('"', p + 1);
    *out = doc.substr(p + 1, e - p - 1);
  } else if (doc[p] == '[') {
    *out = doc.substr(p, doc.find(']', p) - p + 1);
  } else {
    const size_t e = doc.find_first_of(",}\n", p);
    *out = doc.substr(p, e - p);
    out->erase(out->find_last_not_of(" \t\r") + 1);
  }
  return true;
}

std::string meta_string(const std::string& doc, const std::string& key) {
  std::string v;
  if (!json_value(doc, key, &v) || v == "null")
    fail("meta.json has no " + key);
  return v;
}

std::vector<int64_t> meta_ints(const std::string& doc, const std::string& key) {
  std::string v = meta_string(doc, key);
  std::vector<int64_t> out;
  for (char& c : v)
    if (c == '[' || c == ']' || c == ',') c = ' ';
  std::istringstream s(v);
  int64_t x;
  while (s >> x) out.push_back(x);
  return out;
}

std::string exe_dir() {
  char buf[4096];
  const ssize_t n = readlink("/proc/self/exe", buf, sizeof(buf) - 1);
  if (n <= 0) fail("cannot read /proc/self/exe");
  std::string path(buf, n);
  return path.substr(0, path.rfind('/'));
}

template <typename F>
F symbol(void* lib, const char* name) {
  void* p = dlsym(lib, name);
  if (!p) fail(std::string("the op library has no ") + name);
  return reinterpret_cast<F>(p);
}

double percentile(std::vector<double> v, double q) {
  std::sort(v.begin(), v.end());
  const double pos = q / 100.0 * (v.size() - 1);
  const size_t lo = (size_t)pos, hi = std::min(lo + 1, v.size() - 1);
  return v[lo] + (v[hi] - v[lo]) * (pos - lo);
}

double now_ms() {
  return std::chrono::duration<double, std::milli>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// one frame in flight: its stream, the device input, the pinned outputs
// and the event recorded after the outputs' copies
struct Slot {
  c10::cuda::CUDAStream stream;
  at::Tensor input;
  std::vector<at::Tensor> outputs;
  c10::Event done{c10::DeviceType::CUDA};
};

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr,
                 "usage: %s <export_dir> [--image FILE] [--iters N] "
                 "[--depth D] [--lib-dir DIR]\n",
                 argv[0]);
    return 2;
  }
  const std::string dir = argv[1];
  std::string image, lib_dir = exe_dir();
  int iters = 100, depth = 1;
  for (int i = 2; i < argc; ++i) {
    const std::string a = argv[i];
    if (i + 1 >= argc) {
      std::fprintf(stderr, "torch_runner: %s needs a value\n", a.c_str());
      return 2;
    }
    const std::string v = argv[++i];
    if (a == "--image") image = v;
    else if (a == "--iters") iters = std::atoi(v.c_str());
    else if (a == "--depth") depth = std::atoi(v.c_str());
    else if (a == "--lib-dir") lib_dir = v;
    else {
      std::fprintf(stderr, "torch_runner: unknown argument %s\n", a.c_str());
      return 2;
    }
  }
  if (iters < 1 || depth < 1) {
    std::fprintf(stderr, "torch_runner: --iters and --depth must be >= 1\n");
    return 2;
  }

  // 1. meta.json
  const std::string meta = read_file(dir + "/meta.json");
  std::string package;
  if (!json_value(meta, "runner_package", &package) || package == "null")
    fail(dir + " has no runner package (an export on the CPU writes none)");
  const std::string version = meta_string(meta, "torch_version");
  if (version != HELMET_TORCH_VERSION)
    fail("the program was exported by torch " + version +
         ", this runner is built against " HELMET_TORCH_VERSION);
  const std::string ops_digest = meta_string(meta, "op_library");
  const std::vector<int64_t> shape = meta_ints(meta, "input_shape");
  const bool raw = meta_string(meta, "input_dtype") == "uint8";
  if (shape.size() != 4 || shape[3] != 3)
    fail("input_shape must be [B, H, W, 3]");

  // 2. the op library and its digests
  const std::string lib_path = lib_dir + "/torch_ops-" + ops_digest + ".so";
  void* lib = dlopen(lib_path.c_str(), RTLD_NOW | RTLD_GLOBAL);
  if (!lib) fail(std::string("cannot load the op library: ") + dlerror());
  const std::string built = symbol<const char* (*)()>(lib, "helmet_ops_digest")();
  if (built != ops_digest)
    fail("op library digest " + built + ", meta.json wants " + ops_digest);
  std::istringstream kernels(
      symbol<const char* (*)()>(lib, "helmet_kernel_digests")());
  for (std::string kv; std::getline(kernels, kv, ',');) {
    const std::string name = kv.substr(0, kv.find('='));
    const std::string want = meta_string(meta, name);
    if (kv.substr(kv.find('=') + 1) != want)
      fail("kernel library " + kv + ", meta.json wants " + name + "=" + want);
  }
  const auto op_counts = symbol<int (*)(long long*, int)>(lib, "helmet_op_counts");
  std::vector<std::string> names;
  {
    std::istringstream s(symbol<const char* (*)()>(lib, "helmet_op_names")());
    for (std::string n; std::getline(s, n, ',');) names.push_back(n);
  }
  auto counts = [&]() {
    std::vector<long long> c(names.size());
    op_counts(c.data(), (int)c.size());
    return c;
  };

  try {
    // 3. the package, with as many runners as frames in flight
    double t0 = now_ms();
    torch::inductor::AOTIModelPackageLoader loader(dir + "/" + package,
                                                   "model", false,
                                                   (size_t)depth);
    const double load_ms = now_ms() - t0;

    // 4. the input, in pinned host memory
    const auto dtype = raw ? at::kByte : at::kFloat;
    at::Tensor host = at::empty(
        shape, at::TensorOptions().dtype(dtype).pinned_memory(true));
    const size_t total = host.nbytes(), one = total / shape[0];
    if (!image.empty()) {
      const std::string bytes = read_file(image);
      if (bytes.size() != one && bytes.size() != total)
        fail(image + " holds " + std::to_string(bytes.size()) +
             " bytes; one image is " + std::to_string(one));
      for (size_t off = 0; off < total; off += bytes.size())
        std::memcpy(static_cast<char*>(host.data_ptr()) + off, bytes.data(),
                    bytes.size());
    } else {
      uint32_t s = 12345;
      for (int64_t i = 0; i < host.numel(); ++i) {
        s = s * 1664525u + 1013904223u;
        if (raw)
          host.data_ptr<uint8_t>()[i] = (uint8_t)(s >> 24);
        else
          host.data_ptr<float>()[i] = (float)(s >> 8) / (1 << 23) - 1.0f;
      }
    }
    const c10::Device cuda(c10::DeviceType::CUDA, 0);
    std::vector<Slot> slots;
    for (int i = 0; i < depth; ++i)
      slots.push_back(Slot{c10::cuda::getStreamFromPool(false, 0),
                           at::empty(shape, host.options().device(cuda)
                                                .pinned_memory(false)),
                           {}});

    // one frame on slot s: H2D, the program, D2H, an event, all on the
    // slot's stream, which is also the current stream the op library's
    // kernels launch on
    auto frame = [&](Slot& s) {
      const c10::StreamGuard guard(s.stream.unwrap());
      s.input.copy_(host, /*non_blocking=*/true);
      std::vector<at::Tensor> out =
          loader.run({s.input}, reinterpret_cast<void*>(s.stream.stream()));
      if (s.outputs.empty())
        for (const at::Tensor& t : out)
          s.outputs.push_back(at::empty(
              t.sizes(), t.options().device(c10::kCPU).pinned_memory(true)));
      for (size_t k = 0; k < out.size(); ++k)
        s.outputs[k].copy_(out[k], /*non_blocking=*/true);
      s.done.record(s.stream.unwrap());
    };

    // the first frame: its detections and its launches
    const std::vector<long long> before = counts();
    frame(slots[0]);
    slots[0].done.synchronize();
    const std::vector<long long> after = counts();
    const at::Tensor boxes = slots[0].outputs.at(0).to(at::kFloat);
    const at::Tensor classes = slots[0].outputs.at(1).to(at::kLong);
    const at::Tensor scores = slots[0].outputs.at(2).to(at::kFloat);
    const at::Tensor valid = slots[0].outputs.at(3).to(at::kBool);
    std::string dets = "{\"detections\": [";
    char buf[256];
    for (int64_t b = 0; b < boxes.size(0); ++b) {
      dets += b ? ", [" : "[";
      bool first = true;
      for (int64_t n = 0; n < boxes.size(1); ++n) {
        if (!valid[b][n].item<bool>()) continue;
        std::snprintf(buf, sizeof(buf), "%s[%.9g, %.9g, %.9g, %.9g, %lld, %.9g]",
                      first ? "" : ", ", boxes[b][n][0].item<float>(),
                      boxes[b][n][1].item<float>(), boxes[b][n][2].item<float>(),
                      boxes[b][n][3].item<float>(),
                      (long long)classes[b][n].item<int64_t>(),
                      scores[b][n].item<float>());
        dets += buf;
        first = false;
      }
      dets += "]";
    }
    std::printf("%s]}\n", dets.c_str());

    // warm-up (the first calls of a package load its kernels lazily),
    // then depth 1: per-frame latency
    const int warmup = std::min(iters, 10);
    for (int i = 0; i < warmup; ++i) frame(slots[i % depth]);
    for (Slot& s : slots) s.done.synchronize();
    std::vector<double> lat;
    t0 = now_ms();
    for (int i = 0; i < iters; ++i) {
      const double f0 = now_ms();
      frame(slots[0]);
      slots[0].done.synchronize();
      lat.push_back(now_ms() - f0);
    }
    const double fps1 = iters * 1e3 / (now_ms() - t0);
    // depth D: up to D frames in flight, one stream each
    t0 = now_ms();
    for (int i = 0; i < iters; ++i) {
      Slot& s = slots[i % depth];
      if (i >= depth) s.done.synchronize();
      frame(s);
    }
    for (Slot& s : slots) s.done.synchronize();
    const double fpsd = iters * 1e3 / (now_ms() - t0);

    const std::vector<long long> end = counts();
    std::string per_frame, in_total;
    for (size_t i = 0; i < names.size(); ++i) {
      per_frame += (i ? ", \"" : "\"") + names[i] +
                   "\": " + std::to_string(after[i] - before[i]);
      in_total += (i ? ", \"" : "\"") + names[i] +
                  "\": " + std::to_string(end[i] - before[i]);
    }
    std::printf(
        "{\"package\": \"%s\", \"load_ms\": %.3f, \"frames\": %d, "
        "\"batch\": %lld, \"depth\": %d, \"latency_ms_depth1\": {\"p50\": "
        "%.4f, \"p99\": %.4f, \"max\": %.4f}, \"fps_depth1\": %.3f, "
        "\"fps_depth\": %.3f, \"op_calls_per_frame\": {%s}, "
        "\"op_calls_total\": {%s}, \"frames_total\": %d}\n",
        package.c_str(), load_ms, iters, (long long)shape[0], depth,
        percentile(lat, 50), percentile(lat, 99), percentile(lat, 100), fps1,
        fpsd, per_frame.c_str(), in_total.c_str(), 1 + warmup + 2 * iters);
  } catch (const std::exception& e) {
    fail(std::string("run failed: ") + e.what());
  }
  return 0;
}
