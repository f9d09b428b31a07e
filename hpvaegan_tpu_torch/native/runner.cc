// Native runner of the exported sampler on libtorch: the port of the
// repo's native/pjrt_runner/main.cc (reference ascend310_infer/src/main.cc).
//
// Loads the AOTInductor package that `python -m hpvaegan_tpu_torch.export`
// writes (<netG>.aoti.pt2), runs it once per noise_init .bin, writes each
// output as a dense row-major <base>_output_0.bin and the average latency
// to time_Result/test_perform_static.txt.
//
// Usage (hpvaegan_tpu_torch/native/build.py builds it):
//   ./runner --model_path=exp/infer/netG_9.aoti.pt2 \
//       --input0_path=exp/infer/noise_init \
//       --input1_path=exp/infer/noise_amps \
//       --input2_path=exp/infer/seed \
//       --output_dir=exp/infer/result [--warmup=1] [--io_spec_path=...] \
//       [--allow_tf32=0]
//
// Input contract (preprocess.py): input0 = f32 noise_init bins (one
// execution per file), input1 = the f32 noise_amps bin, input2 = the i32
// seed bin; their shapes come from io_spec.txt (default: beside the
// model). Each timed inference is h2d + run + d2h, and ends synchronised.
// The convolutions run in float32, as the exported program computes
// them; --allow_tf32=1 lets cuDNN and cuBLAS use TF32 (PyTorch's default
// for cuDNN) instead.
// A package compiled for CUDA needs a card: without one the runner exits
// non-zero, it never runs on the CPU instead.

#include <sys/stat.h>

#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/cuda.h>

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <filesystem>
#include <fstream>
#include <iostream>
#include <map>
#include <sstream>
#include <string>
#include <vector>

namespace {

[[noreturn]] void Die(const std::string& msg) {
  std::cerr << "runner: " << msg << std::endl;
  exit(1);
}

std::map<std::string, std::string> ParseFlags(int argc, char** argv) {
  std::map<std::string, std::string> flags;
  for (int i = 1; i < argc; ++i) {
    std::string arg = argv[i];
    if (arg.rfind("--", 0) != 0) continue;
    auto eq = arg.find('=');
    if (eq == std::string::npos) continue;
    flags[arg.substr(2, eq - 2)] = arg.substr(eq + 1);
  }
  return flags;
}

int64_t ParseI64(const std::string& value, const std::string& what) {
  try {
    size_t pos = 0;
    int64_t v = std::stoll(value, &pos);
    if (pos != value.size()) throw std::invalid_argument(value);
    return v;
  } catch (const std::exception&) {
    Die("malformed integer for " + what + ": '" + value + "'");
  }
}

std::string ReadFileToString(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) Die("cannot read " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

// the .bin files of a directory, sorted (reference utils.cc:25-44)
std::vector<std::string> GetAllFiles(const std::string& dir) {
  std::vector<std::string> files;
  std::error_code ec;
  for (const auto& entry : std::filesystem::directory_iterator(dir, ec)) {
    if (entry.is_regular_file() && entry.path().extension() == ".bin")
      files.push_back(entry.path().string());
  }
  std::sort(files.begin(), files.end());
  return files;
}

struct IoSpec {
  std::vector<std::vector<int64_t>> dims;
  std::vector<at::ScalarType> types;
};

// io_spec.txt: one line per input, "f32 1,128,24,33" or "s32" (a scalar)
IoSpec ReadIoSpec(const std::string& path) {
  IoSpec spec;
  std::ifstream f(path);
  if (!f) Die("cannot read io spec " + path);
  std::string line;
  while (std::getline(f, line)) {
    if (line.empty()) continue;
    std::istringstream ss(line);
    std::string type, rest;
    ss >> type >> rest;
    if (type == "f32") spec.types.push_back(at::kFloat);
    else if (type == "s32") spec.types.push_back(at::kInt);
    else Die("unknown dtype in io spec: " + type);
    std::vector<int64_t> dims;
    std::istringstream ds(rest);
    std::string tok;
    while (std::getline(ds, tok, ','))
      dims.push_back(ParseI64(tok, "io_spec dim"));
    spec.dims.push_back(dims);
  }
  return spec;
}

// a host .bin as a tensor on `device`; its byte size must match the spec
at::Tensor ToDevice(std::string& data, at::ScalarType type,
                    const std::vector<int64_t>& dims,
                    const c10::Device& device) {
  int64_t expected = 4;
  for (int64_t d : dims) expected *= d;
  if (static_cast<int64_t>(data.size()) != expected)
    Die("input size mismatch: got " + std::to_string(data.size()) +
        " bytes, io_spec expects " + std::to_string(expected) +
        " — stale bins from a previous export/preprocess?");
  return at::from_blob(data.data(), dims, at::TensorOptions().dtype(type))
      .to(device);
}

int Run(const std::map<std::string, std::string>& flags) {
  auto get = [&](const std::string& k, const std::string& dflt) {
    auto it = flags.find(k);
    return it == flags.end() ? dflt : it->second;
  };
  const std::string model_path = get("model_path", "");
  const std::string input0 = get("input0_path", "");
  const std::string input1 = get("input1_path", "");
  const std::string input2 = get("input2_path", "");
  const std::string output_dir = get("output_dir", "result");
  if (model_path.empty() || input0.empty())
    Die("--model_path and --input0_path are required");

  size_t slash = model_path.find_last_of('/');
  std::string spec_default = slash == std::string::npos
      ? "io_spec.txt"
      : model_path.substr(0, slash) + "/io_spec.txt";
  IoSpec spec = ReadIoSpec(get("io_spec_path", spec_default));
  if (spec.types.size() != 3)
    Die("io_spec.txt must describe exactly 3 inputs (noise, amps, seed); "
        "got " + std::to_string(spec.types.size()) +
        " — truncated or stale sidecar?");

  auto meta = torch::inductor::AOTIModelPackageLoader::
      load_metadata_from_package(model_path, "model");
  const std::string device_type =
      meta.count("AOTI_DEVICE_KEY") ? meta["AOTI_DEVICE_KEY"] : "cpu";
  if (device_type == "cuda" && !torch::cuda::is_available())
    Die(model_path + " is compiled for CUDA and no CUDA device is "
        "available");
  const c10::Device device(device_type == "cuda" ? c10::kCUDA : c10::kCPU);
  const bool tf32 = ParseI64(get("allow_tf32", "0"), "--allow_tf32") != 0;
  at::globalContext().setAllowTF32CuDNN(tf32);
  at::globalContext().setAllowTF32CuBLAS(tf32);
  torch::inductor::AOTIModelPackageLoader loader(model_path);
  std::cerr << "loaded " << model_path << " (" << device_type << ")"
            << std::endl;

  // the constant inputs go to the device once, outside the timed loop
  auto amps_files = GetAllFiles(input1);
  auto seed_files = GetAllFiles(input2);
  if (amps_files.empty() || seed_files.empty())
    Die("missing noise_amps/seed bins");
  std::string amps_data = ReadFileToString(amps_files[0]);
  std::string seed_data = ReadFileToString(seed_files[0]);
  at::Tensor amps = ToDevice(amps_data, spec.types[1], spec.dims[1], device);
  at::Tensor seed = ToDevice(seed_data, spec.types[2], spec.dims[2], device);

  mkdir(output_dir.c_str(), 0755);
  mkdir("time_Result", 0755);
  auto input_files = GetAllFiles(input0);
  if (input_files.empty()) Die("no input bins in " + input0);

  // warm-up executions are left out of the latency report
  int warmup = static_cast<int>(ParseI64(get("warmup", "1"), "--warmup"));
  std::vector<std::string> run_list(warmup, input_files[0]);
  run_list.insert(run_list.end(), input_files.begin(), input_files.end());
  double total_ms = 0;
  int runs = 0;
  for (size_t k = 0; k < run_list.size(); ++k) {
    const std::string& file = run_list[k];
    std::string noise = ReadFileToString(file);
    auto t0 = std::chrono::steady_clock::now();
    at::Tensor in0 = ToDevice(noise, spec.types[0], spec.dims[0], device);
    std::vector<at::Tensor> outs = loader.run({in0, amps, seed});
    // the .bin contract is single-output
    if (outs.size() != 1)
      Die("the model has " + std::to_string(outs.size()) +
          " outputs; this runner's .bin contract is single-output");
    at::Tensor host = outs[0].to(c10::kCPU).contiguous();
    if (device.is_cuda()) torch::cuda::synchronize();
    auto t1 = std::chrono::steady_clock::now();
    double ms = std::chrono::duration<double, std::milli>(t1 - t0).count();
    if (static_cast<int>(k) >= warmup) {
      total_ms += ms;
      runs += 1;
      auto base = file.substr(file.find_last_of('/') + 1);
      base = base.substr(0, base.find_last_of('.'));
      std::ofstream out(output_dir + "/" + base + "_output_0.bin",
                        std::ios::binary);
      if (!out) Die("cannot write into " + output_dir);
      out.write(static_cast<const char*>(host.data_ptr()), host.nbytes());
    }
    std::cerr << file << ": " << ms << " ms" << std::endl;
  }

  // latency report (reference main.cc:127-143 contract)
  double avg = total_ms / runs;
  std::ofstream report("time_Result/test_perform_static.txt");
  report << "NN inference cost average time: " << avg
         << " ms of infer_count " << runs << std::endl;
  std::cout << "NN inference cost average time: " << avg
            << " ms of infer_count " << runs << std::endl;
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  try {
    return Run(ParseFlags(argc, argv));
  } catch (const std::exception& e) {
    Die(e.what());
  }
}
