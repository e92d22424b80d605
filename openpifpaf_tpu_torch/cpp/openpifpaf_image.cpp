// Standalone C++ deployment runner of the port: image -> poses, no Python.
//
// Counterpart of the JAX package's cpp/openpifpaf_image.cpp. The model is
// the AOTInductor package written by
//   python -m openpifpaf_tpu_torch.export --format savedmodel --with-decoder
// whose program maps a preprocessed (1, H, W, 3) image to (poses, keep);
// it runs through LibTorch on the device it was compiled for, the card or
// the CPU. The CifHr kernel in it is the operator of csrc/cifhr_op.cpp,
// linked into this binary, which launches csrc/cifhr.cu on the card. Images
// are decoded and preprocessed by the port's native loader
// (../csrc/pifpaf_io.cpp): JPEG where it was built with libjpeg, and binary
// PPM (P6) in every build.
//
// Usage:
//   openpifpaf-tpu-torch-image --model <package.pt2> \
//       [--input-height H --input-width W] [--long-edge 641] \
//       [--instance-threshold 0.15] [--verbose] image1.jpg [image2.ppm ...]
//
// The input size defaults to the package's (export's --input-height and
// --input-width, 481x641 by default); a size that differs is refused.
// Prints one JSON line per image:
//   {"file": "...", "predictions": [{"score": s, "keypoints": [x,y,v, ...]}]}
// With --verbose, stderr gets each image's milliseconds (load, run) and a
// line on all the program's lanes (runner_common.hpp::print_lanes), and at
// the end the CifHr kernel's launches.

#include "runner_common.hpp"

#include <chrono>
#include <cstdio>
#include <string>
#include <vector>

// native IO layer (../csrc/pifpaf_io.cpp)
extern "C" int pifpaf_load_batch(const char** paths, int n, int long_edge,
                                 int out_h, int out_w, float* out,
                                 int* scaled_sizes, int n_threads);

namespace {

const char kUsage[] =
    "usage: openpifpaf-tpu-torch-image --model <package.pt2> [options] "
    "images...\n";

struct Args {
    std::string model;
    int input_height = 0;  // 0: the package's
    int input_width = 0;
    int long_edge = 0;  // 0: fit into input box without upscaling
    float instance_threshold = 0.15f;
    bool verbose = false;
    std::vector<std::string> images;
};

Args parse_args(int argc, char** argv) {
    Args a;
    for (int i = 1; i < argc; ++i) {
        const std::string arg = argv[i];
        auto next = [&]() -> const char* {
            if (i + 1 >= argc) {
                std::fprintf(stderr, "missing value for %s\n", arg.c_str());
                std::exit(2);
            }
            return argv[++i];
        };
        if (arg == "--model") a.model = next();
        else if (arg == "--input-height") a.input_height = std::atoi(next());
        else if (arg == "--input-width") a.input_width = std::atoi(next());
        else if (arg == "--long-edge") a.long_edge = std::atoi(next());
        else if (arg == "--instance-threshold")
            a.instance_threshold = std::atof(next());
        else if (arg == "--verbose") a.verbose = true;
        else if (arg == "--help" || arg == "-h") {
            std::printf("%s", kUsage);
            std::exit(0);
        } else {
            a.images.push_back(arg);
        }
    }
    if (a.model.empty() || a.images.empty()) {
        std::fprintf(stderr, "%s", kUsage);
        std::exit(2);
    }
    return a;
}

double ms_since(std::chrono::steady_clock::time_point start) {
    return std::chrono::duration<double, std::milli>(
        std::chrono::steady_clock::now() - start).count();
}

}  // namespace

int main(int argc, char** argv) {
    Args args = parse_args(argc, argv);

    pifpaf::Model model;
    model.load(args.model);
    model.input_size(&args.input_height, &args.input_width);

    const int h = args.input_height;
    const int w = args.input_width;
    int failed = 0;

    for (const std::string& path : args.images) {
        const auto start = std::chrono::steady_clock::now();
        // native decode + preprocess into a (1, h, w, 3) float32 tensor
        at::Tensor input = at::empty({1, h, w, 3}, at::kFloat);
        int scaled[4] = {0, 0, 0, 0};
        const char* paths[] = {path.c_str()};
        const int failures = pifpaf_load_batch(
            paths, 1, args.long_edge, h, w, input.data_ptr<float>(), scaled,
            0);
        if (failures != 0) {
            std::fprintf(stderr, "error: could not load %s\n", path.c_str());
            ++failed;
            continue;
        }
        const double load_ms = ms_since(start);
        // map network coordinates back to original pixels
        const float rescale_x = scaled[1] > 1
            ? float(scaled[3] - 1) / float(scaled[1] - 1) : 1.0f;
        const float rescale_y = scaled[0] > 1
            ? float(scaled[2] - 1) / float(scaled[0] - 1) : 1.0f;

        const std::vector<at::Tensor> outputs = model.run(input);

        int n_kp = 0;
        const std::vector<pifpaf::Pose> found = pifpaf::extract_poses(
            outputs, rescale_x, rescale_y, args.instance_threshold, &n_kp);

        std::printf("{\"file\": \"%s\", \"predictions\": ", path.c_str());
        pifpaf::print_predictions(found, n_kp);
        std::printf("}\n");
        std::fflush(stdout);
        if (args.verbose) {
            std::fprintf(stderr, "%s: load %.3f ms, load and run %.3f ms\n",
                         path.c_str(), load_ms, ms_since(start));
            pifpaf::print_lanes(path.c_str(), outputs);
        }
    }

    if (args.verbose) {
        std::fprintf(stderr, "cifhr kernel launches: %lld\n",
                     pifpaf_cifhr_launches());
    }
    return failed ? 1 : 0;
}
