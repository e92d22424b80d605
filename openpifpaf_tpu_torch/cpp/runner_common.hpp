// Shared plumbing for the port's standalone C++ runners (image + video):
// loading the AOTInductor package, running it, pose extraction and JSON
// emission. The counterpart of cpp/runner_common.hpp of the JAX package,
// whose runners load a TensorFlow SavedModel; here the model is the
// package that
//   python -m openpifpaf_tpu_torch.export --format savedmodel --with-decoder
// writes, loaded through LibTorch's AOTIModelPackageLoader. Keeping this
// in one place guarantees the two CLIs agree on conventions (output order,
// keep-mask dtypes, score formula, coordinate rescaling), which are the
// JAX runners'.

#pragma once

#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <exception>
#include <memory>
#include <string>
#include <vector>

// the CifHr operator's library (csrc/cifhr_op.cpp), linked into every
// runner: it registers openpifpaf_tpu_torch::cifhr_accumulate, which the
// package calls, and counts the kernel's launches
extern "C" long long pifpaf_cifhr_launches(void);

namespace pifpaf {

struct Model {
    std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
    c10::Device device{c10::kCPU};
    // the input's (height, width) that the package was compiled for, from
    // the metadata export writes (0 where it has none)
    int input_height = 0;
    int input_width = 0;

    // Loads the package on the device it was compiled for; exits on
    // failure (a CUDA package where no card is found fails: it never runs
    // on the CPU instead).
    void load(const std::string& package) {
        try {
            loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(
                package);
            const auto metadata = loader->get_metadata();
            const auto found = metadata.find("AOTI_DEVICE_KEY");
            if (found != metadata.end()) device = c10::Device(found->second);
            const auto shape = metadata.find("input_shape");
            int batch = 0, channels = 0;
            if (shape != metadata.end()
                && std::sscanf(shape->second.c_str(), "%d,%d,%d,%d", &batch,
                               &input_height, &input_width, &channels) != 4) {
                input_height = input_width = 0;
            }
        } catch (const std::exception& e) {
            std::fprintf(stderr, "error: loading package %s: %s\n",
                         package.c_str(), e.what());
            std::exit(1);
        }
    }

    // The input size: the flags' (0 where not given) or else the
    // package's; exits where the two differ, since the package checks no
    // shape and would read past a smaller input.
    void input_size(int* height, int* width) const {
        if (input_height == 0) {
            if (*height == 0) *height = 481;
            if (*width == 0) *width = 641;
            return;
        }
        if ((*height && *height != input_height)
            || (*width && *width != input_width)) {
            std::fprintf(stderr, "error: --input-height/--input-width %dx%d, "
                         "but the package takes %dx%d\n", *height, *width,
                         input_height, input_width);
            std::exit(2);
        }
        *height = input_height;
        *width = input_width;
    }

    // input: (1, h, w, 3) float32 on the CPU; returns the program's
    // outputs (poses, keep) on the CPU
    std::vector<at::Tensor> run(const at::Tensor& input) {
        try {
            std::vector<at::Tensor> outputs = loader->run({input.to(device)});
            for (at::Tensor& out : outputs) out = out.cpu();
            return outputs;
        } catch (const std::exception& e) {
            std::fprintf(stderr, "error: running package: %s\n", e.what());
            std::exit(1);
        }
    }
};

struct Pose {
    float score;
    std::vector<float> kps;  // x, y, v triples in original pixels
};

// The decoder outputs poses (1, P, K, 4: v,x,y,s) and keep (1, P), in
// either order: normalised by rank, as the JAX runner does; poses as
// contiguous float32.
inline void poses_and_keep(const std::vector<at::Tensor>& outputs,
                           at::Tensor* poses, at::Tensor* keep) {
    if (outputs.size() < 2) {
        std::fprintf(stderr, "error: the package returned %zu outputs, "
                     "expected (poses, keep)\n", outputs.size());
        std::exit(1);
    }
    *poses = outputs[0];
    *keep = outputs[1];
    if (poses->dim() == 2 || keep->dim() == 3) std::swap(*poses, *keep);
    *poses = poses->to(at::kFloat).contiguous();
    *keep = keep->contiguous();
}

// Extract kept poses from the decoder outputs.
inline std::vector<Pose> extract_poses(
        const std::vector<at::Tensor>& outputs, float rescale_x,
        float rescale_y, float instance_threshold, int* n_kp_out) {
    at::Tensor poses_t, keep_t;
    poses_and_keep(outputs, &poses_t, &keep_t);
    if (keep_t.scalar_type() != at::kBool && keep_t.scalar_type() != at::kInt)
        keep_t = keep_t.to(at::kFloat);
    const int n_poses = int(poses_t.size(1));
    const int n_kp = int(poses_t.size(2));
    *n_kp_out = n_kp;
    const float* poses = poses_t.data_ptr<float>();

    std::vector<Pose> found;
    for (int p = 0; p < n_poses; ++p) {
        bool keep = false;
        if (keep_t.scalar_type() == at::kBool) {
            keep = keep_t.data_ptr<bool>()[p];
        } else if (keep_t.scalar_type() == at::kInt) {
            keep = keep_t.data_ptr<int32_t>()[p] != 0;
        } else {
            keep = keep_t.data_ptr<float>()[p] > 0.5f;
        }
        if (!keep) continue;

        const float* pose = poses + size_t(p) * n_kp * 4;
        float score = 0.0f;
        int n_vis = 0;
        for (int k = 0; k < n_kp; ++k) {
            if (pose[k * 4] > 0.0f) {
                score += pose[k * 4];
                ++n_vis;
            }
        }
        if (n_vis == 0) continue;
        score /= float(n_kp);
        if (score < instance_threshold) continue;

        Pose out;
        out.score = score;
        out.kps.resize(size_t(n_kp) * 3);
        for (int k = 0; k < n_kp; ++k) {
            out.kps[k * 3 + 0] = pose[k * 4 + 1] * rescale_x;
            out.kps[k * 3 + 1] = pose[k * 4 + 2] * rescale_y;
            out.kps[k * 3 + 2] = pose[k * 4 + 0];
        }
        found.push_back(std::move(out));
    }
    return found;
}

// One line on every lane of the outputs, for --verbose: the poses with a
// visible joint, the kept ones, and the sums of v, x and y over all lanes
// and joints in order, in double precision, so that another reader of
// the same outputs can check them all, kept or not.
inline void print_lanes(const char* name,
                        const std::vector<at::Tensor>& outputs) {
    at::Tensor poses_t, keep_t;
    poses_and_keep(outputs, &poses_t, &keep_t);
    keep_t = keep_t.to(at::kBool);
    const int n_poses = int(poses_t.size(1)), n_kp = int(poses_t.size(2));
    const float* poses = poses_t.data_ptr<float>();
    int visible = 0, kept = 0;
    double sums[3] = {0.0, 0.0, 0.0};
    for (int p = 0; p < n_poses; ++p) {
        bool any = false;
        for (int k = 0; k < n_kp; ++k) {
            const float* joint = poses + (size_t(p) * n_kp + k) * 4;
            any = any || joint[0] > 0.0f;
            for (int c = 0; c < 3; ++c) sums[c] += double(joint[c]);
        }
        visible += any;
        kept += keep_t.data_ptr<bool>()[p];
    }
    std::fprintf(stderr, "%s: lanes %d with a visible joint, %d kept, sums "
                 "v %.17g x %.17g y %.17g\n", name, visible, kept, sums[0],
                 sums[1], sums[2]);
}

// {"score": s, "keypoints": [x, y, v, ...]} list body (no surrounding key)
inline void print_predictions(const std::vector<Pose>& found, int n_kp) {
    std::printf("[");
    for (size_t p = 0; p < found.size(); ++p) {
        if (p) std::printf(", ");
        std::printf("{\"score\": %.4f, \"keypoints\": [", found[p].score);
        for (int k = 0; k < n_kp; ++k) {
            std::printf("%s%.2f, %.2f, %.3f", k ? ", " : "",
                        found[p].kps[k * 3], found[p].kps[k * 3 + 1],
                        found[p].kps[k * 3 + 2]);
        }
        std::printf("]}");
    }
    std::printf("]");
}

}  // namespace pifpaf
