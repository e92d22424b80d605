// Standalone C++ video runner of the port: video/webcam -> poses, no
// Python.
//
// Counterpart of the JAX package's cpp/openpifpaf_video.cpp. The model is
// the AOTInductor package written by
//   python -m openpifpaf_tpu_torch.export --format savedmodel --with-decoder
// run through LibTorch (runner_common.hpp), and frames come from OpenCV
// VideoCapture (file path or camera index). Built only where CMake finds
// OpenCV.
//
// Usage:
//   openpifpaf-tpu-torch-video --model <package.pt2> --source <file|camindex>
//       [--input-height H --input-width W] (default the package's)
//       [--video-output out.avi] [--max-frames N] [--verbose]
//
// Prints one JSON line per frame:
//   {"frame": i, "predictions": [{"score": s, "keypoints": [x,y,v, ...]}]}
// With --video-output, additionally writes frames with skeleton overlays.
// With --verbose, stderr gets the CifHr kernel's launches at the end.

#include "runner_common.hpp"

#include <opencv2/core.hpp>
#include <opencv2/imgproc.hpp>
#include <opencv2/videoio.hpp>

#include <algorithm>
#include <cstdio>
#include <string>
#include <vector>

namespace {

constexpr float kMean[3] = {0.485f, 0.456f, 0.406f};
constexpr float kStd[3] = {0.229f, 0.224f, 0.225f};

// COCO person skeleton (1-based pairs), plugins/coco/constants.py
constexpr int kSkeleton[][2] = {
    {16, 14}, {14, 12}, {17, 15}, {15, 13}, {12, 13}, {6, 12}, {7, 13},
    {6, 7},   {6, 8},   {7, 9},   {8, 10},  {9, 11},  {2, 3},  {1, 2},
    {1, 3},   {2, 4},   {3, 5},   {4, 6},   {5, 7}};

struct Args {
    std::string model;
    std::string source;
    std::string video_output;
    int input_height = 0;  // 0: the package's
    int input_width = 0;
    int max_frames = 0;  // 0 = until stream ends
    float instance_threshold = 0.15f;
    float keypoint_threshold = 0.15f;
    bool verbose = false;
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
        else if (arg == "--source") a.source = next();
        else if (arg == "--video-output") a.video_output = next();
        else if (arg == "--input-height") a.input_height = std::atoi(next());
        else if (arg == "--input-width") a.input_width = std::atoi(next());
        else if (arg == "--max-frames") a.max_frames = std::atoi(next());
        else if (arg == "--instance-threshold")
            a.instance_threshold = std::atof(next());
        else if (arg == "--keypoint-threshold")
            a.keypoint_threshold = std::atof(next());
        else if (arg == "--verbose") a.verbose = true;
        else if (arg == "--help" || arg == "-h") {
            std::printf("usage: openpifpaf-tpu-torch-video --model <package.pt2> "
                        "--source <file|camindex> [options]\n");
            std::exit(0);
        } else {
            std::fprintf(stderr, "unknown argument %s\n", arg.c_str());
            std::exit(2);
        }
    }
    if (a.model.empty() || a.source.empty()) {
        std::fprintf(stderr,
                     "usage: openpifpaf-tpu-torch-video --model <package.pt2> "
                     "--source <file|camindex> [options]\n");
        std::exit(2);
    }
    return a;
}

void draw_poses(cv::Mat* frame, const std::vector<pifpaf::Pose>& found,
                int n_kp, float keypoint_threshold) {
    for (const pifpaf::Pose& pose : found) {
        if (n_kp == 17) {
            for (const auto& edge : kSkeleton) {
                const int a = edge[0] - 1, b = edge[1] - 1;
                if (pose.kps[a * 3 + 2] <= keypoint_threshold
                    || pose.kps[b * 3 + 2] <= keypoint_threshold) continue;
                cv::line(*frame,
                         {int(pose.kps[a * 3]), int(pose.kps[a * 3 + 1])},
                         {int(pose.kps[b * 3]), int(pose.kps[b * 3 + 1])},
                         {0, 255, 0}, 2);
            }
        }
        for (int k = 0; k < n_kp; ++k) {
            if (pose.kps[k * 3 + 2] <= keypoint_threshold) continue;
            cv::circle(*frame,
                       {int(pose.kps[k * 3]), int(pose.kps[k * 3 + 1])},
                       3, {0, 0, 255}, -1);
        }
    }
}

}  // namespace

int main(int argc, char** argv) {
    Args args = parse_args(argc, argv);

    pifpaf::Model model;
    model.load(args.model);
    model.input_size(&args.input_height, &args.input_width);

    cv::VideoCapture cap;
    const bool is_camera = !args.source.empty()
        && args.source.find_first_not_of("0123456789") == std::string::npos;
    if (is_camera) {
        cap.open(std::atoi(args.source.c_str()));
    } else {
        cap.open(args.source);
    }
    if (!cap.isOpened()) {
        std::fprintf(stderr, "error: cannot open source %s\n",
                     args.source.c_str());
        return 1;
    }

    cv::VideoWriter writer;
    const int h = args.input_height;
    const int w = args.input_width;

    cv::Mat frame_bgr, resized, rgb;
    int frame_i = 0;
    while (cap.read(frame_bgr)) {
        if (args.max_frames && frame_i >= args.max_frames) break;

        // fit the frame into (w, h), preserving aspect ratio, without
        // upscaling (matches the image runner's long_edge=0 behavior)
        const double scale = std::min(
            1.0, std::min(double(w) / frame_bgr.cols,
                          double(h) / frame_bgr.rows));
        const int sw = std::max(1, int(frame_bgr.cols * scale));
        const int sh = std::max(1, int(frame_bgr.rows * scale));
        cv::resize(frame_bgr, resized, cv::Size(sw, sh), 0, 0,
                   cv::INTER_LINEAR);
        cv::cvtColor(resized, rgb, cv::COLOR_BGR2RGB);
        const float rescale_x = sw > 1
            ? float(frame_bgr.cols - 1) / float(sw - 1) : 1.0f;
        const float rescale_y = sh > 1
            ? float(frame_bgr.rows - 1) / float(sh - 1) : 1.0f;

        at::Tensor input = at::empty({1, h, w, 3}, at::kFloat);
        float* data = input.data_ptr<float>();
        // ImageNet normalization, zero padding outside the scaled frame
        // (matches ../csrc/pifpaf_io.cpp)
        for (int y = 0; y < h; ++y) {
            for (int x = 0; x < w; ++x) {
                float* px = data + (size_t(y) * w + x) * 3;
                if (y < sh && x < sw) {
                    const cv::Vec3b& v = rgb.at<cv::Vec3b>(y, x);
                    for (int c = 0; c < 3; ++c) {
                        px[c] = (v[c] / 255.0f - kMean[c]) / kStd[c];
                    }
                } else {
                    for (int c = 0; c < 3; ++c) {
                        px[c] = (0.0f - kMean[c]) / kStd[c];
                    }
                }
            }
        }

        const std::vector<at::Tensor> outputs = model.run(input);

        int n_kp = 0;
        const std::vector<pifpaf::Pose> found = pifpaf::extract_poses(
            outputs, rescale_x, rescale_y, args.instance_threshold, &n_kp);

        std::printf("{\"frame\": %d, \"predictions\": ", frame_i);
        pifpaf::print_predictions(found, n_kp);
        std::printf("}\n");
        std::fflush(stdout);

        if (!args.video_output.empty()) {
            if (!writer.isOpened()) {
                writer.open(args.video_output,
                            cv::VideoWriter::fourcc('M', 'J', 'P', 'G'),
                            cap.get(cv::CAP_PROP_FPS) > 0
                                ? cap.get(cv::CAP_PROP_FPS) : 25.0,
                            frame_bgr.size());
                if (!writer.isOpened()) {
                    std::fprintf(stderr,
                                 "error: cannot open --video-output %s\n",
                                 args.video_output.c_str());
                    return 1;
                }
            }
            draw_poses(&frame_bgr, found, n_kp, args.keypoint_threshold);
            writer.write(frame_bgr);
        }

        ++frame_i;
    }

    if (args.verbose) {
        std::fprintf(stderr, "cifhr kernel launches: %lld\n",
                     pifpaf_cifhr_launches());
    }
    return 0;
}
