// The CifHr operator in C++, for the C++ runner (openpifpaf_tpu_torch/cpp/).
//
// An AOTInductor package of the (poses, keep) program
// (`python -m openpifpaf_tpu_torch.export --format savedmodel
// --with-decoder`) calls the operator openpifpaf_tpu_torch::cifhr_accumulate
// through the dispatcher. In Python the package's __init__.py defines it;
// a process with no Python loads this library instead, which defines the
// same schema. The two never meet in one process: the dispatcher refuses a
// second TORCH_LIBRARY of one namespace, and no Python module loads this
// library.
//
//   CUDA: the launch plan of ops/cifhr_cuda.py::plan (cifhr_plan.h), then
//         cifhr.cu's cifhr_accumulate on the current CUDA stream; a launch
//         that the kernel refuses raises. Counted in
//         pifpaf_cifhr_launches().
//   CPU:  a plain loop with the float operations of
//         ops/cifhr.py::accumulate_dense, in its order: a CPU package runs
//         in the runner for the tests. Never taken for a CUDA tensor.
//
// Built with PIFPAF_WITH_CUDA (and cifhr.cu linked in) where the toolkit
// is there; without it the library has the CPU implementation alone. No
// multiply-add may be contracted (-ffp-contract=off).

#include "cifhr_plan.h"

#include <ATen/ATen.h>
#include <torch/library.h>

#include <atomic>
#include <cstdint>
#include <vector>

#ifdef PIFPAF_WITH_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

// csrc/cifhr.cu
extern "C" int cifhr_accumulate(const float* x, const float* y,
                                const float* sigma, const float* w,
                                float* out, int n_fields, int n_cells,
                                int hr_h, int hr_w, float neighbors,
                                float factor, int groups, int bands_per_cta,
                                int threads, int chunks, int cap, int smem,
                                void* stream);
#endif

namespace {

std::atomic<long long> launches{0};

void check_cells(const at::Tensor& x, const at::Tensor& y,
                 const at::Tensor& sigma, const at::Tensor& w) {
    TORCH_CHECK(x.dim() == 2, "cifhr_accumulate: cells must be (F, K), got ",
                x.sizes());
    for (const at::Tensor* t : {&x, &y, &sigma, &w}) {
        TORCH_CHECK(t->sizes() == x.sizes() && t->device() == x.device(),
                    "cifhr_accumulate: cells ", t->sizes(), " on ",
                    t->device(), " do not match x ", x.sizes(), " on ",
                    x.device());
        TORCH_CHECK(t->scalar_type() == at::kFloat,
                    "cifhr_accumulate: cells must be float32, got ",
                    t->scalar_type());
    }
}

// ops/cifhr.py::approx_exp
inline float approx_exp(float x) {
    float y = 1.0f + x / 8.0f;
    y = y * y;
    y = y * y;
    y = y * y;
    return (x > 2.0f || x < -2.0f) ? 0.0f : y;
}

at::Tensor cifhr_cpu(const at::Tensor& x_in, const at::Tensor& y_in,
                     const at::Tensor& sigma_in, const at::Tensor& w_in,
                     int64_t hr_h, int64_t hr_w, double neighbors,
                     double factor) {
    check_cells(x_in, y_in, sigma_in, w_in);
    const at::Tensor x = x_in.contiguous(), y = y_in.contiguous();
    const at::Tensor sigma = sigma_in.contiguous(), w = w_in.contiguous();
    const int64_t n_fields = x.size(0), n_cells = x.size(1);
    at::Tensor acc = at::zeros({n_fields, hr_h, hr_w}, x.options());
    const float* px = x.data_ptr<float>();
    const float* py = y.data_ptr<float>();
    const float* ps = sigma.data_ptr<float>();
    const float* pw = w.data_ptr<float>();
    float* out = acc.data_ptr<float>();

    // scaled_weights: w / neighbors * factor, two rounded float operations
    std::vector<float> cw(size_t(n_fields * n_cells));
    for (size_t i = 0; i < cw.size(); ++i) {
        cw[i] = pw[i] / float(neighbors) * float(factor);
    }
    for (int64_t k = 0; k < n_cells; ++k) {
        // a cell whose weight is 0 in every field adds exactly 0.0
        bool live = false;
        for (int64_t f = 0; f < n_fields; ++f) {
            live = live || cw[f * n_cells + k] != 0.0f;
        }
        if (!live) continue;
        for (int64_t f = 0; f < n_fields; ++f) {
            const int64_t c = f * n_cells + k;
            const float cx = px[c], cy = py[c], cs = ps[c], wk = cw[c];
            const float s2 = cs * cs;
            float* map = out + f * hr_h * hr_w;
            for (int64_t row = 0; row < hr_h; ++row) {
                const float dy = float(row) - cy;
                const float dy2 = dy * dy;
                for (int64_t col = 0; col < hr_w; ++col) {
                    const float dx = float(col) - cx;
                    const float dx2 = dx * dx;
                    const float d2 = dx2 + dy2;
                    const bool closest = dx2 < 0.25f && dy2 < 0.25f;
                    const float g = closest
                        ? 1.0f : approx_exp(-0.5f * d2 / s2);
                    map[row * hr_w + col] += d2 <= s2 ? wk * g : 0.0f;
                }
            }
        }
    }
    return at::clamp_max(acc, 1.0);
}

#ifdef PIFPAF_WITH_CUDA
at::Tensor cifhr_cuda(const at::Tensor& x_in, const at::Tensor& y_in,
                      const at::Tensor& sigma_in, const at::Tensor& w_in,
                      int64_t hr_h, int64_t hr_w, double neighbors,
                      double factor) {
    check_cells(x_in, y_in, sigma_in, w_in);
    const int64_t n_fields = x_in.size(0), n_cells = x_in.size(1);
    TORCH_CHECK(n_fields * hr_h * hr_w < (int64_t(1) << 31)
                    && n_cells < (int64_t(1) << 31),
                "cifhr_accumulate: CifHr map too large for 32-bit sizes");
    pifpaf::CifhrPlan plan;
    TORCH_CHECK(pifpaf::cifhr_plan(int(n_fields), int(n_cells), int(hr_h),
                                   int(hr_w), &plan),
                "cifhr_accumulate: no launch plan for F=", n_fields,
                " K=", n_cells, " map ", hr_h, "x", hr_w);
    const c10::cuda::CUDAGuard guard(x_in.device());
    const at::Tensor x = x_in.contiguous(), y = y_in.contiguous();
    const at::Tensor sigma = sigma_in.contiguous(), w = w_in.contiguous();
    at::Tensor out = at::empty({n_fields, hr_h, hr_w}, x.options());
    const int err = cifhr_accumulate(
        x.data_ptr<float>(), y.data_ptr<float>(), sigma.data_ptr<float>(),
        w.data_ptr<float>(), out.data_ptr<float>(), int(n_fields),
        int(n_cells), int(hr_h), int(hr_w), float(neighbors), float(factor),
        plan.groups, plan.bands_per_cta, plan.threads, plan.chunks, plan.cap,
        plan.smem, c10::cuda::getCurrentCUDAStream(x.device().index())
                       .stream());
    TORCH_CHECK(err == 0, "cifhr_accumulate launch failed: CUDA error ", err);
    ++launches;
    return out;
}
#endif

}  // namespace

// The schema of openpifpaf_tpu_torch/__init__.py, letter for letter.
TORCH_LIBRARY(openpifpaf_tpu_torch, m) {
    m.def("cifhr_accumulate(Tensor x, Tensor y, Tensor sigma, Tensor w, "
          "int hr_h, int hr_w, float neighbors, float factor) -> Tensor");
}

TORCH_LIBRARY_IMPL(openpifpaf_tpu_torch, CPU, m) {
    m.impl("cifhr_accumulate", cifhr_cpu);
}

#ifdef PIFPAF_WITH_CUDA
TORCH_LIBRARY_IMPL(openpifpaf_tpu_torch, CUDA, m) {
    m.impl("cifhr_accumulate", cifhr_cuda);
}
#endif

// Kernel launches made by the operator's CUDA implementation in this
// process (the CPU loop launches nothing).
extern "C" long long pifpaf_cifhr_launches(void) { return launches.load(); }
