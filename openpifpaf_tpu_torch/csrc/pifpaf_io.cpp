// Native image loading / preprocessing for the port's serving input
// pipeline: JPEG decode + long-edge bilinear resize + pad-to-multiple +
// ImageNet normalization, fanned out over a thread pool on the host. A copy
// of openpifpaf_tpu/csrc/pifpaf_io.cpp (the JAX package's loader), so that
// both packages give the same bytes from the same files.
//
// Exposed as a plain C API consumed via ctypes
// (openpifpaf_tpu_torch/io/native.py), which builds it with g++ into the
// port's build directory at first use.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

constexpr float kImagenetMean[3] = {0.485f, 0.456f, 0.406f};
constexpr float kImagenetStd[3] = {0.229f, 0.224f, 0.225f};

struct Image {
    std::vector<uint8_t> data;  // HWC uint8 RGB
    int height = 0;
    int width = 0;
};

bool decode_jpeg(const uint8_t* bytes, size_t len, Image* out) {
    jpeg_decompress_struct cinfo;
    jpeg_error_mgr jerr;
    cinfo.err = jpeg_std_error(&jerr);

    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, bytes, len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);

    out->height = cinfo.output_height;
    out->width = cinfo.output_width;
    out->data.resize(size_t(out->height) * out->width * 3);

    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = out->data.data()
            + size_t(cinfo.output_scanline) * out->width * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return true;
}

// Bilinear resize with the keypoint-aligned mapping used by the python
// pipeline: source position = target_index * (src_len - 1) / (dst_len - 1).
//
// Separable two-pass in 10-bit fixed point: the horizontal pass resizes
// one source row into a uint32 buffer (value * 1024), the vertical pass
// blends two cached horizontal rows. Each source row's horizontal resize
// is computed once and shared by every output row that interpolates from
// it (~2x fewer multiplies at near-1:1 scales). Weight granularity 1/1024
// bounds the error vs exact float bilinear at 255 * 2/2048 = 0.25, plus
// the 0.5 of the final round-to-uint8 that the float path also pays
// (pinned by tests/test_native_io.py::test_resize_within_*). Bilinear
// output of uint8 inputs cannot leave [0, 255], so no clamp is needed.
void resize_bilinear(const Image& src, int dst_h, int dst_w,
                     std::vector<uint8_t>* dst) {
    dst->resize(size_t(dst_h) * dst_w * 3);
    const float sy = dst_h > 1
        ? float(src.height - 1) / float(dst_h - 1) : 0.0f;
    const float sx = dst_w > 1
        ? float(src.width - 1) / float(dst_w - 1) : 0.0f;
    constexpr int kShift = 10;            // weight scale 1024
    constexpr int kOne = 1 << kShift;

    // horizontal taps, precomputed once per image
    std::vector<int> x0(dst_w);
    std::vector<int> wx1(dst_w);  // weight of the x0+1 tap, in [0, kOne]
    for (int x = 0; x < dst_w; ++x) {
        const float fx = x * sx;
        int xi = int(fx);
        int w1 = int((fx - xi) * kOne + 0.5f);
        if (w1 == kOne) { ++xi; w1 = 0; }  // exact hit on the next texel
        x0[x] = std::min(xi, src.width - 1);
        wx1[x] = (xi + 1 <= src.width - 1) ? w1 : 0;
    }

    const size_t row_values = size_t(dst_w) * 3;
    std::vector<uint32_t> rowbuf(2 * row_values);
    int cached_sy[2] = {-1, -1};

    auto hresize = [&](int sy_row, int slot) {
        const uint8_t* srow = src.data.data()
            + size_t(sy_row) * src.width * 3;
        uint32_t* out = rowbuf.data() + size_t(slot) * row_values;
        for (int x = 0; x < dst_w; ++x) {
            const uint8_t* p0 = srow + size_t(x0[x]) * 3;
            const int w1 = wx1[x];
            const int w0 = kOne - w1;
            // w1 != 0 implies x0[x] + 1 exists (wx1 is zeroed at the
            // right edge), so p0 + 3 stays inside the row
            const uint8_t* p1 = (w1 != 0) ? p0 + 3 : p0;
            out[size_t(x) * 3 + 0] = uint32_t(w0 * p0[0] + w1 * p1[0]);
            out[size_t(x) * 3 + 1] = uint32_t(w0 * p0[1] + w1 * p1[1]);
            out[size_t(x) * 3 + 2] = uint32_t(w0 * p0[2] + w1 * p1[2]);
        }
        cached_sy[slot] = sy_row;
    };
    auto slot_for = [&](int sy_row, int other_row) {
        for (int s = 0; s < 2; ++s)
            if (cached_sy[s] == sy_row) return s;
        int s = (cached_sy[0] == other_row) ? 1 : 0;
        hresize(sy_row, s);
        return s;
    };

    for (int y = 0; y < dst_h; ++y) {
        const float fy = y * sy;
        int yi = int(fy);
        int wy1 = int((fy - yi) * kOne + 0.5f);
        if (wy1 == kOne) { ++yi; wy1 = 0; }
        const int y0r = std::min(yi, src.height - 1);
        const int y1r = std::min(yi + 1, src.height - 1);
        if (y1r == y0r) wy1 = 0;
        const int wy0 = kOne - wy1;

        const int s0 = slot_for(y0r, y1r);
        const uint32_t* r0 = rowbuf.data() + size_t(s0) * row_values;
        const uint32_t* r1 = r0;
        if (wy1 != 0) {
            const int s1 = slot_for(y1r, y0r);
            r1 = rowbuf.data() + size_t(s1) * row_values;
        }
        uint8_t* drow = dst->data() + size_t(y) * row_values;
        for (size_t i = 0; i < row_values; ++i) {
            drow[i] = uint8_t(
                (uint32_t(wy0) * r0[i] + uint32_t(wy1) * r1[i]
                 + (1u << (2 * kShift - 1))) >> (2 * kShift));
        }
    }
}


struct ThreadPool {
    explicit ThreadPool(int n_threads) {
        for (int i = 0; i < n_threads; ++i) {
            workers_.emplace_back([this] { worker(); });
        }
    }

    ~ThreadPool() {
        {
            std::unique_lock<std::mutex> lock(mutex_);
            stopping_ = true;
        }
        cv_.notify_all();
        for (auto& t : workers_) t.join();
    }

    void submit(std::function<void()> fn) {
        {
            std::unique_lock<std::mutex> lock(mutex_);
            tasks_.push(std::move(fn));
        }
        cv_.notify_one();
    }

    void wait_all() {
        std::unique_lock<std::mutex> lock(mutex_);
        done_cv_.wait(lock, [this] { return tasks_.empty() && active_ == 0; });
    }

 private:
    void worker() {
        for (;;) {
            std::function<void()> task;
            {
                std::unique_lock<std::mutex> lock(mutex_);
                cv_.wait(lock, [this] { return stopping_ || !tasks_.empty(); });
                if (stopping_ && tasks_.empty()) return;
                task = std::move(tasks_.front());
                tasks_.pop();
                ++active_;
            }
            task();
            {
                std::unique_lock<std::mutex> lock(mutex_);
                --active_;
                if (tasks_.empty() && active_ == 0) done_cv_.notify_all();
            }
        }
    }

    std::vector<std::thread> workers_;
    std::queue<std::function<void()>> tasks_;
    std::mutex mutex_;
    std::condition_variable cv_;
    std::condition_variable done_cv_;
    int active_ = 0;
    bool stopping_ = false;
};

ThreadPool* pool = nullptr;
std::mutex pool_mutex;

ThreadPool* get_pool(int n_threads) {
    std::unique_lock<std::mutex> lock(pool_mutex);
    if (pool == nullptr) {
        pool = new ThreadPool(n_threads > 0
            ? n_threads
            : int(std::max(1u, std::thread::hardware_concurrency())));
    }
    return pool;
}

// Preprocess one decoded image into the output slot: long-edge resize,
// top-left pad to (out_h, out_w), normalize. Fill value 0 after
// normalization equals the ImageNet mean color.
void preprocess_into(const Image& img, int long_edge, int out_h, int out_w,
                     float* out, int* scaled_h, int* scaled_w) {
    int dst_h = img.height;
    int dst_w = img.width;
    if (long_edge > 0) {
        const float s = float(long_edge) / std::max(img.height, img.width);
        if (img.height > img.width) {
            dst_h = long_edge;
            dst_w = int(img.width * s);
        } else {
            dst_w = long_edge;
            dst_h = int(img.height * s);
        }
    }
    dst_h = std::min(dst_h, out_h);
    dst_w = std::min(dst_w, out_w);

    std::vector<uint8_t> resized;
    const std::vector<uint8_t>* pixels = &img.data;
    int src_h = img.height, src_w = img.width;
    if (dst_h != img.height || dst_w != img.width) {
        resize_bilinear(img, dst_h, dst_w, &resized);
        pixels = &resized;
        src_h = dst_h;
        src_w = dst_w;
    }

    std::memset(out, 0, sizeof(float) * size_t(out_h) * out_w * 3);
    for (int y = 0; y < src_h; ++y) {
        for (int x = 0; x < src_w; ++x) {
            for (int c = 0; c < 3; ++c) {
                const float v = (*pixels)[(size_t(y) * src_w + x) * 3 + c] / 255.0f;
                out[(size_t(y) * out_w + x) * 3 + c] =
                    (v - kImagenetMean[c]) / kImagenetStd[c];
            }
        }
    }
    *scaled_h = src_h;
    *scaled_w = src_w;
}

}  // namespace

extern "C" {

// Decode + preprocess a batch of JPEG files into a preallocated
// (n, out_h, out_w, 3) float32 buffer. Returns the number of failures.
// scaled_sizes: (n, 4) int32 output per image:
// (scaled_h, scaled_w, original_h, original_w).
int pifpaf_load_batch(const char** paths, int n,
                      int long_edge, int out_h, int out_w,
                      float* out, int* scaled_sizes, int n_threads) {
    ThreadPool* p = get_pool(n_threads);
    std::vector<int> failures(n, 0);

    for (int i = 0; i < n; ++i) {
        const char* path = paths[i];
        float* slot = out + size_t(i) * out_h * out_w * 3;
        int* size_slot = scaled_sizes + size_t(i) * 4;
        p->submit([path, slot, size_slot, long_edge, out_h, out_w,
                   &failures, i] {
            FILE* f = std::fopen(path, "rb");
            if (f == nullptr) { failures[i] = 1; return; }
            std::fseek(f, 0, SEEK_END);
            const long len = std::ftell(f);
            std::fseek(f, 0, SEEK_SET);
            std::vector<uint8_t> bytes(len);
            const size_t n_read = std::fread(bytes.data(), 1, len, f);
            std::fclose(f);
            if (long(n_read) != len) { failures[i] = 1; return; }

            Image img;
            if (!decode_jpeg(bytes.data(), bytes.size(), &img)) {
                failures[i] = 1;
                return;
            }
            preprocess_into(img, long_edge, out_h, out_w, slot,
                            &size_slot[0], &size_slot[1]);
            size_slot[2] = img.height;
            size_slot[3] = img.width;
        });
    }
    p->wait_all();

    int n_failures = 0;
    for (int i = 0; i < n; ++i) n_failures += failures[i];
    return n_failures;
}

// Like pifpaf_load_batch, but writes raw uint8 pixels (long-edge resized,
// top-left zero-padded) without normalization: the float conversion and
// ImageNet normalization then run fused into the accelerator graph, and
// the host->device transfer is 4x smaller.
int pifpaf_load_batch_u8(const char** paths, int n,
                         int long_edge, int out_h, int out_w,
                         uint8_t* out, int* scaled_sizes, int n_threads) {
    ThreadPool* p = get_pool(n_threads);
    std::vector<int> failures(n, 0);

    for (int i = 0; i < n; ++i) {
        const char* path = paths[i];
        uint8_t* slot = out + size_t(i) * out_h * out_w * 3;
        int* size_slot = scaled_sizes + size_t(i) * 4;
        p->submit([path, slot, size_slot, long_edge, out_h, out_w,
                   &failures, i] {
            FILE* f = std::fopen(path, "rb");
            if (f == nullptr) { failures[i] = 1; return; }
            std::fseek(f, 0, SEEK_END);
            const long len = std::ftell(f);
            std::fseek(f, 0, SEEK_SET);
            std::vector<uint8_t> bytes(len);
            const size_t n_read = std::fread(bytes.data(), 1, len, f);
            std::fclose(f);
            if (long(n_read) != len) { failures[i] = 1; return; }

            Image img;
            if (!decode_jpeg(bytes.data(), bytes.size(), &img)) {
                failures[i] = 1;
                return;
            }

            int dst_h = img.height;
            int dst_w = img.width;
            if (long_edge > 0) {
                const float s = float(long_edge)
                    / std::max(img.height, img.width);
                if (img.height > img.width) {
                    dst_h = long_edge;
                    dst_w = int(img.width * s);
                } else {
                    dst_w = long_edge;
                    dst_h = int(img.height * s);
                }
            }
            dst_h = std::min(dst_h, out_h);
            dst_w = std::min(dst_w, out_w);

            std::vector<uint8_t> resized;
            const std::vector<uint8_t>* pixels = &img.data;
            int src_w = img.width;
            if (dst_h != img.height || dst_w != img.width) {
                resize_bilinear(img, dst_h, dst_w, &resized);
                pixels = &resized;
                src_w = dst_w;
            }

            // pad with the ImageNet mean color so that after the
            // in-graph normalization the padding is 0 (same as the
            // float path's post-normalization zero fill)
            const uint8_t mean_u8[3] = {124, 116, 104};
            for (size_t p = 0; p < size_t(out_h) * out_w; ++p) {
                slot[p * 3 + 0] = mean_u8[0];
                slot[p * 3 + 1] = mean_u8[1];
                slot[p * 3 + 2] = mean_u8[2];
            }
            for (int y = 0; y < dst_h; ++y) {
                std::memcpy(slot + size_t(y) * out_w * 3,
                            pixels->data() + size_t(y) * src_w * 3,
                            size_t(dst_w) * 3);
            }
            size_slot[0] = dst_h;
            size_slot[1] = dst_w;
            size_slot[2] = img.height;
            size_slot[3] = img.width;
        });
    }
    p->wait_all();

    int n_failures = 0;
    for (int i = 0; i < n; ++i) n_failures += failures[i];
    return n_failures;
}

// Decode a single JPEG from memory into a preallocated uint8 HWC buffer
// of capacity cap_h * cap_w * 3; writes actual (h, w) into size_out.
int pifpaf_decode_jpeg(const uint8_t* bytes, long len,
                       uint8_t* out, int cap_h, int cap_w, int* size_out) {
    Image img;
    if (!decode_jpeg(bytes, size_t(len), &img)) return 1;
    if (img.height > cap_h || img.width > cap_w) return 2;
    std::memcpy(out, img.data.data(), img.data.size());
    size_out[0] = img.height;
    size_out[1] = img.width;
    return 0;
}

}  // extern "C"
