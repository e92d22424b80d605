// Launch plan of the CifHr kernel (cifhr.cu) in C++: the counterpart of
// ops/cifhr_cuda.py::plan with its defaults (DEFAULT there), for the C++
// operator (cifhr_op.cpp) that the C++ runner loads. It must give the same
// numbers as the Python plan for every shape: the kernel checks them and
// refuses a launch whose plan does not cover the map
// (cudaErrorInvalidValue). Plain C++, no PyTorch headers, so that a test
// compiles it into a small shim and holds it against the Python plan.

#pragma once

namespace pifpaf {

// map rows per thread (kRows in cifhr.cu, ROWS in cifhr_cuda.py)
constexpr int kCifhrRows = 8;
// threads per CTA at most (MAX_THREADS)
constexpr int kCifhrMaxThreads = 512;
constexpr int kCifhrWarp = 32;
// consecutive cells a thread culls per round (CELLS_PER_THREAD)
constexpr int kCifhrCellsPerThread = 4;
// cells the survivor list holds at most (MAX_CAP)
constexpr int kCifhrMaxCap = 4096;
// the plan's defaults (DEFAULT)
constexpr int kCifhrGroups = 2;
constexpr int kCifhrBandsPerCta = 4;
constexpr int kCifhrDefaultThreads = 128;

struct CifhrPlan {
    int groups;         // row groups of warps per band
    int bands_per_cta;  // bands a CTA accumulates in turn
    int threads;        // threads per CTA
    int chunks;         // column chunks (grid x)
    int bands;          // bands per field
    int cap;            // survivor list capacity, in cells
    int smem;           // dynamic shared bytes: 4 floats per cell
    long long ctas;
};

inline long long cifhr_ceil_div(long long a, long long b) {
    return (a + b - 1) / b;
}

// The plan for n_fields fields of n_cells cells on an (hr_h, hr_w) map;
// returns false (and leaves *out alone) where the arguments give none (as
// the Python plan raises: bad groups or threads, or a map with no column).
inline bool cifhr_plan(int n_fields, int n_cells, int hr_h, int hr_w,
                       CifhrPlan* out, int groups = kCifhrGroups,
                       int bands_per_cta = kCifhrBandsPerCta,
                       int max_threads = kCifhrDefaultThreads) {
    if (max_threads > kCifhrMaxThreads) max_threads = kCifhrMaxThreads;
    if (groups < 1 || groups > max_threads / kCifhrWarp
        || bands_per_cta < 1 || n_fields < 0 || n_cells < 0 || hr_h < 0
        || hr_w < 1) {
        return false;
    }
    const long long segments = cifhr_ceil_div(hr_w, kCifhrWarp);
    const long long chunks = cifhr_ceil_div(
        segments, max_threads / kCifhrWarp / groups);
    const long long threads =
        kCifhrWarp * groups * cifhr_ceil_div(segments, chunks);
    const long long per_round = threads * kCifhrCellsPerThread;
    long long rounds = cifhr_ceil_div(n_cells, per_round);
    if (rounds > kCifhrMaxCap / per_round) rounds = kCifhrMaxCap / per_round;
    if (rounds < 1) rounds = 1;
    const long long cap = per_round * rounds;
    const long long bands = cifhr_ceil_div(hr_h, kCifhrRows * groups);
    out->groups = groups;
    out->bands_per_cta = bands_per_cta;
    out->threads = int(threads);
    out->chunks = int(chunks);
    out->bands = int(bands);
    out->cap = int(cap);
    out->smem = int(4 * 4 * cap);
    out->ctas = n_fields * chunks * cifhr_ceil_div(bands, bands_per_cta);
    return true;
}

}  // namespace pifpaf
