// The scrappie dual short/long peak detector, for Hopper (sm_90a), bound to
// Python with ctypes (poreplex_torch/kernels/event_detection.py).
//
// Replaces the Pallas TPU kernel _peaks_kernel / detect_peaks of
// poreplex_tpu/ops/pallas_event_detection.py: per frame, each detector
// tracks a candidate peak of its t-statistic stream (CASE 1: no maximum
// yet; CASE 2: inside a peak) and emits the peak position window/2 frames
// after it; while the short detector rides a peak above threshold1 it
// resets the long detector and masks it to dom_pos + window_length1, before
// the long detector's own step (event_detection.c:169-179).
//
// Exactness: the state machine only subtracts floats and compares, in the
// plain version's order (poreplex_torch/ops/event_detection.py
// _detector_step), so its emissions equal the plain version's bit for bit.
//
// What bounds it on the H100: the T dependent steps of each read, not
// bytes (4 arrays of B x T words: about 34 MB at B = 256, T = 8192, some
// 10 us at 3.35 TB/s) and not operations. Design: one thread per read with
// both detectors' state in registers, 32 threads per block; t-statistics
// are read and emissions written in a [T, B] layout so neighbouring
// threads touch neighbouring words. A read's loop ends at its length; the
// frames past it are written -1 in a second, independent loop. With
// B = 256 only 8 SMs run: the finding for a later change.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int THREADS = 32;

struct Detector {
    int masked_to;
    int peak_pos;
    float peak_value;
    bool valid;
};

__device__ __forceinline__ void fresh(Detector& d) {
    d.masked_to = 0;
    d.peak_pos = -1;
    d.peak_value = FLT_MAX;
    d.valid = false;
}

// One frame of one detector (frames before the length only); returns the
// emission (-1 for none) and sets dominating / dom_pos for the short one.
__device__ __forceinline__ int step(Detector& d, float tval, int i,
                                    float threshold, int half_window,
                                    float peak_height, bool& dominating,
                                    int& dom_pos) {
    dominating = false;
    dom_pos = d.peak_pos;
    if (d.masked_to >= i) return -1;
    if (d.peak_pos == -1) {
        // CASE 1: no maximum recorded yet
        const bool deeper = tval < d.peak_value;
        const bool qualify = (tval - d.peak_value) > peak_height;
        if (!deeper && qualify) d.peak_pos = i;
        if (deeper || qualify) d.peak_value = tval;
        dom_pos = d.peak_pos;
        return -1;
    }
    // CASE 2: inside an existing peak
    if (tval > d.peak_value) {
        d.peak_value = tval;
        d.peak_pos = i;
    }
    if ((d.peak_value - tval) > peak_height && d.peak_value > threshold)
        d.valid = true;
    int emitted = -1;
    if (d.valid && (i - d.peak_pos) > half_window) {
        emitted = d.peak_pos;
        d.peak_pos = -1;
        d.peak_value = tval;
        d.valid = false;
    }
    dominating = d.peak_value > threshold;
    dom_pos = d.peak_pos;
    return emitted;
}

// t1T, t2T [T, B]; lengths [B]; em_sT, em_lT [T, B]
__global__ void __launch_bounds__(THREADS)
peaks_kernel(const float* __restrict__ t1T, const float* __restrict__ t2T,
             const int* __restrict__ lengths, int* __restrict__ em_sT,
             int* __restrict__ em_lT, int B, int T, float threshold1,
             float threshold2, int window_length1, int window_length2,
             float peak_height) {
    const int b = blockIdx.x * THREADS + threadIdx.x;
    if (b >= B) return;
    const int len = min(max(lengths[b], 0), T);
    Detector s, l;
    fresh(s);
    fresh(l);
    const int half1 = window_length1 / 2, half2 = window_length2 / 2;
    for (int i = 0; i < len; ++i) {
        const size_t at = (size_t)i * B + b;
        bool dom, unused_dom;
        int dom_pos, unused_pos;
        em_sT[at] = step(s, t1T[at], i, threshold1, half1, peak_height, dom,
                         dom_pos);
        if (dom) {
            l.masked_to = dom_pos + window_length1;
            l.peak_pos = -1;
            l.peak_value = FLT_MAX;
            l.valid = false;
        }
        em_lT[at] = step(l, t2T[at], i, threshold2, half2, peak_height,
                         unused_dom, unused_pos);
    }
    for (int i = len; i < T; ++i) {
        const size_t at = (size_t)i * B + b;
        em_sT[at] = -1;
        em_lT[at] = -1;
    }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code.
int pp_detect_peaks(const float* t1T, const float* t2T, const int* lengths,
                    int* em_sT, int* em_lT, int B, int T, float threshold1,
                    float threshold2, int window_length1, int window_length2,
                    float peak_height, void* stream) {
    if (B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
    const dim3 grid((B + THREADS - 1) / THREADS);
    peaks_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        t1T, t2T, lengths, em_sT, em_lT, B, T, threshold1, threshold2,
        window_length1, window_length2, peak_height);
    return (int)cudaGetLastError();
}

}  // extern "C"
