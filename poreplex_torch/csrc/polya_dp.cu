// Best poly(A) interval DP, for Hopper (sm_90a), bound to Python with
// ctypes (poreplex_torch/kernels/polya_dp.py).
//
// Replaces the Pallas TPU kernel _dp_kernel / dp_pallas_core of
// poreplex_tpu/ops/pallas_polya_dp.py: the O(K) sequential recurrence over
// the event columns of each row (every live start lane shares one spike
// budget), with the running score prefix, the spike budget, the running
// minimum of the packed (exclusive prefix + VOFF) * K + start and the
// row-major-first argmax, then the `found` masking of the wrapper
// (pallas_polya_dp.py:162-167).
//
// Exactness: the column scores are computed here as in the plain version
// (poreplex_torch/ops/polya_dp.py): the length, or -spike_weight times it
// (one float32 multiply), truncated toward zero; everything after that is
// int32, so the results equal the plain version's exactly.
//
// What bounds it on the H100: the dependent steps of each row, one per
// event (at most K = 512 or 1024), not bytes (two [N, K] inputs, about
// 2 MB at N = 512, K = 512) and not operations. Design: one thread per
// row, state in registers, 32 threads per block; inputs are read in a
// [K, N] layout so neighbouring threads read neighbouring words.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;
constexpr int INT_MIN_ = -2147483647;   // -2**31 + 1
constexpr int VOFF = 1 << 20;
constexpr int PACK_INF = 2147483647;

// is_polyaT [K, N] (0/1); lengthT [K, N]; n_events [N]; start, end,
// score [N]
__global__ void __launch_bounds__(THREADS)
dp_kernel(const unsigned char* __restrict__ is_polyaT,
          const float* __restrict__ lengthT, const int* __restrict__ n_events,
          int* __restrict__ start, int* __restrict__ end,
          int* __restrict__ score, int N, int K, float spike_weight,
          int spike_tolerance) {
    const int b = blockIdx.x * THREADS + threadIdx.x;
    if (b >= N) return;
    // columns j >= n are never valid and no argmax reads them: a row stops
    // at its event count
    const int n = min(n_events[b], K);
    int prefix = 0, budget = 0, runmin = PACK_INF;
    int best_val = INT_MIN_, best_i = K, best_j = 0;
    for (int j = 0; j < n; ++j) {
        const size_t at = (size_t)j * N + b;
        const bool isp = is_polyaT[at] != 0;
        const float len = lengthT[at];
        const int col = (int)truncf(isp ? len : -spike_weight * len);
        const int spl = isp ? 0 : (int)truncf(len);

        const int prefix_ex = prefix;
        prefix += col;
        budget = isp ? 0 : budget + spl;
        const bool died = !isp && budget > spike_tolerance;
        const int cand = isp ? (prefix_ex + VOFF) * K + j : PACK_INF;
        runmin = min(died ? PACK_INF : runmin, cand);
        const int run_val = runmin / K - VOFF;
        const int run_i = runmin % K;
        const bool valid = (isp || budget < spike_tolerance) &&
                           runmin < PACK_INF;
        const int val = valid ? prefix - run_val : INT_MIN_;
        if (val > best_val || (val == best_val && run_i < best_i)) {
            best_val = val;
            best_i = run_i;
            best_j = j;
        }
    }
    const bool found = best_val > 0;
    start[b] = found ? best_i : 0;
    end[b] = found ? best_j : 0;
    score[b] = found ? best_val : 0;
}

}  // namespace

extern "C" {

// Returns a cudaError_t code.
int pp_polya_dp(const unsigned char* is_polyaT, const float* lengthT,
                const int* n_events, int* start, int* end, int* score, int N,
                int K, float spike_weight, int spike_tolerance, void* stream) {
    if (N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + THREADS - 1) / THREADS);
    dp_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        is_polyaT, lengthT, n_events, start, end, score, N, K, spike_weight,
        spike_tolerance);
    return (int)cudaGetLastError();
}

}  // extern "C"
