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
// Exactness: the state machine only subtracts floats, compares and
// selects, in the plain version's order (poreplex_torch/ops/
// event_detection.py _detector_step), so its emissions equal the plain
// version's bit for bit.
//
// What bounds it on the H100: the T dependent steps of each read, not
// bytes (4 arrays of B x T words: about 34 MB at B = 256, T = 8192, some
// 10 us at 3.35 TB/s) and not operations. A frame costs the latency of one
// detector step, so the design keeps everything else off that chain:
//
// * A block owns ROWS = 32 reads, one per lane, and has four warps: the
//   short detector, the long detector and two copy warps. The long detector
//   reads nothing of the short one but, per frame, whether it dominates
//   and where (the mask it imposes), so the short warp runs tile p while
//   the long warp runs tile p - 1 from the short warp's mask stream in
//   shared memory: each warp's dependent chain is one detector's.
// * The copy warps stage tiles of TILE frames of both t-statistics into a
//   double-buffered ring in shared memory by cp.async, straight from the
//   caller's [B, T] rows (16-byte copies when T allows), and write each
//   finished tile of emissions back with coalesced 16-byte stores, -1 past
//   a read's length. The detector warps read and write only shared memory,
//   four frames at a time (a row's tile is TILE + 4 words apart, so the
//   float4 accesses of a quarter-warp hit distinct banks).
// * The step is branch-free (selects only), as in the Pallas kernel and
//   the plain version, so a warp stays converged whatever case each lane
//   is in. One __syncthreads() per tile.
//
// With B = 256 it runs 8 blocks; each read's frames are a chain either way.

#include <cuda_runtime.h>
#include <cfloat>
#include <climits>

namespace {

constexpr int ROWS = 32;                  // reads per block, one per lane
constexpr int TILE = 64;                  // frames per tile
constexpr int STRIDE = TILE + 4;          // words per row of a staged tile
constexpr int TILE_WORDS = ROWS * STRIDE;
// warps of a block: the two detectors, then COPY_WARPS copy warps (one
// alone worked 113 cycles a frame on an H100, more than either detector)
constexpr int SHORT_WARP = 0, LONG_WARP = 1, COPY_WARP = 2;
constexpr int COPY_WARPS = 2;
constexpr int WARPS = COPY_WARP + COPY_WARPS;
constexpr int COPY_THREADS = 32 * COPY_WARPS;
constexpr int NO_MASK = INT_MIN;  // in the mask stream: no short peak dominates
constexpr unsigned FULL = 0xffffffffu;
// double-buffered tiles of t1, t2, the mask stream, em_s and em_l, then
// the reads' lengths
constexpr size_t SMEM_BYTES = sizeof(int) * (10 * TILE_WORDS + ROWS);

static_assert(TILE % 32 == 0, "a row's tile starts in bank 4 * row");

struct Detector {
    float peak_value;
    int peak_pos;
    int masked_to;
    bool valid;
};

__device__ __forceinline__ Detector fresh() {
    return Detector{FLT_MAX, -1, 0, false};
}

// One frame of one detector, with selects only (the plain version's
// _detector_step): returns the emission (-1 for none) and sets dom and
// dom_pos, whether the detector dominates after the frame and its peak.
__device__ __forceinline__ int step(Detector& d, float tval, int i, int len,
                                   float threshold, int half_window,
                                   float peak_height, bool& dom,
                                   int& dom_pos) {
    const bool skip = (d.masked_to >= i) | (i >= len);
    const bool not_in_peak = d.peak_pos == -1;
    // CASE 1: no maximum recorded yet
    const bool deeper = tval < d.peak_value;
    const bool qualify = (tval - d.peak_value) > peak_height;
    const float pv1 = (deeper | qualify) ? tval : d.peak_value;
    const int pp1 = (!deeper & qualify) ? i : d.peak_pos;
    // CASE 2: inside an existing peak
    const bool higher = tval > d.peak_value;
    float pv2 = higher ? tval : d.peak_value;
    int pp2 = higher ? i : d.peak_pos;
    bool valid2 = d.valid | (((pv2 - tval) > peak_height) & (pv2 > threshold));
    const bool fire = valid2 & ((i - pp2) > half_window);
    const int emitted = fire ? pp2 : -1;
    pp2 = fire ? -1 : pp2;
    pv2 = fire ? tval : pv2;
    valid2 = valid2 & !fire;

    const int new_pp = not_in_peak ? pp1 : pp2;
    const float new_pv = not_in_peak ? pv1 : pv2;
    const bool new_valid = not_in_peak ? d.valid : valid2;
    d.peak_pos = skip ? d.peak_pos : new_pp;
    d.peak_value = skip ? d.peak_value : new_pv;
    d.valid = skip ? d.valid : new_valid;
    dom = !skip & !not_in_peak & (new_pv > threshold);
    dom_pos = new_pp;
    return (skip | not_in_peak) ? -1 : emitted;
}

// The short detector's frame: its emission, and in mask the long
// detector's masked_to while the short one dominates (else NO_MASK).
__device__ __forceinline__ int short_step(Detector& d, float tval, int i,
                                          int len, float threshold,
                                          int window_length, float peak_height,
                                          int& mask) {
    bool dom;
    int dom_pos;
    const int e = step(d, tval, i, len, threshold, window_length / 2,
                       peak_height, dom, dom_pos);
    mask = dom ? dom_pos + window_length : NO_MASK;
    return e;
}

// The long detector's frame: the short detector's reset and mask, then
// its own step.
__device__ __forceinline__ int long_step(Detector& d, float tval, int mask,
                                         int i, int len, float threshold,
                                         int window_length,
                                         float peak_height) {
    const bool reset = mask != NO_MASK;
    d.masked_to = reset ? mask : d.masked_to;
    d.peak_pos = reset ? -1 : d.peak_pos;
    d.peak_value = reset ? FLT_MAX : d.peak_value;
    d.valid = d.valid & !reset;
    bool dom;
    int dom_pos;
    return step(d, tval, i, len, threshold, window_length / 2, peak_height,
                dom, dom_pos);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(a), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(a), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared memory of a block: each tile [2][ROWS][STRIDE], buffer p & 1
// holding tile p.
struct Tiles {
    float* t1;
    float* t2;
    int* mask;
    int* em_s;
    int* em_l;
    int* lens;
};

__device__ __forceinline__ Tiles tiles(int* smem) {
    float* f = reinterpret_cast<float*>(smem);
    return Tiles{f, f + 2 * TILE_WORDS, smem + 4 * TILE_WORDS,
                 smem + 6 * TILE_WORDS, smem + 8 * TILE_WORDS,
                 smem + 10 * TILE_WORDS};
}

__device__ __forceinline__ int buffer(int tile) {
    return (tile & 1) * TILE_WORDS;
}

// Thread ct of THREADS copy threads stages its share of frames [f0, f0 +
// TILE) of src rows row0 .. into dst [ROWS][STRIDE], each row up to its
// length (VEC: 16-byte copies, rounded up to whole copies, T % 4 == 0).
template <bool VEC, int THREADS>
__device__ __forceinline__ void stage(const float* __restrict__ src, float* dst,
                                      const int* lens, int row0, int nrows,
                                      int T, int f0, int ct) {
    if (VEC) {
        constexpr int CH = TILE / 4;
        for (int k = ct; k < ROWS * CH; k += THREADS) {
            const int r = k / CH, c = 4 * (k % CH);
            if (r < nrows && f0 + c < lens[r])
                cp_async16(dst + r * STRIDE + c,
                           src + (size_t)(row0 + r) * T + f0 + c);
        }
    } else {
        for (int k = ct; k < ROWS * TILE; k += THREADS) {
            const int r = k / TILE, c = k % TILE;
            if (r < nrows && f0 + c < lens[r])
                cp_async4(dst + r * STRIDE + c,
                          src + (size_t)(row0 + r) * T + f0 + c);
        }
    }
}

// Thread ct of THREADS copy threads writes its share of frames [f0, f0 +
// TILE) of the emission tile src [ROWS][STRIDE] to dst rows row0 .., -1
// from each row's length on.
template <bool VEC, int THREADS>
__device__ __forceinline__ void flush(int* __restrict__ dst, const int* src,
                                      const int* lens, int row0, int nrows,
                                      int T, int f0, int ct) {
    if (VEC) {
        constexpr int CH = TILE / 4;
        for (int k = ct; k < ROWS * CH; k += THREADS) {
            const int r = k / CH, c = 4 * (k % CH), f = f0 + c;
            if (r < nrows && f < T) {
                int4 v = *reinterpret_cast<const int4*>(src + r * STRIDE + c);
                const int len = lens[r];
                v.x = f < len ? v.x : -1;
                v.y = f + 1 < len ? v.y : -1;
                v.z = f + 2 < len ? v.z : -1;
                v.w = f + 3 < len ? v.w : -1;
                *reinterpret_cast<int4*>(dst + (size_t)(row0 + r) * T + f) = v;
            }
        }
    } else {
        for (int k = ct; k < ROWS * TILE; k += THREADS) {
            const int r = k / TILE, c = k % TILE, f = f0 + c;
            if (r < nrows && f < T)
                dst[(size_t)(row0 + r) * T + f] =
                    f < lens[r] ? src[r * STRIDE + c] : -1;
        }
    }
}

// t1, t2 [B, T]; lengths [B]; em_s, em_l [B, T]. Phase p: the short warp
// runs tile p, the long warp tile p - 1, the copy warps stage t1 of tile
// p + 1 and t2 of tile p and write em_s of tile p - 1 and em_l of tile
// p - 2. Tiles past the block's longest read are written -1 without a
// step.
template <bool VEC>
__global__ void __launch_bounds__(WARPS * 32, 1)
peaks_kernel(const float* __restrict__ t1, const float* __restrict__ t2,
             const int* __restrict__ lengths, int* __restrict__ em_s,
             int* __restrict__ em_l, int B, int T, float threshold1,
             float threshold2, int window_length1, int window_length2,
             float peak_height) {
    extern __shared__ __align__(16) int smem[];
    const Tiles s = tiles(smem);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int ct = threadIdx.x - 32 * COPY_WARP;   // thread of the copy warps
    const int row0 = blockIdx.x * ROWS;
    const int nrows = min(ROWS, B - row0);
    const int len = lane < nrows ? min(max(lengths[row0 + lane], 0), T) : 0;
    const int valid_tiles = (__reduce_max_sync(FULL, len) + TILE - 1) / TILE;
    const int ntiles = (T + TILE - 1) / TILE;
    if (warp == SHORT_WARP) s.lens[lane] = len;
    __syncthreads();
    if (warp >= COPY_WARP) {
        if (valid_tiles > 0)
            stage<VEC, COPY_THREADS>(t1, s.t1, s.lens, row0, nrows, T, 0, ct);
        cp_async_commit();
        cp_async_wait_all();
    }
    __syncthreads();

    Detector d = fresh();
    for (int p = 0; p < ntiles + 2; ++p) {
        if (warp == SHORT_WARP && p < valid_tiles) {
            const int b = buffer(p) + lane * STRIDE, f0 = p * TILE;
#pragma unroll 4
            for (int c = 0; c < TILE; c += 4) {
                const float4 tv = *reinterpret_cast<const float4*>(s.t1 + b + c);
                int4 e, m;
                e.x = short_step(d, tv.x, f0 + c, len, threshold1,
                                 window_length1, peak_height, m.x);
                e.y = short_step(d, tv.y, f0 + c + 1, len, threshold1,
                                 window_length1, peak_height, m.y);
                e.z = short_step(d, tv.z, f0 + c + 2, len, threshold1,
                                 window_length1, peak_height, m.z);
                e.w = short_step(d, tv.w, f0 + c + 3, len, threshold1,
                                 window_length1, peak_height, m.w);
                *reinterpret_cast<int4*>(s.em_s + b + c) = e;
                *reinterpret_cast<int4*>(s.mask + b + c) = m;
            }
        } else if (warp == LONG_WARP && p >= 1 && p <= valid_tiles) {
            const int b = buffer(p - 1) + lane * STRIDE, f0 = (p - 1) * TILE;
#pragma unroll 4
            for (int c = 0; c < TILE; c += 4) {
                const float4 tv = *reinterpret_cast<const float4*>(s.t2 + b + c);
                const int4 m = *reinterpret_cast<const int4*>(s.mask + b + c);
                int4 e;
                e.x = long_step(d, tv.x, m.x, f0 + c, len, threshold2,
                                window_length2, peak_height);
                e.y = long_step(d, tv.y, m.y, f0 + c + 1, len, threshold2,
                                window_length2, peak_height);
                e.z = long_step(d, tv.z, m.z, f0 + c + 2, len, threshold2,
                                window_length2, peak_height);
                e.w = long_step(d, tv.w, m.w, f0 + c + 3, len, threshold2,
                                window_length2, peak_height);
                *reinterpret_cast<int4*>(s.em_l + b + c) = e;
            }
        } else if (warp >= COPY_WARP) {
            if (p + 1 < valid_tiles)
                stage<VEC, COPY_THREADS>(t1, s.t1 + buffer(p + 1), s.lens,
                                         row0, nrows, T, (p + 1) * TILE, ct);
            if (p < valid_tiles)
                stage<VEC, COPY_THREADS>(t2, s.t2 + buffer(p), s.lens, row0,
                                         nrows, T, p * TILE, ct);
            cp_async_commit();
            if (p >= 1 && p <= ntiles)
                flush<VEC, COPY_THREADS>(em_s, s.em_s + buffer(p - 1), s.lens,
                                         row0, nrows, T, (p - 1) * TILE, ct);
            if (p >= 2)
                flush<VEC, COPY_THREADS>(em_l, s.em_l + buffer(p - 2), s.lens,
                                         row0, nrows, T, (p - 2) * TILE, ct);
            cp_async_wait_all();
        }
        __syncthreads();
    }
}

bool aligned16(const void* p) {
    return ((size_t)p & 15) == 0;
}

int blocks(int B) { return (B + ROWS - 1) / ROWS; }

}  // namespace

extern "C" {

// Returns a cudaError_t code.
int pp_detect_peaks(const float* t1, const float* t2, const int* lengths,
                    int* em_s, int* em_l, int B, int T, float threshold1,
                    float threshold2, int window_length1, int window_length2,
                    float peak_height, void* stream) {
    if (B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
    const bool vec = T % 4 == 0 && aligned16(t1) && aligned16(t2) &&
                     aligned16(em_s) && aligned16(em_l);
    auto kernel = vec ? &peaks_kernel<true> : &peaks_kernel<false>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks(B), WARPS * 32, SMEM_BYTES, (cudaStream_t)stream>>>(
        t1, t2, lengths, em_s, em_l, B, T, threshold1, threshold2,
        window_length1, window_length2, peak_height);
    return (int)cudaGetLastError();
}

// The launch for B reads: shape = {reads per block, threads per block,
// blocks}.
int pp_peaks_launch_shape(int B, int* shape) {
    if (B <= 0) return (int)cudaErrorInvalidValue;
    shape[0] = ROWS;
    shape[1] = WARPS * 32;
    shape[2] = blocks(B);
    return 0;
}

}  // extern "C"
