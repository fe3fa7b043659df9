// Best poly(A) interval DP, for Hopper (sm_90a), bound to Python with
// ctypes (poreplex_torch/kernels/polya_dp.py).
//
// Replaces the Pallas TPU kernel _dp_kernel / dp_pallas_core of
// poreplex_tpu/ops/pallas_polya_dp.py: per row, the recurrence over the
// event columns (every live start lane shares one spike budget) with the
// running score prefix, the spike budget, the running minimum of
// (exclusive prefix, start) over the poly(A) columns since the last death
// and the row-major-first argmax, then the `found` masking of the wrapper
// (pallas_polya_dp.py:162-167).
//
// Exactness: the column scores are computed as in the plain version
// (poreplex_torch/ops/polya_dp.py): the length, or -spike_weight times it
// (one float32 multiply), truncated toward zero. Everything after that is
// int32 sums, minima and maxima, which may be reassociated freely, so the
// results equal the plain version's exactly. The plain version packs the
// running minimum as (prefix + VOFF) * K + start in int32; here it is the
// pair (prefix, start) in one int64 key, which orders as the packed value
// wherever the packing is exact (the pipeline caps windows so that it is,
// pipeline/polya.py _PACK_SAFE_LEN), and no column divides by K.
//
// What bounds it on the H100: the dependent chain of a row's columns, not
// bytes (5 a column, some 1.3 MB at [512, 512]) nor operations. Design:
// the recurrence is split into scans across the columns. A warp owns a
// row and each lane a chunk of C contiguous columns:
//  1. the lane loads its chunk straight from the [N, K] inputs (16-byte
//     loads where K and the pointers allow: the mask is torch.bool, a
//     byte a column) and summarises it: the sum of its column scores;
//     whether it holds a poly(A) column, and the spike sum since its last
//     one; the largest spike sum before its first poly(A) column; whether
//     a death follows that column, and the least (prefix, start) after
//     the chunk's last such death, in the chunk's own prefix frame;
//  2. warp scans by __shfl_up_sync give each lane the prefix and the
//     budget entering its chunk, then (the deaths before the chunk's
//     first poly(A) column need that budget) the running minimum: a sum,
//     a sum reset at poly(A) columns, a minimum reset at deaths;
//  3. the lane runs the recurrence over its chunk from those, keeping its
//     best (value, start, end);
//  4. a __shfl_xor_sync butterfly takes the lexicographic maximum: higher
//     value, then smaller start, then earlier end.
// A row longer than the warp's 32 * C columns carries the warp's totals
// into the next pass, so any K works. WARPS rows a block: the round's
// launch at [512, 512] is 512 warps in 128 blocks. One launch takes both
// decision packs of a round: rows [0, R) read the first mask, rows
// [R, 2R) the second, both with the round's one length and event count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int INT_MIN_ = -2147483647;   // -2**31 + 1, the plain version's
constexpr long long KEY_INF = 0x7fffffffffffffffLL;
constexpr unsigned FULL = 0xffffffffu;

// (prefix, start) as one key that orders as the pair, prefix first
__device__ __forceinline__ long long make_key(int prefix, int start) {
    return (long long)prefix * 4294967296LL + start;
}

__device__ __forceinline__ int key_prefix(long long key) {
    return (int)(key >> 32);
}

__device__ __forceinline__ int key_start(long long key) {
    return (int)(unsigned)key;
}

// the 0/1 bytes of a word as 4 bits
__device__ __forceinline__ unsigned byte_bits(unsigned w) {
    return (w & 1u) | ((w >> 7) & 2u) | ((w >> 14) & 4u) | ((w >> 21) & 8u);
}

// A lane's chunk of C columns from j0: the poly(A) bits and the lengths.
// Columns at and past n are never valid and only follow the valid ones,
// so what they hold does not matter: a chunk that starts past n is not
// read, a VEC chunk that starts before it is read whole (VEC: K is a
// multiple of C, so the chunk ends within the row), and a scalar chunk
// repeats column n - 1 past n, so its loads need no predicate.
template <int C, bool VEC>
__device__ __forceinline__ void load_chunk(const unsigned char* isp,
                                           const float* len, int j0, int n,
                                           unsigned& bits, float (&l)[C]) {
    bits = 0;
    if (j0 >= n) {
#pragma unroll
        for (int c = 0; c < C; ++c) l[c] = 0.0f;
    } else if (VEC) {
#pragma unroll
        for (int q = 0; q < C / 16; ++q) {
            const uint4 w = *reinterpret_cast<const uint4*>(isp + j0 + 16 * q);
            bits |= (byte_bits(w.x) | byte_bits(w.y) << 4 |
                     byte_bits(w.z) << 8 | byte_bits(w.w) << 12) << (16 * q);
        }
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(len + j0 + 4 * q);
            l[4 * q] = v.x;
            l[4 * q + 1] = v.y;
            l[4 * q + 2] = v.z;
            l[4 * q + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int j = min(j0 + c, n - 1);
            bits |= (isp[j] != 0 ? 1u : 0u) << c;
            l[c] = len[j];
        }
    }
}

// isp_a, isp_b [R, K] bytes (0/1); length [R, K]; n_events [R];
// out [3, 2R]: start, end, score.
template <int C, bool VEC>
__global__ void __launch_bounds__(THREADS)
dp_kernel(const unsigned char* __restrict__ isp_a,
          const unsigned char* __restrict__ isp_b,
          const float* __restrict__ length, const int* __restrict__ n_events,
          int* __restrict__ out, int R, int K, float neg_weight, int tol) {
    const int lane = threadIdx.x & 31;
    // warp-uniform by construction, so no shuffle below sits in code the
    // compiler must treat as divergent
    const int row = blockIdx.x * WARPS +
                    __shfl_sync(FULL, (int)threadIdx.x >> 5, 0);
    const int rows = 2 * R;
    if (row >= rows) return;
    const int src = row < R ? row : row - R;
    const unsigned char* isp = (row < R ? isp_a : isp_b) + (size_t)src * K;
    const float* len = length + (size_t)src * K;
    const int n = min(__shfl_sync(FULL, lane == 0 ? n_events[src] : 0, 0), K);

    // the warp's totals entering a pass, and the lane's best
    int carry_prefix = 0, carry_budget = 0;
    long long carry_min = KEY_INF;
    int best_val = INT_MIN_, best_i = 0x7fffffff, best_j = 0x7fffffff;

    for (int base = 0; base < n; base += 32 * C) {
        const int j0 = base + lane * C;
        unsigned bits;
        float l[C];
        load_chunk<C, VEC>(isp, len, j0, n, bits, l);

        // 1. the chunk's columns and its summaries
        int col[C], spl[C];
        int csum = 0, budget = 0, pre_max = 0;
        bool seen = false, has_pre = false, reset = false;
        long long local_min = KEY_INF;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const bool p = (bits >> c) & 1u;
            col[c] = (int)truncf(p ? l[c] : neg_weight * l[c]);
            spl[c] = p ? 0 : (int)truncf(l[c]);
            const int prefix_ex = csum;
            csum += col[c];
            budget = p ? 0 : budget + spl[c];
            // before the first poly(A) column the budget is the one
            // entering plus this; after it, this alone
            const bool pre = !seen && !p;
            pre_max = pre ? (has_pre ? max(pre_max, budget) : budget)
                          : pre_max;
            has_pre |= pre;
            seen |= p;
            const bool died = seen && !p && budget > tol;
            reset |= died;
            local_min = died ? KEY_INF
                             : (p ? min(local_min, make_key(prefix_ex, j0 + c))
                                  : local_min);
        }

        // 2. the prefix and the budget entering the chunk (inclusive
        // scans, then a shift by one lane)
        int s = csum, b = budget, h = seen;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int ts = __shfl_up_sync(FULL, s, d);
            const int tb = __shfl_up_sync(FULL, b, d);
            const int th = __shfl_up_sync(FULL, h, d);
            if (lane >= d) {
                s += ts;
                b = h ? b : b + tb;
                h |= th;
            }
        }
        int s_ex = __shfl_up_sync(FULL, s, 1);
        int b_ex = __shfl_up_sync(FULL, b, 1);
        int h_ex = __shfl_up_sync(FULL, h, 1);
        if (lane == 0) s_ex = b_ex = h_ex = 0;
        const int prefix_in = carry_prefix + s_ex;
        const int budget_in = h_ex ? b_ex : carry_budget + b_ex;
        const int s_all = __shfl_sync(FULL, s, 31);
        const int b_all = __shfl_sync(FULL, b, 31);
        const int h_all = __shfl_sync(FULL, h, 31);
        carry_prefix += s_all;
        carry_budget = h_all ? b_all : carry_budget + b_all;

        // the running minimum entering the chunk: reset where a death
        // precedes its first poly(A) column or follows it
        int r = reset || (has_pre && budget_in + pre_max > tol);
        long long m = local_min == KEY_INF
                          ? KEY_INF
                          : local_min + make_key(prefix_in, 0);
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const long long tm = __shfl_up_sync(FULL, m, d);
            const int tr = __shfl_up_sync(FULL, r, d);
            if (lane >= d) {
                m = r ? m : min(m, tm);
                r |= tr;
            }
        }
        long long m_ex = __shfl_up_sync(FULL, m, 1);
        int r_ex = __shfl_up_sync(FULL, r, 1);
        if (lane == 0) {
            m_ex = KEY_INF;
            r_ex = 0;
        }
        long long run = r_ex ? m_ex : min(carry_min, m_ex);
        const long long m_all = __shfl_sync(FULL, m, 31);
        const int r_all = __shfl_sync(FULL, r, 31);
        carry_min = r_all ? m_all : min(carry_min, m_all);

        // 3. the recurrence over the chunk
        int prefix = prefix_in;
        budget = budget_in;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const bool p = (bits >> c) & 1u;
            const int j = j0 + c;
            const int prefix_ex = prefix;
            prefix += col[c];
            budget = p ? 0 : budget + spl[c];
            const bool died = !p && budget > tol;
            run = died ? KEY_INF
                       : (p ? min(run, make_key(prefix_ex, j)) : run);
            const bool valid = j < n && (p || budget < tol) && run != KEY_INF;
            const int val = prefix - key_prefix(run);
            const int vi = key_start(run);
            const bool take = valid && (val > best_val ||
                                        (val == best_val && vi < best_i));
            best_val = take ? val : best_val;
            best_i = take ? vi : best_i;
            best_j = take ? j : best_j;
        }
    }

    // 4. the warp's best
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        const int ov = __shfl_xor_sync(FULL, best_val, d);
        const int oi = __shfl_xor_sync(FULL, best_i, d);
        const int oj = __shfl_xor_sync(FULL, best_j, d);
        const bool take = ov > best_val ||
                          (ov == best_val &&
                           (oi < best_i || (oi == best_i && oj < best_j)));
        best_val = take ? ov : best_val;
        best_i = take ? oi : best_i;
        best_j = take ? oj : best_j;
    }
    if (lane == 0) {
        const bool found = best_val > 0;
        out[row] = found ? best_i : 0;
        out[rows + row] = found ? best_j : 0;
        out[2 * rows + row] = found ? best_val : 0;
    }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <int C>
void launch(const unsigned char* isp_a, const unsigned char* isp_b,
            const float* length, const int* n_events, int* out, int R, int K,
            float neg_weight, int tol, cudaStream_t stream) {
    const dim3 grid((2 * R + WARPS - 1) / WARPS);
    // 16-byte loads where every row starts on a 16-byte boundary and every
    // chunk that starts within a row ends within it
    const bool vec = K % C == 0 && aligned16(isp_a) && aligned16(isp_b) &&
                     aligned16(length);
    if (vec)
        dp_kernel<C, true><<<grid, THREADS, 0, stream>>>(
            isp_a, isp_b, length, n_events, out, R, K, neg_weight, tol);
    else
        dp_kernel<C, false><<<grid, THREADS, 0, stream>>>(
            isp_a, isp_b, length, n_events, out, R, K, neg_weight, tol);
}

}  // namespace

extern "C" {

// The DP of both decision packs of a round over their one length and
// event count; out is int32 [3, 2R]: start, end, score of the rows of
// is_polya_a, then of is_polya_b. Returns a cudaError_t code.
int pp_polya_dp(const unsigned char* is_polya_a,
                const unsigned char* is_polya_b, const float* length,
                const int* n_events, int* out, int R, int K,
                float spike_weight, int spike_tolerance, void* stream) {
    if (R <= 0 || K <= 0 || is_polya_a == nullptr || is_polya_b == nullptr)
        return (int)cudaErrorInvalidValue;
    const float neg_weight = -spike_weight;
    if (K <= 32 * 16)
        launch<16>(is_polya_a, is_polya_b, length, n_events, out, R, K,
                   neg_weight, spike_tolerance, (cudaStream_t)stream);
    else
        launch<32>(is_polya_a, is_polya_b, length, n_events, out, R, K,
                   neg_weight, spike_tolerance, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

// (rows a block, threads a block, blocks) of a launch over `rows` rows
int pp_polya_dp_launch_shape(int rows, int* shape) {
    if (rows <= 0) return (int)cudaErrorInvalidValue;
    shape[0] = WARPS;
    shape[1] = THREADS;
    shape[2] = (rows + WARPS - 1) / WARPS;
    return 0;
}

}  // extern "C"
