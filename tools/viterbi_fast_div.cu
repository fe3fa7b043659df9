// fast_div (poreplex_torch/csrc/viterbi.cu) beside the IEEE division on
// the card: for each triple (x, mu, b), whether it is inside fast_div's
// range (fast_div_operand of x and mu, fast_div_divisor of b) and the bits
// of fast_div(x - mu, b) and (x - mu) / b. Built and read by
// chip_smoke.py's check_fast_div.

#include "../poreplex_torch/csrc/viterbi.cu"

namespace {

__global__ void fast_div_kernel(const float* x, const float* mu,
                                const float* b, int n, int* inside,
                                float* fast, float* ieee) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float a = x[i] - mu[i];
    inside[i] = fast_div_operand(x[i]) & fast_div_operand(mu[i]) &
                fast_div_divisor(b[i]);
    fast[i] = fast_div(a, b[i], recip(b[i]));
    ieee[i] = a / b[i];
}

}  // namespace

extern "C" int pp_fast_div(const float* x, const float* mu, const float* b,
                           int n, int* inside, float* fast, float* ieee,
                           void* stream) {
    fast_div_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        x, mu, b, n, inside, fast, ieee);
    return (int)cudaGetLastError();
}
