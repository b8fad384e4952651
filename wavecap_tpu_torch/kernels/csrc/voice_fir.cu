// K4: the voice-band FIR with the bank's audio epilogue.
//
// Replaces wavecap_tpu/ops/fir.py:fir_filter / conv_valid (the TPU form is
// the banded matmul _conv_valid_matmul; off the TPU the reference takes
// _conv_valid_direct) together with ops/clip.py:rms_normalize, soft_clip
// and squelch_gate, and the active mask of
// wavecap_tpu/models/channel_bank.py:bank_demod_step.  Per slot s, with
// xin = [tail || fm] (the overlap-save carry, T-1 samples):
//
//   y[n]    = sum_k h[k] * xin[n + T-1 - k]             (valid convolution)
//   g       = rms > min_rms ? target / max(rms, min_rms) : 1,  rms = sqrt(mean y^2)
//   audio   = tanh((y * g) * 1.5) * clip_gain            (0 when the squelch is
//             shut, rssi < threshold, or the slot is inactive)
//   rssi'   = active ? rssi : -200,   tail' = last T-1 samples of xin.
//
// Bound on the H100: operations.  At 800 slots x 4,920 samples and 127 taps
// it does ~1.0 GFLOP (15 us at 67 TFLOP/s f32) on 32 MB of traffic
// (10 us at 3.35 TB/s).  Design: one block per slot; the taps, the extended
// row (~20 KB) and the filtered row are staged in shared memory, so the
// normalization's row reduction needs no second pass over device memory.
// Each thread forms whole outputs from shared memory (taps broadcast across
// the warp); register blocking of several outputs per thread, or a banded
// tensor-core product, is later work.
#include "common.cuh"

namespace {

__global__ void voice_fir_kernel(const float* __restrict__ fm, const float* __restrict__ tail,
                                 const float* __restrict__ taps,
                                 const float* __restrict__ rssi,
                                 const float* __restrict__ squelch,
                                 const uint8_t* __restrict__ active, float* __restrict__ audio,
                                 float* __restrict__ rssi_out, float* __restrict__ tail_out,
                                 int s_len, int n_taps, float target_rms, float min_rms,
                                 float clip_gain) {
    extern __shared__ float sm[];
    __shared__ float scratch[32];
    const int slot = blockIdx.x;
    const int tl = n_taps - 1;
    float* h = sm;                 // n_taps
    float* xin = h + n_taps;       // tl + s_len
    float* y = xin + tl + s_len;   // s_len
    const float* row = fm + static_cast<long>(slot) * s_len;
    const float* carry = tail + static_cast<long>(slot) * tl;

    for (int i = threadIdx.x; i < n_taps; i += blockDim.x) h[i] = taps[i];
    for (int i = threadIdx.x; i < tl; i += blockDim.x) xin[i] = carry[i];
    for (int i = threadIdx.x; i < s_len; i += blockDim.x) xin[tl + i] = row[i];
    __syncthreads();

    float energy = 0.f;
    for (int n = threadIdx.x; n < s_len; n += blockDim.x) {
        const float* x = xin + n + tl;
        float acc = 0.f;
        for (int k = 0; k < n_taps; ++k) acc += h[k] * x[-k];
        y[n] = acc;
        energy += acc * acc;
    }
    energy = block_sum(energy, scratch);  // its barrier also publishes y

    const float rms = sqrtf(energy / static_cast<float>(s_len));
    const float gain = rms > min_rms ? target_rms / fmaxf(rms, min_rms) : 1.f;
    const bool on = active[slot] != 0;
    const bool open = on && rssi[slot] >= squelch[slot];
    float* out = audio + static_cast<long>(slot) * s_len;
    for (int n = threadIdx.x; n < s_len; n += blockDim.x)
        out[n] = open ? tanhf((y[n] * gain) * 1.5f) * clip_gain : 0.f;
    float* carry_out = tail_out + static_cast<long>(slot) * tl;
    for (int i = threadIdx.x; i < tl; i += blockDim.x) carry_out[i] = xin[s_len + i];
    if (threadIdx.x == 0) rssi_out[slot] = on ? rssi[slot] : -200.f;
}

}  // namespace

WAVECAP_EXPORT int k4_voice_fir(const void* fm, const void* tail, const void* taps,
                                const void* rssi, const void* squelch, const void* active,
                                void* audio, void* rssi_out, void* tail_out, int n_slots,
                                int s_len, int n_taps, float target_rms, float min_rms,
                                float clip_gain, void* stream) {
    const size_t smem = sizeof(float) * (static_cast<size_t>(n_taps) + (n_taps - 1) + 2 * s_len);
    cudaError_t err = cudaFuncSetAttribute(
        voice_fir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    voice_fir_kernel<<<n_slots, 256, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(fm), static_cast<const float*>(tail),
        static_cast<const float*>(taps), static_cast<const float*>(rssi),
        static_cast<const float*>(squelch), static_cast<const uint8_t*>(active),
        static_cast<float*>(audio), static_cast<float*>(rssi_out), static_cast<float*>(tail_out),
        s_len, n_taps, target_rms, min_rms, clip_gain);
    return static_cast<int>(cudaGetLastError());
}
