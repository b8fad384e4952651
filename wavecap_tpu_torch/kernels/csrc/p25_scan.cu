// K12s and K13s: the P25 per-symbol Gardner timing scans, one CTA per slot.
//
// Replaces the scan branch of wavecap_tpu/models/p25/c4fm.py:c4fm_demodulate
// (the step at c4fm.py:281-290, its lax.scan at :294, then the gain EMA
// and recentring at :299-320; K12s, real rows) and of
// models/p25/cqpsk.py:cqpsk_demodulate (the loop gains and `step` at
// cqpsk.py:346-373, the scan at :453-457, then the differential detector
// and bias tracker at :459-470 shared with the block branch; K13s,
// complex rows).  Per row, over buf = interp_tail (64) ++ filt (n) and the
// carried (pos, freq, integrator, gain or bias, dc or -, prev):
//
//   C4FM:  dc0 = dc 0.9 + mean(filt) 0.1 and amp = 2 / max(gain, 0.05)
//          (2 on the first block); per symbol
//            y   = interp(pos) - dc0,  ym = interp(pos - freq / 2) - dc0
//            err = clip((prev - y) ym / amp^2, +-2)
//   CQPSK: freq0 = sps on the first block; per symbol
//            y   = interp(pos),        ym = interp(pos - freq / 2)
//            err = clip(Re(conj(ym) (prev - y)), +-2)
//   both:  integ = clip(integ + beta err, fmin - sps, fmax - sps)
//          freq  = clip(sps + integ, fmin, fmax)
//          pos   = pos + freq + alpha err,  prev = y
//
// then C4FM's block gain EMA, or CQPSK's detector, soft symbols and
// dibits, and the next position recentred by a whole symbol.  C4FM's
// dc0 comes in from torch (its mean(filt) in the plain version's
// summation order: every symbol reads it, and an ulp would walk the loop
// apart).  interp(p) copies jax.lax.dynamic_slice(buf, (i0,), (2,)): the
// start is clamped to [0, len - 2] while the fraction uses the unclamped
// floor.  Every step is __f*_rn, so nvcc does not contract it into FMAs
// the plain version does not have: each symbol's error moves the next
// position, and one ulp would walk.
//
// Bound on the H100: the serial chain.  Program A's bank (50 rows x 12,564
// f32 in, 1,200 symbols) moves ~2.8 MB (~0.8 us at 3.35 TB/s) and does ~60
// flops a symbol, but each symbol's error moves the next position: the
// mid point, the floor and fraction, the lerp, the error (C4FM: the dc and
// the division by amp^2), its clip, the integrator, the clock, the
// position; 19-22 dependent f32 operations a symbol, ~72-85 SM cycles at
// the latencies measured on the card (chip_smoke.py:SCAN_CHAIN_OPS), the
// same whatever the row count.  One thread walks, so its warp issues one
// instruction a cycle: what a step issues counts beside its chain.
//
// Design: one CTA of four warps a row, one job each while the row is
// walked; no whole row or symbol array in shared memory, so blocks of any
// length run.
//
// * Warp 1 streams the row through a ring of `slots` chunks of `chunk`
//   samples in shared memory, with the first two samples of
//   slot 0 again past its end: cp.async per sample, each chunk's landing
//   counted on its mbarrier; a slot is refilled once the walker's published
//   low mark has passed it by a chunk.  Rows of any length run with the
//   same code, and the walk starts when the first chunk lands.
// * Warp 0's lane 0 walks, in groups of `group` steps: before a group it
//   publishes its low mark and waits for the chunks the group can reach;
//   after it, it publishes the symbols (one release fence a group).  A
//   step's samples are loaded a step ahead: from pos the next position is
//   at least RN(RN(pos + fmin) - 2 alpha) (|err| <= 2, RN is monotone) and
//   less than one sample more, the next mid point at least that less fmax
//   / 2, so floor(next) is one of two indices and three consecutive
//   samples from the lower one hold each read; the floor comes from one
//   addition rounded down onto 1.5 2^23, and the exact floor selects among
//   the samples when the position is known.  Where the plan finds the
//   loop's ranges narrow enough for that (`narrow`), steps whose windows
//   stay inside [0, len - 2) below 2^21 run with no check (tests/
//   test_torch_p25_scan.py holds the windows across the legal ranges);
//   the other steps check their windows and read the row from global
//   memory where one does not hold or the clamp acts.  C4FM's
//   division by the block's den = amp^2 is a multiply by r = RN(1/den) and
//   two fused multiply-adds (correctly rounded while the quotient is
//   normal: Markstein); a numerator outside [2^-80, 2^80] (0, tiny, huge,
//   not finite), or a den outside [2^-30, 2^30], takes __fdiv_rn: an
//   unchecked run that meets one is walked again, each step checked.
//   From the second step the error's clip merges exactly into the
//   integrator's, and the clock's clip is dropped where it is idle (walk).
// * Warp 2 takes the symbols as they are published: C4FM |y| summed,
//   CQPSK z = y[m] conj(y[m-1]), atan2, the pi/4 quantizer and its residual
//   against the carried bias, in the order of p25_common.cuh's epilogues
//   (a block of 256 threads, symbol m to thread m % 256, then block_sum's
//   shuffle trees): the raw symbols or phase steps go to the soft row.
// * Then all four warps rescale the soft row in place and write dibits.
#include "p25_common.cuh"

#include <type_traits>

namespace {

using namespace p25;

// The rings' and the groups' sizes come from the plan (models/p25/
// c4fm.py:k12s_plan): chunk x slots samples of the row, sym_ring symbols
// between the walker and the helper, groups of `group` steps, the first
// ending at symbol `first`.
constexpr int kThreads = 128;  // warp 0 walks, warp 1 stages the row, warp 2 sums; all rescale
constexpr int kProducer = 1, kHelper = 2;
constexpr int kVirtual = 256;   // the block whose summation order (p25_common.cuh) is kept
constexpr int kVirtualWarps = kVirtual / 32;
constexpr float kDivLo = 8.271806125530277e-25f;  // 2^-80: quotients past these take __fdiv_rn
constexpr float kDivHi = 1.2089258196146292e24f;  // 2^80
constexpr float kDenLo = 9.313225746154785e-10f;  // 2^-30
constexpr float kDenHi = 1073741824.f;            // 2^30
constexpr float kFloorShift = 12582912.f;          // 1.5 2^23
constexpr float kFar = 2097152.f;                  // 2^21: positions past it are read from the row

#ifdef K12S_CLOCKS
// clock64 of the walking thread a CTA: [0] start, [1] first chunk landed,
// [2] walk done, [3] the helper's sums done, [4] end (build switch of
// scripts/k12s_k13s_variants.py)
__device__ long long g_k12s_clocks[4096][8];
#define STAMP(k)                                                         \
    do {                                                                 \
        if (blockIdx.x < 4096) g_k12s_clocks[blockIdx.x][k] = clock64(); \
    } while (0)
#else
#define STAMP(k) \
    do {         \
    } while (0)
#endif

__device__ __forceinline__ unsigned smem(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool landed(const uint64_t* bar, unsigned parity) {
    unsigned ok;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
    return ok != 0;
}

__device__ __forceinline__ int load_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(smem(p)) : "memory");
    return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
    asm volatile("st.release.cta.shared.b32 [%0], %1;\n" ::"r"(smem(p)), "r"(v) : "memory");
}

template <typename V>
__device__ __forceinline__ void copy_async(V* dst, const V* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem(dst)), "l"(src), "n"(sizeof(V))
                 : "memory");
}

// A step's samples, loaded a step ahead: the three at the floor `at` of
// the lowest position the step can read (the ring holds two samples past
// its end that repeat its first two, so they are consecutive), and that
// floor as a float.  Good for positions p in [b, b + 2) when 0 <= at <
// len - 2, where the reference's clamp is idle: floor(p) is b or b + 1.
template <typename V>
struct Window {
    float b, b1;  // at, at + 1
    int at;
    V s0, s1, s2;

    // the floor by one addition rounded down onto 1.5 2^23, whose low
    // mantissa bits then hold it: exact for |lo| < 2^22 (the walk checks
    // positions past 2^21 from the row)
    __device__ __forceinline__ void load(const V* ring, int mask, float lo) {
        const float t = __fadd_rd(lo, kFloorShift);
        at = __float_as_int(t) - __float_as_int(kFloorShift);
        b = __fsub_rn(t, kFloorShift);
        b1 = __fadd_rn(b, 1.f);
        const V* r = ring + (__float_as_int(t) & mask);  // = at & mask: 1.5 2^23's low bits are 0
        s0 = r[0];
        s1 = r[1];
        s2 = r[2];
    }

    // interp(p) for p in [b, b + 2)
    __device__ __forceinline__ V sample(float p) const {
        const bool up = p >= b1;
        const float fr = up ? __fsub_rn(p, b1) : __fsub_rn(p, b);
        return lerp(up ? s1 : s0, up ? s2 : s1, fr);
    }

    // whether p lies in the window, below 2^21, and the reference's clamp
    // is idle there
    __device__ __forceinline__ bool holds(float p, int last) const {
        return __fsub_rn(p, b) < 2.f && p < kFar && static_cast<unsigned>(at) < static_cast<unsigned>(last);
    }
};

// interp(p) straight from the row, clamped as the reference's dynamic_slice
template <typename V>
__device__ __forceinline__ V interp_row(const V* buf, float p, int last) {
    const float f = floorf(p);
    const float fr = __fsub_rn(p, f);
    const int i0 = static_cast<int>(clip(f, 0.f, static_cast<float>(last)));
    return lerp(buf[i0], buf[i0 + 1], fr);
}

// What the walk shares with the rest of the CTA, and its constants.
template <typename V>
struct Walk {
    const V* src;  // the row in global memory
    const V* ring;  // the row's chunks in shared memory
    V* syms;        // the symbol ring
    const uint64_t* full;
    int* progress;
    int* consumed;
    int* low;
    int len, n_sym, chunk, slots, group, first, sym_ring;
    bool narrow;  // the windows hold every step's reads: unchecked runs allowed
    Consts c;
    float alpha, beta, dc0, den, rden, div_lo;
};

// The loop's carried state.
template <typename V>
struct State {
    float pos, freq, integ;
    V prev;
};

// One step's reads and error numerator over den from the row, as the
// reference reads them: step 0, and a checked step whose window or
// division range does not hold.  Out of line, so that nothing of it is
// computed on the fast path.
template <typename V>
struct Redo {
    V y;
    float q;
};
template <typename V, bool kCqpsk>
__device__ __noinline__ Redo<V> redo(const V* src, float pos, float pm, V prev, float dc0, float den, int last) {
    V y = interp_row(src, pos, last), ym = interp_row(src, pm, last);
    float q;
    if constexpr (!kCqpsk) {
        y = __fsub_rn(y, dc0);
        ym = __fsub_rn(ym, dc0);
        q = __fdiv_rn(__fmul_rn(__fsub_rn(prev, y), ym), den);
    } else {
        const float2 d = sub(prev, y);
        q = __fadd_rn(__fmul_rn(ym.x, d.x), __fmul_rn(ym.y, d.y));
    }
    return {y, q};
}

// The walk of one row by one thread: (pos, freq, integ, prev) in, out.
//
// The steps run in groups that end at multiples of `group` symbols: before
// a group the walker publishes its low mark and waits for the chunks its
// windows can reach; after it, it publishes the symbols (one release
// fence a group).  The walker's warp issues one instruction a cycle, so
// what a step issues counts as much as its chain.  Where the windows are
// narrow, the steps whose windows stay inside [0, len - 2) below 2^21 run
// unchecked, with no branch but the loop's: there every position lies in
// its window (tests/test_torch_p25_scan.py); only C4FM's division range
// marks such a run bad, and a bad run is walked again from its start
// checked.  The other steps run checked: a step whose window or division
// range does not hold is redone from the row (redo).
//
// Step 0 runs from the row (its integ may lie anywhere).  From step 1 on
// integ lies in [integ_lo, integ_hi], and two exact rewrites shorten the
// chain: with f = RN(integ + .) and g = RN(beta .) monotone,
// clip(f(g(clip(q, +-2))), lo, hi) = clip(f(g(q)), max(f(-g(2)), lo),
// min(f(g(2)), hi)) (the intervals meet at integ; a NaN q goes to the
// lower bound either way), and RN(alpha clip(q, +-2)) = clip(RN(alpha q),
// +-RN(2 alpha)); the clock's clip is skipped where RN(sps + integ_lo) >=
// fmin and RN(sps + integ_hi) <= fmax (kClipFreq false), which makes it
// idle for every integ in range.
template <typename V, bool kCqpsk, bool kClipFreq>
__device__ __forceinline__ void walk(const Walk<V>& w, float& pos_io, float& freq_io, float& integ_io,
                                     V& prev_io) {
    const Consts& c = w.c;
    const int last = w.len - 2;
    const int mask = w.chunk * w.slots - 1;
    const int slot_bits = __popc(w.slots - 1);
    const float a2 = __fmul_rn(2.f, w.alpha), b2 = __fmul_rn(2.f, w.beta);
    const float hmax = __fmul_rn(c.fmax, 0.5f);  // the mid point's offset at most
    const float reach = __fadd_rn(c.fmax, 1.f);  // a step's advance, with room to spare
    const float div_lo = w.div_lo, den = w.den, rden = w.rden;
    State<V> s{pos_io, freq_io, integ_io, prev_io};
    int ready = 0, waited = 0;  // samples landed as the walker knows; chunks waited for
    int allowed = w.sym_ring;   // symbols the walker may write before it asks the helper

    // before `steps` steps: the low mark a chunk behind the lowest read to
    // come, then the chunks up to the highest sample the steps' windows
    // (each a step ahead) can reach
    auto await = [&](int steps) {
        const int need = min(static_cast<int>(__fadd_rn(s.pos, __fmul_rn(static_cast<float>(steps + 1), reach))) + 3,
                             w.len - 1);
        if (need >= ready) {
            store_release(w.low, static_cast<int>(__fsub_rn(s.pos, hmax)) - 1 - w.chunk);
            while (need >= ready) {
                while (!landed(w.full + (waited & (w.slots - 1)), (waited >> slot_bits) & 1)) {
                }
                ++waited;
                ready = min(waited * w.chunk, w.len);
            }
        }
        return need;
    };
    // the windows of a step whose position is at least ly: its mid point
    // is at least ly - fmax / 2
    Window<V> wy, wm;
    auto fetch = [&](float ly) {
        wy.load(w.ring, mask, ly);
        wm.load(w.ring, mask, __fsub_rn(ly, hmax));
    };

    // --- step 0, from the row, as the reference writes it
    await(min(w.first - 1, w.n_sym - 1));
    STAMP(1);
    {
        const Redo<V> rd =
            redo<V, kCqpsk>(w.src, s.pos, __fsub_rn(s.pos, __fmul_rn(s.freq, 0.5f)), s.prev, w.dc0, den, last);
        const float err = clip(rd.q, -2.f, 2.f);
        s.integ = clip(__fadd_rn(s.integ, __fmul_rn(w.beta, err)), c.integ_lo, c.integ_hi);
        s.freq = clip(__fadd_rn(c.sps, s.integ), c.fmin, c.fmax);
        s.pos = __fadd_rn(__fadd_rn(s.pos, s.freq), __fmul_rn(w.alpha, err));
        s.prev = rd.y;
        w.syms[0] = rd.y;
    }
    fetch(s.pos);  // step 1's windows from its own position

    // --- steps 1 .. n_sym - 1, in groups.  `checked`: each step checks
    // its windows and division range and is redone from the row where one
    // does not hold; otherwise a failed check marks the run bad.
    struct Run {
        State<V> s;
        bool bad;
    };
    auto steps = [&](int from, int end, V* sp, auto checked) -> Run {
        float pos = s.pos, integ = s.integ, freq = s.freq, h = __fmul_rn(s.freq, 0.5f);
        V prev = s.prev;
        bool bad = false;
#pragma unroll 2
        for (int k = from; k < end; ++k) {
            const float pm = __fsub_rn(pos, h);
            V y = wy.sample(pos), ym = wm.sample(pm);
            bool ok = true;
            if constexpr (decltype(checked)::value) ok = wy.holds(pos, last) && wm.holds(pm, last);
            // the next step's windows, in place: its position is at least
            // RN(RN(pos + fmin) - 2 alpha)
            fetch(__fsub_rn(__fadd_rn(pos, c.fmin), a2));
            float q;
            if constexpr (!kCqpsk) {
                y = __fsub_rn(y, w.dc0);
                ym = __fsub_rn(ym, w.dc0);
                const float x = __fmul_rn(__fsub_rn(prev, y), ym);
                const float q0 = __fmul_rn(x, rden);
                q = __fmaf_rn(__fmaf_rn(-q0, den, x), rden, q0);
                const float ax = fabsf(x);
                ok = ok && ax >= div_lo && ax <= kDivHi;
            } else {
                const float2 d = sub(prev, y);
                q = __fadd_rn(__fmul_rn(ym.x, d.x), __fmul_rn(ym.y, d.y));
            }
            if constexpr (decltype(checked)::value) {
                if (!ok) {
                    const Redo<V> rd = redo<V, kCqpsk>(w.src, pos, pm, prev, w.dc0, den, last);
                    y = rd.y;
                    q = rd.q;
                }
            } else {
                bad = bad || !ok;
            }
            const float lo_i = fmaxf(__fsub_rn(integ, b2), c.integ_lo);  // the merged clip's bounds
            const float hi_i = fminf(__fadd_rn(integ, b2), c.integ_hi);
            integ = clip(__fadd_rn(integ, __fmul_rn(w.beta, q)), lo_i, hi_i);
            const float t = __fadd_rn(c.sps, integ);
            freq = kClipFreq ? clip(t, c.fmin, c.fmax) : t;
            pos = __fadd_rn(__fadd_rn(pos, freq), clip(__fmul_rn(w.alpha, q), -a2, a2));
            h = __fmul_rn(freq, 0.5f);
            prev = y;
            *sp++ = y;
        }
        return {State<V>{pos, freq, integ, prev}, bad};
    };
    int m = 1;
    while (m < w.n_sym) {
        // the first group short, so that the walk starts on the first chunk
        const int end = min(m < w.first ? w.first : (m | (w.group - 1)) + 1, w.n_sym);
        const int need = await(end - m);
        V* sp = w.syms + (m & (w.sym_ring - 1));
        // with narrow windows, the steps whose windows stay inside [0, len
        // - 2) below 2^21 run unchecked: from a start past the row's first
        // samples, every step while the group's reach stays inside, else as
        // many as the room left at the end allows
        int split = m;
        if (w.narrow && wm.at >= 0 && wy.at < last && static_cast<int>(__fsub_rn(s.pos, hmax)) >= 2 &&
            need < static_cast<int>(kFar)) {
            split = need < last ? end
                                : min(end, m + max(0, static_cast<int>(__fdiv_rn(
                                                         __fsub_rn(static_cast<float>(last - 3),
                                                                   __fadd_rn(s.pos, c.fmin)),
                                                         reach))));
        }
        if (split > m) {
            Run r = steps(m, split, sp, std::false_type{});
            if (__builtin_expect(r.bad, 0)) {  // again from the group's start, each step checked
                fetch(s.pos);
                r = steps(m, split, sp, std::true_type{});
            }
            s = r.s;
        }
        if (split < end) s = steps(split, end, sp + (split - m), std::true_type{}).s;
        store_release(w.progress, end);
        if (end + w.group > allowed) {  // the next group's slots must have been read
            int seen;
            while (end + w.group > (seen = load_acquire(w.consumed)) + w.sym_ring) __nanosleep(32);
            allowed = seen + w.sym_ring;
        }
        m = end;
    }
    if (w.n_sym == 1) store_release(w.progress, 1);
    pos_io = s.pos;
    freq_io = s.freq;
    integ_io = s.integ;
    prev_io = s.prev;
}

template <typename V, bool kCqpsk>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const V* __restrict__ rows_in, const float* __restrict__ st,
            const float* __restrict__ dc_in, float* __restrict__ soft,
            unsigned char* __restrict__ dibits, float* __restrict__ out, int rows, int len,
            int n_sym, int chunk, int slots, int group, int first, int sym_ring, bool narrow, Consts c,
            float alpha, float beta) {
    extern __shared__ __align__(16) unsigned char dyn[];
    V* ring = reinterpret_cast<V*>(dyn);                             // slots x chunk samples
    V* syms = ring + chunk * slots + 2;                              // sym_ring symbols
    uint64_t* full = reinterpret_cast<uint64_t*>(syms + sym_ring + 2);  // a chunk's copies landed
    __shared__ int progress, consumed, low;
    __shared__ float carry[6];
    const int r = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const V* src = rows_in + static_cast<long long>(r) * len;
    float* srow = soft + static_cast<long long>(r) * n_sym;
    unsigned char* drow = dibits + static_cast<long long>(r) * n_sym;
    const float s3 = st[3 * rows + r], s4 = st[4 * rows + r], s5 = st[5 * rows + r];
    if (tid == 0) {
        STAMP(0);
        for (int s = 0; s < slots; ++s)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;\n" ::"r"(smem(full + s)) : "memory");
        progress = 0;
        consumed = 0;
        low = 0;
    }
    __syncthreads();

    if (warp == kProducer) {
        // --- the row through the ring, a chunk at a time
        const int chunks = (len + chunk - 1) / chunk;
        for (int k = 0; k < chunks; ++k) {
            const int slot = k & (slots - 1);
            if (k >= slots) {  // the slot's last chunk is a chunk behind the walker's reads
                const int need = (k - slots + 1) * chunk;
                while (load_acquire(&low) < need) __nanosleep(64);
            }
            const int lo = k * chunk, hi = min(lo + chunk, len);
            V* dst = ring + slot * chunk;
            for (int i = lo + lane; i < hi; i += 32) copy_async(dst + (i - lo), src + i);
            // slot 0's first two samples again past the ring's end, so that
            // a window's three samples are consecutive
            if (slot == 0 && lane < 2 && lo + lane < hi) copy_async(ring + chunk * slots + lane, src + lo + lane);
            asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem(full + slot))
                         : "memory");
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else if (tid == 0) {
        // --- the walk
        float pos = st[r], freq = st[rows + r], integ = st[2 * rows + r];
        if (kCqpsk && freq < 1.f) freq = c.sps;
        // C4FM's division by den = amp^2: the reciprocal once
        const float amp = s3 < 0.01f ? 2.f : __fdiv_rn(2.f, fmaxf(s3, 0.05f));
        const float den = __fmul_rn(amp, amp);
        const bool den_ok = den >= kDenLo && den <= kDenHi;
        const Walk<V> wk{src, ring, syms, full, &progress, &consumed, &low, len, n_sym, chunk, slots, group,
                         first, sym_ring, narrow, c, alpha, beta, kCqpsk ? 0.f : dc_in[r], den,
                         __frcp_rn(den),
                         den_ok ? kDivLo : __int_as_float(0x7f800000)};  // +inf: every step divides
        V prev;
        if constexpr (kCqpsk) {
            prev = make_float2(s4, s5);
        } else {
            prev = s5;
        }
        if (__fadd_rn(c.sps, c.integ_lo) >= c.fmin && __fadd_rn(c.sps, c.integ_hi) <= c.fmax)
            walk<V, kCqpsk, false>(wk, pos, freq, integ, prev);
        else
            walk<V, kCqpsk, true>(wk, pos, freq, integ, prev);
        STAMP(2);
        store_release(&low, 0x7fffffff);  // the producer may finish the row
        carry[0] = pos;
        carry[1] = freq;
        carry[2] = integ;
        if constexpr (kCqpsk) {
            carry[4] = prev.x;
            carry[5] = prev.y;
        } else {
            carry[5] = prev;
        }
    } else if (warp == kHelper) {
        // --- the block sum as the symbols come, in the order of a block of
        // 256 threads: symbol m is thread m % 256's, its warp (m % 256) / 32,
        // its lane m % 32
        float acc[kVirtualWarps];
#pragma unroll
        for (int j = 0; j < kVirtualWarps; ++j) acc[j] = 0.f;
        int avail = 0;
        for (int base = 0; base < n_sym; base += kVirtual) {
#pragma unroll
            for (int j = 0; j < kVirtualWarps; ++j) {
                const int g0 = base + 32 * j;
                if (g0 < n_sym) {
                    const int need = min(g0 + 32, n_sym);
                    while (avail < need) {
                        avail = load_acquire(&progress);
                        if (avail < need) __nanosleep(32);
                    }
                    const int m = g0 + lane;
                    if (m < n_sym) {
                        const V s = syms[m & (sym_ring - 1)];
                        if constexpr (!kCqpsk) {
                            srow[m] = s;
                            acc[j] += fabsf(s);
                        } else {
                            const float2 p = m > 0 ? syms[(m - 1) & (sym_ring - 1)] : make_float2(s4, s5);
                            const float zr = __fadd_rn(__fmul_rn(s.x, p.x), __fmul_rn(s.y, p.y));
                            const float zi = __fsub_rn(__fmul_rn(s.y, p.x), __fmul_rn(s.x, p.y));
                            const float d = atan2f(zi, zr);
                            srow[m] = d;
                            const float q = clip(rintf(__fdiv_rn(__fsub_rn(d, s3), kQuarterPi)), -3.f, 3.f);
                            acc[j] += __fsub_rn(__fsub_rn(d, s3), __fmul_rn(q, kQuarterPi));
                        }
                    }
                    __syncwarp();
                    // every symbol before the group's last is read (CQPSK reads m - 1)
                    if (lane == 0) store_release(&consumed, need - 1);
                }
            }
        }
        // block_sum's order (common.cuh): each warp's shuffle tree, then the
        // warps' sums over 32 lanes (0 past the 8 warps)
        float w[kVirtualWarps];
#pragma unroll
        for (int j = 0; j < kVirtualWarps; ++j) {
            float v = acc[j];
            for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
            w[j] = v;
        }
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < kVirtualWarps; ++j) v = lane == j ? w[j] : v;
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) {
            if constexpr (!kCqpsk) {
                const float scale = __fdiv_rn(2.f, fmaxf(__fdiv_rn(v, static_cast<float>(n_sym)), 0.05f));
                const float g = s3 < 0.01f ? scale : __fadd_rn(__fmul_rn(0.95f, s3), __fmul_rn(0.05f, scale));
                carry[3] = clip(g, 0.05f, 40.f);
            } else {
                carry[3] = __fadd_rn(s3, __fmul_rn(0.02f, __fdiv_rn(v, static_cast<float>(n_sym))));
            }
        }
    }
    __syncthreads();  // the walk, the sums and the soft row are done
    if (tid == 0) STAMP(3);

    const float g = carry[3];
    constexpr int kBatch = 4;  // loads in flight a thread
    for (int m0 = tid; m0 < n_sym; m0 += kBatch * kThreads) {
        float raw[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
            const int m = m0 + j * kThreads;
            raw[j] = m < n_sym ? srow[m] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
            const int m = m0 + j * kThreads;
            if (m < n_sym) {
                const float v = kCqpsk ? __fdiv_rn(__fsub_rn(raw[j], g), kQuarterPi) : __fmul_rn(raw[j], g);
                srow[m] = v;
                drow[m] = to_dibit(v);
            }
        }
    }
    if (tid == 0) {
        const float vals[6] = {recenter(carry[0], len, c), carry[1], carry[2], g,
                               kCqpsk ? carry[4] : dc_in[r], carry[5]};
        for (int q = 0; q < 6; ++q) out[q * rows + r] = vals[q];
        STAMP(4);
    }
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

template <typename V, bool kCqpsk>
int launch_scan(const void* buf, const void* st, const void* dc, void* soft, void* dibits, void* out,
                int rows, int len, int n_sym, int chunk, int slots, int group, int first, int sym_ring,
                int narrow, int smem, Consts c, float alpha, float beta, void* stream) {
    if (rows <= 0) return 0;
    // the plan (models/p25/c4fm.py:k12s_plan): rings of powers of two, at
    // least three chunks, each longer than a step's reads; groups of a power
    // of two steps, the first no longer, with a group and the helper's 32
    // symbols room in the symbol ring; shared memory that holds the layout
    const size_t layout =
        sizeof(V) * (static_cast<size_t>(chunk) * slots + sym_ring + 4) + sizeof(uint64_t) * slots;
    if (!pow2(chunk) || chunk < 64 || !pow2(slots) || slots < 3 || !pow2(group) || first < 1 ||
        first > group || !pow2(sym_ring) || group + 64 > sym_ring || n_sym < 1 || len < 66 ||
        smem < 0 || static_cast<size_t>(smem) < layout)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(scan_kernel<V, kCqpsk>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    scan_kernel<V, kCqpsk><<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const V*>(buf), static_cast<const float*>(st), static_cast<const float*>(dc),
        static_cast<float*>(soft), static_cast<unsigned char*>(dibits), static_cast<float*>(out), rows,
        len, n_sym, chunk, slots, group, first, sym_ring, narrow != 0, c, alpha, beta);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// chunk .. smem: the fields of k12s_plan's K12sPlan, in its order
WAVECAP_EXPORT int k12s_c4fm_scan(const void* buf, const void* st, const void* dc, void* soft,
                                  void* dibits, void* out, int rows, int len, int n_sym, int chunk,
                                  int slots, int group, int first, int sym_ring, int narrow, int smem,
                                  float sps, float fmin, float fmax, float integ_lo, float integ_hi,
                                  float half, float recenter_hi, float lock, float alpha, float beta,
                                  void* stream) {
    const Consts c{sps, fmin, fmax, integ_lo, integ_hi, half, recenter_hi, lock};
    return launch_scan<float, false>(buf, st, dc, soft, dibits, out, rows, len, n_sym, chunk, slots, group,
                                     first, sym_ring, narrow, smem, c, alpha, beta, stream);
}

WAVECAP_EXPORT int k13s_cqpsk_scan(const void* buf, const void* st, const void* dc, void* soft,
                                   void* dibits, void* out, int rows, int len, int n_sym, int chunk,
                                   int slots, int group, int first, int sym_ring, int narrow, int smem,
                                   float sps, float fmin, float fmax, float integ_lo, float integ_hi,
                                   float half, float recenter_hi, float lock, float alpha, float beta,
                                   void* stream) {
    const Consts c{sps, fmin, fmax, integ_lo, integ_hi, half, recenter_hi, lock};
    return launch_scan<float2, true>(buf, st, dc, soft, dibits, out, rows, len, n_sym, chunk, slots, group,
                                     first, sym_ring, narrow, smem, c, alpha, beta, stream);
}

#ifdef K12S_CLOCKS
WAVECAP_EXPORT int k12s_clocks(void* host) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, g_k12s_clocks, sizeof(g_k12s_clocks)));
}
#endif
