// K10's step functions: sin and cos of one bounded argument, the PLL's
// detector as the atan of a positive abscissa, and the Costas wrap without
// fmodf.  Their float32 coefficients come from ops/pll.py (K10Coeffs, by
// value), so the CPU tests evaluate the same constants in the same order.
#pragma once

#include <cuda_runtime.h>

struct K10Coeffs {
    float two_over_pi;   // 2 / pi
    float pio2[3];       // pi / 2 = pio2[0] + pio2[1] + pio2[2] (Cody-Waite)
    float sin[3];        // sin r = r + r z (sin[0] z^2 + sin[1] z + sin[2]), z = r^2
    float cos[3];        // cos r = 1 - z / 2 + z^2 (cos[0] z^2 + cos[1] z + cos[2])
    float atan[8];       // atan t = t + t s P(s), s = t^2, atan[0] the highest power
    float atan_pio2;     // pi / 2 for atan of |y| > x
    float fast_max;      // |x| above which sincosf runs (never after the wrap)
};

// sin(x) and cos(x) from one reduction by pi / 2: j = rint(x 2/pi) by
// adding and taking off 1.5 * 2^23 (two multiply-adds, where rintf takes
// ~20 cycles), the quadrant from the sum's low bits, r in [-pi/4, pi/4] by
// three multiply-adds, Cephes' polynomials (Moshier, public domain).
// Within 2 ulp of float64 for |x| <= fast_max; CHECKED takes sincosf
// beyond it.
template <bool CHECKED>
__device__ __forceinline__ void k10_sincos(float x, const K10Coeffs& k, float& s, float& c) {
    const float shift = 12582912.0f;  // 1.5 * 2^23: the sum's ulp is 1
    const float jm = fmaf(x, k.two_over_pi, shift);
    const float j = __fsub_rn(jm, shift);
    float r = fmaf(-j, k.pio2[0], x);
    r = fmaf(-j, k.pio2[1], r);
    r = fmaf(-j, k.pio2[2], r);
    const float z = __fmul_rn(r, r);
    const float ps = fmaf(fmaf(k.sin[0], z, k.sin[1]), z, k.sin[2]);
    const float sr = fmaf(__fmul_rn(r, z), ps, r);
    const float pc = fmaf(fmaf(k.cos[0], z, k.cos[1]), z, k.cos[2]);
    const float cr = fmaf(__fmul_rn(z, z), pc, fmaf(-0.5f, z, 1.0f));
    const int q = __float_as_int(jm);  // j mod 4 in the low bits
    const float s1 = (q & 1) ? cr : sr;
    const float c1 = (q & 1) ? sr : cr;
    s = (q & 2) ? -s1 : s1;
    c = ((q + 1) & 2) ? -c1 : c1;
    if (CHECKED && fabsf(x) > k.fast_max) sincosf(x, &s, &c);  // a state handed over unwrapped
}

// atan2(y, x) for x > 0: atan(|y| / x) when |y| <= x, else pi/2 - atan(x / |y|),
// with y's sign.  The quotient is a reciprocal with one Newton step.  Within
// 3 ulp of float64 atan2; no NaN or infinity handling.
__device__ __forceinline__ float k10_atan_pos(float y, float x, const K10Coeffs& k) {
    const float ay = fabsf(y);
    const float num = fminf(ay, x);
    const float den = fmaxf(ay, x);
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(den));
    const float t1 = __fmul_rn(num, r);
    const float t = fmaf(r, fmaf(-den, t1, num), t1);
    const float s = __fmul_rn(t, t);
    // P(s) by Estrin's scheme: three multiply-adds deep, not Horner's seven
    const float s2 = __fmul_rn(s, s);
    const float s4 = __fmul_rn(s2, s2);
    const float r0 = fmaf(fmaf(k.atan[4], s, k.atan[5]), s2, fmaf(k.atan[6], s, k.atan[7]));
    const float r1 = fmaf(fmaf(k.atan[0], s, k.atan[1]), s2, fmaf(k.atan[2], s, k.atan[3]));
    const float p = fmaf(r1, s4, r0);
    const float a = fmaf(__fmul_rn(t, s), p, t);
    return copysignf(ay > x ? __fsub_rn(k.atan_pio2, a) : a, y);
}

// The PLL's wrap, p > pi ? p - 2pi : (p < -pi ? p + 2pi : p), as two
// selects (the compiler turns the conditional form into branches).
__device__ __forceinline__ float k10_pll_wrap(float p, float pi, float two_pi) {
    const float hi = __fsub_rn(p, two_pi);
    const float lo = __fadd_rn(p, two_pi);
    float out;
    asm("{\n\t.reg .pred g, l;\n\tsetp.gt.f32 g, %1, %2;\n\tsetp.lt.f32 l, %1, %3;\n\t"
        "selp.f32 %0, %4, %1, l;\n\tselp.f32 %0, %5, %0, g;\n\t}"
        : "=f"(out) : "f"(p), "f"(pi), "f"(-pi), "f"(lo), "f"(hi));
    return out;
}

// mod(v, 2 pi) - pi with the divisor's sign, as jnp.mod: bit-equal to the
// fmodf form for every v.  Three exact-or-rounded-once cases cover
// -2pi < v < 4pi (v - 2pi is exact there by Sterbenz's lemma), as selects;
// CHECKED takes fmodf for the rest.
template <bool CHECKED>
__device__ __forceinline__ float k10_costas_wrap(float v, float pi, float two_pi) {
    const float r0 = __fsub_rn(v, pi);
    const float r1 = __fsub_rn(__fsub_rn(v, two_pi), pi);
    const float r2 = __fsub_rn(__fadd_rn(v, two_pi), pi);
    float out;
    asm("{\n\t.reg .pred ge, lt;\n\tsetp.ge.f32 ge, %1, 0f00000000;\n\tsetp.lt.f32 lt, %1, %2;\n\t"
        "selp.f32 %0, %3, %4, lt;\n\tselp.f32 %0, %0, %5, ge;\n\t}"
        : "=f"(out) : "f"(v), "f"(two_pi), "f"(r0), "f"(r1), "f"(r2));
    if (CHECKED && !(v > -two_pi && v < __fadd_rn(two_pi, two_pi))) {
        float m = fmodf(v, two_pi);
        if (m != 0.f && m < 0.f) m = __fadd_rn(m, two_pi);
        out = __fsub_rn(m, pi);
    }
    return out;
}
