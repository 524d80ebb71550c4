// The 16-byte word moves shared by the tile transposes K1 and K6 (skew.cu)
// and K3 and K5 (unskew_unpack.cu).
//
// Both write a run of contiguous bytes whose start may lie at any address:
// they walk the 16-byte words that cover the run, store a word wholly
// inside the run with one 16-byte store and only the run's bytes of the
// head and tail words, in 4-byte pieces where a whole piece lies in the run
// and byte by byte elsewhere.
#pragma once

#include <cstdint>

// Bytes [lo, hi) of the 16-byte word q at the 16-aligned address a, for the
// run [gs, ge) that a's word overlaps.
__device__ __forceinline__ void dpt_store_word(uint8_t* a, const uint32_t q[4],
                                               uintptr_t gs, uintptr_t ge) {
    const uintptr_t w = reinterpret_cast<uintptr_t>(a);
    if (w >= gs && w + 16 <= ge) {
        *reinterpret_cast<uint4*>(a) = make_uint4(q[0], q[1], q[2], q[3]);
        return;
    }
    const int lo = w >= gs ? 0 : (int)(gs - w);
    const int hi = w + 16 <= ge ? 16 : (int)(ge - w);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
        if (lo <= 4 * m && 4 * m + 4 <= hi) {
            *reinterpret_cast<uint32_t*>(a + 4 * m) = q[m];
        } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int at = 4 * m + i;
                if (at >= lo && at < hi) a[at] = (uint8_t)(q[m] >> (8 * i));
            }
        }
    }
}

// The 16 bytes that start `shift` bits (0, 8, 16 or 24) into the aligned
// 32-bit word src[0] of shared memory: five word reads and a funnel shift.
__device__ __forceinline__ void dpt_funnel_read16(const uint32_t* src, int shift,
                                                  uint32_t q[4]) {
    uint32_t u[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) u[i] = src[i];
#pragma unroll
    for (int m = 0; m < 4; ++m) q[m] = __funnelshift_r(u[m], u[m + 1], shift);
}
