// The palette search of one working value, shared by the scan K2 / K8
// (ed_scan.cu) and the search probe T2 (search_probe.cu), so that the
// probe times the scan's own search.
#pragma once

#include <cuda_runtime.h>

// The search over the block's slice of len colours, packed from index 0
// in shared memory: (r, g, b) 12 bytes a colour for the exact search,
// (r, g, b, n) 16 bytes for the score search. Returns the slice-local
// index of the first strict minimum of the distance (strict <), or of the
// first strict maximum of the score (strict >), and its key: the distance,
// or the negated score, so that the merge of slices keeps a minimum either
// way (negation is exact).
template <bool SCORE>
__device__ __forceinline__ int dpt_palette_search(const float* sp, int len,
                                                  float cur0, float cur1,
                                                  float cur2, float& key) {
    int best_i = 0;
    float best = 0.f;
    if (SCORE) {
        const float4* sp4 = reinterpret_cast<const float4*>(sp);
        for (int i = 0; i < len; ++i) {
            const float4 c = sp4[i];
            const float score = __fadd_rn(
                __fadd_rn(__fadd_rn(__fmul_rn(c.x, cur0), __fmul_rn(c.y, cur1)),
                          __fmul_rn(c.z, cur2)),
                c.w);
            if (i == 0 || score > best) {
                best = score;
                best_i = i;
            }
        }
        key = -best;
    } else {
        for (int i = 0; i < len; ++i) {
            const float dr = __fsub_rn(cur0, sp[3 * i]);
            const float dg = __fsub_rn(cur1, sp[3 * i + 1]);
            const float db = __fsub_rn(cur2, sp[3 * i + 2]);
            const float dist = __fadd_rn(
                __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dg, dg)), __fmul_rn(db, db));
            if (i == 0 || dist < best) {
                best = dist;
                best_i = i;
            }
        }
        key = best;
    }
    return best_i;
}
