// Native RLE mask ops for COCO-style evaluation.
//
// Replaces the pycocotools C extension the reference depends on for
// CocoMetric (reference mmdet/evaluation/metrics/coco_metric.py:23; masks are
// RLE-encoded at coco_metric.py:364-367 and scored with COCOeval). Encoding is
// column-major (Fortran order) runs alternating 0s/1s starting with a 0-run,
// identical to pycocotools' `rleEncode`/`rleIou` semantics so AP numbers are
// comparable bit-for-bit.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// Encode a single H*W uint8 mask (row-major in memory, interpreted
// column-major like pycocotools). counts_out must hold >= h*w+1 entries.
// Returns the number of runs.
int rle_encode(const uint8_t* mask, int h, int w, uint32_t* counts_out) {
    int n = 0;
    uint32_t count = 0;
    uint8_t prev = 0;
    for (int c = 0; c < w; ++c) {
        for (int r = 0; r < h; ++r) {
            uint8_t v = mask[(size_t)r * w + c] ? 1 : 0;
            if (v != prev) {
                counts_out[n++] = count;
                count = 0;
                prev = v;
            }
            ++count;
        }
    }
    counts_out[n++] = count;
    return n;
}

// Decode runs back into a row-major uint8 mask.
void rle_decode(const uint32_t* counts, int n, int h, int w, uint8_t* mask_out) {
    std::memset(mask_out, 0, (size_t)h * w);
    uint8_t v = 0;
    size_t pos = 0;
    for (int i = 0; i < n; ++i) {
        for (uint32_t k = 0; k < counts[i]; ++k, ++pos) {
            if (v) {
                size_t c = pos / h, r = pos % h;
                mask_out[r * w + c] = 1;
            }
        }
        v = 1 - v;
    }
}

uint64_t rle_area(const uint32_t* counts, int n) {
    uint64_t a = 0;
    for (int i = 1; i < n; i += 2) a += counts[i];
    return a;
}

// Intersection area of two RLEs (same h*w extent) by run-walking.
static uint64_t rle_intersect_area(const uint32_t* ca, int na,
                                   const uint32_t* cb, int nb) {
    uint64_t inter = 0;
    size_t ia = 0, ib = 0;          // run indices
    uint64_t ea = ca[0], eb = cb[0]; // end position of current run
    uint8_t va = 0, vb = 0;          // current run values
    uint64_t pos = 0;
    while (ia < (size_t)na && ib < (size_t)nb) {
        uint64_t end = std::min(ea, eb);
        if (va && vb) inter += end - pos;
        pos = end;
        if (ea == end) { ++ia; if (ia < (size_t)na) ea += ca[ia]; va = 1 - va; }
        if (eb == end) { ++ib; if (ib < (size_t)nb) eb += cb[ib]; vb = 1 - vb; }
    }
    return inter;
}

// IoU matrix between D det RLEs and G gt RLEs.
// counts are packed: det_counts concatenated, det_offsets[i]..det_offsets[i+1].
// iscrowd: per-gt flag -> IoF (intersection over det area) like pycocotools.
void rle_iou_matrix(
    const uint32_t* det_counts, const int64_t* det_offsets, int n_det,
    const uint32_t* gt_counts, const int64_t* gt_offsets, int n_gt,
    const uint8_t* iscrowd, double* iou_out) {
    std::vector<uint64_t> det_areas(n_det), gt_areas(n_gt);
    for (int i = 0; i < n_det; ++i)
        det_areas[i] = rle_area(det_counts + det_offsets[i],
                                (int)(det_offsets[i + 1] - det_offsets[i]));
    for (int j = 0; j < n_gt; ++j)
        gt_areas[j] = rle_area(gt_counts + gt_offsets[j],
                               (int)(gt_offsets[j + 1] - gt_offsets[j]));
    for (int i = 0; i < n_det; ++i) {
        for (int j = 0; j < n_gt; ++j) {
            uint64_t inter = rle_intersect_area(
                det_counts + det_offsets[i],
                (int)(det_offsets[i + 1] - det_offsets[i]),
                gt_counts + gt_offsets[j],
                (int)(gt_offsets[j + 1] - gt_offsets[j]));
            double denom = iscrowd && iscrowd[j]
                               ? (double)det_areas[i]
                               : (double)(det_areas[i] + gt_areas[j] - inter);
            iou_out[(size_t)i * n_gt + j] = denom > 0 ? (double)inter / denom : 0.0;
        }
    }
}

// Batch-encode N masks (N, H, W) row-major; counts packed into counts_out with
// offsets_out (size N+1). counts_out must hold >= n*(h*w+1).
void rle_encode_batch(const uint8_t* masks, int n, int h, int w,
                      uint32_t* counts_out, int64_t* offsets_out) {
    int64_t off = 0;
    offsets_out[0] = 0;
    for (int i = 0; i < n; ++i) {
        int nr = rle_encode(masks + (size_t)i * h * w, h, w, counts_out + off);
        off += nr;
        offsets_out[i + 1] = off;
    }
}

// Greedy score-ordered COCO matching for one image & class (the inner loop
// pycocotools runs in C; reference COCOeval.evaluateImg). ious is D x G
// row-major with dets already score-descending and gts non-ignored-first.
// Outputs: dtm (T x D) matched gt index or -1; dtig (T x D) det-ignore flag.
void match_image(const double* ious, int d, int g,
                 const uint8_t* gt_ignore, const uint8_t* gt_crowd,
                 const double* iou_thrs, int t,
                 int64_t* dtm_out, uint8_t* dtig_out) {
    std::vector<int64_t> gtm((size_t)g);
    for (int ti = 0; ti < t; ++ti) {
        std::fill(gtm.begin(), gtm.end(), (int64_t)-1);
        for (int di = 0; di < d; ++di) {
            double best = std::min(iou_thrs[ti], 1.0 - 1e-10);
            int m = -1;
            for (int gi = 0; gi < g; ++gi) {
                if (gtm[gi] >= 0 && !gt_crowd[gi]) continue;
                // gts sorted: once matched to a non-ignored gt, an ignored
                // one cannot improve the match
                if (m > -1 && !gt_ignore[m] && gt_ignore[gi]) break;
                double iou = ious[(size_t)di * g + gi];
                if (iou < best) continue;
                best = iou;
                m = gi;
            }
            dtm_out[(size_t)ti * d + di] = m;
            dtig_out[(size_t)ti * d + di] = (m >= 0) ? gt_ignore[m] : 0;
            if (m >= 0) gtm[m] = di;
        }
    }
}

}  // extern "C"
