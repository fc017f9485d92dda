// Connected components and outer-border following for the port's WHU
// converter (data/contours.py), as OpenCV 5.0 computes them.
//
// cc_label8: 8-connected components of a binary image with their stats, as
// cv2.connectedComponentsWithStats(mask, connectivity=8). OpenCV's 8-way
// labeller scans the image in 2 x 2 blocks, two rows at a time, so its
// final labels follow each component's first block in raster order of
// blocks (the least (y / 2, x / 2) of its pixels), not its first pixel.
// Two components never share a block (any two pixels of a block touch), so
// labels are handed out by a scan over blocks in that order after a
// union-find pass has joined the components. Label 0 is the background.
//
// cc_trace_outer: Suzuki and Abe's outer-border following from a
// component's first pixel in raster order, with CHAIN_APPROX_SIMPLE's
// output, as OpenCV's icvFetchContour runs it under RETR_EXTERNAL: the
// first neighbour is looked for clockwise from the left one, each next
// pixel counterclockwise from the one before, a point is written where the
// direction changes, and the walk ends on coming back to the start along
// its first step. Pixels outside the image count as background (OpenCV
// pads the image by one pixel), so a component on the edge is walked along
// it.
//
// Plain C ABI for ctypes; no state is shared between calls.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

int32_t find(std::vector<int32_t>& parent, int32_t a) {
    while (parent[a] != a) {
        parent[a] = parent[parent[a]];
        a = parent[a];
    }
    return a;
}

void join(std::vector<int32_t>& parent, int32_t a, int32_t b) {
    a = find(parent, a);
    b = find(parent, b);
    if (a != b) parent[std::max(a, b)] = std::min(a, b);
}

// icvCodeDeltas: 0 right, 1 up-right, 2 up, 3 up-left, 4 left, 5 down-left,
// 6 down, 7 down-right
const int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};

}  // namespace

extern "C" {

// mask: h x w bytes, nonzero is foreground. Writes labels (h x w int32),
// stats (n x 5 int32: x, y, w, h, area), sums (n x 2 int64: the sums of x
// and of y) and first (n int64: each label's first pixel y * w + x in
// raster order) for the n labels, background included, and returns n.
// ``cap`` bounds n: (h + 1) / 2 * ((w + 1) / 2) + 1 always suffices.
int64_t cc_label8(const uint8_t* mask, int h, int w, int32_t* labels, int32_t* stats,
                  int64_t* sums, int64_t* first, int64_t cap) {
    const int64_t n = (int64_t)h * w;
    std::vector<int32_t> parent;
    parent.reserve(1024);
    std::vector<int32_t> prov(n, -1);  // provisional label a pixel, -1 background
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            int64_t i = (int64_t)y * w + x;
            if (!mask[i]) continue;
            int32_t l = -1;
            const int nb[4][2] = {{-1, -1}, {0, -1}, {1, -1}, {-1, 0}};  // (dx, dy) seen before
            for (const auto& d : nb) {
                int xx = x + d[0], yy = y + d[1];
                if (xx < 0 || xx >= w || yy < 0) continue;
                int32_t m = prov[(int64_t)yy * w + xx];
                if (m < 0) continue;
                if (l < 0) l = m;
                else join(parent, l, m);
            }
            if (l < 0) {
                l = (int32_t)parent.size();
                parent.push_back(l);
            }
            prov[i] = l;
        }
    }
    std::vector<int32_t> final_label(parent.size(), 0);
    int32_t next = 1;
    for (int by = 0; by < h; by += 2) {
        for (int bx = 0; bx < w; bx += 2) {
            for (int dy = 0; dy < 2 && by + dy < h; ++dy) {
                for (int dx = 0; dx < 2 && bx + dx < w; ++dx) {
                    int32_t p = prov[(int64_t)(by + dy) * w + bx + dx];
                    if (p < 0) continue;
                    int32_t r = find(parent, p);
                    if (final_label[r] == 0) {
                        if (next >= cap) return -1;
                        final_label[r] = next++;
                    }
                }
            }
        }
    }
    for (int64_t l = 0; l < next; ++l) {
        stats[5 * l + 0] = INT32_MAX;  // x
        stats[5 * l + 1] = INT32_MAX;  // y
        stats[5 * l + 2] = -1;         // right, until the end
        stats[5 * l + 3] = -1;         // bottom, until the end
        stats[5 * l + 4] = 0;
        sums[2 * l] = sums[2 * l + 1] = 0;
        first[l] = -1;
    }
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            int64_t i = (int64_t)y * w + x;
            int32_t l = prov[i] < 0 ? 0 : final_label[find(parent, prov[i])];
            labels[i] = l;
            int32_t* s = stats + 5 * (int64_t)l;
            s[0] = std::min(s[0], x);
            s[1] = std::min(s[1], y);
            s[2] = std::max(s[2], x);
            s[3] = std::max(s[3], y);
            s[4] += 1;
            sums[2 * l] += x;
            sums[2 * l + 1] += y;
            if (first[l] < 0) first[l] = i;
        }
    }
    for (int64_t l = 0; l < next; ++l) {
        int32_t* s = stats + 5 * l;
        if (s[4] == 0) {  // no background pixel: OpenCV's values for an empty label
            s[0] = -1;
            s[1] = INT32_MAX;
            s[2] = s[3] = 0;
            continue;
        }
        s[2] = s[2] - s[0] + 1;
        s[3] = s[3] - s[1] + 1;
    }
    return next;
}

// Follows the outer border of the component whose first pixel in raster
// order is (x0, y0). Writes up to ``cap`` points as (x, y) int32 pairs to
// ``pts`` and returns their count (more than ``cap``: call again with room).
int64_t cc_trace_outer(const uint8_t* mask, int h, int w, int x0, int y0, int32_t* pts,
                       int64_t cap) {
    auto on = [&](int x, int y) {
        return x >= 0 && x < w && y >= 0 && y < h && mask[(int64_t)y * w + x] != 0;
    };
    int64_t count = 0;
    auto put = [&](int x, int y) {
        if (count < cap) {
            pts[2 * count] = x;
            pts[2 * count + 1] = y;
        }
        ++count;
    };
    int s = 4, s_end = 4;
    do {
        s = (s - 1) & 7;
    } while (!on(x0 + kDx[s], y0 + kDy[s]) && s != s_end);
    if (s == s_end) {  // a single pixel
        put(x0, y0);
        return count;
    }
    const int x1 = x0 + kDx[s], y1 = y0 + kDy[s];
    int x3 = x0, y3 = y0, prev_s = s ^ 4;
    for (;;) {
        s_end = s;
        int x4 = x3, y4 = y3;
        while (s < 15) {
            ++s;
            x4 = x3 + kDx[s & 7];
            y4 = y3 + kDy[s & 7];
            if (on(x4, y4)) break;
        }
        s &= 7;
        if (s != prev_s) {
            put(x3, y3);
            prev_s = s;
        }
        if (x4 == x0 && y4 == y0 && x3 == x1 && y3 == y1) break;
        x3 = x4;
        y3 = y4;
        s = (s + 4) & 7;
    }
    return count;
}

}  // extern "C"
