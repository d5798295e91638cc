// Host-side data kernels of the PyTorch port: the polygon scanline fill
// and the colour -> class-id map, a copy of the two functions of
// csrc/pseg_native.cpp that the datasets run (OpenCV's cv2.fillPoly and the
// colour loop in the original datasets), OpenMP-parallel over rows.
//
// Built by pytorch_segmentation_tpu_torch/_native.py at first use:
//   g++ -O3 -shared -fPIC -fopenmp -std=c++17 pseg_native.cpp
// ABI: plain C functions, bound with ctypes. The numpy versions in
// data/rasterize.py and data/colormap.py are their plain versions.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Even-odd scanline polygon fill with boundary, matching cv2.fillPoly's
// pixel-center convention. pts: [n][2] float (x, y).
void fill_polygon(uint8_t* mask, int h, int w, const float* pts, int n,
                  uint8_t value) {
    if (n < 3) return;
    float ymin = pts[1], ymax = pts[1];
    for (int i = 1; i < n; ++i) {
        ymin = std::min(ymin, pts[2 * i + 1]);
        ymax = std::max(ymax, pts[2 * i + 1]);
    }
    int y0 = std::max(0, (int)std::floor(ymin));
    int y1 = std::min(h - 1, (int)std::ceil(ymax));

#pragma omp parallel for schedule(static) if (y1 - y0 > 64)
    for (int row = y0; row <= y1; ++row) {
        float xs[64];
        std::vector<float> xs_dyn;
        float* xbuf = xs;
        int nx = 0;
        bool use_dyn = n > 64;
        if (use_dyn) {
            xs_dyn.resize(n);
            xbuf = xs_dyn.data();
        }
        for (int i = 0; i < n; ++i) {
            float ax = pts[2 * i], ay = pts[2 * i + 1];
            int j = (i + 1) % n;
            float bx = pts[2 * j], by = pts[2 * j + 1];
            if ((ay <= row && by > row) || (by <= row && ay > row)) {
                xbuf[nx++] = ax + (row - ay) * (bx - ax) / (by - ay);
            }
        }
        std::sort(xbuf, xbuf + nx);
        for (int i = 0; i + 1 < nx; i += 2) {
            int a = std::max(0, (int)std::ceil(xbuf[i]));
            int b = std::min(w - 1, (int)std::floor(xbuf[i + 1]));
            if (a <= b) memset(mask + (size_t)row * w + a, value, b - a + 1);
        }
    }

    // boundary (cv2.fillPoly draws the outline)
    for (int i = 0; i < n; ++i) {
        float ax = pts[2 * i], ay = pts[2 * i + 1];
        int j = (i + 1) % n;
        float bx = pts[2 * j], by = pts[2 * j + 1];
        int steps = (int)std::max(std::fabs(bx - ax), std::fabs(by - ay)) + 1;
        for (int s = 0; s <= steps; ++s) {
            float t = (float)s / steps;
            int x = (int)std::lround(ax + t * (bx - ax));
            int y = (int)std::lround(ay + t * (by - ay));
            if (x >= 0 && x < w && y >= 0 && y < h)
                mask[(size_t)y * w + x] = value;
        }
    }
}

// BGR color image -> class-id mask via colormap table (first match wins in
// reverse order like the reference's sequential overwrite loop:
// later colormap entries overwrite earlier ones, so scan from the end).
void map_colors(const uint8_t* img, int h, int w, const uint8_t* colormap,
                int n_colors, uint8_t* out) {
#pragma omp parallel for schedule(static)
    for (int y = 0; y < h; ++y) {
        const uint8_t* row = img + (size_t)y * w * 3;
        uint8_t* orow = out + (size_t)y * w;
        for (int x = 0; x < w; ++x) {
            const uint8_t* p = row + 3 * x;
            uint8_t id = 0;
            for (int c = n_colors - 1; c >= 0; --c) {
                const uint8_t* cc = colormap + 3 * c;
                if (p[0] == cc[0] && p[1] == cc[1] && p[2] == cc[2]) {
                    id = (uint8_t)c;
                    break;
                }
            }
            orow[x] = id;
        }
    }
}

}  // extern "C"
