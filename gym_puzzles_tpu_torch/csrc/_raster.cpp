// Native rasterizer core of the host-side renderer (render/raster.py).
//
// A copy of the JAX package's render/_raster.cpp, the functions unchanged:
// convex polygon fill, discs, rings and thick lines over uint8 RGB buffers,
// the GL-free stand-in for the reference's pyglet/OpenGL drawing
// (multi_robot_puzzle_00.py:534).  render/_raster_cpp.py builds it with g++
// at first use into gym_puzzles_tpu_torch/_build/ and binds it with ctypes;
// the numpy functions of raster.py are its plain version.

#include <cstdint>
#include <cmath>
#include <algorithm>

extern "C" {

// img: h*w*3 uint8, row-major, y-down.  verts: n*(x,y) float pixels, CCW in
// image coordinates.
void gpt_fill_polygon(uint8_t* img, int h, int w,
                      const float* verts, int n,
                      uint8_t cr, uint8_t cg, uint8_t cb) {
    float minx = 1e30f, maxx = -1e30f, miny = 1e30f, maxy = -1e30f;
    for (int i = 0; i < n; ++i) {
        minx = std::min(minx, verts[2 * i]);
        maxx = std::max(maxx, verts[2 * i]);
        miny = std::min(miny, verts[2 * i + 1]);
        maxy = std::max(maxy, verts[2 * i + 1]);
    }
    int x0 = std::max((int)std::floor(minx), 0);
    int x1 = std::min((int)std::ceil(maxx) + 1, w);
    int y0 = std::max((int)std::floor(miny), 0);
    int y1 = std::min((int)std::ceil(maxy) + 1, h);
    for (int y = y0; y < y1; ++y) {
        float py = y + 0.5f;
        for (int x = x0; x < x1; ++x) {
            float px = x + 0.5f;
            bool inside = true;
            for (int i = 0; i < n && inside; ++i) {
                float ax = verts[2 * i], ay = verts[2 * i + 1];
                float bx = verts[2 * ((i + 1) % n)], by = verts[2 * ((i + 1) % n) + 1];
                if ((bx - ax) * (py - ay) - (by - ay) * (px - ax) < 0.0f)
                    inside = false;
            }
            if (inside) {
                uint8_t* p = img + 3 * (y * w + x);
                p[0] = cr; p[1] = cg; p[2] = cb;
            }
        }
    }
}

void gpt_fill_circle(uint8_t* img, int h, int w,
                     float cx, float cy, float rad,
                     uint8_t cr, uint8_t cg, uint8_t cb,
                     int filled, float thickness) {
    float reach = rad + (filled ? 0.0f : thickness);
    int x0 = std::max((int)std::floor(cx - reach), 0);
    int x1 = std::min((int)std::ceil(cx + reach) + 1, w);
    int y0 = std::max((int)std::floor(cy - reach), 0);
    int y1 = std::min((int)std::ceil(cy + reach) + 1, h);
    float r_out2 = filled ? rad * rad : (rad + thickness) * (rad + thickness);
    float r_in2 = filled ? -1.0f : (rad - thickness) * (rad - thickness);
    for (int y = y0; y < y1; ++y) {
        float dy = y + 0.5f - cy;
        for (int x = x0; x < x1; ++x) {
            float dx = x + 0.5f - cx;
            float d2 = dx * dx + dy * dy;
            if (d2 <= r_out2 && d2 >= r_in2) {
                uint8_t* p = img + 3 * (y * w + x);
                p[0] = cr; p[1] = cg; p[2] = cb;
            }
        }
    }
}

void gpt_draw_line(uint8_t* img, int h, int w,
                   float ax, float ay, float bx, float by,
                   uint8_t cr, uint8_t cg, uint8_t cb, float thickness) {
    int x0 = std::max((int)std::floor(std::min(ax, bx) - thickness), 0);
    int x1 = std::min((int)std::ceil(std::max(ax, bx) + thickness) + 1, w);
    int y0 = std::max((int)std::floor(std::min(ay, by) - thickness), 0);
    int y1 = std::min((int)std::ceil(std::max(ay, by) + thickness) + 1, h);
    float ux = bx - ax, uy = by - ay;
    float denom = ux * ux + uy * uy + 1e-12f;
    float t2 = thickness * thickness;
    for (int y = y0; y < y1; ++y) {
        float py = y + 0.5f;
        for (int x = x0; x < x1; ++x) {
            float px = x + 0.5f;
            float t = ((px - ax) * ux + (py - ay) * uy) / denom;
            t = std::max(0.0f, std::min(1.0f, t));
            float dx = px - (ax + t * ux), dy = py - (ay + t * uy);
            if (dx * dx + dy * dy <= t2) {
                uint8_t* p = img + 3 * (y * w + x);
                p[0] = cr; p[1] = cg; p[2] = cb;
            }
        }
    }
}

}  // extern "C"
