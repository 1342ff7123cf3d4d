// Native P3 PPM writer — the IO-runtime counterpart of the reference's
// C++ writer (src/main.cpp:658-689). Byte-identical to io/ppm.py:
// header "P3\nW H\n255", rows emitted h = H-1 .. 0, channels clamped to
// 1.0 then scaled by 255 and truncated, one "r g b\n" triplet per line
// (triplets joined by '\n', trailing newline).
//
// The Python writer string-formats ~W*H lines per frame (~10 s host time
// at 4K); this one hand-formats into a buffered stream at memory speed.
// Bound via ctypes (io/native_ppm.py) with the Python writer as the
// always-available fallback, parity-pinned by tests/test_ppm.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// Append 0..255 as decimal digits.
inline char *put_u8(char *p, int v) {
    if (v >= 100) {
        *p++ = static_cast<char>('0' + v / 100);
        *p++ = static_cast<char>('0' + (v / 10) % 10);
        *p++ = static_cast<char>('0' + v % 10);
    } else if (v >= 10) {
        *p++ = static_cast<char>('0' + v / 10);
        *p++ = static_cast<char>('0' + v % 10);
    } else {
        *p++ = static_cast<char>('0' + v);
    }
    return p;
}

}  // namespace

extern "C" {

// image: float32 [h][w][3], row h-1 written first (framebuffer order as
// io/ppm.py). Returns 0 on success, negative errno-style code otherwise.
int esc_write_ppm_p3(const char *path, const float *image, int w, int h) {
    FILE *fh = std::fopen(path, "wb");
    if (!fh) return -1;

    char header[64];
    int hl = std::snprintf(header, sizeof header, "P3\n%d %d\n255\n", w, h);
    if (std::fwrite(header, 1, static_cast<size_t>(hl), fh) !=
        static_cast<size_t>(hl)) {
        std::fclose(fh);
        return -2;
    }

    // Worst case per pixel: "255 255 255\n" = 12 bytes.
    std::vector<char> buf(static_cast<size_t>(w) * 12 + 16);
    for (int row = h - 1; row >= 0; --row) {
        const float *src = image + static_cast<size_t>(row) * w * 3;
        char *p = buf.data();
        for (int x = 0; x < w; ++x) {
            for (int c = 0; c < 3; ++c) {
                float f = src[x * 3 + c];
                if (f > 1.0f) f = 1.0f;
                int v = static_cast<int>(f * 255.0f);  // C truncation
                if (v < 0) v = 0;  // no negative colors occur (io/ppm.py)
                p = put_u8(p, v);
                *p++ = (c == 2) ? '\n' : ' ';
            }
        }
        if (row == 0) --p;  // the Python writer joins rows by '\n' ...
        size_t n = static_cast<size_t>(p - buf.data());
        if (std::fwrite(buf.data(), 1, n, fh) != n) {
            std::fclose(fh);
            return -3;
        }
    }
    // ... then appends one trailing '\n'.
    if (std::fputc('\n', fh) == EOF) {
        std::fclose(fh);
        return -4;
    }
    if (std::fclose(fh) != 0) return -5;
    return 0;
}

}  // extern "C"
