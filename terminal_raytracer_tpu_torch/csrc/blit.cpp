// ANSI terminal blitter — the host-side hot loop.
//
// The reference encodes every frame's ANSI escape stream on the CPU with a
// rayon-parallel row loop (reference: src/lib.rs:499-532, ~20 bytes/cell,
// 80k cells at 400x200). This is its native equivalent: C++ with manual
// integer formatting, row-parallel over std::thread, loaded from Python via
// ctypes (runtime/blit.py). A frame at 400x200 truecolor (~1.9 MB of ANSI)
// encodes in well under a millisecond.
//
// Cell formats (matching lib.rs:509-524 byte-for-byte):
//   full-color: "\x1b[38;2;R;G;Bm\xE2\x96\x88\x1b[0m"   (the UTF-8 block)
//   ascii:      "\x1b[38;2;R;G;Bm<glyph>\x1b[0m"
// Rows end with "\r\n" (raw-mode terminal, lib.rs:527).
//
// Build: g++ -O3 -march=native -shared -fPIC blit.cpp -o blit.so

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// The 68-glyph luminance ramp (lib.rs:521); indexed by the device-computed
// glyph id so host and device never disagree about the ramp.
const char kRamp[69] = " .`^\",:;Il!i><~+_-?][}{1)(|\\tfjrxnuvczXYUJCLQ0OZmwqpdbkhao*#MW&8%B@$";

// Fastest path for 0..255: precomputed decimal strings.
struct Dec3 {
  char s[4];
  uint8_t len;
};
struct Dec3Table {
  Dec3 t[256];
  Dec3Table() {
    for (int i = 0; i < 256; i++) {
      int n = 0;
      if (i >= 100) t[i].s[n++] = '0' + i / 100;
      if (i >= 10) t[i].s[n++] = '0' + (i / 10) % 10;
      t[i].s[n++] = '0' + i % 10;
      t[i].s[n] = 0;
      t[i].len = n;
    }
  }
};
const Dec3Table kDec;

inline char* put(char* p, const char* s, size_t n) {
  std::memcpy(p, s, n);
  return p + n;
}

inline char* put_dec(char* p, uint8_t v) {
  const Dec3& d = kDec.t[v];
  std::memcpy(p, d.s, d.len);
  return p + d.len;
}

// Encode one row. Returns bytes written.
size_t encode_row(const uint8_t* rgb, const uint8_t* glyphs, int w,
                  int full_color, char* out) {
  char* p = out;
  for (int i = 0; i < w; i++) {
    const uint8_t r = rgb[i * 3], g = rgb[i * 3 + 1], b = rgb[i * 3 + 2];
    p = put(p, "\x1b[38;2;", 7);
    p = put_dec(p, r);
    *p++ = ';';
    p = put_dec(p, g);
    *p++ = ';';
    p = put_dec(p, b);
    *p++ = 'm';
    if (full_color) {
      p = put(p, "\xE2\x96\x88", 3);  // U+2588 FULL BLOCK
    } else {
      *p++ = kRamp[glyphs[i] > 67 ? 67 : glyphs[i]];
    }
    p = put(p, "\x1b[0m", 4);
  }
  *p++ = '\r';
  *p++ = '\n';
  return size_t(p - out);
}

}  // namespace

extern "C" {

// Max bytes one cell can need (prefix 7 + 3*3 digits + 2 ';' + 'm' + 3 glyph
// + 4 reset = 26) — callers size buffers with this.
long trt_max_row_bytes(int w) { return 26L * w + 2; }

// Encode a full frame into `out` (capacity `cap`). Returns bytes written,
// or -1 if cap is too small. `n_threads` <= 1 means single-threaded.
long trt_blit(const uint8_t* rgb, const uint8_t* glyphs, int h, int w,
              int full_color, int n_threads, char* out, long cap) {
  const long stride = trt_max_row_bytes(w);
  if (cap < stride * h) return -1;

  std::vector<size_t> lens(h);
  if (n_threads <= 1 || h < 8) {
    char* p = out;
    for (int y = 0; y < h; y++) {
      p += encode_row(rgb + size_t(y) * w * 3, glyphs + size_t(y) * w, w,
                      full_color, p);
    }
    return long(p - out);
  }

  // Parallel: each row encodes into its fixed-stride slot, then rows are
  // compacted in place (sequential memmove; ~GB/s, negligible).
  if (n_threads > h) n_threads = h;
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      for (int y = t; y < h; y += n_threads) {
        lens[y] = encode_row(rgb + size_t(y) * w * 3, glyphs + size_t(y) * w,
                             w, full_color, out + stride * y);
      }
    });
  }
  for (auto& th : threads) th.join();

  char* p = out + lens[0];
  for (int y = 1; y < h; y++) {
    std::memmove(p, out + stride * y, lens[y]);
    p += lens[y];
  }
  return long(p - out);
}

}  // extern "C"
