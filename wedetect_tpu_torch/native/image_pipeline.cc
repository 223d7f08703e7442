// Native host image pipeline: the keep-ratio resize + letterbox of a
// decoded JPEG, and the header facts that drive it (frame size, EXIF
// orientation, the fast path's DCT scale). A copy of the resampling,
// letterbox and EXIF code of wedetect_tpu/native/image_pipeline.cc,
// built on its own.
//
// The JPEG itself is decoded by the caller with cv2.imdecode, whose
// bundled libjpeg-turbo is the library the JAX package links (the same
// IDCT, chroma upsampling and colour conversion, so the same pixels),
// and which ships with cv2 on every host; fast=True decodes there at
// libjpeg's DCT scale 1/2, 1/4 or 1/8 (cv2.IMREAD_REDUCED_COLOR_*), as
// the JAX package's fast path does. cv2 decodes with its EXIF handling
// off; the orientation is this file's.
//
// Serves every JPEG path of the port's host loaders:
// data/loader.eval_sample (EvalLoader), models/api.Detector.__call__
// and data/wds (plain decode), in place of cv2.imread +
// ops/letterbox.preprocess_image. Semantics mirror the reference test
// pipeline (wedetect/datasets/transformers/transforms.py:94-124,
// 180-275):
//   - keep-ratio resize by r = min(t/max, t/min): AREA when
//     downscaling, BILINEAR when upscaling,
//   - second-stage bilinear to the rounded letter size,
//   - center pad with 114, top = round(pad_h//2 - 0.1).
// Resampling uses float accumulation; cv2's fixed-point kernels may
// differ by +-1 LSB per pixel (the arithmetic outputs sf/pad/ori are
// exact). The port builds without -march=native, so where the JAX
// package's build contracts a multiply-add to an FMA this one rounds
// twice: a pixel may differ from that build's by 1 LSB.
//
// Threading stays in Python: ctypes and cv2 release the GIL, so a
// ThreadPoolExecutor over these calls decodes in parallel.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// EXIF orientation (1-8) from the JPEG APP1 segment; 1 when absent
// or unparseable. cv2.imread applies this tag, so the native decoder
// must too — otherwise phone photos come out rotated.
int exif_orientation(const uint8_t* buf, size_t len) {
  if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return 1;
  size_t i = 2;
  while (i + 4 <= len) {
    if (buf[i] != 0xFF) return 1;
    uint8_t m = buf[i + 1];
    if (m == 0xFF) {  // legal fill byte before a marker
      i += 1;
      continue;
    }
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      i += 2;
      continue;
    }
    if (m == 0xDA) return 1;  // start of scan: no APP1 seen
    size_t seglen = (size_t(buf[i + 2]) << 8) | buf[i + 3];
    if (seglen < 2 || i + 2 + seglen > len) return 1;
    if (m == 0xE1 && seglen >= 16
        && !std::memcmp(buf + i + 4, "Exif\0\0", 6)) {
      const uint8_t* t = buf + i + 10;  // TIFF header
      size_t tlen = seglen - 8;
      bool le;
      if (t[0] == 'I' && t[1] == 'I') le = true;
      else if (t[0] == 'M' && t[1] == 'M') le = false;
      else return 1;
      auto rd16 = [&](size_t o) -> uint32_t {
        return le ? (t[o] | (uint32_t(t[o + 1]) << 8))
                  : ((uint32_t(t[o]) << 8) | t[o + 1]);
      };
      auto rd32 = [&](size_t o) -> uint32_t {
        return le ? (t[o] | (uint32_t(t[o + 1]) << 8)
                     | (uint32_t(t[o + 2]) << 16)
                     | (uint32_t(t[o + 3]) << 24))
                  : ((uint32_t(t[o]) << 24) | (uint32_t(t[o + 1]) << 16)
                     | (uint32_t(t[o + 2]) << 8) | t[o + 3]);
      };
      if (tlen < 8) return 1;
      uint32_t ifd = rd32(4);
      // 64-bit compare: a crafted ifd near UINT32_MAX must not wrap
      if (size_t(ifd) + 2 > tlen) return 1;
      uint32_t n = rd16(ifd);
      for (uint32_t e = 0; e < n; ++e) {
        size_t off = size_t(ifd) + 2 + size_t(e) * 12;
        if (off + 12 > tlen) return 1;
        if (rd16(off) == 0x0112) {
          uint32_t v = rd16(off + 8);
          return (v >= 1 && v <= 8) ? int(v) : 1;
        }
      }
      return 1;
    }
    i += 2 + seglen;
  }
  return 1;
}

// The frame's (h, w) from its SOF segment, before orientation: 0, or 1
// for bytes the decoder does not take (no JPEG, no frame before the
// scan, a height of 0). Only the frames libjpeg 6.2 decodes to RGB are
// taken: 8-bit baseline, extended or progressive (SOF0-2, SOF9-10),
// with 1 or 3 components; a lossless, 12-bit or CMYK file is rejected
// and the caller decodes it with cv2 + preprocess_image, as the JAX
// package does with every file its libjpeg rejects.
int jpeg_frame(const uint8_t* buf, size_t len, int* h, int* w) {
  if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return 1;
  size_t i = 2;
  while (i + 4 <= len) {
    if (buf[i] != 0xFF) return 1;
    uint8_t m = buf[i + 1];
    if (m == 0xFF) {  // legal fill byte before a marker
      i += 1;
      continue;
    }
    if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      i += 2;
      continue;
    }
    if (m == 0xD8 || m == 0xD9 || m == 0xDA) return 1;  // no frame first
    size_t seglen = (size_t(buf[i + 2]) << 8) | buf[i + 3];
    if (seglen < 2 || i + 2 + seglen > len) return 1;
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      const uint8_t* s = buf + i + 4;
      if (seglen < 8) return 1;
      int nc = s[5];
      bool taken = m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC9
                   || m == 0xCA;
      if (!taken || s[0] != 8 || (nc != 1 && nc != 3)
          || seglen != size_t(8 + 3 * nc))
        return 1;
      *h = (s[1] << 8) | s[2];
      *w = (s[3] << 8) | s[4];
      return *h > 0 && *w > 0 ? 0 : 1;
    }
    i += 2 + seglen;
  }
  return 1;
}

// Copy an interleaved 3-channel image upright (same convention as
// cv2.imread: orientation 6 -> rotate 90 CW, 8 -> 90 CCW, 3 -> 180,
// 2/4/5/7 mirrored variants), swapping channels 0 and 2 (cv2's BGR to
// RGB) when `swap_rb`. dst holds h*w*3 bytes; its shape is (w, h) for
// orient >= 5.
void upright(const uint8_t* src, int H, int W, int orient, bool swap_rb,
             uint8_t* dst) {
  const int r = swap_rb ? 2 : 0, b = 2 - r;
  bool swap = orient >= 5;
  int oh = swap ? W : H, ow = swap ? H : W;
  for (int y = 0; y < oh; ++y) {
    uint8_t* d = dst + size_t(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      int sy, sx;
      switch (orient) {
        case 2: sy = y; sx = W - 1 - x; break;          // mirror H
        case 3: sy = H - 1 - y; sx = W - 1 - x; break;  // 180
        case 4: sy = H - 1 - y; sx = x; break;          // mirror V
        case 5: sy = x; sx = y; break;                  // transpose
        case 6: sy = H - 1 - x; sx = y; break;          // 90 CW
        case 7: sy = H - 1 - x; sx = W - 1 - y; break;  // transverse
        case 8: sy = x; sx = W - 1 - y; break;          // 90 CCW
        default: sy = y; sx = x; break;                 // 1: upright
      }
      const uint8_t* s = src + (size_t(sy) * W + sx) * 3;
      d[x * 3] = s[r];
      d[x * 3 + 1] = s[1];
      d[x * 3 + 2] = s[b];
    }
  }
}

// Bilinear resize (pixel-center alignment, float weights, RGB u8).
void resize_bilinear(const uint8_t* src, int h, int w, uint8_t* dst,
                     int nh, int nw) {
  const double sy = double(h) / nh, sx = double(w) / nw;
  std::vector<int> x0(nw), x1(nw);
  std::vector<float> fx(nw);
  for (int x = 0; x < nw; ++x) {
    double s = (x + 0.5) * sx - 0.5;
    int i = int(std::floor(s));
    double f = s - i;
    if (i < 0) { i = 0; f = 0.0; }
    if (i >= w - 1) { i = w - 2 >= 0 ? w - 2 : 0; f = w > 1 ? 1.0 : 0.0; }
    x0[x] = i; x1[x] = w > 1 ? i + 1 : i; fx[x] = float(f);
  }
  for (int y = 0; y < nh; ++y) {
    double s = (y + 0.5) * sy - 0.5;
    int j = int(std::floor(s));
    double f = s - j;
    if (j < 0) { j = 0; f = 0.0; }
    if (j >= h - 1) { j = h - 2 >= 0 ? h - 2 : 0; f = h > 1 ? 1.0 : 0.0; }
    int j1 = h > 1 ? j + 1 : j;
    const uint8_t* r0 = src + size_t(j) * w * 3;
    const uint8_t* r1 = src + size_t(j1) * w * 3;
    uint8_t* d = dst + size_t(y) * nw * 3;
    float fy = float(f);
    for (int x = 0; x < nw; ++x) {
      const uint8_t* a = r0 + x0[x] * 3;
      const uint8_t* b = r0 + x1[x] * 3;
      const uint8_t* c = r1 + x0[x] * 3;
      const uint8_t* e = r1 + x1[x] * 3;
      float wx = fx[x];
      for (int ch = 0; ch < 3; ++ch) {
        float top = a[ch] + (b[ch] - a[ch]) * wx;
        float bot = c[ch] + (e[ch] - c[ch]) * wx;
        float v = top + (bot - top) * fy;
        d[x * 3 + ch] = uint8_t(std::lround(std::min(255.f,
                                                     std::max(0.f, v))));
      }
    }
  }
}

// Integer-ratio area downscale: plain ky x kx box average (u32
// accumulate, no per-pixel weight tables). Exactly the generic path's
// result for integer ratios, ~4x faster.
void resize_area_int(const uint8_t* src, int h, int w, uint8_t* dst,
                     int nh, int nw, int ky, int kx) {
  const uint32_t area = uint32_t(ky) * kx;
  const uint32_t half = area / 2;
  for (int y = 0; y < nh; ++y) {
    uint8_t* d = dst + size_t(y) * nw * 3;
    const uint8_t* base = src + size_t(y) * ky * w * 3;
    for (int x = 0; x < nw; ++x) {
      uint32_t r = 0, g = 0, b = 0;
      const uint8_t* p0 = base + size_t(x) * kx * 3;
      for (int j = 0; j < ky; ++j) {
        const uint8_t* p = p0 + size_t(j) * w * 3;
        for (int i = 0; i < kx; ++i) {
          r += p[i * 3];
          g += p[i * 3 + 1];
          b += p[i * 3 + 2];
        }
      }
      d[x * 3] = uint8_t((r + half) / area);
      d[x * 3 + 1] = uint8_t((g + half) / area);
      d[x * 3 + 2] = uint8_t((b + half) / area);
    }
  }
}

// Area resize for downscale (contribution-weighted average like
// cv2.INTER_AREA's generic path).
void resize_area(const uint8_t* src, int h, int w, uint8_t* dst,
                 int nh, int nw) {
  if (h % nh == 0 && w % nw == 0) {
    resize_area_int(src, h, w, dst, nh, nw, h / nh, w / nw);
    return;
  }
  const double sy = double(h) / nh, sx = double(w) / nw;
  // per-output-column source spans and weights
  struct Span { int start; int n; };
  std::vector<Span> xs(nw);
  std::vector<std::vector<float>> xw(nw);
  for (int x = 0; x < nw; ++x) {
    double a = x * sx, b = (x + 1) * sx;
    int ia = int(std::floor(a)), ib = std::min(int(std::ceil(b)), w);
    xs[x].start = ia;
    xs[x].n = ib - ia;
    xw[x].resize(xs[x].n);
    for (int i = 0; i < xs[x].n; ++i) {
      double l = std::max(a, double(ia + i));
      double r = std::min(b, double(ia + i + 1));
      xw[x][i] = float(std::max(0.0, r - l) / sx);
    }
  }
  std::vector<float> acc(size_t(nw) * 3);
  for (int y = 0; y < nh; ++y) {
    double a = y * sy, b = (y + 1) * sy;
    int ja = int(std::floor(a)), jb = std::min(int(std::ceil(b)), h);
    uint8_t* d = dst + size_t(y) * nw * 3;
    std::fill(acc.begin(), acc.end(), 0.f);
    for (int j = ja; j < jb; ++j) {
      double l = std::max(a, double(j));
      double r = std::min(b, double(j + 1));
      float wy = float(std::max(0.0, r - l) / sy);
      const uint8_t* row = src + size_t(j) * w * 3;
      for (int x = 0; x < nw; ++x) {
        const auto& wx = xw[x];
        const uint8_t* p = row + xs[x].start * 3;
        float r0 = 0.f, g0 = 0.f, b0 = 0.f;
        for (int i = 0; i < xs[x].n; ++i) {
          float f = wx[i];
          r0 += f * p[i * 3];
          g0 += f * p[i * 3 + 1];
          b0 += f * p[i * 3 + 2];
        }
        acc[x * 3] += wy * r0;
        acc[x * 3 + 1] += wy * g0;
        acc[x * 3 + 2] += wy * b0;
      }
    }
    for (int x = 0; x < nw * 3; ++x)
      d[x] = uint8_t(std::lround(std::min(255.f, std::max(0.f, acc[x]))));
  }
}

void resize_rgb(const uint8_t* src, int h, int w, uint8_t* dst,
                int nh, int nw) {
  if (nh < h || nw < w)
    resize_area(src, h, w, dst, nh, nw);
  else
    resize_bilinear(src, h, w, dst, nh, nw);
}

}  // namespace

extern "C" {

// Header facts: the frame's (h, w) before orientation and the EXIF
// orientation (1-8). 0, or 1 for bytes the decoder does not take.
int wd_jpeg_header(const uint8_t* buf, size_t len, int* h, int* w,
                   int* orient) {
  if (jpeg_frame(buf, len, h, w)) return 1;
  *orient = exif_orientation(buf, len);
  return 0;
}

// The fast path's DCT scale denominator for a frame (fh, fw) before
// orientation and a target (th, tw): the largest of 8, 4, 2 whose
// decode (ceil(f / d) a side) still covers the keep-ratio size, 1 when
// the keep-ratio target is not >= 2x smaller than the source. The
// remaining < 2x step uses the normal area kernel. This cuts decode
// time ~denom^2-fold on large inputs at the cost of a small, bounded
// numeric deviation vs the full-res path (the IDCT box low-pass vs
// area averaging of full-res pixels; pinned by
// tests/test_torch_native_image.py with tolerance).
int wd_decode_scale(int fh, int fw, int orient, int th, int tw) {
  // oriented full-res dims drive the keep-ratio math
  int oh = orient >= 5 ? fw : fh, ow = orient >= 5 ? fh : fw;
  double ratio = std::min(double(std::max(th, tw)) / std::max(oh, ow),
                          double(std::min(th, tw)) / std::min(oh, ow));
  if (ratio >= 1.0) return 1;
  int rh = int(oh * ratio), rw = int(ow * ratio);
  // pre-orientation targets for the decode-scale decision
  int trh = orient >= 5 ? rw : rh, trw = orient >= 5 ? rh : rw;
  for (int d : {8, 4, 2})
    if ((fh + d - 1) / d >= trh && (fw + d - 1) / d >= trw) return d;
  return 1;
}

// Keep-ratio + letterbox of a decoded BGR image (h, w) before
// orientation, decoded at full size or at a DCT scale of the frame
// (fh, fw): the scale/pad arithmetic is the full-size frame's either
// way. The resampling treats the channels alike, so it runs on BGR and
// the last copy writes RGB.
// out must hold th*tw*3 bytes. sf: (w_ratio, h_ratio); pad: (top,
// bottom, left, right); ori: (h, w).
void wd_letterbox(const uint8_t* bgr, int h, int w, int orient, int fh,
                  int fw, int th, int tw, int pad_val, uint8_t* out,
                  float* sf, float* pad, int* ori) {
  std::vector<uint8_t> img;
  const uint8_t* cur = bgr;
  if (orient > 1) {
    img.resize(size_t(h) * w * 3);
    upright(bgr, h, w, orient, false, img.data());
    cur = img.data();
    if (orient >= 5) std::swap(h, w);
  }
  // full-res oriented dims
  const int h0 = orient >= 5 ? fw : fh, w0 = orient >= 5 ? fh : fw;
  ori[0] = h0;
  ori[1] = w0;

  // stage 1: keep-ratio (allow_scale_up=True), truncated int sizes
  double ratio = std::min(double(std::max(th, tw)) / std::max(h0, w0),
                          double(std::min(th, tw)) / std::min(h0, w0));
  int rh = h0, rw = w0;
  if (ratio != 1.0) {
    rh = int(h0 * ratio);
    rw = int(w0 * ratio);
  }
  std::vector<uint8_t> stage1;
  if (rh != h || rw != w) {   // no-op when scaled decode hit target
    stage1.resize(size_t(rh) * rw * 3);
    resize_rgb(cur, h, w, stage1.data(), rh, rw);
    cur = stage1.data();
  }
  // stage 2: letterbox (allow_scale_up=False), rounded sizes, bilinear
  double r2 = std::min(std::min(double(th) / rh, double(tw) / rw), 1.0);
  // nearbyint: ties-to-even like Python round() (lround would give
  // half-away and shift the letterbox by 1 px at exact .5 sizes)
  int nh = int(std::nearbyint(rh * r2)), nw = int(std::nearbyint(rw * r2));
  std::vector<uint8_t> stage2;
  if (nh != rh || nw != rw) {
    stage2.resize(size_t(nh) * nw * 3);
    resize_bilinear(cur, rh, rw, stage2.data(), nh, nw);
    cur = stage2.data();
  }
  int pad_h = th - nh, pad_w = tw - nw;
  int top = int(std::lround(pad_h / 2 - 0.1));
  int left = int(std::lround(pad_w / 2 - 0.1));
  if (top < 0) top = 0;
  if (left < 0) left = 0;
  pad[0] = float(top);
  pad[1] = float(pad_h - top);
  pad[2] = float(left);
  pad[3] = float(pad_w - left);
  // preprocess_image composes the two stage ratios (== nw/w0, nh/h0)
  sf[0] = float((double(nw) / rw) * (double(rw) / w0));
  sf[1] = float((double(nh) / rh) * (double(rh) / h0));

  std::memset(out, pad_val, size_t(th) * tw * 3);
  for (int y = 0; y < nh; ++y) {
    const uint8_t* s = cur + size_t(y) * nw * 3;
    uint8_t* d = out + (size_t(y + top) * tw + left) * 3;
    for (int x = 0; x < nw * 3; x += 3) {
      d[x] = s[x + 2];
      d[x + 1] = s[x + 1];
      d[x + 2] = s[x];
    }
  }
}

// A decoded BGR image (h, w) made upright RGB; out holds h*w*3 bytes.
void wd_upright_rgb(const uint8_t* bgr, int h, int w, int orient,
                    uint8_t* out) {
  upright(bgr, h, w, orient, true, out);
}

}  // extern "C"
