// Native audio ingestion for the PyTorch port (a copy of the JAX package's
// native/audio_io.cpp; the port builds and loads its own copy).
//
// Replaces the numpy WAV decode path (audioyolo_tpu_torch/data/wavio.py) for
// the hot training and inference ingestion loop: one C call decodes,
// mono-downmixes, scales and zero-pads a whole batch of clip spans into a
// caller-owned contiguous buffer (float32 (B, S), int16 (B, S), or int16
// frames in the fused frontend's phase-grouped layout), fanning file decodes
// out over a thread pool. PCM 8/16/24/32 and IEEE float32/64 are supported
// with the numpy reader's [-1, 1] scaling (bit-exact: both divide by
// 2^(bits-1)).
//
// Built at first use by audioyolo_tpu_torch/ops/build.py with the host C++
// compiler ($CXX or c++: -O3 -fPIC -std=c++17 -march=native -shared -pthread)
// and loaded with ctypes by audioyolo_tpu_torch/data/native.py. A failed
// build raises; there is no numpy fallback.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint16_t kFmtPcm = 1;
constexpr uint16_t kFmtFloat = 3;
constexpr uint16_t kFmtExtensible = 0xFFFE;

struct WavHeader {
  uint16_t format = 0;
  uint16_t channels = 0;
  uint32_t rate = 0;
  uint16_t bits = 0;
  int64_t data_offset = 0;
  int64_t data_size = 0;
};

bool read_exact(FILE* f, void* dst, size_t n) { return fread(dst, 1, n, f) == n; }

uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

// Parses the RIFF header up to the data chunk. Returns 0 on success.
int parse_header(FILE* f, WavHeader* h) {
  uint8_t riff[12];
  if (!read_exact(f, riff, 12)) return -1;
  if (memcmp(riff, "RIFF", 4) != 0 || memcmp(riff + 8, "WAVE", 4) != 0) return -2;
  bool have_fmt = false;
  for (;;) {
    uint8_t hdr[8];
    if (!read_exact(f, hdr, 8)) return -3;
    uint32_t size = rd_u32(hdr + 4);
    if (memcmp(hdr, "fmt ", 4) == 0) {
      std::vector<uint8_t> payload(size + (size & 1));
      if (!read_exact(f, payload.data(), payload.size())) return -4;
      h->format = rd_u16(payload.data());
      h->channels = rd_u16(payload.data() + 2);
      h->rate = rd_u32(payload.data() + 4);
      h->bits = rd_u16(payload.data() + 14);
      if (h->format == kFmtExtensible && size >= 40) h->format = rd_u16(payload.data() + 24);
      have_fmt = true;
    } else if (memcmp(hdr, "data", 4) == 0) {
      if (!have_fmt) return -5;
      h->data_offset = ftell(f);
      h->data_size = size;
      return 0;
    } else {
      if (fseek(f, static_cast<long>(size + (size & 1)), SEEK_CUR) != 0) return -6;
    }
  }
}

// Decodes `frames` interleaved frames into mono float32 (mean over channels).
// Raw bytes are in `raw`; writes `frames` floats to `out`.
int decode_to_mono(const WavHeader& h, const uint8_t* raw, int64_t frames, float* out) {
  const int ch = h.channels;
  const float inv_ch = 1.0f / static_cast<float>(ch);
  if (h.format == kFmtFloat && h.bits == 32) {
    const float* s = reinterpret_cast<const float*>(raw);
    for (int64_t i = 0; i < frames; ++i) {
      float acc = 0.f;
      for (int c = 0; c < ch; ++c) acc += s[i * ch + c];
      out[i] = acc * inv_ch;
    }
  } else if (h.format == kFmtFloat && h.bits == 64) {
    const double* s = reinterpret_cast<const double*>(raw);
    for (int64_t i = 0; i < frames; ++i) {
      double acc = 0.0;
      for (int c = 0; c < ch; ++c) acc += s[i * ch + c];
      out[i] = static_cast<float>(acc * inv_ch);
    }
  } else if (h.format == kFmtPcm && h.bits == 16) {
    const int16_t* s = reinterpret_cast<const int16_t*>(raw);
    constexpr float kScale = 1.0f / 32768.0f;
    for (int64_t i = 0; i < frames; ++i) {
      float acc = 0.f;
      for (int c = 0; c < ch; ++c) acc += static_cast<float>(s[i * ch + c]);
      out[i] = acc * kScale * inv_ch;
    }
  } else if (h.format == kFmtPcm && h.bits == 32) {
    const int32_t* s = reinterpret_cast<const int32_t*>(raw);
    constexpr float kScale = 1.0f / 2147483648.0f;
    for (int64_t i = 0; i < frames; ++i) {
      float acc = 0.f;
      for (int c = 0; c < ch; ++c) acc += static_cast<float>(s[i * ch + c]) * kScale;
      out[i] = acc * inv_ch;
    }
  } else if (h.format == kFmtPcm && h.bits == 24) {
    constexpr float kScale = 1.0f / 8388608.0f;  // 2^23
    for (int64_t i = 0; i < frames; ++i) {
      float acc = 0.f;
      for (int c = 0; c < ch; ++c) {
        const uint8_t* b = raw + (i * ch + c) * 3;
        int32_t v = static_cast<int32_t>(b[0]) | (static_cast<int32_t>(b[1]) << 8) |
                    (static_cast<int32_t>(b[2]) << 16);
        v = (v << 8) >> 8;  // sign-extend 24 -> 32
        acc += static_cast<float>(v) * kScale;
      }
      out[i] = acc * inv_ch;
    }
  } else if (h.format == kFmtPcm && h.bits == 8) {
    constexpr float kScale = 1.0f / 128.0f;
    for (int64_t i = 0; i < frames; ++i) {
      float acc = 0.f;
      for (int c = 0; c < ch; ++c)
        acc += (static_cast<float>(raw[i * ch + c]) - 128.0f) * kScale;
      out[i] = acc * inv_ch;
    }
  } else {
    return -10;
  }
  return 0;
}

// Reads [frame_offset, frame_offset+num_frames) as mono float32, zero-padding
// to out_len. Returns frames actually decoded, or a negative error code.
int64_t read_span_mono(const char* path, int64_t frame_offset, int64_t num_frames,
                       float* out, int64_t out_len) {
  FILE* f = fopen(path, "rb");
  if (!f) return -100;
  WavHeader h;
  int rc = parse_header(f, &h);
  if (rc != 0) {
    fclose(f);
    return rc;
  }
  const int64_t frame_bytes = static_cast<int64_t>(h.channels) * (h.bits / 8);
  const int64_t total = h.data_size / frame_bytes;
  int64_t start = frame_offset < 0 ? 0 : (frame_offset > total ? total : frame_offset);
  int64_t count = num_frames < 0 ? total - start : num_frames;
  if (count > total - start) count = total - start;
  if (count > out_len) count = out_len;

  if (count > 0) {
    if (fseek(f, static_cast<long>(h.data_offset + start * frame_bytes), SEEK_SET) != 0) {
      fclose(f);
      return -7;
    }
    std::vector<uint8_t> raw(static_cast<size_t>(count * frame_bytes));
    if (!read_exact(f, raw.data(), raw.size())) {
      fclose(f);
      return -8;
    }
    rc = decode_to_mono(h, raw.data(), count, out);
    if (rc != 0) {
      fclose(f);
      return rc;
    }
  }
  fclose(f);
  if (count < out_len) memset(out + count, 0, static_cast<size_t>(out_len - count) * sizeof(float));
  return count;
}

// Decodes [frame_offset, frame_offset+num_frames) as mono int16 (PCM16
// quantization: round-to-nearest-even of x*32768, clipped — matching the
// numpy loader path bit-for-bit). For mono PCM16 sources the samples are
// fread straight into `out` with zero decode work. Zero-pads to out_len.
int64_t read_span_mono_i16(const char* path, int64_t frame_offset, int64_t num_frames,
                           int16_t* out, int64_t out_len) {
  FILE* f = fopen(path, "rb");
  if (!f) return -100;
  WavHeader h;
  int rc = parse_header(f, &h);
  if (rc != 0) {
    fclose(f);
    return rc;
  }
  const int64_t frame_bytes = static_cast<int64_t>(h.channels) * (h.bits / 8);
  const int64_t total = h.data_size / frame_bytes;
  int64_t start = frame_offset < 0 ? 0 : (frame_offset > total ? total : frame_offset);
  int64_t count = num_frames < 0 ? total - start : num_frames;
  if (count > total - start) count = total - start;
  if (count > out_len) count = out_len;

  if (count > 0) {
    if (h.format == kFmtPcm && h.bits == 16 && h.channels == 1) {
      if (fseek(f, static_cast<long>(h.data_offset + start * 2), SEEK_SET) != 0 ||
          !read_exact(f, out, static_cast<size_t>(count) * 2)) {
        fclose(f);
        return -8;
      }
    } else {
      fclose(f);
      std::vector<float> tmp(static_cast<size_t>(count));
      int64_t got = read_span_mono(path, start, count, tmp.data(), count);
      if (got < 0) return got;
      for (int64_t i = 0; i < count; ++i) {
        float v = tmp[static_cast<size_t>(i)] * 32768.0f;
        long q = lrintf(v);  // round-half-even, same as np.round
        if (q < -32768) q = -32768;
        if (q > 32767) q = 32767;
        out[i] = static_cast<int16_t>(q);
      }
      if (count < out_len)
        memset(out + count, 0, static_cast<size_t>(out_len - count) * 2);
      return count;
    }
  }
  fclose(f);
  if (count < out_len) memset(out + count, 0, static_cast<size_t>(out_len - count) * 2);
  return count;
}

}  // namespace

extern "C" {

int ayt_wav_info(const char* path, int32_t* rate, int64_t* frames, int32_t* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -100;
  WavHeader h;
  int rc = parse_header(f, &h);
  fclose(f);
  if (rc != 0) return rc;
  *rate = static_cast<int32_t>(h.rate);
  *frames = h.data_size / (static_cast<int64_t>(h.channels) * (h.bits / 8));
  *channels = h.channels;
  return 0;
}

// Single span; out must hold out_len floats.
int64_t ayt_read_mono(const char* path, int64_t frame_offset, int64_t num_frames,
                      float* out, int64_t out_len) {
  return read_span_mono(path, frame_offset, num_frames, out, out_len);
}

// Batch: decodes n spans into out[i * out_len ...] using up to n_threads.
// Returns 0 on success or the first error code encountered.
int ayt_load_batch(const char** paths, int32_t n, const int64_t* frame_offsets,
                   const int64_t* num_frames, float* out, int64_t out_len,
                   int32_t n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::vector<int64_t> rcs(static_cast<size_t>(n), 0);
  std::vector<std::thread> workers;
  std::vector<int32_t> next(1, 0);
  // simple static partition: thread t handles items t, t+T, t+2T, ...
  for (int32_t t = 0; t < n_threads; ++t) {
    workers.emplace_back([&, t]() {
      for (int32_t i = t; i < n; i += n_threads) {
        rcs[static_cast<size_t>(i)] = read_span_mono(
            paths[i], frame_offsets[i], num_frames[i], out + static_cast<int64_t>(i) * out_len,
            out_len);
      }
    });
  }
  for (auto& w : workers) w.join();
  for (int32_t i = 0; i < n; ++i)
    if (rcs[static_cast<size_t>(i)] < 0) return static_cast<int>(rcs[static_cast<size_t>(i)]);
  return 0;
}

// Per-clip symmetric int8 quantization of int16 clips for the minimum-byte
// host->device transfer posture: step[i] = max(per-clip absmax, 1) / 127 in
// int16 units, q = x/step rounded half-to-even (matches numpy.round),
// clipped to [-127, 127]. A two-pass streaming loop per clip.
int ayt_quant_i8(const int16_t* clips, int32_t n, int64_t clip_len,
                 int8_t* out, float* out_step, int32_t n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::vector<std::thread> workers;
  for (int32_t t = 0; t < n_threads; ++t) {
    workers.emplace_back([&, t]() {
      for (int32_t i = t; i < n; i += n_threads) {
        const int16_t* src = clips + static_cast<int64_t>(i) * clip_len;
        int32_t amax = 0;
        for (int64_t j = 0; j < clip_len; ++j) {
          int32_t a = src[j];
          a = a < 0 ? -a : a;  // int32: |-32768| is representable
          if (a > amax) amax = a;
        }
        const float step = (amax < 1 ? 1 : amax) / 127.0f;
        const float inv = 1.0f / step;
        int8_t* dst = out + static_cast<int64_t>(i) * clip_len;
        for (int64_t j = 0; j < clip_len; ++j) {
          // lrintf under FE_TONEAREST = round half to even = numpy.round
          long q = lrintf(src[j] * inv);
          if (q > 127) q = 127;
          if (q < -127) q = -127;
          dst[j] = static_cast<int8_t>(q);
        }
        out_step[i] = step;
      }
    });
  }
  for (auto& w : workers) w.join();
  return 0;
}

// In-memory variant: phase-group a batch of already-decoded int16 clips
// (B, clip_len) into (B, n_ph, n_groups, frame_len) — the streaming
// evaluator's framing step, as a pure memcpy loop instead of numpy
// pad/reshape/stack on the host core.
int ayt_frame_i16(const int16_t* clips, int32_t n, int64_t clip_len, int16_t* out,
                  int32_t n_ph, int64_t n_groups, int64_t frame_len, int64_t span,
                  const int64_t* phase_offs, int64_t left_pad, int32_t n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  int64_t max_off = 0;
  for (int32_t r = 0; r < n_ph; ++r)
    if (phase_offs[r] > max_off) max_off = phase_offs[r];
  const int64_t padded_len =
      std::max(left_pad + clip_len, max_off + n_groups * span);
  const int64_t item_out = static_cast<int64_t>(n_ph) * n_groups * frame_len;

  std::vector<std::thread> workers;
  for (int32_t t = 0; t < n_threads; ++t) {
    workers.emplace_back([&, t]() {
      std::vector<int16_t> padded(static_cast<size_t>(padded_len), 0);
      for (int32_t i = t; i < n; i += n_threads) {
        memcpy(padded.data() + left_pad, clips + static_cast<int64_t>(i) * clip_len,
               static_cast<size_t>(clip_len) * 2);
        int16_t* dst = out + static_cast<int64_t>(i) * item_out;
        for (int32_t r = 0; r < n_ph; ++r) {
          const int16_t* base = padded.data() + phase_offs[r];
          for (int64_t g = 0; g < n_groups; ++g)
            memcpy(dst + (static_cast<int64_t>(r) * n_groups + g) * frame_len,
                   base + g * span, static_cast<size_t>(frame_len) * 2);
        }
      }
    });
  }
  for (auto& w : workers) w.join();
  return 0;
}

// Batch decode to raw int16 waveforms (B, out_len): the minimum-byte
// host->device layout.
// Mono PCM16 is fread directly; other formats decode via float and quantize
// like the numpy loader.
int ayt_load_batch_i16(const char** paths, int32_t n, const int64_t* frame_offsets,
                       const int64_t* num_frames, int16_t* out, int64_t out_len,
                       int32_t n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::vector<int64_t> rcs(static_cast<size_t>(n), 0);
  std::vector<std::thread> workers;
  for (int32_t t = 0; t < n_threads; ++t) {
    workers.emplace_back([&, t]() {
      for (int32_t i = t; i < n; i += n_threads) {
        rcs[static_cast<size_t>(i)] = read_span_mono_i16(
            paths[i], frame_offsets[i], num_frames[i],
            out + static_cast<int64_t>(i) * out_len, out_len);
      }
    });
  }
  for (auto& w : workers) w.join();
  for (int32_t i = 0; i < n; ++i)
    if (rcs[static_cast<size_t>(i)] < 0) return static_cast<int>(rcs[static_cast<size_t>(i)]);
  return 0;
}

// Batch decode straight into the fused frontend's phase-grouped int16 frame
// layout (audioyolo_tpu_torch/ops/fused_frontend.py::FusedFrameDFT.frame_host):
//
//   out[i, r, g, :] = padded_i[phase_offs[r] + g * span : ... + frame_len]
//
// where padded_i = left_pad zeros ++ clip_i (zero-padded to clip_len) ++ tail
// zeros. Mono PCM16 files are fread directly as int16 (no float round trip,
// no numpy restack); other formats decode via the float path and quantize
// with the numpy loader's exact convention. One call produces the
// device-ready (B, n_ph, n_groups, frame_len) training/inference input.
int ayt_load_batch_framed_i16(const char** paths, int32_t n, const int64_t* frame_offsets,
                              const int64_t* num_frames, int16_t* out, int64_t clip_len,
                              int32_t n_ph, int64_t n_groups, int64_t frame_len,
                              int64_t span, const int64_t* phase_offs, int64_t left_pad,
                              int32_t n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  int64_t max_off = 0;
  for (int32_t r = 0; r < n_ph; ++r)
    if (phase_offs[r] > max_off) max_off = phase_offs[r];
  const int64_t padded_len =
      std::max(left_pad + clip_len, max_off + n_groups * span);
  const int64_t item_out = static_cast<int64_t>(n_ph) * n_groups * frame_len;

  std::vector<int64_t> rcs(static_cast<size_t>(n), 0);
  std::vector<std::thread> workers;
  for (int32_t t = 0; t < n_threads; ++t) {
    workers.emplace_back([&, t]() {
      std::vector<int16_t> padded(static_cast<size_t>(padded_len));
      for (int32_t i = t; i < n; i += n_threads) {
        memset(padded.data(), 0, static_cast<size_t>(left_pad) * 2);
        int64_t got = read_span_mono_i16(paths[i], frame_offsets[i], num_frames[i],
                                         padded.data() + left_pad, padded_len - left_pad);
        if (got < 0) {
          rcs[static_cast<size_t>(i)] = got;
          continue;
        }
        int16_t* dst = out + static_cast<int64_t>(i) * item_out;
        for (int32_t r = 0; r < n_ph; ++r) {
          const int16_t* base = padded.data() + phase_offs[r];
          for (int64_t g = 0; g < n_groups; ++g)
            memcpy(dst + (static_cast<int64_t>(r) * n_groups + g) * frame_len,
                   base + g * span, static_cast<size_t>(frame_len) * 2);
        }
      }
    });
  }
  for (auto& w : workers) w.join();
  for (int32_t i = 0; i < n; ++i)
    if (rcs[static_cast<size_t>(i)] < 0) return static_cast<int>(rcs[static_cast<size_t>(i)]);
  return 0;
}

}  // extern "C"
