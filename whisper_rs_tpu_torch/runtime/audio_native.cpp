// Native audio ingest runtime: container decode -> mono f32 -> 16 kHz.
//
// A copy of whisper_rs_tpu/runtime/audio_native.cpp, kept by the PyTorch
// port so that it needs nothing of the JAX package.  Exposed over a minimal
// C ABI and loaded from Python with ctypes (runtime/native.py), which
// builds it with the Makefile beside it at first use.
//
// Formats: WAV (PCM 8/16/24/32 + IEEE float) parsed directly; MP3 decoded
// through libmpg123 when present (dlopen'd at runtime — no build-time dep).
// Downmix: channel mean.  Resampler: Hann-windowed-sinc polyphase evaluated
// per output sample — band-limited 16 kHz out.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <dlfcn.h>

namespace {

thread_local std::string g_error;

constexpr int kTargetRate = 16000;

void set_error(const std::string& e) { g_error = e; }

// ---------------------------------------------------------------------------
// resampler: windowed-sinc, evaluated per output sample
// ---------------------------------------------------------------------------

std::vector<float> resample(const std::vector<float>& in, int sr_in, int sr_out) {
  if (sr_in == sr_out) return in;
  const double ratio = static_cast<double>(sr_in) / sr_out;
  const double cutoff = 0.95 * std::min(1.0, static_cast<double>(sr_out) / sr_in);
  const int half = 24;  // half-width in input samples at the lower rate
  const int64_t n_out =
      static_cast<int64_t>(static_cast<double>(in.size()) * sr_out / sr_in);
  std::vector<float> out(n_out);

  const int64_t n_in = static_cast<int64_t>(in.size());
  for (int64_t n = 0; n < n_out; ++n) {
    const double t = n * ratio;
    const int64_t i0 = static_cast<int64_t>(std::floor(t));
    const double frac = t - i0;
    double acc = 0.0;
    for (int k = -half + 1; k <= half; ++k) {
      const int64_t idx = i0 + k;
      if (idx < 0 || idx >= n_in) continue;
      const double u = k - frac;                     // distance in input samples
      const double x = cutoff * u;
      double s = (std::abs(x) < 1e-9) ? 1.0 : std::sin(M_PI * x) / (M_PI * x);
      const double w = 0.5 * (1.0 + std::cos(M_PI * u / half));  // Hann
      acc += in[idx] * s * cutoff * w;
    }
    out[n] = static_cast<float>(acc);
  }
  return out;
}

// ---------------------------------------------------------------------------
// WAV
// ---------------------------------------------------------------------------

bool parse_wav(const std::vector<uint8_t>& data, std::vector<float>* mono,
               int* sample_rate) {
  if (data.size() < 44 || std::memcmp(data.data(), "RIFF", 4) != 0 ||
      std::memcmp(data.data() + 8, "WAVE", 4) != 0) {
    set_error("not a RIFF/WAVE file");
    return false;
  }
  size_t pos = 12;
  uint16_t fmt_tag = 0, n_ch = 0, bits = 0;
  uint32_t sr = 0, sub_format = 0;
  const uint8_t* samples = nullptr;
  size_t samples_len = 0;

  while (pos + 8 <= data.size()) {
    const char* cid = reinterpret_cast<const char*>(data.data() + pos);
    uint32_t size;
    std::memcpy(&size, data.data() + pos + 4, 4);
    if (pos + 8 + size > data.size()) size = data.size() - pos - 8;
    const uint8_t* body = data.data() + pos + 8;
    if (std::memcmp(cid, "fmt ", 4) == 0 && size >= 16) {
      std::memcpy(&fmt_tag, body, 2);
      std::memcpy(&n_ch, body + 2, 2);
      std::memcpy(&sr, body + 4, 4);
      std::memcpy(&bits, body + 14, 2);
      // WAVE_FORMAT_EXTENSIBLE: SubFormat GUID data1 at fmt offset 24
      // (KSDATAFORMAT_SUBTYPE_PCM = 1, _IEEE_FLOAT = 3)
      if (size >= 40) std::memcpy(&sub_format, body + 24, 4);
    } else if (std::memcmp(cid, "data", 4) == 0) {
      samples = body;
      samples_len = size;
    }
    pos += 8 + size + (size & 1);
  }
  if (!samples || n_ch == 0 || sr == 0) {
    set_error("missing fmt/data chunk");
    return false;
  }
  if (fmt_tag == 0xFFFE) {
    if (sub_format != 1 && sub_format != 3) {
      set_error("unsupported WAVE_FORMAT_EXTENSIBLE SubFormat");
      return false;
    }
    fmt_tag = static_cast<uint16_t>(sub_format);
  }

  std::vector<float> interleaved;
  if (fmt_tag == 1) {  // PCM
    if (bits == 16) {
      const int16_t* p = reinterpret_cast<const int16_t*>(samples);
      size_t n = samples_len / 2;
      interleaved.resize(n);
      for (size_t i = 0; i < n; ++i) interleaved[i] = p[i] / 32768.0f;
    } else if (bits == 8) {
      interleaved.resize(samples_len);
      for (size_t i = 0; i < samples_len; ++i)
        interleaved[i] = (samples[i] - 128) / 128.0f;
    } else if (bits == 32) {
      const int32_t* p = reinterpret_cast<const int32_t*>(samples);
      size_t n = samples_len / 4;
      interleaved.resize(n);
      for (size_t i = 0; i < n; ++i) interleaved[i] = p[i] / 2147483648.0f;
    } else if (bits == 24) {
      size_t n = samples_len / 3;
      interleaved.resize(n);
      for (size_t i = 0; i < n; ++i) {
        int32_t v = samples[3 * i] | (samples[3 * i + 1] << 8) |
                    (samples[3 * i + 2] << 16);
        if (v >= (1 << 23)) v -= (1 << 24);
        interleaved[i] = v / 8388608.0f;
      }
    } else {
      set_error("unsupported PCM bit depth");
      return false;
    }
  } else if (fmt_tag == 3) {  // IEEE float
    if (bits == 32) {
      const float* p = reinterpret_cast<const float*>(samples);
      interleaved.assign(p, p + samples_len / 4);
    } else if (bits == 64) {
      const double* p = reinterpret_cast<const double*>(samples);
      size_t n = samples_len / 8;
      interleaved.resize(n);
      for (size_t i = 0; i < n; ++i) interleaved[i] = static_cast<float>(p[i]);
    } else {
      set_error("unsupported float bit depth");
      return false;
    }
  } else {
    set_error("unsupported WAV format tag");
    return false;
  }

  const size_t frames = interleaved.size() / n_ch;
  mono->resize(frames);
  for (size_t i = 0; i < frames; ++i) {
    double acc = 0;
    for (int c = 0; c < n_ch; ++c) acc += interleaved[i * n_ch + c];
    (*mono)[i] = static_cast<float>(acc / n_ch);
  }
  *sample_rate = static_cast<int>(sr);
  return true;
}

// ---------------------------------------------------------------------------
// FLAC (native decoder — LibriSpeech ingest fast path)
//
// Same stream support as the Python fallback (audio/flac.py): constant /
// verbatim / fixed / LPC subframes, Rice & Rice2 partitions incl. escapes,
// wasted bits, left/right/mid-side decorrelation, 8..32-bit samples.
// Reference capability: symphonia "flac" feature (Cargo.toml:15).
// ---------------------------------------------------------------------------

class FlacBitReader {
 public:
  // data must have >=8 readable bytes past the end (caller pads).
  FlacBitReader(const uint8_t* data, size_t len_bytes)
      : d_(data), len_bits_(len_bytes * 8) {}

  uint64_t read(int n) {  // n <= 57
    const uint64_t w = be64(pos_ >> 3) << (pos_ & 7);
    pos_ += n;
    return n ? (w >> (64 - n)) : 0;
  }

  int64_t read_signed(int n) {
    uint64_t v = read(n);
    if (n < 64 && v >= (1ull << (n - 1))) return static_cast<int64_t>(v) - (1ll << n);
    return static_cast<int64_t>(v);
  }

  int read_unary() {
    int q = 0;
    for (;;) {
      uint64_t w = be64(pos_ >> 3) << (pos_ & 7);
      if (w == 0) {  // >=57 zero bits in the window
        int advance = 57 - static_cast<int>(pos_ & 7);
        q += advance;
        pos_ += advance;
        if (pos_ >= len_bits_) return q;  // corrupt; caller detects
        continue;
      }
      const int lead = __builtin_clzll(w);
      q += lead;
      pos_ += lead + 1;  // consume zeros + the stop bit
      return q;
    }
  }

  uint64_t read_utf8() {
    uint64_t b0 = read(8);
    if (b0 < 0x80) return b0;
    int n_extra = 0;
    uint64_t mask = 0x40;
    while (b0 & mask) {
      ++n_extra;
      mask >>= 1;
    }
    uint64_t v = b0 & (mask - 1);
    for (int i = 0; i < n_extra; ++i) v = (v << 6) | (read(8) & 0x3F);
    return v;
  }

  void align() { pos_ = (pos_ + 7) & ~size_t(7); }
  size_t bit_pos() const { return pos_; }
  void set_bit_pos(size_t p) { pos_ = p; }
  bool overran() const { return pos_ > len_bits_; }

 private:
  uint64_t be64(size_t byte) const {
    uint64_t w;
    std::memcpy(&w, d_ + byte, 8);
    return __builtin_bswap64(w);
  }
  const uint8_t* d_;
  size_t len_bits_;
  size_t pos_ = 0;
};

bool flac_residual(FlacBitReader& br, int blocksize, int order,
                   std::vector<int64_t>* out) {
  const int method = static_cast<int>(br.read(2));
  if (method > 1) {
    set_error("reserved FLAC residual method");
    return false;
  }
  const int plen = method == 0 ? 4 : 5;
  const uint64_t escape = (1ull << plen) - 1;
  const int part_order = static_cast<int>(br.read(4));
  const int n_parts = 1 << part_order;
  out->clear();
  out->reserve(blocksize);
  for (int p = 0; p < n_parts; ++p) {
    const int n = (blocksize >> part_order) - (p == 0 ? order : 0);
    const uint64_t param = br.read(plen);
    if (param == escape) {
      const int width = static_cast<int>(br.read(5));
      for (int i = 0; i < n; ++i)
        out->push_back(width ? br.read_signed(width) : 0);
    } else {
      const int k = static_cast<int>(param);
      for (int i = 0; i < n; ++i) {
        const uint64_t q = br.read_unary();
        const uint64_t u = (q << k) | (k ? br.read(k) : 0);
        out->push_back(static_cast<int64_t>(u >> 1) ^
                       -static_cast<int64_t>(u & 1));  // zigzag
      }
    }
  }
  return true;
}

bool flac_subframe(FlacBitReader& br, int blocksize, int bps,
                   std::vector<int64_t>* samples) {
  if (br.read(1) != 0) {
    set_error("invalid FLAC subframe padding bit");
    return false;
  }
  const int sf_type = static_cast<int>(br.read(6));
  int wasted = 0;
  if (br.read(1)) {
    wasted = 1 + br.read_unary();
    bps -= wasted;
  }
  samples->clear();
  samples->reserve(blocksize);
  std::vector<int64_t> resid;

  if (sf_type == 0) {  // constant
    samples->assign(blocksize, br.read_signed(bps));
  } else if (sf_type == 1) {  // verbatim
    for (int i = 0; i < blocksize; ++i) samples->push_back(br.read_signed(bps));
  } else if (sf_type >= 8 && sf_type <= 12) {  // fixed
    const int order = sf_type - 8;
    static const int kCoefs[5][4] = {
        {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};
    for (int i = 0; i < order; ++i) samples->push_back(br.read_signed(bps));
    if (!flac_residual(br, blocksize, order, &resid)) return false;
    for (int64_t r : resid) {
      int64_t pred = 0;
      const size_t t = samples->size();
      for (int i = 0; i < order; ++i) pred += kCoefs[order][i] * (*samples)[t - 1 - i];
      samples->push_back(pred + r);
    }
  } else if (sf_type >= 32) {  // LPC
    const int order = (sf_type & 31) + 1;
    for (int i = 0; i < order; ++i) samples->push_back(br.read_signed(bps));
    const int precision = static_cast<int>(br.read(4)) + 1;
    const int shift = static_cast<int>(br.read_signed(5));
    int64_t coefs[32];
    for (int i = 0; i < order; ++i) coefs[i] = br.read_signed(precision);
    if (!flac_residual(br, blocksize, order, &resid)) return false;
    for (int64_t r : resid) {
      int64_t acc = 0;
      const size_t t = samples->size();
      for (int i = 0; i < order; ++i) acc += coefs[i] * (*samples)[t - 1 - i];
      samples->push_back((acc >> shift) + r);
    }
  } else {
    set_error("reserved FLAC subframe type");
    return false;
  }

  if (wasted)
    for (auto& s : *samples) s <<= wasted;
  return true;
}

bool decode_flac_native(const std::vector<uint8_t>& raw,
                        std::vector<float>* mono_or_interleaved, int* n_channels,
                        int* sample_rate) {
  if (raw.size() < 8 || std::memcmp(raw.data(), "fLaC", 4) != 0) {
    set_error("not a FLAC stream");
    return false;
  }
  std::vector<uint8_t> data(raw);
  data.resize(raw.size() + 8, 0);  // bit-reader overread pad

  static const int kBlockSizes[16] = {0,    192,  576,   1152,  2304, 4608,
                                      0,    0,    256,   512,   1024, 2048,
                                      4096, 8192, 16384, 32768};
  static const int kSampleSizes[8] = {0, 8, 12, 0, 16, 20, 24, 32};

  size_t pos = 4;
  int sr = 0, n_ch = 0, bps = 0;
  uint64_t total = 0;
  for (;;) {
    if (pos + 4 > raw.size()) {
      set_error("truncated FLAC metadata");
      return false;
    }
    const uint8_t hdr = data[pos];
    const uint32_t length =
        (data[pos + 1] << 16) | (data[pos + 2] << 8) | data[pos + 3];
    if ((hdr & 0x7F) == 0) {  // STREAMINFO
      FlacBitReader br(data.data() + pos + 4, length);
      br.read(16);
      br.read(16);
      br.read(24);
      br.read(24);
      sr = static_cast<int>(br.read(20));
      n_ch = static_cast<int>(br.read(3)) + 1;
      bps = static_cast<int>(br.read(5)) + 1;
      total = br.read(36);
    }
    pos += 4 + length;
    if (hdr & 0x80) break;
  }
  if (sr == 0) {
    set_error("missing FLAC STREAMINFO");
    return false;
  }

  std::vector<std::vector<int64_t>> channels(n_ch);
  std::vector<int64_t> sub[2];
  std::vector<std::vector<int64_t>> subs(n_ch);
  FlacBitReader br(data.data(), raw.size());
  br.set_bit_pos(pos * 8);

  while ((br.bit_pos() >> 3) + 2 < raw.size()) {
    if (br.read(14) != 0x3FFE) break;
    br.read(1);
    br.read(1);
    const int bs_code = static_cast<int>(br.read(4));
    const int sr_code = static_cast<int>(br.read(4));
    const int chan_code = static_cast<int>(br.read(4));
    const int ss_code = static_cast<int>(br.read(3));
    br.read(1);
    br.read_utf8();
    int blocksize = kBlockSizes[bs_code];
    if (bs_code == 6) blocksize = static_cast<int>(br.read(8)) + 1;
    if (bs_code == 7) blocksize = static_cast<int>(br.read(16)) + 1;
    if (sr_code == 12) br.read(8);
    if (sr_code == 13 || sr_code == 14) br.read(16);
    const int frame_bps = kSampleSizes[ss_code] ? kSampleSizes[ss_code] : bps;
    br.read(8);  // CRC-8

    if (blocksize <= 0) {
      set_error("invalid FLAC block size");
      return false;
    }

    if (chan_code < 8) {
      const int nc = chan_code + 1;
      if (nc != n_ch) {
        set_error("FLAC channel count mismatch");
        return false;
      }
      for (int c = 0; c < nc; ++c)
        if (!flac_subframe(br, blocksize, frame_bps, &subs[c])) return false;
    } else if (chan_code <= 10) {
      if (n_ch != 2) {
        set_error("FLAC stereo decorrelation in non-stereo stream");
        return false;
      }
      const int bps0 = frame_bps + (chan_code == 9 ? 1 : 0);
      const int bps1 = frame_bps + (chan_code == 9 ? 0 : 1);
      if (!flac_subframe(br, blocksize, bps0, &sub[0])) return false;
      if (!flac_subframe(br, blocksize, bps1, &sub[1])) return false;
      subs[0].resize(blocksize);
      subs[1].resize(blocksize);
      for (int i = 0; i < blocksize; ++i) {
        if (chan_code == 8) {  // left/side
          subs[0][i] = sub[0][i];
          subs[1][i] = sub[0][i] - sub[1][i];
        } else if (chan_code == 9) {  // right/side
          subs[0][i] = sub[1][i] + sub[0][i];
          subs[1][i] = sub[1][i];
        } else {  // mid/side
          const int64_t mm = (sub[0][i] << 1) | (sub[1][i] & 1);
          subs[0][i] = (mm + sub[1][i]) >> 1;
          subs[1][i] = (mm - sub[1][i]) >> 1;
        }
      }
    } else {
      set_error("reserved FLAC channel assignment");
      return false;
    }
    if (br.overran()) {
      set_error("truncated FLAC frame");
      return false;
    }
    for (int c = 0; c < n_ch; ++c)
      channels[c].insert(channels[c].end(), subs[c].begin(), subs[c].end());

    br.align();
    br.read(16);  // CRC-16
  }

  size_t n = channels[0].size();
  for (int c = 1; c < n_ch; ++c) n = std::min(n, channels[c].size());
  if (total) n = std::min(n, static_cast<size_t>(total));
  const double scale = static_cast<double>(1ll << (bps - 1));
  mono_or_interleaved->resize(n * n_ch);
  for (size_t i = 0; i < n; ++i)
    for (int c = 0; c < n_ch; ++c)
      (*mono_or_interleaved)[i * n_ch + c] =
          static_cast<float>(channels[c][i] / scale);
  *n_channels = n_ch;
  *sample_rate = sr;
  return true;
}

bool decode_flac_mono(const std::vector<uint8_t>& data, std::vector<float>* mono,
                      int* sample_rate) {
  std::vector<float> interleaved;
  int n_ch = 0;
  if (!decode_flac_native(data, &interleaved, &n_ch, sample_rate)) return false;
  const size_t frames = n_ch ? interleaved.size() / n_ch : 0;
  mono->resize(frames);
  for (size_t i = 0; i < frames; ++i) {
    double acc = 0;
    for (int c = 0; c < n_ch; ++c) acc += interleaved[i * n_ch + c];
    (*mono)[i] = static_cast<float>(acc / n_ch);
  }
  return true;
}

// ---------------------------------------------------------------------------
// MP3 via dlopen'd libmpg123 (optional at runtime)
// ---------------------------------------------------------------------------

struct Mpg123Api {
  void* lib = nullptr;
  int (*init)() = nullptr;
  void* (*newh)(const char*, int*) = nullptr;
  int (*open)(void*, const char*) = nullptr;
  int (*getformat)(void*, long*, int*, int*) = nullptr;
  int (*param)(void*, int, long, double) = nullptr;
  int (*read)(void*, unsigned char*, size_t, size_t*) = nullptr;
  int (*close)(void*) = nullptr;
  void (*del)(void*) = nullptr;

  bool load() {
    if (lib) return true;
    lib = dlopen("libmpg123.so.0", RTLD_NOW | RTLD_LOCAL);
    if (!lib) return false;
    init = reinterpret_cast<decltype(init)>(dlsym(lib, "mpg123_init"));
    newh = reinterpret_cast<decltype(newh)>(dlsym(lib, "mpg123_new"));
    open = reinterpret_cast<decltype(open)>(dlsym(lib, "mpg123_open"));
    getformat =
        reinterpret_cast<decltype(getformat)>(dlsym(lib, "mpg123_getformat"));
    param = reinterpret_cast<decltype(param)>(dlsym(lib, "mpg123_param"));
    read = reinterpret_cast<decltype(read)>(dlsym(lib, "mpg123_read"));
    close = reinterpret_cast<decltype(close)>(dlsym(lib, "mpg123_close"));
    del = reinterpret_cast<decltype(del)>(dlsym(lib, "mpg123_delete"));
    return init && newh && open && getformat && param && read && close && del;
  }
};

constexpr int kMpg123EncFloat32 = 0x200;
constexpr int kMpg123Done = -12;

bool decode_mp3(const char* path, std::vector<float>* mono, int* sample_rate) {
  static Mpg123Api api;
  if (!api.load()) {
    set_error("libmpg123 not available for mp3 decode");
    return false;
  }
  api.init();
  int err = 0;
  void* h = api.newh(nullptr, &err);
  if (!h) {
    set_error("mpg123_new failed");
    return false;
  }
  bool ok = false;
  long rate = 0;
  int channels = 0, enc = 0;
  std::vector<float> interleaved;
  // Force float32 BEFORE open: mpg123_format on an already-open stream
  // does not re-negotiate, silently yielding s16 bytes read as floats.
  // MPG123_ADD_FLAGS = 2, MPG123_FORCE_FLOAT = 0x400.
  api.param(h, 2, 0x400, 0.0);
  if (api.open(h, path) == 0 && api.getformat(h, &rate, &channels, &enc) == 0 &&
      enc == kMpg123EncFloat32) {
    std::vector<unsigned char> buf(1 << 16);
    size_t done = 0;
    int r;
    while ((r = api.read(h, buf.data(), buf.size(), &done)) == 0 || done > 0) {
      const float* p = reinterpret_cast<const float*>(buf.data());
      interleaved.insert(interleaved.end(), p, p + done / sizeof(float));
      if (r == kMpg123Done) break;
      if (r != 0 && done == 0) break;
      done = 0;
    }
    ok = !interleaved.empty();
    if (!ok) set_error("mp3 decode produced no samples");
  } else {
    set_error("mpg123 open/getformat failed");
  }
  api.close(h);
  api.del(h);
  if (!ok) return false;

  const size_t frames = interleaved.size() / channels;
  mono->resize(frames);
  for (size_t i = 0; i < frames; ++i) {
    double acc = 0;
    for (int c = 0; c < channels; ++c) acc += interleaved[i * channels + c];
    (*mono)[i] = static_cast<float>(acc / channels);
  }
  *sample_rate = static_cast<int>(rate);
  return true;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    set_error("failed to open file");
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(size);
  size_t got = std::fread(out->data(), 1, size, f);
  std::fclose(f);
  if (static_cast<long>(got) != size) {
    set_error("short read");
    return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Decode any supported file to mono f32 @16 kHz.  Returns 0 on success;
// caller frees *out with wr_free.
int wr_load_audio(const char* path, float** out, int64_t* out_len) {
  std::vector<float> mono;
  int sr = 0;

  const char* dot = std::strrchr(path, '.');
  const bool is_mp3 = dot && (std::strcmp(dot, ".mp3") == 0);

  if (is_mp3) {
    if (!decode_mp3(path, &mono, &sr)) return -1;
  } else {
    std::vector<uint8_t> data;
    if (!read_file(path, &data)) return -1;
    if (data.size() >= 4 && std::memcmp(data.data(), "fLaC", 4) == 0) {
      if (!decode_flac_mono(data, &mono, &sr)) return -1;
    } else {
      if (!parse_wav(data, &mono, &sr)) return -1;
    }
  }

  std::vector<float> res = resample(mono, sr, kTargetRate);
  *out_len = static_cast<int64_t>(res.size());
  *out = static_cast<float*>(std::malloc(res.size() * sizeof(float)));
  std::memcpy(*out, res.data(), res.size() * sizeof(float));
  return 0;
}

// Standalone resampler (for tests / pipelines with raw PCM input).
int wr_resample(const float* in, int64_t n, int sr_in, int sr_out, float** out,
                int64_t* out_len) {
  std::vector<float> v(in, in + n);
  std::vector<float> res = resample(v, sr_in, sr_out);
  *out_len = static_cast<int64_t>(res.size());
  *out = static_cast<float*>(std::malloc(res.size() * sizeof(float)));
  std::memcpy(*out, res.data(), res.size() * sizeof(float));
  return 0;
}

void wr_free(float* p) { std::free(p); }

const char* wr_last_error() { return g_error.c_str(); }

}  // extern "C"
