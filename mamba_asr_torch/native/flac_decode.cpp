// Decode-only FLAC reader (native, no external deps), and the speed
// perturbation's resamplers.
//
// The PyTorch port's copy of mamba_asr_tpu/native/flac_decode.cpp, byte
// for byte in every function: built with the same flags
// (mamba_asr_torch/native/build.py), it decodes and resamples to the same
// bits. LibriSpeech ships FLAC and the port has no other FLAC backend.
//
// Supported: the full FLAC subset LibriSpeech uses and more —
//   - STREAMINFO + skipped metadata blocks,
//   - fixed-blocksize and variable-blocksize frames,
//   - subframe types: CONSTANT, VERBATIM, FIXED (orders 0-4), LPC (1-32),
//   - rice residual coding (partition orders, both RICE and RICE2,
//     escape-to-raw partitions),
//   - wasted bits,
//   - channel assignments: independent, left/side, right/side, mid/side
//     (output is downmixed to mono float32, matching data/audio.py).
// Not verified: CRCs (skipped for speed; decode correctness is covered by
// the subframe math itself).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// MSB-first bit reader with a 64-bit cached accumulator: bulk 8-byte
// refills + clz-based unary decode instead of per-bit loops (~4x on the
// rice/LPC hot path, which is the loader's host bottleneck).
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;       // next byte to load into the cache
  uint64_t cache = 0;   // unread bits, left-aligned (MSB first)
  int ncache = 0;       // valid bits at the top of `cache`
  bool error = false;

  void seek(size_t byte_pos) {
    pos = byte_pos;
    cache = 0;
    ncache = 0;
  }

  size_t byte_pos() const {  // valid only when bit-aligned
    return pos - (size_t)(ncache >> 3);
  }

  void fill() {
    while (ncache <= 56 && pos < size) {
      cache |= (uint64_t)data[pos++] << (56 - ncache);
      ncache += 8;
    }
  }

  uint64_t read_bits(int n) {
    if (n <= 0) return 0;
    if (n > 32) return (read_bits(n - 32) << 32) | read_bits(32);
    if (ncache < n) {
      fill();
      if (ncache < n) {  // past EOF: flag and zero-pad
        error = true;
        uint64_t v = ncache ? cache >> (64 - ncache) : 0;
        v <<= (n - ncache);
        cache = 0;
        ncache = 0;
        return v;
      }
    }
    uint64_t v = cache >> (64 - n);
    cache <<= n;
    ncache -= n;
    return v;
  }

  uint32_t read_bit() { return (uint32_t)read_bits(1); }

  int64_t read_signed(int n) {
    if (n == 0) return 0;
    uint64_t v = read_bits(n);
    uint64_t sign = 1ull << (n - 1);
    return (v & sign) ? (int64_t)(v | ~((sign << 1) - 1)) : (int64_t)v;
  }

  uint32_t read_unary() {
    uint32_t n = 0;
    for (;;) {
      if (ncache == 0) {
        fill();
        if (ncache == 0) {
          error = true;
          return n;
        }
      }
      int lz = cache ? __builtin_clzll(cache) : 64;
      if (lz >= ncache) {  // zeros run to the end of the cache
        n += ncache;
        cache = 0;
        ncache = 0;
        continue;
      }
      n += lz;
      cache <<= lz + 1;
      ncache -= lz + 1;
      return n;
    }
  }

  bool aligned_skip() {  // align to byte boundary
    int drop = ncache & 7;
    cache <<= drop;
    ncache -= drop;
    return byte_pos() <= size;
  }
};

// UTF-8-style coded number (frame header sample/frame number).
uint64_t read_utf8(BitReader& br) {
  uint64_t b0 = br.read_bits(8);
  if ((b0 & 0x80) == 0) return b0;
  int n = 0;
  for (uint64_t m = 0x40; b0 & m; m >>= 1) ++n;
  uint64_t v = b0 & ((1ull << (6 - n)) - 1);
  for (int i = 0; i < n; ++i) v = (v << 6) | (br.read_bits(8) & 0x3F);
  return v;
}

const int kBlockSizes[16] = {0,    192,   576,   1152,  2304, 4608, -1, -2,
                             256,  512,   1024,  2048,  4096, 8192, 16384,
                             32768};

bool decode_residual(BitReader& br, int order, int block_size,
                     int64_t* out /* block_size entries, first `order`
                                     already filled */) {
  int method = (int)br.read_bits(2);
  if (method > 1) return false;
  int rice_esc = method == 0 ? 15 : 31;
  int param_bits = method == 0 ? 4 : 5;
  int part_order = (int)br.read_bits(4);
  int parts = 1 << part_order;
  int samples_per_part = block_size >> part_order;
  if (samples_per_part << part_order != block_size) return false;
  int idx = order;
  for (int p = 0; p < parts; ++p) {
    int count = samples_per_part - (p == 0 ? order : 0);
    if (count < 0) return false;
    int param = (int)br.read_bits(param_bits);
    if (param == rice_esc) {
      int raw_bits = (int)br.read_bits(5);
      for (int i = 0; i < count; ++i) out[idx++] = br.read_signed(raw_bits);
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint64_t r = br.read_bits(param);
        uint64_t u = ((uint64_t)q << param) | r;
        out[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
    if (br.error) return false;
  }
  return idx == block_size;
}

bool decode_subframe(BitReader& br, int block_size, int bps,
                     std::vector<int64_t>& out) {
  out.resize(block_size);
  if (br.read_bit() != 0) return false;  // zero padding bit
  int type = (int)br.read_bits(6);
  int wasted = 0;
  if (br.read_bit()) wasted = 1 + (int)br.read_unary();
  bps -= wasted;

  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < block_size; ++i) out[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED order 0-4
    int order = type - 8;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    if (!decode_residual(br, order, block_size, out.data())) return false;
    for (int i = order; i < block_size; ++i) {
      switch (order) {
        case 0:
          break;
        case 1:
          out[i] += out[i - 1];
          break;
        case 2:
          out[i] += 2 * out[i - 1] - out[i - 2];
          break;
        case 3:
          out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
          break;
        case 4:
          out[i] +=
              4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4];
          break;
      }
    }
  } else if (type >= 32) {  // LPC order 1-32
    int order = type - 31;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    int precision = (int)br.read_bits(4) + 1;
    if (precision == 16) return false;  // invalid code 1111
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; ++i) coef[i] = br.read_signed(precision);
    if (!decode_residual(br, order, block_size, out.data())) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coef[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    return false;
  }
  if (wasted) {
    for (int i = 0; i < block_size; ++i) out[i] <<= wasted;
  }
  return !br.error;
}

}  // namespace

extern "C" {

// Decode a FLAC file into mono float32. Returns number of samples
// written (<= max_samples), or -1 on error. sample_rate_out receives the
// stream sample rate. Pass out == nullptr to query the total length.
int64_t flac_decode_file(const char* path, float* out, int64_t max_samples,
                         int32_t* sample_rate_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(fsize);
  if (fread(buf.data(), 1, fsize, f) != (size_t)fsize) {
    fclose(f);
    return -1;
  }
  fclose(f);
  if (fsize < 42 || memcmp(buf.data(), "fLaC", 4) != 0) return -1;

  size_t pos = 4;
  uint32_t sample_rate = 0;
  int channels = 0, bps = 0;
  uint64_t total_samples = 0;
  bool last = false;
  while (!last && pos + 4 <= (size_t)fsize) {
    last = buf[pos] & 0x80;
    int type = buf[pos] & 0x7F;
    uint32_t len =
        (buf[pos + 1] << 16) | (buf[pos + 2] << 8) | buf[pos + 3];
    pos += 4;
    if (type == 0 && len >= 34) {  // STREAMINFO
      const uint8_t* si = buf.data() + pos;
      sample_rate = (si[10] << 12) | (si[11] << 4) | (si[12] >> 4);
      channels = ((si[12] >> 1) & 0x7) + 1;
      bps = (((si[12] & 1) << 4) | (si[13] >> 4)) + 1;
      total_samples = ((uint64_t)(si[13] & 0x0F) << 32) | (si[14] << 24) |
                      (si[15] << 16) | (si[16] << 8) | si[17];
    }
    pos += len;
  }
  if (sample_rate == 0 || channels == 0) return -1;
  if (sample_rate_out) *sample_rate_out = (int32_t)sample_rate;
  if (out == nullptr) return (int64_t)total_samples;

  BitReader br{buf.data(), (size_t)fsize};

  std::vector<std::vector<int64_t>> ch(channels);
  int64_t written = 0;
  float scale = 1.0f / (float)(1ll << (bps - 1));

  size_t scan = pos;  // byte cursor for frame-sync scanning
  while (written < max_samples && scan + 4 < (size_t)fsize) {
    // Frame sync: 11111111 111110xx.
    if (buf[scan] != 0xFF || (buf[scan + 1] & 0xFC) != 0xF8) {
      ++scan;  // resync scan
      continue;
    }
    br.seek(scan);
    br.read_bits(14);               // sync
    br.read_bit();                  // reserved
    br.read_bit();                  // blocking strategy
    int bs_code = (int)br.read_bits(4);
    int sr_code = (int)br.read_bits(4);
    int ch_assign = (int)br.read_bits(4);
    int ss_code = (int)br.read_bits(3);
    br.read_bit();  // reserved
    read_utf8(br);  // frame/sample number

    int block_size;
    if (bs_code == 0) return -1;
    block_size = kBlockSizes[bs_code];
    if (block_size == -1)
      block_size = (int)br.read_bits(8) + 1;
    else if (block_size == -2)
      block_size = (int)br.read_bits(16) + 1;

    if (sr_code == 12)
      br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14)
      br.read_bits(16);

    int frame_bps = bps;
    static const int kBps[8] = {0, 8, 12, 0, 16, 20, 24, 32};
    if (ss_code != 0 && kBps[ss_code]) frame_bps = kBps[ss_code];

    br.read_bits(8);  // CRC-8 (unchecked)
    if (br.error) return written;

    int nch = channels;
    bool left_side = false, right_side = false, mid_side = false;
    if (ch_assign >= 8 && ch_assign <= 10) {
      nch = 2;
      left_side = ch_assign == 8;
      right_side = ch_assign == 9;
      mid_side = ch_assign == 10;
    } else {
      nch = ch_assign + 1;
    }

    bool ok = true;
    for (int c = 0; c < nch && ok; ++c) {
      int sub_bps = frame_bps;
      // The "side" channel carries one extra bit.
      if ((left_side && c == 1) || (right_side && c == 0) ||
          (mid_side && c == 1))
        sub_bps += 1;
      if ((size_t)c >= ch.size()) ch.resize(c + 1);
      ok = decode_subframe(br, block_size, sub_bps, ch[c]);
    }
    if (!ok) return written;
    br.aligned_skip();
    br.read_bits(16);  // CRC-16 (unchecked)
    scan = br.byte_pos();  // aligned: resume scanning after this frame

    // Channel reconstruction + mono downmix (mean over channels).
    for (int i = 0; i < block_size && written < max_samples; ++i) {
      int64_t sum;  // sum over reconstructed channels
      if (nch == 1) {
        sum = ch[0][i];
      } else if (left_side) {
        int64_t l = ch[0][i], s = ch[1][i];
        sum = l + (l - s);  // r = l - s
      } else if (right_side) {
        int64_t s = ch[0][i], r = ch[1][i];
        sum = (r + s) + r;  // l = r + s
      } else if (mid_side) {
        int64_t m = ch[0][i], s = ch[1][i];
        int64_t m2 = (m << 1) | (s & 1);
        int64_t l = (m2 + s) >> 1;
        int64_t r = (m2 - s) >> 1;
        sum = l + r;
      } else {
        sum = 0;
        for (int c = 0; c < nch; ++c) sum += ch[c][i];
      }
      out[written++] = (float)sum * scale / (float)nch;
    }
  }
  return written;
}

// Linear resample by playback factor (speed perturb: factor 1.05 ->
// faster -> shorter). Matches numpy.interp semantics on positions
// i * factor: out[i] lerps in[floor(p)]..in[floor(p)+1], clamped at the
// final sample. Lives here (not Python) so the loader's whole
// per-utterance hot path — decode + perturb — is GIL-free native code
// and scales across dataloader threads on many-core TPU hosts.
int64_t linear_resample(const float* in, int64_t n_in, double factor,
                        float* out, int64_t max_out) {
  if (n_in <= 0) return 0;
  int64_t n_out = (int64_t)(n_in / factor + 0.5);
  if (n_out > max_out) n_out = max_out;
  for (int64_t i = 0; i < n_out; ++i) {
    double p = i * factor;
    int64_t j = (int64_t)p;
    if (j >= n_in - 1) {
      out[i] = in[n_in - 1];
    } else {
      double f = p - j;
      out[i] = (float)((1.0 - f) * in[j] + f * in[j + 1]);
    }
  }
  return n_out;
}

// Windowed-sinc resample by playback factor — the quality class of the
// reference recipe's SpeedPerturb (speechbrain Resample: Kaldi-style
// lowpass sinc with a Hann window, lowpass_filter_width taps each side of
// the cutoff period; hparams/CTC/conmamba_large.yaml's speed_perturb).
// Linear interpolation folds the whole spectrum above Nyquist/2 back as
// aliasing; this kernel low-passes at 0.99 * Nyquist(min(in, out)) first.
//
// out[i] = sum_j in[j] * h(j - i*factor),
//   h(x) = 2 fc sinc(2 fc x) * 0.5 (1 + cos(pi x / support)), |x| < support
//   fc = 0.99 * 0.5 * min(1, 1/factor)   [cycles per input sample]
//   support = width / (2 fc)
//
// For the rational factors speed perturb uses (19/20, 21/20), the tap
// phases repeat with period <= 64: the filter bank is precomputed once
// (polyphase) and the inner loop is pure multiply-adds. Irrational
// factors fall back to direct kernel evaluation.
int64_t sinc_resample(const float* in, int64_t n_in, double factor,
                      float* out, int64_t max_out, int32_t width) {
  if (n_in <= 0 || factor <= 0.0) return 0;
  if (width <= 0) width = 6;  // speechbrain Resample default
  const double fc = 0.99 * 0.5 * (factor > 1.0 ? 1.0 / factor : 1.0);
  const double support = width / (2.0 * fc);
  const int64_t half = (int64_t)std::ceil(support);
  int64_t n_out = (int64_t)(n_in / factor + 0.5);
  if (n_out > max_out) n_out = max_out;

  auto kernel = [&](double x) -> double {
    if (std::fabs(x) >= support) return 0.0;
    double window = 0.5 * (1.0 + std::cos(M_PI * x / support));
    double s = (x == 0.0)
                   ? 2.0 * fc
                   : std::sin(2.0 * M_PI * fc * x) / (M_PI * x);
    return s * window;
  };

  // Rational factor q/p with p <= 64 -> p-phase filter bank.
  int64_t p = 0, q = 0;
  for (int64_t den = 1; den <= 64; ++den) {
    double num = factor * (double)den;
    double r = std::llround(num);
    if (std::fabs(num - r) < 1e-9) { p = den; q = (int64_t)r; break; }
  }
  const int taps = (int)(2 * half + 1);
  if (p > 0) {
    std::vector<double> coef((size_t)p * taps);
    for (int64_t r = 0; r < p; ++r) {
      double t = (double)(r * q) / (double)p;
      double frac = t - std::floor(t);
      for (int k = 0; k < taps; ++k)
        coef[(size_t)r * taps + k] = kernel((double)(k - half) - frac);
    }
    for (int64_t i = 0; i < n_out; ++i) {
      int64_t t_num = i * q;  // center = t_num / p input samples
      int64_t j0 = t_num / p - half;
      const double* c = &coef[(size_t)(i % p) * taps];
      double acc = 0.0;
      int k0 = (int)(j0 < 0 ? -j0 : 0);
      int k1 = (int)(j0 + taps > n_in ? n_in - j0 : taps);
      for (int k = k0; k < k1; ++k) acc += c[k] * in[j0 + k];
      out[i] = (float)acc;
    }
  } else {
    for (int64_t i = 0; i < n_out; ++i) {
      double t = (double)i * factor;
      int64_t j0 = (int64_t)std::floor(t) - half;
      double acc = 0.0;
      for (int k = 0; k < taps; ++k) {
        int64_t j = j0 + k;
        if (j >= 0 && j < n_in) acc += kernel((double)j - t) * in[j];
      }
      out[i] = (float)acc;
    }
  }
  return n_out;
}

}  // extern "C"
