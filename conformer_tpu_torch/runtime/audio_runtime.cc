// The port's own copy of the JAX package's host audio runtime
// (runtime/audio_runtime.cc), its code unchanged. conformer_tpu_torch/data/
// native.py builds it with g++ at first use into build/host/ and binds it
// with ctypes; unlike the JAX package's binding, a library whose ABI
// version differs raises there instead of falling back to NumPy.
//
// Native host audio runtime: wav decode, polyphase resampling, Kaldi-style
// log-mel fbank, and a multi-threaded batch frontend.
//
// TPU-native equivalent of the reference's native data-path dependencies
// (SURVEY.md §2.3: torchaudio C++ wav IO, sox resampler, Kaldi fbank ops).
// The Python pipeline (conformer_tpu/data) calls this through ctypes
// (conformer_tpu/data/native.py) when the shared library is built
// (make -C runtime); it falls back to the NumPy implementations otherwise.
// Semantics intentionally match ops/fbank.py (same framing, dither=0 path,
// preemphasis, povey window, DFT, mel banks, log floor).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <thread>
#include <vector>

namespace {

constexpr float kLogFloor = 1.1920928955078125e-07f;  // float32 epsilon

struct MelBank {
  int num_bins = 0;
  int num_fft = 0;              // padded_window / 2
  std::vector<float> weights;   // [num_bins, num_fft]
  // sparse ranges: triangular filters touch a contiguous [start, end) run
  // of FFT bins — iterating only that run cuts the mel matmul ~50x
  std::vector<int> start, end;
};

double mel_scale(double f) { return 1127.0 * std::log(1.0 + f / 700.0); }

MelBank make_mel_banks(int num_bins, int padded, double sample_rate,
                       double low_freq, double high_freq) {
  MelBank mb;
  mb.num_bins = num_bins;
  mb.num_fft = padded / 2;
  mb.weights.assign(static_cast<size_t>(num_bins) * mb.num_fft, 0.f);
  const double nyquist = 0.5 * sample_rate;
  if (high_freq <= 0.0) high_freq = nyquist + high_freq;
  const double fft_bin_width = sample_rate / padded;
  const double mel_low = mel_scale(low_freq);
  const double mel_high = mel_scale(high_freq);
  const double mel_delta = (mel_high - mel_low) / (num_bins + 1);
  for (int b = 0; b < num_bins; ++b) {
    const double left = mel_low + b * mel_delta;
    const double center = mel_low + (b + 1) * mel_delta;
    const double right = mel_low + (b + 2) * mel_delta;
    for (int k = 0; k < mb.num_fft; ++k) {
      const double mel = mel_scale(fft_bin_width * k);
      const double up = (mel - left) / (center - left);
      const double down = (right - mel) / (right - center);
      const double w = std::min(up, down);
      if (w > 0.0) mb.weights[static_cast<size_t>(b) * mb.num_fft + k] =
          static_cast<float>(w);
    }
  }
  mb.start.resize(num_bins);
  mb.end.resize(num_bins);
  for (int b = 0; b < num_bins; ++b) {
    int s = 0, e = mb.num_fft;
    const float* w = &mb.weights[static_cast<size_t>(b) * mb.num_fft];
    while (s < mb.num_fft && w[s] == 0.f) ++s;
    while (e > s && w[e - 1] == 0.f) --e;
    mb.start[b] = s;
    mb.end[b] = e;
  }
  return mb;
}

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Iterative in-place radix-2 FFT over interleaved complex data.
void fft_radix2(std::vector<float>& re, std::vector<float>& im) {
  const int n = static_cast<int>(re.size());
  for (int i = 1, j = 0; i < n; ++i) {
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  // Twiddles precomputed in double precision (a float32 recurrence leaks
  // ~-40 dB error into near-silent bins, visible after the mel log).
  static thread_local std::vector<float> tw_r, tw_i;
  static thread_local int tw_n = -1;
  if (tw_n != n) {
    tw_r.resize(n / 2);
    tw_i.resize(n / 2);
    for (int k = 0; k < n / 2; ++k) {
      const double ang = -2.0 * M_PI * k / n;
      tw_r[k] = static_cast<float>(std::cos(ang));
      tw_i[k] = static_cast<float>(std::sin(ang));
    }
    tw_n = n;
  }
  for (int len = 2; len <= n; len <<= 1) {
    const int stride = n / len;
    for (int i = 0; i < n; i += len) {
      for (int k = 0; k < len / 2; ++k) {
        const float cur_r = tw_r[k * stride];
        const float cur_i = tw_i[k * stride];
        const float ur = re[i + k], ui = im[i + k];
        const float vr = re[i + k + len / 2] * cur_r - im[i + k + len / 2] * cur_i;
        const float vi = re[i + k + len / 2] * cur_i + im[i + k + len / 2] * cur_r;
        re[i + k] = ur + vr;
        im[i + k] = ui + vi;
        re[i + k + len / 2] = ur - vr;
        im[i + k + len / 2] = ui - vi;
      }
    }
  }
}

// Counter-based Gaussian noise for dither: stateless splitmix64 hash of
// (seed, counter) -> Box-Muller. Thread-safe and reproducible regardless of
// which worker thread processes which frame (unlike a shared RNG stream),
// which is what lets the multi-threaded batch frontend serve the training
// recipe's dither=0.1 deterministically.
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

inline float gauss_at(uint64_t seed, uint64_t counter) {
  const uint64_t r = splitmix64(seed ^ splitmix64(counter));
  // two 32-bit uniforms in (0, 1]
  const double u1 = ((r >> 32) + 1.0) * (1.0 / 4294967296.0);
  const double u2 = ((r & 0xffffffffULL) + 1.0) * (1.0 / 4294967296.0);
  return static_cast<float>(std::sqrt(-2.0 * std::log(u1)) *
                            std::cos(2.0 * M_PI * u2));
}

// Two Gaussians per splitmix64 draw (Box-Muller cos+sin pair).
inline void gauss_pair(uint64_t seed, uint64_t counter, float* z0, float* z1) {
  const uint64_t r = splitmix64(seed ^ splitmix64(counter));
  // float math throughout: dither noise needs no double precision
  const float u1 = ((r >> 32) + 1.0f) * (1.0f / 4294967296.0f);
  const float u2 = ((r & 0xffffffffULL) + 1.0f) * (1.0f / 4294967296.0f);
  const float rad = std::sqrt(-2.0f * std::log(u1));
  float s, c;
  sincosf(6.2831853071795864f * u2, &s, &c);
  *z0 = rad * c;
  *z1 = rad * s;
}

void fbank_one(const float* wave, int64_t n, float sample_rate, int num_bins,
               float frame_length_ms, float frame_shift_ms, const MelBank& mb,
               const std::vector<float>& window, int ws, int shift, int padded,
               float dither, uint64_t seed,
               float* out /* [T, num_bins] */, int64_t t_frames) {
  // Real-input FFT via a half-size complex FFT: pack even/odd samples as
  // (re, im) of an N/2 complex sequence, FFT, then unpack with one
  // O(N) twiddle pass — ~2x over the naive zero-padded complex FFT.
  const int half = padded / 2;
  std::vector<float> re(half), im(half);
  std::vector<float> frame(ws);
  std::vector<float> power(mb.num_fft);
  // unpack twiddles for the half-size trick
  static thread_local std::vector<float> uw_r, uw_i;
  static thread_local int uw_n = -1;
  if (uw_n != padded) {
    uw_r.resize(half);
    uw_i.resize(half);
    for (int k = 0; k < half; ++k) {
      const double ang = -2.0 * M_PI * k / padded;
      uw_r[k] = static_cast<float>(std::cos(ang));
      uw_i[k] = static_cast<float>(std::sin(ang));
    }
    uw_n = padded;
  }
  for (int64_t t = 0; t < t_frames; ++t) {
    const float* src = wave + t * shift;
    // copy + optional dither + remove DC. Dither is drawn per (frame,
    // in-frame sample) like Kaldi / ops/fbank.py:126-130 — overlapping
    // samples of adjacent frames get independent noise.
    if (dither != 0.0f) {
      const uint64_t base = static_cast<uint64_t>(t) * ws;
      int i = 0;
      for (; i + 1 < ws; i += 2) {
        float z0, z1;
        gauss_pair(seed, base + i, &z0, &z1);
        frame[i] = src[i] + dither * z0;
        frame[i + 1] = src[i + 1] + dither * z1;
      }
      if (i < ws) {
        float z0, z1;
        gauss_pair(seed, base + i, &z0, &z1);
        frame[i] = src[i] + dither * z0;
      }
    } else {
      std::copy(src, src + ws, frame.begin());
    }
    double mean = 0.0;
    for (int i = 0; i < ws; ++i) mean += frame[i];
    mean /= ws;
    for (int i = 0; i < ws; ++i) frame[i] = static_cast<float>(frame[i] - mean);
    // preemphasis 0.97 (first sample replicated), povey window
    for (int i = ws - 1; i > 0; --i)
      frame[i] = (frame[i] - 0.97f * frame[i - 1]) * window[i];
    frame[0] = (frame[0] - 0.97f * frame[0]) * window[0];
    // pack even/odd -> half-size complex FFT
    std::fill(re.begin(), re.end(), 0.f);
    std::fill(im.begin(), im.end(), 0.f);
    for (int i = 0; i * 2 < ws; ++i) re[i] = frame[2 * i];
    for (int i = 0; i * 2 + 1 < ws; ++i) im[i] = frame[2 * i + 1];
    fft_radix2(re, im);
    // unpack bins 0..half-1 of the full real FFT and take the power
    // spectrum ONCE (the old code recomputed it per mel bin)
    // X[k] = E + O*W, with E/O the even/odd half-spectra:
    //   E[k] = (Z[k] + conj(Z[half-k])) / 2
    //   O[k] = (Z[k] - conj(Z[half-k])) / (2i)
    power[0] = (re[0] + im[0]) * (re[0] + im[0]);  // X[0] = sum of all
    for (int k = 1; k < mb.num_fft; ++k) {
      const int kr = half - k;
      const float zr = re[k], zi = im[k];
      const float yr = re[kr], yi = im[kr];
      const float er = 0.5f * (zr + yr), ei = 0.5f * (zi - yi);
      const float or_ = 0.5f * (zi + yi), oi = -0.5f * (zr - yr);
      const float xr = er + or_ * uw_r[k] - oi * uw_i[k];
      const float xi = ei + or_ * uw_i[k] + oi * uw_r[k];
      power[k] = xr * xr + xi * xi;
    }
    // sparse mel: each triangular filter only touches [start, end)
    for (int b = 0; b < num_bins; ++b) {
      const float* w = &mb.weights[static_cast<size_t>(b) * mb.num_fft];
      float acc = 0.f;
      for (int k = mb.start[b]; k < mb.end[b]; ++k) acc += w[k] * power[k];
      out[t * num_bins + b] = std::log(std::max(acc, kLogFloor));
    }
  }
}

}  // namespace

extern "C" {

// ABI version of the exported crt_* surface. Bump whenever any signature
// changes (v2: crt_fbank/crt_fbank_batch grew dither + seed parameters).
// The ctypes loader (conformer_tpu/data/native.py) refuses to bind a
// library whose version mismatches, falling back to the NumPy path instead
// of calling a stale .so with the wrong argument layout.
int32_t crt_abi_version() { return 2; }

// ---- WAV decode (PCM16/PCM8/float32, mono-mixdown) ----------------------
// Returns number of samples written to `out` (query with out == nullptr),
// sets *sample_rate. Returns -1 on parse failure.
int64_t crt_decode_wav(const uint8_t* data, int64_t size, float* out,
                       int32_t* sample_rate) {
  if (size < 44 || std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "WAVE", 4))
    return -1;
  int64_t pos = 12;
  int16_t audio_format = 0, channels = 0, bits = 0;
  int32_t rate = 0;
  const uint8_t* payload = nullptr;
  int64_t payload_size = 0;
  while (pos + 8 <= size) {
    const char* id = reinterpret_cast<const char*>(data + pos);
    uint32_t chunk_size;
    std::memcpy(&chunk_size, data + pos + 4, 4);
    const uint8_t* body = data + pos + 8;
    if (!std::memcmp(id, "fmt ", 4) && chunk_size >= 16) {
      std::memcpy(&audio_format, body, 2);
      std::memcpy(&channels, body + 2, 2);
      std::memcpy(&rate, body + 4, 4);
      std::memcpy(&bits, body + 14, 2);
    } else if (!std::memcmp(id, "data", 4)) {
      payload = body;
      payload_size = std::min<int64_t>(chunk_size, size - pos - 8);
    }
    pos += 8 + chunk_size + (chunk_size & 1);
  }
  if (!payload || channels <= 0 || rate <= 0) return -1;
  *sample_rate = rate;
  int64_t frames;
  if ((audio_format == 1 && bits == 16)) frames = payload_size / (2 * channels);
  else if (audio_format == 1 && bits == 8) frames = payload_size / channels;
  else if (audio_format == 3 && bits == 32) frames = payload_size / (4 * channels);
  else return -1;
  if (!out) return frames;
  for (int64_t f = 0; f < frames; ++f) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) {
      if (bits == 16) {
        int16_t s;
        std::memcpy(&s, payload + (f * channels + c) * 2, 2);
        acc += s / 32768.0;
      } else if (bits == 8) {
        acc += (payload[f * channels + c] - 128) / 128.0;
      } else {
        float s;
        std::memcpy(&s, payload + (f * channels + c) * 4, 4);
        acc += s;
      }
    }
    out[f] = static_cast<float>(acc / channels);
  }
  return frames;
}

// ---- polyphase-ish resampler (windowed-sinc) ----------------------------
// Returns output length (query with out == nullptr).
int64_t crt_resample(const float* in, int64_t n, int32_t in_rate,
                     int32_t out_rate, float* out) {
  if (in_rate == out_rate) {
    if (out) std::memcpy(out, in, n * sizeof(float));
    return n;
  }
  const double ratio = static_cast<double>(out_rate) / in_rate;
  const int64_t out_n = static_cast<int64_t>(std::floor(n * ratio));
  if (!out) return out_n;
  const double cutoff = 0.95 * 0.5 * std::min(in_rate, out_rate);
  const int half_taps = 24;
  for (int64_t i = 0; i < out_n; ++i) {
    const double center = i / ratio;
    const int64_t lo = std::max<int64_t>(0, static_cast<int64_t>(center) - half_taps);
    const int64_t hi = std::min<int64_t>(n - 1, static_cast<int64_t>(center) + half_taps);
    double acc = 0.0, norm = 0.0;
    for (int64_t j = lo; j <= hi; ++j) {
      const double x = (center - j) * 2.0 * cutoff / in_rate;
      double sinc = (std::abs(x) < 1e-9) ? 1.0 : std::sin(M_PI * x) / (M_PI * x);
      const double u = (j - center) / (half_taps + 1);
      const double win = (std::abs(u) <= 1.0) ? 0.5 * (1.0 + std::cos(M_PI * u)) : 0.0;
      const double w = sinc * win;
      acc += w * in[j];
      norm += w;
    }
    out[i] = static_cast<float>(norm > 1e-12 ? acc / norm : 0.0);
  }
  return out_n;
}

// ---- fbank ---------------------------------------------------------------
// wave: [n] float already scaled by 2**15. out: [T, num_bins] float32.
// Returns T (query with out == nullptr).
int64_t crt_fbank(const float* wave, int64_t n, float sample_rate,
                  int32_t num_bins, float frame_length_ms,
                  float frame_shift_ms, float dither, uint64_t seed,
                  float* out) {
  const int ws = static_cast<int>(sample_rate * frame_length_ms * 0.001f);
  const int shift = static_cast<int>(sample_rate * frame_shift_ms * 0.001f);
  if (n < ws) return 0;
  const int64_t t_frames = 1 + (n - ws) / shift;
  if (!out) return t_frames;
  const int padded = next_pow2(ws);
  static thread_local MelBank mb;
  static thread_local int mb_bins = -1, mb_padded = -1;
  static thread_local float mb_rate = -1;
  if (mb_bins != num_bins || mb_padded != padded || mb_rate != sample_rate) {
    mb = make_mel_banks(num_bins, padded, sample_rate, 20.0, 0.0);
    mb_bins = num_bins;
    mb_padded = padded;
    mb_rate = sample_rate;
  }
  std::vector<float> window(ws);
  for (int i = 0; i < ws; ++i) {
    const double hann = 0.5 - 0.5 * std::cos(2.0 * M_PI * i / (ws - 1));
    window[i] = static_cast<float>(std::pow(hann, 0.85));
  }
  fbank_one(wave, n, sample_rate, num_bins, frame_length_ms, frame_shift_ms,
            mb, window, ws, shift, padded, dither, seed, out, t_frames);
  return t_frames;
}

// ---- multi-threaded batch fbank -----------------------------------------
// waves: concatenated [total]; offsets/lengths per utterance (B of them);
// outs: concatenated [sum_t * num_bins]; out_offsets: per-utterance frame
// offsets (precomputed by the caller from crt_fbank length queries).
void crt_fbank_batch(const float* waves, const int64_t* offsets,
                     const int64_t* lengths, int32_t batch,
                     float sample_rate, int32_t num_bins,
                     float frame_length_ms, float frame_shift_ms,
                     float dither, uint64_t seed,
                     float* outs, const int64_t* out_offsets,
                     int32_t num_threads) {
  std::atomic<int32_t> next{0};
  auto worker = [&]() {
    for (;;) {
      const int32_t i = next.fetch_add(1);
      if (i >= batch) return;
      // per-utterance counter-based seed: identical output no matter how
      // utterances land on threads
      crt_fbank(waves + offsets[i], lengths[i], sample_rate, num_bins,
                frame_length_ms, frame_shift_ms, dither,
                seed ^ splitmix64(static_cast<uint64_t>(i) + 1),
                outs + out_offsets[i] * num_bins);
    }
  };
  const int nt = std::max(1, static_cast<int>(num_threads));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // extern "C"
