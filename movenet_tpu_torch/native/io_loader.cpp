// movenet_tpu_torch native IO/preprocess runtime (host CPU, no device
// code): the port's own copy of movenet_tpu/native/io_loader.cpp, which it
// follows line for line.
//
// The reference's input pipeline runs per-example video decode +
// resize + audio resample in Python on dataloader worker processes
// (dataset.py:162-310).  This library provides the same preprocessing
// as C callables that release the Python GIL (ctypes calls drop the
// GIL), so a plain Python thread pool gets true multi-core decode:
//
//   mn_preprocess_video : uint8 (F,H,W,C) -> float32 (nf,64,64,1)
//                         grayscale (ITU-R 601, truncated like
//                         torchvision on uint8) + bilinear resize
//                         (align_corners=false, pixel centers) +
//                         uniform temporal subsample (linspace, truncated)
//   mn_preprocess_audio : float32 (ch,S) -> int32 mu-law codes (T)
//                         channel mean + polyphase sinc/Hann resample
//                         (torchaudio semantics, matching
//                         movenet_tpu_torch/ops/resample.py) + min-max
//                         normalize + mu-law encode
//
// Build: python -m movenet_tpu_torch.native.build (into
// build/movenet_tpu_torch/native/).  Python binding:
// movenet_tpu_torch/native/loader.py (ctypes).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <numeric>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

inline float luma(float r, float g, float b) {
  return 0.2989f * r + 0.587f * g + 0.114f * b;
}

// ---------------------------------------------------------------- video
void bilinear_resize(const float* src, int h, int w, float* dst, int oh,
                     int ow) {
  for (int oy = 0; oy < oh; ++oy) {
    double ys = (oy + 0.5) * h / oh - 0.5;
    long y0 = std::clamp<long>((long)std::floor(ys), 0, h - 1);
    long y1 = std::clamp<long>(y0 + 1, 0, h - 1);
    float wy = (float)std::clamp(ys - (double)y0, 0.0, 1.0);
    for (int ox = 0; ox < ow; ++ox) {
      double xs = (ox + 0.5) * w / ow - 0.5;
      long x0 = std::clamp<long>((long)std::floor(xs), 0, w - 1);
      long x1 = std::clamp<long>(x0 + 1, 0, w - 1);
      float wx = (float)std::clamp(xs - (double)x0, 0.0, 1.0);
      float top = src[y0 * w + x0] * (1 - wx) + src[y0 * w + x1] * wx;
      float bot = src[y1 * w + x0] * (1 - wx) + src[y1 * w + x1] * wx;
      dst[oy * ow + ox] = top * (1 - wy) + bot * wy;
    }
  }
}

// ---------------------------------------------------------------- audio
struct ResamplePlan {
  int width = 0;            // tap half-width (input samples)
  int taps = 0;             // 2*width + 2 (static support bound)
  int orig = 0, fresh = 0;  // gcd-reduced rates
  // per-phase weights: fresh rows x taps; first tap offset per phase
  std::vector<double> weights;
  std::vector<long> d0;
};

std::mutex g_plan_mu;
std::map<std::pair<long, long>, ResamplePlan> g_plans;

const ResamplePlan& get_plan(long orig_freq, long new_freq,
                             int lowpass = 6, double rolloff = 0.99) {
  std::lock_guard<std::mutex> lock(g_plan_mu);
  auto key = std::make_pair(orig_freq, new_freq);
  auto it = g_plans.find(key);
  if (it != g_plans.end()) return it->second;

  ResamplePlan p;
  long g = std::gcd(orig_freq, new_freq);
  p.orig = (int)(orig_freq / g);
  p.fresh = (int)(new_freq / g);
  double base = std::min(p.orig, p.fresh) * rolloff;
  p.width = (int)std::ceil(lowpass * p.orig / base);
  p.taps = 2 * p.width + 2;
  p.weights.assign((size_t)p.fresh * p.taps, 0.0);
  p.d0.assign(p.fresh, 0);
  double scale = base / p.orig;
  for (int ph = 0; ph < p.fresh; ++ph) {
    double frac = (double)ph * p.orig / p.fresh;
    long d0 = (long)((long long)ph * p.orig / p.fresh) - p.width;
    p.d0[ph] = d0;
    for (int r = 0; r < p.taps; ++r) {
      double t = ((double)(d0 + r) - frac) / p.orig * base;
      if (std::abs(t) >= lowpass) continue;
      double tc = std::clamp(t, (double)-lowpass, (double)lowpass);
      double window = std::cos(tc * kPi / lowpass / 2.0);
      window *= window;
      double tp = tc * kPi;
      double sinc = tp == 0.0 ? 1.0 : std::sin(tp) / tp;
      p.weights[(size_t)ph * p.taps + r] = sinc * window * scale;
    }
  }
  return g_plans.emplace(key, std::move(p)).first->second;
}

}  // namespace

extern "C" {

// API version for the ctypes binding to sanity-check.
int mn_api_version() { return 1; }

// video: (frames, h, w, c) uint8, c in {1, 3} -> out (num_out, oh, ow)
// float32 (caller adds the trailing channel dim).  Returns 0 on success.
int mn_preprocess_video(const uint8_t* video, long frames, long h, long w,
                        long c, long num_out, long oh, long ow,
                        float* out) {
  if (frames <= 0 || (c != 1 && c != 3)) return 1;
  std::vector<long> idx(num_out);
  for (long i = 0; i < num_out; ++i) {
    double pos = num_out == 1 ? 0.0
                              : (double)i * (frames - 1) / (num_out - 1);
    // torch .long() truncates toward zero (pytorchvideo semantics)
    idx[i] = std::clamp<long>((long)pos, 0, frames - 1);
  }
  std::vector<float> gray((size_t)h * w);
  std::vector<float> resized((size_t)oh * ow);
  for (long i = 0; i < num_out; ++i) {
    const uint8_t* f = video + (size_t)idx[i] * h * w * c;
    if (c == 3) {
      for (long px = 0; px < h * w; ++px) {
        // match torchvision: cast back to uint8 (truncation) before
        // further float use
        gray[px] = std::trunc(
            luma(f[px * 3], f[px * 3 + 1], f[px * 3 + 2]));
      }
    } else {
      for (long px = 0; px < h * w; ++px) gray[px] = f[px];
    }
    bilinear_resize(gray.data(), (int)h, (int)w, resized.data(), (int)oh,
                    (int)ow);
    std::memcpy(out + (size_t)i * oh * ow, resized.data(),
                sizeof(float) * oh * ow);
  }
  return 0;
}

// audio: (channels, samples) float32 -> (target) int32 mu-law codes.
int mn_preprocess_audio(const float* audio, long channels, long samples,
                        long target, int quantization_channels,
                        int normalize, int32_t* out) {
  if (samples <= 0 || channels <= 0) return 1;
  // channel mean (dataset.py:258)
  std::vector<float> mono(samples);
  if (channels == 1) {
    std::memcpy(mono.data(), audio, sizeof(float) * samples);
  } else {
    for (long i = 0; i < samples; ++i) {
      double acc = 0;
      for (long ch = 0; ch < channels; ++ch)
        acc += audio[ch * samples + i];
      mono[i] = (float)(acc / channels);
    }
  }

  // sinc resample: orig_freq = len(x) (the reference's unusual call,
  // dataset.py:259)
  std::vector<float> res(target);
  if (samples == target) {
    res = mono;
  } else {
    const ResamplePlan& p = get_plan(samples, target);
    long t_out = (long)std::ceil((double)p.fresh * samples / p.orig);
    t_out = std::min(t_out, target);
    for (long m = 0; m < t_out; ++m) {
      long j = m / p.fresh;
      long ph = m % p.fresh;
      long start = j * p.orig + p.d0[ph];
      const double* wrow = &p.weights[(size_t)ph * p.taps];
      double acc = 0;
      for (int r = 0; r < p.taps; ++r) {
        long i = start + r;
        if (i < 0 || i >= samples) continue;
        acc += (double)mono[i] * wrow[r];
      }
      res[m] = (float)acc;
    }
    for (long m = t_out; m < target; ++m) res[m] = 0.0f;
  }

  // min-max normalize to [-1, 1] with the all-zero guard
  // (dataset.py:265-275)
  if (normalize) {
    double sum = 0;
    float lo = res[0], hi = res[0];
    for (long i = 0; i < target; ++i) {
      sum += res[i];
      lo = std::min(lo, res[i]);
      hi = std::max(hi, res[i]);
    }
    if (sum != 0.0) {
      float rng = hi - lo;
      if (rng == 0) rng = 1.0f;
      for (long i = 0; i < target; ++i)
        res[i] = (res[i] - lo) / rng * 2.0f - 1.0f;
    }
  }

  // mu-law encode (float32 math, matching ops/mulaw.py)
  float mu = (float)(quantization_channels - 1);
  float log1p_mu = std::log1p(mu);
  for (long i = 0; i < target; ++i) {
    float x = res[i];
    float y = (x > 0 ? 1.0f : (x < 0 ? -1.0f : 0.0f)) *
              std::log1p(mu * std::abs(x)) / log1p_mu;
    out[i] = (int32_t)((y + 1.0f) / 2.0f * mu + 0.5f);
  }
  return 0;
}

}  // extern "C"
