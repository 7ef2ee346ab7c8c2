// DIO-style F0 estimation + StoneMask-style refinement, C++.
//
// Native offline pitch path (SURVEY.md §2.9 #3): the reference extracts
// pitch with pyworld's DIO + StoneMask (reference
// litfass/dataset/datasets.py:566-575); pyworld is unavailable here, so
// this is a from-scratch implementation of the published algorithms
// (Morise et al., DIO 2009 / StoneMask refinement):
//
// DIO: for each log2-spaced candidate band, low-pass the signal at the
// band's boundary frequency (Nuttall-windowed-sinc FIR), then measure the
// four fundamental-period event sequences (negative/positive zero
// crossings, peaks, dips). Each event pair gives an instantaneous F0; a
// frame's candidate for the band is the mean of the four interpolated
// tracks and its reliability is their standard deviation. The best
// (lowest-deviation, in-range) candidate per frame wins; unreliable frames
// are unvoiced (0).
//
// StoneMask: refine each voiced frame by the weighted instantaneous
// frequency of the first harmonics from a short DFT around the frame.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 pitch.cpp -o libpitch.so
// (native/__init__.py drives this; ctypes C ABI below).

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// Nuttall-windowed sinc low-pass FIR, zero-phase via forward+reverse.
std::vector<double> lowpass(const std::vector<double>& x, double cutoff_hz,
                            double fs) {
  int half = static_cast<int>(fs / cutoff_hz * 1.5 + 0.5);
  half = std::max(2, std::min(half, 2048));
  int n = 2 * half + 1;
  std::vector<double> h(n);
  double sum = 0.0;
  for (int i = 0; i < n; ++i) {
    double t = i - half;
    double sinc = (t == 0.0) ? 2.0 * cutoff_hz / fs
                             : std::sin(2.0 * kPi * cutoff_hz * t / fs) /
                                   (kPi * t);
    double w = 0.355768 - 0.487396 * std::cos(2.0 * kPi * i / (n - 1)) +
               0.144232 * std::cos(4.0 * kPi * i / (n - 1)) -
               0.012604 * std::cos(6.0 * kPi * i / (n - 1));
    h[i] = sinc * w;
    sum += h[i];
  }
  for (double& v : h) v /= sum;  // unit DC gain

  std::vector<double> y(x.size(), 0.0);
  for (size_t i = 0; i < x.size(); ++i) {
    double acc = 0.0;
    for (int j = 0; j < n; ++j) {
      long k = static_cast<long>(i) + j - half;
      if (k >= 0 && k < static_cast<long>(x.size())) acc += h[j] * x[k];
    }
    y[i] = acc;
  }
  return y;
}

struct EventTrack {
  std::vector<double> times;  // event midpoint times (s)
  std::vector<double> f0s;    // instantaneous F0 at those times
};

// intervals between successive events of one type -> F0 track
EventTrack events_to_track(const std::vector<double>& ev_times) {
  EventTrack t;
  for (size_t i = 0; i + 1 < ev_times.size(); ++i) {
    double dt = ev_times[i + 1] - ev_times[i];
    if (dt > 1e-6) {
      t.times.push_back(0.5 * (ev_times[i] + ev_times[i + 1]));
      t.f0s.push_back(1.0 / dt);
    }
  }
  return t;
}

double interp_track(const EventTrack& t, double time) {
  if (t.times.empty()) return 0.0;
  if (time <= t.times.front()) return t.f0s.front();
  if (time >= t.times.back()) return t.f0s.back();
  auto it = std::upper_bound(t.times.begin(), t.times.end(), time);
  size_t hi = it - t.times.begin();
  size_t lo = hi - 1;
  double w = (time - t.times[lo]) / (t.times[hi] - t.times[lo]);
  return t.f0s[lo] * (1 - w) + t.f0s[hi] * w;
}

// zero crossings (sign +->- or -->+) with linear sub-sample interpolation
std::vector<double> zero_crossings(const std::vector<double>& x, double fs,
                                   bool negative_going) {
  std::vector<double> out;
  for (size_t i = 0; i + 1 < x.size(); ++i) {
    bool cross = negative_going ? (x[i] > 0 && x[i + 1] <= 0)
                                : (x[i] < 0 && x[i + 1] >= 0);
    if (cross) {
      double frac = x[i] / (x[i] - x[i + 1]);
      out.push_back((i + frac) / fs);
    }
  }
  return out;
}

// local extrema times (peaks of x or -x)
std::vector<double> extrema(const std::vector<double>& x, double fs,
                            bool peaks) {
  std::vector<double> out;
  for (size_t i = 1; i + 1 < x.size(); ++i) {
    bool is_ext = peaks ? (x[i] > x[i - 1] && x[i] >= x[i + 1] && x[i] > 0)
                        : (x[i] < x[i - 1] && x[i] <= x[i + 1] && x[i] < 0);
    if (is_ext) {
      // parabolic sub-sample refinement
      double denom = x[i - 1] - 2 * x[i] + x[i + 1];
      double off = (std::fabs(denom) > 1e-12)
                       ? 0.5 * (x[i - 1] - x[i + 1]) / denom
                       : 0.0;
      out.push_back((i + std::max(-0.5, std::min(0.5, off))) / fs);
    }
  }
  return out;
}

}  // namespace

extern "C" {

// DIO-style F0: x (n samples), fs, frame_period_ms; writes f0 (n_frames)
// with n_frames = floor(n/fs*1000/frame_period) + 1. Returns n_frames.
int dio_f0(const double* x_in, int n, double fs, double frame_period_ms,
           double f0_floor, double f0_ceil, double* f0_out) {
  std::vector<double> x(x_in, x_in + n);
  int n_frames =
      static_cast<int>(n / fs * 1000.0 / frame_period_ms) + 1;

  // log2-spaced candidate bands
  std::vector<double> boundaries;
  for (double f = f0_floor * 2.0; f <= f0_ceil * 2.0 * 1.0001; f *= std::sqrt(2.0))
    boundaries.push_back(f);

  std::vector<double> best_f0(n_frames, 0.0);
  std::vector<double> best_dev(n_frames, 1e30);

  for (double boundary : boundaries) {
    std::vector<double> filtered = lowpass(x, boundary, fs);
    EventTrack tracks[4] = {
        events_to_track(zero_crossings(filtered, fs, true)),
        events_to_track(zero_crossings(filtered, fs, false)),
        events_to_track(extrema(filtered, fs, true)),
        events_to_track(extrema(filtered, fs, false)),
    };
    for (int fi = 0; fi < n_frames; ++fi) {
      double time = fi * frame_period_ms / 1000.0;
      double vals[4];
      double mean = 0.0;
      bool ok = true;
      for (int k = 0; k < 4; ++k) {
        vals[k] = interp_track(tracks[k], time);
        if (vals[k] <= 0.0) ok = false;
        mean += vals[k];
      }
      if (!ok) continue;
      mean /= 4.0;
      if (mean < f0_floor || mean > f0_ceil) continue;
      // the band is only credible for F0 near its half-boundary
      if (mean > boundary || mean < boundary / 4.0) continue;
      double dev = 0.0;
      for (int k = 0; k < 4; ++k) dev += (vals[k] - mean) * (vals[k] - mean);
      dev = std::sqrt(dev / 4.0) / mean;  // relative deviation
      if (dev < best_dev[fi]) {
        best_dev[fi] = dev;
        best_f0[fi] = mean;
      }
    }
  }

  // voicing decision: estimator agreement AND harmonicity (normalized
  // autocorrelation of the raw signal at the candidate period — narrowband
  // noise can fool the four interval estimators)
  for (int fi = 0; fi < n_frames; ++fi) {
    double f0 = best_f0[fi];
    bool voiced = best_dev[fi] < 0.12 && f0 > 0.0;
    if (voiced) {
      int lag = static_cast<int>(fs / f0 + 0.5);
      int center = static_cast<int>(fi * frame_period_ms / 1000.0 * fs + 0.5);
      int half = 2 * lag;
      int lo = std::max(0, center - half);
      int hi = std::min(n - 1 - lag, center + half);
      double xy = 0, xx = 0, yy = 0;
      for (int i = lo; i <= hi; ++i) {
        xy += x[i] * x[i + lag];
        xx += x[i] * x[i];
        yy += x[i + lag] * x[i + lag];
      }
      double nac = xy / std::max(std::sqrt(xx * yy), 1e-12);
      voiced = nac > 0.5;
    }
    f0_out[fi] = voiced ? f0 : 0.0;
  }
  return n_frames;
}

// StoneMask-style refinement: instantaneous frequency of the fundamental
// from a 3-period DFT window around each frame.
void stonemask_refine(const double* x, int n, double fs,
                      double frame_period_ms, const double* f0_in,
                      int n_frames, double* f0_out) {
  for (int fi = 0; fi < n_frames; ++fi) {
    double f0 = f0_in[fi];
    if (f0 <= 0.0) {
      f0_out[fi] = 0.0;
      continue;
    }
    double refined = f0;
    for (int iter = 0; iter < 2; ++iter) {
      int center = static_cast<int>(fi * frame_period_ms / 1000.0 * fs + 0.5);
      int half = static_cast<int>(1.5 * fs / refined + 0.5);
      int lo = std::max(0, center - half);
      int hi = std::min(n - 1, center + half);
      if (hi - lo < 8) break;
      // windowed DFT at refined and at refined*(1 +/- eps) -> phase slope
      double re = 0, im = 0, re2 = 0, im2 = 0;
      double dt = 1.0 / fs;
      for (int i = lo; i <= hi; ++i) {
        double t = (i - center) * dt;
        double w = 0.5 + 0.5 * std::cos(kPi * t / (half * dt));  // Hann
        double ph = 2.0 * kPi * refined * t;
        re += x[i] * w * std::cos(ph);
        im -= x[i] * w * std::sin(ph);
        // quadrature at slight time offset for instantaneous frequency
        double ph2 = 2.0 * kPi * refined * (t + dt);
        re2 += x[i] * w * std::cos(ph2);
        im2 -= x[i] * w * std::sin(ph2);
      }
      double mag = std::hypot(re, im);
      if (mag < 1e-12) break;
      double dphi = std::atan2(im2, re2) - std::atan2(im, re);
      while (dphi > kPi) dphi -= 2 * kPi;
      while (dphi < -kPi) dphi += 2 * kPi;
      // observed instantaneous frequency = refined + dphi/(2 pi dt)
      double inst = refined + dphi / (2.0 * kPi * dt);
      if (inst > 0.25 * refined && inst < 4.0 * refined) refined = inst;
    }
    f0_out[fi] = refined;
  }
}

}  // extern "C"
