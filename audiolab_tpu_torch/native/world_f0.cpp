// world_f0 — native DIO / Harvest / StoneMask parity oracle.
//
// The reference extracts f0 through the pyworld wheel (WORLD's C++ dio/
// harvest/stonemask, modules/rvc/pitch_extraction.py:172-191).  The port
// does not depend on that wheel, so this file is an INDEPENDENT, per-frame
// transcription of the published WORLD algorithm flow (Morise's DIO
// half-octave channel design + four-interval event detector + the four
// FixF0Contour steps + Flanagan instantaneous-frequency refinement),
// written in the C++ loop style of the original — deliberately NOT a port
// of the vectorized NumPy implementation in dsp/f0.py.  The test suite
// gates dsp/f0.py against this oracle on speech-like signals
// (tests/test_torch_port_host_utils.py), which is what SURVEY §2.5 prescribed ("keep a
// C++ host op for parity testing").
//
// Algorithm-level agreement is expected (voicing decisions, f0 within a
// few percent); bit-exactness is not, since the two implementations make
// independent low-level choices (FFT-vs-direct filtering, FFT-bin vs
// exact-DTFT instantaneous frequency).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <limits>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// Nuttall window (the FIR prototype WORLD uses for its channel filters).
std::vector<double> nuttall(int64_t n) {
    std::vector<double> w((size_t)n);
    for (int64_t i = 0; i < n; i++) {
        double t = 2.0 * M_PI * i / std::max<int64_t>(n - 1, 1);
        w[(size_t)i] = 0.355768 - 0.487396 * cos(t) + 0.144232 * cos(2 * t)
                       - 0.012604 * cos(3 * t);
    }
    return w;
}

// Direct FIR convolution, output trimmed to len(x) with the group delay
// removed (same alignment as an FFT filter with the kernel centred).
std::vector<double> filter_signal(const std::vector<double>& x,
                                  const std::vector<double>& h) {
    int64_t n = (int64_t)x.size(), m = (int64_t)h.size(), d = m / 2;
    std::vector<double> y((size_t)n, 0.0);
    for (int64_t i = 0; i < n; i++) {
        double acc = 0.0;
        // y_full[i + d] = sum_j h[j] * x[i + d - j]
        int64_t lo = std::max<int64_t>(0, i + d - n + 1);
        int64_t hi = std::min<int64_t>(m - 1, i + d);
        for (int64_t j = lo; j <= hi; j++) acc += h[(size_t)j] * x[(size_t)(i + d - j)];
        y[(size_t)i] = acc;
    }
    return y;
}

struct EventTrack {
    std::vector<double> locs;   // fractional sample positions of events
    std::vector<double> f0s;    // fs / interval, one per interval
    std::vector<double> mids;   // interval midpoints
};

// Negative-to-positive zero crossings of `sig`, with linear interpolation
// of the crossing position (WORLD's ZeroCrossingEngine).
EventTrack zero_crossings(const std::vector<double>& sig, int fs) {
    EventTrack ev;
    int64_t n = (int64_t)sig.size();
    for (int64_t i = 0; i + 1 < n; i++) {
        if (!(sig[(size_t)i] <= 0.0 && sig[(size_t)(i + 1)] > 0.0)) continue;
        double denom = sig[(size_t)(i + 1)] - sig[(size_t)i];
        double frac = denom > 1e-12 ? -sig[(size_t)i] / denom : 0.5;
        ev.locs.push_back((double)i + frac);
    }
    for (size_t i = 0; i + 1 < ev.locs.size(); i++) {
        double interval = ev.locs[i + 1] - ev.locs[i];
        if (interval <= 0.0) continue;
        ev.f0s.push_back((double)fs / interval);
        ev.mids.push_back(0.5 * (ev.locs[i] + ev.locs[i + 1]));
    }
    return ev;
}

// Piecewise-linear interpolation of (mids, f0s) at the frame centres,
// clamped to the end values outside the event range.
std::vector<double> interp_track(const EventTrack& ev,
                                 const std::vector<double>& centers) {
    std::vector<double> out(centers.size(), 0.0);
    if (ev.f0s.empty()) return out;
    for (size_t t = 0; t < centers.size(); t++) {
        double c = centers[t];
        if (c <= ev.mids.front()) { out[t] = ev.f0s.front(); continue; }
        if (c >= ev.mids.back())  { out[t] = ev.f0s.back();  continue; }
        size_t j = (size_t)(std::upper_bound(ev.mids.begin(), ev.mids.end(), c)
                            - ev.mids.begin());
        double x0 = ev.mids[j - 1], x1 = ev.mids[j];
        double w = (c - x0) / std::max(x1 - x0, 1e-12);
        out[t] = ev.f0s[j - 1] * (1.0 - w) + ev.f0s[j] * w;
    }
    return out;
}

// One channel: filter, detect the four event trains (negative ZC,
// positive ZC, peaks, dips), score their agreement per frame.
void channel_candidates(const std::vector<double>& x, int fs,
                        const std::vector<double>& centers,
                        double boundary_f0, double f0_floor, double f0_ceil,
                        bool bandpass,
                        std::vector<double>& cand, std::vector<double>& score) {
    size_t T = centers.size();
    cand.assign(T, 0.0);
    score.assign(T, kInf);

    int64_t half_len = std::max<int64_t>(2, (int64_t)llround(fs / boundary_f0 / 2.0));
    std::vector<double> h = nuttall(4 * half_len);
    if (bandpass) {  // Harvest channel: Nuttall-windowed cosine at boundary_f0
        for (int64_t i = 0; i < 4 * half_len; i++) {
            double t = (double)(i - 2 * half_len) / fs;
            h[(size_t)i] *= cos(2.0 * M_PI * boundary_f0 * t);
        }
    }
    double s = 0.0;
    for (double v : h) s += fabs(v);
    for (double& v : h) v /= (s + 1e-12);

    std::vector<double> y = filter_signal(x, h);

    // four event trains: -ZC of y, +ZC of y (=-ZC of -y), peaks (ZC of
    // dy), dips (ZC of -dy)
    std::vector<double> neg = y, dy(y.size()), ndy(y.size());
    for (double& v : neg) v = -v;
    dy[0] = 0.0;
    for (size_t i = 1; i < y.size(); i++) dy[i] = y[i] - y[i - 1];
    for (size_t i = 0; i < y.size(); i++) ndy[i] = -dy[i];

    const std::vector<double>* sigs[4] = {&y, &neg, &dy, &ndy};
    std::vector<std::vector<double>> tracks;
    for (auto* sg : sigs) {
        EventTrack ev = zero_crossings(*sg, fs);
        if (ev.f0s.size() < 2) return;  // channel yields nothing
        tracks.push_back(interp_track(ev, centers));
    }

    double lo = bandpass ? boundary_f0 * 0.6 : boundary_f0 / 2.0;
    double hi = bandpass ? boundary_f0 * 1.2 : boundary_f0;
    lo = std::max(lo, f0_floor);
    hi = std::min(hi, f0_ceil);
    for (size_t t = 0; t < T; t++) {
        double mean = 0.0;
        for (int k = 0; k < 4; k++) mean += tracks[(size_t)k][t];
        mean *= 0.25;
        double dev = 0.0;
        for (int k = 0; k < 4; k++) {
            double d = tracks[(size_t)k][t] - mean;
            dev += d * d;
        }
        dev = sqrt(dev / 3.0) / std::max(mean, 1e-6);
        if (mean >= lo && mean <= hi) {
            cand[t] = mean;
            score[t] = dev;
        }
    }
}

// The four WORLD FixF0Contour steps, frame-by-frame.
std::vector<double> fix_f0_contour(const std::vector<double>& best,
                                   const std::vector<std::vector<double>>& cand_all,
                                   double hop_s, double f0_floor,
                                   double allowed_range) {
    int64_t T = (int64_t)best.size();
    std::vector<double> f0 = best;
    int64_t vrm = (int64_t)(0.5 + 1.0 / hop_s / f0_floor) * 2 + 1;

    // step 1: rapid-change removal
    for (int64_t t = T - 1; t >= 1; t--) {
        if (f0[(size_t)t] > 0.0 && f0[(size_t)(t - 1)] > 0.0 &&
            fabs(f0[(size_t)t] - f0[(size_t)(t - 1)]) / f0[(size_t)t] > allowed_range)
            f0[(size_t)t] = 0.0;
    }

    // step 2: short voiced-segment removal
    for (int64_t i = 0; i < T;) {
        if (f0[(size_t)i] <= 0.0) { i++; continue; }
        int64_t j = i;
        while (j < T && f0[(size_t)j] > 0.0) j++;
        if (j - i < vrm)
            for (int64_t k = i; k < j; k++) f0[(size_t)k] = 0.0;
        i = j;
    }

    // steps 3+4: extend voiced sections forward/backward by re-selecting
    // the nearest channel candidate; keep extensions both passes agree on
    auto extend = [&](const std::vector<double>& base, bool forward) {
        std::vector<double> g = base;
        for (int64_t s = 1; s < T; s++) {
            int64_t t = forward ? s : T - 1 - s;
            int64_t p = forward ? t - 1 : t + 1;
            if (g[(size_t)t] != 0.0 || g[(size_t)p] <= 0.0) continue;
            double ref = g[(size_t)p], bd = kInf, bc = 0.0;
            for (const auto& ch : cand_all) {
                double c = ch[(size_t)t];
                if (c <= 0.0) continue;
                double d = fabs(c - ref) / ref;
                if (d < bd) { bd = d; bc = c; }
            }
            if (bd < allowed_range) g[(size_t)t] = bc;
        }
        return g;
    };
    std::vector<double> fwd = extend(f0, true), bwd = extend(f0, false);
    std::vector<double> out((size_t)T);
    for (int64_t t = 0; t < T; t++) {
        if (f0[(size_t)t] > 0.0) { out[(size_t)t] = f0[(size_t)t]; continue; }
        double a = fwd[(size_t)t], b = bwd[(size_t)t];
        bool agree = a > 0.0 && b > 0.0 && fabs(a - b) / std::max(a, 1e-6) < allowed_range;
        out[(size_t)t] = agree ? 0.5 * (a + b) : 0.0;
    }
    return out;
}

// Flanagan instantaneous frequency at frequency f via the exact DTFT of
// the windowed segment and its derivative-window counterpart:
//   IF(f) = f + (Re S · Im S' − Im S · Re S') / |S|^2 · fs / (2π)
struct IFResult { double inst; double amp; };
IFResult instantaneous_frequency(const std::vector<double>& x, int64_t center,
                                 int64_t half, int fs, double f) {
    int64_t n = (int64_t)x.size();
    double wlen_s = (2.0 * half + 1.0) / fs;
    double sr = 0, si = 0, dr = 0, di = 0;
    for (int64_t o = -half; o <= half; o++) {
        int64_t i = std::clamp<int64_t>(center + o, 0, n - 1);
        double tt = (double)o / fs;
        double ph = 2.0 * M_PI * tt / wlen_s;
        double wmain = 0.42 + 0.5 * cos(ph) + 0.08 * cos(2.0 * ph);  // Blackman
        double wdiff = -(M_PI / wlen_s) * sin(ph)
                       - (0.16 * M_PI / wlen_s) * sin(2.0 * ph);
        double v = x[(size_t)i];
        double c = cos(2.0 * M_PI * f * tt), s = -sin(2.0 * M_PI * f * tt);
        sr += v * wmain * c;  si += v * wmain * s;
        dr += v * wdiff * c;  di += v * wdiff * s;
    }
    double power = sr * sr + si * si;
    IFResult r;
    r.amp = sqrt(power);
    r.inst = f + (power > 1e-12 ? (sr * di - si * dr) / power : 0.0)
                     * fs / (2.0 * M_PI);
    return r;
}

// StoneMask: two refinement passes (2 then 6 harmonics), amp-weighted
// mean of per-harmonic IF/h, implausible refinements rejected.
void stonemask_refine(const std::vector<double>& x, int fs, int64_t hop,
                      std::vector<double>& f0) {
    auto fix = [&](double cur, int64_t pos, int max_harm) {
        int64_t half = (int64_t)(1.5 * fs / cur + 1.0);
        int n_harm = std::clamp((int)(fs / 2.0 / cur), 1, max_harm);
        double wsum = 0.0, acc = 0.0;
        for (int hmr = 1; hmr <= n_harm; hmr++) {
            IFResult r = instantaneous_frequency(x, pos, half, fs, cur * hmr);
            acc += r.amp * (r.inst / hmr);
            wsum += r.amp;
        }
        return wsum > 1e-12 ? acc / wsum : 0.0;
    };
    for (size_t t = 0; t < f0.size(); t++) {
        if (f0[t] <= 0.0) continue;
        int64_t pos = (int64_t)t * hop;
        double cur = f0[t];
        double tent = fix(cur, pos, 2);
        if (tent <= 0.0) tent = cur;
        double ref = fix(tent, pos, 6);
        if (ref > 0.0 && fabs(ref - cur) / cur < 0.2) f0[t] = ref;
    }
}

}  // namespace

extern "C" {

// mode 0 = DIO (half-octave low-pass channels), 1 = Harvest (dense
// band-pass channels + per-run smoothing).  Writes n/hop + 1 frames.
int32_t ah_world_f0(const float* x_in, int64_t n, int32_t fs, int32_t hop,
                    double f0_floor, double f0_ceil, int32_t mode,
                    int32_t refine, double* out) {
    if (n <= 0 || fs <= 0 || hop <= 0 || f0_floor <= 0 || f0_ceil <= f0_floor)
        return -1;
    std::vector<double> x((size_t)n);
    for (int64_t i = 0; i < n; i++) x[(size_t)i] = (double)x_in[i];
    int64_t T = n / hop + 1;
    std::vector<double> centers((size_t)T);
    for (int64_t t = 0; t < T; t++) centers[(size_t)t] = (double)(t * hop);

    double cpo = mode == 1 ? 12.0 : 2.0;       // channels per octave
    int64_t n_ch = std::max<int64_t>(2,
        (int64_t)ceil(cpo * log2(f0_ceil / f0_floor)));

    std::vector<std::vector<double>> cand_all, score_all;
    for (int64_t c = 0; c < n_ch; c++) {
        double boundary = f0_floor * pow(2.0, (double)(c + 1) / cpo);
        std::vector<double> cand, score;
        channel_candidates(x, fs, centers, boundary, f0_floor, f0_ceil,
                           mode == 1, cand, score);
        cand_all.push_back(std::move(cand));
        score_all.push_back(std::move(score));
    }

    double score_max = mode == 1 ? 0.12 : 0.06;
    double allowed = mode == 1 ? 0.18 : 0.10;
    if (mode == 1) {  // Harvest keeps only near-agreeing channel events
        for (int64_t c = 0; c < n_ch; c++)
            for (int64_t t = 0; t < T; t++)
                if (!(score_all[(size_t)c][(size_t)t] < score_max)) {
                    cand_all[(size_t)c][(size_t)t] = 0.0;
                    score_all[(size_t)c][(size_t)t] = kInf;
                }
    }

    std::vector<double> best((size_t)T, 0.0);
    for (int64_t t = 0; t < T; t++) {
        double bs = kInf, bc = 0.0;
        for (int64_t c = 0; c < n_ch; c++) {
            if (score_all[(size_t)c][(size_t)t] < bs) {
                bs = score_all[(size_t)c][(size_t)t];
                bc = cand_all[(size_t)c][(size_t)t];
            }
        }
        if (mode == 1 ? std::isfinite(bs) : bs < score_max) best[(size_t)t] = bc;
    }

    best = fix_f0_contour(best, cand_all, (double)hop / fs, f0_floor, allowed);
    if (refine) stonemask_refine(x, fs, hop, best);

    if (mode == 1) {  // SmoothF0Contour: zero-phase MA inside voiced runs
        const int64_t k = 3;
        std::vector<double> sm = best;
        for (int64_t t = 0; t < T; t++) {
            bool run = true;
            for (int64_t o = -k; o <= k && run; o++) {
                int64_t i = std::clamp<int64_t>(t + o, 0, T - 1);
                // mirror np.roll wrap semantics is irrelevant at edges —
                // require the full window voiced inside bounds
                if (t + o < 0 || t + o >= T || best[(size_t)i] <= 0.0) run = false;
            }
            if (!run) continue;
            double acc = 0.0;
            for (int64_t o = -k; o <= k; o++) acc += best[(size_t)(t + o)];
            sm[(size_t)t] = acc / (2 * k + 1);
        }
        best = std::move(sm);
    }

    for (int64_t t = 0; t < T; t++) {
        double v = best[(size_t)t];
        out[t] = (v >= f0_floor && v <= f0_ceil) ? v : 0.0;
    }
    return 0;
}

// Standalone StoneMask refinement of an existing f0 track (pyworld's
// third entry point, pitch_extraction.py:180,190).
int32_t ah_stonemask(const float* x_in, int64_t n, int32_t fs, int32_t hop,
                     const double* f0_in, int64_t t_frames, double* out) {
    if (n <= 0 || fs <= 0 || hop <= 0 || t_frames <= 0) return -1;
    std::vector<double> x((size_t)n);
    for (int64_t i = 0; i < n; i++) x[(size_t)i] = (double)x_in[i];
    std::vector<double> f0((size_t)t_frames);
    for (int64_t t = 0; t < t_frames; t++) f0[(size_t)t] = f0_in[t];
    stonemask_refine(x, fs, hop, f0);
    for (int64_t t = 0; t < t_frames; t++) out[t] = f0[(size_t)t];
    return 0;
}

}  // extern "C"
