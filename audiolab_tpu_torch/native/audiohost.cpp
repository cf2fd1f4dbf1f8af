// audiohost — native host-side audio runtime for audiolab_tpu_torch.
//
// The reference gets its host-side speed from prebuilt wheels (xxhash,
// soundfile/libsndfile, ffmpeg — SURVEY §2.5); this library is the in-tree
// native equivalent for the data path that feeds the TPU: WAV codec,
// polyphase resampling, content hashing, and level scanning.  Exposed via
// a C ABI for ctypes (no pybind11 needed).
//
// Built by audiolab_tpu_torch/native/__init__.py with g++ at first use, into
// build/native/ under a name that hashes the sources and the command.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------- hashing

// FNV-1a 64-bit — stable content hash for project directories
// (util/data_classes.py:12-16 uses xxhash64; same role, stable in-tree).
uint64_t ah_hash64(const uint8_t* data, uint64_t len) {
    uint64_t h = 1469598103934665603ULL;
    for (uint64_t i = 0; i < len; i++) {
        h ^= data[i];
        h *= 1099511628211ULL;
    }
    return h;
}

// ---------------------------------------------------------------- WAV

struct WavInfo {
    int32_t channels;
    int32_t sample_rate;
    int32_t bits;
    int32_t format;      // 1 = PCM, 3 = float
    int64_t frames;
    int64_t data_offset;
};

static int parse_wav(const uint8_t* d, uint64_t len, WavInfo* info) {
    if (len < 44 || memcmp(d, "RIFF", 4) || memcmp(d + 8, "WAVE", 4)) return -1;
    uint64_t pos = 12;
    bool have_fmt = false;
    while (pos + 8 <= len) {
        const uint8_t* ck = d + pos;
        uint32_t sz;
        memcpy(&sz, ck + 4, 4);
        const uint8_t* body = ck + 8;
        if (!memcmp(ck, "fmt ", 4) && sz >= 16) {
            uint16_t fmt, ch, bits;
            uint32_t sr;
            memcpy(&fmt, body, 2);
            memcpy(&ch, body + 2, 2);
            memcpy(&sr, body + 4, 4);
            memcpy(&bits, body + 14, 2);
            if (fmt == 0xFFFE && sz >= 40) memcpy(&fmt, body + 24, 2);
            info->format = fmt;
            info->channels = ch;
            info->sample_rate = (int32_t)sr;
            info->bits = bits;
            have_fmt = true;
        } else if (!memcmp(ck, "data", 4)) {
            if (!have_fmt) return -2;
            if (info->channels <= 0 || info->bits < 8) return -5;
            uint64_t avail = std::min<uint64_t>(sz, len - pos - 8);
            info->data_offset = (int64_t)(pos + 8);
            info->frames = (int64_t)(avail / (info->channels * info->bits / 8));
            return 0;
        }
        pos += 8 + sz + (sz & 1);
    }
    return -3;
}

int32_t ah_wav_info(const uint8_t* data, uint64_t len, int32_t* channels,
                    int32_t* sample_rate, int64_t* frames) {
    WavInfo info;
    int rc = parse_wav(data, len, &info);
    if (rc) return rc;
    *channels = info.channels;
    *sample_rate = info.sample_rate;
    *frames = info.frames;
    return 0;
}

// Decode to float32 interleaved [-1, 1].
int32_t ah_wav_decode(const uint8_t* data, uint64_t len, float* out) {
    WavInfo info;
    int rc = parse_wav(data, len, &info);
    if (rc) return rc;
    const uint8_t* p = data + info.data_offset;
    int64_t n = info.frames * info.channels;
    if (info.format == 3 && info.bits == 32) {
        memcpy(out, p, (size_t)n * 4);
    } else if (info.format == 1 && info.bits == 16) {
        const int16_t* s = (const int16_t*)p;
        for (int64_t i = 0; i < n; i++) out[i] = s[i] * (1.0f / 32768.0f);
    } else if (info.format == 1 && info.bits == 24) {
        for (int64_t i = 0; i < n; i++) {
            int32_t v = (int32_t)(p[3 * i] | (p[3 * i + 1] << 8) |
                                  (p[3 * i + 2] << 16));
            if (v & 0x800000) v |= ~0xFFFFFF;
            out[i] = v * (1.0f / 8388608.0f);
        }
    } else if (info.format == 1 && info.bits == 32) {
        const int32_t* s = (const int32_t*)p;
        for (int64_t i = 0; i < n; i++) out[i] = s[i] * (1.0f / 2147483648.0f);
    } else {
        return -4;
    }
    return 0;
}

// Encode float32 interleaved -> PCM16 WAV. Returns bytes written or <0.
int64_t ah_wav_encode_pcm16(const float* samples, int64_t frames,
                            int32_t channels, int32_t sample_rate,
                            uint8_t* out, int64_t out_cap) {
    int64_t data_bytes = frames * channels * 2;
    int64_t total = 44 + data_bytes;
    if (out_cap < total) return -1;
    uint32_t u32;
    uint16_t u16;
    memcpy(out, "RIFF", 4);
    u32 = (uint32_t)(total - 8); memcpy(out + 4, &u32, 4);
    memcpy(out + 8, "WAVEfmt ", 8);
    u32 = 16; memcpy(out + 16, &u32, 4);
    u16 = 1; memcpy(out + 20, &u16, 2);
    u16 = (uint16_t)channels; memcpy(out + 22, &u16, 2);
    u32 = (uint32_t)sample_rate; memcpy(out + 24, &u32, 4);
    u32 = (uint32_t)(sample_rate * channels * 2); memcpy(out + 28, &u32, 4);
    u16 = (uint16_t)(channels * 2); memcpy(out + 32, &u16, 2);
    u16 = 16; memcpy(out + 34, &u16, 2);
    memcpy(out + 36, "data", 4);
    u32 = (uint32_t)data_bytes; memcpy(out + 40, &u32, 4);
    int16_t* d = (int16_t*)(out + 44);
    int64_t n = frames * channels;
    for (int64_t i = 0; i < n; i++) {
        float v = samples[i];
        v = v > 1.0f ? 1.0f : (v < -1.0f ? -1.0f : v);
        d[i] = (int16_t)lrintf(v * 32767.0f);
    }
    return total;
}

// ---------------------------------------------------------------- resample

// Windowed-sinc polyphase resampler (scipy.signal.resample_poly semantics,
// Kaiser-windowed lowpass at min(1/up, 1/down)).
static double bessel_i0(double x) {
    double s = 1.0, t = 1.0;
    for (int k = 1; k < 32; k++) {
        t *= (x / (2.0 * k)) * (x / (2.0 * k));
        s += t;
        if (t < 1e-16 * s) break;
    }
    return s;
}

int64_t ah_resample_len(int64_t n_in, int32_t up, int32_t down) {
    return (n_in * up + down - 1) / down;
}

int32_t ah_resample(const float* x, int64_t n_in, int32_t up, int32_t down,
                    float* out) {
    if (up <= 0 || down <= 0) return -1;
    if (up == down) { memcpy(out, x, (size_t)n_in * 4); return 0; }
    // design kaiser lowpass: half = 10 taps per phase
    const int half_per_phase = 10;
    int64_t half = (int64_t)half_per_phase * std::max(up, down);
    int64_t ntaps = 2 * half + 1;
    double fc = 0.5 / std::max(up, down);   // normalized to up-rate nyquist=0.5
    double beta = 5.0;                        // scipy resample_poly default
    std::vector<float> h((size_t)ntaps);
    double i0b = bessel_i0(beta);
    for (int64_t i = 0; i < ntaps; i++) {
        double m = (double)(i - half);
        double sinc = (m == 0.0) ? 2.0 * fc
                                 : sin(2.0 * M_PI * fc * m) / (M_PI * m);
        double w = bessel_i0(beta * sqrt(std::max(0.0, 1.0 - (m / half) * (m / half)))) / i0b;
        h[(size_t)i] = (float)(sinc * w * up);
    }
    int64_t n_out = ah_resample_len(n_in, up, down);
    // polyphase: out[j] = sum_k h[phase + k*up] * x[start - k]
    for (int64_t j = 0; j < n_out; j++) {
        int64_t t = j * down;                 // position on the up-rate grid
        int64_t x0 = (t + half) / up;         // input index of first tap
        int64_t phase = (t + half) - x0 * up;
        double acc = 0.0;
        for (int64_t k = 0;; k++) {
            int64_t hi = phase + k * up;
            if (hi >= ntaps) break;
            int64_t xi = x0 - k;
            if (xi < 0) break;
            if (xi < n_in) acc += (double)h[(size_t)hi] * x[xi];
        }
        out[j] = (float)acc;
    }
    return 0;
}

// ---------------------------------------------------------------- levels

void ah_levels(const float* x, int64_t n, float* peak, float* rms) {
    double p = 0.0, s = 0.0;
    for (int64_t i = 0; i < n; i++) {
        double v = fabs((double)x[i]);
        if (v > p) p = v;
        s += v * v;
    }
    *peak = (float)p;
    *rms = (float)sqrt(s / std::max<int64_t>(n, 1));
}

}  // extern "C"
