// Native WAV codec of the PyTorch port (gat_tpu_torch), the port's own
// copy of the JAX package's codec: a small RIFF/WAVE parser that decodes
// PCM 8/16/24/32 and IEEE float 32/64 to mono float32, and an encoder.
// The Python side (gat_tpu_torch/utils/native_wav.py) builds it with g++
// at first use and calls it through ctypes; the GIL is released during
// the call, so a thread pool decodes many files in parallel.
//
// Two-call protocol:
//   wav_probe(path, &sr, &channels, &frames)      → 0 on success
//   wav_decode(path, out, capacity, &sr, &frames) → 0 on success, mono
//
// Encode:
//   wav_encode(path, samples, frames, sr, bits)   → 0 on success
// bits = 16 (PCM16, clamped) or 32 (IEEE float32). Mono only — every
// writer in this framework emits mono clips.
//
// Error codes: -1 open/read failure, -2 not RIFF/WAVE, -3 unsupported
// format, -4 capacity too small, -5 bad encode argument.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <vector>

namespace {

struct Wav {
    uint16_t format = 0;
    uint16_t channels = 0;
    uint32_t sample_rate = 0;
    uint16_t bits = 0;
    uint64_t data_size = 0;  // probe records size without allocating
    std::vector<uint8_t> data;
};

constexpr uint16_t kPcm = 0x0001;
constexpr uint16_t kFloat = 0x0003;
constexpr uint16_t kExtensible = 0xFFFE;

int parse(const char* path, Wav& w, bool want_data) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    // file length bounds every declared chunk size: a corrupt 4 GiB
    // data-size field must not trigger a 4 GiB allocation
    std::fseek(f, 0, SEEK_END);
    long file_len = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    uint8_t hdr[12];
    if (std::fread(hdr, 1, 12, f) != 12 ||
        std::memcmp(hdr, "RIFF", 4) != 0 ||
        std::memcmp(hdr + 8, "WAVE", 4) != 0) {
        std::fclose(f);
        return -2;
    }
    bool have_fmt = false, have_data = false;
    while (true) {
        uint8_t chdr[8];
        if (std::fread(chdr, 1, 8, f) != 8) break;
        uint32_t size;
        std::memcpy(&size, chdr + 4, 4);
        if (std::memcmp(chdr, "fmt ", 4) == 0) {
            if (size < 16) {  // a valid PCM fmt chunk is ≥ 16 bytes
                std::fclose(f);
                return -2;
            }
            // clamp to the remaining file bytes like the data chunk: a
            // corrupt 4 GiB fmt-size field must not drive an allocation
            long pos = std::ftell(f);
            long remaining = (pos >= 0 && file_len > pos)
                ? file_len - pos : 0;
            if (static_cast<long>(size) > remaining) {
                std::fclose(f);
                return -2;  // fmt chunk extends past EOF: corrupt
            }
            std::vector<uint8_t> fmt(size);
            if (std::fread(fmt.data(), 1, size, f) != size) break;
            std::memcpy(&w.format, fmt.data(), 2);
            std::memcpy(&w.channels, fmt.data() + 2, 2);
            std::memcpy(&w.sample_rate, fmt.data() + 4, 4);
            std::memcpy(&w.bits, fmt.data() + 14, 2);
            if (w.format == kExtensible) {
                if (size < 26) {
                    std::fclose(f);
                    return -2;
                }
                std::memcpy(&w.format, fmt.data() + 24, 2);
            }
            have_fmt = true;
        } else if (std::memcmp(chdr, "data", 4) == 0) {
            long pos = std::ftell(f);
            long remaining = (pos >= 0 && file_len > pos)
                ? file_len - pos : 0;
            if (static_cast<long>(size) > remaining) {
                size = static_cast<uint32_t>(remaining);
            }
            w.data_size = size;
            if (want_data) {
                try {
                    w.data.resize(size);
                } catch (const std::bad_alloc&) {
                    std::fclose(f);
                    return -1;  // corrupt size field / out of memory
                }
                size_t got = std::fread(w.data.data(), 1, size, f);
                if (got != size) {
                    // truncated payload: keep what's there (frame count
                    // derives from the actual bytes read)
                    w.data.resize(got);
                    w.data_size = got;
                }
            } else {
                std::fseek(f, size, SEEK_CUR);
            }
            have_data = true;
        } else {
            std::fseek(f, size, SEEK_CUR);
        }
        if (size & 1) std::fseek(f, 1, SEEK_CUR);
        if (have_fmt && have_data) break;
    }
    std::fclose(f);
    if (!have_fmt || !have_data) return -2;
    if (w.channels == 0) return -3;
    return 0;
}

long frame_count(const Wav& w) {
    long bytes_per = (w.bits / 8) * w.channels;
    return bytes_per ? static_cast<long>(w.data_size) / bytes_per : 0;
}

}  // namespace

extern "C" {

int wav_probe(const char* path, int* sr, int* channels, long* frames) {
    Wav w;
    int rc = parse(path, w, /*want_data=*/false);
    if (rc) return rc;
    if (!((w.format == kPcm && (w.bits == 8 || w.bits == 16 ||
                                w.bits == 24 || w.bits == 32)) ||
          (w.format == kFloat && (w.bits == 32 || w.bits == 64)))) {
        return -3;
    }
    *sr = static_cast<int>(w.sample_rate);
    *channels = w.channels;
    *frames = frame_count(w);
    return 0;
}

// Decodes to mono float32 (channel average). `capacity` in samples.
int wav_decode(const char* path, float* out, long capacity, int* sr,
               long* frames_out) {
    Wav w;
    int rc = parse(path, w, /*want_data=*/true);
    if (rc) return rc;
    long frames = frame_count(w);
    if (frames > capacity) return -4;
    int ch = w.channels;
    const uint8_t* d = w.data.data();
    const float inv_ch = 1.0f / ch;

    if (w.format == kPcm && w.bits == 16) {
        const int16_t* s = reinterpret_cast<const int16_t*>(d);
        for (long i = 0; i < frames; ++i) {
            float acc = 0.f;
            for (int c = 0; c < ch; ++c) acc += s[i * ch + c];
            out[i] = acc * inv_ch / 32768.0f;
        }
    } else if (w.format == kPcm && w.bits == 24) {
        for (long i = 0; i < frames; ++i) {
            float acc = 0.f;
            for (int c = 0; c < ch; ++c) {
                const uint8_t* p = d + 3 * (i * ch + c);
                int32_t v = p[0] | (p[1] << 8) | (p[2] << 16);
                if (v >= (1 << 23)) v -= (1 << 24);
                acc += static_cast<float>(v);
            }
            out[i] = acc * inv_ch / 8388608.0f;
        }
    } else if (w.format == kPcm && w.bits == 32) {
        const int32_t* s = reinterpret_cast<const int32_t*>(d);
        for (long i = 0; i < frames; ++i) {
            double acc = 0.0;
            for (int c = 0; c < ch; ++c) acc += s[i * ch + c];
            out[i] = static_cast<float>(acc * inv_ch / 2147483648.0);
        }
    } else if (w.format == kPcm && w.bits == 8) {
        for (long i = 0; i < frames; ++i) {
            float acc = 0.f;
            for (int c = 0; c < ch; ++c)
                acc += (static_cast<int>(d[i * ch + c]) - 128);
            out[i] = acc * inv_ch / 128.0f;
        }
    } else if (w.format == kFloat && w.bits == 32) {
        const float* s = reinterpret_cast<const float*>(d);
        for (long i = 0; i < frames; ++i) {
            float acc = 0.f;
            for (int c = 0; c < ch; ++c) acc += s[i * ch + c];
            out[i] = acc * inv_ch;
        }
    } else if (w.format == kFloat && w.bits == 64) {
        const double* s = reinterpret_cast<const double*>(d);
        for (long i = 0; i < frames; ++i) {
            double acc = 0.0;
            for (int c = 0; c < ch; ++c) acc += s[i * ch + c];
            out[i] = static_cast<float>(acc * inv_ch);
        }
    } else {
        return -3;
    }
    *sr = static_cast<int>(w.sample_rate);
    *frames_out = frames;
    return 0;
}

// Encodes mono float32 samples as RIFF/WAVE: PCM16 (bits=16, values
// clamped to [-1, 1]) or IEEE float32 (bits=32, values written as-is).
// Non-PCM (float) files carry the strict-reader shape: an 18-byte fmt
// chunk (cbSize=0) plus a fact chunk with the frame count — libsndfile-
// family tools reject bare 16-byte fmt chunks for format 3.
int wav_encode(const char* path, const float* samples, long frames,
               int sr, int bits) {
    if (frames < 0 || sr <= 0 || !(bits == 16 || bits == 32)) return -5;
    const uint32_t bytes_per = bits / 8;
    const bool is_float = (bits == 32);
    // float: fmt grows to 18 bytes and a 12-byte fact chunk follows
    const uint32_t fmt_size = is_float ? 18 : 16;
    const uint32_t pre_data = 12 + 8 + fmt_size + (is_float ? 12 : 0) + 8;
    const uint64_t data_size64 = static_cast<uint64_t>(frames) * bytes_per;
    if (data_size64 > 0xFFFFFFFFu - (pre_data - 8)) return -5;
    const uint32_t data_size = static_cast<uint32_t>(data_size64);

    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    uint8_t hdr[58];
    size_t off = 0;
    std::memcpy(hdr + off, "RIFF", 4); off += 4;
    const uint32_t riff_size = pre_data - 8 + data_size;
    std::memcpy(hdr + off, &riff_size, 4); off += 4;
    std::memcpy(hdr + off, "WAVEfmt ", 8); off += 8;
    std::memcpy(hdr + off, &fmt_size, 4); off += 4;
    const uint16_t format = is_float ? kFloat : kPcm;
    const uint16_t channels = 1;
    std::memcpy(hdr + off, &format, 2); off += 2;
    std::memcpy(hdr + off, &channels, 2); off += 2;
    const uint32_t rate = static_cast<uint32_t>(sr);
    std::memcpy(hdr + off, &rate, 4); off += 4;
    const uint32_t byte_rate = rate * bytes_per;
    std::memcpy(hdr + off, &byte_rate, 4); off += 4;
    const uint16_t block_align = static_cast<uint16_t>(bytes_per);
    std::memcpy(hdr + off, &block_align, 2); off += 2;
    const uint16_t bits16 = static_cast<uint16_t>(bits);
    std::memcpy(hdr + off, &bits16, 2); off += 2;
    if (is_float) {
        const uint16_t cb_size = 0;
        std::memcpy(hdr + off, &cb_size, 2); off += 2;
        std::memcpy(hdr + off, "fact", 4); off += 4;
        const uint32_t fact_size = 4;
        std::memcpy(hdr + off, &fact_size, 4); off += 4;
        const uint32_t n_frames32 = static_cast<uint32_t>(frames);
        std::memcpy(hdr + off, &n_frames32, 4); off += 4;
    }
    std::memcpy(hdr + off, "data", 4); off += 4;
    std::memcpy(hdr + off, &data_size, 4); off += 4;
    if (std::fwrite(hdr, 1, off, f) != off) { std::fclose(f); return -1; }

    bool ok = true;
    if (bits == 32) {
        ok = std::fwrite(samples, sizeof(float),
                         static_cast<size_t>(frames), f)
             == static_cast<size_t>(frames);
    } else {
        constexpr size_t kChunk = 1 << 16;
        std::vector<int16_t> buf(kChunk);
        for (long off = 0; ok && off < frames;
             off += static_cast<long>(kChunk)) {
            const size_t n = static_cast<size_t>(
                frames - off < static_cast<long>(kChunk)
                    ? frames - off : static_cast<long>(kChunk));
            for (size_t i = 0; i < n; ++i) {
                // scale by 32768 with round-half-even then clamp —
                // matches the Python encoder (wavio.py: np.round of
                // audio*32768, clipped to [-32768, 32767])
                long v = std::lrint(
                    static_cast<double>(samples[off + i]) * 32768.0);
                if (v > 32767) v = 32767;
                if (v < -32768) v = -32768;
                buf[i] = static_cast<int16_t>(v);
            }
            ok = std::fwrite(buf.data(), sizeof(int16_t), n, f) == n;
        }
    }
    if (std::fclose(f) != 0) ok = false;
    return ok ? 0 : -1;
}

}  // extern "C"
