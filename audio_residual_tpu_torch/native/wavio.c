/* Host-side audio decode for the data loader: PCM16 / PCM32 WAV frames to
 * mono float32 (the mean over channels). Called through ctypes
 * (audio_residual_tpu_torch/native/__init__.py), built with gcc -O3 at
 * first use. The numpy functions beside the loader compute the same values
 * in the same order; tests hold these against them bit for bit.
 */

#include <stddef.h>
#include <stdint.h>

/* interleaved int16 frames -> mono float32; returns n_frames */
long wav_pcm16_to_float32_mono(const int16_t *in, long n_frames, int channels, float *out) {
    const float scale = 1.0f / 32768.0f;
    if (channels == 1) {
        for (long i = 0; i < n_frames; ++i) out[i] = in[i] * scale;
    } else {
        const float inv_c = 1.0f / channels;
        for (long i = 0; i < n_frames; ++i) {
            float acc = 0.0f;
            const int16_t *f = in + (size_t)i * channels;
            for (int c = 0; c < channels; ++c) acc += f[c];
            out[i] = acc * scale * inv_c;
        }
    }
    return n_frames;
}

/* interleaved int32 frames -> mono float32; returns n_frames */
long wav_pcm32_to_float32_mono(const int32_t *in, long n_frames, int channels, float *out) {
    const float scale = 1.0f / 2147483648.0f;
    const float inv_c = 1.0f / channels;
    for (long i = 0; i < n_frames; ++i) {
        float acc = 0.0f;
        const int32_t *f = in + (size_t)i * channels;
        for (int c = 0; c < channels; ++c) acc += f[c] * scale;
        out[i] = acc * inv_c;
    }
    return n_frames;
}
