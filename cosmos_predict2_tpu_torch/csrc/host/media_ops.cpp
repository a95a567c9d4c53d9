// Host-side media preprocessing kernels (C++), loaded via ctypes.
//
// Fills the role of the reference's native video-decode/preprocess layer
// (decord/ffmpeg + torchvision resize ops): the per-frame uint8
// resize/crop/normalize work that feeds the data pipeline runs as tight
// vectorizable loops on the host instead of per-frame Python/PIL calls.
//
// Built by cosmos_predict2_tpu_torch/utils/native.py on first use, with g++
// -O3 -march=native -shared -fPIC, into build/cosmos_torch_host/.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Bilinear resize of T RGB uint8 frames (T, H, W, 3) -> (T, OH, OW, 3).
// Uses half-pixel centers (align_corners=false), matching PIL/torchvision
// bilinear conventions.
void resize_bilinear_u8(const uint8_t* src, int64_t T, int64_t H, int64_t W,
                        uint8_t* dst, int64_t OH, int64_t OW) {
    const float sy = static_cast<float>(H) / OH;
    const float sx = static_cast<float>(W) / OW;
    // Precompute x coordinates/weights once per resize.
    int* x0s = new int[OW];
    int* x1s = new int[OW];
    float* wxs = new float[OW];
    for (int64_t ox = 0; ox < OW; ++ox) {
        float fx = (ox + 0.5f) * sx - 0.5f;
        fx = std::max(0.0f, std::min(fx, static_cast<float>(W - 1)));
        int x0 = static_cast<int>(fx);
        x0s[ox] = x0;
        x1s[ox] = std::min<int>(x0 + 1, W - 1);
        wxs[ox] = fx - x0;
    }
    for (int64_t t = 0; t < T; ++t) {
        const uint8_t* frame = src + t * H * W * 3;
        uint8_t* out = dst + t * OH * OW * 3;
        for (int64_t oy = 0; oy < OH; ++oy) {
            float fy = (oy + 0.5f) * sy - 0.5f;
            fy = std::max(0.0f, std::min(fy, static_cast<float>(H - 1)));
            int y0 = static_cast<int>(fy);
            int y1 = std::min<int>(y0 + 1, H - 1);
            float wy = fy - y0;
            const uint8_t* row0 = frame + y0 * W * 3;
            const uint8_t* row1 = frame + y1 * W * 3;
            uint8_t* orow = out + oy * OW * 3;
            for (int64_t ox = 0; ox < OW; ++ox) {
                int x0 = x0s[ox] * 3, x1 = x1s[ox] * 3;
                float wx = wxs[ox];
                for (int c = 0; c < 3; ++c) {
                    float top = row0[x0 + c] + (row0[x1 + c] - row0[x0 + c]) * wx;
                    float bot = row1[x0 + c] + (row1[x1 + c] - row1[x0 + c]) * wx;
                    float v = top + (bot - top) * wy;
                    orow[ox * 3 + c] = static_cast<uint8_t>(v + 0.5f);
                }
            }
        }
    }
    delete[] x0s;
    delete[] x1s;
    delete[] wxs;
}

// Nearest-neighbor resize (used for padding masks).
void resize_nearest_u8(const uint8_t* src, int64_t T, int64_t H, int64_t W,
                       uint8_t* dst, int64_t OH, int64_t OW) {
    for (int64_t t = 0; t < T; ++t) {
        const uint8_t* frame = src + t * H * W * 3;
        uint8_t* out = dst + t * OH * OW * 3;
        for (int64_t oy = 0; oy < OH; ++oy) {
            int64_t y = std::min<int64_t>(static_cast<int64_t>((oy + 0.5) * H / OH), H - 1);
            for (int64_t ox = 0; ox < OW; ++ox) {
                int64_t x = std::min<int64_t>(static_cast<int64_t>((ox + 0.5) * W / OW), W - 1);
                std::memcpy(out + (oy * OW + ox) * 3, frame + (y * W + x) * 3, 3);
            }
        }
    }
}

// Center crop (T, H, W, 3) -> (T, CH, CW, 3).
void center_crop_u8(const uint8_t* src, int64_t T, int64_t H, int64_t W,
                    uint8_t* dst, int64_t CH, int64_t CW) {
    const int64_t top = (H - CH) / 2;
    const int64_t left = (W - CW) / 2;
    for (int64_t t = 0; t < T; ++t) {
        for (int64_t y = 0; y < CH; ++y) {
            std::memcpy(dst + (t * CH + y) * CW * 3,
                        src + ((t * H) + top + y) * W * 3 + left * 3,
                        CW * 3);
        }
    }
}

// uint8 [0,255] -> float32 [-1,1] (x/127.5 - 1).
void u8_to_pm1_f32(const uint8_t* src, int64_t n, float* dst) {
    constexpr float inv = 1.0f / 127.5f;
    for (int64_t i = 0; i < n; ++i) {
        dst[i] = src[i] * inv - 1.0f;
    }
}

}  // extern "C"
