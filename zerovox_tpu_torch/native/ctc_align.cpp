// Native CTC Viterbi forced alignment.
//
// The offline preprocessor aligns every corpus utterance (reference
// utils/preprocess.py:421 uses torchaudio's C++ forced_align); the numpy
// version, `forced_align_plain` in zerovox_tpu_torch/preprocess/ctc_align.py,
// loops over frames in Python. This is the same DP as a single O(T*S) C++
// pass: blank-interleaved target states, {stay, advance, skip} transitions,
// backpointer trace. Built at first use by zerovox_tpu_torch/native/__init__.py.
//
// ABI (ctypes):
//   int zv_forced_align(const float* log_probs, long T, long C,
//                       const long* targets, long N, long blank,
//                       long* out_tokens, float* out_scores)
// returns 0 on success, -1 when T is too short for the target sequence.

#include <cstdint>
#include <cstring>
#include <vector>
#include <limits>

namespace {
constexpr float kNegInf = -std::numeric_limits<float>::infinity();
}

extern "C" int zv_forced_align(const float* log_probs, int64_t T, int64_t C,
                               const int64_t* targets, int64_t N, int64_t blank,
                               int64_t* out_tokens, float* out_scores) {
    if (N == 0) {
        for (int64_t t = 0; t < T; ++t) {
            out_tokens[t] = blank;
            out_scores[t] = log_probs[t * C + blank];
        }
        return 0;
    }

    // minimal frames: one per target plus one per adjacent repeat
    int64_t min_frames = N;
    for (int64_t i = 1; i < N; ++i)
        if (targets[i] == targets[i - 1]) ++min_frames;
    if (T < min_frames) return -1;

    const int64_t S = 2 * N + 1;
    std::vector<int64_t> ext(S, blank);
    for (int64_t i = 0; i < N; ++i) ext[2 * i + 1] = targets[i];

    std::vector<uint8_t> can_skip(S, 0);
    for (int64_t s = 2; s < S; ++s)
        can_skip[s] = (ext[s] != blank && ext[s] != ext[s - 2]) ? 1 : 0;

    std::vector<float> alpha(S, kNegInf), next(S, kNegInf);
    std::vector<int8_t> backptr(static_cast<size_t>(T) * S, 0);

    alpha[0] = log_probs[ext[0]];
    if (S > 1) alpha[1] = log_probs[ext[1]];

    for (int64_t t = 1; t < T; ++t) {
        const float* row = log_probs + t * C;
        int8_t* bp = backptr.data() + static_cast<size_t>(t) * S;
        for (int64_t s = 0; s < S; ++s) {
            float best = alpha[s];
            int8_t choice = 0;
            if (s >= 1 && alpha[s - 1] > best) { best = alpha[s - 1]; choice = 1; }
            if (s >= 2 && can_skip[s] && alpha[s - 2] > best) { best = alpha[s - 2]; choice = 2; }
            bp[s] = choice;
            next[s] = (best == kNegInf) ? kNegInf : best + row[ext[s]];
        }
        alpha.swap(next);
    }

    int64_t s = (alpha[S - 1] >= alpha[S - 2]) ? S - 1 : S - 2;
    for (int64_t t = T - 1; t >= 0; --t) {
        out_tokens[t] = ext[s];
        out_scores[t] = log_probs[t * C + ext[s]];
        s -= backptr[static_cast<size_t>(t) * S + s];
    }
    return 0;
}
