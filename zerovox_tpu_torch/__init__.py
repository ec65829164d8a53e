"""zerovox-tpu on PyTorch and CUDA.

The PyTorch/CUDA port of the JAX package `zerovox_tpu`, written for one
NVIDIA H100: the same zero-shot FastSpeech2 + HiFi-GAN synthesis, with the
JAX package's Pallas TPU kernels replaced by hand-written Hopper kernels
(`csrc/`). It imports nothing of the JAX package.

    from zerovox_tpu_torch import ZeroVoxTTS
    synth = ZeroVoxTTS.from_random(seed=0)        # on the CUDA card
    spkemb = synth.speaker_embed(wav)
    wav, phoneme, length = synth.tts("hello world", spkemb)
"""

__version__ = "0.1.0"

from zerovox_tpu_torch.symbols import Symbols

__all__ = ["Symbols", "ZeroVoxTTS", "__version__"]


def __getattr__(name):
    if name == "ZeroVoxTTS":
        from zerovox_tpu_torch.synthesize import ZeroVoxTTS

        return ZeroVoxTTS
    raise AttributeError(f"module 'zerovox_tpu_torch' has no attribute {name!r}")
