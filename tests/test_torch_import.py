"""The PyTorch package stands alone: it imports with JAX and the JAX package
blocked, no file of it imports either, and its entry points never fall back
to the CPU on their own."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

PKG = Path(__file__).resolve().parent.parent / "zerovox_tpu_torch"


def test_imports_with_jax_and_jax_package_blocked():
    code = (
        "import sys\n"
        # the card's machine has no JAX, flax, pyyaml or msgpack
        "for m in ('jax', 'jaxlib', 'flax', 'zerovox_tpu', 'yaml', 'msgpack'):\n"
        "    sys.modules[m] = None\n"
        "import zerovox_tpu_torch\n"
        "from zerovox_tpu_torch import ZeroVoxTTS\n"
        "import zerovox_tpu_torch.weights, zerovox_tpu_torch.streaming\n"
        "import zerovox_tpu_torch.ops.mrf, zerovox_tpu_torch.ops.upsample_stage\n"
        "import zerovox_tpu_torch.text, zerovox_tpu_torch.utils.profiling\n"
        "import zerovox_tpu_torch.ops.se_conv, zerovox_tpu_torch.training.trainer\n"
        "import zerovox_tpu_torch.ops.resblock, zerovox_tpu_torch.models.styletts\n"
        "import zerovox_tpu_torch.models.layers, zerovox_tpu_torch.models.zerovox\n"
        "import zerovox_tpu_torch.serving, zerovox_tpu_torch.hub\n"
        "import zerovox_tpu_torch.cli.serve, zerovox_tpu_torch.cli.demo\n"
        "import zerovox_tpu_torch.training.checkpointing, zerovox_tpu_torch.utils.msgpack_codec\n"
        "import zerovox_tpu_torch.cli.train, zerovox_tpu_torch.training.data\n"
        "import zerovox_tpu_torch.training.vocoder, zerovox_tpu_torch.cli.train_vocoder\n"
        "import zerovox_tpu_torch.ops.pqmf, zerovox_tpu_torch.dsp.griffinlim\n"
        "import zerovox_tpu_torch.preprocess.pipeline, zerovox_tpu_torch.preprocess.tone_ctc\n"
        "import zerovox_tpu_torch.preprocess.units, zerovox_tpu_torch.preprocess.ctc_align\n"
        "import zerovox_tpu_torch.dsp.pitch, zerovox_tpu_torch.native\n"
        "import zerovox_tpu_torch.utils.synthvoice, zerovox_tpu_torch.cli.preprocess\n"
        "import zerovox_tpu_torch.cli.stats, zerovox_tpu_torch.cli.dump_ckpt\n"
        "import zerovox_tpu_torch.cli.edit_meldec, zerovox_tpu_torch.cli.export_hifigan\n"
        "import zerovox_tpu_torch.parallel, zerovox_tpu_torch.utils.compile_cache\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flax', 'msgpack', 'yaml', 'h5py',\n"
        "                                             'transformers'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_file_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|msgpack|zerovox_tpu)\b(?!_torch)",
                         re.M)
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    import numpy as np

    from zerovox_tpu_torch.dsp.mels import MelFrontend, get_mel_from_wav
    from zerovox_tpu_torch.preprocess.aligner import make_aligner
    from zerovox_tpu_torch.preprocess.pipeline import AudioPreprocessor
    from zerovox_tpu_torch.preprocess.tone_ctc import ToneCTCAligner
    from zerovox_tpu_torch.synthesize import ZeroVoxTTS

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ZeroVoxTTS.from_random()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ZeroVoxTTS.load_model("/nonexistent")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MelFrontend()
    assert MelFrontend(device="cpu").device.type == "cpu"
    wav = np.zeros(4096, np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_mel_from_wav(wav, 22050, 1024, 256, 1024, 80, 0, 8000)
    assert get_mel_from_wav(wav, 22050, 1024, 256, 1024, 80, 0, 8000, device="cpu")[0].shape[0] == 80
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ToneCTCAligner()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_aligner("tone")
    assert ToneCTCAligner(device="cpu").device.type == "cpu"
    audio = {"sampling_rate": 22050, "fft_size": 1024, "hop_size": 256, "win_length": 1024,
             "num_mels": 80, "fmin": 0, "fmax": 8000}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AudioPreprocessor({"audio": audio})
    assert AudioPreprocessor({"audio": audio}, device="cpu").device.type == "cpu"


def test_tool_clis_default_to_the_card(monkeypatch, tmp_path):
    from zerovox_tpu_torch.cli import export_hifigan, preprocess

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = preprocess.get_args(["m.yaml", "c.yaml", "--aligner", "pseudo"])
    assert args.device == "cuda"
    modelcfg = {"audio": {"sampling_rate": 22050, "fft_size": 1024, "hop_size": 256,
                          "win_length": 1024, "num_mels": 80, "fmin": 0, "fmax": 8000},
                "model": {"max_txt_len": 64, "min_mel_len": 1, "max_mel_len": 100,
                          "phones": "'-ab", "puncts": " ,."}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        preprocess.run(args, modelcfg, [{"language": "en"}], base_path=str(tmp_path))
    (tmp_path / "c.yaml").write_text("dataset: LJSpeech\nlanguage: en\n")
    (tmp_path / "modelcfg.yaml").write_text("{}\n")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_hifigan.main([str(tmp_path / "c.yaml"), "--out-dir", str(tmp_path / "o"),
                             "--model", str(tmp_path)])


def test_trainer_needs_a_card_unless_told_cpu(monkeypatch):
    from zerovox_tpu_torch.config import ZeroVoxConfig
    from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(ZeroVoxConfig(), TrainerConfig(), steps_per_epoch=1)
    assert Trainer(ZeroVoxConfig(), TrainerConfig(), steps_per_epoch=1,
                   device="cpu").device.type == "cpu"


def test_vocoder_trainer_needs_a_card_unless_told_cpu(monkeypatch):
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig
    from zerovox_tpu_torch.training.vocoder import (VocoderDataConfig, VocoderTrainer,
                                                    VocoderTrainerConfig)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (HifiGanConfig(), VocoderDataConfig(), VocoderTrainerConfig(), 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VocoderTrainer(*args)
    assert VocoderTrainer(*args, device="cpu").device.type == "cpu"
