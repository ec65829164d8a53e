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
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flax', 'msgpack', 'yaml'))\n"
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
    from zerovox_tpu_torch.synthesize import ZeroVoxTTS

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ZeroVoxTTS.from_random()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ZeroVoxTTS.load_model("/nonexistent")


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
