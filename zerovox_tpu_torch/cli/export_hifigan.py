"""Vocoder-adaptation corpus exporter (`zerovox-torch-export-hifigan`).

Surface parity with reference utils/export_hifigan.py and the JAX package's
`cli/export_hifigan.py`: runs the trained TTS over the training corpus with
teacher durations (`force_duration`) so the synthesized mel is frame-aligned
with the ground-truth audio, and writes paired (ground-truth wav |
synthesized wav | mel .h5 feats | text) into train/dev splits (1/100 to dev)
for external HiFiGAN/ParallelWaveGAN fine-tuning. `--orig` exports
ground-truth mels instead.

Two steps: `export_items` runs the engine's model and vocoder on its device
and yields one `ExportItem` per utterance (`export_batch` does one batch);
`write_item` writes one (h5py is imported there only). `export_items` takes the parsed corpus and model
configs and an engine, so it needs no pyyaml; `main` reads the YAMLs.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class ExportItem:
    split: str  # "train" or "dev"
    item_dir: str  # the corpus's preprocessed dir name, the item's folder under split/
    basename: str
    orig_wav: np.ndarray  # [wav_len * hop] float32, the ground truth
    synth_wav: np.ndarray  # [wav_len * hop] float32, the vocoded mel
    mel: np.ndarray  # [wav_len, n_mels], synthesized (or ground truth with orig)
    text: str


def export_items(corpora: list[dict], modelcfg: dict, engine, batch_size: int = 8,
                 num_workers: int = 4, orig: bool = False, base_path: str | None = None):
    """Yield an ExportItem for every utterance of `corpora`: the model's
    teacher-forced forward and the vocoder over batches of `batch_size` on
    the engine's device (the tail batch's wrap-around pad items skipped)."""
    from zerovox_tpu_torch.symbols import Symbols
    from zerovox_tpu_torch.training.data import SpeechDataModule

    symbols = Symbols(modelcfg["model"]["phones"], modelcfg["model"]["puncts"])
    datamodule = SpeechDataModule(
        corpora=corpora, symbols=symbols, stats=modelcfg["stats"], batch_size=batch_size,
        num_workers=num_workers, base_path=base_path,
        drop_last=False)  # export every sample; the tail batch is wrap-padded
    datamodule.prepare_data()
    cnt = 0
    for x, y in datamodule.train_dataloader():
        for item in export_batch(engine, x, y, modelcfg["audio"]["hop_size"], orig, cnt):
            cnt += 1
            yield item


def export_batch(engine, x: dict, y: dict, hop_length: int, orig: bool = False,
                 start: int = 0):
    """The ExportItems of one data-module batch (x, y); `start` items came
    before it (every 100th item goes to the dev split)."""
    import torch

    from zerovox_tpu_torch.dsp.audio import load_wav
    from zerovox_tpu_torch.training.trainer import device_batch

    batch = device_batch((x, y), engine.device)
    batch = {k: v.to(engine._dtype) if v.is_floating_point() else v for k, v in batch.items()}
    with torch.inference_mode():
        mels = engine._model(batch, train=False, force_duration=True)["mel"]
        if orig:
            mels = batch["mel"]
        wavs = engine._meldec(mels, normalize_before=True).float().cpu().numpy()
        mels = mels.float().cpu().numpy()

    for i in range(wavs.shape[0] - x.get("pad_items", 0)):
        wav_len = int(x["mel_len"][i])
        dur_sum = int(np.sum(x["duration"][i]))
        if wav_len != dur_sum:
            raise ValueError(f"{x['basenames'][i]}: {wav_len} mel frames but durations "
                             f"sum to {dur_sum}")

        orig_wav_path = os.path.join(x["preprocessed_paths"][i], "wavs",
                                     x["basenames"][i] + ".wav")
        orig_wav, _ = load_wav(orig_wav_path)
        orig_wav = orig_wav[x["starts"][i] * hop_length : (x["ends"][i] + 1) * hop_length]
        padding_needed = wav_len * hop_length - len(orig_wav)
        if padding_needed > 0:
            print(f"warning: padding of {padding_needed} samples needed for {orig_wav_path}")
            orig_wav = np.pad(orig_wav, (0, padding_needed))

        yield ExportItem(split="dev" if (start + i + 1) % 100 == 0 else "train",
                         item_dir=os.path.basename(x["preprocessed_paths"][i]),
                         basename=x["basenames"][i],
                         orig_wav=orig_wav[: wav_len * hop_length],
                         synth_wav=wavs[i][: wav_len * hop_length],
                         mel=mels[i][:wav_len], text=x["text"][i])


def write_item(out_dir: str, item: ExportItem, sampling_rate: int) -> None:
    """Write one item as the JAX exporter does: `<base>.wav`,
    `<base>-synth.wav`, `<base>.h5` (feats, wave) and `<base>.txt` under
    out_dir/<split>/<corpus dir>/."""
    import h5py  # only the .h5 writer needs it

    from zerovox_tpu_torch.dsp.audio import save_wav

    d = os.path.join(out_dir, item.split, item.item_dir)
    os.makedirs(d, mode=0o755, exist_ok=True)
    save_wav(os.path.join(d, f"{item.basename}.wav"), item.orig_wav, sampling_rate)
    save_wav(os.path.join(d, f"{item.basename}-synth.wav"), item.synth_wav, sampling_rate)
    with h5py.File(os.path.join(d, f"{item.basename}.h5"), "w") as hdf:
        hdf.create_dataset("feats", data=item.mel)
        hdf.create_dataset("wave", data=item.orig_wav.astype(np.float32))
    with open(os.path.join(d, f"{item.basename}.txt"), "w") as f:
        f.write(item.text)


def main(argv=None):
    import yaml  # only main reads YAML

    from zerovox_tpu_torch.cli.preprocess import collect_corpus_configs
    from zerovox_tpu_torch.hub import DEFAULT_MELDEC_MODEL_NAME, get_default_model
    from zerovox_tpu_torch.synthesize import ZeroVoxTTS

    parser = argparse.ArgumentParser()
    parser.add_argument("corpora", type=str, nargs="+", help="corpus yaml(s) or dir(s)")
    parser.add_argument("--out-dir", type=str, required=True)
    parser.add_argument("--model", type=str, default=None,
                        help="TTS model dir (default: language default model)")
    parser.add_argument("--meldec-model", default=DEFAULT_MELDEC_MODEL_NAME, type=str)
    parser.add_argument("--orig", action="store_true",
                        help="export ground-truth mels instead of synthesized")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="where the model and the vocoder run (default: the CUDA card)")
    args = parser.parse_args(argv)

    corpora = collect_corpus_configs(args.corpora)
    lang = None
    for corpus in corpora:
        if lang is None:
            lang = corpus["language"]
        elif lang != corpus["language"]:
            raise Exception(f"multiple languages detected: {lang} != {corpus['language']}")

    model_dir = args.model or get_default_model(lang=str(lang))
    with open(os.path.join(model_dir, "modelcfg.yaml")) as f:
        modelcfg = yaml.load(f, Loader=yaml.FullLoader)
    _, engine = ZeroVoxTTS.load_model(model_dir, meldec_model=args.meldec_model,
                                      verbose=args.verbose, device=args.device)

    os.makedirs(os.path.join(args.out_dir, "train"), mode=0o755, exist_ok=True)
    os.makedirs(os.path.join(args.out_dir, "dev"), mode=0o755, exist_ok=True)
    cnt = 0
    for item in export_items(corpora, modelcfg, engine, args.batch_size, args.num_workers,
                             args.orig):
        write_item(args.out_dir, item, modelcfg["audio"]["sampling_rate"])
        cnt += 1
    print(f"exported {cnt} items to {args.out_dir}")


if __name__ == "__main__":
    main()
