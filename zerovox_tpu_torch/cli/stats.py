"""Corpus statistics CLI (`zerovox-torch-stats`): total audio hours +
speaker count per corpus set (surface parity with reference
utils/stats.py:26-84 and the JAX package's `cli/stats.py`, computed from the
mel frame counts of the preprocessed features). `main` reads the YAMLs;
`run` takes them parsed."""

from __future__ import annotations

import argparse
import os

import numpy as np


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("modelcfg", type=str, help="model config preprocessing was done for")
    parser.add_argument("corpora", type=str, nargs="+",
                        help="path[s] to corpus .yaml config file[s] or directorie[s]")
    parser.add_argument("--verbose", action="store_true")
    return parser.parse_args(argv)


def run(modelcfg: dict, corpus_sets: list[tuple[str, list[dict]]],
        base: str | None = None) -> list[dict]:
    """One line per corpus set ((argument, its parsed corpus configs)), as
    the JAX CLI prints it; returns [{"corpus", "lang", "speakers", "hours"}]."""
    from zerovox_tpu_torch.training.data import preprocessed_data_path

    print(f"audio cfg:\n{modelcfg['audio']}")
    sampling_rate = modelcfg["audio"]["sampling_rate"]
    hop_length = modelcfg["audio"]["hop_size"]
    base = base or preprocessed_data_path()

    out = []
    for corpusfn, corpus_configs in corpus_sets:
        lang = None
        for corpus in corpus_configs:
            if lang is None:
                lang = corpus["language"]
            elif lang != corpus["language"]:
                raise Exception("inconsistent languages detected")

        num_speakers = 0
        total_length = 0.0
        for pc in corpus_configs:
            num_speakers += 1
            mel_dir = os.path.join(base, pc["path"]["preprocessed_path"], "mel")
            if not os.path.isdir(mel_dir):
                continue
            for melfn in os.listdir(mel_dir):
                if melfn.endswith(".npy"):
                    mel = np.load(os.path.join(mel_dir, melfn), mmap_mode="r")
                    total_length += float(mel.shape[0]) * hop_length / sampling_rate

        print(f"{corpusfn}: lang={lang} speakers={num_speakers} "
              f"hours={total_length / 3600.0:.2f}")
        out.append({"corpus": corpusfn, "lang": lang, "speakers": num_speakers,
                    "hours": total_length / 3600.0})
    return out


def main(argv=None):
    import yaml  # only main reads YAML

    from zerovox_tpu_torch.cli.preprocess import collect_corpus_configs

    args = get_args(argv)
    with open(args.modelcfg) as f:
        modelcfg = yaml.load(f, Loader=yaml.FullLoader)
    run(modelcfg, [(fn, collect_corpus_configs([fn])) for fn in args.corpora])


if __name__ == "__main__":
    main()
