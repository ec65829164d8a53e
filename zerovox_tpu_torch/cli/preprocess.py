"""Corpus preprocessing CLI (`zerovox-torch-preprocess`).

Surface parity with the reference (utils/preprocess.py:659-766) and the JAX
package's `cli/preprocess.py`: takes a model config + corpus yamls (files or
directories), runs forced alignment then audio feature extraction, writes
per-corpus stats.json, prints leftover punctuation characters. `--aligner`
selects the alignment acoustic model; `--device cuda|cpu` (default: the
card) is where the aligner's emissions and the mel frontend run. `main`
reads the YAMLs; `run` takes them parsed and needs no pyyaml.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time

import numpy as np


def collect_corpus_configs(paths) -> list[dict]:
    import yaml  # only YAML reading needs it

    configs = []
    for corpusfn in paths:
        if os.path.isdir(corpusfn):
            for cfn in sorted(os.listdir(corpusfn)):
                if os.path.splitext(cfn)[1] != ".yaml":
                    continue
                with open(os.path.join(corpusfn, cfn)) as f:
                    configs.append(yaml.load(f, Loader=yaml.FullLoader))
        else:
            with open(corpusfn) as f:
                configs.append(yaml.load(f, Loader=yaml.FullLoader))
    if not configs:
        raise Exception("*** error: no .yaml files found!")
    return configs


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("modelcfg", type=str, help="model config to preprocess for")
    parser.add_argument("corpora", type=str, nargs="+",
                        help="path[s] to corpus .yaml config file[s] or directorie[s]")
    parser.add_argument("-l", "--limit", type=int, default=1000,
                        help="limit number of audio files per config, default 1000 (0=unlimited)")
    parser.add_argument("-j", "--num-jobs", type=int, default=multiprocessing.cpu_count())
    parser.add_argument("-m", "--min-alignment-score", type=float, default=0.9)
    parser.add_argument("-b", "--batch-size", type=int, default=4)
    parser.add_argument("--aligner", type=str, default=None,
                        help="alignment model (required): HF wav2vec2-CTC checkpoint "
                             "path, 'tone' (bundled tone-speak CTC), 'cluster:<units.npz>', "
                             "or 'pseudo' (explicitly accept NON-PHONETIC test alignments)")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="where the aligner's emissions and the mel frontend run "
                             "(default: the CUDA card, raising without one)")
    return parser.parse_args(argv)


def run(args, modelcfg: dict, corpus_configs: list[dict], base_path: str | None = None) -> dict:
    """Preprocess every corpus of `corpus_configs` for the parsed `modelcfg`
    into `base_path` (default: $ZEROVOX_PREPROCESSED_DATA_PATH). Returns
    {"jobs", "kept", "seconds", "stage_seconds": {stage: s}, "stats": {path:
    stats.json}}."""
    from zerovox_tpu_torch.preprocess.aligner import make_aligner
    from zerovox_tpu_torch.preprocess.pipeline import (AudioPreprocessor, Preprocessor,
                                                       gather_jobs_from_config)
    from zerovox_tpu_torch.training.data import preprocessed_data_path

    print(f"audio cfg:\n{modelcfg['audio']}")
    print(f"max txt len: {modelcfg['model']['max_txt_len']}, "
          f"max mel len: {modelcfg['model']['max_mel_len']}")
    print(f"{len(corpus_configs)} corpora found.")

    lang = None
    for corpus in corpus_configs:
        if lang is None:
            lang = corpus["language"]
        elif lang != corpus["language"]:
            raise Exception("inconsistent languages detected")
    print(f"language is {lang}")

    t0 = time.perf_counter()
    limit = args.limit if args.limit > 0 else 10**9
    base_path = base_path or preprocessed_data_path()
    pproc = Preprocessor(modelcfg, lang=lang, min_avg_score=args.min_alignment_score,
                         aligner=make_aligner(args.aligner, device=args.device))
    aproc = AudioPreprocessor(modelcfg=modelcfg, verbose=args.verbose, device=args.device)

    n_jobs = n_kept = 0
    all_stats = {}
    for cfg in corpus_configs:
        jobs = gather_jobs_from_config(cfg, base_path, limit=limit)
        print(f"gathered {len(jobs)} jobs.")
        n_jobs += len(jobs)

        out_dir = os.path.join(base_path, cfg["path"]["preprocessed_path"])
        pproc.align(jobs, out_dir=out_dir, batch_size=args.batch_size)

        pitch_min = energy_min = np.finfo(np.float64).max
        pitch_max = energy_max = np.finfo(np.float64).min

        for job in jobs:
            stats = aproc.process(job)
            if not stats:
                continue
            n_kept += 1
            pmin, pmax, emin, emax = stats
            pitch_min, pitch_max = min(pitch_min, pmin), max(pitch_max, pmax)
            energy_min, energy_max = min(energy_min, emin), max(energy_max, emax)

        stats = {"pitch": [float(pitch_min), float(pitch_max)],
                 "energy": [float(energy_min), float(energy_max)]}
        with open(os.path.join(out_dir, "stats.json"), "w") as f:
            json.dump(stats, f)
        all_stats[cfg["path"]["preprocessed_path"]] = stats

    print(f"extra puncts : {pproc.extra_puncts}")
    return {"jobs": n_jobs, "kept": n_kept, "seconds": time.perf_counter() - t0,
            "stage_seconds": {**pproc.seconds, **aproc.seconds}, "stats": all_stats}


def main(argv=None):
    import yaml  # the card's machine has none: only main reads YAML

    args = get_args(argv)
    with open(args.modelcfg) as f:
        modelcfg = yaml.load(f, Loader=yaml.FullLoader)
    run(args, modelcfg, collect_corpus_configs(args.corpora))


if __name__ == "__main__":
    main()
