"""`zerovox-torch-train`: the acoustic-model training CLI on CUDA cards.

The JAX package's `zerovox-train` with the same arguments and defaults:
collects the corpus YAMLs (files or directories), merges their
`stats.json` into the global pitch/energy ranges, writes the merged
`modelcfg.yaml` (the inference contract), builds the data module and the
model, restores weights for incremental training (`--checkpoint`, a native
`.msgpack` or an upstream torch `.ckpt`; `--train-decoder-only` keeps the
fresh decoder), or `--resume`s the whole train state, and runs
`Trainer.fit`.

    export ZEROVOX_PREPROCESSED_DATA_PATH=/data/pp
    zerovox-torch-train -c modelcfg.yaml corpus.yaml --out-folder mymodel1

Defaults as the JAX CLI's: `--precision bf16-mixed`, `--optim-dtype auto`
(bf16 second moments on the card, float32 on the CPU), `--data-device-cache
auto` (on for one-process runs on the card), `--packed-speaker` 0 off the
TPU (in the port it only gates `--fused-speaker`, whose stage 1 runs K4).
It runs on the CUDA card; `--accelerator cpu` runs it on the CPU; without a
card the default raises. Data parallel, one process a device
(`parallel/mesh.py`): `--devices N` spawns N ranks on `cuda:0..N-1` (or N
CPU ranks with `--accelerator cpu`), each on its block of every global
batch of `--batch-size` rows, with the device corpus cache per rank;
`--devices -1`, the default, takes every visible card, which on a machine
with one card is the single-process run. `--distributed` joins a
multi-host job (one process a card; `--coordinator-address host:port`,
`--num-processes`, `--process-id`, or torchrun's variables): each process
loads its own batches of `--batch-size` rows, shuffled with its rank as the
seed, without the device cache unless asked. Rank 0 writes the
checkpoints and logs. The kernel build cache is `ZEROVOX_COMPILE_CACHE`'s
(`utils/compile_cache.py`); its counters are printed at the end.

YAML is read and written only by `main`; `run(args, modelcfg, corpora)`
takes the parsed dicts, so it runs where pyyaml is missing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

from zerovox_tpu_torch.config import ZeroVoxConfig
from zerovox_tpu_torch.hub import DEFAULT_MELDEC_MODEL_NAME
from zerovox_tpu_torch.symbols import Symbols


def resolve_optim_dtype(spec: str, accelerator: str) -> str:
    """'auto' -> bf16 second moments on the card, f32 on the CPU."""
    if spec != "auto":
        return spec
    if accelerator != "cpu":
        print("optim-dtype auto -> bf16 second moments (accelerator backend)")
        return "bf16"
    return "f32"


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--accelerator", type=str, default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--devices", type=int, default=-1,
                        help="data-parallel processes, one a card (-1: every visible card; "
                             "with --accelerator cpu, CPU ranks)")
    parser.add_argument("--threads", type=int, default=24)
    parser.add_argument("--precision", default="bf16-mixed",
                        help="bf16-mixed (forward and backward in bf16) or 32")
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("-c", "--model-config", type=str, required=True,
                        help="Path to model config.yaml")
    parser.add_argument("corpora", type=str, nargs="+", help="Path to corpus .yamls")
    parser.add_argument("--out-folder", default="mymodel1", type=str,
                        help="Output folder for checkpoints, modelcfg and validation data")
    parser.add_argument("--meldec-model", default=DEFAULT_MELDEC_MODEL_NAME, type=str)
    parser.add_argument("--name", type=str, help="run name (optional)")
    parser.add_argument("--checkpoint", default=None, type=str,
                        help="Path to model checkpoint file (torch .ckpt or native .msgpack)")
    parser.add_argument("--resume", action="store_true",
                        help="resume a killed run from the newest train-state checkpoint in "
                             "--out-folder: weights, Adam moments and LR position, continuing "
                             "at the next epoch (implies --checkpoint-format state)")
    parser.add_argument("--keep-checkpoints", type=int, default=0,
                        help="prune to the newest N checkpoints (0 = keep all)")
    parser.add_argument("--checkpoint-every-n-epochs", type=int, default=1,
                        help="save a checkpoint every N epochs (last epoch always saved)")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--train-decoder-only", action="store_true")
    parser.add_argument("--remat", action="store_true",
                        help="recompute FFT blocks in the backward: more FLOPs for less "
                             "activation memory")
    parser.add_argument("--remat-speaker", action="store_true",
                        help="recompute the speaker encoder's unfused blocks in the backward "
                             "(a memory lever)")
    parser.add_argument("--optim-dtype", default="auto", choices=["auto", "f32", "bf16"],
                        help="second-moment storage dtype: bf16 halves the optimizer's nu "
                             "stream (requires betas[0]=0); 'auto' picks bf16 on the card, "
                             "f32 on the CPU")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="capture a torch.profiler trace of the first trained steps into "
                             "DIR (the first step excluded)")
    parser.add_argument("--profile-steps", type=int, default=10)
    parser.add_argument("--packed-speaker", type=int, nargs="?", const=1, default=None,
                        choices=[0, 1, 2],
                        help="the JAX package's lane packing level of the speaker encoder "
                             "(same math and checkpoints); default 0 off the TPU. "
                             "--fused-speaker needs >= 1")
    parser.add_argument("--fused-speaker", type=int, nargs="?", const=1, default=0,
                        choices=[0, 1],
                        help="run the speaker encoder's stage 1 through the fused K4 conv "
                             "passes (same math and checkpoints). Requires --packed-speaker >= 1")
    parser.add_argument("--data-device-cache", default="auto", choices=["auto", "on", "off"],
                        help="keep the whole bucket-padded corpus on the card and gather "
                             "batches there; auto = on for one-process runs on the card; "
                             "corpora over the budget fall back to host loading")
    parser.add_argument("--max-epochs", type=int, default=40)
    parser.add_argument("--warmup-epochs", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=24, help="batch size")
    parser.add_argument("--checkpoint-format", default="msgpack", choices=["msgpack", "state"],
                        help="state = the native msgpack plus the whole train state "
                             "(state/NNNN.pt), which --resume reads")
    parser.add_argument("--distributed", action="store_true",
                        help="join a multi-host data-parallel job: one process a card, each "
                             "loading its own batches (coordinator from --coordinator-address "
                             "or torchrun's environment)")
    parser.add_argument("--coordinator-address", type=str, default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    return parser.parse_args(argv)


def check_args(args) -> None:
    """Raise on flags that contradict each other, and on more `--devices`
    than the machine has."""
    from zerovox_tpu_torch.parallel.mesh import device_count

    device_count(args.devices, args.accelerator)
    if args.distributed and args.devices > 1:
        raise ValueError("--distributed runs one process a card: start one process per card "
                         "instead of --devices > 1")
    if not args.distributed and (args.coordinator_address is not None
                                 or args.num_processes is not None
                                 or args.process_id is not None):
        raise ValueError("--coordinator-address, --num-processes and --process-id go with "
                         "--distributed")


def merge_stats(modelcfg: dict, corpora, base_path: str) -> dict:
    """Merge per-corpus stats.json into global min/max + langs."""
    modelcfg["stats"] = {
        "energy_min": sys.float_info.max,
        "energy_max": -sys.float_info.max,
        "pitch_min": sys.float_info.max,
        "pitch_max": -sys.float_info.max,
    }
    modelcfg["lang"] = []
    for corpus in corpora:
        if corpus["language"] not in modelcfg["lang"]:
            modelcfg["lang"].append(corpus["language"])
        with open(os.path.join(base_path, corpus["path"]["preprocessed_path"], "stats.json")) as f:
            stats = json.load(f)
        pmin, pmax = stats["pitch"][:2]
        emin, emax = stats["energy"][:2]
        s = modelcfg["stats"]
        s["pitch_min"] = min(s["pitch_min"], pmin)
        s["pitch_max"] = max(s["pitch_max"], pmax)
        s["energy_min"] = min(s["energy_min"], emin)
        s["energy_max"] = max(s["energy_max"], emax)
    return modelcfg


def model_config(args, modelcfg: dict) -> ZeroVoxConfig:
    """The merged modelcfg with the remat, packing and fused-stage flags."""
    cfg = ZeroVoxConfig.from_dict(modelcfg)
    if args.packed_speaker is None:
        args.packed_speaker = 0  # the JAX CLI packs only on the TPU
    mcfg = cfg.model
    if args.remat:
        mcfg = dataclasses.replace(mcfg, remat=True)
    if args.remat_speaker:
        mcfg = dataclasses.replace(mcfg, remat_speaker=True)
    if args.packed_speaker:
        mcfg = dataclasses.replace(mcfg, packed_speaker=args.packed_speaker)
    if args.fused_speaker:
        if not (args.packed_speaker or mcfg.packed_speaker):
            raise SystemExit("--fused-speaker requires --packed-speaker >= 1")
        mcfg = dataclasses.replace(mcfg, fused_speaker=True)
    return dataclasses.replace(cfg, model=mcfg)


def run(args, modelcfg: dict, corpora: list[dict]) -> dict | None:
    """Train on the merged `modelcfg` (after `merge_stats`) and the parsed
    corpora. Returns {"trainer", "state", "datamodule", "cfg"} of this
    process; None where it spawned the ranks (`--devices N`), which return
    when training has ended."""
    from zerovox_tpu_torch.parallel.mesh import (device_count, initialize_distributed,
                                                 make_mesh, spawn_data_parallel)
    from zerovox_tpu_torch.utils.compile_cache import enable_compile_cache

    check_args(args)
    enable_compile_cache()
    if args.distributed:
        # the card (cuda:LOCAL_RANK, raising without one) unless --accelerator cpu
        device = "cpu" if args.accelerator == "cpu" else None
        initialize_distributed(strict=True, coordinator_address=args.coordinator_address,
                               num_processes=args.num_processes, process_id=args.process_id,
                               device=device)
        mesh = make_mesh(devices=[device] if device else None, process_local=True)
        print(f"distributed: process {mesh.rank}/{mesh.world} on {mesh.devices[0]}")
        return _train(args, modelcfg, corpora, mesh)
    n = device_count(args.devices, args.accelerator)
    if n > 1:
        spawn_data_parallel(_train, n, args.accelerator, args, modelcfg, corpora)
        return None
    return _train(args, modelcfg, corpora, None)


def _train(args, modelcfg: dict, corpora: list[dict], mesh) -> dict:
    """The run of one process: alone (mesh None) or one rank of `mesh`."""
    from zerovox_tpu_torch.device import resolve_device
    from zerovox_tpu_torch.training.checkpointing import load_native_checkpoint
    from zerovox_tpu_torch.training.data import SpeechDataModule
    from zerovox_tpu_torch.training.trainer import Trainer, TrainerConfig
    from zerovox_tpu_torch.utils.compile_cache import format_cache_stats

    cfg = model_config(args, modelcfg)
    symbols = Symbols(modelcfg["model"]["phones"], modelcfg["model"]["puncts"])
    device = mesh.devices[0] if mesh is not None else resolve_device(args.accelerator)
    process_local = mesh is not None and mesh.process_local
    rank = mesh.rank if mesh is not None else 0
    if args.data_device_cache == "auto":
        # one host's process a card: ship the corpus once, gather batches there;
        # a multi-host job's processes each load their own batches
        use_device_cache = device.type == "cuda" and not process_local
    else:
        use_device_cache = args.data_device_cache == "on"
    datamodule = SpeechDataModule(
        corpora=corpora, symbols=symbols, stats=modelcfg["stats"], batch_size=args.batch_size,
        num_workers=args.num_workers, seed=rank if process_local else 0,
        device_cache=use_device_cache, device=device)
    datamodule.prepare_data()
    print(f"{len(datamodule.train_dataset)} training samples")

    tcfg = TrainerConfig(
        max_epochs=args.max_epochs, warmup_epochs=args.warmup_epochs,
        out_folder=args.out_folder, name=args.name,
        train_decoder_only=args.train_decoder_only,
        precision="bf16-mixed" if "16" in str(args.precision) else "32",
        checkpoint_format="state" if args.resume else args.checkpoint_format,
        keep_checkpoints=args.keep_checkpoints,
        checkpoint_every_n_epochs=args.checkpoint_every_n_epochs,
        profile_dir=args.profile, profile_steps=args.profile_steps,
        optim_dtype=resolve_optim_dtype(args.optim_dtype, device.type))
    trainer = Trainer(cfg, tcfg, steps_per_epoch=datamodule.steps_per_epoch(), device=device,
                      mesh=mesh)
    state = trainer.init_state()

    start_epoch = 0
    if args.resume:
        state, start_epoch = trainer.resume_from(state)
    elif args.checkpoint:
        print(f"incremental training mode: restoring model weights from {args.checkpoint}")
        if str(args.checkpoint).endswith(".msgpack"):
            from zerovox_tpu_torch.weights import from_jax_variables

            state_dict = from_jax_variables(load_native_checkpoint(args.checkpoint), cfg)
        else:
            from zerovox_tpu_torch.synthesize import _torch_state_dict
            from zerovox_tpu_torch.weights import upstream_state_dict

            state_dict = upstream_state_dict(_torch_state_dict(args.checkpoint), state.model)
        state = trainer.restore_into(state, state_dict, reinit_decoder=args.train_decoder_only)

    trainer.fit(datamodule.train_dataloader, state, start_epoch=start_epoch)
    if rank == 0:
        print(format_cache_stats())
    return {"trainer": trainer, "state": state, "datamodule": datamodule, "cfg": cfg}


def main(argv=None):
    import yaml  # the card's machine has none: only main reads and writes YAML

    from zerovox_tpu_torch.cli.preprocess import collect_corpus_configs
    from zerovox_tpu_torch.training.data import preprocessed_data_path

    args = get_args(argv)
    check_args(args)
    print("collecting .yaml files from specified paths...")
    corpora = collect_corpus_configs(args.corpora)
    print(f"{len(corpora)} corpus .yaml files found.")
    with open(args.model_config) as f:
        modelcfg = yaml.load(f, Loader=yaml.FullLoader)
    modelcfg = merge_stats(modelcfg, corpora, preprocessed_data_path())
    model_config(args, dict(modelcfg))  # flag errors before anything is written
    os.makedirs(args.out_folder, exist_ok=True)
    name = f"modelcfg_{args.name}.yaml" if args.name else "modelcfg.yaml"
    with open(Path(args.out_folder) / name, "w") as f:
        yaml.dump(modelcfg, f, default_flow_style=False)
    return run(args, modelcfg, corpora)


if __name__ == "__main__":
    main()
