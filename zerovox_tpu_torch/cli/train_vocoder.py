"""`zerovox-torch-train-vocoder`: HiFi-GAN GAN training on CUDA cards.

The JAX package's `zerovox-train-vocoder` with the same arguments and
defaults (`training/vocoder.py`): it trains on preprocess output dirs
(`train.txt` + `wavs/` + `mel/`) and/or `.h5` export dirs, and writes the
inference contract `config.json` + `generator.msgpack` that both
packages' engines load as a meldec dir.

    zerovox-torch-train-vocoder --data /data/pp/real --out-folder myvoc1 \\
        --max-epochs 200 --batch-size 16

It runs on the CUDA card; `--accelerator cpu` runs it on the CPU, and
without a card the default raises. `--devices N` trains data parallel, one
process a card on `cuda:0..N-1` (N CPU ranks with `--accelerator cpu`),
each on its block of every batch of `--batch-size` rows; -1, the default,
takes every visible card, as the JAX trainer's mesh does. `--checkpoint`
resumes the whole GAN state from a `checkpoints/vocoder-NNNN.pt` this CLI
wrote or a `vocoder-NNNN.msgpack` the JAX package's trainer wrote, and
continues at the epoch after the file's (the JAX CLI counts its epochs from
0 again after a resume). The kernel build cache is `ZEROVOX_COMPILE_CACHE`'s
(`utils/compile_cache.py`). `--bench` prints one JSON row instead of training: the
step's device milliseconds (CUDA events, the median marginal cost between
two chain lengths over BENCH_PAIRS pairs of chains, each chain after
BENCH_WARM untimed steps), its FLOP (counted over one step by
torch.utils.flop_counter) and the MFU against the H100's dense peak for
the precision.
"""

from __future__ import annotations

import argparse
import json

# H100 SXM dense peaks: float32 outside the tensor cores (TF32 is off), bf16
PEAK_FLOPS = {"32": 67e12, "bf16-mixed": 989e12}
BENCH_PAIRS = 3  # --bench: chain pairs (n1, n2 steps) whose marginal steps give the median
BENCH_WARM = 2  # --bench: untimed steps before each timed chain, as the JAX CLI's run(n)


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, nargs="+", required=True,
                   help="preprocess output dir(s) and/or h5 export dir(s)")
    p.add_argument("--out-folder", type=str, default="myvocoder1")
    p.add_argument("--accelerator", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--devices", type=int, default=-1,
                   help="data-parallel processes, one a card (-1: every visible card; with "
                        "--accelerator cpu, CPU ranks)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--max-epochs", type=int, default=200)
    p.add_argument("--segment-frames", type=int, default=32,
                   help="mel frames per training segment (32*hop=8192 samples, the upstream "
                        "HiFi-GAN default)")
    p.add_argument("--learning-rate", type=float, default=2e-4)
    p.add_argument("--precision", default="32", choices=["32", "bf16-mixed"],
                   help="'32' (default: GAN training is noise-sensitive) or 'bf16-mixed'")
    p.add_argument("--generator-config", type=str, default=None,
                   help="HiFi-GAN config.json (default: V1 80-mel 22k)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="resume the full GAN state from a checkpoints/vocoder-NNNN.pt, or from "
                        "the JAX trainer's vocoder-NNNN.msgpack; training continues at the "
                        "epoch after the file's (the JAX CLI restarts its count at 0)")
    p.add_argument("--checkpoint-every-n-epochs", type=int, default=25)
    p.add_argument("--log-every-n-epochs", type=int, default=1)
    p.add_argument("--mel-weight", type=float, default=45.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--gan-step", default="fused", choices=["fused", "split"],
                   help="'fused': one call per GAN round (the generator's forward once); "
                        "'split': the discriminators' and the generator's updates as two calls "
                        "(same math and order)")
    p.add_argument("--data-device-cache", default="on", choices=["on", "off"],
                   help="keep the (mel, wav) corpus on the device and cut training segments "
                        "there (bitwise the host batches); host loading over the budget")
    p.add_argument("--bench", action="store_true",
                   help="measure step time + FLOPs/MFU, print one JSON row, and exit without "
                        "training")
    p.add_argument("--bench-steps", type=int, default=20)
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)

    from zerovox_tpu_torch.parallel.mesh import device_count, spawn_data_parallel
    from zerovox_tpu_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    n = device_count(args.devices, args.accelerator)
    if n > 1:
        if args.bench:
            raise ValueError("--bench measures one process: run it with --devices 1")
        spawn_data_parallel(_train, n, args.accelerator, args)
        return None
    return _train(args, None)


def _train(args, mesh):
    """The run of one process: alone (mesh None) or one rank of `mesh`."""
    from zerovox_tpu_torch.device import resolve_device
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig
    from zerovox_tpu_torch.training.vocoder import (VocoderDataConfig, VocoderDataset,
                                                    VocoderTrainer, VocoderTrainerConfig)

    device = None if mesh is not None else resolve_device(args.accelerator)
    if args.generator_config:
        with open(args.generator_config) as f:
            gcfg = HifiGanConfig.from_dict(json.load(f))
    else:
        gcfg = HifiGanConfig()
    dcfg = VocoderDataConfig(num_mels=gcfg.num_mels, sampling_rate=gcfg.sampling_rate,
                             segment_frames=args.segment_frames)
    if gcfg.total_upsample != dcfg.hop_size:
        raise ValueError(f"generator upsample {gcfg.total_upsample} != hop {dcfg.hop_size}")

    dataset = VocoderDataset(args.data, dcfg, seed=args.seed)
    steps_per_epoch = max(1, (len(dataset) + args.batch_size - 1) // args.batch_size)
    print(f"vocoder corpus: {len(dataset)} items, {steps_per_epoch} steps/epoch at "
          f"B={args.batch_size}")
    tcfg = VocoderTrainerConfig(
        max_epochs=args.max_epochs, batch_size=args.batch_size,
        learning_rate=args.learning_rate, out_folder=args.out_folder,
        precision=args.precision, mel_weight=args.mel_weight,
        checkpoint_every_n_epochs=args.checkpoint_every_n_epochs,
        log_every_n_epochs=args.log_every_n_epochs, seed=args.seed,
        device_cache=args.data_device_cache == "on", split_step=args.gan_step == "split")
    trainer = VocoderTrainer(gcfg, dcfg, tcfg, steps_per_epoch, device=device, mesh=mesh)
    state = trainer.init_state()
    start_epoch = 0
    if args.checkpoint:
        start_epoch = trainer.restore_state(state, args.checkpoint)
        print(f"resumed GAN state from {args.checkpoint} (step {state.step}); continuing at "
              f"epoch {start_epoch}")

    if args.bench:
        return bench_step(args, trainer, dataset, state)

    state = trainer.fit(dataset, state, start_epoch=start_epoch)
    if trainer.rank == 0:
        gen_path = trainer.save_generator(state, args.out_folder)
        print(f"wrote {gen_path} (+ config.json): ready for --meldec-model {args.out_folder}")
    return None


def bench_step(args, trainer, dataset, state) -> dict:
    """One row: the step's milliseconds, the FLOP of one step and, on the
    card, the MFU against PEAK_FLOPS (null elsewhere). A chain of n steps on
    one batch runs BENCH_WARM untimed steps, then times its n (CUDA events on
    the card, from after the warm steps; the host clock on the CPU); the
    step is the median over BENCH_PAIRS pairs of chains of n1 and n2 steps,
    taken in turns, of the marginal cost (t(n2) - t(n1)) / (n2 - n1)."""
    import statistics
    import time

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    batch = next(iter(trainer.loader(dataset)(args.batch_size)))
    batch = {k: torch.as_tensor(v).to(trainer.device) for k, v in batch.items()}
    cuda = trainer.device.type == "cuda"
    with FlopCounterMode(display=False) as counter:
        trainer.train_step(state, batch)
    flops = float(counter.get_total_flops()) or None

    def chain(n: int) -> float:
        for _ in range(BENCH_WARM):
            trainer.train_step(state, batch)
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                trainer.train_step(state, batch)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            trainer.train_step(state, batch)
        return time.perf_counter() - t0

    n1 = max(args.bench_steps // 4, 1)
    n2 = max(args.bench_steps, n1 + 1)
    marginals = []
    for i in range(BENCH_PAIRS):  # in turns: n1 first, then n2 first
        if i % 2 == 0:
            t1 = chain(n1)
            t2 = chain(n2)
        else:
            t2 = chain(n2)
            t1 = chain(n1)
        marginals.append((t2 - t1) / (n2 - n1))
    step_s = statistics.median(marginals)
    # the peak is the H100's: a run elsewhere has none to divide by
    peak = PEAK_FLOPS[args.precision] if cuda else None
    row = {"batch": args.batch_size, "segment_frames": args.segment_frames,
           "precision": args.precision, "gan_step": args.gan_step,
           "device": str(trainer.device), "ms_per_step": 1e3 * step_s,
           "flops_per_step": flops, "peak_flops": peak,
           "mfu_pct": 100 * flops / step_s / peak if peak and flops and step_s > 0 else None}
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
