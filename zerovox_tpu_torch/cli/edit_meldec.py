"""Checkpoint surgery (`zerovox-torch-edit-meldec`): add or remove vocoder
weights in an acoustic checkpoint, so one self-contained inference artifact
can be shipped (surface parity with reference
utils/edit_meldec_in_checkpoint.py:48-94 and the JAX package's
`cli/edit_meldec.py`).

Native `.msgpack` checkpoints get the HiFi-GAN generator's params, in the
JAX package's layout (`weights.generator_to_jax_params`), under a "meldec"
key; torch `.ckpt` files get the raw upstream state dict under "_meldec.*"
keys exactly like the reference. `--meldec` is a directory holding
`generator.ckpt` (and `config.json`) or a hub model name, which is read
from the local hub cache only: this tool downloads nothing.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint", help="checkpoint to add/remove/replace meldec in")
    parser.add_argument("--meldec", type=str, default=None,
                        help="meldec model dir or cached hub name; omit to remove the meldec")
    args = parser.parse_args(argv)

    if args.checkpoint.endswith(".msgpack"):
        _edit_native(args.checkpoint, args.meldec)
    else:
        _edit_torch(args.checkpoint, args.meldec)
    print(f"{args.checkpoint} written.")


def _cached(meldec_spec: str, relpath: str) -> str:
    from zerovox_tpu_torch import hub

    path = hub.cache_path() / "model_repo" / meldec_spec / relpath
    if not path.exists() and relpath == "generator.ckpt":
        raise FileNotFoundError(f"{meldec_spec} is neither a directory nor in the hub cache "
                                f"({path} is missing); this tool downloads nothing")
    return str(path)


def _load_meldec_state_dict(meldec_spec):
    """(upstream generator state dict, HifiGanConfig) of a meldec dir or a
    cached hub model."""
    from zerovox_tpu_torch.models.hifigan import HifiGanConfig
    from zerovox_tpu_torch.synthesize import _torch_state_dict

    if os.path.isdir(str(meldec_spec)):
        gen_path = os.path.join(meldec_spec, "generator.ckpt")
        cfg_path = os.path.join(meldec_spec, "config.json")
    else:
        gen_path = _cached(str(meldec_spec), "generator.ckpt")
        cfg_path = _cached(str(meldec_spec), "config.json")

    cfg = HifiGanConfig()
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = HifiGanConfig.from_dict(json.load(f))
    return _torch_state_dict(gen_path), cfg


def _edit_native(path, meldec_spec):
    from zerovox_tpu_torch.training.checkpointing import (load_native_checkpoint,
                                                          save_native_checkpoint)
    from zerovox_tpu_torch.weights import generator_to_jax_params, upstream_generator_state_dict

    print(f"loading {path} ...")
    variables = load_native_checkpoint(path)
    if meldec_spec:
        sd, cfg = _load_meldec_state_dict(meldec_spec)
        gen = {k[len("generator."):]: v for k, v in upstream_generator_state_dict(sd).items()
               if k.startswith("generator.")}
        print("adding meldec params")
        variables["meldec"] = {"generator": generator_to_jax_params(gen, cfg)}
    else:
        if variables.pop("meldec", None) is not None:
            print("removing meldec params")
    save_native_checkpoint(path, variables)


def _edit_torch(path, meldec_spec):
    import torch

    print(f"loading {path} ...")
    checkpoint = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = checkpoint["state_dict"]

    if meldec_spec:
        sd, _ = _load_meldec_state_dict(meldec_spec)
        for key, val in sd.items():
            mkey = "_meldec." + key
            print(f"adding meldec key {mkey}")
            state_dict[mkey] = torch.as_tensor(val)
    else:
        for key in list(state_dict):
            if key.startswith("_meldec."):
                print(f"removing {key}")
                del state_dict[key]

    torch.save(checkpoint, path)


if __name__ == "__main__":
    main()
