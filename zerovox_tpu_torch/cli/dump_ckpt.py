"""Checkpoint inspector (`zerovox-torch-dump-ckpt`): print tensor names and
shapes from a checkpoint file (surface parity with reference
utils/dump_pkl.py and the JAX package's `cli/dump_ckpt.py`): native
`.msgpack` through the port's flax-format codec, anything else through
`torch.load`."""

from __future__ import annotations

import argparse

import numpy as np


def _print_tree(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            _print_tree(tree[k], prefix + ("." if prefix else "") + str(k))
    else:
        try:
            arr = np.asarray(tree)
            print(f"{prefix}  {arr.shape} {arr.dtype}")
        except (TypeError, ValueError):
            print(prefix)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Print tensor names from a checkpoint.")
    parser.add_argument("checkpoint_file", type=str)
    args = parser.parse_args(argv)

    path = args.checkpoint_file
    try:
        if path.endswith(".msgpack"):
            from zerovox_tpu_torch.training.checkpointing import load_native_checkpoint

            _print_tree(load_native_checkpoint(path))
            return

        import torch

        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(ckpt, dict) and "state_dict" in ckpt:
            for name, t in ckpt["state_dict"].items():
                print(f"{name}  {tuple(t.shape)}")
        elif isinstance(ckpt, dict):
            for name, v in ckpt.items():
                if hasattr(v, "shape"):
                    print(f"{name}  {tuple(v.shape)}")
                elif isinstance(v, dict):
                    for k2, t in v.items():
                        shape = tuple(t.shape) if hasattr(t, "shape") else ""
                        print(f"{name}.{k2}  {shape}")
                else:
                    print(name)
    except FileNotFoundError:
        print(f"Error: Checkpoint file not found at {path}")
    except Exception as e:  # the CLI's boundary: report any unreadable file, as the JAX CLI does
        print(f"An error occurred: {e}")


if __name__ == "__main__":
    main()
