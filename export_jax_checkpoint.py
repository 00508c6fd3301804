#!/usr/bin/env python
"""Export an orbax train state of the JAX package to one ``.npz``.

Usage (from the repository root, where JAX and orbax are installed):

    python export_jax_checkpoint.py <ckpt_dir/step_N> <out.npz>

Every JAX trainer saves its whole train state with orbax
(``diner_tpu/train/checkpoint.py:save_checkpoint``): the DINER loop, NOVEL,
KeypointNeRF and TransMVSNet. This restores one without a target
(``orbax.checkpoint.StandardCheckpointer().restore(path)``: dicts, lists
and arrays come back as saved; flax and optax containers as dicts and
lists, e.g. a scheduled Adam's ``opt_state`` as ``[{count, mu, nu},
{count}]``) and writes every array leaf under its ``/``-joined path
(``params/encoder/.../kernel``, ``opt_state/0/mu/...``, ``step``). Empty
containers and ``None`` leaves write nothing.

The PyTorch port reads the file with ``python -m
diner_tpu_torch.train.import_jax``; this script imports neither torch nor
either package, so the port never needs JAX.
"""

import argparse
import os
from pathlib import Path

import numpy as np


def flatten(tree, prefix=()):
    """(path, array) for every array leaf of a restored tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), np.asarray(tree)


def export(ckpt: Path, out: Path) -> int:
    """Write ``ckpt``'s leaves to ``out``; returns their count."""
    import orbax.checkpoint as ocp
    state = ocp.StandardCheckpointer().restore(Path(ckpt).absolute())
    arrays = dict(flatten(state))
    if not arrays:
        raise ValueError(f"{ckpt} holds no arrays")
    tmp = Path(f"{out}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, out)
    return len(arrays)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python export_jax_checkpoint.py")
    ap.add_argument("ckpt", help="an orbax step directory (step_%%08d)")
    ap.add_argument("out", help="the .npz to write")
    args = ap.parse_args(argv)
    n = export(Path(args.ckpt), Path(args.out))
    print(f"wrote {n} arrays to {args.out}")


if __name__ == "__main__":
    main()
