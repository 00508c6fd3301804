"""The DINER train and eval steps over a ('data', 'rays') mesh of ranks.

Port of ``diner_tpu/parallel/train.py``. The JAX package jits its
one-device step over the mesh, and XLA computes the global step from the
global arrays. Here each rank runs its block of the one-process step
(``train/diner.py``'s ``compute_losses`` and ``make_eval_step`` with a
``mesh``), and the collectives make the sum over ranks the global step:

- every rank draws the global pixel indices and the renderer's global
  noise from the same generator, in the one-process step's order, and
  keeps its block (``sharding.ray_slice``);
- the encoder's train-mode BatchNorms take their statistics over the data
  axis (``sharding.batch_mean``), as JAX's ``mutable=["batch_stats"]``
  does over its global batch, so the running statistics move alike on
  every rank;
- with the VGG loss on, the rendered patch is gathered over the rays axis
  (differentiably) before the losses, which then see the whole patch;
- each rank's loss is its share of the global one: divided by the number
  of ranks, so its sum over ranks is the one-process loss (every rank of
  a ray group computes the same patch terms, every data slice holds as
  many scenes);
- the gradients are summed over every rank through one flat buffer, and
  every rank steps Adam, so the parameters stay identical;
- the metrics are summed over every rank: the global values.

Both steps take the global batch that every rank loaded (the trainer's
seeded shuffle) and keep this rank's scenes (``sharding.shard_batch``).
"""

from __future__ import annotations

import functools

from diner_tpu_torch.parallel.sharding import Mesh, all_reduce_gradients
from diner_tpu_torch.train.diner import (DinerConfig, TrainStep,
                                         compute_losses, make_eval_step)

__all__ = ["ParallelTrainStep", "make_parallel_train_step",
           "make_parallel_eval_step"]


class ParallelTrainStep(TrainStep):
    """One optimizer step of the global batch per call, on every rank of
    ``mesh``: ``(batch, generator=None, noise=None, pix_idcs=None) →
    metrics`` as :class:`TrainStep`, with the global batch and global
    draws. After a call each parameter's ``.grad`` holds the global
    gradient, the same on every rank."""

    def __init__(self, model, cfg: DinerConfig, mesh: Mesh, vgg=None):
        if cfg.rays_per_step % mesh.rays:
            raise ValueError(f"{cfg.rays_per_step} rays a step do not split "
                             f"over {mesh.rays} ranks")
        super().__init__(model, cfg, vgg)
        self.mesh = mesh
        self.loss_fn = functools.partial(compute_losses, mesh=mesh)

    def complete_gradients(self):
        all_reduce_gradients(self.model, self.mesh)


def make_parallel_train_step(model, cfg: DinerConfig, mesh: Mesh,
                             vgg=None) -> ParallelTrainStep:
    """The train step over ``mesh`` on the model's device; every rank's
    model must hold the same weights (``sharding.replicate``)."""
    return ParallelTrainStep(model, cfg, mesh, vgg)


def make_parallel_eval_step(model, cfg: DinerConfig, mesh: Mesh):
    """Full-image renderer over ``mesh``, the whole image on every rank:
    scenes split over the data axis where they divide, and each chunk of
    ``ray_chunk`` rays over the rays axis, so the noise, whole-image arrays
    or drawn from ``generator`` chunk by chunk as the one-process step
    draws it, reaches every ray as there (``train/diner.py:
    make_eval_step``)."""
    return make_eval_step(model, cfg, mesh=mesh)
